"""The port's natural gradients (gpitch_tpu_torch.models.natgrad) against
gpitch_tpu.models.natgrad.

Same seeded numpy inputs through both packages, f64 on the CPU, raw leaves
carried across with ``load_raw`` (the ModGP golden fixture of
tests/test_golden.py).  Tolerances: the bank update 1e-10, a natural step
and the polish 1e-10 (of max|ref| for leaves), full-batch trajectories of
natural gradients with Adam 1e-9.  Minibatches come from a torch generator
in the port and from jax.random keys in JAX, so only full-batch
trajectories are held against JAX.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpitch_tpu.models import natgrad as jng
from gpitch_tpu.models.fit import fit_modgp as j_fit_modgp
from gpitch_tpu_torch.core.params import named_params
from gpitch_tpu_torch.kernels import Matern32, MercerMatern12sm
from gpitch_tpu_torch.models import ModGP, fit_modgp, natgrad as tng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from test_torch_lbfgs import close_leaves  # noqa: E402
from test_torch_svgp import _jax_golden, _port_of  # noqa: E402

F64 = torch.float64



@pytest.fixture(autouse=True)
def _one_thread():
    """The solvers run thousands of small torch ops; with one intra-op
    thread each they do not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _golden_pair():
    jm, x, y = _jax_golden()
    return jm, _port_of(jm), x, y, torch.as_tensor(x.copy()), torch.as_tensor(y.copy())


@pytest.mark.parametrize("gamma", [0.05, 0.3, 1.0])
def test_torch_nat_update_bank_matches_jax(gamma):
    """The whitened-frame update on seeded SPD inputs (2 banks of 6): the
    new q_mu and q_sqrt within 1e-10 of max|ref|."""
    rng = np.random.default_rng(3)
    s, m = 2, 6
    a = rng.standard_normal((s, m, m))
    L = np.linalg.cholesky(a @ a.transpose(0, 2, 1) / m + 0.5 * np.eye(m))
    mu, gm = rng.standard_normal((s, m, 1)), rng.standard_normal((s, m, 1))
    g = rng.standard_normal((s, m, m))
    gS = -0.5 * (g @ g.transpose(0, 2, 1)) / m
    want = jng._nat_update_bank(*(jnp.asarray(v) for v in (mu, L, gm, gS)), gamma)
    got = tng._nat_update_bank(*(torch.as_tensor(v) for v in (mu, L, gm, gS)), gamma)
    for gt, wt in zip(got, want):
        wt = np.asarray(wt)
        np.testing.assert_allclose(gt.numpy(), wt, rtol=0, atol=1e-10 * np.abs(wt).max())
    assert torch.equal(got[1], torch.tril(got[1]))


def test_torch_natgrad_step_matches_jax():
    """One natural step (gamma 0.1) on the golden fixture: every raw leaf
    within 1e-10 of max|ref|, the ELBO within 1e-10 and higher than before;
    the input model is left unchanged."""
    jm, tm, x, y, xt, yt = _golden_pair()
    before = [p.raw.clone() for _, p in named_params(tm)]
    j2 = jng.natgrad_step(jm, x, y, 0.1)
    t2 = tng.natgrad_step(tm, xt, yt, 0.1)
    close_leaves(t2, j2, 1e-10)
    with torch.no_grad():
        e0, e1 = float(tm.elbo(xt, yt)), float(t2.elbo(xt, yt))
    np.testing.assert_allclose(e1, float(j2.elbo(x, y)), rtol=1e-10)
    assert e1 > e0
    assert all(torch.equal(a, p.raw) for a, (_, p) in zip(before, named_params(tm)))


def test_torch_natgrad_polish_matches_jax():
    """10 full-batch natural steps at gamma 0.05: the loss trace at rtol
    1e-10 and the raw leaves within 1e-10 of max|ref|."""
    jm, tm, x, y, xt, yt = _golden_pair()
    jp, jl = jng.natgrad_polish(jm, x, y, num_steps=10)
    tp, tl = tng.natgrad_polish(tm, xt, yt, num_steps=10)
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-10)
    close_leaves(tp, jp, 1e-10)


def test_torch_natgrad_one_step_optimal_in_conjugate_case():
    """As tests/test_hmc_natgrad.py:34-57: with a constant modulation the
    model is conjugate in the component GP, so one natural step at gamma 1
    lands on the optimal q, and a second leaves the ELBO unchanged (within
    1e-3 relative)."""
    sys.path.insert(0, ROOT)
    from tests.test_svgp import synth_data
    z = np.linspace(0.0, 1.0, 12).reshape(-1, 1)
    model = ModGP.create(z=[[z], [z]], kern=[[Matern32.create(1.0, 1.0, dtype=F64)],
                                            [MercerMatern12sm.create(
                                                1.0, 0.5, [1.0, 0.5], [10.0, 20.0], dtype=F64)]],
                         nlinfun=torch.ones_like, dtype=F64, device="cpu")
    x, y, _, _ = synth_data(150)
    x, y = torch.as_tensor(np.asarray(x)), torch.as_tensor(np.asarray(y))
    m1 = tng.natgrad_step(model, x, y, gamma=1.0)
    m2 = tng.natgrad_step(m1, x, y, gamma=1.0)
    with torch.no_grad():
        e0, e1, e2 = (float(m.elbo(x, y)) for m in (model, m1, m2))
    assert e1 > e0 + 1.0
    assert abs(e2 - e1) < 1e-3 * abs(e1)


def test_torch_fit_natgrad_adam_matches_jax():
    """Full batch, 30 steps in segments of 10 with a 5-step polish: the
    losses at rtol 1e-9, and n_skipped, the full-data losses at segment
    ends, the state returned and the polish's record as JAX's; the raw
    leaves within 1e-9 of max|ref|."""
    jm, tm, x, y, xt, yt = _golden_pair()
    kw = dict(num_steps=30, gamma=0.1, learning_rate=0.01, segment=10,
              polish_steps=5, return_info=True)
    jo, jl, ji = jng.fit_natgrad_adam(jm, x, y, **kw)
    to, tl, ti = tng.fit_natgrad_adam(tm, xt, yt, **kw)
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-9)
    assert ti["adam_steps"] == 30
    for key in ("n_skipped", "full_loss_at_segments", "returned"):
        assert ti[key] == ji[key], key
    assert ti["polish"].keys() == ji["polish"].keys()
    for key, value in ji["polish"].items():
        np.testing.assert_allclose(ti["polish"][key], value, rtol=1e-9, err_msg=key)
    close_leaves(to, jo, 1e-9)


def test_torch_natgrad_skipped_steps_keep_adam_and_the_model():
    """gamma 3 with no warm-up leaves the PSD cone on some steps: those
    record NaN at the same steps as JAX, the other losses agree at rtol
    1e-9 (which they would not if a skipped step had advanced Adam's count
    or moments), and Adam took one step per finite step.  At gamma 1e4
    every step is skipped and the model comes back unchanged."""
    jm, tm, x, y, xt, yt = _golden_pair()
    kw = dict(num_steps=12, gamma=3.0, learning_rate=0.01, gamma_warmup=1, return_info=True)
    _, jl, ji = jng.fit_natgrad_adam(jm, x, y, **kw)
    to, tl, ti = tng.fit_natgrad_adam(tm, xt, yt, **kw)
    jl = np.asarray(jl)
    np.testing.assert_array_equal(np.isnan(tl), np.isnan(jl))
    assert 0 < ti["n_skipped"] == ji["n_skipped"] < 12
    assert ti["adam_steps"] == 12 - ti["n_skipped"]
    np.testing.assert_allclose(tl, jl, rtol=1e-9)

    kw.update(gamma=1e4)
    out, losses, info = tng.fit_natgrad_adam(tm, xt, yt, **kw)
    assert np.isnan(losses).all() and info["adam_steps"] == 0
    for (_, a), (_, b) in zip(named_params(out), named_params(tm)):
        assert torch.equal(a.raw, b.raw)


def test_torch_fit_modgp_natgrad_adam_matches_jax():
    """fit_modgp(method="natgrad_adam"), full batch, 20 steps in segments
    of 10: the losses at rtol 1e-9 and the returned raw leaves within 1e-9
    of max|ref|."""
    jm, tm, x, y, _, _ = _golden_pair()
    kw = dict(num_steps=20, method="natgrad_adam", learning_rate=0.01,
              minibatch_size=None, segment=10, gamma=0.1)
    jo, jl = j_fit_modgp(jm, x, y, **kw)
    to, tl = fit_modgp(tm, x, y, **kw)
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-9)
    close_leaves(to, jo, 1e-9)


def test_torch_natgrad_adam_minibatch_trains():
    """Minibatches of 16 from a seeded torch generator, 40 steps: finite
    losses, the best full-data loss of the segment ends below the start,
    and the same generator seed gives the same run."""
    _, tm, _, _, xt, yt = _golden_pair()

    def run():
        return fit_modgp(tm, xt, yt, num_steps=40, method="natgrad_adam",
                         learning_rate=0.01, minibatch_size=16, segment=10,
                         generator=torch.Generator().manual_seed(0), return_info=True)

    _, losses, info = run()
    with torch.no_grad():
        start = float(tm.loss(xt, yt))
    assert np.isfinite(losses).all() and info["n_skipped"] == 0
    assert min(info["full_loss_at_segments"]) < start
    np.testing.assert_array_equal(run()[1], losses)
