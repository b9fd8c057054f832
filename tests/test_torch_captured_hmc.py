"""The port's HMC runner (gpitch_tpu_torch.models.hmc.HmcSteps): every
iteration on static device tensors, a phase an iteration captured and
replayed on the card.

On the CPU (f64) the runner runs eagerly, the plain version of its
capture: on the same noise it equals ``_hmc_core`` (the sampler one
iteration after another from Python loops) bit for bit, with and without
mass adaptation and with a warm-up too short for it; on the JAX package's
own draws (``tests/test_torch_hmc.py``'s ``jax_noise``) it gives
``gpitch_tpu.models.hmc.hmc_sample``'s chains within 1e-8; a diverging
chain rejects while the others are those of a run without it, bit for bit;
and a tiny window bank's folded chains equal each chain run alone (1e-10).
The runner's card cases (its captured phases against its eager iterations
on both routes, no host read, a failed capture raising) are in
``tests/test_torch_cuda.py``, which the card runs without JAX.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpitch_tpu.models.hmc import hmc_sample as j_hmc_sample
from gpitch_tpu_torch.core.params import named_params, with_raw
from gpitch_tpu_torch.models.hmc import HmcSteps, _hmc_core, model_logprob_fn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from test_torch_hmc import _replay_case, jax_noise, t_anisotropic, t_correlated  # noqa: E402
from test_torch_lbfgs import _bank_pair  # noqa: E402

F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _noise(init: dict, chains: int, total: int, seed: int):
    """Seeded init normals (C, ...), momentum normals (T, C, ...) and
    uniforms (T, C) in f64."""
    gen = torch.Generator().manual_seed(seed)

    def normal(shape, v):
        return torch.randn(shape + tuple(v.shape), generator=gen, dtype=F64)

    return ({k: normal((chains,), v) for k, v in init.items()},
            {k: normal((total, chains), v) for k, v in init.items()},
            torch.rand((total, chains), generator=gen, dtype=F64))


def _run(fn, init, noise, num_warmup, num_samples, num_leapfrog=4, init_step_size=0.1,
         jitter_init=0.1, mass_adapt=True, runner=True):
    args = (fn, init, *noise, num_warmup, num_samples, num_leapfrog, init_step_size, 0.8,
            jitter_init, mass_adapt)
    return HmcSteps(*args).run() if runner else _hmc_core(*args)


def _assert_equal(a, b):
    (sa, ra), (sb, rb) = a, b
    for k in sb:
        assert sa[k].shape == sb[k].shape
        assert torch.equal(sa[k], sb[k]), k
    assert torch.equal(ra, rb)


_CASES = {
    "correlated": (t_correlated, np.zeros(2), dict(num_warmup=20, num_samples=10)),
    "anisotropic": (t_anisotropic, np.array([2.1, -25.0]),
                    dict(num_warmup=20, num_samples=10, jitter_init=0.01)),
    "no_mass_adapt": (t_correlated, np.zeros(2),
                      dict(num_warmup=20, num_samples=10, mass_adapt=False)),
    "short_warmup": (t_anisotropic, np.array([2.1, -25.0]),
                     dict(num_warmup=12, num_samples=10, jitter_init=0.01)),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_torch_hmc_steps_equal_the_loop(case):
    """3 chains, 4 leapfrog steps, 20 (or 12: no mass adaptation) + 10
    iterations in f64: the runner's samples and rates equal the loop's bit
    for bit (the dual averaging's count a tensor in both)."""
    fn, start, kw = _CASES[case]
    init = {"theta": torch.as_tensor(start)}
    noise = _noise(init, 3, kw["num_warmup"] + kw["num_samples"], seed=7)
    got = _run(fn, init, noise, **kw)
    _assert_equal(got, _run(fn, init, noise, runner=False, **kw))
    assert got[0]["theta"].shape == (3, 10, 2)
    assert torch.isfinite(got[0]["theta"]).all()


@pytest.mark.parametrize("name", ["correlated", "anisotropic", "modgp"])
def test_torch_hmc_steps_replay_jax_chains(name):
    """The runner on the JAX package's own draws gives its chains: samples
    within 1e-8 of max|ref|, the rates equal (2 chains, 4 leapfrog, 20 +
    6, mass adaptation)."""
    jfn, tfn, init, key, kw = _replay_case(name)
    jsamples, jrates = j_hmc_sample(jfn, {k: jnp.asarray(v) for k, v in init.items()},
                                    key, **kw)
    noise = jax_noise(key, init, kw["num_chains"], kw["num_warmup"], kw["num_samples"])
    tsamples, trates = HmcSteps(
        tfn, {k: torch.as_tensor(v) for k, v in init.items()}, *noise, kw["num_warmup"],
        kw["num_samples"], kw["num_leapfrog"], 0.01, 0.8, kw.get("jitter_init", 0.1),
        True).run()
    for k in init:
        want = np.asarray(jsamples[k])
        np.testing.assert_allclose(tsamples[k].numpy(), want, rtol=0,
                                   atol=1e-8 * np.abs(want).max())
    np.testing.assert_allclose(trates.numpy(), np.asarray(jrates), rtol=0, atol=1e-7)


def test_torch_hmc_steps_diverged_chain_rejects():
    """Chain 1 starts where the density is NaN: the runner rejects each of
    its proposals (it stays at its start, rate 0) and chains 0 and 2 are bit
    for bit those of a run where chain 1 starts in the well."""
    def logprob(q):
        x = q["x"]
        lp = -0.5 * x.square().sum(-1)
        return torch.where(x[:, 0] > 5.0, torch.full_like(lp, float("nan")), lp)

    q0 = {"x": torch.zeros(2, dtype=F64)}
    good, mom, unif = _noise(q0, 3, 30, seed=0)
    bad = {"x": good["x"].clone()}
    bad["x"][1] = torch.tensor([100.0, 0.0], dtype=F64)
    s_good, r_good = _run(logprob, q0, (good, mom, unif), 20, 10, num_leapfrog=5)
    s_bad, r_bad = _run(logprob, q0, (bad, mom, unif), 20, 10, num_leapfrog=5)
    assert r_bad[1].item() == 0.0
    assert torch.equal(s_bad["x"][1], (0.1 * bad["x"][1]).expand(10, 2))
    for k in (0, 2):
        assert torch.equal(s_bad["x"][k], s_good["x"][k])
        assert r_bad[k].item() == r_good[k].item()


def _bank_hmc():
    """HMC over the tiny 4-window bank's stacked kernel variances and
    lengthscales (the chains folded into the window axis)."""
    _, bank = _bank_pair()
    paths = [".kern.stacked.variance", ".kern.stacked.lengthscales"]
    raws = dict(named_params(bank))
    init = {k: raws[k].raw.detach().clone() for k in paths}
    return model_logprob_fn(bank, with_raw, prior_scale=10.0), init


def test_torch_hmc_steps_folded_bank_equals_one_chain_at_a_time():
    """The tiny bank's 3 chains folded into 12 windows against each chain
    run alone on its own noise (5 + 5 iterations, 2 leapfrog steps):
    samples within 1e-10 of max|ref|, equal rates."""
    fn, init = _bank_hmc()
    noise = _noise(init, 3, 10, seed=3)
    kw = dict(num_leapfrog=2, init_step_size=0.05, jitter_init=0.01)
    folded = _run(fn, init, noise, 5, 5, **kw)
    inits, mom, unif = noise
    for c in range(3):
        one = _run(fn, init, ({k: v[c:c + 1] for k, v in inits.items()},
                              {k: v[:, c:c + 1] for k, v in mom.items()}, unif[:, c:c + 1]),
                   5, 5, **kw)
        for k in init:
            want = one[0][k][0]
            np.testing.assert_allclose(folded[0][k][c].numpy(), want.numpy(), rtol=0,
                                       atol=1e-10 * want.abs().max().item())
        assert folded[1][c].item() == one[1][0].item()
    assert torch.isfinite(folded[0][".kern.stacked.variance"]).all()
