"""The port's ModGP SVGP path (gpitch_tpu_torch.models.svgp, .fit, .linalg
conditionals, .kernels.stationary, FillTriangular) against gpitch_tpu.

Same seeded numpy inputs through both packages, f64 on the CPU; raw
leaves carried across with ``load_raw``.  Tolerances: transforms and
covariance builds 1e-12 relative, conditionals and KLs 1e-10, the golden
values of tests/golden_values.json 1e-9 (as tests/test_golden.py pins
them), ELBO gradients 1e-8, and a 20-step Adam trajectory 1e-9 (losses)
and 1e-7 (raw leaves).
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpitch_tpu.core.transforms import FillTriangular as JFill
from gpitch_tpu.kernels import stationary as jst
from gpitch_tpu.kernels import Matern32 as JMatern32
from gpitch_tpu.kernels import MercerMatern12sm as JMercer
from gpitch_tpu.kernels.base import stack_modules as j_stack
from gpitch_tpu.linalg import ops as jops
from gpitch_tpu.models import ModGP as JModGP
from gpitch_tpu.models.fit import fit_adam as j_fit_adam
from gpitch_tpu_torch.core.params import load_raw, named_params, to_device
from gpitch_tpu_torch.core.transforms import FillTriangular as TFill
from gpitch_tpu_torch.kernels import stationary as tst
from gpitch_tpu_torch.kernels import Matern32 as TMatern32
from gpitch_tpu_torch.kernels import MercerMatern12sm as TMercer
from gpitch_tpu_torch.kernels.base import stack_modules as t_stack
from gpitch_tpu_torch.linalg import ops as tops
from gpitch_tpu_torch.models import (ModGP, fit_adam, fit_adam_timed, fit_modgp,
                                     minibatch_fn, predict_windowed)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the port's golden fixture, as the card runs it)

F64 = torch.float64
with open(os.path.join(ROOT, "tests", "golden_values.json")) as fh:
    GOLDEN = json.load(fh)


def jax_leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def close(got, want, rtol):
    got, want = (a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
                 for a in (got, want))
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


# ------------------------------------------------------------ FillTriangular
@pytest.mark.parametrize("n,lead", [(1, ()), (3, (2,)), (8, (2, 3))])
def test_fill_triangular_matches_jax(n, lead):
    """forward on a seeded packed vector and inverse on a seeded lower
    triangle: exact (the same index map)."""
    rng = np.random.default_rng(n)
    packed = rng.standard_normal(lead + (n * (n + 1) // 2,))
    np.testing.assert_array_equal(TFill(n).forward(torch.as_tensor(packed)).numpy(),
                                  np.asarray(JFill(n).forward(jnp.asarray(packed))))
    tril = np.tril(rng.standard_normal(lead + (n, n)))
    np.testing.assert_array_equal(TFill(n).inverse(tril), np.asarray(JFill(n).inverse(tril)))
    np.testing.assert_array_equal(TFill(n).forward(torch.as_tensor(TFill(n).inverse(tril))),
                                  tril)


# -------------------------------------------------------- stationary kernels
_STATIONARY = [("RBF", (0.7, 0.02)), ("Matern12", (0.7, 0.02)), ("Matern32", (0.7, 0.02)),
               ("Matern52", (0.7, 0.02)), ("Cosine", (0.7, 35.0)),
               ("Gammaexponential", (0.7, 0.02, 1.3)), ("LogisticHat", (0.7, 0.01))]


@pytest.mark.parametrize("name,args", _STATIONARY, ids=[s[0] for s in _STATIONARY])
def test_stationary_kernel_matches_jax(name, args):
    """K(X), K(X, X2) and Kdiag(X): 1e-12 of max|K|."""
    rng = np.random.default_rng(1)
    X = np.sort(rng.uniform(0.0, 0.05, (17, 1)), axis=0)
    X2 = np.sort(rng.uniform(0.0, 0.05, (9, 1)), axis=0)
    jk = getattr(jst, name).create(*args)
    tk = getattr(tst, name).create(*args, dtype=F64)
    assert load_raw(tk, jax_leaves(jk)) == len(list(named_params(tk)))
    close(tk.K(torch.as_tensor(X)), jk.K(X), 1e-12)
    close(tk.K(torch.as_tensor(X), torch.as_tensor(X2)), jk.K(X, X2), 1e-12)
    close(tk.Kdiag(torch.as_tensor(X)), jk.Kdiag(X), 1e-12)


def test_stacked_matern32_bank_matches_vmapped_jax():
    """stack_modules stacks a bank of Matern32 into (S,) leaves; its K over
    (S, M, 1) inputs against JAX's vmap over the stacked bank."""
    rng = np.random.default_rng(2)
    z = np.sort(rng.uniform(0.0, 0.05, (3, 7, 1)), axis=1)
    x = np.sort(rng.uniform(0.0, 0.05, (11, 1)), axis=0)
    params = [(1.0, 0.01), (0.8, 0.02), (1.5, 0.005)]
    jb = j_stack([JMatern32.create(*p) for p in params])
    tb = t_stack([TMatern32.create(*p, dtype=F64) for p in params])
    assert tb.variance.raw.shape == (3,)
    zt, xt = torch.as_tensor(z), torch.as_tensor(x)
    close(tb.K(zt), jax.vmap(lambda k, zi: k.K(zi))(jb, z), 1e-12)
    close(tb.K(zt, xt), jax.vmap(lambda k, zi: k.K(zi, x))(jb, z), 1e-12)
    close(tb.Kdiag(xt), jax.vmap(lambda k: k.Kdiag(x))(jb), 1e-12)


# ---------------------------------------------------------- conditionals, KL
def _cond_inputs(seed, m=9, n=13):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, m))
    Kmm = A @ A.T / m + 0.5 * np.eye(m)
    return {"Kmm": Kmm, "Lm": np.linalg.cholesky(Kmm),
            "Kmn": rng.standard_normal((m, n)) * 0.5,
            "Knn": 2.0 + rng.uniform(0.0, 1.0, n),
            "q_mu": rng.standard_normal((m, 1)),
            "q_sqrt": np.tril(rng.standard_normal((m, m)) * 0.3) + np.eye(m),
            "wm": rng.standard_normal((n, 1)), "wv": rng.standard_normal((n, 1))}


def _grads_torch(fn, arrays, names):
    leaves = {k: torch.as_tensor(arrays[k]).requires_grad_(True) for k in names}
    out = fn(**leaves)
    out.backward()
    return out.detach().numpy(), {k: leaves[k].grad.numpy() for k in names}


def _grads_jax(fn, arrays, names):
    val, g = jax.value_and_grad(lambda d: fn(**d))({k: jnp.asarray(arrays[k]) for k in names})
    return np.asarray(val), {k: np.asarray(v) for k, v in g.items()}


@pytest.mark.parametrize("whiten", [True, False])
@pytest.mark.parametrize("route", ["base_conditional", "base_conditional_inv"])
def test_base_conditionals_and_gradients_match_jax(route, whiten):
    """mean, var and the gradient of <w_m, mean> + <w_v, var> in Kmn, L (or
    L^-1), Knn, q_mu and q_sqrt: 1e-10 of max|ref|."""
    d = _cond_inputs(3)
    if route == "base_conditional_inv":
        d["Lm"] = np.linalg.inv(d["Lm"])
    names = ["Kmn", "Lm", "Knn", "q_mu", "q_sqrt"]

    def scalar(ops, xp):
        def f(Kmn, Lm, Knn, q_mu, q_sqrt):
            m, v = getattr(ops, route)(Kmn, Lm, Knn, q_mu, q_sqrt, whiten)
            return (m * xp.asarray(d["wm"])).sum() + (v * xp.asarray(d["wv"])).sum()
        return f

    got = _grads_torch(scalar(tops, torch), d, names)
    want = _grads_jax(scalar(jops, jnp), d, names)
    close(got[0], want[0], 1e-10)
    for k in names:
        close(got[1][k], want[1][k], 1e-10)


@pytest.mark.parametrize("whiten", [True, False])
def test_conditional_matches_jax(whiten):
    """The functional conditional through safe_chol_inv on a Matern32: the
    value at 1e-10, the gradient in the kernel's raw leaves at 1e-8 (the
    unwhitened path goes through Kmm^-1 of an ill-conditioned Gram)."""
    d = _cond_inputs(4)
    rng = np.random.default_rng(5)
    Z = np.sort(rng.uniform(0.0, 0.05, (9, 1)), axis=0)
    X = np.sort(rng.uniform(0.0, 0.05, (13, 1)), axis=0)
    jk = JMatern32.create(0.9, 0.01)
    tk = TMatern32.create(0.9, 0.01, dtype=F64)

    def jf(k):
        m, v = jops.conditional(X, Z, k, d["q_mu"], d["q_sqrt"], whiten, jitter=1e-6)
        return (m * d["wm"]).sum() + (v * d["wv"]).sum()

    out = tops.conditional(torch.as_tensor(X), torch.as_tensor(Z), tk,
                           torch.as_tensor(d["q_mu"]), torch.as_tensor(d["q_sqrt"]),
                           whiten, jitter=1e-6)
    val = (out[0] * torch.as_tensor(d["wm"])).sum() + (out[1] * torch.as_tensor(d["wv"])).sum()
    val.backward()
    jval, jg = jax.value_and_grad(jf)(jk)
    close(val, jval, 1e-10)
    jg = jax_leaves(jg)
    for name, p in named_params(tk):
        close(p.raw.grad, jg[name + "[<flat index 0>]"], 1e-8)


@pytest.mark.parametrize("whitened", [True, False])
def test_gauss_kl_and_gradients_match_jax(whitened):
    """KL with its gradient in q_mu, q_sqrt (and K): 1e-10."""
    d = _cond_inputs(6)
    names = ["q_mu", "q_sqrt"] + ([] if whitened else ["Kmm"])

    def scalar(ops):
        def f(q_mu, q_sqrt, Kmm=None):
            return ops.gauss_kl(q_mu, q_sqrt, Kmm, jitter=1e-6)
        return f

    got = _grads_torch(scalar(tops), d, names)
    want = _grads_jax(scalar(jops), d, names)
    close(got[0], want[0], 1e-10)
    for k in names:
        close(got[1][k], want[1][k], 1e-10)
    # batched over a leading axis = one call per matrix
    qm = torch.as_tensor(np.stack([d["q_mu"], 0.5 * d["q_mu"]]))
    qs = torch.as_tensor(np.stack([d["q_sqrt"], np.eye(9)]))
    K = None if whitened else torch.as_tensor(np.stack([d["Kmm"], d["Kmm"]]))
    kl = tops.gauss_kl(qm, qs, K, jitter=1e-6)
    for i in range(2):
        close(kl[i], jops.gauss_kl(qm[i].numpy(), qs[i].numpy(),
                                   None if whitened else d["Kmm"], jitter=1e-6), 1e-10)


# ----------------------------------------------------------------- ModGP
def test_golden_fixture_matches_golden_values():
    """chip_smoke.golden_modgp, the fixture of tests/test_golden.py built
    with the port: every modgp_* value of tests/golden_values.json at rtol
    1e-9 (atol 1e-12), as test_golden_values_pinned holds the JAX package."""
    model, x, y = chip_smoke.golden_modgp(F64, "cpu")
    got = chip_smoke.golden_modgp_values(model, x, y)
    assert sorted(got) == sorted(k for k in GOLDEN if k.startswith("modgp_"))
    for key, value in got.items():
        np.testing.assert_allclose(np.asarray(value), np.asarray(GOLDEN[key]),
                                   rtol=1e-9, atol=1e-12, err_msg=key)


def test_golden_fixture_f32_within_tolerance():
    """In f32 (the dtype's own jitter): the ELBO within rtol 2e-4 of the f64
    pin, the limit of tests/test_golden.py:146-147."""
    model, x, y = chip_smoke.golden_modgp(torch.float32, "cpu")
    np.testing.assert_allclose(float(model.elbo(x, y)), GOLDEN["modgp_elbo_whitened"],
                               rtol=2e-4)


def _jax_golden(whiten=True):
    from test_golden import build_modgp
    jm, x, y = build_modgp()
    if not whiten:
        jm = jm.replace(whiten=False)
    return jm, np.asarray(x), np.asarray(y)


def _port_of(jm, whiten=True, join=True):
    """The port's ModGP with the JAX model's raw leaves."""
    kern_act = [TMatern32.create(dtype=F64) for _ in range(2)]
    kern_com = [TMercer.create(1.0, 1.0, [1.0, 1.0], [1.0, 1.0], dtype=F64) for _ in range(2)]
    z = np.zeros((8, 1))
    tm = ModGP.create(z=[[z, z], [z, z]], kern=[kern_act, kern_com], whiten=whiten,
                      dtype=F64, device="cpu")
    tm = dataclasses.replace(tm, join_banks=join)
    assert load_raw(tm, jax_leaves(jm)) == len(list(named_params(tm)))
    return tm


@pytest.mark.parametrize("whiten,join,batch", [
    (True, True, "full"), (True, False, "full"), (False, True, "full"),
    (True, True, "minibatch")])
def test_modgp_elbo_and_raw_gradients_match_jax(whiten, join, batch):
    """ELBO and the gradient of every trainable raw leaf against jax.grad:
    the joined and separate bank paths, whitened or not, and a minibatch
    (a given index set with num_data scaling).  Values 1e-10, gradients
    1e-8 of max|ref|."""
    jm, x, y = _jax_golden(whiten)
    jm = jm.replace(join_banks=join)
    tm = _port_of(jm, whiten, join)
    num_data = None
    if batch == "minibatch":
        idx = np.random.default_rng(7).integers(0, 32, 12)
        x, y, num_data = x[idx], y[idx], 32
    elbo = tm.elbo(torch.as_tensor(x), torch.as_tensor(y), num_data=num_data)
    elbo.backward()
    jval, jg = jax.value_and_grad(lambda m: m.elbo(x, y, num_data=num_data))(jm)
    close(elbo, jval, 1e-10)
    jg = jax_leaves(jg)
    grads = {name: p.raw.grad for name, p in named_params(tm) if p.trainable}
    assert len(grads) == 11 and ".za" not in grads
    for name, g in grads.items():
        close(g, jg[name + "[<flat index 0>]"], 1e-8)


def test_load_raw_takes_modgp_leaves_of_separate_kernels():
    """Kernels that do not stack (different partial counts) stay a tuple;
    load_raw fills their leaves by index, and the ELBO matches: 1e-10."""
    z = np.linspace(0.0, 0.04, 6).reshape(-1, 1)

    def kerns(mat32, mercer, **kw):
        return [[mat32.create(1.0, 0.01, **kw), mat32.create(0.5, 0.02, **kw)],
                [mercer.create(1.0, 0.05, [1.0], [50.0], **kw),
                 mercer.create(0.7, 0.04, [0.8, 0.3], [80.0, 160.0], **kw)]]

    jm = JModGP.create(z=[[z, z], [z, z]], kern=kerns(JMatern32, JMercer))
    tm = ModGP.create(z=[[z, z], [z, z]], kern=kerns(TMatern32, TMercer, dtype=F64),
                      dtype=F64, device="cpu")
    assert tm.stacked_act and not tm.stacked_com and not tm._can_join()
    leaves = jax_leaves(jm)
    assert ".kern_com[1].frequency[<flat index 0>]" in leaves
    assert load_raw(tm, leaves) == len(leaves)
    x = np.linspace(0.0, 0.04, 20).reshape(-1, 1)
    y = np.sin(2 * np.pi * 50.0 * x)
    close(tm.elbo(torch.as_tensor(x), torch.as_tensor(y)), jm.elbo(x, y), 1e-10)


def test_modgp_create_refuses_kernels_of_another_dtype():
    z = np.zeros((4, 1))
    with pytest.raises(ValueError, match="dtype"):
        ModGP.create(z=[[z], [z]], kern=[[TMatern32.create()], [TMatern32.create()]],
                     dtype=F64, device="cpu")


def test_torch_joint_bank_matches_separate():
    """The joined (2S, M, M) path against the per-bank path and the ELBO
    assembled from it: 1e-10."""
    model, x, y = chip_smoke.golden_modgp(F64, "cpu")
    assert model._can_join()
    fmu, fvar = model._banks_joint(x)
    ma, va = model._bank("act", x)
    mc, vc = model._bank("com", x)
    close(fmu, torch.cat([ma, mc], 1), 1e-10)
    close(fvar, torch.cat([va, vc], 1), 1e-10)
    ve = model.likelihood.variational_expectations(torch.cat([ma, mc], 1),
                                                   torch.cat([va, vc], 1), y)
    close(model.elbo(x, y), ve.sum() - model.prior_kl(), 1e-10)


def test_predict_windowed_matches_direct():
    """Chunks of 5 points (a ragged last chunk) against one call: 1e-12."""
    model, x, _ = chip_smoke.golden_modgp(F64, "cpu")
    direct = model.predict_act_n_com(x)
    chunked = predict_windowed(model, x, ws=5)
    assert len(chunked) == 5
    for d, c in zip(direct, chunked):
        assert c.shape == (32, 2)
        close(c, d, 1e-12)


def test_fit_adam_trajectory_matches_jax():
    """20 full-batch Adam steps at lr 0.01 on the golden fixture: losses at
    rtol 1e-9, final raw leaves at 1e-7 of max|ref|."""
    jm, x, y = _jax_golden()
    tm = _port_of(jm)
    jm, jl = j_fit_adam(jm, lambda m: m.loss(x, y), num_steps=20, learning_rate=0.01)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    tm, tl = fit_adam(tm, lambda m: m.loss(xt, yt), num_steps=20, learning_rate=0.01)
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-9)
    want = jax_leaves(jm)
    for name, p in named_params(tm):
        close(p.raw, want[name + "[<flat index 0>]"], 1e-7)


def test_minibatch_fn_is_seeded_and_in_range():
    """(size, 1) batches of rows of the data, drawn with replacement; the
    same seed gives the same stream, another seed another."""
    x = torch.arange(50, dtype=F64).reshape(-1, 1)
    y = 2.0 * x

    def draws(seed, k=4):
        fn = minibatch_fn(x, y, 16, torch.Generator().manual_seed(seed))
        return [fn() for _ in range(k)]

    a, b, c = draws(3), draws(3), draws(4)
    for xb, yb in a:
        assert xb.shape == yb.shape == (16, 1)
        assert torch.equal(yb, 2.0 * xb)
        assert bool(((xb >= 0) & (xb < 50)).all())
        assert torch.equal(xb, xb.round())
    assert all(torch.equal(p[0], q[0]) for p, q in zip(a, b))
    assert not all(torch.equal(p[0], q[0]) for p, q in zip(a, c))
    assert len(torch.unique(torch.cat([xb for xb, _ in a]))) > 16
    assert minibatch_fn(x, y, 4).generator.initial_seed() == 0


def test_fit_adam_timed_repeats_the_minibatch_stream():
    """fit_adam_timed restores the generator between its two runs, so its
    losses equal fit_adam's from the same seed (exact)."""
    model, x, y = chip_smoke.golden_modgp(F64, "cpu")

    def loss(m, xb, yb):
        return m.loss(xb, yb, num_data=32)

    _, l1 = fit_adam(model, loss, 5, 0.01,
                     minibatch_fn(x, y, 8, torch.Generator().manual_seed(1)))
    model, x, y = chip_smoke.golden_modgp(F64, "cpu")
    _, l2, first_s, run_s = fit_adam_timed(model, loss, 5, 0.01, minibatch_fn(
        x, y, 8, torch.Generator().manual_seed(1)))
    np.testing.assert_array_equal(l1, l2)
    assert first_s >= 0.0 and run_s > 0.0


def test_fit_modgp_trains_and_names_what_is_left():
    model, x, y = chip_smoke.golden_modgp(F64, "cpu")
    model, losses = fit_modgp(model, x.numpy(), y.numpy(), num_steps=30,
                              learning_rate=0.01, minibatch_size=16, segment=10,
                              generator=torch.Generator().manual_seed(0))
    assert losses.shape == (30,) and np.isfinite(losses).all()
    assert losses[-5:].mean() < losses[:5].mean()
    for method, item in (("natgrad_adam", "item 10"), ("lbfgs", "item 11")):
        with pytest.raises(NotImplementedError, match=item):
            fit_modgp(model, x, y, num_steps=1, method=method)


def test_modgp_entry_point_defaults_to_the_card():
    z = np.zeros((4, 1))
    kern = [[TMatern32.create()], [TMatern32.create()]]
    if torch.cuda.is_available():
        assert ModGP.create(z=[[z], [z]], kern=kern).za.raw.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ModGP.create(z=[[z], [z]], kern=kern)
    m = to_device(ModGP.create(z=[[z], [z]], kern=kern, device="cpu"), "cpu")
    assert m.q_sqrt_act.raw.shape == (1, 10)
