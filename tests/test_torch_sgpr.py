"""The port's SGPR models, fit loop and window bank (gpitch_tpu_torch.models,
.pipelines.windowed_sgpr) against gpitch_tpu.

Same host inputs through both packages, raw leaves carried across with
``load_raw``.  f64 tolerances: covariance builds ~1e-13, the bound 1e-9
relative (it sums ~1e5-sized terms that cancel), gradients and short Adam
trajectories 1e-7 relative (they pass through two Cholesky inverses).
"""

import jax
import numpy as np
import optax
import pytest
import torch

from gpitch_tpu.kernels import MercerMatern12sm as JMercer
from gpitch_tpu.kernels.base import StackedSum as JStacked
from gpitch_tpu.kernels.base import Sum as JSum
from gpitch_tpu.models.fit import fit_adam as j_fit_adam
from gpitch_tpu.models.sgpr import SGPRSS as JSGPRSS
from gpitch_tpu.pipelines import windowed_sgpr as jws
from gpitch_tpu_torch.core.params import load_raw, named_params
from gpitch_tpu_torch.kernels import MercerMatern12sm as TMercer
from gpitch_tpu_torch.kernels.base import StackedSum as TStacked
from gpitch_tpu_torch.kernels.base import Sum as TSum
from gpitch_tpu_torch.models.fit import Adam as t_Adam
from gpitch_tpu_torch.models.fit import fit_adam as t_fit_adam
from gpitch_tpu_torch.models.sgpr import SGPRSS as TSGPRSS
from gpitch_tpu_torch.pipelines import windowed_sgpr as tws

F64 = torch.float64


def jax_leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _kerns(cls, **kw):
    out = []
    for i in range(3):
        e = np.linspace(1.0, 0.3, 4)
        out.append(cls.create(0.6 + 0.3 * i, 0.05 + 0.03 * i, e / e.sum(),
                              (220.0 + 60.0 * i) * np.arange(1, 5), **kw))
    return out


def _data(rng, n=150, m=20, t0=13.0, fs=16000.0):
    x = t0 + np.arange(n) / fs
    y = np.sin(2 * np.pi * 220.0 * (x - t0)) + 0.3 * rng.standard_normal(n)
    z = np.sort(rng.choice(x, m, replace=False))
    return x.reshape(-1, 1), y.reshape(-1, 1), z.reshape(-1, 1)


def _pair(rng, mask=None, reg=False, seed=0, stacked=True, n=150, m=20):
    """The same SGPRSS in both packages, kernel hypers perturbed by seeded
    noise in JAX and copied across.  ``stacked=False``: a Sum of two
    kernels with different partial counts instead of a StackedSum."""
    x, y, z = _data(rng, n=n, m=m)
    if stacked:
        jk = JStacked.create(_kerns(JMercer))
        tk = TStacked.create(_kerns(TMercer, dtype=F64))
    else:
        jk = JSum(kern_list=tuple(_kerns(JMercer)[:1]) + (JMercer.create(
            0.7, 0.08, [0.6, 0.4], [330.0, 660.0]),))
        tk = TSum(kern_list=tuple(_kerns(TMercer, dtype=F64)[:1]) + (TMercer.create(
            0.7, 0.08, [0.6, 0.4], [330.0, 660.0], dtype=F64),))
    jm = JSGPRSS.create(x, y, jk, Z=z, mask=mask, reg=reg)
    noise = np.random.default_rng(seed)
    jm = jm.replace(kern=jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.2 * noise.standard_normal(np.shape(a)), jm.kern),
        variance=jax.tree_util.tree_map(lambda a: np.asarray(a) - 0.5, jm.variance))
    tm = TSGPRSS.create(x, y, tk, Z=z, mask=mask, reg=reg, dtype=F64)
    assert load_raw(tm, jax_leaves(jm)) == len(list(named_params(tm)))
    return jm, tm, x


@pytest.mark.parametrize("masked", [False, True])
def test_sgpr_bound_and_raw_gradients_match(masked, rng):
    mask = None
    if masked:
        mask = np.ones(150)
        mask[-30:] = 0.0
    jm, tm, _ = _pair(rng, mask=mask, reg=masked)
    bound = tm.elbo()
    close(bound, jax.jit(lambda m: m.elbo())(jm), 1e-9)
    bound.backward()
    jg = jax_leaves(jax.jit(jax.grad(lambda m: m.elbo()))(jm))
    grads = {name: p.raw.grad for name, p in named_params(tm) if p.trainable}
    assert sorted(grads) == [".kern.stacked.energy", ".kern.stacked.frequency",
                             ".kern.stacked.lengthscales", ".kern.stacked.variance",
                             ".variance"]
    for name, g in grads.items():
        close(g, jg[name + "[<flat index 0>]"], 1e-7)


def test_predict_f_matches(rng):
    jm, tm, x = _pair(rng, seed=1)
    xnew = x[::3] + 0.5 / 16000.0
    mean, var = tm.predict_f(torch.as_tensor(xnew))
    jmean, jvar = jax.jit(lambda m, a: m.predict_f(a))(jm, xnew)
    close(mean, jmean, 1e-9)
    close(var, jvar, 1e-9)


@pytest.mark.parametrize("source_batch,xnew_is_x,stacked", [
    (8, True, True), (2, False, True), (8, False, True), (8, True, False)])
def test_predict_s_matches(source_batch, xnew_is_x, stacked, rng):
    """The Gram-reuse path (all sources in one chunk), the chunked path, and
    the per-kernel path of a Sum."""
    mask = np.ones(150)
    mask[:10] = 0.0
    jm, tm, x = _pair(rng, mask=mask, seed=2, stacked=stacked)
    got = tm.predict_s(torch.as_tensor(x), source_batch=source_batch,
                       xnew_is_x=xnew_is_x)
    want = jax.jit(lambda m, a: m.predict_s(a, source_batch=source_batch,
                                            xnew_is_x=xnew_is_x))(jm, x)
    for g_list, w_list in zip(got, want):
        assert len(g_list) == (3 if stacked else 2)
        for g, w in zip(g_list, w_list):
            close(g, w, 1e-8)


def _windows(rng, nw=3, ws=201, m=16):
    n = ws + (nw - 1) * 100
    x = np.arange(n) / 16000.0 + 2.0
    y = np.sin(2 * np.pi * 300 * x) + 0.1 * rng.standard_normal(n)
    idx = np.arange(nw)[:, None] * 100 + np.arange(ws)[None, :]
    xw, yw = x[idx], y[idx]
    zw = np.stack([np.sort(rng.choice(xw[i], m, replace=False)) for i in range(nw)])
    return xw, yw, zw[..., None]


def _banks(rng, **kw):
    xw, yw, zw = _windows(rng)
    jb = jws.build_window_bank(xw, yw, zw, lambda: jws.sum_kernel(_kerns(JMercer)),
                               grid_dt=1 / 16000.0, **kw)
    tb = tws.build_window_bank(xw, yw, zw, lambda: tws.sum_kernel(_kerns(TMercer, dtype=F64)),
                               grid_dt=1 / 16000.0, dtype=F64, device="cpu", **kw)
    return jb, tb, xw


def test_build_window_bank_leaves_match(rng):
    jb, tb, _ = _banks(rng, y_scale=20.0)
    want = jax_leaves(jb)
    got = {name: p.raw.detach().numpy() for name, p in named_params(tb)}
    assert sorted(got) == sorted(k.split("[")[0] for k in want)
    for key, arr in want.items():
        np.testing.assert_allclose(got[key.split("[")[0]], arr, rtol=1e-15, atol=0)
    with pytest.raises(ValueError, match="grid"):
        xw, yw, zw = _windows(rng)
        tws.build_window_bank(xw, yw, zw + 0.3 / 16000.0, lambda: tws.sum_kernel(
            _kerns(TMercer, dtype=F64)), grid_dt=1 / 16000.0, dtype=F64)


def test_bank_loss_and_predictions_match(rng):
    jb, tb, xw = _banks(rng)
    close(tb.elbo(), jax.jit(jax.vmap(lambda m: m.elbo()))(jb), 1e-9)
    close(tws.bank_loss(tb), jax.jit(jws.bank_loss)(jb), 1e-9)
    for got, want in zip(tws.predict_bank_sources(tb, xw, batch_size=2),
                         jws.predict_bank_sources(jb, xw, batch_size=2)):
        close(got, want, 1e-8)
    for got, want in zip(tws.predict_bank_mixture(tb, xw, batch_size=2),
                         jws.predict_bank_mixture(jb, xw, batch_size=2)):
        close(got, want, 1e-8)
    close(tws.pitch_variances(tb), jws.pitch_variances(jb), 1e-15)


def test_port_adam_is_optax_adam():
    """The port's Adam against optax.adam (eps_root 0) and torch.optim.Adam
    (b1 0.9, b2 0.999, eps 1e-8) on the same quadratic, two leaves: equal
    up to f64 rounding."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((6, 6))
    p0 = rng.standard_normal(6)

    def run(make_opt):
        p = torch.as_tensor(p0.copy()).requires_grad_(True)
        s = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
        opt = make_opt([p, s])
        for _ in range(20):
            opt.zero_grad()
            (p @ torch.as_tensor(A) @ p * s.exp()).backward()
            opt.step()
        return np.append(p.detach().numpy(), s.item())

    got = run(lambda ps: t_Adam(ps, lr=0.01))
    tx = optax.adam(0.01)
    q = (p0.copy(), 0.3)
    state = tx.init(q)
    for _ in range(20):
        p, s = q
        g = ((A + A.T) @ p * np.exp(s), p @ A @ p * np.exp(s))
        upd, state = tx.update(g, state, q)
        q = tuple(np.asarray(a) for a in optax.apply_updates(q, upd))
    np.testing.assert_allclose(got, np.append(*q), rtol=1e-13, atol=1e-15)
    torch_adam = run(lambda ps: torch.optim.Adam(ps, lr=0.01, betas=(0.9, 0.999), eps=1e-8))
    np.testing.assert_allclose(got, torch_adam, rtol=1e-13, atol=1e-15)


def test_fit_adam_trajectory_matches(rng):
    """Five Adam steps on a 3-window bank: losses and final raw leaves."""
    jb, tb, _ = _banks(rng)
    jb, jl = j_fit_adam(jb, jws.bank_loss, num_steps=5, learning_rate=0.01)
    tb, tl = t_fit_adam(tb, tws.bank_loss, num_steps=5, learning_rate=0.01)
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-9)
    want = jax_leaves(jb)
    for name, p in named_params(tb):
        close(p.raw, want[name + "[<flat index 0>]"], 1e-7)


def test_optimize_bank_window_chunks_are_exact(rng):
    _, tb, _ = _banks(rng)
    whole, lw = tws.optimize_bank(tb, num_steps=3, learning_rate=0.01)
    _, tb, _ = _banks(np.random.default_rng(0))
    chunked, lc = tws.optimize_bank(tb, num_steps=3, learning_rate=0.01,
                                    window_chunk=2)
    np.testing.assert_allclose(lc, lw, rtol=1e-12)
    for (_, a), (_, b) in zip(named_params(chunked), named_params(whole)):
        np.testing.assert_allclose(a.raw.detach().numpy(), b.raw.detach().numpy(),
                                   rtol=1e-12, atol=1e-14)
    # method="lbfgs" trains: one solver per window, finite and decreasing
    # best-visited losses
    lbfgs, ll = tws.optimize_bank(tb, num_steps=5, method="lbfgs")
    assert np.isfinite(ll).all() and ll[-1] < ll[0]
    best = tws.bank_loss(lbfgs).item()
    assert np.isfinite(best) and best <= ll.min() + 1e-9 * abs(ll.min())
    with pytest.raises(ValueError, match="unknown method"):
        tws.optimize_bank(tb, num_steps=1, method="sgd")
    with pytest.raises(NotImplementedError, match="item 16"):
        tws.optimize_bank(tb, num_steps=1, mesh=object())


def _bound_and_grads(model):
    """The bound (per window) and the gradient of its sum in every
    trainable raw leaf."""
    for _, p in named_params(model):
        p.raw.grad = None
    bound = model.elbo()
    bound.sum().backward()
    return bound.detach(), {name: p.raw.grad.clone() for name, p in named_params(model)
                            if p.trainable}


def _jax_bound_and_grads(jm, batched):
    def f(m):
        return m.elbo()
    if batched:
        return (jax.jit(jax.vmap(f))(jm),
                jax_leaves(jax.jit(jax.grad(lambda m: jax.vmap(f)(m).sum()))(jm)))
    return jax.jit(f)(jm), jax_leaves(jax.jit(jax.grad(f))(jm))


def _match_jax(bound, grads, jm, batched):
    """At the tolerances of test_sgpr_bound_and_raw_gradients_match."""
    jbound, jg = _jax_bound_and_grads(jm, batched)
    close(bound, jbound, 1e-9)
    for name, g in grads.items():
        close(g, jg[name + "[<flat index 0>]"], 1e-7)


@pytest.mark.parametrize("batched", [False, True], ids=["single", "bank"])
def test_fused_bound_matches_unfused_and_jax(batched, rng, monkeypatch):
    """An eligible f64 model on the CPU takes the fused route (the plain
    versions of kernels A and B): AAT and Aerr within 1e-12 of
    _common_unfused's, the bound and every raw gradient within 1e-10, and
    both against the JAX package's SGPR.elbo and jax.grad."""
    jm, tm = (_banks(rng)[:2] if batched else _pair(rng)[:2])
    assert tm.fused_eligible()
    err, _, _, A, AAT, (LB, _), c, sigma2 = tm._common()
    assert A is None
    _, _, _, A, AAT_ref, _, _, _ = tm._common_unfused()
    close(AAT, AAT_ref.detach(), 1e-12)
    close(sigma2 * (LB @ c), (A @ err).detach(), 1e-12)
    fused = _bound_and_grads(tm)
    monkeypatch.setattr(TSGPRSS, "fused_eligible", lambda self: False)
    unfused = _bound_and_grads(tm)
    close(fused[0], unfused[0], 1e-10)
    assert sorted(fused[1]) == sorted(unfused[1]) and len(fused[1]) == 5
    for name, g in unfused[1].items():
        close(fused[1][name], g, 1e-10)
    _match_jax(*fused, jm, batched)


@pytest.mark.parametrize("case", ["masked", "sum", "m_over_max"])
def test_ineligible_bounds_take_the_unfused_route(case, rng):
    """A mask, a Sum kernel and M > 160 (MAX_M) route to _common_unfused,
    decided by the model's structure; the bound and its raw gradients still
    match the JAX package."""
    if case == "masked":
        mask = np.ones(150)
        mask[-30:] = 0.0
        jm, tm, _ = _pair(rng, mask=mask)
    elif case == "sum":
        jm, tm, _ = _pair(rng, stacked=False)
    else:
        jm, tm, _ = _pair(rng, n=400, m=170)
    assert not tm.fused_eligible()
    assert tm._common()[3] is not None            # A is built
    _match_jax(*_bound_and_grads(tm), jm, False)
