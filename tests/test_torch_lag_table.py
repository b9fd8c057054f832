"""The port's lag-table route and masked banks (gpitch_tpu_torch.models.sgpr
``lag_table``, pipelines.windowed_sgpr ``build_window_bank(masks=,
lag_table=)``) against gpitch_tpu and against the port's direct route.

Same seeded host inputs through both packages, f64 on the CPU, the JAX
kernel's leaves perturbed by seeded noise and carried across with
``load_raw``.  Tolerances, relative to max|ref|: bounds, gradients and
predictions 1e-10, table against direct 1e-10, L-BFGS trajectories 1e-8;
the vectorized bank build against its loop oracle leaf for leaf at 1e-15.
"""

import sys
import os

import jax
import numpy as np
import pytest
import torch

from gpitch_tpu.kernels import StackedSum as JStacked
from gpitch_tpu.kernels import Sum as JSum
from gpitch_tpu.models.sgpr import SGPRSS as JSGPRSS
from gpitch_tpu.pipelines import windowed_sgpr as jws
from gpitch_tpu_torch.core.params import load_raw, named_params, take_windows
from gpitch_tpu_torch.kernels import Sig as TSig
from gpitch_tpu_torch.kernels import StackedSum as TStacked
from gpitch_tpu_torch.kernels import Sum as TSum
from gpitch_tpu_torch.models.sgpr import SGPRSS as TSGPRSS
from gpitch_tpu_torch.pipelines import windowed_sgpr as tws

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_sgpr import F64, JMercer, TMercer, _kerns, _windows  # noqa: E402

FS = 16000.0


def jax_leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def close(got, want, rtol, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max(),
                               err_msg=err_msg)


def perturb_kern(jm, seed=0):
    noise = np.random.default_rng(seed)
    return jm.replace(kern=jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.2 * noise.standard_normal(np.shape(a)), jm.kern),
        variance=jax.tree_util.tree_map(lambda a: np.asarray(a) - 0.5, jm.variance))


def copy_leaves(tm, jm):
    assert load_raw(tm, jax_leaves(jm)) == len(list(named_params(tm)))
    return tm


def j_grads(jm, total=False):
    fn = (lambda m: jax.numpy.sum(jax.vmap(lambda w: w.loss())(m))) if total else (
        lambda m: m.loss())
    return jax_leaves(jax.jit(jax.grad(fn))(jm))


def j_losses(jb):
    """Per-window losses of a JAX bank (one compiled program)."""
    return jax.jit(jax.vmap(lambda m: m.loss()))(jb)


def t_grads(tm):
    for _, p in named_params(tm):
        p.raw.grad = None
    tm.loss().sum().backward()
    return {name: p.raw.grad for name, p in named_params(tm) if p.trainable}


def same_grads(tm, want, rtol=1e-10):
    for name, g in t_grads(tm).items():
        close(g, want[name + "[<flat index 0>]"], rtol, err_msg=name)


# ------------------------------------------------------------ one model
def _model_pair(stacked: bool, lag_table: bool, mask=None):
    """An SGPRSS on 150 samples at 13 s (16 kHz), 20 on-grid inducing
    points, three 4-partial pitches (a StackedSum, or a Sum of kernels with
    4 and 2 partials), in both packages."""
    rng = np.random.default_rng(3)
    n = 150
    x = (13.0 + np.arange(n) / FS).reshape(-1, 1)
    y = np.sin(2 * np.pi * 220.0 * (x - 13.0)) + 0.3 * rng.standard_normal((n, 1))
    z = np.sort(rng.choice(x[:, 0], 20, replace=False)).reshape(-1, 1)
    if stacked:
        jk, tk = JStacked.create(_kerns(JMercer)), TStacked.create(_kerns(TMercer, dtype=F64))
    else:
        jk = JSum(kern_list=tuple(_kerns(JMercer)[:1]) + (JMercer.create(
            0.7, 0.08, [0.6, 0.4], [330.0, 660.0]),))
        tk = TSum(kern_list=tuple(_kerns(TMercer, dtype=F64)[:1]) + (TMercer.create(
            0.7, 0.08, [0.6, 0.4], [330.0, 660.0], dtype=F64),))
    kw = dict(Z=z, grid_dt=1 / FS, lag_table=lag_table, mask=mask)
    jm = perturb_kern(JSGPRSS.create(x, y, jk, **kw))
    tm = copy_leaves(TSGPRSS.create(x, y, tk, dtype=F64, **kw), jm)
    return jm, tm, x


@pytest.mark.parametrize("stacked", [True, False])
def test_sgpr_lag_table_matches_jax_and_the_direct_route(stacked):
    """Bound, gradient, predict_f and predict_s of the table route against
    the JAX package's table route; bound and gradient against the port's
    direct route with the same leaves (1e-10)."""
    jm, tm, x = _model_pair(stacked, lag_table=True)
    assert tm.lag_table and tm.num_lags == jm.num_lags == 150 and not tm.fused_eligible()
    close(tm.elbo(), jax.jit(lambda m: m.elbo())(jm), 1e-10)
    grads = j_grads(jm)
    same_grads(tm, grads)
    xt = torch.as_tensor(x, dtype=F64)
    with torch.no_grad():
        for got, want in zip(tm.predict_f(xt), jax.jit(
                lambda m, xx: m.predict_f(xx))(jm, jax.numpy.asarray(x))):
            close(got, want, 1e-10)
        tmeans, tvars = tm.predict_s(xt, xnew_is_x=True)
    jmeans, jvars = jax.jit(lambda m, xx: m.predict_s(xx, xnew_is_x=True))(
        jm, jax.numpy.asarray(x))
    for got, want in zip(tmeans + tvars, jmeans + jvars):
        close(got, want, 1e-10)
    _, direct, _ = _model_pair(stacked, lag_table=False)
    assert not direct.lag_table and direct.num_lags == 0
    close(tm.elbo(), direct.elbo().detach(), 1e-10)
    same_grads(direct, grads)


def test_sgpr_create_checks_the_table():
    """A table shorter than the index span, a kernel without k_r, and
    inputs off the grid all raise."""
    rng = np.random.default_rng(0)
    x = (np.arange(40) / FS).reshape(-1, 1)
    z = x[::5]
    y = rng.standard_normal((40, 1))
    kern = TStacked.create(_kerns(TMercer, dtype=F64))
    with pytest.raises(ValueError, match="num_lags"):
        TSGPRSS.create(x, y, kern, Z=z, grid_dt=1 / FS, num_lags=39, lag_table=True,
                       dtype=F64)
    assert TSGPRSS.create(x, y, kern, Z=z, grid_dt=1 / FS, num_lags=45, lag_table=True,
                          dtype=F64).num_lags == 45
    with pytest.raises(NotImplementedError, match="not stationary"):
        TSGPRSS.create(x, y, TSig.create(dtype=F64), Z=z, grid_dt=1 / FS, lag_table=True,
                       dtype=F64)
    with pytest.raises(ValueError, match="not on the grid"):
        TSGPRSS.create(x + 0.3 / FS, y, kern, Z=z, grid_dt=1 / FS, dtype=F64)
    # without grid_dt the table is off whatever lag_table says, as in JAX
    assert not TSGPRSS.create(x, y, kern, Z=z, lag_table=True, dtype=F64).lag_table


@pytest.mark.parametrize("lag_table", [False, True])
def test_masked_window_equals_its_truncation(lag_table):
    """A model whose last 50 of 150 samples are masked has the bound and
    gradient of the model of its first 100 samples (1e-10), on the direct
    and the table route."""
    mask = np.ones(150)
    mask[100:] = 0.0
    _, masked, x = _model_pair(True, lag_table, mask=mask)
    rng = np.random.default_rng(3)
    y = np.sin(2 * np.pi * 220.0 * (x - 13.0)) + 0.3 * rng.standard_normal((150, 1))
    z = np.sort(rng.choice(x[:, 0], 20, replace=False)).reshape(-1, 1)
    short = TSGPRSS.create(x[:100], y[:100], TStacked.create(_kerns(TMercer, dtype=F64)),
                           Z=z, grid_dt=1 / FS, lag_table=lag_table, dtype=F64)
    load_raw(short, {name + "[<flat index 0>]": p.raw.detach().numpy()
                     for name, p in named_params(masked) if name.startswith((".kern", ".var"))})
    assert not masked.fused_eligible()
    close(masked.elbo(), short.elbo().detach(), 1e-10)
    want = {name + "[<flat index 0>]": g.numpy() for name, g in t_grads(short).items()}
    same_grads(masked, want)


# ------------------------------------------------------------ the bank
def _masks(shape):
    """Window 2's trailing half and window 1's first 40 samples masked:
    window 1's leading samples sit at negative positions from its x0."""
    m = np.ones(shape)
    m[2, shape[1] // 2 + 50:] = 0.0
    m[1, :40] = 0.0
    return m


def _bank_pair(**kw):
    xw, yw, zw = _windows(np.random.default_rng(0), nw=3)
    if kw.pop("masked", False):
        kw["masks"] = _masks(xw.shape)
    jb = jws.build_window_bank(xw, yw, zw, lambda: jws.sum_kernel(_kerns(JMercer)),
                               grid_dt=1 / FS, **kw)
    noise = np.random.default_rng(1)
    jb = jb.replace(kern=jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * noise.standard_normal(np.shape(a)), jb.kern))
    tb = tws.build_window_bank(xw, yw, zw, lambda: tws.sum_kernel(_kerns(TMercer, dtype=F64)),
                               grid_dt=1 / FS, dtype=F64, device="cpu", **kw)
    return jb, copy_leaves(tb, jb), xw


CASES = {"lag_table": dict(lag_table=True), "masked": dict(masked=True),
         "masked_lag_table": dict(masked=True, lag_table=True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bank_matches_jax_and_never_takes_the_fused_pair(case):
    """Per-window bounds and the gradient of their sum against the JAX
    package's bank (1e-10); fused_eligible is False.  The table bank's
    num_lags covers the largest max - min span (window 1's masked leading
    samples lie before its x0)."""
    jb, tb, _ = _bank_pair(**CASES[case])
    assert not tb.fused_eligible()
    assert tb.num_lags == jb.num_lags
    if tb.lag_table:
        assert tb.num_lags == 201
    close(tb.loss(), j_losses(jb), 1e-10)
    same_grads(tb, j_grads(jb, total=True))


@pytest.mark.parametrize("masked", [False, True])
def test_table_bank_equals_the_direct_bank(masked):
    """The table bank against the port's direct bank with the same leaves:
    the unmasked direct bank takes the fused route (its plain versions
    here), the masked one the unfused; bounds and gradients 1e-10."""
    _, table, _ = _bank_pair(lag_table=True, masked=masked)
    jb, direct, _ = _bank_pair(masked=masked)
    assert direct.fused_eligible() == (not masked)
    close(table.loss(), direct.loss().detach(), 1e-10)
    want = {name + "[<flat index 0>]": g.numpy() for name, g in t_grads(direct).items()}
    same_grads(table, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bank_predictions_match_jax(case):
    """predict_bank_sources and predict_bank_mixture (1e-10)."""
    jb, tb, xw = _bank_pair(**CASES[case])
    for got, want in zip(tws.predict_bank_sources(tb, xw, batch_size=2),
                         jws.predict_bank_sources(jb, xw, batch_size=2)):
        close(got, want, 1e-10)
    for got, want in zip(tws.predict_bank_mixture(tb, xw, batch_size=2),
                         jws.predict_bank_mixture(jb, xw, batch_size=2)):
        close(got, want, 1e-10)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bank_build_matches_its_loop_oracle(case):
    """build_window_bank against nw SGPRSS.create calls stacked
    (_build_window_bank_loop), leaf for leaf, and the static table
    length."""
    kw = dict(CASES[case])
    xw, yw, zw = _windows(np.random.default_rng(0), nw=3)
    if kw.pop("masked", False):
        kw["masks"] = _masks(xw.shape)
    args = (xw, yw, zw, lambda: tws.sum_kernel(_kerns(TMercer, dtype=F64)))
    fast = tws.build_window_bank(*args, grid_dt=1 / FS, dtype=F64, device="cpu", **kw)
    loop = tws._build_window_bank_loop(*args, grid_dt=1 / FS, dtype=F64, device="cpu", **kw)
    assert (fast.num_lags, fast.lag_table) == (loop.num_lags, loop.lag_table)
    for (name, a), (_, b) in zip(named_params(fast), named_params(loop)):
        np.testing.assert_allclose(a.raw.detach().numpy(), b.raw.detach().numpy(),
                                   rtol=1e-15, atol=0, err_msg=name)


@pytest.mark.slow
def test_masked_table_bank_trains_as_jax_by_adam_and_lbfgs():
    """optimize_bank on the masked table bank: 5 Adam steps (1e-10) and 5
    per-window L-BFGS iterations (1e-8), totals against the JAX package;
    the chunks of the port's run (window_chunk=2) keep the mask."""
    jb, tb, _ = _bank_pair(masked=True, lag_table=True)
    _, jl = jws.optimize_bank(jb, num_steps=5, learning_rate=0.01)
    _, tl = tws.optimize_bank(tb, num_steps=5, learning_rate=0.01, window_chunk=2)
    close(tl, np.asarray(jl), 1e-10)
    _, jl = jws.optimize_bank(jb, num_steps=5, method="lbfgs")
    out, tl = tws.optimize_bank(tb, num_steps=5, method="lbfgs")
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-8)
    assert out.mask is not None and out.lag_table and out.num_lags == tb.num_lags
    np.testing.assert_array_equal(take_windows(out, slice(1, 2)).mask.raw.numpy(),
                                  _masks((3, 201))[1:2])


def test_masked_table_bank_trains_by_adam_and_lbfgs():
    """The port alone (the fast tier's share of the test above): 3 Adam
    steps and 3 per-window L-BFGS iterations of the masked table bank
    lower its total, keep the mask and the table, and chunks of 2 windows
    give the whole run's losses (1e-12)."""
    _, tb, _ = _bank_pair(masked=True, lag_table=True)
    for method in ("adam", "lbfgs"):
        out, losses = tws.optimize_bank(tb, num_steps=3, learning_rate=0.01, method=method)
        _, chunked = tws.optimize_bank(tb, num_steps=3, learning_rate=0.01, method=method,
                                       window_chunk=2)
        np.testing.assert_allclose(chunked, losses, rtol=1e-12)
        assert np.isfinite(losses).all() and out.loss().sum() < losses[0]
        assert out.lag_table and out.num_lags == tb.num_lags
        assert torch.equal(out.mask.raw, tb.mask.raw)


def test_chunked_vmap_over_models_and_tensors():
    _, tb, xw = _bank_pair(masked=True)
    x = torch.as_tensor(xw)
    got = tws.chunked_vmap(lambda c: (c[0].loss().detach(), c[1][:, :3]), (tb, x),
                           batch_size=2)
    close(got[0], tb.loss().detach().numpy(), 1e-15)
    close(got[1], xw[:, :3], 0.0)
