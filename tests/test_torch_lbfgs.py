"""The port's L-BFGS (gpitch_tpu_torch.models._lbfgs, fit.lbfgs_solve /
fit_lbfgs, windowed_sgpr's per-window L-BFGS) against gpitch_tpu's, which
runs optax's L-BFGS and zoom linesearch.

Same seeded numpy inputs through both packages, f64 on the CPU, raw leaves
carried across with ``load_raw``.  On the CPU the fused route of the bank's
bound runs the plain versions of kernels A and B, so the bank tests cover
them.  Tolerances: trajectories and final raw leaves 1e-8 (relative;
leaves of max|ref|), segments and chunks of one solve against the whole
1e-12.

``tests/torch_lbfgs_goldens.npz`` holds the JAX package's f64 trajectories
that ``chip_smoke.py`` holds the card's f32 runs against, and the spread of
the port's own f32 runs on the CPU that its limits are set from.  Write it
anew (a few minutes) with

    JAX_PLATFORMS=cpu python -m tests.test_torch_lbfgs --write-goldens
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from gpitch_tpu.kernels import Matern32 as JMatern32
from gpitch_tpu.models import SGPR as JSGPR
from gpitch_tpu.models.fit import fit_modgp as j_fit_modgp
from gpitch_tpu.models.fit import lbfgs_solve as j_lbfgs_solve
from gpitch_tpu.pipelines import windowed_sgpr as jws
from gpitch_tpu_torch.core.params import load_raw, named_params, take_windows
from gpitch_tpu_torch.kernels import Matern32 as TMatern32
from gpitch_tpu_torch.models import SGPR as TSGPR
from gpitch_tpu_torch.models import fit_modgp as t_fit_modgp
from gpitch_tpu_torch.models.fit import lbfgs_solve as t_lbfgs_solve
from gpitch_tpu_torch.pipelines import windowed_sgpr as tws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
import chip_smoke  # noqa: E402  (the port's workloads, as the card runs them)
from chip_smoke import (LBFGS_GOLDENS as GOLDENS, MODGP_LBFGS_ITERS,  # noqa: E402
                        NATGRAD, best_totals_dev)
from test_torch_sgpr import F64, JMercer, TMercer, _kerns, _windows  # noqa: E402
from test_torch_svgp import _jax_golden, _port_of  # noqa: E402

SOSP_WINDOWS, SOSP_ITERS = 16, 30          # the first 16 windows of sosp-4s



@pytest.fixture(autouse=True)
def _one_thread():
    """The solvers run thousands of small torch ops; with one intra-op
    thread each they do not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def jax_leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def close_leaves(tmodel, jmodel, rtol):
    """Every raw leaf within rtol of the largest |value| of its JAX leaf."""
    want = jax_leaves(jmodel)
    for name, p in named_params(tmodel):
        w = want[name + "[<flat index 0>]"]
        np.testing.assert_allclose(p.raw.detach().numpy(), w, rtol=0,
                                   atol=rtol * np.abs(w).max(), err_msg=name)


def _sgpr_pair():
    """The 40-point Matern32 SGPR of tests/test_sgpr.py:128-139 in both
    packages."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.random((40, 1)), axis=0)
    y = np.sin(6 * x) + 0.1 * rng.standard_normal((40, 1))
    z = x[::4]
    jm = JSGPR.create(x, y, JMatern32.create(1.0, 1.0), Z=z, noise_variance=1.0)
    tm = TSGPR.create(x, y, TMatern32.create(1.0, 1.0, dtype=F64), Z=z,
                      noise_variance=1.0, dtype=F64)
    assert load_raw(tm, jax_leaves(jm)) == len(list(named_params(tm)))
    return jm, tm


def _bank_pair(nw=4):
    """A 4-window bank of 3 stacked 4-partial kernels (tests/test_torch_sgpr's
    ``_banks``) in both packages."""
    xw, yw, zw = _windows(np.random.default_rng(0), nw=nw)
    jb = jws.build_window_bank(xw, yw, zw, lambda: jws.sum_kernel(_kerns(JMercer)),
                               grid_dt=1 / 16000.0)
    tb = tws.build_window_bank(xw, yw, zw, lambda: tws.sum_kernel(_kerns(TMercer, dtype=F64)),
                               grid_dt=1 / 16000.0, dtype=F64, device="cpu")
    return jb, tb


def _raws(model):
    return [p.raw.detach().clone() for _, p in named_params(model)]


# ------------------------------------------------------------ lbfgs_solve
def test_torch_lbfgs_solve_matches_jax():
    """30 iterations: every loss and the returned (best-visited) raw leaves
    within 1e-8; the caller's model is left unchanged."""
    jm, tm = _sgpr_pair()
    before = _raws(tm)
    jbest, jl = jax.jit(lambda m: j_lbfgs_solve(m, lambda mm: mm.loss(), num_steps=30))(jm)
    tbest, tl = t_lbfgs_solve(tm, lambda m: m.loss(), num_steps=30)
    assert tl.shape == (30,) and tl[-1] < tl[0] - 1.0
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-8)
    close_leaves(tbest, jbest, 1e-8)
    assert all(torch.equal(a, b) for a, b in zip(before, _raws(tm)))


def test_torch_lbfgs_three_segments_equal_one_solve():
    """3 x 10 iterations threading (state, best) equal one 30-iteration
    solve at rtol 1e-12 (as test_lbfgs_segment_resume_exact holds the JAX
    package), and the returned loss is <= every visited loss."""
    _, tm = _sgpr_pair()
    one, l_one = t_lbfgs_solve(tm, lambda m: m.loss(), num_steps=30)
    m, state, best, segs = tm, None, None, []
    for _ in range(3):
        m, ls, state, best = t_lbfgs_solve(m, lambda mm: mm.loss(), num_steps=10,
                                           opt_state=state, return_state=True,
                                           best_in=best)
        segs.append(ls)
    np.testing.assert_allclose(np.concatenate(segs), l_one, rtol=1e-12)
    with torch.no_grad():
        one_loss, best_loss = float(one.loss()), float(best[0].loss())
    np.testing.assert_allclose(float(best[1]), one_loss, rtol=1e-12)
    np.testing.assert_allclose(best_loss, one_loss, rtol=1e-12)
    assert one_loss <= l_one.min() + 1e-12


def test_torch_lbfgs_freezes_at_grad_tol():
    """With grad_tol above the first gradient's norm the solver never
    moves: every loss is the first and the model comes back unchanged."""
    _, tm = _sgpr_pair()
    out, losses = t_lbfgs_solve(tm, lambda m: m.loss(), num_steps=5, grad_tol=1e12)
    np.testing.assert_array_equal(losses, np.full(5, losses[0]))
    assert all(torch.equal(a, b) for a, b in zip(_raws(tm), _raws(out)))


# ------------------------------------------------------------ the bank
def test_torch_bank_lbfgs_matches_jax():
    """optimize_bank(method="lbfgs"), one solver per window, 20 iterations
    on a 4-window bank: per-step totals and the returned (each window's
    best-visited) raw leaves within 1e-8 of the JAX package's vmapped
    solvers."""
    jb, tb = _bank_pair()
    jout, jl = jws.optimize_bank(jb, num_steps=20, method="lbfgs")
    tout, tl, info = tws.optimize_bank(tb, num_steps=20, method="lbfgs", return_info=True)
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-8)
    close_leaves(tout, jout, 1e-8)
    assert info["window_losses"].shape == (4, 20)
    np.testing.assert_allclose(info["window_losses"].sum(0), tl, rtol=1e-12)
    assert info["iterations"] == 20 and len(info["trials_per_iteration"]) == 20
    assert info["trials"] == sum(info["trials_per_iteration"]) >= 20
    assert info["windows_at_initial_state"] == 0 and info["windows_nonfinite"] == 0


@pytest.fixture(scope="module")
def whole_bank_run():
    """The 4-window bank and its whole 20-iteration per-window solve."""
    _, tb = _bank_pair()
    return tb, tws._optimize_bank_lbfgs(tb, 20)


@pytest.mark.parametrize("how", ["window_chunk", "step_segment", "one_window"])
def test_torch_bank_lbfgs_parts_equal_the_whole(how, whole_bank_run):
    """Chunks of 2 windows and segments of 7 iterations against the whole
    20-iteration run: rtol 1e-12.  Window 2 solved alone against its slice
    of the whole: rtol 1e-9 for the losses and 1e-7 for the leaves (a batch
    of one window takes other matmul paths: after 20 iterations the losses
    are 3e-11 apart, the leaves 4e-9 along flat directions)."""
    tb, (whole, lw, _, info) = whole_bank_run
    rtol = 1e-12
    if how == "one_window":
        rtol = 1e-7
        part, lp, _, pinfo = tws._optimize_bank_lbfgs(take_windows(tb, slice(2, 3)), 20)
        np.testing.assert_allclose(pinfo["window_losses"][0], info["window_losses"][2],
                                   rtol=1e-9)
        whole = take_windows(whole, slice(2, 3))
    else:
        kw = {"window_chunk": 2} if how == "window_chunk" else {"step_segment": 7}
        part, lp, _, _ = tws._optimize_bank_lbfgs(tb, 20, **kw)
        np.testing.assert_allclose(lp, lw, rtol=1e-12)
    for (_, a), (_, b) in zip(named_params(part), named_params(whole)):
        np.testing.assert_allclose(a.raw.detach().numpy(), b.raw.detach().numpy(),
                                   rtol=rtol, atol=1e-14)


def test_torch_bank_lbfgs_timed_returns_the_split(whole_bank_run):
    """optimize_bank(method="lbfgs", timed=True) in chunks of 2 windows (one
    segment each): the whole run's losses and bank (rtol 1e-12), and
    (first_s, run_s) split from the segments' times beside them."""
    tb, (whole, lw, _, _) = whole_bank_run
    bank, losses, (first_s, run_s) = tws.optimize_bank(tb, 20, method="lbfgs", timed=True,
                                                       window_chunk=2)
    np.testing.assert_allclose(losses, lw, rtol=1e-12)
    assert first_s >= 0.0 and run_s > 0.0
    for (_, a), (_, b) in zip(named_params(bank), named_params(whole)):
        np.testing.assert_allclose(a.raw.detach().numpy(), b.raw.detach().numpy(),
                                   rtol=1e-12, atol=1e-14)


def test_torch_bank_lbfgs_contains_a_nan_window():
    """A window whose bound is NaN (one inducing point NaN) stays NaN and
    at its initial state; nothing raises, and every other window follows
    the run without it exactly."""
    _, tb = _bank_pair()
    clean, _, _, cinfo = tws._optimize_bank_lbfgs(tb, 10)
    _, bad = _bank_pair()
    with torch.no_grad():
        bad.Z.raw[1, 3, 0] = float("nan")
    out, losses, _, info = tws._optimize_bank_lbfgs(bad, 10)
    assert np.isnan(info["window_losses"][1]).all() and np.isnan(losses).all()
    keep = [0, 2, 3]
    np.testing.assert_array_equal(info["window_losses"][keep], cinfo["window_losses"][keep])
    assert info["windows_nonfinite"] == 1 and info["windows_at_initial_state"] == 1
    for (name, a), (_, b), (_, c) in zip(named_params(out), named_params(clean),
                                         named_params(bad)):
        a, b, c = (p.raw.detach().numpy() for p in (a, b, c))
        np.testing.assert_array_equal(a[keep], b[keep], err_msg=name)
        np.testing.assert_array_equal(a[1], c[1], err_msg=name)


def test_torch_fit_modgp_lbfgs_matches_jax():
    """fit_modgp(method="lbfgs") on the golden fixture, 15 iterations of
    full-batch L-BFGS: losses and the returned raw leaves within 1e-8."""
    jm, x, y = _jax_golden()
    tm = _port_of(jm)
    jout, jl = j_fit_modgp(jm, x, y, num_steps=MODGP_LBFGS_ITERS, method="lbfgs",
                           minibatch_size=None)
    tout, tl = t_fit_modgp(tm, x, y, num_steps=MODGP_LBFGS_ITERS, method="lbfgs",
                           minibatch_size=None)
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-8)
    close_leaves(tout, jout, 1e-8)


# ------------------------------------------------------------ the goldens
def test_torch_lbfgs_goldens_hold_for_the_port_in_f64():
    """The goldens file against the port in f64 on the CPU: the first 2
    windows of sosp-4s (chip_smoke.make_sosp, the workload of the card's
    ``lbfgs`` phase; windows are independent, so a subset is exact) for 5
    iterations, and the ModGP L-BFGS trajectory, within 1e-8."""
    gold = np.load(GOLDENS)
    assert gold["sosp16_window_losses"].shape == (SOSP_WINDOWS, SOSP_ITERS)
    sosp, _ = chip_smoke.make_sosp(4.0, "cpu", F64)
    _, _, _, info = tws._optimize_bank_lbfgs(take_windows(sosp.bank, slice(0, 2)), 5)
    np.testing.assert_allclose(info["window_losses"], gold["sosp16_window_losses"][:2, :5],
                               rtol=1e-8)
    model, x, y = chip_smoke.golden_modgp(F64, "cpu")
    _, losses = t_fit_modgp(model, x, y, num_steps=MODGP_LBFGS_ITERS, method="lbfgs",
                            minibatch_size=None)
    np.testing.assert_allclose(losses, gold["modgp_lbfgs_losses"], rtol=1e-8)


def make_goldens(path: str = GOLDENS) -> dict:
    """Write the goldens: the JAX package in f64 on the CPU runs (a) the
    per-window L-BFGS of the first 16 windows of sosp-4s
    (tests_tpu/workloads.make_sosp: ws 2001, M 112, 3 x 5 partials), 30
    iterations, (b) full-batch ``fit_natgrad_adam`` (NATGRAD) and (c)
    ``fit_modgp(method="lbfgs")`` (15 iterations) on the ModGP golden
    fixture.  Then the port runs the same in f32 on the CPU, and the file
    keeps its largest relative deviations (``port_f32_cpu_*``): loss[0]
    and the best-visited totals (``best_totals_dev``) of (a), the losses of
    (b), and the running minimum of (c).  Returns what was written."""
    from gpitch_tpu.models.natgrad import fit_natgrad_adam as j_natgrad
    from tests_tpu.workloads import make_sosp
    from gpitch_tpu_torch.models.natgrad import fit_natgrad_adam as t_natgrad

    sub = jax.tree_util.tree_map(lambda a: a[:SOSP_WINDOWS], make_sosp(4.0).bank)
    _, lw = jax.jit(jax.vmap(lambda m: j_lbfgs_solve(
        m, lambda mm: mm.loss(), num_steps=SOSP_ITERS)))(sub)
    jm, x, y = _jax_golden()
    _, ng = j_natgrad(jm, x, y, **NATGRAD)
    _, lb = j_fit_modgp(jm, x, y, num_steps=MODGP_LBFGS_ITERS, method="lbfgs",
                        minibatch_size=None)
    out = {"sosp16_window_losses": np.asarray(lw, dtype=np.float64),
           "modgp_natgrad_losses": np.asarray(ng, dtype=np.float64),
           "modgp_lbfgs_losses": np.asarray(lb, dtype=np.float64)}

    f32 = torch.float32
    sosp, _ = chip_smoke.make_sosp(4.0, "cpu", f32)
    _, _, _, info = tws._optimize_bank_lbfgs(take_windows(sosp.bank, slice(0, SOSP_WINDOWS)),
                                             SOSP_ITERS)
    gold_lw = out["sosp16_window_losses"]
    out["port_f32_cpu_sosp16_rel0"] = abs(info["window_losses"][:, 0].sum()
                                          / gold_lw[:, 0].sum() - 1)
    out["port_f32_cpu_sosp16_best_dev"] = best_totals_dev(info["window_losses"], gold_lw)
    model, xt, yt = chip_smoke.golden_modgp(f32, "cpu")
    _, tng = t_natgrad(model, xt, yt, **NATGRAD)
    out["port_f32_cpu_natgrad_rel"] = np.max(np.abs(tng / out["modgp_natgrad_losses"] - 1))
    _, tlb = t_fit_modgp(model, xt, yt, num_steps=MODGP_LBFGS_ITERS, method="lbfgs",
                         minibatch_size=None)
    out["port_f32_cpu_lbfgs_min_rel"] = np.max(np.abs(
        np.minimum.accumulate(tlb) / np.minimum.accumulate(out["modgp_lbfgs_losses"]) - 1))
    np.savez(path, **out)
    return out


if __name__ == "__main__" and "--write-goldens" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    written = make_goldens()
    print({k: (v.shape if np.ndim(v) else float(v)) for k, v in written.items()})
