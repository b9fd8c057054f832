"""The port's L-BFGS as the card captures it (gpitch_tpu_torch.models._lbfgs
``LbfgsSteps``: the state, the linesearch, the best-visited point, the
losses and the counts in static tensors, the counts on the device, five
parts an iteration with the evaluation and the trial under conditions)
against gpitch_tpu's optax L-BFGS.

On the CPU an iteration runs eagerly in the early-exit form (a condition
read on the host).  The card's conditional graphs run a body only where its
condition holds; the tests here also run every body unconditionally, all
``MAX_LINESEARCH_STEPS`` trial slots an iteration with the inactive ones
masked (``masked``), which must equal the early-exit form bit for bit.

Same seeded numpy inputs through both packages, f64 on the CPU, raw leaves
carried across with ``load_raw``.  Tolerances: trajectories and returned
leaves 1e-8 against the JAX package (relative; leaves of max|ref|), the
masked form against the early-exit form exactly, segments and chunks
against the whole run 1e-12.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gpitch_tpu.models.fit import fit_modgp as j_fit_modgp
from gpitch_tpu.models.fit import lbfgs_solve as j_lbfgs_solve
import gpitch_tpu.pipelines.kernel_learning as jkl
from gpitch_tpu_torch.core.params import named_params
from gpitch_tpu_torch.models import fit_modgp as t_fit_modgp
from gpitch_tpu_torch.models._lbfgs import MAX_LINESEARCH_STEPS, LbfgsSteps, lbfgs_run
from gpitch_tpu_torch.models.fit import ParamRows
import gpitch_tpu_torch.pipelines.kernel_learning as tkl
from gpitch_tpu_torch.pipelines import windowed_sgpr as tws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
from chip_smoke import MODGP_LBFGS_ITERS  # noqa: E402
from test_torch_lbfgs import _bank_pair, _sgpr_pair, close_leaves  # noqa: E402
from test_torch_svgp import _jax_golden, _port_of  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """The solvers run thousands of small torch ops; with one intra-op
    thread each they do not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def masked(monkeypatch):
    """Every condition's body runs, whatever the condition: the trial slots
    of an iteration all run, the inactive problems masked."""
    def run_always(self, pred, body):
        body()
        return True
    monkeypatch.setattr(LbfgsSteps, "_if", run_always)


def _equal_leaves(a, b):
    for (name, p), (_, q) in zip(named_params(a), named_params(b)):
        assert torch.equal(p.raw, q.raw), name


# ------------------------------------------------------------ against JAX
def test_torch_masked_slots_bank_matches_jax(masked):
    """A 4-window bank, 20 iterations with all 20 trial slots of each run
    and the inactive ones masked: every window's losses and its returned
    (best-visited) raw leaves within 1e-8 of the JAX package's vmapped
    solvers; the counts read from the device add up (the trials of each
    iteration sum to the trials, each iteration took at least one)."""
    jb, tb = _bank_pair()
    jbest, jl = jax.jit(jax.vmap(lambda m: j_lbfgs_solve(m, lambda mm: mm.loss(),
                                                         num_steps=20)))(jb)
    tbest, tl, _, info = tws._optimize_bank_lbfgs(tb, 20)
    np.testing.assert_allclose(info["window_losses"], np.asarray(jl), rtol=1e-8)
    np.testing.assert_allclose(tl, np.asarray(jl).sum(0), rtol=1e-8)
    close_leaves(tbest, jbest, 1e-8)
    assert info["iterations"] == 20 and len(info["trials_per_iteration"]) == 20
    assert info["trials"] == sum(info["trials_per_iteration"])
    assert min(info["trials_per_iteration"]) >= 1
    assert max(info["trials_per_iteration"]) <= MAX_LINESEARCH_STEPS
    assert info["grad_evaluations"] == 1 and info["value_evaluations"] == 1


def test_torch_masked_slots_fit_modgp_lbfgs_matches_jax(masked):
    """fit_modgp(method="lbfgs") on the ModGP golden fixture, 15 iterations
    with every trial slot run: the losses and the returned raw leaves
    within 1e-8 of the JAX package's."""
    jm, x, y = _jax_golden()
    jout, jl = j_fit_modgp(jm, x, y, num_steps=MODGP_LBFGS_ITERS, method="lbfgs",
                           minibatch_size=None)
    tout, tl = t_fit_modgp(_port_of(jm), x, y, num_steps=MODGP_LBFGS_ITERS,
                           method="lbfgs", minibatch_size=None)
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-8)
    close_leaves(tout, jout, 1e-8)


def test_torch_masked_slots_kernel_learning_solve_matches_jax(masked):
    """kernel learning's batched fit (``_solve``: 3 problems in one solver,
    30 iterations, every trial slot run) against the JAX package's compiled
    fit of each problem alone: the last parameters and the losses within
    1e-8 (the problems are independent, as the JAX package's one fit per
    pitch)."""
    rng = np.random.default_rng(5)
    x = np.linspace(0.0, 100.0 / 16000.0, 101)
    truth = np.hstack([[0.0, 0.004], [1.0, 0.5, 0.25], [262.0, 524.0, 786.0]])
    p0 = truth * (1.0 + 0.1 * rng.standard_normal((3, truth.size)))
    target = np.asarray(jkl.approximate_kernel(truth, x))
    run = jkl._kernelfit_runner(30, truth.size, x.size, "float64")
    want = [run(p, x, target) for p in p0]
    got, losses = tkl._solve(tkl.approximate_kernel, torch.as_tensor(p0), torch.as_tensor(x),
                             torch.as_tensor(target), 30, best=False)
    for i, (wp, wl) in enumerate(want):
        np.testing.assert_allclose(losses[i].numpy(), np.asarray(wl), rtol=1e-8)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(wp), rtol=0,
                                   atol=1e-8 * np.abs(np.asarray(wp)).max())


# ------------------------------------------------------------ the two forms
def _bank_run(bank, iters=12, **kw):
    out, losses, _, info = tws._optimize_bank_lbfgs(bank, iters, **kw)
    return out, losses, info


def test_torch_masked_slots_equal_early_exit_bit_for_bit(monkeypatch):
    """All trial slots run, the inactive problems masked, against the
    early-exit form: the same losses, returned leaves, counts and trials of
    each iteration, bit for bit, on a 4-window bank and on one problem."""
    _, tb = _bank_pair()
    _, tm = _sgpr_pair()
    early = _bank_run(tb)
    early_one = lbfgs_run(*_sgpr_fns(tm), num_steps=12)

    def run_always(self, pred, body):
        body()
        return True
    monkeypatch.setattr(LbfgsSteps, "_if", run_always)
    full = _bank_run(tb)
    full_one = lbfgs_run(*_sgpr_fns(tm), num_steps=12)
    np.testing.assert_array_equal(full[1], early[1])
    _equal_leaves(full[0], early[0])
    for key in ("window_losses", "trials_per_iteration", "trials", "iterations",
                "grad_evaluations", "value_evaluations", "windows_at_initial_state",
                "windows_nonfinite"):
        np.testing.assert_array_equal(full[2][key], early[2][key], err_msg=key)
    for a, b in zip(full_one[:2], early_one[:2]):
        assert torch.equal(a, b)
    assert full_one[4].trials_per_iteration == early_one[4].trials_per_iteration
    # the early-exit form reads a condition per slot it reaches, the masked
    # form none: it runs every slot
    assert full[2]["syncs"] < early[2]["syncs"]


def _sgpr_fns(model):
    rows = ParamRows(model, lambda m: m.loss(), batched=False)
    return rows.value_and_grad, rows.value, rows.rows()


def test_torch_static_buffers_hold_the_device_counts():
    """The solver's counts live on the device, indexed by its iteration
    count: after 6 iterations the count is 6, the losses are written at
    0..5, the trials of each iteration sum to the trial count, and a load
    starts the count and the losses again while the counts go on."""
    _, tm = _sgpr_pair()
    f, fv, w = _sgpr_fns(tm)
    run = LbfgsSteps(f, fv, w, 8)
    run.load(w)
    run.run(6)
    losses = run.read(0, 6)[0]
    assert int(run.i) == 6 and np.isfinite(losses).all()
    assert (run.losses[:, 6:] == 0).all()
    counts = run.counts.tolist()
    assert counts[0] == 6 and counts[1] == int(run.trials.sum()) == run.stats.trials
    assert run.stats.trials_per_iteration == run.trials[:6].tolist()
    run.load(w)
    assert int(run.i) == 0 and (run.losses == 0).all() and int(run.trials.sum()) == 0
    run.run(6)
    np.testing.assert_array_equal(run.read(0, 6)[0], losses)
    assert run.stats.iterations == 12


# ------------------------------------------------------------ parts
@pytest.fixture(scope="module")
def whole_run():
    _, tb = _bank_pair()
    return tb, _bank_run(tb, 20)


@pytest.mark.parametrize("how", [{"step_segment": 7}, {"window_chunk": 2},
                                 {"window_chunk": 3}, {"window_chunk": 2, "step_segment": 5}])
def test_torch_captured_lbfgs_segments_and_chunks_equal_the_whole(how, whole_run, masked):
    """Segments of the iterations and chunks of the windows (chunks of 3:
    the last chunk padded by copies of the last window, as the JAX package
    pads it) against the whole 20-iteration run, every trial slot run:
    the per-window losses and the returned leaves at rtol 1e-12."""
    tb, (whole, _, winfo) = whole_run
    part, _, info = _bank_run(tb, 20, **how)
    np.testing.assert_allclose(info["window_losses"], winfo["window_losses"], rtol=1e-12)
    for (_, a), (_, b) in zip(named_params(part), named_params(whole)):
        np.testing.assert_allclose(a.raw.detach().numpy(), b.raw.detach().numpy(),
                                   rtol=1e-12, atol=1e-14)


def test_torch_captured_lbfgs_contains_a_nan_window(masked):
    """A window whose bound is NaN, every trial slot run: it stays NaN and
    at its initial state, it alone is marked, and every other window
    follows the clean run exactly."""
    _, tb = _bank_pair()
    clean, _, cinfo = _bank_run(tb, 10)
    _, bad = _bank_pair()
    with torch.no_grad():
        bad.Z.raw[2, 0, 0] = float("nan")
    out, losses, info = _bank_run(bad, 10)
    keep = [0, 1, 3]
    assert np.isnan(info["window_losses"][2]).all() and np.isnan(losses).all()
    np.testing.assert_array_equal(info["window_losses"][keep], cinfo["window_losses"][keep])
    assert info["windows_nonfinite"] == 1 and info["windows_at_initial_state"] == 1
    for (name, a), (_, b), (_, c) in zip(named_params(out), named_params(clean),
                                         named_params(bad)):
        a, b, c = (p.raw.detach().numpy() for p in (a, b, c))
        np.testing.assert_array_equal(a[keep], b[keep], err_msg=name)
        np.testing.assert_array_equal(a[2], c[2], err_msg=name)


def test_torch_fits_import_no_dynamo():
    """A fresh process that runs a bank's L-BFGS, fit_lbfgs and natgrad_adam
    has not imported torch._dynamo (whose first import costs seconds)."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import numpy as np, torch\n"
        "import chip_smoke\n"
        "from gpitch_tpu_torch.kernels import MercerMatern12sm\n"
        "from gpitch_tpu_torch.models.fit import fit_lbfgs\n"
        "from gpitch_tpu_torch.models.natgrad import fit_natgrad_adam\n"
        "from gpitch_tpu_torch.pipelines import windowed_sgpr as tws\n"
        "rng = np.random.default_rng(0)\n"
        "x = np.arange(301) / 16000.0 + 2.0\n"
        "y = np.sin(2 * np.pi * 300 * x) + 0.1 * rng.standard_normal(301)\n"
        "idx = np.arange(2)[:, None] * 100 + np.arange(201)[None, :]\n"
        "zw = np.stack([np.sort(rng.choice(x[i], 16, replace=False)) for i in idx])\n"
        "kern = lambda: tws.sum_kernel([MercerMatern12sm.create(\n"
        "    0.6, 0.05, [0.6, 0.4], [300.0, 600.0], dtype=torch.float64)])\n"
        "b = tws.build_window_bank(x[idx], y[idx], zw[..., None], kern, grid_dt=1 / 16000.0,\n"
        "                          dtype=torch.float64, device='cpu')\n"
        "tws.optimize_bank(b, 2, method='lbfgs')\n"
        "m, x, y = chip_smoke.golden_modgp(torch.float64, 'cpu')\n"
        "fit_lbfgs(m, lambda mm: mm.loss(x, y), num_steps=3)\n"
        "fit_natgrad_adam(m, x, y, num_steps=3, segment=2)\n"
        "print('torch._dynamo' in sys.modules, 'sympy' in sys.modules)\n"
    ) % ROOT
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split()[-2:] == ["False", "False"], res.stdout
