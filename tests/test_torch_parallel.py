"""The port's distribution (gpitch_tpu_torch.parallel and
``optimize_bank(mesh=)``) against its unsharded runs and gpitch_tpu.

In one process: ``pad_bank_windows`` is loss-free (1e-12) and the padded
windows' gradients are zero; an unmasked bank refuses padding; without an
address or a cluster environment ``init_multihost`` returns False.

Two ranks: two worker processes (tests/torch_parallel_worker.py) join a
gloo group through a file store under the test's own directory (no port)
and run, in f64 on the CPU, the shard-map bank loss and its gradient
(nw 5, padded to 6), ``optimize_bank(mesh=)`` under Adam (also in window
chunks) and L-BFGS (nw 5: padding runs), ``SoSp.optimize(mesh=)`` on
tests/test_parallel.py's ``_tiny_sosp`` and ``shard_modgp_sources`` with 8
sources.  Each matches the port's unsharded run and the JAX package's
local values within 1e-10 (of max|ref| for arrays); the L-BFGS run's
comparison with the JAX package is in the slow tier (its compile).  The rendezvous and
the workers have time limits of their own, so a stuck group fails the test
instead of hanging the suite.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gpitch_tpu.pipelines import bank_loss as j_bank_loss
from gpitch_tpu.pipelines import optimize_bank as j_optimize_bank
from gpitch_tpu_torch.core.params import named_params
from gpitch_tpu_torch.parallel import init_multihost, pad_bank_windows
from gpitch_tpu_torch.pipelines import bank_loss, optimize_bank

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import torch_parallel_worker as worker  # noqa: E402
from test_parallel import _tiny_bank as j_tiny_bank  # noqa: E402
from test_parallel import _tiny_sosp as j_tiny_sosp  # noqa: E402
from test_torch_lbfgs import jax_leaves  # noqa: E402

WORKER_TIMEOUT_S = 300


def close(got, want, rtol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300))


def _grads(model, loss):
    names, grads = worker.trainable_grads(model, loss)
    return dict(zip(names, grads))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ one process
def test_torch_pad_bank_windows_is_loss_free():
    """6 masked windows padded to 8: the loss within 1e-12, the padded
    windows' gradients zero, the real windows' gradients unchanged."""
    bank = worker.tiny_bank(nw=6)
    loss0 = bank_loss(bank)
    padded, nw = pad_bank_windows(bank, 8)
    assert nw == 6 and padded.X.raw.shape[0] == 8
    loss = bank_loss(padded)
    np.testing.assert_allclose(loss.item(), loss0.item(), rtol=1e-12)
    g0, g = _grads(bank, loss0), _grads(padded, loss)
    for name, grad in g.items():
        assert torch.all(grad[6:] == 0), name
        close(grad[:6].numpy(), g0[name].numpy(), 1e-12)
    same, n = pad_bank_windows(bank, 3)
    assert same is bank and n == 6
    with pytest.raises(ValueError):
        pad_bank_windows(worker.tiny_bank(nw=5, masks=False), 2)


def test_torch_init_multihost_without_a_cluster_returns_false(monkeypatch):
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert init_multihost() is False


# ---------------------------------------------------------------- two ranks
@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Rank 0's results of the two-rank runs (see the worker)."""
    d = tmp_path_factory.mktemp("gloo")
    out = str(d / "out.npz")
    procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "tests",
                                                            "torch_parallel_worker.py"),
                               str(rank), "2", str(d / "store"), out],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              cwd=ROOT) for rank in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    return dict(np.load(out, allow_pickle=False))


def test_torch_shard_map_bank_loss_matches_local(two_ranks):
    """The shard-map loss of the padded, sharded bank and every trainable
    leaf's gradient against the unsharded bank (port and JAX)."""
    bank = worker.tiny_bank()
    loss = bank_loss(bank)
    close(two_ranks["shard_loss"], loss.item())
    close(two_ranks["shard_loss"], float(j_bank_loss(j_tiny_bank(nw=5))))
    jg = jax_leaves(jax.jit(jax.grad(j_bank_loss))(j_tiny_bank(nw=5)))
    for name, g in _grads(bank, loss).items():
        got = two_ranks[f"shard_grad{name}"].reshape(g.shape)
        close(got, g.numpy())
        close(got, jg[name + "[<flat index 0>]"])


@pytest.mark.parametrize("case", ["adam", "adam_chunked", "lbfgs"])
def test_torch_optimize_bank_mesh_matches_unsharded(two_ranks, case):
    """optimize_bank(mesh=) on 5 windows over 2 ranks (one padded window):
    the per-step totals and every leaf of the returned bank against the
    unsharded port run and the JAX package's local run."""
    kw = {"adam": dict(num_steps=5, learning_rate=0.05),
          "adam_chunked": dict(num_steps=5, learning_rate=0.05, window_chunk=2, segment=2),
          "lbfgs": dict(num_steps=6, method="lbfgs")}[case]
    local, losses = optimize_bank(worker.tiny_bank(), **kw)
    close(two_ranks[f"{case}_losses"], losses)
    for name, p in named_params(local):
        close(two_ranks[f"{case}{name}"], p.raw.detach().numpy())
    if case != "lbfgs":       # (the JAX package's L-BFGS compiles for ~15 s: below)
        _close_to_jax(two_ranks, case, kw, local)


def _close_to_jax(two_ranks, case, kw, local):
    jkw = {k: v for k, v in kw.items() if k != "segment"}
    jlocal, jlosses = j_optimize_bank(j_tiny_bank(nw=5), **jkw)
    close(two_ranks[f"{case}_losses"], np.asarray(jlosses))
    jl = jax_leaves(jlocal)
    for name, p in named_params(local):
        if p.trainable:
            close(two_ranks[f"{case}{name}"], jl[name + "[<flat index 0>]"])


@pytest.mark.slow
def test_torch_optimize_bank_mesh_lbfgs_matches_jax(two_ranks):
    """The two-rank L-BFGS run against the JAX package's local run."""
    kw = dict(num_steps=6, method="lbfgs")
    _close_to_jax(two_ranks, "lbfgs", kw, optimize_bank(worker.tiny_bank(), **kw)[0])


def test_torch_sosp_on_two_ranks_matches_single_process(two_ranks):
    """SoSp.optimize(maxiter=5, mesh=) on the tiny separation: the losses
    and matrix_var against one process (port) and the JAX package."""
    m = worker.tiny_sosp()
    losses = m.optimize(maxiter=5, learning_rate=0.02)
    close(two_ranks["sosp_losses"], losses)
    close(two_ranks["sosp_matrix_var"], m.matrix_var)
    jm = j_tiny_sosp()
    jlosses = jm.optimize(maxiter=5, learning_rate=0.02)
    close(two_ranks["sosp_losses"], np.asarray(jlosses))
    close(two_ranks["sosp_matrix_var"], np.asarray(jm.matrix_var))


def test_torch_modgp_sources_on_two_ranks_match(two_ranks):
    """8 sources over 2 ranks: the loss and every trainable leaf's gradient
    (per-source leaves gathered in rank order) equal the whole model's."""
    from gpitch_tpu.kernels import Matern32, MercerMatern12sm
    from gpitch_tpu.models import ModGP
    model, x, y = worker.modgp_data()
    loss = model.loss(x, y)
    close(two_ranks["modgp_loss"], loss.item())
    z = np.linspace(0, 1, 6).reshape(-1, 1)
    jm = ModGP.create(z=[[z] * 8, [z] * 8],
                      kern=[[Matern32.create(1.0, 1.0) for _ in range(8)],
                            [MercerMatern12sm.create(1.0, 0.5, [1.0], [10.0 * (i + 1)])
                             for i in range(8)]])
    close(two_ranks["modgp_loss"], float(jm.loss(x.numpy(), y.numpy())))
    for name, g in _grads(model, loss).items():
        got = two_ranks[f"modgp_grad{name}"].reshape(g.shape)
        close(got, g.numpy())
