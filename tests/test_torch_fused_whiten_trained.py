"""The fused pair's f32 gradient at a state that per-window L-BFGS reaches
(gpitch_tpu_torch/linalg/fused_whiten.py), against f64 and the JAX package.

The state: the first 16 windows of sosp-4s (``chip_smoke.make_sosp``, the
workload of tests_tpu/workloads.make_sosp) after 30 iterations of the
port's per-window L-BFGS in f64 (total loss 43378.4 -> -65835.5), kept in
``tests/torch_fused_whiten_trained_state.npz`` (every kernel raw and the
noise raw, ~600 numbers).  There the bound is ill-conditioned: the
cotangent G = dU + dU^T of U = A A^T reaches ~4e7.  Write the file anew
(~1-2 min) with

    JAX_PLATFORMS=cpu python -m tests.test_torch_fused_whiten_trained --write-goldens

The f32 bank is the state's raws cast to float32; the arbiter is the same
bound in f64 with float32's jitters (``chip_smoke.f32_jitters``).  The
gradient of the total loss in the trainable raws is held to 2e-4 relative
norm (docs/F32_ACCURACY.md:57).  Measured on the CPU: kernel B's earlier
association, C = Linv^T G Linv applied to Kuf, put the fused route 9.3e-4
away; the prototype's association 1.7e-4, and with B = I + AAT / sigma^2
factored in f64 (the largest error left) 6.5e-5; the unfused route 2.8e-4,
then 1.1e-4 (the JAX package's f32 gradient: 2.4e-4).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpitch_tpu import config as jconfig
from gpitch_tpu_torch.core.params import Param, map_params, named_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the workload and the state, as the card loads them)
from chip_smoke import TRAINED_STATE, TRAINED_WINDOWS, bank_grad, f32_jitters  # noqa: E402

F64 = torch.float64
ITERS = 30           # L-BFGS iterations of the saved state
TOL = 2e-4           # docs/F32_ACCURACY.md:57
M = 112              # the sosp workload's inducing points


@pytest.fixture(scope="module")
def banks():
    """(the f64 bank at the saved state, its raws cast to float32)."""
    b64 = chip_smoke.trained_bank("cpu", F64)
    b32 = map_params(b64, lambda p: Param(p.raw.detach().float(), p.transform, p.trainable))
    return b64, b32


@pytest.fixture(scope="module")
def arbiter(banks):
    with f32_jitters(M):
        return bank_grad(banks[0])


def _rel(got, want):
    return float((got - want).norm() / want.norm())


def test_trained_state_file_holds_every_kernel_and_noise_raw():
    state = np.load(TRAINED_STATE)
    b64 = chip_smoke.trained_bank("cpu", F64)
    names = {k for k, _ in named_params(b64) if k.startswith(".kern.") or k == ".variance"}
    assert set(state.files) == names
    for k, p in named_params(b64):
        if k in names:
            assert state[k].shape[0] == TRAINED_WINDOWS
            np.testing.assert_array_equal(p.raw.detach().numpy(), state[k])


@pytest.mark.parametrize("route", ["fused", "unfused"])
def test_f32_gradient_at_the_trained_state_is_within_2e_4_of_f64(banks, arbiter, route,
                                                                 monkeypatch):
    """The f32 bank's bound by the fused route (kernel A's and B's plain
    versions on the CPU) and by the unfused composition: value within 1e-5
    and gradient within 2e-4 of f64."""
    _, b32 = banks
    assert b32.fused_eligible()
    if route == "unfused":
        monkeypatch.setattr(type(b32), "fused_eligible", lambda self: False)
    loss64, grad64 = arbiter
    loss, grad = bank_grad(b32)
    assert abs(loss / loss64 - 1) <= 1e-5
    assert _rel(grad, grad64) <= TOL, _rel(grad, grad64)


def test_f32_bound_factors_b_in_f64(banks):
    """B = I + AAT / sigma^2 of the f32 bank is factored in f64 and its
    factors rounded once to f32 (models/sgpr.py ``_finish``)."""
    from gpitch_tpu_torch.linalg.ops import safe_chol_inv
    _, b32 = banks
    with torch.no_grad():
        _, _, _, _, aat, (lb, lb_inv), _, _ = b32._common()
        want = safe_chol_inv((aat + torch.eye(M)).double(), 0.0, jitter_rel=0.0)
    assert lb.dtype == lb_inv.dtype == torch.float32
    assert torch.equal(lb, want[0].float()) and torch.equal(lb_inv, want[1].float())


def test_f64_fused_and_unfused_routes_agree_at_the_trained_state(banks, arbiter,
                                                                 monkeypatch):
    """In f64 the plain backward's association and autograd through the
    unfused composition give one gradient (1e-9)."""
    b64, _ = banks
    monkeypatch.setattr(type(b64), "fused_eligible", lambda self: False)
    with f32_jitters(M):
        _, unfused = bank_grad(b64)
    assert _rel(unfused, arbiter[1]) <= 1e-9


def _flat(tree) -> dict:
    """A JAX model's leaves by the port's Param names."""
    return {jax.tree_util.keystr(p).replace("[<flat index 0>]", ""): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_arbiter_equals_the_jax_package_f64_gradient(arbiter):
    """The arbiter (f64, float32's jitters) against jax.grad of the JAX
    package's summed SGPR.elbo (``bank_loss``) in f64 with the same
    jitters, at the same raws: within 1e-9 of the gradient's norm."""
    from gpitch_tpu.pipelines import windowed_sgpr as jws
    from tests_tpu.workloads import make_sosp
    bank = jax.tree_util.tree_map(lambda a: a[:TRAINED_WINDOWS], make_sosp(4.0).bank)
    state = np.load(TRAINED_STATE)
    paths, treedef = jax.tree_util.tree_flatten_with_path(bank)
    names = [jax.tree_util.keystr(p).replace("[<flat index 0>]", "") for p, _ in paths]
    bank = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(state[k]) if k in state.files else leaf
        for k, (_, leaf) in zip(names, paths)])
    jconfig.set_jitter(1e-4)
    jconfig.set_jitter_rel(8e-7 * M)
    try:
        grads = _flat(jax.jit(jax.grad(jws.bank_loss))(bank))
    finally:
        jconfig.set_jitter(None)
        jconfig.set_jitter_rel(None)
    b64 = chip_smoke.trained_bank("cpu", F64)
    want = np.concatenate([grads[k].reshape(-1) for k, p in named_params(b64) if p.trainable])
    got = arbiter[1].numpy()
    assert np.linalg.norm(got - want) <= 1e-9 * np.linalg.norm(want)


def make_goldens(path: str = TRAINED_STATE) -> dict:
    """Run the port's per-window L-BFGS in f64 on the CPU over the first 16
    windows of sosp-4s (30 iterations) and save each window's best-visited
    kernel and noise raws.  Returns what was written."""
    from gpitch_tpu_torch.core.params import take_windows
    from gpitch_tpu_torch.pipelines import windowed_sgpr as tws
    model, _ = chip_smoke.make_sosp(4.0, "cpu", F64)
    bank = take_windows(model.bank, slice(0, TRAINED_WINDOWS))
    best, losses, _, _ = tws._optimize_bank_lbfgs(bank, ITERS)
    out = {k: p.raw.detach().numpy().copy() for k, p in named_params(best)
           if k.startswith(".kern.") or k == ".variance"}
    np.savez(path, **out)
    print("total loss", float(losses[0]), "->", float(losses[-1]))
    return out


if __name__ == "__main__" and "--write-goldens" in sys.argv:
    written = make_goldens()
    print({k: v.shape for k, v in written.items()})
