"""The f32 log density and gradient of HMC over a trained bank's kernel
leaves (``chip_smoke.py`` phase hmc (c)) at the card's own state, against
f64 and the JAX package.

The state, ``tests/torch_hmc_bank_state.npz``, was written on the card by

    python3 chip_smoke.py --write-hmc-state tests/torch_hmc_bank_state.npz

the first 16 windows of sosp-4s after lbfgs (a)'s 30 f32 L-BFGS iterations
(every raw leaf of the bank but X and Y, whose sums it keeps) and the 4
chains' start, init + 0.1 N(0, 1) per chain from a CUDA generator seeded
4, which a CPU run cannot replay.  The chains are folded into the window
axis (64 windows in one evaluation of the bound) or taken one at a time (16
windows); both f32 gradients are held to 2e-4 relative norm
(docs/F32_ACCURACY.md:57) of the same function in f64 with float32's
jitters.  Each f32 part's share of the error (``chip_smoke.hmc_bank_parts``)
prints, on the CPU, with

    JAX_PLATFORMS=cpu python -m tests.test_torch_hmc_bank_state --parts
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpitch_tpu import config as jconfig
from gpitch_tpu_torch.core.params import named_params, take_windows

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the workload, the chains and the check, as the card runs them)
from chip_smoke import bank_grad, f32_jitters  # noqa: E402

TOL = 2e-4           # docs/F32_ACCURACY.md:57
M = 112              # the sosp workload's inducing points


@pytest.fixture(scope="module")
def loaded():
    return chip_smoke.saved_hmc_bank("cpu")


@pytest.fixture(scope="module")
def check(loaded):
    bank, chains, _ = loaded
    return chip_smoke.hmc_bank_check(bank, chains)


def test_state_file_holds_the_card_bank_and_the_chains(loaded):
    """Every raw leaf but X and Y, whose sums equal those of the CPU's own
    sosp-4s windows (the data are the same), and 4 chains of the 528 kernel
    raws a chain (3 + 15 + 15 per window)."""
    bank, chains, state = loaded
    model, _ = chip_smoke.make_sosp(4.0, "cpu", torch.float32)
    fresh = dict(named_params(take_windows(model.bank, slice(0, 16))))
    for key in (".X", ".Y"):
        raw = fresh[key].raw.detach().double()
        np.testing.assert_allclose(state[f"sum{key}"], [float(raw.sum()),
                                                        float(raw.square().sum())], rtol=1e-12)
    np.testing.assert_array_equal(state[".Z"], fresh[".Z"].raw.detach().numpy())
    names = {k for k, _ in named_params(bank)} - {".X", ".Y"}
    assert {k for k in state.files if not k.startswith(("chain", "sum"))} == names
    assert set(chains) == {k for k, p in named_params(bank)
                           if p.trainable and k.startswith(".kern.")}
    assert sum(v[0].numel() for v in chains.values()) == 528
    assert all(v.shape[0] == chip_smoke.HMC_BANK["num_chains"] for v in chains.values())


def test_folded_log_density_equals_one_chain_at_a_time(check):
    assert check["value_rel"] <= 1e-5


@pytest.mark.parametrize("how", ["folded", "one"])
def test_f32_gradient_at_the_card_state_is_within_2e_4_of_f64(check, how):
    """The f32 gradient of the chains' log density (the fused route, its
    plain versions on the CPU; B's factors and c from float64), folded
    into 64 windows or one chain of 16 at a time, against f64: within 2e-4
    relative norm, the value within 1e-5."""
    assert check[f"f64_value_rel_{how}"] <= 1e-5
    assert check[f"f64_grad_rel_norm_{how}"] <= TOL, check


def test_f32_bound_forms_c_from_the_f64_factor(loaded):
    """c = LB^-1 Aerr / sigma^2 of the f32 bank is formed from B's float64
    factor and rounded once to f32 (models/sgpr.py ``_finish``), as B's
    factors are."""
    from gpitch_tpu_torch.linalg import fused_whiten
    from gpitch_tpu_torch.linalg.ops import safe_chol_inv
    bank, _, _ = loaded
    with torch.no_grad():
        u, aerr = fused_whiten(*bank.fused_whiten_args())
        sigma2 = bank.variance.value[..., None, None]
        aat = u / sigma2
        got = bank._finish(aat, aerr, sigma2)
        lb, lb_inv = safe_chol_inv((aat + torch.eye(M)).double(), 0.0, jitter_rel=0.0)
        want = (lb_inv @ aerr.double()) / sigma2.double()
    assert got[2].dtype == torch.float32
    assert torch.equal(got[2], want.float())
    assert torch.equal(got[1][0], lb.float()) and torch.equal(got[1][1], lb_inv.float())


def _flat(tree) -> dict:
    """A JAX model's leaves by the port's Param names."""
    return {jax.tree_util.keystr(p).replace("[<flat index 0>]", ""): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_arbiter_equals_the_jax_package_f64_gradient():
    """The f64 bound with float32's jitters at chain 0's start against
    jax.grad of the JAX package's summed SGPR.elbo (``bank_loss``) in f64
    with the same jitters at the same raws: within 1e-9 of the gradient's
    norm (the arbiter's log density is minus this loss plus its prior).
    Every leaf is the f32 bank's (the saved ones the card's, the
    lengthscales from its own FFT init; the data rounded to f32)."""
    from gpitch_tpu.pipelines import windowed_sgpr as jws
    from tests_tpu.workloads import make_sosp
    b64, chains, state = chip_smoke.saved_hmc_bank("cpu", torch.float64)
    raws = {k: v[0] for k, v in chains.items()}
    raws.update({k: torch.as_tensor(state[k], dtype=torch.float64) for k in (".variance",)})
    bank = jax.tree_util.tree_map(lambda a: a[:chip_smoke.TRAINED_WINDOWS],
                                  make_sosp(4.0).bank)
    paths, treedef = jax.tree_util.tree_flatten_with_path(bank)
    names = [jax.tree_util.keystr(p).replace("[<flat index 0>]", "") for p, _ in paths]
    saved = set(state.files) - {".X", ".Y"}
    bank = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(raws[k].numpy()) if k in raws else
        jnp.asarray(state[k], dtype=leaf.dtype) if k in saved else
        jnp.asarray(np.asarray(leaf, np.float32), dtype=leaf.dtype)
        for k, (_, leaf) in zip(names, paths)])
    jconfig.set_jitter(1e-4)
    jconfig.set_jitter_rel(8e-7 * M)
    try:
        grads = _flat(jax.jit(jax.grad(jws.bank_loss))(bank))
    finally:
        jconfig.set_jitter(None)
        jconfig.set_jitter_rel(None)
    for key, prm in named_params(b64):
        if key in raws:
            with torch.no_grad():
                prm.raw.copy_(raws[key])
    with f32_jitters(M):
        _, got = bank_grad(b64)
    want = np.concatenate([grads[k].reshape(-1) for k, p in named_params(b64) if p.trainable])
    assert np.linalg.norm(got.numpy() - want) <= 1e-9 * np.linalg.norm(want)


if __name__ == "__main__" and "--parts" in sys.argv:
    bank32, start, _ = chip_smoke.saved_hmc_bank("cpu")
    print(json.dumps(chip_smoke.hmc_bank_parts(bank32, start), indent=1))
