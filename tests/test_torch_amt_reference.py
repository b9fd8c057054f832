"""The port's transcription bank (``pipelines.AMT``) against the
benchmark's plain reference (benchmark/reference.py: plain numpy and torch,
no module of the port), on the CPU at a small size of the transcription
cell's configuration (benchmark/configs/amt63x20-2s.json): 3 windows of
2001 samples at 44.1 kHz, M 24, 6 keys x 20 partials, y x 20, the
lengthscales trained.  Both start from the same seeded random raw leaves;
every window's bound and every leaf's gradient are compared.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from benchmark import drivers, generator, reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(dtype: str) -> dict:
    """The cell's configuration cut to 3 windows (4004 samples), M 24 and
    6 keys, every width of a key kept: 20 partials, 2 s notes."""
    with open(os.path.join(ROOT, "benchmark", "configs", "amt63x20-2s.json")) as f:
        config = copy.deepcopy(json.load(f))
    config.update(dtype=dtype, seconds=0.0908, pitches=[33, 45, 57, 60, 64, 79],
                  num_inducing=24, reference_block=2)
    config["score"]["onsets"] = [[33, 0.0], [57, 0.01], [64, 0.02], [45, 0.04], [60, 0.05],
                                 [79, 0.06]]
    return config


def _random_leaves(raw: dict, seed: int) -> dict:
    """Seeded raw leaves about the start: the variances, lengthscales,
    energies and noise moved by up to ~0.3 in raw (softplus) units, each
    frequency by ~0.2%."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k in sorted(raw):
        v = raw[k].double()
        noise = torch.randn(v.shape, generator=gen, dtype=torch.float64)
        out[k] = v * (1.0 + 2e-3 * noise) if k == "frequency" else v + 0.3 * noise
    return out


def _program(config, rec, leaves):
    """The port's bank built as the benchmark builds it, its raw leaves set
    to ``leaves``: (each window's negative bound, the gradient of their sum
    by leaf name), float64 on the host."""
    model = drivers.build_model(config, rec, "cpu")
    assert model.bank.fused_eligible()
    got = drivers.program_leaves(model.bank)
    assert sorted(got) == sorted(leaves)
    with torch.no_grad():
        for k, v in got.items():
            v.copy_(leaves[k].to(v.dtype))
    params = [v.requires_grad_(True) for v in got.values()]
    losses = model.bank.loss()
    grads = torch.autograd.grad(losses.sum(), params)
    return (losses.detach().double(),
            {k: g.double() for k, g in zip(got, grads)})


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


# float64: the same mathematics in the same type, so only the order of the
# sums differs (1e-10 of max|ref|; up to 6e-15 seen); float32: the port at
# its card type against the float64 reference at the float32 model's
# jitter, within docs/F32_ACCURACY.md's 2e-4 relative for the bound and the
# gradients (up to 3.2e-5 seen, the energies' gradient)
TOLERANCE = {"float64": 1e-10, "float32": 2e-4}


@pytest.mark.parametrize("seed", [3, 2 ** 32 + 17])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_amt_bank_bound_and_gradient_match_the_plain_reference(dtype, seed):
    config = _config(dtype)
    rec = generator.make_recording(config, generator.job_seed(seed, 0))
    prob = reference.make_problem(config, rec)
    assert prob.nw == 3 and prob.raw["energy"].shape == (3, 6, 20)
    assert sorted(prob.raw) == ["energy", "frequency", "lengthscale", "noise", "variance"]
    leaves = _random_leaves(prob.raw, seed)
    losses, grads = _program(config, rec, leaves)
    ref_losses, ref_grads = reference.loss_and_grad(prob, leaves, config["reference_block"])
    tol = TOLERANCE[dtype]
    assert np.isfinite(losses.numpy()).all()
    assert _rel(losses, ref_losses) <= tol, (_rel(losses, ref_losses), tol)
    for k in ref_grads:
        assert _rel(grads[k], ref_grads[k]) <= tol, (k, _rel(grads[k], ref_grads[k]), tol)


@pytest.mark.parametrize("ragged", [False, True])
def test_amt_opt_info_records_the_route_its_bank_took(ragged):
    """``AMT.opt_info["route"]``: "fused" where every key's FFT gave 20
    partials (a StackedSum, through the pair's plain versions on the CPU);
    "sum" where one key's note is a bare sine (one FFT peak), so that
    ``sum_kernel`` fell back to a Sum of the keys' kernels."""
    config = _config("float64")
    rec = generator.make_recording(config, generator.job_seed(5, 0))
    if ragged:
        key = config["pitches"][-1]
        t = np.arange(rec["notes"][key].size) / rec["fs"]
        rec["notes"][key] = np.sin(2.0 * np.pi * generator.f0_of(key) * t)
    model = drivers.build_model(config, rec, "cpu")
    losses = model.optimize(maxiter=2)
    assert np.isfinite(losses).all()
    assert model.opt_info["route"] == ("sum" if ragged else "fused")
