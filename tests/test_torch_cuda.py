"""The port's CUDA kernels against their plain versions, on the card.

Every test needs a CUDA card and skips without one.  The file imports
nothing of JAX, so on a machine with a card and without JAX it runs as

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from gpitch_tpu_torch.linalg import ops
from gpitch_tpu_torch.linalg.chol import cholesky_batched, cholesky_plain, panel_width
from gpitch_tpu_torch.linalg.specmix import specmix_matrix, specmix_plain
from fused_whiten_inputs import prototype_inputs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


def _spd(rng, b, m):
    A = rng.standard_normal((b, m, m)) * 0.2
    return A @ np.swapaxes(A, 1, 2) + np.eye(m) * m


def _ill_gram(m):
    i = np.arange(m, dtype=np.float64)
    return np.exp(-np.abs(i[:, None] - i[None, :]) / max(m / 3.0, 1.0)) + 1e-3 * np.eye(m)


@pytest.mark.parametrize("m,dtype,b", [(24, torch.float32, 9), (100, torch.float32, 9),
                                       (112, torch.float32, 9), (128, torch.float32, 9),
                                       (136, torch.float32, 9), (160, torch.float32, 9),
                                       (200, torch.float32, 9), (256, torch.float32, 9),
                                       (112, torch.float64, 9), (160, torch.float64, 9),
                                       (256, torch.float64, 9), (112, torch.float32, 1),
                                       (112, torch.float32, 222), (160, torch.float32, 43)])
def test_cuda_cholesky_kernel_matches_plain(cuda, m, dtype, b):
    """f32: 1e-4 of max|L| (f32 rounding along the chain of panels); f64:
    1e-11.  Panels of 16 up to M 128, of 32 above (panel_width); M 256 in
    f64 runs on the device-memory scratch path; M 24, 100, 136 and 200 end
    in a ragged panel."""
    K = torch.as_tensor(_spd(np.random.default_rng(m), b, m)).to(cuda, dtype)
    before = cholesky_batched.launches
    got = cholesky_batched(K)
    assert cholesky_batched.launches == before + 1
    want = cholesky_plain(K)
    tol = (1e-4 if dtype == torch.float32 else 1e-11) * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
    assert float(torch.triu(got, 1).abs().max()) == 0.0
    g = torch.as_tensor(_ill_gram(m)).to(cuda, dtype).expand(3, m, m).contiguous()
    Lg = cholesky_batched(g)
    assert bool(torch.isfinite(Lg).all())
    assert float((Lg - cholesky_plain(g)).abs().max()) <= 1e-3 * float(Lg.abs().max())


@pytest.mark.parametrize("panel,m", [(16, 40), (32, 160)], ids=["16", "32"])
def test_cuda_cholesky_not_positive_definite_gives_nan(cuda, panel, m):
    """NaN from the failing pivot on, finite before it, also past the first
    panel (in the second panel of 16 at M 40, of 32 at M 160), as the plain
    version."""
    assert panel_width(m) == panel
    k = panel + 9
    K = torch.eye(m, dtype=torch.float32, device=cuda).repeat(2, 1, 1)
    K[1, k, k] = -1.0
    L = cholesky_batched(K)
    assert bool(torch.isfinite(L[0]).all()) and bool(torch.isnan(L[1, k:, k]).all())
    assert bool(torch.isfinite(L[1, :, :k]).all())


def test_cuda_chol_inv_on_the_low_rank_amt_gram(cuda):
    """The late-training AMT Gram of tests_tpu/test_shipped_defaults.py:61-78
    (8 pitches whose lengthscale outgrew the window: exactly rank 2P before
    the jitter) at (64, 160, 160) f32, through safe_chol_inv and so the
    kernel: L and L^-1 finite, L within 1e-3 of max|L| of the plain
    version on the same jittered Gram (the M-aware relative floor of
    add_jitter keeps the pivots above f32 rounding)."""
    from gpitch_tpu_torch.core.params import to_device
    from gpitch_tpu_torch.kernels import MercerMatern12sm, StackedSum
    m, fs = 160, 44100.0
    z = torch.as_tensor((np.arange(m) * 12.0 / fs).reshape(-1, 1), dtype=torch.float32,
                        device=cuda)
    kerns = []
    for i in range(8):
        f0 = 261.6 * 2 ** (i / 12.0)
        energy = np.full(10, 1e-4)
        energy[0] = 4.0
        kerns.append(MercerMatern12sm.create(0.8 if i == 4 else 0.014, 3.4, energy,
                                             np.minimum(f0 * np.arange(1, 11), 0.45 * fs)))
    with torch.no_grad():
        kuu = to_device(StackedSum.create(kerns), cuda).K(z).expand(64, m, m).contiguous()
        before = cholesky_batched.launches
        L, Linv = ops.safe_chol_inv(kuu)
        assert cholesky_batched.launches == before + 1
        want = cholesky_plain(ops.add_jitter(kuu))
    assert bool(torch.isfinite(L).all()) and bool(torch.isfinite(Linv).all())
    assert float((L - want).abs().max()) <= 1e-3 * float(want.abs().max())


def test_cuda_modgp_golden_fixture_f64(cuda):
    """The ModGP golden fixture in f64 on the card against
    tests/golden_values.json: rtol 1e-9, atol 1e-12."""
    import json
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke
    with open(os.path.join(root, "tests", "golden_values.json")) as fh:
        golden = json.load(fh)
    model, x, y = chip_smoke.golden_modgp(torch.float64, cuda)
    assert model.za.raw.is_cuda
    for key, value in chip_smoke.golden_modgp_values(model, x, y).items():
        np.testing.assert_allclose(np.asarray(value), np.asarray(golden[key]),
                                   rtol=1e-9, atol=1e-12, err_msg=key)


def test_cuda_chol_inv_matches_cpu(cuda):
    """The bound's factorization through the kernel, forward and backward,
    against the CPU path; f64, 1e-9 relative."""
    K = torch.as_tensor(_spd(np.random.default_rng(3), 4, 112))
    W = torch.as_tensor(np.random.default_rng(4).standard_normal((4, 112, 112)))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        k = K.to(dev).requires_grad_(True)
        L, Li = ops.safe_chol_inv(k)
        ((W.to(dev) * L).sum() + (Li ** 2).sum()).backward()
        grads.append((L.detach().cpu(), k.grad.cpu()))
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-9 * float(b.abs().max())


def _specmix_args(dev, b, s, n, m, p, dtype=torch.float32):
    rng = np.random.default_rng(9)
    arrays = (np.sort(rng.uniform(0.0, 0.125, (b, n)), axis=1),
              np.sort(rng.uniform(0.0, 0.125, (b, m)), axis=1),
              rng.uniform(0.1, 1.0, (b, s, p)), rng.uniform(100.0, 4000.0, (b, s, p)),
              rng.uniform(0.5, 2.0, (b, s)), rng.uniform(0.05, 0.3, (b, s)))
    return [torch.as_tensor(a, dtype=dtype, device=dev) for a in arrays]


@pytest.mark.parametrize("shape", [(3, 3, 300, 257, 5), (2, 88, 300, 257, 20)])
@pytest.mark.parametrize("m32", [False, True])
def test_cuda_specmix_kernel_matches_plain(cuda, m32, shape):
    """f32 with cosine arguments up to ~3e3 rad, per source and summed: the
    kernel against the f32 plain version (the same features; the sums in
    another order) at 1e-6 of max|K|, and against the f64 plain version on
    the same inputs (the truth) at 2e-6; for the sum, of sum_s max|K_s|."""
    args = _specmix_args(cuda, *shape)
    with torch.no_grad():
        before = specmix_matrix.launches
        got = specmix_matrix(*args, m32=m32)
        summed = specmix_matrix(*args, m32=m32, sum_sources=True)
        assert specmix_matrix.launches == before + 2
        want = specmix_plain(*args, m32=m32)
        truth = specmix_plain(*[a.double() for a in args], m32=m32)
    scale = truth.abs().amax((-1, -2))                       # (B, S)
    assert bool(((got - want).abs().amax((-1, -2)) <= 1e-6 * scale).all())
    assert bool(((got.double() - truth).abs().amax((-1, -2)) <= 2e-6 * scale).all())
    scale_sum = scale.sum(1)
    assert bool(((summed - want.sum(1)).abs().amax((-1, -2)) <= 1e-6 * scale_sum).all())
    assert bool(((summed.double() - truth.sum(1)).abs().amax((-1, -2))
                 <= 2e-6 * scale_sum).all())


def test_cuda_specmix_f64_matches_plain(cuda):
    """f64 kernel against the f64 plain version: 1e-12 of max|K|."""
    args = _specmix_args(cuda, 2, 3, 300, 257, 5, torch.float64)
    with torch.no_grad():
        got = specmix_matrix(*args)
        want = specmix_plain(*args)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


def test_cuda_specmix_refuses_gradients(cuda):
    args = _specmix_args(cuda, 1, 2, 8, 8, 3)
    args[4].requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        specmix_matrix(*args)


def _whiten_args(dev, nw, m, n, s, p, per_window=False, seed=0):
    """prototype_inputs at (nw, M, N, S, P), float32 on ``dev``."""
    return [torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in prototype_inputs(nw, m, n, s, p, per_window, seed)]


def _rel(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


# (nw, M, N, S, P): a ragged M and N, the SoSp and AMT widths, and sources
# that take several feature chunks
_WHITEN_SHAPES = [(3, 16, 300, 2, 3), (4, 112, 2001, 3, 5), (3, 160, 1001, 8, 10),
                  (2, 40, 77, 17, 20)]


@pytest.mark.parametrize("shape", _WHITEN_SHAPES)
@pytest.mark.parametrize("per_window", [False, True])
def test_cuda_fused_whiten_kernel_matches_plain(cuda, shape, per_window):
    """Kernel A through both entry points against the f64 plain forward:
    1e-4 of max|ref|, the prototype's own limit."""
    from gpitch_tpu_torch.linalg.fused_whiten import (fused_whiten, fused_whiten_flat,
                                                      fused_whiten_plain)
    args = _whiten_args(cuda, *shape, per_window=per_window)
    with torch.no_grad():
        want = fused_whiten_plain(*[a.double() for a in args])
        before = fused_whiten.launches
        got = fused_whiten(*args)
        assert fused_whiten.launches == before + 1
        e, f, v, il = args[4:]
        s, p = e.shape[-2:]
        flat = torch.cat([e, f, v[..., None], il[..., None]], -1).reshape(-1, s * (2 * p + 2))
        before = fused_whiten_flat.launches
        got_flat = fused_whiten_flat(*args[:4], flat, num_sources=s)
        assert fused_whiten_flat.launches == before + 1
    torch.cuda.synchronize()
    for g in (got, got_flat):
        for a, b in zip(g, want):
            assert a.shape == b.shape and bool(torch.isfinite(a).all())
            assert _rel(a, b) <= 1e-4


@pytest.mark.parametrize("shape", _WHITEN_SHAPES)
def test_cuda_fused_whiten_bwd_kernel_matches_plain(cuda, shape):
    """Kernel B, explicit and as fused_whiten's backward, against the f64
    plain backward: 1e-3 of max|ref| per output."""
    from gpitch_tpu_torch.linalg.fused_whiten import (fused_whiten, fused_whiten_bwd,
                                                      fused_whiten_bwd_plain)
    args = _whiten_args(cuda, *shape, per_window=True)
    nw, m = shape[:2]
    gen = torch.Generator().manual_seed(1)
    du = (torch.randn(nw, m, m, generator=gen) * 0.01).to(cuda)
    dv = (torch.randn(nw, m, 1, generator=gen) * 0.01).to(cuda)
    want = fused_whiten_bwd_plain(*[a.double() for a in args[:4]], du.double(),
                                  dv.double(), *[a.double() for a in args[4:]])
    before = fused_whiten_bwd.launches
    got = fused_whiten_bwd(*args[:4], du, dv, *args[4:])
    leaves = [a.clone().requires_grad_(True) for a in args[3:]]
    u, v = fused_whiten(*args[:3], *leaves)
    ((u * du).sum() + (v * dv).sum()).backward()
    assert fused_whiten_bwd.launches == before + 2
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == b.shape and _rel(a, b) <= 1e-3
    dlinv, dvar, dinvl, de, df = want
    for leaf, b in zip(leaves, (dlinv, de, df, dvar[:, 0], dinvl[:, 0])):
        assert _rel(leaf.grad, b) <= 1e-3


def test_cuda_fused_whiten_refuses_what_the_kernels_do_not_take(cuda):
    from gpitch_tpu_torch.linalg.fused_whiten import fused_whiten
    args = _whiten_args(cuda, 2, 16, 64, 2, 3)
    with pytest.raises(TypeError, match="float32"):
        fused_whiten(*[a.double() for a in args])
    big = _whiten_args(cuda, 1, 161, 64, 1, 2)
    with pytest.raises(ValueError, match="M=161"):
        fused_whiten(*big)
