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
# that take several feature chunks; M 16, 30, 40, 112 and 160 launch every
# instance of the kernels (RU 1, 2, 4, 7, 10)
_WHITEN_SHAPES = [(3, 16, 300, 2, 3), (4, 112, 2001, 3, 5), (3, 160, 1001, 8, 10),
                  (2, 40, 77, 17, 20), (3, 30, 257, 3, 3)]


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


@pytest.mark.parametrize("shape", [(4, 112, 2001, 3, 5), (3, 160, 1001, 8, 10),
                                   (3, 30, 257, 3, 3)])
def test_cuda_fused_whiten_reads_the_lower_triangle_of_linv_only(cuda, shape):
    """Kernel A on a Linv whose strict upper triangle is noise gives the
    f64 plain forward on torch.tril of it, within 1e-4 of max|ref|."""
    from gpitch_tpu_torch.linalg.fused_whiten import fused_whiten, fused_whiten_plain
    args = _whiten_args(cuda, *shape)
    gen = torch.Generator().manual_seed(2)
    noisy = args[3] + torch.triu(torch.randn(args[3].shape, generator=gen), 1).to(cuda)
    with torch.no_grad():
        got = fused_whiten(*args[:3], noisy, *args[4:])
        want = fused_whiten_plain(*[a.double() for a in args[:3]], torch.tril(noisy).double(),
                                  *[a.double() for a in args[4:]])
    torch.cuda.synchronize()
    for a, b in zip(got, want):
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


@pytest.mark.parametrize("shape", _WHITEN_SHAPES[:2])
def test_cuda_fused_whiten_bwd_reads_the_lower_triangle_of_linv_only(cuda, shape):
    """Kernel B on a Linv whose strict upper triangle is noise gives the f64
    plain backward on torch.tril of it, within 1e-3 of max|ref|."""
    from gpitch_tpu_torch.linalg.fused_whiten import fused_whiten_bwd, fused_whiten_bwd_plain
    args = _whiten_args(cuda, *shape)
    nw, m = shape[:2]
    gen = torch.Generator().manual_seed(2)
    noisy = args[3] + torch.triu(torch.randn(args[3].shape, generator=gen), 1).to(cuda)
    du = (torch.randn(nw, m, m, generator=gen) * 0.01).to(cuda)
    dv = (torch.randn(nw, m, 1, generator=gen) * 0.01).to(cuda)
    got = fused_whiten_bwd(*args[:3], noisy, du, dv, *args[4:])
    want = fused_whiten_bwd_plain(*[a.double() for a in args[:3]], torch.tril(noisy).double(),
                                  du.double(), dv.double(), *[a.double() for a in args[4:]])
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == b.shape and _rel(a, b) <= 1e-3


def _bwd_rows(got, want64, plain32, rel=1e-3):
    """Per output: kernel B within the larger of ``rel`` of max|ref| (1e-3:
    chip_smoke's ``_whiten_case`` limit) and 4x the f32 plain backward's own
    error against the f64 one."""
    for g, w, q in zip(got, want64, plain32):
        scale = float(w.abs().max())
        tol = max(rel * scale, 4 * float((q.double() - w).abs().max()))
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert float((g.double() - w).abs().max()) <= tol


# the bank widths at a ragged N (2001 = 62 x 32 + 17), each at several
# splits of a window's tiles over blocks
@pytest.mark.parametrize("shape", [(5, 112, 2001, 3, 5), (4, 160, 2001, 8, 10),
                                   (3, 112, 1999, 3, 5)])
@pytest.mark.parametrize("splits", [1, 2, 7, 21])
def test_cuda_fused_whiten_bwd_kernel_at_splits_matches_f64_and_f32_plain(cuda, shape, splits):
    """Kernel B with a window's tiles split over ``splits`` blocks against
    the plain backward in f64 and f32 (``_bwd_rows`` at 1e-4 of max|ref|:
    every product in FP32 or 3xTF32, where one in plain TF32 puts dLinv
    ~7e-4 off); two launches are bit for bit equal."""
    from gpitch_tpu_torch.linalg.fused_whiten import _backward_kernel, fused_whiten_bwd_plain
    args = _whiten_args(cuda, *shape, per_window=True)
    nw, m = shape[:2]
    gen = torch.Generator().manual_seed(4)
    du = (torch.randn(nw, m, m, generator=gen) * 0.01).to(cuda)
    dv = (torch.randn(nw, m, 1, generator=gen) * 0.01).to(cuda)
    bwd = (*args[:4], du, dv, *args[4:])
    want = fused_whiten_bwd_plain(*[a.double() for a in bwd])
    plain32 = fused_whiten_bwd_plain(*bwd)
    got = _backward_kernel(*bwd, splits=splits)
    again = _backward_kernel(*bwd, splits=splits)
    torch.cuda.synchronize()
    _bwd_rows(got, want, plain32, rel=1e-4)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("shape,roles", [((4, 112, 2001, 3, 5), True),
                                         ((3, 30, 257, 3, 3), True),
                                         ((3, 160, 1001, 8, 10), False),
                                         ((2, 40, 77, 17, 20), False)])
def test_cuda_fused_whiten_bwd_counts_its_role_split_launches(cuda, shape, roles):
    """fused_whiten's backward launches kernel B once; ``fused_whiten_bwd_roles``
    counts it where the role-split body serves the sizes (the SoSp width,
    M 30), not at M 160 nor where the pairs' features do not fit."""
    from gpitch_tpu_torch.linalg.fused_whiten import (fused_whiten, fused_whiten_bwd,
                                                      fused_whiten_bwd_roles)
    args = _whiten_args(cuda, *shape, per_window=True)
    leaves = [a.clone().requires_grad_(True) for a in args[3:]]
    before = (fused_whiten_bwd.launches, fused_whiten_bwd_roles.launches)
    u, v = fused_whiten(*args[:3], *leaves)
    (u.sum() + v.sum()).backward()
    torch.cuda.synchronize()
    assert fused_whiten_bwd.launches == before[0] + 1
    assert fused_whiten_bwd_roles.launches == before[1] + int(roles)
    assert all(bool(torch.isfinite(x.grad).all()) for x in leaves)


def test_cuda_fused_whiten_bwd_role_split_layouts_agree(cuda):
    """The role-split body over 40 windows of 32 tiles (1280 tiles, more
    than the card's SMs) at its plan and at 1, 2 and 3 records a window:
    each within ``_bwd_rows`` at 1e-4 of max|ref| of the f64 and f32 plain
    backward and 1e-5 of the plan's (sums over 2001 samples in another
    order; ~1.8e-6 seen), and bit for bit over two launches."""
    from gpitch_tpu_torch.linalg.fused_whiten import _backward_kernel, fused_whiten_bwd_plain
    args = _whiten_args(cuda, 40, 112, 2001, 3, 5, per_window=True, seed=5)
    gen = torch.Generator().manual_seed(6)
    du = (torch.randn(40, 112, 112, generator=gen) * 0.01).to(cuda)
    dv = (torch.randn(40, 112, 1, generator=gen) * 0.01).to(cuda)
    bwd = (*args[:4], du, dv, *args[4:])
    want = fused_whiten_bwd_plain(*[a.double() for a in bwd])
    plain32 = fused_whiten_bwd_plain(*bwd)
    plan = _backward_kernel(*bwd)
    for splits in (None, 1, 2, 3):
        got = _backward_kernel(*bwd, splits=splits)
        again = _backward_kernel(*bwd, splits=splits)
        torch.cuda.synchronize()
        _bwd_rows(got, want, plain32, rel=1e-4)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        for a, b in zip(got, plan):
            assert _rel(a, b.double()) <= 1e-5


@pytest.mark.parametrize("state", ["f64_lbfgs", "card_lbfgs"])
def test_cuda_fused_whiten_bwd_kernel_at_the_trained_states(cuda, state):
    """Kernel B at the bound's own cotangent of the two saved L-BFGS states
    (tests/torch_fused_whiten_trained_state.npz, an f64 run, and
    tests/torch_hmc_bank_state.npz, the card's own f32 run), where |G|
    reaches ~4e7, against the plain backward in f64 and f32."""
    import chip_smoke
    from gpitch_tpu_torch.linalg.fused_whiten import fused_whiten_bwd, fused_whiten_bwd_plain
    if state == "f64_lbfgs":
        bank = chip_smoke.trained_bank(cuda, torch.float32)
    else:
        bank = chip_smoke.saved_hmc_bank(cuda)[0]
    _, a, du, dv = chip_smoke.pair_cotangents(bank)
    bwd = (*a[:4], du, dv, *a[4:])
    got = fused_whiten_bwd(*bwd)
    want = fused_whiten_bwd_plain(*[t.double() for t in bwd])
    plain32 = fused_whiten_bwd_plain(*bwd)
    torch.cuda.synchronize()
    _bwd_rows(got, want, plain32)


def test_cuda_fused_whiten_refuses_what_the_kernels_do_not_take(cuda):
    from gpitch_tpu_torch.linalg.fused_whiten import fused_whiten
    args = _whiten_args(cuda, 2, 16, 64, 2, 3)
    with pytest.raises(TypeError, match="float32"):
        fused_whiten(*[a.double() for a in args])
    big = _whiten_args(cuda, 1, 161, 64, 1, 2)
    with pytest.raises(ValueError, match="M=161"):
        fused_whiten(*big)


def test_cuda_bank_bound_goes_through_the_fused_pair_in_f32_only(cuda, monkeypatch):
    """A stacked f32 bank on the card takes the fused pair (one kernel A
    and one kernel B launch per bound and gradient) and agrees with its
    unfused composition (the bound to 1e-5 relative, every raw gradient to
    1e-3 of max|ref|, the limit of chip_smoke's bank case); the same bank
    in f64 takes the unfused composition and launches neither."""
    from gpitch_tpu_torch.core.params import named_params
    from gpitch_tpu_torch.kernels import MercerMatern12sm
    from gpitch_tpu_torch.linalg.fused_whiten import fused_whiten, fused_whiten_bwd
    from gpitch_tpu_torch.models.sgpr import SGPRSS
    from gpitch_tpu_torch.pipelines import windowed_sgpr as tws
    rng = np.random.default_rng(3)
    nw, ws, fs = 4, 401, 16000.0
    x = np.arange(nw * ws).reshape(nw, ws) / fs
    y = np.sin(2 * np.pi * 330 * x) + 0.1 * rng.standard_normal(x.shape)

    def run(dtype):
        bank = tws.build_window_bank(x, y, x[:, ::10, None], lambda: tws.sum_kernel([
            MercerMatern12sm.create(0.7, 0.05, [0.7, 0.3], [f, 2 * f], dtype=dtype)
            for f in (220.0, 330.0)]), dtype=dtype, device=cuda)
        before = (fused_whiten.launches, fused_whiten_bwd.launches)
        bound = tws.bank_loss(bank)
        bound.backward()
        torch.cuda.synchronize()
        after = (fused_whiten.launches, fused_whiten_bwd.launches)
        grads = {k: p.raw.grad for k, p in named_params(bank) if p.trainable}
        return bank.fused_eligible(), (after[0] - before[0], after[1] - before[1]), \
            bound.detach(), grads

    eligible, launched, bound, grads = run(torch.float32)
    assert eligible and launched == (1, 1)
    eligible64, launched64, _, _ = run(torch.float64)
    assert not eligible64 and launched64 == (0, 0)
    monkeypatch.setattr(SGPRSS, "fused_eligible", lambda self: False)
    _, launched, ref, ref_grads = run(torch.float32)
    assert launched == (0, 0)
    assert _rel(bound, ref.double()) <= 1e-5
    assert sorted(grads) == sorted(ref_grads)
    for k, g in ref_grads.items():
        assert _rel(grads[k], g.double()) <= 1e-3, k


def _lbfgs_bank(cuda, dtype, nw=6, ws=401):
    """A small stacked bank on the card (2 pitches x 2 partials, M 40)."""
    from gpitch_tpu_torch.kernels import MercerMatern12sm
    from gpitch_tpu_torch.pipelines import windowed_sgpr as tws
    rng = np.random.default_rng(5)
    fs = 16000.0
    x = np.arange(nw * ws).reshape(nw, ws) / fs
    y = np.sin(2 * np.pi * 330 * x) + 0.1 * rng.standard_normal(x.shape)
    return tws.build_window_bank(x, y, x[:, ::10, None], lambda: tws.sum_kernel([
        MercerMatern12sm.create(0.7, 0.05, [0.7, 0.3], [f, 2 * f], dtype=dtype)
        for f in (220.0, 330.0)]), dtype=dtype, device=cuda)


def test_cuda_bank_lbfgs_matches_the_cpu_in_f64(cuda):
    """Per-window L-BFGS, 10 iterations, f64: the card (the Cholesky kernel
    in f64, the unfused composition) against the CPU, per-window losses at
    rtol 1e-8."""
    from gpitch_tpu_torch.core.params import to_device
    from gpitch_tpu_torch.pipelines import windowed_sgpr as tws
    bank = _lbfgs_bank(cuda, torch.float64)
    _, _, _, got = tws._optimize_bank_lbfgs(bank, 10)
    _, _, _, want = tws._optimize_bank_lbfgs(to_device(bank, "cpu"), 10)
    np.testing.assert_allclose(got["window_losses"], want["window_losses"], rtol=1e-8)


def test_cuda_bank_lbfgs_contains_a_nan_window(cuda):
    """f32 through the fused pair: a window with a NaN inducing point (NaN
    Kuu into the Cholesky kernel, NaN Linv into kernels A and B) stays NaN
    and at its initial state, nothing traps, and every other window's
    trajectory equals the run without it."""
    from gpitch_tpu_torch.linalg.fused_whiten import fused_whiten_bwd
    from gpitch_tpu_torch.pipelines import windowed_sgpr as tws
    before = fused_whiten_bwd.launches
    _, _, _, clean = tws._optimize_bank_lbfgs(_lbfgs_bank(cuda, torch.float32), 10)
    assert fused_whiten_bwd.launches > before
    bad = _lbfgs_bank(cuda, torch.float32)
    with torch.no_grad():
        bad.Z.raw[2, 0, 0] = float("nan")
    _, _, _, info = tws._optimize_bank_lbfgs(bad, 10)
    keep = [0, 1, 3, 4, 5]
    assert np.isnan(info["window_losses"][2]).all()
    np.testing.assert_array_equal(info["window_losses"][keep], clean["window_losses"][keep])
    assert info["windows_at_initial_state"] == clean["windows_at_initial_state"] + 1


def _grid_bank(dev, dtype, **kw):
    """4 overlapping windows of 401 samples at 16 kHz, M 40 on the grid, two
    stacked 2-partial kernels; ``kw`` (lag_table, masks) to the build."""
    from gpitch_tpu_torch.kernels import MercerMatern12sm
    from gpitch_tpu_torch.pipelines import windowed_sgpr as tws
    rng = np.random.default_rng(8)
    nw, ws, fs = 4, 401, 16000.0
    x = (np.arange(nw)[:, None] * 200 + np.arange(ws)[None, :]) / fs + 3.0
    y = np.sin(2 * np.pi * 330 * x) + 0.1 * rng.standard_normal(x.shape)
    return tws.build_window_bank(x, y, x[:, 5::10, None], lambda: tws.sum_kernel([
        MercerMatern12sm.create(0.7, 0.05, [0.7, 0.3], [f, 2 * f], dtype=dtype)
        for f in (220.0, 330.0)]), grid_dt=1 / fs, dtype=dtype, device=dev, **kw)


def _masks():
    m = np.ones((4, 401))
    m[3, 250:] = 0.0
    m[1, :60] = 0.0
    return m


def _launched(bank):
    """(bound, gradients, launches of the Cholesky kernel, kernel A, kernel B)
    of one bound and gradient of the bank."""
    from gpitch_tpu_torch.core.params import named_params
    from gpitch_tpu_torch.linalg.chol import cholesky_batched
    from gpitch_tpu_torch.linalg.fused_whiten import fused_whiten, fused_whiten_bwd
    counters = (cholesky_batched, fused_whiten, fused_whiten_bwd)
    before = [c.launches for c in counters]
    loss = bank.loss()
    loss.sum().backward()
    torch.cuda.synchronize()
    grads = {k: p.raw.grad.cpu() for k, p in named_params(bank) if p.trainable}
    return loss.detach().cpu(), grads, tuple(c.launches - b for c, b in zip(counters, before))


@pytest.mark.parametrize("masked", [False, True])
def test_cuda_lag_table_bank_equals_the_direct_bank_in_f64(cuda, masked):
    """The lag-table bank on the card in f64 against the direct bank on the
    card (1e-9 relative, the chip_smoke limit) and against the table bank
    on the CPU (1e-9); the table route launches the Cholesky kernel and
    never the fused pair, in f64 and in f32."""
    from gpitch_tpu_torch.core.params import to_device
    kw = {"masks": _masks()} if masked else {}
    table = _grid_bank(cuda, torch.float64, lag_table=True, **kw)
    loss, grads, launched = _launched(table)
    direct, _, _ = _launched(_grid_bank(cuda, torch.float64, **kw))
    assert _rel(loss, direct) <= 1e-9
    cpu_loss, cpu_grads, _ = _launched(to_device(table, "cpu"))
    assert _rel(loss, cpu_loss) <= 1e-9
    for k, g in cpu_grads.items():
        assert _rel(grads[k], g) <= 1e-8, k
    assert launched[0] > 0 and launched[1:] == (0, 0)
    table32 = _grid_bank(cuda, torch.float32, lag_table=True, **kw)
    assert not table32.fused_eligible()
    loss32, _, launched32 = _launched(table32)
    assert launched32[0] > 0 and launched32[1:] == (0, 0)
    assert _rel(loss32.double(), loss) <= 1e-4


def test_cuda_masked_bank_goes_through_the_cholesky_kernel(cuda):
    """A masked f32 bank on the card takes the unfused route (the Cholesky
    kernel, no fused launch) and agrees with the same bank's plain
    versions on the CPU: bound 1e-5 relative, gradients 1e-3 of max|ref|."""
    from gpitch_tpu_torch.core.params import to_device
    bank = _grid_bank(cuda, torch.float32, masks=_masks())
    assert not bank.fused_eligible()
    loss, grads, launched = _launched(bank)
    assert launched[0] > 0 and launched[1:] == (0, 0)
    ref, ref_grads, _ = _launched(to_device(bank, "cpu"))
    assert _rel(loss.double(), ref.double()) <= 1e-5
    for k, g in ref_grads.items():
        assert _rel(grads[k].double(), g.double()) <= 1e-3, k


def test_cuda_chain_folded_bank_log_density_through_the_fused_pair(cuda, monkeypatch):
    """HMC's chain-folded bank log density (3 chains x 4 windows in one
    evaluation) on the card: through the Cholesky kernel and kernels A and
    B, within 1e-5 relative of its unfused composition (values, and the
    chains' gradients within 1e-3 of max|ref|), and each chain within 1e-5
    of that chain alone."""
    from gpitch_tpu_torch.core.params import named_params, with_raw
    from gpitch_tpu_torch.linalg.chol import cholesky_batched
    from gpitch_tpu_torch.linalg.fused_whiten import fused_whiten, fused_whiten_bwd
    from gpitch_tpu_torch.models import model_logprob_fn
    from gpitch_tpu_torch.models.sgpr import SGPRSS
    bank = _lbfgs_bank(cuda, torch.float32, nw=4)
    paths = [".kern.stacked.variance", ".kern.stacked.energy", ".kern.stacked.frequency"]
    raws = dict(named_params(bank))
    gen = torch.Generator(device=cuda).manual_seed(0)
    leaves = {p: raws[p].raw.detach()[None] * (1 + 0.01 * torch.randn(
        (3,) + tuple(raws[p].raw.shape), generator=gen, device=cuda)) for p in paths}

    def run(chains):
        fn = model_logprob_fn(bank, with_raw)
        ls = {k: v[chains].clone().requires_grad_(True) for k, v in leaves.items()}
        lp = fn(ls)
        grads = torch.autograd.grad(lp.sum(), list(ls.values()))
        torch.cuda.synchronize()
        return lp.detach().double(), [g.double() for g in grads]

    counters = (cholesky_batched, fused_whiten, fused_whiten_bwd)
    before = [c.launches for c in counters]
    lp, grads = run(slice(None))
    assert all(c.launches > b for c, b in zip(counters, before))
    for c in range(3):
        one, _ = run(slice(c, c + 1))
        assert _rel(lp[c], one[0]) <= 1e-5
    monkeypatch.setattr(SGPRSS, "fused_eligible", lambda self: False)
    ref, ref_grads = run(slice(None))
    assert _rel(lp, ref) <= 1e-5
    for g, r in zip(grads, ref_grads):
        assert _rel(g, r) <= 1e-3


def test_cuda_one_rank_nccl_shard_map_bank_loss(cuda, tmp_path):
    """A one-rank NCCL group: make_bank_loss_shard_map gives bank_loss's
    value and gradients on the card (1e-6 relative)."""
    import torch.distributed as dist

    from gpitch_tpu_torch.core.params import named_params
    from gpitch_tpu_torch.parallel import init_multihost, make_bank_loss_shard_map, make_mesh
    from gpitch_tpu_torch.pipelines.windowed_sgpr import bank_loss
    if dist.is_initialized():
        pytest.skip("a process group already exists in this process")
    assert init_multihost(f"file://{tmp_path / 'store'}", 1, 0, backend="nccl", timeout_s=60)
    try:
        mesh = make_mesh(1)
        bank = _lbfgs_bank(cuda, torch.float32)
        leaves = [p.raw for _, p in named_params(bank) if p.trainable]
        loss = make_bank_loss_shard_map(mesh)(bank)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        ref = bank_loss(bank)
        ref_grads = torch.autograd.grad(ref, leaves, allow_unused=True)
        assert _rel(loss.detach().double(), ref.detach().double()) <= 1e-6
        for g, r in zip(grads, ref_grads):
            if r is not None:
                assert _rel(g.double(), r.double()) <= 1e-6
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("window_chunk", [None, 4], ids=["whole", "chunks_of_4"])
def test_cuda_captured_bank_steps_match_eager(cuda, monkeypatch, window_chunk):
    """optimize_bank's Adam on the card replays one captured step (the
    fused pair inside the graph, once a step of every chunk; 6 windows in
    chunks of 4 pad to 8) and gives the eager steps' losses and leaves
    within 1e-5 relative (the same kernels on the same inputs)."""
    from gpitch_tpu_torch.core.params import named_params
    from gpitch_tpu_torch.linalg import _cuda
    from gpitch_tpu_torch.models import fit
    from gpitch_tpu_torch.pipelines import windowed_sgpr as tws
    bank = _lbfgs_bank(cuda, torch.float32)
    _cuda.reset_launches()
    got, gl = tws.optimize_bank(bank, 12, 0.05, window_chunk=window_chunk, segment=5)
    chunks = 1 if window_chunk is None else 2
    assert _cuda.GRAPHS["graphs"] == 1
    assert _cuda.GRAPHS["replays"] == chunks * 12 - fit.AdamSteps.WARMUP
    launches = _cuda.device_launches()
    assert launches["fused_whiten"] == launches["fused_whiten_bwd"] == chunks * 12
    monkeypatch.setattr(fit.AdamSteps, "run", fit.AdamSteps.eager)
    want, wl = tws.optimize_bank(bank, 12, 0.05, window_chunk=window_chunk, segment=5)
    np.testing.assert_allclose(gl, wl, rtol=1e-5)
    for (_, a), (_, b) in zip(named_params(got), named_params(want)):
        assert _rel(a.raw.detach(), b.raw.detach().double()) <= 1e-5


def test_cuda_captured_minibatch_draws_differ_and_equal_eager(cuda):
    """A minibatch draw inside the captured step: its generator registered
    with the graph, each replay draws the next batch (20 different batches
    in 20 steps), the same batches the eager steps draw from the same seed,
    and the same losses."""
    import dataclasses
    from typing import Any

    from gpitch_tpu_torch.core.params import Param
    from gpitch_tpu_torch.models.fit import AdamSteps, minibatch_fn

    @dataclasses.dataclass
    class Mean:
        w: Any = None

    x = torch.arange(64.0, device=cuda)[:, None]

    def draws(eager):
        seen = torch.zeros(20, 8, device=cuda)
        k = torch.zeros((), dtype=torch.int64, device=cuda)
        base = minibatch_fn(x, x.clone(), 8, torch.Generator(device=cuda).manual_seed(5))

        def batch_fn():
            xb, yb = base()
            seen.index_copy_(0, k.reshape(1), xb.reshape(1, 8))
            k.add_(1)
            return xb, yb

        batch_fn.generator = base.generator
        run = AdamSteps(Mean(w=Param(torch.zeros(1, device=cuda))),
                        lambda m, xb, yb: ((m.w.value - yb / 64.0) ** 2).sum(), 20, 0.05,
                        batch_fn)
        (run.eager if eager else run.run)(20)
        assert (run.graph is None) == eager
        return seen, run.losses.clone()

    seen_c, loss_c = draws(False)
    seen_e, loss_e = draws(True)
    assert torch.equal(seen_c, seen_e) and torch.equal(loss_c, loss_e)
    assert len({tuple(r) for r in seen_c.tolist()}) == 20


def _eager_lbfgs(self, n):
    """LbfgsSteps.run as the plain version: every iteration eagerly, each
    condition read on the host."""
    with torch.no_grad():
        for _ in range(n):
            self.iteration()


@pytest.mark.parametrize("window_chunk", [None, 4], ids=["whole", "chunks_of_4"])
def test_cuda_captured_lbfgs_matches_eager(cuda, monkeypatch, window_chunk):
    """Per-window L-BFGS on the card replays its captured iteration (the
    five parts captured once for every chunk; 6 windows in chunks of 4 pad
    to 8), 10 iterations in segments of 4, f32 through the fused pair: the
    same per-window losses, leaves and counts as the eager iterations, bit
    for bit, with fewer host reads; the fused pair launched once for every
    evaluation the device counted."""
    from gpitch_tpu_torch.core.params import named_params
    from gpitch_tpu_torch.linalg import _cuda
    from gpitch_tpu_torch.models._lbfgs import LbfgsSteps
    from gpitch_tpu_torch.pipelines import windowed_sgpr as tws
    bank = _lbfgs_bank(cuda, torch.float32)
    _cuda.reset_launches()
    got, _, _, ginfo = tws._optimize_bank_lbfgs(bank, 10, window_chunk=window_chunk,
                                                step_segment=4)
    assert _cuda.GRAPHS["graphs"] == 5 and ginfo["capture_s"] > 0
    launches = _cuda.device_launches()
    grads = ginfo["trials"] + ginfo["grad_evaluations"]
    assert launches["fused_whiten_bwd"] == grads
    assert launches["fused_whiten"] == grads + ginfo["value_evaluations"]
    monkeypatch.setattr(LbfgsSteps, "run", _eager_lbfgs)
    want, _, _, winfo = tws._optimize_bank_lbfgs(bank, 10, window_chunk=window_chunk,
                                                 step_segment=4)
    np.testing.assert_array_equal(ginfo["window_losses"], winfo["window_losses"])
    for key in ("trials", "trials_per_iteration", "grad_evaluations", "iterations"):
        assert ginfo[key] == winfo[key], key
    assert ginfo["syncs"] < winfo["syncs"]
    for (name, a), (_, b) in zip(named_params(got), named_params(want)):
        assert torch.equal(a.raw, b.raw), name


def test_cuda_captured_lbfgs_f64_bank_matches_the_cpu(cuda):
    """The f64 bank's per-window L-BFGS captured on the card (the Cholesky
    kernel in f64 inside the conditional trial) against the CPU: per-window
    losses at rtol 1e-8, 10 iterations."""
    from gpitch_tpu_torch.core.params import to_device
    from gpitch_tpu_torch.linalg import _cuda
    from gpitch_tpu_torch.pipelines import windowed_sgpr as tws
    bank = _lbfgs_bank(cuda, torch.float64)
    _cuda.reset_launches()
    _, _, _, got = tws._optimize_bank_lbfgs(bank, 10)
    assert _cuda.GRAPHS["graphs"] == 5 and _cuda.GRAPHS["replayed"]["cholesky_batched"] > 0
    _, _, _, want = tws._optimize_bank_lbfgs(to_device(bank, "cpu"), 10)
    np.testing.assert_allclose(got["window_losses"], want["window_losses"], rtol=1e-8)


def test_cuda_captured_natgrad_adam_with_skips_matches_eager(cuda):
    """fit_natgrad_adam's steps captured on the card (NatgradSteps, gamma 3
    with no warm-up, f32: some steps leave the PSD cone and are skipped on
    the device) against the same steps run eagerly: the losses with NaN at
    the same steps, Adam's count and every raw leaf, bit for bit."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import golden_modgp
    from gpitch_tpu_torch.core.params import copy_params, named_params
    from gpitch_tpu_torch.models.natgrad import NatgradSteps
    model, x, y = golden_modgp(torch.float32, cuda)
    runs = [NatgradSteps(copy_params(model), x, y, 12, 3.0, None, 0.01, 1) for _ in range(2)]
    runs[0].run(12)
    runs[1].eager(12)
    assert runs[0].graph is not None and runs[1].graph is None
    cap, eag = (r.losses.cpu().numpy() for r in runs)
    np.testing.assert_array_equal(cap, eag)
    assert 0 < np.isnan(cap).sum() < 12
    assert int(runs[0].adam.t) == int(runs[1].adam.t) == int(np.isfinite(cap).sum())
    for (name, a), (_, b) in zip(named_params(runs[0].model), named_params(runs[1].model)):
        assert torch.equal(a.raw, b.raw), name


# ------------------------------------------------------------ the HMC runner
def _hmc_noise(init, chains, total, seed, device):
    gen = torch.Generator().manual_seed(seed)

    def normal(shape, v):
        return torch.randn(shape + tuple(v.shape), generator=gen).to(device)

    return ({k: normal((chains,), v) for k, v in init.items()},
            {k: normal((total, chains), v) for k, v in init.items()},
            torch.rand((total, chains), generator=gen).to(device))


def _hmc_routes(cuda):
    """Both model_logprob_fn routes on the card in f32, (logprob, init):
    the small bank's kernel leaves, the chains folded into its windows (the
    Cholesky kernel and the fused pair), and a 2-source ModGP's component
    lengthscales and variances, the chains vmapped."""
    from gpitch_tpu_torch.core.params import named_params, with_raw
    from gpitch_tpu_torch.kernels import Matern32, MercerMatern12sm
    from gpitch_tpu_torch.models import ModGP, model_logprob_fn
    bank = _lbfgs_bank(cuda, torch.float32)
    raws = dict(named_params(bank))
    bank_init = {k: raws[k].raw.detach().clone()
                 for k in (".kern.stacked.variance", ".kern.stacked.lengthscales")}
    z = np.linspace(0, 1, 8).reshape(-1, 1)
    model = ModGP.create(z=[[z] * 2, [z] * 2],
                         kern=[[Matern32.create(1.0, 0.3) for _ in range(2)],
                               [MercerMatern12sm.create(1.0, 0.5, [1.0], [5.0 * (i + 1)])
                                for i in range(2)]], device=cuda)
    x = torch.linspace(0, 1, 64, device=cuda)[:, None]
    y = 0.5 * torch.sin(2 * np.pi * 5.0 * x)
    raws = dict(named_params(model))
    modgp_init = {k: raws[k].raw.detach().clone()
                  for k in (".kern_com.lengthscales", ".kern_com.variance")}
    return [(model_logprob_fn(bank, with_raw, prior_scale=10.0), bank_init),
            (model_logprob_fn(model, with_raw, x, y, prior_scale=10.0), modgp_init)]


@pytest.mark.parametrize("route", [0, 1], ids=["bank", "modgp"])
def test_cuda_captured_hmc_matches_eager(cuda, monkeypatch, route):
    """models.hmc.HmcSteps on each route, 2 chains, 3 leapfrog steps, 20 +
    10 iterations in f32: its three phases captured (3 graphs) and replayed
    give the eager iterations' samples and rates bit for bit; the eager
    iterations run under torch's sync debug mode 'error' (no host read);
    on the bank the Cholesky kernel and kernels A and B launch."""
    from gpitch_tpu_torch.linalg import _cuda
    from gpitch_tpu_torch.models import fit
    from gpitch_tpu_torch.models.hmc import HmcSteps
    fn, init = _hmc_routes(cuda)[route]
    noise = _hmc_noise(init, 2, 30, 11, cuda)
    args = (fn, init, *noise, 20, 10, 3, 0.05, 0.8, 0.01, True)
    _cuda.reset_launches()
    runner = HmcSteps(*args)
    got_s, got_r = runner.run()
    assert _cuda.GRAPHS["graphs"] == 3
    assert all(p.graph is not None for p in runner.phases.values())
    if route == 0:
        launches = _cuda.device_launches()
        assert all(launches[k] > 0 for k in ("cholesky_batched", "fused_whiten",
                                             "fused_whiten_bwd")), launches
    monkeypatch.setattr(fit.CapturedSteps, "run", fit.CapturedSteps.eager)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        want_s, want_r = HmcSteps(*args).run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got_r, want_r)
    for k in want_s:
        assert torch.equal(got_s[k], want_s[k]), k
    assert bool(torch.isfinite(got_r).all())


def test_cuda_hmc_capture_that_fails_raises(cuda):
    """A log density that reads the host cannot be captured: HmcSteps
    raises (it has no eager fallback)."""
    from gpitch_tpu_torch.models.hmc import HmcSteps

    def logprob(q):
        x = q["x"]
        float(x.sum())
        return -0.5 * x.square().sum(-1)

    init = {"x": torch.zeros(2, device=cuda)}
    with pytest.raises(RuntimeError):
        HmcSteps(logprob, init, *_hmc_noise(init, 2, 10, 0, cuda), 5, 5, 2, 0.1, 0.8, 0.1,
                 False).run()
