"""The fused pair's CUDA kernels (gpitch_tpu_torch/csrc/fused_whiten.cu,
kernels A and B) run on the CPU through a CPU emulation of the CUDA
subset they use (tests/cuda_emulation/cuda_runtime.h), against the f64
plain versions.

A CUDA kernel has no interpret mode.  The source is compiled here by g++
as it stands, with the emulation header in the place of CUDA's: a block's
CUDA threads are fibers on one core in a fixed order, barriers and warp
shuffles are emulated, and shared memory starts as NaN.  This holds the
kernels' own indexing, layouts, padding, source chunks, ragged tiles and
split sums to the plain versions at small sizes, on the CPU; the card
tests (tests/test_torch_cuda.py) hold the compiled kernels.  Skips where
no g++ that takes -std=c++20 is found.
"""

import ctypes

import pytest
import torch

from emulation_build import emulated_library
from fused_whiten_inputs import prototype_inputs
from gpitch_tpu_torch.linalg import _cuda
from gpitch_tpu_torch.linalg.fused_whiten import fused_whiten_bwd_plain, fused_whiten_plain


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """csrc/fused_whiten.cu built for the CPU with the emulation header."""
    so = emulated_library(tmp_path_factory, _cuda.CSRC_DIR / "fused_whiten.cu")
    for fn, argtypes in _cuda.SIGNATURES["fused_whiten"].items():
        getattr(so, fn).argtypes = argtypes
        getattr(so, fn).restype = ctypes.c_int
    return so


def _inputs(nw, m, n, s, p, seed=0):
    """prototype_inputs (per window) and cotangents (du, dv), f64."""
    a = [torch.as_tensor(x) for x in prototype_inputs(nw, m, n, s, p, True, seed)]
    gen = torch.Generator().manual_seed(seed + 1)
    du = torch.randn(nw, m, m, generator=gen, dtype=torch.float64) * 0.01
    dv = torch.randn(nw, m, 1, generator=gen, dtype=torch.float64) * 0.01
    return a, du, dv


def _f32(ts):
    return [t.float().contiguous() for t in ts]


def run_bwd(lib, a, du, dv, splits, ws=None):
    """Kernel B on CPU tensors (float32): its five outputs; the scratch it
    was given, which starts as NaN, is appended to the list ``ws``."""
    zc, xc, err, linv, e, f, v, il = _f32(a)
    du, dv = _f32((du, dv))
    nw, m = zc.shape[:2]
    n, (s, p) = xc.shape[-1], e.shape[-2:]
    rec = m * m + 2 * s + 2 * s * p
    part = torch.full((nw, splits, rec), float("nan"))    # every output must be written
    sums = torch.full((nw, rec), float("nan")) if splits > 1 else part
    scratch = torch.full((nw, lib.gpitch_fused_whiten_bwd_workspace(m, n, s, p)), float("nan"))
    if ws is not None:
        ws.append(scratch)
    rc = lib.gpitch_fused_whiten_bwd(
        *(t.data_ptr() for t in (zc, xc, err, linv, e, f, v, il, du, dv)), part.data_ptr(),
        sums.data_ptr(), scratch.data_ptr(), s * p, s, nw, m, n, s, p, splits, None)
    assert rc == 0
    buf = sums.reshape(nw, rec)
    o = m * m
    return (buf[:, :o].reshape(nw, m, m), buf[:, o:o + s].reshape(nw, 1, s),
            buf[:, o + s:o + 2 * s].reshape(nw, 1, s),
            buf[:, o + 2 * s:o + 2 * s + s * p].reshape(nw, s, p),
            buf[:, o + 2 * s + s * p:].reshape(nw, s, p))


def run_fwd(lib, a, splits):
    """Kernel A on CPU tensors (float32): (U, v)."""
    zc, xc, err, linv, e, f, v, il = _f32(a)
    nw, m = zc.shape[:2]
    n, (s, p) = xc.shape[-1], e.shape[-2:]
    part = torch.zeros(nw, splits, m * m + m)
    out = torch.zeros(nw, m * m + m) if splits > 1 else part
    ws = torch.zeros(nw, lib.gpitch_fused_whiten_fwd_workspace(m, s, p))
    rc = lib.gpitch_fused_whiten_fwd(
        *(t.data_ptr() for t in (zc, xc, err, linv, e, f, v, il)), part.data_ptr(),
        out.data_ptr(), ws.data_ptr(), s * p, s, nw, m, n, s, p, splits, None)
    assert rc == 0
    buf = out.reshape(nw, m * m + m)
    return buf[:, :m * m].reshape(nw, m, m), buf[:, m * m:].reshape(nw, m, 1)


def _rel(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


# (nw, M, N, S, P, splits): every instance (RU 1, 2, 4, 7, 10: M 16, 30, 40,
# 112, 160), a ragged N, sources that take several feature chunks (S 17 x P
# 20 at M 40, S 8 x P 10 at M 112 and 160), a window's tiles split over
# blocks; kernel B's role-split body at RU 1, 2 and 7 (up to 19 pairs at
# RU 7), its present body at the rest
_SHAPES = [(2, 16, 70, 2, 3, 1), (2, 30, 100, 3, 3, 2), (1, 40, 77, 17, 20, 1),
           (2, 112, 100, 3, 5, 1), (2, 112, 130, 3, 5, 3), (1, 160, 70, 8, 10, 2),
           (1, 112, 90, 8, 10, 2), (2, 112, 150, 1, 19, 2)]


@pytest.mark.parametrize("shape", _SHAPES)
def test_emulated_kernel_b_matches_the_f64_plain_backward(lib, shape):
    """Kernel B's five outputs within 1e-5 of max|ref| of the f64 plain
    backward (f32 sums over at most a few hundred samples; ~1e-6 seen)."""
    *size, splits = shape
    a, du, dv = _inputs(*size)
    want = fused_whiten_bwd_plain(*a[:4], du, dv, *a[4:])
    for g, w in zip(run_bwd(lib, a, du, dv, splits), want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert _rel(g, w) <= 1e-5


@pytest.mark.parametrize("shape", _SHAPES)
def test_emulated_kernel_a_matches_the_f64_plain_forward(lib, shape):
    """Kernel A's (U, v) within 1e-5 of max|ref| of the f64 plain forward."""
    *size, splits = shape
    a, _, _ = _inputs(*size)
    want = fused_whiten_plain(*a)
    for g, w in zip(run_fwd(lib, a, splits), want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert _rel(g, w) <= 1e-5


@pytest.mark.parametrize("m", [112, 160])
def test_emulated_kernel_b_is_bit_for_bit_reproducible_and_split_invariant(lib, m):
    """Two launches give the same bits; the splits' fixed-order sums agree
    with one block per window to 1e-6 of max|ref|."""
    a, du, dv = _inputs(2, m, 130, 3, 5)
    one = run_bwd(lib, a, du, dv, 1)
    first = run_bwd(lib, a, du, dv, 3)
    again = run_bwd(lib, a, du, dv, 3)
    for x, y, z in zip(first, again, one):
        assert torch.equal(x, y)
        assert _rel(x, z.double()) <= 1e-6


def test_emulated_kernel_b_takes_the_role_split_body_where_its_plan_fits(lib):
    """The role-split body serves M <= 112 where every pair's features fit
    beside its slots (19 pairs at M 112); M 160 and more pairs keep the
    present body."""
    roles = {(m, s, p): lib.gpitch_fused_whiten_bwd_roles(m, s, p)
             for m, s, p in [(16, 2, 3), (30, 3, 3), (40, 3, 5), (112, 3, 5), (112, 1, 19),
                             (112, 1, 20), (112, 4, 5), (112, 8, 10), (40, 17, 20),
                             (160, 8, 10), (160, 3, 5)]}
    assert [k for k, v in roles.items() if v] == [(16, 2, 3), (30, 3, 3), (40, 3, 5),
                                                  (112, 3, 5), (112, 1, 19)]
    assert lib.gpitch_fused_whiten_bwd_workspace(112, 2001, 3, 5) == 0
    assert lib.gpitch_fused_whiten_bwd_workspace(160, 2001, 8, 10) > 0


@pytest.mark.parametrize("splits", [1, 2, 3, 4, 5])
def test_emulated_kernel_b_role_split_body_at_every_work_item_layout(lib, splits):
    """The role-split body at M 112 over 3 windows of 4 tiles (the last
    ragged: N 200 = 3 x 64 + 8) with at most ``splits`` blocks a window:
    one window a block (1), blocks of 3 tiles that each end inside a
    window so that one block runs two windows (2), blocks of 2 tiles with a
    record slot no block covers (3, zeroed), one tile a block (4, 5).  Each
    within 1e-5 of max|ref| of the f64 plain backward and 1e-6 of one
    window a block; two launches give the same bits."""
    a, du, dv = _inputs(3, 112, 200, 3, 5, seed=3)
    want = fused_whiten_bwd_plain(*a[:4], du, dv, *a[4:])
    got = run_bwd(lib, a, du, dv, splits)
    again = run_bwd(lib, a, du, dv, splits)
    one = run_bwd(lib, a, du, dv, 1)
    for g, h, o, w in zip(got, again, one, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert torch.equal(g, h)
        assert _rel(g, w) <= 1e-5
        assert _rel(g, o.double()) <= 1e-6


@pytest.mark.parametrize("splits", [1, 2])
def test_emulated_kernel_b_role_split_body_without_samples_gives_zeros(lib, splits):
    """N 0 at M 112: no tile to walk; every output is 0, as the plain
    backward's."""
    a, du, dv = _inputs(2, 112, 0, 3, 5)
    for g, w in zip(run_bwd(lib, a, du, dv, splits), fused_whiten_bwd_plain(*a[:4], du, dv, *a[4:])):
        assert g.shape == w.shape and not bool(g.any()) and not bool(w.any())


def test_emulated_kernel_b_reads_the_lower_triangle_of_linv_only(lib):
    """Kernel B on a Linv whose strict upper triangle is noise gives the
    f64 plain backward on torch.tril of it."""
    a, du, dv = _inputs(2, 112, 100, 3, 5)
    noisy = list(a)
    gen = torch.Generator().manual_seed(7)
    noisy[3] = a[3] + torch.triu(torch.randn(a[3].shape, generator=gen, dtype=torch.float64), 1)
    want = fused_whiten_bwd_plain(*a[:4], du, dv, *a[4:])
    for g, w in zip(run_bwd(lib, noisy, du, dv, 1), want):
        assert _rel(g, w) <= 1e-5


def test_emulated_kernel_b_at_the_card_trained_state(lib):
    """Kernel B at the bound's own cotangent of two windows of the card's
    own L-BFGS state (tests/torch_hmc_bank_state.npz; |G| ~ 5e4 there),
    against the f64 plain backward on the same f32 inputs: within 4x the
    f32 plain backward's own error (or 1e-5 of max|ref|)."""
    import chip_smoke
    from gpitch_tpu_torch.core.params import take_windows
    bank = take_windows(chip_smoke.saved_hmc_bank("cpu")[0], slice(0, 2))
    _, args, du, dv = chip_smoke.pair_cotangents(bank)
    g_max = float((du + du.mT).abs().max())
    assert g_max > 1e4
    want = fused_whiten_bwd_plain(*[t.double() for t in args[:4]], du.double(), dv.double(),
                                  *[t.double() for t in args[4:]])
    plain32 = fused_whiten_bwd_plain(*args[:4], du, dv, *args[4:])
    got = run_bwd(lib, [t.double() for t in args], du.double(), dv.double(), 2)
    for g, w, q in zip(got, want, plain32):
        scale = float(w.abs().max())
        tol = max(1e-5 * scale, 4 * float((q.double() - w).abs().max()))
        assert float((g.double() - w).abs().max()) <= tol
