"""The fused pair's CUDA kernels (gpitch_tpu_torch/csrc/fused_whiten.cu,
kernels A and B) run on the CPU through a CPU emulation of the CUDA
subset they use (tests/cuda_emulation/cuda_runtime.h), against the f64
plain versions.

A CUDA kernel has no interpret mode.  The source is compiled here by g++
as it stands, with the emulation header in the place of CUDA's: each CUDA
thread is an OS thread, barriers and warp shuffles are emulated, and
shared memory starts as NaN.  This holds the kernels' own indexing,
layouts, padding, source chunks, ragged tiles and split sums to the plain
versions at small sizes, on the CPU; the card tests
(tests/test_torch_cuda.py) hold the compiled kernels.  Skips where no g++
that takes -std=c++20 is found.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from fused_whiten_inputs import prototype_inputs
from gpitch_tpu_torch.linalg import _cuda
from gpitch_tpu_torch.linalg.fused_whiten import fused_whiten_bwd_plain, fused_whiten_plain

HERE = Path(__file__).resolve().parent


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """csrc/fused_whiten.cu built for the CPU with the emulation header."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CPU emulation of the kernels")
    out = tmp_path_factory.mktemp("emulated") / "libfused_whiten.so"
    cmd = [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
           f"-I{HERE / 'cuda_emulation'}", "-x", "c++", "-o", str(out),
           str(_cuda.CSRC_DIR / "fused_whiten.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if res.returncode != 0 and "c++20" in res.stderr:
        pytest.skip(f"g++ does not take -std=c++20: {res.stderr[-300:]}")
    assert res.returncode == 0, res.stderr[-4000:]
    so = ctypes.CDLL(str(out))
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


def run_bwd(lib, a, du, dv, splits):
    """Kernel B on CPU tensors (float32): its five outputs."""
    zc, xc, err, linv, e, f, v, il = _f32(a)
    du, dv = _f32((du, dv))
    nw, m = zc.shape[:2]
    n, (s, p) = xc.shape[-1], e.shape[-2:]
    rec = m * m + 2 * s + 2 * s * p
    part = torch.zeros(nw, splits, rec)
    sums = torch.zeros(nw, rec) if splits > 1 else part
    ws = torch.zeros(nw, lib.gpitch_fused_whiten_bwd_workspace(m, s, p))
    rc = lib.gpitch_fused_whiten_bwd(
        *(t.data_ptr() for t in (zc, xc, err, linv, e, f, v, il, du, dv)), part.data_ptr(),
        sums.data_ptr(), ws.data_ptr(), s * p, s, nw, m, n, s, p, splits, None)
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
# 20 at M 40, S 8 x P 10 at M 160), a window's tiles split over blocks
_SHAPES = [(2, 16, 70, 2, 3, 1), (2, 30, 100, 3, 3, 2), (1, 40, 77, 17, 20, 1),
           (2, 112, 100, 3, 5, 1), (2, 112, 130, 3, 5, 3), (1, 160, 70, 8, 10, 2)]


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
