"""The fused build -> whiten -> accumulate chain of the SGPR bound: CUDA
kernels and their plain versions.

Replaces the three TPU kernels of scripts/proto_fused_whiten.py
(``make_fused_mxu``, ``make_fused``) and scripts/proto_fused_whiten_bwd.py
(``make_fused_bwd``).  Per window, with z (M inducing points), x and err
(N samples) and Linv (M, M):

    Kuf[m, t] = sum_s var_s exp(-|z_m - x_t| inv_l_s)
                      sum_p e_sp cos(2 pi f_sp (z_m - x_t))
    A = Linv Kuf,   U = A A^T (M, M),   v = A err (M, 1)

which are the bound's AAT * sigma^2 and Aerr (models/sgpr.py, ``_common``).
The forward kernel (``csrc/fused_whiten.cu``, kernel A) and the backward
kernel (kernel B) never write Kuf, A or their cotangents to device memory.
``fused_whiten`` is differentiable: its forward is kernel A and its
backward kernel B.  zc, xc and err get no gradient (in a window bank they
are data): the entry points refuse them when they require one.

Shapes, as in the prototypes: zc (nw, M, 1); xc, err (nw, 1, N); linv
(nw, M, M); energy, freq (S, P) shared by the windows or (nw, S, P) per
window; var, inv_l (S,) or (nw, S).  A CPU tensor goes to the plain
version, a CUDA tensor to the kernel (float32 only, M <= ``MAX_M``).
"""

from __future__ import annotations

import ctypes
import functools
import math
import types

import torch

from . import _cuda

__all__ = ["fused_whiten", "fused_whiten_flat", "fused_whiten_bwd",
           "fused_whiten_bwd_roles", "fused_whiten_source_chunks", "fused_whiten_plain",
           "fused_whiten_bwd_plain", "MAX_M", "TILE_T", "ROLE_TILE_T"]

MAX_M = 160      # the largest kernel instance (csrc/fused_whiten.cu, kRows)
TILE_T = 32      # samples per tile of kernel A and B's present body (kTile)
ROLE_TILE_T = 64  # samples per tile of kernel B's role-split body (kRTile)

# Kernel B's launches that took its role-split body (csrc/fused_whiten.cu:
# M <= 112 where every pair's features fit), a part of fused_whiten_bwd's.
fused_whiten_bwd_roles = _cuda.counter("fused_whiten_bwd_roles")

# The source chunks that one launch of kernel A (``fwd``) and of kernel B
# (``bwd``) walks a tile, from the plan of the last launch on the card (its
# shared memory holds so many sources' features at once; 1 where it holds
# every source).  Set where a wrapper plans its launch, so a captured
# step's replays leave it as its capture set it; 0 until a launch.
fused_whiten_source_chunks = types.SimpleNamespace(fwd=0, bwd=0)

_TWO_PI = 2.0 * math.pi


# ------------------------------------------------------------------ checks
def _check(zc, xc, err, linv, energy, freq, var, inv_l, du=None, dv=None):
    """(nw, M, N, S, P); raises ValueError on a shape, TypeError on a dtype
    or device that differs from zc's."""
    if zc.dim() != 3 or zc.shape[-1] != 1:
        raise ValueError(f"zc: expected (nw, M, 1), got {tuple(zc.shape)}")
    nw, m = zc.shape[:2]
    if energy.dim() not in (2, 3):
        raise ValueError(f"energy: expected (S, P) or (nw, S, P), got "
                         f"{tuple(energy.shape)}")
    s, p = energy.shape[-2:]
    n = xc.shape[-1]
    lead = (nw,) if energy.dim() == 3 else ()
    want = {"xc": (xc, (nw, 1, n)), "err": (err, (nw, 1, n)),
            "linv": (linv, (nw, m, m)), "freq": (freq, lead + (s, p)),
            "var": (var, lead + (s,)), "inv_l": (inv_l, lead + (s,))}
    if du is not None:
        want.update(du=(du, (nw, m, m)), dv=(dv, (nw, m, 1)))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
    for name, t in [("energy", energy)] + [(k, v[0]) for k, v in want.items()]:
        if t.dtype != zc.dtype or t.device != zc.device:
            raise TypeError(f"{name}: {t.dtype} on {t.device}, expected "
                            f"{zc.dtype} on {zc.device}")
    if not zc.dtype.is_floating_point:
        raise TypeError(f"unsupported dtype {zc.dtype}")
    return nw, m, n, s, p


def _per_window(energy, freq, var, inv_l):
    """The parameters with a window axis, of length 1 when shared."""
    if energy.dim() == 2:
        return energy[None], freq[None], var[None], inv_l[None]
    return energy, freq, var, inv_l


# ---------------------------------------------------------- plain versions
def fused_whiten_plain(zc, xc, err, linv, energy, freq, var, inv_l):
    """(U (nw, M, M), v (nw, M, 1)) by the unfused composition that
    scripts/proto_fused_whiten.py::xla_reference builds: the cosine mixture
    as the product of cosine features, every source at once (a source axis
    after the window axis, as the unfused bound's StackedSum holds it).
    Differentiable by autograd in every input."""
    # kernels.spectral imports this package: import it at the call
    from ..kernels.spectral import cosine_features
    _check(zc, xc, err, linv, energy, freq, var, inv_l)
    e, f, v, il = _per_window(energy, freq, var, inv_l)
    d = (zc - xc).abs()[:, None]                           # (nw, 1, M, N)
    phi_z = cosine_features(zc[:, None], e, f)             # (nw, S, M, 2P)
    phi_x = cosine_features(xc.mT[:, None], e, f)          # (nw, S, N, 2P)
    kuf = (v[..., None, None] * torch.exp(-d * il[..., None, None])
           * (phi_z @ phi_x.mT)).sum(1)
    a = linv @ kuf
    return a @ a.mT, a @ err.mT


def fused_whiten_bwd_plain(zc, xc, err, linv, du, dv, energy, freq, var, inv_l):
    """Given the cotangents (du, dv) of (U, v): (dlinv (nw, M, M),
    dvar (nw, 1, S), dinvl (nw, 1, S), de (nw, S, P), df (nw, S, P)) per
    window, by the backward kernel's own formulas (not autograd), in its
    association, which is scripts/proto_fused_whiten_bwd.py's: with
    G = dU + dU^T, the whitened A is formed again,

        A = Linv Kuf,  dA = G A + dv err^T,
        dK = Linv^T dA,  dLinv = dA Kuf^T,
        per source s, with E = exp(-|z - x| inv_l), C_p = cos(w_p (z - x)),
        S_p = sin(w_p (z - x)), mix = sum_p e_p C_p, dM = var E . dK:
        dvar = <dK, E mix>,  dinvl = -var <dK, E mix |z - x|>,
        de_p = <dM, C_p>,    df_p = -2 pi e_p <dM, (z - x) S_p>

    The kernel takes these products per tile of samples and sums dLinv
    over the tiles.  A is bounded where Linv is large: at a state trained by
    L-BFGS (|G| ~ 1e7, |Linv| ~ 5e2) the reassociated C = Linv^T G Linv,
    applied to Kuf, cancelled: the f32 gradient of the bound came 9.3e-4
    from f64 in that association and 1.7e-4 in this one, on the CPU
    (tests/test_torch_fused_whiten_trained.py)."""
    _check(zc, xc, err, linv, energy, freq, var, inv_l, du, dv)
    e, f, v, il = _per_window(energy, freq, var, inv_l)
    dsig = (zc - xc)[:, None]                              # (nw, 1, M, N)
    d = dsig.abs()
    ang_z = _TWO_PI * zc[:, None] * f[..., None, :]        # (nw, S, M, P)
    ang_x = _TWO_PI * xc.mT[:, None] * f[..., None, :]     # (nw, S, N, P)
    cz, sz, cx, sx = ang_z.cos(), ang_z.sin(), ang_x.cos(), ang_x.sin()
    ez = e[..., None, :]
    mix = (cz * ez) @ cx.mT + (sz * ez) @ sx.mT            # (nw, S, M, N)
    env = torch.exp(-d * il[..., None, None])
    kuf = (v[..., None, None] * env * mix).sum(1)
    da = (du + du.mT) @ (linv @ kuf) + dv @ err
    dk = linv.mT @ da
    dlinv = da @ kuf.mT
    pm = dk[:, None] * env * mix
    dvar = pm.sum((-2, -1))                                # (nw, S)
    dinvl = -v * (pm * d).sum((-2, -1))
    dm = v[..., None, None] * env * dk[:, None]
    de = ((dm @ cx) * cz).sum(-2) + ((dm @ sx) * sz).sum(-2)
    dmd = dm * dsig
    df = -_TWO_PI * e * (((dmd @ cx) * sz).sum(-2) - ((dmd @ sx) * cz).sum(-2))
    return dlinv, dvar[:, None, :], dinvl[:, None, :], de, df


# ---------------------------------------------------------- CUDA launches
@functools.lru_cache(maxsize=256)
def _splits(bwd: bool, sizes, device_index: int) -> int:
    """Blocks per window, as csrc/fused_whiten.cu's ``plan`` picks them from
    the card's SMs, the kernel's resident blocks per SM and a wave model;
    the partial sums are added in a second, fixed-order pass."""
    splits = ctypes.c_int(1)
    with torch.cuda.device(device_index):
        rc = _cuda.load("fused_whiten").gpitch_fused_whiten_splits(
            int(bwd), *sizes, ctypes.byref(splits))
    _cuda.check(rc, "fused_whiten: splits")
    return splits.value


@functools.lru_cache(maxsize=256)
def _roles(m: int, s: int, p: int) -> bool:
    """Whether kernel B takes its role-split body at these sizes."""
    return bool(_cuda.load("fused_whiten").gpitch_fused_whiten_bwd_roles(m, s, p))


@functools.lru_cache(maxsize=256)
def _source_chunks(bwd: bool, m: int, s: int, p: int) -> int:
    """The source chunks a launch of kernel A or B walks at these sizes."""
    return _cuda.load("fused_whiten").gpitch_fused_whiten_source_chunks(int(bwd), m, s, p)


def _prepare(zc, xc, err, linv, energy, freq, var, inv_l, du=None, dv=None):
    """Check a CUDA call; returns (sizes, contiguous inputs, window strides
    of the (S, P) and (S,) parameters)."""
    sizes = _check(zc, xc, err, linv, energy, freq, var, inv_l, du, dv)
    if not zc.is_cuda:
        raise ValueError(f"unsupported device {zc.device}")
    if zc.dtype != torch.float32:
        raise TypeError(f"the fused-whiten kernels take float32, got {zc.dtype}")
    nw, m, n, s, p = sizes
    if m > MAX_M:
        raise ValueError(f"M={m} > {MAX_M}: the fused-whiten kernels hold "
                         "Linv in shared memory")
    if nw > 65535:
        raise ValueError("more than 65535 windows in one launch")
    shared = energy.dim() == 2
    strides = (0, 0) if shared else (s * p, s)
    tensors = [t.detach().contiguous() for t in
               (zc, xc, err, linv, energy, freq, var, inv_l)
               + (() if du is None else (du, dv))]
    return sizes, tensors, strides


def _records(nw, splits, rec, dev):
    """Each block's partial record (nw, splits, rec) and their sum (nw, 1,
    rec), the same tensor when a window takes one block."""
    part = torch.empty((nw, splits, rec), dtype=torch.float32, device=dev)
    if splits == 1:
        return part, part
    return part, torch.empty((nw, 1, rec), dtype=torch.float32, device=dev)


def _forward_kernel(zc, xc, err, linv, energy, freq, var, inv_l, splits=None):
    """Kernel A on CUDA tensors: (U, v); ``splits`` overrides the plan.
    The kernel reads Linv's lower triangle only (diagonal included), as
    torch.linalg.solve_triangular reads one triangle: what its strict upper
    triangle holds does not matter."""
    sizes, tensors, strides = _prepare(zc, xc, err, linv, energy, freq, var, inv_l)
    nw, m, _, s, p = sizes
    dev = zc.device
    lib = _cuda.load("fused_whiten")
    splits = splits or _splits(False, sizes, dev.index)
    fused_whiten_source_chunks.fwd = _source_chunks(False, m, s, p)
    part, out = _records(nw, splits, m * m + m, dev)
    ws = torch.empty((nw, lib.gpitch_fused_whiten_fwd_workspace(m, s, p)),
                     dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.gpitch_fused_whiten_fwd(
            *(t.data_ptr() for t in tensors), part.data_ptr(), out.data_ptr(),
            ws.data_ptr(), *strides, *sizes, splits,
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(rc, "fused_whiten")
    buf = out.view(nw, m * m + m)
    return buf[:, :m * m].view(nw, m, m), buf[:, m * m:].view(nw, m, 1)


def _backward_kernel(zc, xc, err, linv, du, dv, energy, freq, var, inv_l,
                     splits=None):
    """Kernel B on CUDA tensors; ``splits`` overrides the plan of its main
    kernel: the records a window takes (the present body: its blocks; the
    role-split body: at most that many blocks cover a window).  The record
    of a block is [dLinv (M M), dvar (S), dinvl (S), de (S P), df (S P)].
    Like kernel A it reads Linv's lower triangle only."""
    sizes, tensors, strides = _prepare(zc, xc, err, linv, energy, freq, var,
                                       inv_l, du, dv)
    nw, m, _, s, p = sizes
    dev = zc.device
    lib = _cuda.load("fused_whiten")
    splits = splits or _splits(True, sizes, dev.index)
    fused_whiten_source_chunks.bwd = _source_chunks(True, m, s, p)
    rec = m * m + 2 * s + 2 * s * p
    part, sums = _records(nw, splits, rec, dev)
    ws = torch.empty((nw, lib.gpitch_fused_whiten_bwd_workspace(m, s, p)),
                     dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.gpitch_fused_whiten_bwd(
            *(t.data_ptr() for t in tensors), part.data_ptr(), sums.data_ptr(),
            ws.data_ptr(), *strides, *sizes, splits,
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(rc, "fused_whiten_bwd")
    buf = sums.view(nw, rec)
    o = m * m
    return (buf[:, :o].view(nw, m, m), buf[:, o:o + s].view(nw, 1, s),
            buf[:, o + s:o + 2 * s].view(nw, 1, s),
            buf[:, o + 2 * s:o + 2 * s + s * p].view(nw, s, p),
            buf[:, o + 2 * s + s * p:].view(nw, s, p))


@_cuda.counted
def fused_whiten_bwd(zc, xc, err, linv, du, dv, energy, freq, var, inv_l):
    """Kernel B (``make_fused_bwd``): given (du, dv), the per-window
    (dlinv (nw, M, M), dvar (nw, 1, S), dinvl (nw, 1, S), de (nw, S, P),
    df (nw, S, P)) of ``fused_whiten_bwd_plain``.  A CPU tensor goes to the
    plain version."""
    if zc.device.type == "cpu":
        return fused_whiten_bwd_plain(zc, xc, err, linv, du, dv, energy, freq,
                                      var, inv_l)
    out = _backward_kernel(zc, xc, err, linv, du, dv, energy, freq, var, inv_l)
    fused_whiten_bwd.launches += 1
    if _roles(zc.shape[1], *energy.shape[-2:]):
        fused_whiten_bwd_roles.launches += 1
    return out


# ---------------------------------------------------------------- autograd
class _FusedWhiten(torch.autograd.Function):
    """Forward: kernel A (or the plain forward on the CPU).  Backward:
    kernel B (or the plain backward), reduced over windows for the
    parameters the windows share."""

    @staticmethod
    def forward(ctx, entry, zc, xc, err, linv, energy, freq, var, inv_l):
        ctx.save_for_backward(zc, xc, err, linv, energy, freq, var, inv_l)
        if zc.device.type == "cpu":
            return fused_whiten_plain(zc, xc, err, linv, energy, freq, var, inv_l)
        u, v = _forward_kernel(zc, xc, err, linv, energy, freq, var, inv_l)
        entry.launches += 1
        return u, v

    @staticmethod
    def backward(ctx, du, dv):
        zc, xc, err, linv, energy, freq, var, inv_l = ctx.saved_tensors
        dlinv, dvar, dinvl, de, df = fused_whiten_bwd(
            zc, xc, err, linv, du.contiguous(), dv.contiguous(), energy, freq,
            var, inv_l)
        shared = energy.dim() == 2

        def fold(g):
            return g.sum(0) if shared else g

        return (None, None, None, None, dlinv, fold(de), fold(df),
                fold(dvar[:, 0]), fold(dinvl[:, 0]))


def _refuse_data_grads(zc, xc, err):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (zc, xc, err)):
        raise RuntimeError("fused_whiten has no gradient in zc, xc or err: "
                           "pass them detached")


@_cuda.counted
def fused_whiten(zc, xc, err, linv, energy, freq, var, inv_l):
    """(U (nw, M, M), v (nw, M, 1)) of ``fused_whiten_plain`` through kernel
    A (``make_fused_mxu``'s arguments), differentiable in linv, energy,
    freq, var and inv_l through kernel B.  Linv must be lower triangular:
    on the card kernels A and B read its lower triangle only (the plain
    versions take it whole; chol_inv's Linv is exactly lower).  Raises
    if grad mode is on and zc, xc or err requires grad."""
    _refuse_data_grads(zc, xc, err)
    return _FusedWhiten.apply(fused_whiten, zc, xc, err, linv, energy, freq,
                              var, inv_l)


@_cuda.counted
def fused_whiten_flat(zc, xc, err, linv, params, num_sources: int):
    """``make_fused``'s form: params (1, S (2P + 2)) shared, or
    (nw, S (2P + 2)) per window, flat per source [e_1..e_P, f_1..f_P, var,
    inv_l].  Unpacks them and runs kernel A (differentiable in params).
    Raises as ``fused_whiten`` does."""
    _refuse_data_grads(zc, xc, err)
    if params.dim() != 2 or params.shape[1] % num_sources:
        raise ValueError(f"params: expected (1 or nw, S (2P + 2)), got "
                         f"{tuple(params.shape)} for S={num_sources}")
    stride = params.shape[1] // num_sources
    if stride < 4 or stride % 2:
        raise ValueError(f"params: {stride} values per source is not 2P + 2")
    p = (stride - 2) // 2
    r = params.reshape(params.shape[0], num_sources, stride)
    if params.shape[0] == 1:
        r = r[0]
    return _FusedWhiten.apply(fused_whiten_flat, zc, xc, err, linv,
                              r[..., :p], r[..., p:2 * p], r[..., 2 * p],
                              r[..., 2 * p + 1])
