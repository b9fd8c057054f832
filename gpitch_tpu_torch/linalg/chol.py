"""Batched Cholesky of small SPD matrices: CUDA kernel and its plain version.

Replaces gpitch_tpu/linalg/pallas/chol.py::cholesky_batched.  The kernel is
``gpitch_tpu_torch/csrc/chol.cu`` (one thread block per matrix, blocked
right-looking with panels of 16 or 32 columns in shared memory);
``cholesky_plain`` runs the same blocked recurrence in torch.  Per panel of
columns k0..k0+w-1, on the slab S of rows k0.. of those columns:

    for each column j of the panel:
        d_j      = S[j, j]                   (NaN when not positive)
        S[:, j]  = S[:, j] / sqrt(d_j)       rows j.. (L11, then L21)
        S[i, c] -= S[i, j] S[c, j]           rows i > j, panel columns c > j
    A22 -= L21 L21^T                         the trailing matrix

Only the lower triangle of K is read.
"""

from __future__ import annotations

import torch

from . import _cuda

__all__ = ["cholesky_batched", "cholesky_plain", "panel_width", "MAX_M"]

MAX_M = 256


def panel_width(m: int) -> int:
    """The kernel's panel width for order m: 16 up to 128 (twice the panels,
    but a diagonal block half as long and a finer trailing update, faster
    at M 112 on the H100), 32 above (faster at M 160 and 256; PERF.md)."""
    return 16 if m <= 128 else 32


def cholesky_plain(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each matrix of K (..., M, M), by the
    kernel's blocked recurrence in torch, with its panel width; NaN from a
    pivot that is not positive on."""
    m = K.shape[-1]
    panel = panel_width(m)
    A = K.clone()
    for k0 in range(0, m, panel):
        w = min(panel, m - k0)
        S = A[..., k0:, k0:k0 + w]
        for j in range(w):
            d = S[..., j, j]
            d = torch.where(d > 0, d, torch.full_like(d, float("nan")))
            S[..., j:, j] *= (1.0 / torch.sqrt(d))[..., None]
            S[..., j + 1:, j + 1:] -= S[..., j + 1:, j, None] * S[..., None, j + 1:w, j]
        L21 = S[..., w:, :]
        A[..., k0 + w:, k0 + w:] -= L21 @ L21.mT
    return torch.tril(A)


@_cuda.counted
def cholesky_batched(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each matrix of a (B, M, M) batch, M <= 256.

    A CUDA tensor goes to the kernel (float32 or float64), a CPU tensor to
    ``cholesky_plain``.  Upper triangles are zero; a matrix that is not
    positive definite gives NaN.
    """
    if K.dim() != 3 or K.shape[-1] != K.shape[-2]:
        raise ValueError(f"expected a (B, M, M) batch, got {tuple(K.shape)}")
    if K.device.type == "cpu":
        return cholesky_plain(K)
    if not K.is_cuda:
        raise ValueError(f"unsupported device {K.device}")
    if K.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {K.dtype}")
    b, m = K.shape[0], K.shape[-1]
    if m > MAX_M:
        raise ValueError(f"M={m} > {MAX_M}: use torch.linalg.cholesky")
    K = K.contiguous()
    panel = panel_width(m)
    out = torch.empty_like(K)
    lib = _cuda.load("chol")
    elems = lib.gpitch_chol_scratch(m, panel, K.element_size())
    scratch = (torch.empty((b, elems), dtype=K.dtype, device=K.device)
               if elems > 0 else None)
    fn = lib.gpitch_chol_f32 if K.dtype == torch.float32 else lib.gpitch_chol_f64
    with torch.cuda.device(K.device):
        rc = fn(K.data_ptr(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(), b, m, panel,
                torch.cuda.current_stream(K.device).cuda_stream)
    _cuda.check(rc, "cholesky_batched")
    cholesky_batched.launches += 1
    return out
