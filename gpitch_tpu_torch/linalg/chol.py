"""Batched Cholesky of small SPD matrices: CUDA kernel and its plain version.

Replaces gpitch_tpu/linalg/pallas/chol.py::cholesky_batched.  The kernel is
``gpitch_tpu_torch/csrc/chol.cu`` (one thread block per matrix, the lower
triangle packed by columns in shared memory); ``cholesky_plain`` runs the
same right-looking recurrence in torch:

    d_j      = A[j, j]                   (NaN when not positive)
    A[i, k] -= A[i, j] (A[k, j] / d_j)   for i, k > j
    L[:, j]  = A[:, j] / sqrt(d_j)       on and below the diagonal
"""

from __future__ import annotations

import torch

from . import _cuda

__all__ = ["cholesky_batched", "cholesky_plain", "MAX_M"]

MAX_M = 256
# the packed triangle plus one column must fit a block's shared memory
_SMEM_BYTES = 232448


def cholesky_plain(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each matrix of K (..., M, M), by the
    kernel's recurrence in torch; NaN where a pivot is not positive."""
    m = K.shape[-1]
    A = K.clone()
    nan = torch.tensor(float("nan"), dtype=K.dtype, device=K.device)
    pivots = []
    for j in range(m):
        d = A[..., j, j]
        d = torch.where(d > 0, d, nan)
        pivots.append(d)
        a = A[..., j + 1:, j]
        A[..., j + 1:, j + 1:] -= a[..., :, None] * (a * (1.0 / d)[..., None])[..., None, :]
    return torch.tril(A / torch.sqrt(torch.stack(pivots, -1))[..., None, :])


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
    out = torch.empty_like(K)
    size = K.element_size()
    scratch = None
    if size * (m + m * (m + 1) // 2) > _SMEM_BYTES:
        scratch = torch.empty((b, m * (m + 1) // 2), dtype=K.dtype,
                              device=K.device)
    lib = _cuda.load("chol")
    fn = lib.gpitch_chol_f32 if K.dtype == torch.float32 else lib.gpitch_chol_f64
    with torch.cuda.device(K.device):
        rc = fn(K.data_ptr(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(), b, m,
                torch.cuda.current_stream(K.device).cuda_stream)
    _cuda.check(rc, "cholesky_batched")
    cholesky_batched.launches += 1
    return out


cholesky_batched.launches = 0
