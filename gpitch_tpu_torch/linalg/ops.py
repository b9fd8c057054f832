"""Dense GP linear algebra: jitter, the (L, L^-1) factorization and its
matmul-only backward, and the sparse-GP conditionals and KL divergence.

Counterpart of gpitch_tpu/linalg/ops.py.  Every function takes leading batch
axes (windows, sources) as they come, so each kernel sees the whole batch in
one launch.
"""

from __future__ import annotations

import torch

from ..config import default_jitter, default_jitter_rel
from .chol import MAX_M, cholesky_batched

__all__ = ["add_jitter", "tri_inv_blocked", "chol_inv", "safe_chol_inv",
           "safe_cholesky", "solve_lower", "solve_upper", "base_conditional",
           "base_conditional_inv", "conditional", "gauss_kl"]


def add_jitter(K: torch.Tensor, jitter: float | None = None,
               jitter_rel: float | None = None) -> torch.Tensor:
    """K + (jitter + rel_eff * mean(diag(K))) * I.

    Defaults follow K's dtype (config.default_jitter / default_jitter_rel).
    In float32 the relative part is M-aware, rel_eff = max(rel, 8e-7 M):
    f32 Cholesky rounding grows like eps * lambda_max * sqrt(M), and a fixed
    floor is outrun by it at large M.  The floor keys on K's last axis only,
    so it also lifts the N x N Gram of ``SGPRSS.predict_s``, exactly as the
    JAX package does.
    """
    j = default_jitter(K.dtype) if jitter is None else jitter
    rel = default_jitter_rel(K.dtype) if jitter_rel is None else jitter_rel
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    if rel:
        if K.dtype == torch.float32:
            rel = max(float(rel), 8e-7 * K.shape[-1])
        d = torch.diagonal(K, dim1=-2, dim2=-1)
        j = j + rel * d.mean(-1)[..., None, None]
    return K + j * eye


def _phi(X: torch.Tensor) -> torch.Tensor:
    """tril with halved diagonal: the projection in the Cholesky VJP."""
    return torch.tril(X, -1) + 0.5 * torch.diag_embed(
        torch.diagonal(X, dim1=-2, dim2=-1))


def tri_inv_blocked(L: torch.Tensor, block: int = 256) -> torch.Tensor:
    """Inverse of lower-triangular matrices (..., N, N) by 2 x 2 block
    doubling: one batched triangular solve over the diagonal blocks, then
    log2(N / block) levels of batched matmuls,

        inv([[A, 0], [B, C]]) = [[inv(A), 0], [-inv(C) B inv(A), inv(C)]].

    N is padded to block * 2^k with an identity tail (exact) and sliced back.
    """
    n = L.shape[-1]
    lead = L.shape[:-2]
    nb = max(1, -(-n // block))
    p2 = 1 << (nb - 1).bit_length()
    m = p2 * block
    if m != n:
        Lp = torch.zeros(lead + (m, m), dtype=L.dtype, device=L.device)
        Lp[..., :n, :n] = L
        tail = torch.arange(n, m, device=L.device)
        Lp[..., tail, tail] = 1.0
        L = Lp
    diag = torch.stack([L[..., i * block:(i + 1) * block, i * block:(i + 1) * block]
                        for i in range(p2)], dim=-3)            # (..., p2, b, b)
    eye = torch.eye(block, dtype=L.dtype, device=L.device).expand(diag.shape)
    X = torch.linalg.solve_triangular(diag, eye, upper=False)
    s, cnt = block, p2
    while cnt > 1:
        cnt //= 2
        Xa, Xc = X[..., 0::2, :, :], X[..., 1::2, :, :]          # (..., cnt, s, s)
        B = torch.stack([L[..., (2 * i + 1) * s:(2 * i + 2) * s, 2 * i * s:(2 * i + 1) * s]
                         for i in range(cnt)], dim=-3)
        low = -Xc @ B @ Xa
        top = torch.cat([Xa, torch.zeros_like(Xa)], dim=-1)
        bot = torch.cat([low, Xc], dim=-1)
        X = torch.cat([top, bot], dim=-2)                        # (..., cnt, 2s, 2s)
        s *= 2
    return X[..., 0, :n, :n]


# at or above this size the triangular inverse takes the blocked-matmul
# path; below it one batched triangular solve (the JAX package's CPU rule)
_TRI_INV_BLOCK_MIN = 1024


def _tri_inv(L: torch.Tensor) -> torch.Tensor:
    n = L.shape[-1]
    if n >= _TRI_INV_BLOCK_MIN:
        return tri_inv_blocked(L, block=32 if n <= 512 else 256)
    eye = torch.eye(n, dtype=L.dtype, device=L.device).expand(L.shape)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def _library_cholesky(K: torch.Tensor) -> torch.Tensor:
    """torch.linalg's Cholesky (differentiable); a matrix that is not
    positive definite factors to NaN, as jnp.linalg.cholesky does, instead
    of raising."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info == 0)[..., None, None], L, float("nan"))


def _cholesky(K: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky: CUDA tensors with M <= 256 go to the hand kernel;
    larger matrices (the N x N prediction Gram) and CPU tensors to
    torch.linalg."""
    m = K.shape[-1]
    if K.is_cuda and m <= MAX_M:
        return cholesky_batched(K.reshape(-1, m, m)).reshape(K.shape)
    return _library_cholesky(K)


class _CholInv(torch.autograd.Function):
    """(L, L^-1) with the matmul-only pullback (Murray 2016,
    arXiv:1602.07527): K_bar = L^-T Phi(L^T total) L^-1, symmetrized, where
    total folds the L^-1 cotangent in as -L^-T Linv_bar L^-T.  With L^-1 in
    hand the backward has no triangular solve, so the Cholesky kernel needs
    no backward kernel."""

    @staticmethod
    def forward(ctx, K):
        L = _cholesky(K)
        Linv = _tri_inv(L)
        ctx.save_for_backward(L, Linv)
        return L, Linv

    @staticmethod
    def backward(ctx, L_bar, Linv_bar):
        L, Linv = ctx.saved_tensors
        LinvT = Linv.mT
        total = L_bar - LinvT @ Linv_bar @ LinvT
        K_bar = LinvT @ _phi(L.mT @ total) @ Linv
        return 0.5 * (K_bar + K_bar.mT)


def chol_inv(K: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, L^-1) of each matrix of K (..., M, M)."""
    return _CholInv.apply(K)


def safe_chol_inv(K: torch.Tensor, jitter: float | None = None,
                  jitter_rel: float | None = None):
    """chol_inv of K + (jitter + jitter_rel * mean diag) * I (see add_jitter)."""
    return chol_inv(add_jitter(K, jitter, jitter_rel))


def safe_cholesky(K: torch.Tensor, jitter: float | None = None,
                  jitter_rel: float | None = None) -> torch.Tensor:
    """Cholesky of K + (jitter + jitter_rel * mean diag) * I (see
    add_jitter) by torch.linalg, where the JAX package takes
    jnp.linalg.cholesky; differentiable by autograd."""
    return _library_cholesky(add_jitter(K, jitter, jitter_rel))


def solve_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """L^-1 B for lower-triangular L."""
    return torch.linalg.solve_triangular(L, B, upper=False)


def solve_upper(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """L^-T B for lower-triangular L."""
    return torch.linalg.solve_triangular(L.mT, B, upper=True)


def _conditional(A, Knn_diag, q_mu, q_sqrt, unwhiten):
    """q(f) from A = Lm^-1 Kmn; ``unwhiten(A)`` gives Kmm^-1 Kmn."""
    fvar = Knn_diag - A.square().sum(-2)                 # (..., N)
    if unwhiten is not None:
        A = unwhiten(A)
    fmean = A.mT @ q_mu                                  # (..., N, Q)
    if q_sqrt is not None:
        fvar = fvar + (torch.tril(q_sqrt).mT @ A).square().sum(-2)
    return fmean, fvar[..., None] * torch.ones_like(fmean)


def base_conditional(Kmn, Lm, Knn_diag, q_mu, q_sqrt=None, whiten=True):
    """Marginals of q(f(Xnew)) given q(u) = N(q_mu, S), S = tril(q_sqrt)
    tril(q_sqrt)^T, and Lm = chol(Kmm + jitter).  Kmn (..., M, N), Lm (...,
    M, M), Knn_diag (..., N), q_mu (..., M, Q), q_sqrt (..., M, M) or None.
    Returns mean, var each (..., N, Q); by triangular solves."""
    unwhiten = None if whiten else (lambda A: solve_upper(Lm, A))
    return _conditional(solve_lower(Lm, Kmn), Knn_diag, q_mu, q_sqrt, unwhiten)


def base_conditional_inv(Kmn, Lm_inv, Knn_diag, q_mu, q_sqrt=None, whiten=True):
    """base_conditional with Lm^-1 from ``chol_inv``: every solve is a
    matmul."""
    unwhiten = None if whiten else (lambda A: Lm_inv.mT @ A)
    return _conditional(Lm_inv @ Kmn, Knn_diag, q_mu, q_sqrt, unwhiten)


def conditional(Xnew, Z, kernel, q_mu, q_sqrt=None, whiten=True,
                jitter: float | None = None):
    """q(f(Xnew)) of a sparse GP with inducing inputs Z; Kmm is factored by
    ``safe_chol_inv`` (the Cholesky kernel on the card up to M 256)."""
    _, Lm_inv = safe_chol_inv(kernel.K(Z), jitter)
    return base_conditional_inv(kernel.K(Z, Xnew), Lm_inv, kernel.Kdiag(Xnew),
                                q_mu, q_sqrt, whiten)


def gauss_kl(q_mu, q_sqrt, K=None, jitter: float | None = None):
    """KL[N(q_mu, S) || N(0, K)] with S = tril(q_sqrt) tril(q_sqrt)^T, one
    per leading index: q_mu (..., M, Q), q_sqrt (..., M, M).  K=None is the
    whitened prior N(0, I); otherwise K + jitter is factored by
    ``safe_chol_inv``."""
    m, q = q_mu.shape[-2:]
    Lq = torch.tril(q_sqrt)
    logdet_q = 2.0 * torch.log(torch.diagonal(Lq, dim1=-2, dim2=-1).abs() + 1e-38).sum(-1)
    if K is None:
        mahal = q_mu.square().sum((-2, -1))
        trace = Lq.square().sum((-2, -1)) * q
        logdet_p = 0.0
    else:
        Lp, Lp_inv = safe_chol_inv(K, jitter)
        mahal = (Lp_inv @ q_mu).square().sum((-2, -1))
        trace = (Lp_inv @ Lq).square().sum((-2, -1)) * q
        logdet_p = 2.0 * q * torch.log(torch.diagonal(Lp, dim1=-2, dim2=-1).abs()).sum(-1)
    return 0.5 * (mahal + trace - m * q - q * logdet_q + logdet_p)
