"""The yardstick's operation and byte counts, worked out from shapes.

Each count is of the work the mathematics needs, once, whatever computes
it: the least-work association of a product, a lower triangle where only
it is needed, each input read once and each output written once.  A count
is (products, other operations, bytes): products are the multiply-adds of
matrix products (2 operations each), other operations the transcendental
and elementwise ones.  Nothing here is taken from the program: a change to
the program's association or its kernels does not move these numbers.

``least_s`` is the least time an NVIDIA H100 SXM could take (NVIDIA's
data sheet, dense rates): products at the TF32 tensor-core rate, the
fastest at which the card multiplies float32 operands, so no float32
implementation can read over 100%; the rest at the float32 rate outside
the tensor cores; the bytes at the HBM3 bandwidth.  The three units run
at once, so the largest of the three times counts.
"""

from __future__ import annotations

__all__ = ["PRODUCT_FLOP_PER_S", "OTHER_FLOP_PER_S", "BYTES_PER_S", "least_s",
           "kernel_a", "kernel_b", "cholesky", "specmix", "bank_step",
           "predict_sources", "total"]

PRODUCT_FLOP_PER_S = 495e12     # dense TF32 tensor cores
OTHER_FLOP_PER_S = 67e12        # float32 outside the tensor cores
BYTES_PER_S = 3.35e12           # HBM3


def least_s(count) -> float:
    """The least seconds of a count (products, other, bytes)."""
    products, other, nbytes = count
    return max(products / PRODUCT_FLOP_PER_S, other / OTHER_FLOP_PER_S,
               nbytes / BYTES_PER_S)


def total(count) -> float:
    """All the operations of a count."""
    return count[0] + count[1]


def _add(*counts):
    return tuple(sum(c[i] for c in counts) for i in range(3))


def _scale(count, k):
    return tuple(k * c for c in count)


def _params(s: int, p: int) -> int:
    """Floats of one window's kernel parameters: energies and frequencies
    (S, P), variances and inverse lengthscales (S,)."""
    return 2 * s * p + 2 * s


def kernel_a(m: int, n: int, s: int, p: int):
    """One window of the bound's forward chain, Kuf -> A = Linv Kuf -> (A
    A^T, A err), float32: the mixture of Kuf as a K = 2P contraction of
    cos / sin features per pitch (4 P S M N), A with Linv lower triangular
    (M (M + 1) N), A A^T symmetric (M (M + 1) N), A err (2 M N); the
    envelope, variance and sum over pitches 4 S M N other.  Bytes: Linv's
    lower triangle, z, x, err and the parameters in, A A^T and A err out."""
    products = 4 * p * s * m * n + 2 * m * (m + 1) * n + 2 * m * n
    floats = m * (m + 1) // 2 + m + 2 * n + _params(s, p) + m * m + m
    return products, 4 * s * m * n, 4 * floats


def kernel_b(m: int, n: int, s: int, p: int):
    """One window of the chain's gradient, given the cotangents dU of A A^T
    and dv of A err, float32, in the fewer-operation of its two
    associations: either A again, dA = (dU + dU^T) A + dv err^T and the
    dense dLinv = dA Kuf^T, dKuf = Linv^T dA; or (as its prototype takes
    it) C = Linv^T (dU + dU^T) Linv and h = Linv^T dv per window (O(M^3)),
    then per sample dKuf = C Kuf + h err^T, Q = Kuf Kuf^T (symmetric) and
    Kuf err, and dLinv = (dU + dU^T) Linv Q + dv (Kuf err)^T.  Plus the
    rebuilt Kuf (4 P S M N) and the parameters' sums over dKuf (8 P S M N),
    the envelope's 4 S M N other.  Bytes: Linv's lower triangle, dU, dv, z,
    x, err and the parameters in, dLinv and the parameters' gradients
    out."""
    tri = m * (m + 1) * n
    again = 2 * tri + 4 * m * m * n + 2 * m * n
    folded = (m * m + 3 * m * m * (m + 1) + m * (m + 1) + 2 * m * m * n + 4 * m * n
              + tri + 2 * m ** 3 + m * m)
    products = min(again, folded) + 4 * p * s * m * n + 8 * p * s * m * n
    floats = m * (m + 1) // 2 + 2 * m * m + 2 * m + 2 * n + 2 * _params(s, p)
    return products, 4 * s * m * n, 4 * floats


def cholesky(m: int, itemsize: int):
    """One (M, M) Cholesky factor: M^3 / 3 products, M square roots and
    divisions; the lower triangle in and out."""
    return m ** 3 / 3.0, float(m), itemsize * m * (m + 1)


def specmix(n: int, m: int, s: int, p: int):
    """One window's (S, N, M) spectral-mixture covariances, float32, not
    summed over pitches: the mixture as a K = 2P contraction of features
    (4 P S N M), the envelope and variance 4 S N M other; the points and
    parameters in, the covariances out."""
    floats = s * n * m + n + m + _params(s, p)
    return 4 * p * s * n * m, 4 * s * n * m, 4 * floats


def _kuu(m: int, s: int, p: int):
    return 4 * p * s * m * m, 4 * s * m * m, 0


def bank_step(nw: int, m: int, n: int, s: int, p: int):
    """One Adam step of a bank of ``nw`` windows: per window the bound
    (Kuu built, factored and inverted, kernel A's chain, B = I + A A^T /
    sigma^2 factored and inverted, c) and its gradient (kernel B's chain,
    the two factorizations' pullbacks at 2 M^3 each, Kuu's build again
    twice).  Adam's elementwise update is left out (under 0.01%)."""
    m3 = m ** 3
    fwd = _add(kernel_a(m, n, s, p), _kuu(m, s, p), (4 * m3 / 3 + 4 * m * m, 0, 0))
    bwd = _add(kernel_b(m, n, s, p), _scale(_kuu(m, s, p), 2), (4 * m3, 0, 0))
    return _scale(_add(fwd, bwd), nw)


def predict_sources(nw: int, n: int, s: int, p: int):
    """Every window's per-source posterior means and variances at its own
    N samples: the pitches' (N, N) covariances (``specmix``), the mixture
    Gram's Cholesky factor (N^3 / 3), the triangular solves the variances
    need (S N^3), the means (2 S N^2 + 4 N^2)."""
    per = _add(specmix(n, n, s, p),
               (n ** 3 / 3.0 + s * n ** 3 + 2 * s * n * n + 4 * n * n, 0, 0))
    return _scale(per, nw)
