"""The port's linear algebra (gpitch_tpu_torch.linalg) against gpitch_tpu.

Same seeded numpy inputs through both packages.  The Pallas kernels run as
tests/test_pallas.py runs them (interpret mode on the CPU); the port's
kernels run their plain versions on CPU tensors (the CUDA kernels are
held against those plain versions in tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpitch_tpu.linalg import ops as jops
from gpitch_tpu.linalg.pallas.chol import cholesky_batched as j_cholesky_batched
from gpitch_tpu.linalg.pallas.specmix import specmix_matrix as j_specmix
from gpitch_tpu.linalg.pallas.specmix import specmix_matrix_xla as j_specmix_xla
from gpitch_tpu_torch.linalg import ops as tops
from gpitch_tpu_torch.linalg.chol import cholesky_batched, cholesky_plain, panel_width
from gpitch_tpu_torch.linalg.specmix import specmix_matrix, specmix_plain


def _spd(rng, b, m, dtype=np.float64):
    A = rng.standard_normal((b, m, m)) * 0.2
    return (A @ np.swapaxes(A, 1, 2) + np.eye(m) * m).astype(dtype)


def _ill_gram(m, dtype=np.float64):
    """The strongly correlated Gram of gpitch_tpu/linalg/ops.py:169-171."""
    i = np.arange(m, dtype=np.float64)
    corr = np.exp(-np.abs(i[:, None] - i[None, :]) / max(m / 3.0, 1.0))
    return (corr + 1e-3 * np.eye(m)).astype(dtype)


@pytest.mark.parametrize("b,m,bt", [
    pytest.param(b, m, bt, id=f"{b}-{m}-{bt}")
    for b, m, bt in [(5, 24, 4), (3, 100, 3), (3, 112, 2), (2, 128, 2), (2, 136, 2),
                     (2, 160, 2), (2, 200, 2), (1, 256, 1)]])
def test_cholesky_plain_matches_pallas_and_xla(b, m, bt):
    """Both Pallas branches (unblocked below M 96 and where no panel of
    32/28/16 divides M: 100, 136, 200; panel at 112, 128, 160, 256) in f32,
    at the tolerance of tests/test_pallas.py (f32 rounding, 3e-5); the f64
    plain recurrence against LAPACK at 1e-12 (f64 rounding, well
    conditioned).  The plain recurrence takes the kernel's panel width
    (panel_width: 16 up to M 128, 32 above), so M 24-128 run panels of 16
    and M 136-256 panels of 32; the last panel is ragged at M 24 (under one
    panel), 100 (6 x 16 + 4), 136 (4 x 32 + 8) and 200 (6 x 32 + 8)."""
    assert panel_width(m) == (16 if m <= 128 else 32)
    K = _spd(np.random.default_rng(5), b, m, np.float32)
    got = cholesky_plain(torch.as_tensor(K)).numpy()
    pallas = np.asarray(j_cholesky_batched(jnp.asarray(K), batch_tile=bt,
                                           interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(got, np.asarray(jnp.linalg.cholesky(K)),
                               rtol=3e-5, atol=3e-5)
    assert np.array_equal(got, np.tril(got))
    K64 = K.astype(np.float64)
    np.testing.assert_allclose(cholesky_plain(torch.as_tensor(K64)).numpy(),
                               np.asarray(jnp.linalg.cholesky(K64)),
                               rtol=1e-12, atol=1e-12)


def test_cholesky_plain_on_ill_conditioned_gram():
    """The self-check Gram (lambda_min ~ 1e-3): f64 against LAPACK at 1e-10
    (cond ~ 1e4 times f64 rounding); f32 against the Pallas panel kernel and
    LAPACK at the self-check's 1e-3 * max|L| (f32 rounding times cond)."""
    m = 112
    g = _ill_gram(m)
    np.testing.assert_allclose(cholesky_plain(torch.as_tensor(g[None])).numpy()[0],
                               np.linalg.cholesky(g), rtol=1e-10, atol=1e-10)
    g32 = np.broadcast_to(_ill_gram(m, np.float32), (2, m, m)).copy()
    got = cholesky_plain(torch.as_tensor(g32)).numpy()
    assert np.isfinite(got).all()
    scale = np.abs(got).max()
    pallas = np.asarray(j_cholesky_batched(jnp.asarray(g32), batch_tile=2,
                                           interpret=True))
    assert np.abs(got - pallas).max() <= 1e-3 * scale
    assert np.abs(got - np.asarray(jnp.linalg.cholesky(g32))).max() <= 1e-3 * scale


def test_cholesky_not_positive_definite_gives_nan():
    """As jnp.linalg.cholesky: a non-PD matrix factors to NaN, never clamped."""
    K = np.eye(8)[None].repeat(2, 0)
    K[1, 5, 5] = -1.0
    got = cholesky_plain(torch.as_tensor(K)).numpy()
    assert np.isfinite(got[0]).all() and np.isnan(got[1]).any()
    assert np.isnan(np.asarray(jnp.linalg.cholesky(K[1]))).any()
    L, _ = tops.chol_inv(torch.as_tensor(K))
    assert np.isnan(L[1].numpy()).all() and np.isfinite(L[0].numpy()).all()


@pytest.mark.parametrize("panel,m", [(16, 40), (32, 160)], ids=["16", "32"])
def test_cholesky_nan_starts_at_the_failing_pivot(panel, m):
    """The columns before a failing pivot stay finite and the pivot's column
    is NaN, also when the pivot lies past the first panel (in the second
    panel of 16 at M 40, of 32 at M 160)."""
    assert panel_width(m) == panel
    k = panel + 9
    K = np.eye(m)[None].repeat(2, 0)
    K[1, k, k] = -1.0
    got = cholesky_plain(torch.as_tensor(K)).numpy()
    assert np.isfinite(got[0]).all() and np.isnan(got[1, k:, k]).all()
    assert np.isfinite(got[1, :, :k]).all()


def test_cholesky_wrapper_uses_plain_version_on_cpu():
    K = torch.as_tensor(_spd(np.random.default_rng(1), 3, 20))
    before = cholesky_batched.launches
    assert torch.equal(cholesky_batched(K), cholesky_plain(K))
    assert cholesky_batched.launches == before   # no kernel launch on the CPU
    with pytest.raises(ValueError):
        cholesky_batched(K[0])


def _specmix_inputs(rng, b, s, n, m, p):
    x = np.sort(rng.random((b, n)), axis=1)
    x2 = np.sort(rng.random((b, m)), axis=1)
    e = rng.uniform(0.1, 1.0, (b, s, p))
    f = rng.uniform(10.0, 150.0, (b, s, p))
    v = rng.uniform(0.5, 2.0, (b, s))
    ls = rng.uniform(0.03, 0.2, (b, s))
    return x, x2, e, f, v, ls


@pytest.mark.parametrize("m32", [False, True])
def test_specmix_plain_matches_pallas_and_xla(m32):
    """Each (b, s) matrix of the batched plain build against the Pallas
    kernel (interpret) and the XLA feature-matmul reference, at
    tests/test_pallas.py's sizes; f64, 1e-10 relative (the feature matmul
    sums in another order)."""
    b, s, n, m, p = 2, 2, 256, 128, 3
    x, x2, e, f, v, ls = _specmix_inputs(np.random.default_rng(3), b, s, n, m, p)
    got = specmix_plain(*map(torch.as_tensor, (x, x2, e, f, v, ls)), m32=m32).numpy()
    assert got.shape == (b, s, n, m)
    for bi in range(b):
        for si in range(s):
            args = (jnp.asarray(x[bi, :, None]), jnp.asarray(x2[bi, :, None]),
                    jnp.asarray(e[bi, si]), jnp.asarray(f[bi, si]),
                    float(v[bi, si]), float(ls[bi, si]))
            pallas = np.asarray(j_specmix(*args, tile_n=128, tile_m=128, m32=m32,
                                          interpret=True))
            xla = np.asarray(j_specmix_xla(*args, m32=m32))
            scale = np.abs(xla).max()
            np.testing.assert_allclose(got[bi, si], pallas, rtol=0, atol=1e-10 * scale)
            np.testing.assert_allclose(got[bi, si], xla, rtol=0, atol=1e-10 * scale)
    summed = specmix_plain(*map(torch.as_tensor, (x, x2, e, f, v, ls)), m32=m32,
                           sum_sources=True).numpy()
    np.testing.assert_allclose(summed, got.sum(1), rtol=1e-13, atol=1e-13)


def test_specmix_plain_f32_holds_the_amt_width():
    """f32 at the AMT width (44.1 kHz, a centred 2001-sample window, 8
    pitches x 20 partials up to 0.45 fs = 19.8 kHz) against the f64 XLA
    feature-matmul reference: the feature form with f64 angles keeps each
    source within 1e-6 of max|K| (f32 rounding of the reduced angle and the
    products).  The direct form, cos(2 pi f (x - x2)) on f32 arguments of up
    to ~2.8e3 rad, misses that by two orders of magnitude."""
    fs, n, s, p = 44100.0, 2001, 8, 20
    rng = np.random.default_rng(11)
    x = ((np.arange(n) - (n - 1) / 2) / fs).astype(np.float32)
    x2 = x[::8].copy()
    f0 = 27.5 * 2 ** (np.arange(0, 88, 11) / 12)
    f = np.minimum(f0[:, None] * np.arange(1, p + 1), 0.45 * fs).astype(np.float32)
    e = rng.uniform(0.1, 1.0, (s, p))
    e = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    v = rng.uniform(0.5, 2.0, s).astype(np.float32)
    ls = rng.uniform(0.01, 0.1, s).astype(np.float32)
    got = specmix_plain(*map(torch.as_tensor, (x[None], x2[None], e[None], f[None],
                                               v[None], ls[None]))).numpy()[0]
    d = x[:, None] - x2[None, :]                                # f32 arguments
    for si in range(s):
        want = np.asarray(j_specmix_xla(*(jnp.asarray(a, dtype=jnp.float64) for a in (
            x[:, None], x2[:, None], e[si], f[si])), float(v[si]), float(ls[si])))
        scale = np.abs(want).max()
        assert np.abs(got[si] - want).max() <= 1e-6 * scale
        direct = v[si] * np.exp(-np.abs(d) / ls[si]) * sum(
            e[si, q] * np.cos(np.float32(2 * np.pi) * f[si, q] * d) for q in range(p))
        if si == s - 1:     # the highest partials: the direct form's worst case
            assert np.abs(direct - want).max() > 30e-6 * scale


def test_specmix_wrapper_is_forward_only():
    x, x2, e, f, v, ls = map(torch.as_tensor, _specmix_inputs(
        np.random.default_rng(4), 1, 2, 16, 8, 3))
    with torch.no_grad():
        before = specmix_matrix.launches
        assert torch.equal(specmix_matrix(x, x2, e, f, v, ls),
                           specmix_plain(x, x2, e, f, v, ls))
        assert specmix_matrix.launches == before
    v = v.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        specmix_matrix(x, x2, e, f, v, ls)
    with pytest.raises(ValueError):
        specmix_matrix(x, x2[:, :4, None], e, f, v.detach(), ls)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_add_jitter_matches(dtype):
    """The jitter follows the tensor dtype; the JAX package reads a global
    x64 flag (on here), so its f32 policy is passed explicitly.  Exact up to
    the mean's summation order."""
    m = 40
    K = _spd(np.random.default_rng(2), 3, m, dtype) * 50.0
    got = tops.add_jitter(torch.as_tensor(K)).numpy()
    if dtype == np.float32:
        want = jops.add_jitter(jnp.asarray(K), jitter=1e-4, jitter_rel=1e-5)
        # the M-aware floor (8e-7 * M = 3.2e-5 > 1e-5) lifts the diagonal by
        # ~0.064 against f32 diagonals ~2000 (ulp 1.2e-4): 1e-2 separates it
        # from the fixed 1e-5 floor's lift (~0.02)
        lift = 1e-4 + 8e-7 * m * np.diagonal(K, axis1=1, axis2=2).mean(-1)
        np.testing.assert_allclose(np.diagonal(got - K, axis1=1, axis2=2),
                                   np.broadcast_to(lift[:, None], (3, m)), rtol=1e-2)
    else:
        want = jops.add_jitter(jnp.asarray(K))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6 if dtype == np.float32
                               else 1e-15, atol=0)
    np.testing.assert_allclose(tops.add_jitter(torch.as_tensor(K), 0.5, 0.0).numpy(),
                               np.asarray(jops.add_jitter(jnp.asarray(K), 0.5, 0.0)),
                               rtol=0, atol=0)


def test_chol_inv_values_and_backward_match_jax():
    """(L, Linv) and the matmul-only backward, as jax.grad of a scalar of
    (L, Linv); f64, values 1e-12, gradients 1e-9 relative (the gradient
    passes Linv three times; cond(K) ~ 10)."""
    rng = np.random.default_rng(7)
    K = _spd(rng, 3, 20)
    W1, W2 = rng.standard_normal((2, 3, 20, 20))

    def jf(k):
        L, Li = jops.safe_chol_inv(k)
        return jnp.sum(W1 * L) + jnp.sum(W2 * Li ** 2)

    Kt = torch.as_tensor(K).requires_grad_(True)
    L, Li = tops.safe_chol_inv(Kt)
    (torch.as_tensor(W1) * L).sum().add((torch.as_tensor(W2) * Li ** 2).sum()).backward()
    jL, jLi = jops.safe_chol_inv(jnp.asarray(K))
    np.testing.assert_allclose(L.detach().numpy(), np.asarray(jL), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(Li.detach().numpy(), np.asarray(jLi), rtol=1e-12, atol=1e-13)
    jg = np.asarray(jax.grad(jf)(jnp.asarray(K)))
    np.testing.assert_allclose(Kt.grad.numpy(), jg, rtol=1e-9,
                               atol=1e-9 * np.abs(jg).max())


@pytest.mark.parametrize("n,block", [(300, 64), (1100, 256)])
def test_tri_inv_blocked_matches_jax(n, block):
    """Block-doubling inverse against the JAX rewrite and a plain solve;
    f64, 1e-10 relative to max|Linv| (block matmuls reassociate)."""
    K = _spd(np.random.default_rng(8), 2, n)
    L = np.linalg.cholesky(K)
    got = tops.tri_inv_blocked(torch.as_tensor(L), block=block).numpy()
    want = np.linalg.inv(L)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * scale)
    if n < 1024:    # the JAX rewrite runs op by op here: keep it small
        jgot = np.asarray(jops.tri_inv_blocked(jnp.asarray(L[0]), block=block))
        np.testing.assert_allclose(got[0], jgot, rtol=0, atol=1e-10 * scale)
    if n >= 1024:   # the _tri_inv rule takes the blocked path at this size
        np.testing.assert_allclose(tops._tri_inv(torch.as_tensor(L)).numpy(), got,
                                   rtol=0, atol=1e-10 * scale)
