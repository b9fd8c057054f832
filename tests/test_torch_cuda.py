"""The port's CUDA kernels against their plain versions, on the card.

Every test needs a CUDA card and skips without one.  The file imports
nothing of JAX, so on a machine with a card and without JAX it runs as

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from gpitch_tpu_torch.linalg import ops
from gpitch_tpu_torch.linalg.chol import cholesky_batched, cholesky_plain
from gpitch_tpu_torch.linalg.specmix import specmix_matrix, specmix_plain


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


@pytest.mark.parametrize("m,dtype", [(24, torch.float32), (112, torch.float32),
                                     (160, torch.float32), (256, torch.float32),
                                     (112, torch.float64), (256, torch.float64)])
def test_cuda_cholesky_kernel_matches_plain(cuda, m, dtype):
    """f32: 1e-4 of max|L| (f32 rounding along an M-step chain); f64: 1e-11.
    M = 256 in f64 runs on the device-memory scratch path."""
    K = torch.as_tensor(_spd(np.random.default_rng(m), 9, m)).to(cuda, dtype)
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


def test_cuda_cholesky_not_positive_definite_gives_nan(cuda):
    K = torch.eye(16, dtype=torch.float32, device=cuda).repeat(2, 1, 1)
    K[1, 9, 9] = -1.0
    L = cholesky_batched(K)
    assert bool(torch.isfinite(L[0]).all()) and bool(torch.isnan(L[1]).any())


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


def _specmix_args(dev, b, s, n, m, p):
    rng = np.random.default_rng(9)
    arrays = (np.sort(rng.uniform(0.0, 0.125, (b, n)), axis=1),
              np.sort(rng.uniform(0.0, 0.125, (b, m)), axis=1),
              rng.uniform(0.1, 1.0, (b, s, p)), rng.uniform(100.0, 4000.0, (b, s, p)),
              rng.uniform(0.5, 2.0, (b, s)), rng.uniform(0.05, 0.3, (b, s)))
    return [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in arrays]


@pytest.mark.parametrize("m32", [False, True])
def test_cuda_specmix_kernel_matches_plain(cuda, m32):
    """f32 with cosine arguments up to ~3e3 rad: both sides form the same
    f32 arguments, so they differ by the cos/exp implementations' few ulp;
    1e-5 of max|K| per source, 3e-5 for the source sum."""
    args = _specmix_args(cuda, 3, 3, 300, 257, 5)
    with torch.no_grad():
        before = specmix_matrix.launches
        got = specmix_matrix(*args, m32=m32)
        summed = specmix_matrix(*args, m32=m32, sum_sources=True)
        assert specmix_matrix.launches == before + 2
        want = specmix_plain(*args, m32=m32)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert float((summed - want.sum(1)).abs().max()) <= 3e-5 * scale


def test_cuda_specmix_refuses_gradients(cuda):
    args = _specmix_args(cuda, 1, 2, 8, 8, 3)
    args[4].requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        specmix_matrix(*args)
