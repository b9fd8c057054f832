"""Spectral-mixture covariance build: CUDA kernel and its plain version.

Replaces gpitch_tpu/linalg/pallas/specmix.py::specmix_matrix, batched over
matrices and sources:

    K[b,s,i,j] = var[b,s] * env(|x[b,i] - x2[b,j]| / l[b,s])
                 * sum_p e[b,s,p] cos(2 pi f[b,s,p] (x[b,i] - x2[b,j]))

env(r) = exp(-r), or (1 + r) exp(-r) with ``m32``; ``sum_sources`` returns
sum_s K[b,s].  ``m32`` mirrors the TPU kernel's option: no covariance of
the port (Matern12sm) passes it yet.  Forward only: the training bound builds its covariances with
the differentiable feature matmul (kernels/spectral.py), and this wrapper
refuses inputs that would need a gradient.

The kernel (``gpitch_tpu_torch/csrc/specmix.cu``) and ``specmix_plain`` both
take the feature form sum_p phi_p(x) . phi_p(x2), phi_p(x) = sqrt(e_p)
(cos, sin)(2 pi f_p x), with each angle formed and reduced mod 2 pi in f64
before it is rounded to the working type: in f32 the direct cos(2 pi f
(x - x2)) loses ~1e-4 of max|K| to the rounding of arguments ~1e3 rad.
"""

from __future__ import annotations

import torch

from . import _cuda

__all__ = ["specmix_matrix", "specmix_plain"]

_TWO_PI = 6.283185307179586


def _check(x, x2, energy, frequency, variance, lengthscale):
    b, n = x.shape
    s, p = energy.shape[1:]
    m = x2.shape[1]
    shapes = {"x2": (x2, (b, m)), "energy": (energy, (b, s, p)),
              "frequency": (frequency, (b, s, p)),
              "variance": (variance, (b, s)), "lengthscale": (lengthscale, (b, s))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {want}")
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"{name}: {t.dtype} on {t.device}, expected "
                            f"{x.dtype} on {x.device}")
    return b, s, n, m, p


def _features(t, energy, frequency):
    """(B, S, 2P, len) features sqrt(e_p) (cos, sin)(2 pi f_p t) of the points
    t (B, len): the angle in f64, reduced mod 2 pi in f64, then rounded to
    the working type, where cos and sin are taken."""
    ang = ((_TWO_PI * frequency.double())[..., None]
           * t.double()[:, None, None, :])                   # (B, S, P, len)
    ang = (ang - _TWO_PI * torch.round(ang / _TWO_PI)).to(t.dtype)
    root = torch.sqrt(energy)[..., None]
    return torch.cat([root * torch.cos(ang), root * torch.sin(ang)], -2)


def specmix_plain(x, x2, energy, frequency, variance, lengthscale,
                  m32: bool = False, sum_sources: bool = False):
    """The kernel's algorithm in torch: features of every point, their
    products summed over the partials, times the envelope.  Shapes as in
    ``specmix_matrix``."""
    mix = _features(x, energy, frequency).mT @ _features(x2, energy, frequency)
    d = x[:, None, :, None] - x2[:, None, None, :]           # (B, 1, N, M)
    r1 = d.abs() * (1.0 / lengthscale)[:, :, None, None]     # (B, S, N, M)
    env = torch.exp(-r1)
    if m32:
        env = (1.0 + r1) * env
    K = variance[:, :, None, None] * env * mix
    return K.sum(1) if sum_sources else K


@_cuda.counted
def specmix_matrix(x, x2, energy, frequency, variance, lengthscale,
                   m32: bool = False, sum_sources: bool = False):
    """K (B, S, N, M), or (B, N, M) with ``sum_sources``.

    x: (B, N); x2: (B, M); energy, frequency: (B, S, P); variance,
    lengthscale: (B, S).  A CUDA tensor goes to the kernel, a CPU tensor to
    ``specmix_plain``.  Raises if grad mode is on and an input requires
    grad: the build has no backward.
    """
    inputs = (x, x2, energy, frequency, variance, lengthscale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError("specmix_matrix is forward only: call it under "
                           "torch.no_grad() or on detached inputs")
    b, s, n, m, p = _check(*inputs)
    if x.device.type == "cpu":
        return specmix_plain(*inputs, m32=m32, sum_sources=sum_sources)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {x.dtype}")
    inputs = [t.contiguous() for t in inputs]
    out = torch.empty((b, n, m) if sum_sources else (b, s, n, m),
                      dtype=x.dtype, device=x.device)
    lib = _cuda.load("specmix")
    feat = torch.empty((b, s, lib.gpitch_specmix_workspace(n, m, p)), dtype=x.dtype,
                       device=x.device)
    fn = (lib.gpitch_specmix_f32 if x.dtype == torch.float32
          else lib.gpitch_specmix_f64)
    with torch.cuda.device(x.device):
        rc = fn(*(t.data_ptr() for t in inputs), feat.data_ptr(), out.data_ptr(),
                b, s, n, m, p,
                int(m32), int(sum_sources),
                torch.cuda.current_stream(x.device).cuda_stream)
    _cuda.check(rc, "specmix_matrix")
    specmix_matrix.launches += 1
    return out
