"""Finite-rank and learned kernels.

Counterpart of gpitch_tpu/kernels/feature.py: Sig, Hann and Env are
feature outer products K = phi(X) phi(X2)^T; NonParam is a free PSD matrix
variance * L L^T; MeanGP interpolates sampled kernel values by an RBF GP;
KernelGPR is the posterior mean of a trained GP regression at the pairwise
distances.  Host-built and unbatched, as the JAX package uses them; the
factorizations go through torch.linalg, as JAX's through jnp.linalg.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..core.params import Param, static_field
from ..core.transforms import FillTriangular, Positive
from ..linalg.ops import safe_cholesky, solve_lower
from .base import Kernel, absdist
from .stationary import RBF

__all__ = ["Sig", "Hann", "Env", "NonParam", "MeanGP", "KernelGPR"]


class _Features(Kernel):
    """K = phi(X) phi(X2)^T, Kdiag = |phi(X)|^2 by rows."""

    def _phi(self, X):
        raise NotImplementedError

    def K(self, X, X2=None):
        phi = self._phi(X)
        phi2 = phi if X2 is None else self._phi(X2)
        return phi @ phi2.mT

    def Kdiag(self, X):
        return self._phi(X).square().sum(-1)


@dataclasses.dataclass
class Sig(_Features):
    """Sigmoid features sig(a X + b)."""

    a: Any = None
    b: Any = None

    @classmethod
    def create(cls, a=1.0, b=1.0, dtype=torch.float32):
        return cls(a=Param.create(a, dtype=dtype), b=Param.create(b, dtype=dtype))

    def _phi(self, X):
        return 1.0 / (1.0 + torch.exp(-(X * self.a.value + self.b.value)))


@dataclasses.dataclass
class Hann(_Features):
    """Hann-window features of a window of ``n`` samples at ``fs``."""

    n: int = static_field(1025)
    fs: float = static_field(16000.0)

    def _phi(self, X):
        return 0.5 * (1.0 - torch.cos(2.0 * math.pi * X * self.fs / (self.n - 1.0)))


@dataclasses.dataclass
class Env(_Features):
    """Envelope features softplus(g(X)), g the posterior mean of an RBF GP
    through the inducing values u at z (Cholesky with 0.001 I)."""

    kernel: Any = None     # the inner RBF
    z: Any = None          # (M, 1)
    u: Any = None          # (M, 1)

    @classmethod
    def create(cls, z, u=None, lengthscales=0.5, variance=1.0, dtype=torch.float32):
        z = np.asarray(z).reshape(-1, 1)
        if u is None:
            u = np.zeros((z.shape[0], 1))
        return cls(kernel=RBF.create(variance=variance, lengthscales=lengthscales,
                                     dtype=dtype),
                   z=Param.create(z, dtype=dtype), u=Param.create(u, dtype=dtype))

    def _phi(self, X):
        z = self.z.value
        L = safe_cholesky(self.kernel.K(z), 0.001)
        A = solve_lower(L, self.kernel.K(z, X))
        V = solve_lower(L, self.u.value)
        g = A.mT @ V
        return torch.logaddexp(g, torch.zeros_like(g))


@dataclasses.dataclass
class NonParam(Kernel):
    """variance * L L^T with a free lower-triangular L; ignores X (the Gram
    is num_samples x num_samples)."""

    variance: Any = None
    L: Any = None
    num_samples: int = static_field(1)

    @classmethod
    def create(cls, num_samples, variance=1.0, dtype=torch.float32):
        return cls(variance=Param.create(variance, Positive(), dtype=dtype),
                   L=Param.create(np.eye(num_samples), FillTriangular(num_samples),
                                  dtype=dtype),
                   num_samples=num_samples)

    def K(self, X=None, X2=None):
        L = self.L.value
        return self.variance.value * (L @ L.mT)

    def Kdiag(self, X):
        return self.variance.value * torch.ones(X.shape[:-1], dtype=X.dtype,
                                                device=X.device)


@dataclasses.dataclass
class MeanGP(Kernel):
    """variance times the RBF-GP interpolation of sampled kernel values
    fkern at distances xkern, evaluated at |x - x'|."""

    variance: Any = None
    kern: Any = None       # the inner RBF over distances
    xkern: Any = None      # (Mk, 1), fixed
    fkern: Any = None      # (Mk, 1), fixed

    @classmethod
    def create(cls, xkern, fkern, variance=1.0, plen=1.0, pvar=1.0,
               dtype=torch.float32):
        def fixed(v):
            return Param.create(np.asarray(v).reshape(-1, 1), trainable=False, dtype=dtype)

        return cls(variance=Param.create(variance, Positive(), dtype=dtype),
                   kern=RBF.create(variance=pvar, lengthscales=plen, dtype=dtype),
                   xkern=fixed(xkern), fkern=fixed(fkern))

    def _interp(self, r_flat):
        xk = self.xkern.value
        L = safe_cholesky(self.kern.K(xk))
        alpha = solve_lower(L, self.fkern.value)
        A = solve_lower(L, self.kern.K(xk, r_flat))
        return A.mT @ alpha

    def K(self, X, X2=None):
        r = absdist(X, X2)
        vals = self._interp(r.reshape(-1, 1))
        return self.variance.value * vals.reshape(r.shape)

    def Kdiag(self, X):
        k0 = self._interp(torch.zeros((1, 1), dtype=X.dtype, device=X.device))[0, 0]
        return self.variance.value * k0 * torch.ones(X.shape[:-1], dtype=X.dtype,
                                                     device=X.device)


@dataclasses.dataclass
class KernelGPR(Kernel):
    """variance times the posterior mean of ``gpm`` (any model with
    ``predict_f(Xnew) -> (mean, var)``, e.g. models.GPR) at |x - x'|."""

    variance: Any = None
    gpm: Any = None

    @classmethod
    def create(cls, gpm, variance=1.0, dtype=torch.float32):
        return cls(variance=Param.create(variance, Positive(), dtype=dtype), gpm=gpm)

    def K(self, X, X2=None):
        r = absdist(X, X2)
        mean, _ = self.gpm.predict_f(r.reshape(-1, 1))
        return self.variance.value * mean.reshape(r.shape)

    def Kdiag(self, X):
        mean, _ = self.gpm.predict_f(torch.zeros((1, 1), dtype=X.dtype, device=X.device))
        return self.variance.value * mean[0, 0] * torch.ones(X.shape[:-1], dtype=X.dtype,
                                                             device=X.device)
