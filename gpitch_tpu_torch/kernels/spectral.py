"""Spectral-mixture kernels: the pitch models.

Counterpart of gpitch_tpu/kernels/spectral.py:48-137.  The training bound
builds a cosine mixture as a feature matmul,

    sum_p e_p cos(2 pi f_p (x - x')) = phi(x)^T phi(x'),
    phi(x) = [sqrt(e_p) cos(2 pi f_p x); sqrt(e_p) sin(2 pi f_p x)],

which autograd differentiates (the JAX default path).  The prediction path,
which runs without gradients, builds the same covariances with the
spectral-mixture kernel (linalg/specmix.py) through ``K_fwd`` /
``K_terms_fwd``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..core.params import Param
from ..core.transforms import Positive
from ..linalg.specmix import specmix_matrix
from .base import Kernel, absdist

__all__ = ["Matern12sm", "MercerMatern12sm", "cosine_features", "cos_mixture"]


def cosine_features(X, energy, frequency):
    """phi(X): (..., N, 2P) cos/sin features with sqrt-energy scaling."""
    ang = 2.0 * math.pi * X * frequency[..., None, :]
    w = torch.sqrt(energy)[..., None, :]
    return torch.cat([w * torch.cos(ang), w * torch.sin(ang)], dim=-1)


def cos_mixture(X, X2, energy, frequency):
    """sum_p e_p cos(2 pi f_p (x - x')) as a feature matmul, (..., N, M)."""
    phi = cosine_features(X, energy, frequency)
    phi2 = phi if X2 is None else cosine_features(X2, energy, frequency)
    return phi @ phi2.mT


def _specmix_build(X, X2, variance, lengthscale, energy, frequency,
                   sum_terms: bool):
    """Flatten the leading axes into the kernel's batch axis and launch one
    build.  variance, lengthscale: (..., S); energy, frequency: (..., S, P).
    The leading shape is broadcast by numpy: torch.broadcast_shapes imports
    sympy on its first call, a one-time cost of seconds."""
    X2 = X if X2 is None else X2
    lead = np.broadcast_shapes(X.shape[:-2], X2.shape[:-2], variance.shape[:-1],
                               energy.shape[:-2])
    n, m = X.shape[-2], X2.shape[-2]
    s, p = energy.shape[-2:]

    def flat(t, tail):
        return t.expand(lead + tail).reshape((-1,) + tail)

    out = specmix_matrix(flat(X[..., 0], (n,)), flat(X2[..., 0], (m,)),
                         flat(energy, (s, p)), flat(frequency, (s, p)),
                         flat(variance, (s,)), flat(lengthscale, (s,)),
                         sum_sources=sum_terms)
    return out.reshape(lead + out.shape[1:])


@dataclasses.dataclass
class Matern12sm(Kernel):
    """variance * exp(-r / l) * sum_p e_p cos(2 pi f_p r)."""

    variance: Any = None
    lengthscales: Any = None
    energy: Any = None
    frequency: Any = None

    @classmethod
    def create(cls, variance=1.0, lengthscales=1.0, energy=(1.0,),
               frequency=(1.0,), train_energy=False, train_frequency=False,
               len_fixed=False, dtype=torch.float32):
        return cls(
            variance=Param.create(variance, Positive(), dtype=dtype),
            lengthscales=Param.create(lengthscales, Positive(),
                                      trainable=not len_fixed, dtype=dtype),
            energy=Param.create(np.asarray(energy).reshape(-1), Positive(),
                                trainable=train_energy, dtype=dtype),
            frequency=Param.create(np.asarray(frequency).reshape(-1), Positive(),
                                   trainable=train_frequency, dtype=dtype),
        )

    @property
    def num_partials(self):
        return self.energy.raw.shape[-1]

    def K(self, X, X2=None):
        r = absdist(X, X2)
        mix = cos_mixture(X, X2, self.energy.value, self.frequency.value)
        return (self.variance.value[..., None, None]
                * torch.exp(-r / self.lengthscales.value[..., None, None]) * mix)

    def Kdiag(self, X):
        v = self.variance.value * self.energy.value.sum(-1)
        return v[..., None] * torch.ones(X.shape[:-1], dtype=X.dtype,
                                         device=X.device)

    def K_fwd(self, X, X2=None):
        return _specmix_build(X, X2, self.variance.value[..., None],
                              self.lengthscales.value[..., None],
                              self.energy.value[..., None, :],
                              self.frequency.value[..., None, :], sum_terms=True)

    def K_terms_fwd(self, X, X2=None, terms: slice = slice(None),
                    sum_terms: bool = False):
        """For a stacked module (Params with a term axis): the covariances of
        ``terms``, (..., S', N, M), or their sum with ``sum_terms``."""
        return _specmix_build(X, X2, self.variance.value[..., terms],
                              self.lengthscales.value[..., terms],
                              self.energy.value[..., terms, :],
                              self.frequency.value[..., terms, :], sum_terms)


@dataclasses.dataclass
class MercerMatern12sm(Matern12sm):
    """The separation component kernel: same covariance as Matern12sm, with
    energies and frequencies trainable by default."""

    @classmethod
    def create(cls, variance=1.0, lengthscales=1.0, energy=(1.0,),
               frequency=(1.0,), train_energy=True, train_frequency=True,
               len_fixed=False, dtype=torch.float32):
        return super().create(variance, lengthscales, energy, frequency,
                              train_energy, train_frequency, len_fixed, dtype)
