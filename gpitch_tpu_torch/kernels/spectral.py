"""Spectral-mixture kernels: the pitch models.

Counterpart of gpitch_tpu/kernels/spectral.py.  The training bound
builds a cosine mixture as a feature matmul,

    sum_p e_p cos(2 pi f_p (x - x')) = phi(x)^T phi(x'),
    phi(x) = [sqrt(e_p) cos(2 pi f_p x); sqrt(e_p) sin(2 pi f_p x)],

which autograd differentiates (the JAX default path).  The prediction path,
which runs without gradients, builds the same covariances with the
spectral-mixture kernel (linalg/specmix.py) through ``K_fwd`` /
``K_terms_fwd``.  ``k_r`` evaluates each kernel on distances alone (the
lag-table route), with the mixture as ``cos_mixture_r``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..core.params import Param
from ..core.transforms import Logistic, Positive
from ..linalg.specmix import specmix_matrix
from .base import Kernel, absdist

__all__ = ["Matern12sm", "Matern32sm", "Matern32smOld", "Matern32sml",
           "MercerMatern12sm", "MercerCosMix", "Spectrum", "Spectrum2",
           "cosine_features", "cos_mixture", "cos_mixture_r"]

_SQRT3 = float(np.sqrt(3.0))


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


def cos_mixture_r(r, energy, frequency):
    """sum_p e_p cos(2 pi f_p r) on distances r (..., L), energy and
    frequency (..., P): the same values as ``cos_mixture``."""
    ang = 2.0 * math.pi * r[..., None] * frequency[..., None, :]
    return (energy[..., None, :] * torch.cos(ang)).sum(-1)


def _b2(p: torch.Tensor) -> torch.Tensor:
    """A (...) parameter against (..., N, M) covariances."""
    return p[..., None, None]


def _b1(p: torch.Tensor) -> torch.Tensor:
    """A (...) parameter against (..., L) distances."""
    return p[..., None]


def _fixed(p: Param, trainable: bool) -> Param:
    """``p`` with its trainable flag set (the raw leaf is shared)."""
    return Param(p.raw, p.transform, trainable)


def _full(X, value: torch.Tensor) -> torch.Tensor:
    """(..., N) filled with ``value`` (...)."""
    return value[..., None] * torch.ones(X.shape[:-1], dtype=X.dtype, device=X.device)


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

    def k_r(self, r):
        mix = cos_mixture_r(r, self.energy.value, self.frequency.value)
        return (_b1(self.variance.value)
                * torch.exp(-r / _b1(self.lengthscales.value)) * mix)

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


@dataclasses.dataclass
class Matern32sm(Kernel):
    """sum_p v_p (1 + sqrt(3) r / l) exp(-sqrt(3) r / l) cos(2 pi f_p r):
    one lengthscale in Logistic(0, len_bound), per-partial variances in
    Logistic(0, var_bound), positive frequencies."""

    lengthscales: Any = None
    variance: Any = None   # per-partial weights, (..., P)
    frequency: Any = None  # (..., P)

    @classmethod
    def create(cls, num_partials=None, lengthscales=None, variances=None,
               frequencies=None, len_bound=2.0, var_bound=0.25,
               train_vars=True, train_freqs=True, dtype=torch.float32):
        if lengthscales is None:
            lengthscales = 1.0
            variances = 0.125 * np.ones(num_partials)
            frequencies = 1.0 + np.arange(num_partials, dtype=float)
        return cls(
            lengthscales=Param.create(lengthscales, Logistic(0.0, len_bound), dtype=dtype),
            variance=Param.create(np.asarray(variances).reshape(-1),
                                  Logistic(0.0, var_bound), trainable=train_vars,
                                  dtype=dtype),
            frequency=Param.create(np.asarray(frequencies).reshape(-1), Positive(),
                                   trainable=train_freqs, dtype=dtype))

    @property
    def num_partials(self):
        return self.frequency.raw.shape[-1]

    def vars_n_freqs_fixed(self, fix_var=True, fix_freq=False):
        """A new kernel with the variances and frequencies fixed or freed."""
        return dataclasses.replace(self, variance=_fixed(self.variance, not fix_var),
                                   frequency=_fixed(self.frequency, not fix_freq))

    def K(self, X, X2=None):
        r1 = _SQRT3 * absdist(X, X2) / _b2(self.lengthscales.value)
        mix = cos_mixture(X, X2, self.variance.value, self.frequency.value)
        return (1.0 + r1) * torch.exp(-r1) * mix

    def Kdiag(self, X):
        return _full(X, self.variance.value.sum(-1))

    def k_r(self, r):
        r1 = _SQRT3 * r / _b1(self.lengthscales.value)
        mix = cos_mixture_r(r, self.variance.value, self.frequency.value)
        return (1.0 + r1) * torch.exp(-r1) * mix


@dataclasses.dataclass
class Matern32smOld(Matern32sm):
    """The legacy variant: lengthscale in Logistic(0, 10), variances fixed."""

    @classmethod
    def create(cls, num_partials=None, lengthscales=None, variances=None,
               frequencies=None, **kw):
        kw.setdefault("len_bound", 10.0)
        kw.setdefault("train_vars", False)
        return super().create(num_partials, lengthscales, variances, frequencies, **kw)


@dataclasses.dataclass
class Matern32sml(Kernel):
    """Per-partial lengthscales:
    sum_p v_p (1 + sqrt(3) r / l_p) exp(-sqrt(3) r / l_p) cos(2 pi f_p r),
    accumulated one partial at a time into one (..., N, M) buffer."""

    lengthscales: Any = None  # (..., P)
    variance: Any = None      # (..., P)
    frequency: Any = None     # (..., P)

    @classmethod
    def create(cls, num_partials=None, lengthscales=None, variances=None,
               frequencies=None, dtype=torch.float32):
        if lengthscales is None:
            lengthscales = np.ones(num_partials)
            variances = 0.125 * np.ones(num_partials)
            frequencies = 1.0 + np.arange(num_partials, dtype=float)
        return cls(
            lengthscales=Param.create(np.asarray(lengthscales).reshape(-1),
                                      Logistic(0.0, 2.0), dtype=dtype),
            variance=Param.create(np.asarray(variances).reshape(-1),
                                  Logistic(0.0, 1.0), dtype=dtype),
            frequency=Param.create(np.asarray(frequencies).reshape(-1), Positive(),
                                   dtype=dtype))

    @property
    def num_partials(self):
        return self.frequency.raw.shape[-1]

    def K(self, X, X2=None):
        r = absdist(X, X2)
        ls, vs, fs = self.lengthscales.value, self.variance.value, self.frequency.value
        acc = torch.zeros_like(r)
        for i in range(ls.shape[-1]):
            r1 = _SQRT3 * r / _b2(ls[..., i])
            acc = acc + (_b2(vs[..., i]) * (1.0 + r1) * torch.exp(-r1)
                         * torch.cos(2.0 * math.pi * _b2(fs[..., i]) * r))
        return acc

    def Kdiag(self, X):
        return _full(X, self.variance.value.sum(-1))

    def k_r(self, r):
        ls, vs, fs = (p.value[..., None, :] for p in
                      (self.lengthscales, self.variance, self.frequency))
        r1 = _SQRT3 * r[..., None] / ls                     # (..., L, P)
        cosr = torch.cos(2.0 * math.pi * fs * r[..., None])
        return (vs * (1.0 + r1) * torch.exp(-r1) * cosr).sum(-1)


@dataclasses.dataclass
class MercerCosMix(Kernel):
    """variance * sum_p e_p cos(2 pi f_p (x - x')), a finite-rank (Mercer)
    kernel; Kdiag is variance, exact when the energies sum to 1."""

    variance: Any = None
    energy: Any = None
    frequency: Any = None

    @classmethod
    def create(cls, energy=(1.0,), frequency=(2 * np.pi,), variance=1.0,
               features_as_params=False, dtype=torch.float32):
        return cls(
            variance=Param.create(variance, Logistic(0.0, 0.25), dtype=dtype),
            energy=Param.create(np.asarray(energy).reshape(-1), Positive(),
                                trainable=features_as_params, dtype=dtype),
            frequency=Param.create(np.asarray(frequency).reshape(-1), Positive(),
                                   trainable=features_as_params, dtype=dtype))

    @property
    def num_features(self):
        return self.frequency.raw.shape[-1]

    def K(self, X, X2=None):
        return _b2(self.variance.value) * cos_mixture(X, X2, self.energy.value,
                                                      self.frequency.value)

    def Kdiag(self, X):
        return _full(X, self.variance.value)

    def k_r(self, r):
        return _b1(self.variance.value) * cos_mixture_r(r, self.energy.value,
                                                        self.frequency.value)


@dataclasses.dataclass
class Spectrum(Kernel):
    """variance * sum_p e_p cos(2 pi f_p r) with fixed energies and
    frequencies."""

    variance: Any = None
    energy: Any = None
    frequency: Any = None

    @classmethod
    def create(cls, frequency=None, energy=None, variance=1.0, dtype=torch.float32):
        return cls(variance=Param.create(variance, Positive(), dtype=dtype),
                   energy=Param.create(np.asarray(energy).reshape(-1), Positive(),
                                       trainable=False, dtype=dtype),
                   frequency=Param.create(np.asarray(frequency).reshape(-1),
                                          Positive(), trainable=False, dtype=dtype))

    def K(self, X, X2=None):
        return _b2(self.variance.value) * cos_mixture(X, X2, self.energy.value,
                                                      self.frequency.value)

    def Kdiag(self, X):
        return _full(X, self.variance.value)

    def k_r(self, r):
        return _b1(self.variance.value) * cos_mixture_r(r, self.energy.value,
                                                        self.frequency.value)


@dataclasses.dataclass
class Spectrum2(Spectrum):
    """The reference's squared-distance variant; the same covariance."""
