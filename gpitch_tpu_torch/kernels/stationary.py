"""Stationary kernels.

Counterpart of gpitch_tpu/kernels/stationary.py: RBF, Matern12, Matern32
(the activation kernel of ModGP), Matern52, Cosine, Gammaexponential and
LogisticHat.  As in kernels/base.py, Params may carry leading batch axes (a
stacked bank of S kernels has (S,) leaves) that broadcast against the
leading axes of X (..., N, 1):

    K(X, X2=None) -> (..., N, M)        Kdiag(X) -> (..., N)

and ``k_r(r)`` takes distances r (..., L) (see kernels/base.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..core.params import Param
from ..core.transforms import Logistic, Positive
from .base import Kernel, absdist

__all__ = ["RBF", "Matern12", "Matern32", "Matern52", "Cosine",
           "Gammaexponential", "LogisticHat", "Stationary"]


def _bcast(p: torch.Tensor) -> torch.Tensor:
    """A (...) parameter against (..., N, M) distances."""
    return p[..., None, None]


def _on_distances(fn, r: torch.Tensor) -> torch.Tensor:
    """``fn``, written for (..., N, M) distances, at distances r (..., L)."""
    return fn(r[..., None])[..., 0]


@dataclasses.dataclass
class Stationary(Kernel):
    """Positive variance and lengthscales; k(x, x') = variance *
    f(|x - x'| / lengthscales), with f given by ``_k_scaled``."""

    variance: Any = None
    lengthscales: Any = None

    @classmethod
    def create(cls, variance=1.0, lengthscales=1.0, dtype=torch.float32):
        return cls(variance=Param.create(variance, Positive(), dtype=dtype),
                   lengthscales=Param.create(lengthscales, Positive(), dtype=dtype))

    def _r(self, X, X2=None):
        ls = _bcast(self.lengthscales.value)
        return absdist(X / ls, None if X2 is None else X2 / ls)

    def K(self, X, X2=None):
        return self._k_scaled(self._r(X, X2))

    def Kdiag(self, X):
        return self.variance.value[..., None] * torch.ones(
            X.shape[:-1], dtype=X.dtype, device=X.device)

    def k_r(self, r):
        return _on_distances(lambda d: self._k_scaled(
            d / _bcast(self.lengthscales.value)), r)

    def _k_scaled(self, r):
        raise NotImplementedError


@dataclasses.dataclass
class RBF(Stationary):
    def _k_scaled(self, r):
        return _bcast(self.variance.value) * torch.exp(-0.5 * r * r)


@dataclasses.dataclass
class Matern12(Stationary):
    def _k_scaled(self, r):
        return _bcast(self.variance.value) * torch.exp(-r)


@dataclasses.dataclass
class Matern32(Stationary):
    """The activation kernel of ModGP."""

    def _k_scaled(self, r):
        r = math.sqrt(3.0) * r
        return _bcast(self.variance.value) * (1.0 + r) * torch.exp(-r)


@dataclasses.dataclass
class Matern52(Stationary):
    def _k_scaled(self, r):
        r = math.sqrt(5.0) * r
        return _bcast(self.variance.value) * (1.0 + r + r * r / 3.0) * torch.exp(-r)


@dataclasses.dataclass
class Cosine(Kernel):
    """variance * cos(2 pi frequency |x - x'|)."""

    variance: Any = None
    frequency: Any = None

    @classmethod
    def create(cls, variance=1.0, frequency=1.0, dtype=torch.float32):
        return cls(variance=Param.create(variance, Positive(), dtype=dtype),
                   frequency=Param.create(frequency, Positive(), dtype=dtype))

    def K(self, X, X2=None):
        return self._cos(absdist(X, X2))

    def Kdiag(self, X):
        return self.variance.value[..., None] * torch.ones(
            X.shape[:-1], dtype=X.dtype, device=X.device)

    def k_r(self, r):
        return _on_distances(self._cos, r)

    def _cos(self, r):
        return _bcast(self.variance.value) * torch.cos(
            2.0 * math.pi * _bcast(self.frequency.value) * r)


@dataclasses.dataclass
class Gammaexponential(Stationary):
    """variance * exp(-r^gamma), gamma in (1e-5, 2)."""

    gamma: Any = None

    @classmethod
    def create(cls, variance=1.0, lengthscales=1.0, gamma=1.0, dtype=torch.float32):
        return cls(variance=Param.create(variance, Positive(), dtype=dtype),
                   lengthscales=Param.create(lengthscales, Positive(), dtype=dtype),
                   gamma=Param.create(gamma, Logistic(1e-5, 2.0), dtype=dtype))

    def _k_scaled(self, r):
        return _bcast(self.variance.value) * torch.exp(
            -torch.pow(r + 1e-12, _bcast(self.gamma.value)))


@dataclasses.dataclass
class LogisticHat(Stationary):
    """A difference of two steep logistics of the distance (a 'hat')."""

    def _k_scaled(self, r):
        f1 = 1.0 / (1.0 + torch.exp(100.0 * (-1.0 - r)))
        f2 = 1.0 / (1.0 + torch.exp(100.0 * (1.0 - r)))
        return _bcast(self.variance.value) * (f1 - f2)
