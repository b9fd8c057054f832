"""Kernel protocol and combination kernels.

Counterpart of gpitch_tpu/kernels/base.py.  Inputs X are (..., N, 1) time
vectors; Params may carry leading batch axes (windows, and for a stacked
kernel the term axis after them), and the leading axes of X and of the
Params broadcast against each other:

    K(X, X2=None) -> (..., N, M)        Kdiag(X) -> (..., N)

Stationary kernels also give ``k_r(r)``, the value at distance r alone,
r (..., L) with its leading axes broadcast against the Params' batch axes
(a kernel without batch axes takes r of any shape): the lag-table route of
models/sgpr.py builds one table per window from it.

A ``StackedSum`` holds S homogeneous kernels as one module whose Params have
a term axis, so every covariance of the S terms is one batched op (the JAX
package vmaps over the same axis).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from ..core.params import Param, map_named_params, named_params, static_field
from ..core.transforms import Positive

__all__ = ["Kernel", "Sum", "StackedSum", "Product", "White", "Constant",
           "absdist", "sqdist", "euclid_dist", "stack_modules", "unstack_modules"]


def sqdist(X: torch.Tensor, X2: torch.Tensor | None = None) -> torch.Tensor:
    """Pairwise squared euclidean distance, (..., N, M), clamped at 0."""
    if X2 is None:
        X2 = X
    xs = X.square().sum(-1)
    x2s = X2.square().sum(-1)
    d2 = xs[..., :, None] + x2s[..., None, :] - 2.0 * (X @ X2.mT)
    return torch.clamp(d2, min=0.0)


def euclid_dist(X: torch.Tensor, X2: torch.Tensor | None = None,
                eps: float = 1e-12) -> torch.Tensor:
    """sqrt(sqdist + eps): the reference's guarded square root."""
    return torch.sqrt(sqdist(X, X2) + eps)


def absdist(X: torch.Tensor, X2: torch.Tensor | None = None) -> torch.Tensor:
    """Exact |x - x2'| for 1-D inputs, (..., N, M)."""
    if X2 is None:
        X2 = X
    return (X[..., :, None, :] - X2[..., None, :, :]).abs().sum(-1)


class Kernel:
    """Protocol: K and Kdiag (differentiable); K_fwd, the same covariance
    for the prediction path (run under torch.no_grad; K itself unless a
    kernel has a forward-only build); k_r for stationary kernels.  ``+``
    and ``*`` build a Sum and a Product."""

    def K(self, X, X2=None):
        raise NotImplementedError

    def Kdiag(self, X):
        raise NotImplementedError

    def K_fwd(self, X, X2=None):
        return self.K(X, X2)

    def k_r(self, r):
        """k at distances r (..., L); only stationary kernels have it."""
        raise NotImplementedError(f"{type(self).__name__} is not stationary")

    def __add__(self, other):
        return Sum(kern_list=_flatten_combination(self, other, Sum))

    def __radd__(self, other):
        if isinstance(other, (int, float)) and other == 0:  # sum() of kernels
            return self
        return Sum(kern_list=_flatten_combination(other, self, Sum))

    def __mul__(self, other):
        return Product(kern_list=_flatten_combination(self, other, Product))


def _flatten_combination(a, b, cls):
    parts = []
    for k in (a, b):
        parts.extend(k.kern_list if isinstance(k, cls) else (k,))
    return tuple(parts)


@dataclasses.dataclass
class Sum(Kernel):
    """Sum over a list of kernels; exposes ``kern_list``."""

    kern_list: tuple = ()

    def K(self, X, X2=None):
        return sum(k.K(X, X2) for k in self.kern_list)

    def Kdiag(self, X):
        return sum(k.Kdiag(X) for k in self.kern_list)

    def K_fwd(self, X, X2=None):
        return sum(k.K_fwd(X, X2) for k in self.kern_list)

    def k_r(self, r):
        return sum(k.k_r(r) for k in self.kern_list)


@dataclasses.dataclass
class StackedSum(Kernel):
    """Sum of S same-family kernels whose Params are stacked on a term axis
    (``stacked``'s Params are (..., S) for scalars, (..., S, P) for vectors).
    """

    stacked: Any = None
    num_terms: int = static_field(0)

    @classmethod
    def create(cls, kern_list):
        kern_list = list(kern_list)
        return cls(stacked=stack_modules(kern_list), num_terms=len(kern_list))

    def K(self, X, X2=None):
        return self.K_terms(X, X2).sum(-3)

    def Kdiag(self, X):
        return self.Kdiag_terms(X).sum(-2)

    def K_terms(self, X, X2=None):
        """(..., S, N, M) covariance of every term."""
        return self.stacked.K(X[..., None, :, :],
                              None if X2 is None else X2[..., None, :, :])

    def Kdiag_terms(self, X):
        """(..., S, N) diagonals of every term."""
        return self.stacked.Kdiag(X[..., None, :, :])

    def K_fwd(self, X, X2=None):
        """Summed covariance through the stacked kernel's forward-only
        batched build (one launch for all terms), where it has one."""
        if not hasattr(self.stacked, "K_terms_fwd"):
            return self.K(X, X2)
        return self.stacked.K_terms_fwd(X, X2, sum_terms=True)

    def K_terms_fwd(self, X, X2=None, terms: slice = slice(None)):
        """(..., S', N, M) per-term covariances of ``terms``, forward only."""
        if not hasattr(self.stacked, "K_terms_fwd"):
            return self.K_terms(X, X2)[..., terms, :, :]
        return self.stacked.K_terms_fwd(X, X2, terms=terms)

    def k_r(self, r):
        """The summed stationary evaluation, (..., L): the S per-pitch
        tables fold into one before any gather."""
        return self.k_r_terms(r).sum(-2)

    def k_r_terms(self, r):
        """(..., S, L) per-term evaluations at r (..., L)."""
        return self.stacked.k_r(r[..., None, :])

    @property
    def kern_list(self):
        """The S terms as separate kernels (their raw leaves are copies)."""
        return tuple(unstack_modules(self.stacked, self.num_terms))


@dataclasses.dataclass
class Product(Kernel):
    """Elementwise product of a list of kernels."""

    kern_list: tuple = ()

    @staticmethod
    def _prod(parts):
        parts = list(parts)
        out = parts[0]
        for p in parts[1:]:
            out = out * p
        return out

    def K(self, X, X2=None):
        return self._prod(k.K(X, X2) for k in self.kern_list)

    def Kdiag(self, X):
        return self._prod(k.Kdiag(X) for k in self.kern_list)

    def k_r(self, r):
        return self._prod(k.k_r(r) for k in self.kern_list)


def _filled(X: torch.Tensor, m: int, value: torch.Tensor) -> torch.Tensor:
    """(..., N, m) filled with ``value`` (...)."""
    return value[..., None, None] * torch.ones(X.shape[:-1] + (m,), dtype=X.dtype,
                                               device=X.device)


@dataclasses.dataclass
class White(Kernel):
    """White noise: variance * I on K(X), zero between two sets of inputs."""

    variance: Any = None

    @classmethod
    def create(cls, variance=1.0, dtype=torch.float32):
        return cls(variance=Param.create(variance, Positive(), dtype=dtype))

    def K(self, X, X2=None):
        if X2 is None:
            eye = torch.eye(X.shape[-2], dtype=X.dtype, device=X.device)
            return self.variance.value[..., None, None] * eye
        return torch.zeros(X.shape[:-1] + (X2.shape[-2],), dtype=X.dtype,
                           device=X.device)

    def Kdiag(self, X):
        return _filled(X, 1, self.variance.value)[..., 0]


@dataclasses.dataclass
class Constant(Kernel):
    """variance everywhere."""

    variance: Any = None

    @classmethod
    def create(cls, variance=1.0, dtype=torch.float32):
        return cls(variance=Param.create(variance, Positive(), dtype=dtype))

    def K(self, X, X2=None):
        return _filled(X, (X if X2 is None else X2).shape[-2], self.variance.value)

    def Kdiag(self, X):
        return _filled(X, 1, self.variance.value)[..., 0]


def stack_modules(mods: Sequence[Any]):
    """Stack homogeneous modules into one whose Params gain a leading term
    axis (host build: the raw leaves are stacked on the CPU)."""
    paths = [[(name, tuple(p.raw.shape), p.transform, p.trainable)
              for name, p in named_params(m)] for m in mods]
    if any(type(m) is not type(mods[0]) for m in mods) or any(
            p != paths[0] for p in paths):
        raise ValueError("stack_modules requires homogeneous modules")
    flat = [dict(named_params(m)) for m in mods]
    return map_named_params(mods[0], lambda name, p: Param(
        torch.as_tensor(np.stack([f[name].raw.detach().cpu().numpy()
                                  for f in flat])), p.transform, p.trainable))


def unstack_modules(stacked, n: int):
    """Inverse of ``stack_modules``: the n modules along the leading term
    axis, each with copies of its raw leaves."""
    return [map_named_params(stacked, lambda _, p, i=i: Param(
        p.raw.detach()[i].clone(), p.transform, p.trainable)) for i in range(n)]
