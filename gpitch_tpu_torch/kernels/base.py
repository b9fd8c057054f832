"""Kernel protocol and combination kernels.

Counterpart of gpitch_tpu/kernels/base.py.  Inputs X are (..., N, 1) time
vectors; Params may carry leading batch axes (windows, and for a stacked
kernel the term axis after them), and the leading axes of X and of the
Params broadcast against each other:

    K(X, X2=None) -> (..., N, M)        Kdiag(X) -> (..., N)

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

__all__ = ["Kernel", "Sum", "StackedSum", "absdist", "stack_modules"]


def absdist(X: torch.Tensor, X2: torch.Tensor | None = None) -> torch.Tensor:
    """Exact |x - x2'| for 1-D inputs, (..., N, M)."""
    if X2 is None:
        X2 = X
    return (X[..., :, None, :] - X2[..., None, :, :]).abs().sum(-1)


class Kernel:
    """Protocol: K and Kdiag (differentiable), and K_fwd, the same
    covariance built forward only for the prediction path (run under
    torch.no_grad)."""

    def K(self, X, X2=None):
        raise NotImplementedError

    def Kdiag(self, X):
        raise NotImplementedError

    def K_fwd(self, X, X2=None):
        raise NotImplementedError


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
        batched build (one launch for all terms)."""
        return self.stacked.K_terms_fwd(X, X2, sum_terms=True)

    def K_terms_fwd(self, X, X2=None, terms: slice = slice(None)):
        """(..., S', N, M) per-term covariances of ``terms``, forward only."""
        return self.stacked.K_terms_fwd(X, X2, terms=terms)


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
