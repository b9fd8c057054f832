"""Bijective parameter transforms (unconstrained <-> constrained).

Counterpart of gpitch_tpu/core/transforms.py.  ``forward`` runs in torch on
the raw leaf (it is differentiated); ``inverse`` runs in numpy on the host,
where models are built, in the dtype of the value it is given.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["Transform", "Identity", "Positive", "Logistic", "FillTriangular"]

_SOFTPLUS_CLIP = 30.0


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # numerically stable log(1 + e^x), the same branch as the JAX package
    return torch.where(x > _SOFTPLUS_CLIP, x,
                       torch.log1p(torch.exp(torch.clamp(x, max=_SOFTPLUS_CLIP))))


def _softplus_inv(y: np.ndarray) -> np.ndarray:
    # log(e^y - 1), stable for large y
    return np.where(y > _SOFTPLUS_CLIP, y, np.log(-np.expm1(-y)) + y)


@dataclasses.dataclass(frozen=True)
class Transform:
    """forward: unconstrained -> constrained; inverse: constrained -> unconstrained."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def inverse(self, y: np.ndarray) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Identity(Transform):
    def forward(self, x):
        return x

    def inverse(self, y):
        return y


@dataclasses.dataclass(frozen=True)
class Positive(Transform):
    """Softplus with a small floor (keeps variances off exact zero in f32)."""

    lower: float = 1e-6

    def forward(self, x):
        return _softplus(x) + self.lower

    def inverse(self, y):
        y = np.asarray(y)
        return _softplus_inv(np.maximum(y - self.lower, 1e-20).astype(y.dtype))


@dataclasses.dataclass(frozen=True)
class Logistic(Transform):
    """y = a + (b - a) * sigmoid(x), with the sigmoid computed via tanh."""

    a: float = 0.0
    b: float = 1.0

    def forward(self, x):
        return self.a + (self.b - self.a) * 0.5 * (torch.tanh(0.5 * x) + 1.0)

    def inverse(self, y):
        y = np.asarray(y)
        t = (y - self.a) / (self.b - self.a)
        t = np.clip(t, 1e-12, 1.0 - 1e-12)
        return np.log(t) - np.log1p(-t)


@dataclasses.dataclass(frozen=True)
class FillTriangular(Transform):
    """A packed vector of n (n + 1) / 2 entries (..., n(n+1)/2) <-> a lower
    triangular matrix (..., n, n), in the JAX package's layout.  forward is
    the fill_triangular construction: concat([x[n:], flip(x)]) reshaped to
    (n, n) holds every packed entry exactly once in its lower triangle, so
    it is a concatenation, a flip, a reshape and a mask, with no scatter.
    inverse reads the lower triangle back through the same static index
    map."""

    n: int = 1

    def forward(self, x):
        xc = torch.cat([x[..., self.n:], torch.flip(x, dims=(-1,))], dim=-1)
        return torch.tril(xc.reshape(x.shape[:-1] + (self.n, self.n)))

    def inverse(self, y):
        n = self.n
        k = np.arange(n * (n + 1) // 2)
        slots = np.concatenate([k[n:], k[::-1]]).reshape(n, n)
        ii, jj = np.tril_indices(n)
        order = np.argsort(slots[ii, jj])
        return np.asarray(y)[..., ii[order], jj[order]]
