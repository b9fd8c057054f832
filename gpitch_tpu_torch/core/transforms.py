"""Bijective parameter transforms (unconstrained <-> constrained).

Counterpart of gpitch_tpu/core/transforms.py.  ``forward`` runs in torch on
the raw leaf (it is differentiated); ``inverse`` runs in numpy on the host,
where models are built, in the dtype of the value it is given.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

__all__ = ["Transform", "Identity", "Positive", "Logistic", "FillTriangular", "positive",
           "identity"]

_SOFTPLUS_CLIP = 30.0


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # numerically stable log(1 + e^x), the same branch as the JAX package
    return torch.where(x > _SOFTPLUS_CLIP, x,
                       torch.log1p(torch.exp(torch.clamp(x, max=_SOFTPLUS_CLIP))))


def _softplus_inv(y: np.ndarray) -> np.ndarray:
    # log(e^y - 1), stable for large y
    return np.where(y > _SOFTPLUS_CLIP, y, np.log(-np.expm1(-y)) + y)


def _softplus_inv_tensor(y: torch.Tensor) -> torch.Tensor:
    return torch.where(y > _SOFTPLUS_CLIP, y, torch.log(-torch.expm1(-y)) + y)


@dataclasses.dataclass(frozen=True)
class Transform:
    """forward: unconstrained -> constrained; inverse: constrained -> unconstrained."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def inverse(self, y: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def inverse_tensor(self, y: torch.Tensor) -> torch.Tensor:
        """``inverse`` in torch, differentiable, where a model's value is
        computed on the device (the natural-gradient step)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Identity(Transform):
    def forward(self, x):
        return x

    def inverse(self, y):
        return y

    def inverse_tensor(self, y):
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

    def inverse_tensor(self, y):
        return _softplus_inv_tensor(torch.clamp(y - self.lower, min=1e-20))


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

    def inverse_tensor(self, y):
        t = torch.clamp((y - self.a) / (self.b - self.a), 1e-12, 1.0 - 1e-12)
        return torch.log(t) - torch.log1p(-t)


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
        ii, jj = _tril_slots(self.n)
        return np.asarray(y)[..., ii, jj]

    def inverse_tensor(self, y):
        ii, jj = _tril_slot_tensors(self.n, y.device)
        return y[..., ii, jj]


@functools.lru_cache(maxsize=None)
def _tril_slots(n: int):
    """The (row, column) of each packed entry of FillTriangular(n), in
    packed order: the static index map of its lower triangle."""
    k = np.arange(n * (n + 1) // 2)
    slots = np.concatenate([k[n:], k[::-1]]).reshape(n, n)
    ii, jj = np.tril_indices(n)
    order = np.argsort(slots[ii, jj])
    return ii[order], jj[order]


@functools.lru_cache(maxsize=None)
def _tril_slot_tensors(n: int, device: torch.device):
    """``_tril_slots`` as index tensors on ``device``, made once per (n,
    device): made at every call they would be host-to-device copies, which
    a CUDA graph cannot capture."""
    return tuple(torch.as_tensor(i, device=device) for i in _tril_slots(n))


positive = Positive()
identity = Identity()
