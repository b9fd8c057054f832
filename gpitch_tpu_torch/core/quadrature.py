"""Gauss-Hermite quadrature over every data point and source at once.

Counterpart of gpitch_tpu/core/quadrature.py.  The nodes come from numpy on
the host; the tensors of nodes and weights are kept per (H, dtype, device)
(and D for the grids), so a training step copies nothing to the device and
a CUDA graph can capture it.
"""

from __future__ import annotations

import itertools
from functools import lru_cache

import numpy as np
import torch

__all__ = ["hermgauss", "gauss_hermite_moments", "expectation_gaussian_nonlin",
           "mvhermgauss", "hermgauss1d"]


@lru_cache(maxsize=None)
def _hermgauss_np(h: int):
    x, w = np.polynomial.hermite.hermgauss(h)
    return x, w / np.sqrt(np.pi)


@lru_cache(maxsize=32)
def _hermgauss_tensors(h: int, dtype: torch.dtype, device: torch.device):
    x, w = _hermgauss_np(h)
    return (torch.as_tensor(x, dtype=dtype, device=device),
            torch.as_tensor(w, dtype=dtype, device=device))


def hermgauss(h: int, dtype: torch.dtype = torch.float64, device="cpu"):
    """H nodes x and weights w normalized to sum 1, so that
    E[f(g)] ~= sum_k w_k f(mean + sqrt(2 var) x_k) for g ~ N(mean, var)."""
    return _hermgauss_tensors(h, dtype, torch.device(device))


def _nodes_at(mean, var, h):
    gh_x, gh_w = hermgauss(h, mean.dtype, mean.device)
    return mean[..., None] + torch.sqrt(2.0 * var)[..., None] * gh_x, gh_w


def gauss_hermite_moments(mean, var, nlinfun, h: int = 20):
    """(E[phi(g)], E[phi(g)^2]) for g ~ N(mean, var), elementwise over any
    shape."""
    x, gh_w = _nodes_at(mean, var, h)
    f = nlinfun(x)
    return f @ gh_w, (f * f) @ gh_w


def hermgauss1d(mean, var, h=20, nlinfun=None):
    """``gauss_hermite_moments`` with the argument order (mean, var, H,
    nlinfun)."""
    if nlinfun is None:
        raise TypeError("hermgauss1d requires nlinfun (order: mean, var, H, nlinfun)")
    return gauss_hermite_moments(mean, var, nlinfun, h)


@lru_cache(maxsize=32)
def _mvhermgauss_tensors(h: int, d: int, dtype: torch.dtype, device: torch.device):
    """The H^D-point grid (H^D, D) and its weights (H^D,), each made once per
    (H, D, dtype, device)."""
    raw_x, raw_w = np.polynomial.hermite.hermgauss(h)
    xn = np.array(list(itertools.product(*(raw_x,) * d)))           # (H^D, D)
    wn = np.prod(np.array(list(itertools.product(*(raw_w,) * d))), 1)
    return (torch.as_tensor(xn, dtype=dtype, device=device),
            torch.as_tensor(wn * np.pi ** (-0.5 * d), dtype=dtype, device=device))


def mvhermgauss(means, covs, h: int, d: int):
    """The H^D-point Gauss-Hermite grid of D-dimensional Gaussians.  means
    (N, D), covs (N, D, D).  Returns (locations (H^D, N, D), weights (H^D,))
    with E[f(x)] ~= sum_k w_k f(X[k])."""
    grid, weights = _mvhermgauss_tensors(h, d, means.dtype, means.device)
    chol = torch.linalg.cholesky(covs)                              # (N, D, D)
    X = np.sqrt(2.0) * torch.einsum("nde,ke->ndk", chol, grid) + means[..., None]
    return X.permute(2, 0, 1), weights


def expectation_gaussian_nonlin(mean, var, nlinfun, h: int = 20):
    """E[phi(g)] alone, as ``gauss_hermite_moments``."""
    x, gh_w = _nodes_at(mean, var, h)
    return nlinfun(x) @ gh_w
