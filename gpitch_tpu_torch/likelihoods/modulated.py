"""Modulated-GP likelihoods, y = sum_i nlin(g_i) f_i + eps, with batched
Gauss-Hermite expectations.

Counterpart of gpitch_tpu/likelihoods/modulated.py.  One
``ModulatedLikelihood`` handles S sources: the quadrature runs over an
(N, S, H) tensor, and the cross terms of the expected square come from

    2 sum_{i<j} a_i a_j = (sum_i a_i)^2 - sum_i a_i^2.

Columns of F follow the [g_1..g_S, f_1..f_S] convention (MpdLik); ModLik,
LooLik and SsLik take the interleaved [f_1, g_1, f_2, g_2, ..] order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from ..core.params import Param, static_field
from ..core.quadrature import gauss_hermite_moments
from ..core.transforms import Positive
from ..utils.math import logistic

__all__ = ["ModulatedLikelihood", "ModLik", "LooLik", "SsLik", "MpdLik",
           "exp_value_closed_form", "gaussian_logdensity", "log_lik_exp"]

_LOG_2PI = math.log(2.0 * math.pi)


def gaussian_logdensity(y, mean, variance):
    """log N(y | mean, variance)."""
    return -0.5 * (_LOG_2PI + torch.log(variance) + (y - mean).square() / variance)


def exp_value_closed_form(mean, var, b):
    """sqrt(b / (v + b)) exp(-m^2 / (2 (v + b))): E[phi(g)] for the
    Gaussian-bump nonlinearity, in closed form."""
    return torch.sqrt(b / (var + b)) * torch.exp(-0.5 * mean.square() / (var + b))


def log_lik_exp(y, mean_f, var_f, e1, e2, noise_var, reduce=None):
    """E_q[log N(y | sum_i phi(g_i) f_i, sigma^2)] with the cross terms.
    y (N, 1); mean_f, var_f, e1, e2 (N, S).  Returns (N, 1).  ``reduce``
    takes the (N, 3) sums over the sources given here and returns the sums
    over all sources (the sources split over ranks: ``parallel.mesh``)."""
    a = e1 * mean_f
    A = a.sum(-1, keepdim=True)
    B = (e2 * (var_f + mean_f.square())).sum(-1, keepdim=True)
    sq = a.square().sum(-1, keepdim=True)
    if reduce is not None:
        A, B, sq = reduce(torch.cat([A, B, sq], -1)).split(1, -1)
    C = A.square() - sq
    quad = y.square() - 2.0 * y * A + B + C
    return -0.5 * (quad / noise_var + _LOG_2PI + torch.log(noise_var))


@dataclasses.dataclass
class ModulatedLikelihood:
    """y = sum_i nlin(g_i) f_i + eps for any number of sources.
    ``closed_form`` replaces the quadrature by the Gaussian-bump closed
    form with b = 0.5 and 0.25."""

    variance: Any = None
    nlinfun: Callable = static_field(logistic)
    num_sources: int = static_field(1)
    gh_points: int = static_field(20)
    closed_form: bool = static_field(False)

    @classmethod
    def create(cls, num_sources=1, nlinfun=logistic, variance=1.0, gh_points=20,
               closed_form=False, dtype=torch.float32):
        return cls(variance=Param.create(variance, Positive(), dtype=dtype),
                   nlinfun=nlinfun, num_sources=num_sources, gh_points=gh_points,
                   closed_form=closed_form)

    def split(self, F):
        """F (N, 2S) -> (g, f) each (N, S)."""
        s = self.num_sources
        return F[..., :s], F[..., s:]

    def moments(self, mean_g, var_g):
        """(E[phi(g)], E[phi(g)^2]) for every entry."""
        if self.closed_form:
            return (exp_value_closed_form(mean_g, var_g, 0.5),
                    exp_value_closed_form(mean_g, var_g, 0.25))
        return gauss_hermite_moments(mean_g, var_g, self.nlinfun, self.gh_points)

    def mean_function(self, F):
        g, f = self.split(F)
        return (self.nlinfun(g) * f).sum(-1, keepdim=True)

    def logp(self, F, Y):
        """log N(y | sum nlin(g_i) f_i, sigma^2), (N, 1)."""
        return gaussian_logdensity(Y, self.mean_function(F), self.variance.value)

    def variational_expectations(self, Fmu, Fvar, Y, reduce=None):
        """(N, 1) expected log-likelihoods under q(F) = N(Fmu, Fvar)
        (``reduce``: see ``log_lik_exp``)."""
        mean_g, mean_f = self.split(Fmu)
        var_g, var_f = self.split(Fvar)
        e1, e2 = self.moments(mean_g, var_g)
        return log_lik_exp(Y, mean_f, var_f, e1, e2, self.variance.value, reduce)


MpdLik = ModulatedLikelihood


def _swap_fg(F, s):
    """[f_1, g_1, ..] interleaved -> [g_1..g_s, f_1..f_s]."""
    return torch.cat([F[..., 1::2][..., :s], F[..., 0::2][..., :s]], dim=-1)


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


class _Interleaved:
    """logp and variational_expectations on the [f_1, g_1, ..] order."""

    def logp(self, F, Y):
        return super().logp(_swap_fg(F, self.num_sources), Y)

    def variational_expectations(self, Fmu, Fvar, Y, reduce=None):
        s = self.num_sources
        return super().variational_expectations(_swap_fg(Fmu, s), _swap_fg(Fvar, s), Y,
                                                reduce)


@dataclasses.dataclass
class ModLik(_Interleaved, ModulatedLikelihood):
    """One source, columns [f, g]."""

    @classmethod
    def create(cls, transfunc=logistic, variance=1.0, gh_points=20,
               dtype=torch.float32):
        return super().create(num_sources=1, nlinfun=transfunc, variance=variance,
                              gh_points=gh_points, dtype=dtype)


@dataclasses.dataclass
class LooLik(_Interleaved, ModulatedLikelihood):
    """Two sources ('leave one out'), columns [f1, g1, f2, g2], the plain
    sigmoid by default."""

    @classmethod
    def create(cls, variance=1.0, gh_points=20, nlinfun=None, dtype=torch.float32):
        return super().create(num_sources=2, nlinfun=nlinfun or _sigmoid,
                              variance=variance, gh_points=gh_points, dtype=dtype)


@dataclasses.dataclass
class SsLik(_Interleaved, ModulatedLikelihood):
    """Three sources, columns [f1, g1, f2, g2, f3, g3]; ``quad=False``
    takes the closed-form Gaussian-bump expectations."""

    @classmethod
    def create(cls, nlinfun=logistic, quad=True, variance=1.0, gh_points=20,
               dtype=torch.float32):
        return super().create(num_sources=3, nlinfun=nlinfun, variance=variance,
                              gh_points=gh_points, closed_form=not quad, dtype=dtype)
