"""Nonlinearities (torch) and music-math helpers (host numpy).

A copy of gpitch_tpu/utils/math.py: ``logistic``, ``ilogistic``,
``softplus``, ``isoftplus``, ``gaussfun``, ``igaussfun`` and ``norm`` on
tensors (``logistic`` is shifted and scaled, 1 / (1 + e^{-2 (x - pi)}), the
activation nonlinearity of the modulated likelihoods), ``midi2freq``,
``freq2midi`` and ``find_ideal_f0`` on the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["logistic", "ilogistic", "softplus", "isoftplus", "gaussfun",
           "igaussfun", "norm", "midi2freq", "freq2midi", "find_ideal_f0"]


def logistic(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-2 (x - pi))), written through tanh."""
    return 0.5 * (torch.tanh(x - math.pi) + 1.0)


def ilogistic(x: torch.Tensor) -> torch.Tensor:
    """Inverse of ``logistic``."""
    return math.pi - 0.5 * torch.log(1.0 / x - 1.0)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def isoftplus(x: torch.Tensor) -> torch.Tensor:
    """log(e^x - 1)."""
    return torch.log(-torch.expm1(-x)) + x


def gaussfun(x: torch.Tensor) -> torch.Tensor:
    """exp(-2 (x - pi)^2), the Gaussian-bump nonlinearity."""
    return torch.exp(-2.0 * (x - math.pi) ** 2)


def igaussfun(x: torch.Tensor) -> torch.Tensor:
    return math.pi - torch.sqrt(-0.5 * torch.log(x))


def norm(x: torch.Tensor) -> torch.Tensor:
    """x divided by its largest absolute value (x itself when that is 0)."""
    m = x.abs().max()
    return x / torch.where(m == 0, torch.ones_like(m), m)


def midi2freq(midi):
    return 2.0 ** ((np.asarray(midi, dtype=float) - 69.0) / 12.0) * 440.0


def freq2midi(freq):
    return int(69.0 + 12.0 * np.log2(float(freq) / 440.0))


def find_ideal_f0(names):
    """f0 of every MIDI number written like 'M60' in the names."""
    out = []
    for name in names:
        for midi in range(21, 109):
            if f"M{midi}" in name:
                out.append(midi2freq(midi))
    return out
