"""Inducing-point and kernel initialization (host).

Counterpart of gpitch_tpu/pipelines/init.py's ``init_liv``,
``init_liv_robust`` and ``init_kern_com``, with the same dispatch between
the native extrema finder and the numpy path (the native finder differs by
one-off boundary points, so both packages must take the same one).
"""

from __future__ import annotations

import numpy as np
import torch

from ..audio.windowing import hann
from ..kernels.spectral import MercerMatern12sm

__all__ = ["init_liv", "init_liv_robust", "init_kern_com"]


def _smooth(y, win):
    w = hann(win) if win > 1 else np.ones(1)
    return np.convolve(y, w, mode="same") / np.sum(w)


def init_liv(x, y, num_sources: int = 1, win_size: int = 9,
             thres: float = 0.0025, dec: int = 1):
    """Inducing points at the energy-gated signal extrema, decimated by
    ``dec``.  Returns ([za list, zc list], u values at the extrema)."""
    from .. import native

    x = np.asarray(x).reshape(-1)
    y = np.asarray(y).reshape(-1)
    if native.enabled():
        idx = native.find_extrema(y, smooth_win=win_size, energy_win=1600,
                                  thres=thres, dec=dec)
        x_final = x[idx].reshape(-1, 1)
        za = [x_final.copy() for _ in range(num_sources)]
        zc = [x_final.copy() for _ in range(num_sources)]
        return [za, zc], y[idx].reshape(-1, 1)
    return _init_liv_numpy(x, y, num_sources, win_size, thres, dec)


def _init_liv_numpy(x, y, num_sources: int, win_size: int, thres: float,
                    dec: int):
    """The numpy path of ``init_liv``."""
    energy = _smooth(np.abs(y), 1600)
    peak = np.max(energy)
    energy = energy / (peak if peak > 0 else 1.0)  # silent window: zeros
    sign = np.sign(np.gradient(_smooth(y, win_size)))
    idx = np.where(np.diff(sign) != 0)[0]
    keep = np.where(energy[idx] > thres)[0]
    x_final = x[idx][keep].reshape(-1, 1)
    y_final = y[idx][keep].reshape(-1, 1)
    za = [x_final[::dec].copy() for _ in range(num_sources)]
    zc = [x_final[::dec].copy() for _ in range(num_sources)]
    return [za, zc], y_final[::dec]


def init_liv_robust(x, y, dec: int = 1, min_points: int = 8, **kw):
    """``init_liv`` for one window, with a uniform subset of the window's own
    samples when (near-)silence leaves fewer than ``min_points`` extrema.
    Returns an (M, 1) array."""
    z, _ = init_liv(x, y, num_sources=1, dec=dec, **kw)
    zi = z[0][0]
    if zi.shape[0] < min_points:
        x = np.asarray(x).reshape(-1, 1)
        count = max(min_points, 16)
        step = max(1, x.shape[0] // count)
        zi = x[::step][:count].copy()
    return zi


def init_kern_com(num_pitches: int, lengthscale, energy, frequency,
                  len_fixed: bool = True, dtype=torch.float32):
    """MercerMatern12sm component kernels from learned (l, e, f)."""
    return [MercerMatern12sm.create(
        variance=1.0,
        lengthscales=float(np.asarray(lengthscale[i]).reshape(-1)[0]),
        energy=np.asarray(energy[i]).reshape(-1),
        frequency=np.asarray(frequency[i]).reshape(-1),
        len_fixed=len_fixed, dtype=dtype)
        for i in range(num_pitches)]
