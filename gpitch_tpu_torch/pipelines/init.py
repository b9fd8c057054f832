"""Inducing-point and kernel initialization (host).

Counterpart of gpitch_tpu/pipelines/init.py: inducing points at the
signal's extrema (the same dispatch between the native extrema finder and
the numpy path: the native finder differs by one-off boundary points, so
both packages must take the same one) or on uniform grids, and the
activation and component kernels of the detection models.
"""

from __future__ import annotations

import numpy as np
import torch

from ..audio.spectrum import init_cparam
from ..audio.windowing import hann
from ..core.params import Param
from ..kernels import Matern12, Matern32, Matern32sm, Matern52, MercerCosMix, MercerMatern12sm
from ..utils.math import find_ideal_f0

__all__ = ["init_liv", "init_liv_robust", "init_iv", "init_kernel_training",
           "init_kern_act", "init_kern_com", "init_kern", "init_kern_mercer_product",
           "init_kernel_with_trained_models"]


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


def init_iv(x, num_sources: int, nivps_a: int, nivps_c: int, fs: float):
    """Uniform inducing grids of ``nivps_a`` and ``nivps_c`` points a second
    (and the last sample): [za list, zc list], one per source."""
    x = np.asarray(x).reshape(-1, 1)
    dec_a = max(int(fs / nivps_a), 1)
    dec_c = max(int(fs / nivps_c), 1)
    za = [np.vstack([x[::dec_a].copy(), x[-1:].copy()]) for _ in range(num_sources)]
    zc = [np.vstack([x[::dec_c].copy(), x[-1:].copy()]) for _ in range(num_sources)]
    return [za, zc]


def init_kernel_training(y, list_files, fs, maxh: int = 25, dtype=torch.float32):
    """Per pitch a Matern12 activation and a Matern32sm component from the
    FFT of its note (variances fixed, frequencies trainable).  Returns
    ([kern_act list, kern_com list], the FFT parameters)."""
    if0 = find_ideal_f0(list_files)
    kern_act, kern_com, iparam = [], [], []
    for i in range(len(list_files)):
        p = init_cparam(np.asarray(y[i]).reshape(-1), fs=fs, maxh=maxh, ideal_f0=if0[i])
        iparam.append(p)
        kern_act.append(Matern12.create(variance=3.5, lengthscales=1.0, dtype=dtype))
        kc = Matern32sm.create(lengthscales=1.0, variances=np.clip(p[1], 1e-4, 0.2495),
                               frequencies=p[0], dtype=dtype)
        kern_com.append(kc.vars_n_freqs_fixed(fix_var=True, fix_freq=False))
    return [kern_act, kern_com], iparam


def _first(p: Param) -> np.ndarray:
    return p.value.detach().cpu().double().numpy().reshape(-1)


def init_kernel_with_trained_models(models, option_two: bool = False,
                                    dtype=torch.float32):
    """Detection kernels from trained single-pitch ModGP models: the
    activation's variance and lengthscale and the component's lengthscale
    from source 0 (``option_two``: fixed 4.0, 0.5 and 1.0 instead), the
    component's frequencies trainable and its energies or variances fixed.
    Returns [kern_act list, kern_com list]."""
    kern_act, kern_com = [], []
    for m in models:
        src_act = m.kern_act[0] if isinstance(m.kern_act, (list, tuple)) else m.kern_act
        src_com = m.kern_com[0] if isinstance(m.kern_com, (list, tuple)) else m.kern_com
        if option_two:
            ka = Matern12.create(variance=4.0, lengthscales=0.5, dtype=dtype)
            lc = 1.0
        else:
            ka = Matern12.create(variance=float(_first(src_act.variance)[0]),
                                 lengthscales=float(_first(src_act.lengthscales)[0]),
                                 dtype=dtype)
            lc = float(_first(src_com.lengthscales)[0])
        freqs = _first(src_com.frequency)
        if hasattr(src_com, "energy"):
            kc = MercerMatern12sm.create(variance=1.0, lengthscales=lc,
                                         energy=_first(src_com.energy), frequency=freqs,
                                         train_energy=False, train_frequency=True,
                                         dtype=dtype)
        else:
            kc = Matern32sm.create(lengthscales=lc,
                                   variances=np.clip(_first(src_com.variance), 1e-4, 0.2495),
                                   frequencies=freqs, train_vars=False, train_freqs=True,
                                   dtype=dtype)
        kern_act.append(ka)
        kern_com.append(kc)
    return [kern_act, kern_com]


def init_kern_act(num_pitches: int, dtype=torch.float32):
    """Matern32 activations (variance 3.5, lengthscale 1)."""
    return [Matern32.create(variance=3.5, lengthscales=1.0, dtype=dtype)
            for _ in range(num_pitches)]


def init_kern(num_pitches: int, lengthscale, energy, frequency, dtype=torch.float32):
    """[activations, components] of ``num_pitches`` pitches."""
    return [init_kern_act(num_pitches, dtype),
            init_kern_com(num_pitches, lengthscale, energy, frequency, dtype=dtype)]


def init_kern_mercer_product(num_pitches: int, energy, frequency, dtype=torch.float32):
    """Matern32 activations and Matern52 x MercerCosMix components (the
    Matern52's variance fixed)."""
    k_act, k_com = [], []
    for i in range(num_pitches):
        k_act.append(Matern32.create(variance=3.5, lengthscales=0.25, dtype=dtype))
        base = Matern52.create(variance=1.0, lengthscales=0.25, dtype=dtype)
        base.variance = Param(base.variance.raw, base.variance.transform, False)
        mix = MercerCosMix.create(energy=np.asarray(energy[i]).reshape(-1),
                                  frequency=np.asarray(frequency[i]).reshape(-1),
                                  variance=0.25, dtype=dtype)
        k_com.append(base * mix)
    return [k_act, k_com]
