"""Source separation over overlap windows (SoSp).

Counterpart of gpitch_tpu/pipelines/separation.py in its 'fft' and 'load'
kernel modes with Adam: per-pitch kernels from the FFT of isolated notes,
inducing points at each window's extrema, one batched window bank trained
by Adam on the device, per-source posteriors merged by Hann overlap-add.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..audio.spectrum import init_cparam
from ..audio.windowing import merged_mean, merged_variance, window_stack
from ..config import DEFAULT_DEVICE, resolve_device
from ..utils.math import find_ideal_f0
from .init import init_kern_com, init_liv_robust
from .windowed_sgpr import (build_window_bank, optimize_bank, pad_inducing,
                            pitch_variances, predict_bank_mixture,
                            predict_bank_sources, sum_kernel)

__all__ = ["SoSp", "learn_pitch_params"]


def learn_pitch_params(train_signals, names, fs, mode: str = "fft",
                       covsize: int = 441, max_par: int = 1, saved=None):
    """Per-pitch [lengthscales, energies, frequencies]: 'fft' = FFT peak
    init, 'load' = ``saved``.  Returns (params, [xk, sk]) (sk None for
    'load')."""
    if mode == "train":
        raise NotImplementedError(
            "kernel_mode='train' (sampled covariance + kernel fit) is ported "
            "in a later slice of the PyTorch port; use 'fft' or 'load'")
    if mode == "load":
        if saved is None:
            raise ValueError("mode='load' requires saved params")
        return saved, None
    if mode != "fft":
        raise ValueError(f"unknown kernel mode {mode!r}")
    params = [[], [], []]
    xk, sk = [], []
    for i, y in enumerate(train_signals):
        y = np.asarray(y).reshape(-1)
        f0 = find_ideal_f0([names[i]])[0]
        p = init_cparam(y, fs=fs, maxh=max_par, ideal_f0=f0)
        params[0].append(np.array(0.1))
        params[1].append(p[1])
        params[2].append(p[0])
        spec = np.fft.ifft(np.abs(np.fft.fft(y)))[:covsize].real
        sk.append((spec / np.max(spec)).reshape(-1, 1))
        xk.append(np.linspace(0.0, (covsize - 1.0) / fs, covsize).reshape(-1, 1))
    return params, [xk, sk]


class SoSp:
    """Source separation over overlap windows.

        SoSp(train_signals=[y60, y64, y67], train_names=[...], fs=16000,
             mixture=(x, y))

    Runs on ``device`` ('cuda' unless the caller asks for 'cpu') in
    ``dtype``.
    """

    def __init__(self, train_signals, train_names, fs, mixture,
                 window_size: int = 2001, kernel_mode: str = "fft",
                 max_par: int = 1, num_inducing: int | None = None,
                 saved_params=None, reg: bool = False, dec: int = 1,
                 device=DEFAULT_DEVICE, dtype: torch.dtype = torch.float32):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.fs = fs
        self.window_size = window_size
        self.train_names = list(train_names)
        self.num_pitches = len(train_signals)
        self.params, self.kern_sampled = learn_pitch_params(
            train_signals, train_names, fs, mode=kernel_mode, max_par=max_par,
            saved=saved_params)

        self.x = np.asarray(mixture[0]).reshape(-1, 1)
        self.y = np.asarray(mixture[1]).reshape(-1, 1)
        self.xw = window_stack(self.x, window_size)      # (nw, ws)
        self.yw = window_stack(self.y, window_size)
        self.nwin = self.xw.shape[0]

        # inducing points at each window's extrema, uniform for silent windows
        z_list = [init_liv_robust(self.xw[i], self.yw[i], dec=dec)
                  for i in range(self.nwin)]
        self.grid_dt = 1.0 / fs
        self.z = pad_inducing(z_list, num_inducing, grid_dt=self.grid_dt)
        self.reg = reg
        self.bank = self._build_bank()
        self.matrix_var = None
        self.esource = None
        self.mean = None
        self.var = None

    def _kern_builder(self):
        kerns = init_kern_com(self.num_pitches, self.params[0], self.params[1],
                              self.params[2], len_fixed=True, dtype=self.dtype)
        return sum_kernel(kerns)

    def _build_bank(self):
        try:
            return build_window_bank(self.xw, self.yw, self.z, self._kern_builder,
                                     reg=self.reg, grid_dt=self.grid_dt,
                                     dtype=self.dtype, device=self.device)
        except ValueError as e:
            import warnings
            warnings.warn(
                f"SoSp: on-grid (uniform-sampling) property unavailable ({e}); "
                "continuing without grid metadata — equivalent result",
                RuntimeWarning, stacklevel=2)
            return build_window_bank(self.xw, self.yw, self.z, self._kern_builder,
                                     reg=self.reg, dtype=self.dtype,
                                     device=self.device)

    def optimize(self, maxiter: int = 500, learning_rate: float = 0.01,
                 method: str = "adam", window_chunk: int | None = None):
        """Adam on all windows at once.  Returns the per-step total loss
        (numpy)."""
        self.bank, losses = optimize_bank(self.bank, num_steps=maxiter,
                                          learning_rate=learning_rate,
                                          method=method, window_chunk=window_chunk)
        self.matrix_var = pitch_variances(self.bank).cpu().numpy()
        return losses

    def predict_f(self, batch_size: int = 8):
        """Mixture posterior per window: mean, var (nw, ws) numpy."""
        mean, var = predict_bank_mixture(self.bank, self.xw, batch_size)
        self.mean, self.var = mean.cpu().numpy(), var.cpu().numpy()
        return self.mean, self.var

    def predict_s(self, batch_size: int = 8):
        """Per-source Hann overlap-add merge: [[mean (n, 1), var (n, 1)] per
        source]."""
        smean, svar = predict_bank_sources(self.bank, self.xw, batch_size)
        smean, svar = smean.cpu().numpy(), svar.cpu().numpy()
        n = self.x.shape[0]
        self.esource = [[merged_mean(smean[i], self.window_size, n),
                         merged_variance(svar[i], self.window_size, n)]
                        for i in range(smean.shape[0])]
        return self.esource

    def compute_rmse(self, real_sources: Sequence[np.ndarray]) -> float:
        """Mean per-source RMSE against the true sources."""
        if self.esource is None:
            self.predict_s()
        out = []
        for est, real in zip(self.esource, real_sources):
            r = np.asarray(real).reshape(-1, 1)[: est[0].shape[0]]
            out.append(np.sqrt(np.mean((r - est[0]) ** 2)))
        return float(np.mean(out))
