"""Source separation over overlap windows (SoSp).

Counterpart of gpitch_tpu/pipelines/separation.py: per-pitch kernels
learned from isolated notes ('train': a sampled covariance and a kernel
fit), taken from their FFT ('fft') or given ('load'); inducing points at
each window's extrema; one batched window bank trained on the device
(Adam, or one L-BFGS solver per window); per-source posteriors merged by
Hann overlap-add.
"""

from __future__ import annotations

import fnmatch
import os
import time
from typing import Sequence

import numpy as np
import torch

from ..audio.io import Audio
from ..audio.spectrum import init_cparam
from ..audio.windowing import merged_mean, merged_variance, window_stack
from ..config import DEFAULT_DEVICE, resolve_device
from ..utils.math import find_ideal_f0
from .init import init_kern_com, init_liv_robust
from .kernel_learning import fit_kernels, sample_cov
from .windowed_sgpr import (build_window_bank, optimize_bank, pad_inducing,
                            pitch_variances, predict_bank_mixture,
                            predict_bank_sources, sum_kernel)

__all__ = ["SoSp", "learn_pitch_params", "load_mixture_from_sources"]


def learn_pitch_params(train_signals, names, fs, mode: str = "fft",
                       covsize: int = 441, num_sam: int = 10000, max_par: int = 1,
                       saved=None, timings: dict | None = None,
                       device=DEFAULT_DEVICE, dtype: torch.dtype = torch.float32):
    """Per-pitch [lengthscales, energies, frequencies]: 'train' = a sampled
    covariance (``num_sam`` windows of ``covsize`` samples, host numpy)
    and the kernel fit (``fit_kernels``, on ``device`` in ``dtype``),
    'fft' = FFT peak init, 'load' = ``saved``.  Returns (params, [xk, sk])
    (None for 'load').  ``timings``: a dict that receives per-pitch
    seconds, 'sample_cov' and 'fit' lists ('fit': the batched solve the
    pitch was in)."""
    if mode == "load":
        if saved is None:
            raise ValueError("mode='load' requires saved params")
        return saved, None
    if mode not in ("fft", "train"):
        raise ValueError(f"unknown kernel mode {mode!r}")
    params = [[], [], []]
    xk, sk = [], []
    if mode == "train":
        for y in train_signals:
            t0 = time.perf_counter()
            _, kern_sampled, _ = sample_cov(np.asarray(y).reshape(-1), num_sam=num_sam,
                                            size=covsize)
            if timings is not None:
                timings.setdefault("sample_cov", []).append(time.perf_counter() - t0)
            sk.append(kern_sampled)
            xk.append(np.linspace(0.0, (covsize - 1.0) / fs, covsize).reshape(-1, 1))
        fits, seconds = fit_kernels(sk, train_signals, names, max_par, fs,
                                    device=device, dtype=dtype)
        for p, _, _ in fits:
            for k in range(3):
                params[k].append(p[k])
        if timings is not None:
            timings.setdefault("fit", []).extend(seconds)
        return params, [xk, sk]
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


def load_mixture_from_sources(test_path, instrument, names=("_C_", "_E_", "_G_"),
                              window_size: int = 2001):
    """The test mixture as the sum of the isolated source recordings in
    ``test_path`` whose names match ``*{instrument}{tag}*.wav``, one per
    tag.  Returns (x, mixture, [Audio of each source])."""
    sources = []
    for tag in names:
        cands = fnmatch.filter(os.listdir(test_path), f"*{instrument}{tag}*.wav")
        sources.append(Audio(path=test_path + os.sep, filename=cands[0],
                             window_size=window_size))
    return sources[0].x.copy(), sum(s.y for s in sources), sources


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
            saved=saved_params, device=self.device, dtype=dtype)

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
        self.opt_info = None
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
                 method: str = "adam", timed: bool = False,
                 window_chunk: int | None = None, mesh=None, mesh_axis: str = "w"):
        """All windows at once (see ``optimize_bank``): ``method`` "adam", or
        "lbfgs" (one solver per window, the reference's optimizer).
        Returns the per-step total loss (numpy), with ``timed=True``
        (losses, (first_s, run_s)); the run's counts are kept as
        ``opt_info``."""
        out = optimize_bank(self.bank, num_steps=maxiter, learning_rate=learning_rate,
                            method=method, timed=timed, window_chunk=window_chunk,
                            mesh=mesh, mesh_axis=mesh_axis, return_info=True)
        self.bank, losses, self.opt_info = out[0], out[1], out[-1]
        self.matrix_var = pitch_variances(self.bank).cpu().numpy()
        return (losses, out[2]) if timed else losses

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

    def save_results(self, path, real_sources=None):
        """npz of the sources' means and variances, matrix_var and, when
        given, the true sources."""
        np.savez(path,
                 esrc=np.stack([e[0] for e in self.esource]),
                 vsrc=np.stack([e[1] for e in self.esource]),
                 matrix_var=self.matrix_var,
                 src=None if real_sources is None else np.stack(
                     [np.asarray(s).reshape(-1, 1) for s in real_sources]))
