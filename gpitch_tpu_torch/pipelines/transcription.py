"""Automatic music transcription over overlap windows (AMT).

Counterpart of gpitch_tpu/pipelines/transcription.py: per-pitch kernels
from the FFT of isolated notes (lengthscales trainable), the test piece cut
into windows with the targets scaled by ``y_scale`` (20), one batched
window bank trained on the device (Adam, or one L-BFGS solver per window),
and the learned per-window per-pitch variance ``matrix_var`` as the
transcription, turned into a pianoroll by a threshold rule and scored by
the frame-level F-measure.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..audio.pianoroll import Pianoroll
from ..audio.windowing import window_stack
from ..config import DEFAULT_DEVICE, resolve_device
from .init import init_kern_com, init_liv_robust
from .separation import learn_pitch_params
from .windowed_sgpr import (build_window_bank, optimize_bank, pad_inducing,
                            pitch_variances, sum_kernel)

__all__ = ["AMT", "pianoroll_from_variances", "mad_pianoroll", "f_measure"]


def pianoroll_from_variances(matrix_var, threshold: float = 0.02,
                             per_pitch: bool = True):
    """Binary pianoroll by thresholding the variance envelope.  With
    ``per_pitch`` each pitch row is rescaled to [0, 1] first, which makes
    every row cross its threshold somewhere (``mad_pianoroll`` does not)."""
    mv = np.asarray(matrix_var, dtype=float)
    if per_pitch:
        lo = mv.min(axis=1, keepdims=True)
        hi = mv.max(axis=1, keepdims=True)
        mv = (mv - lo) / np.where(hi - lo > 0, hi - lo, 1.0)
        return (mv > threshold).astype(float)
    scale = mv.max() if mv.max() > 0 else 1.0
    return (mv / scale > threshold).astype(float)


def mad_pianoroll(matrix_var, k: float = 4.0, floor_frac: float = 0.05):
    """Per pitch, active where the envelope rises ``k`` scaled MADs (1.4826
    MAD) above the row's median, and at least ``floor_frac`` of the global
    maximum above it.  Assumes each pitch is silent in at least half its
    windows; ``k`` is fixed a priori."""
    mv = np.asarray(matrix_var, dtype=float)
    med = np.median(mv, axis=1, keepdims=True)
    mad = 1.4826 * np.median(np.abs(mv - med), axis=1, keepdims=True)
    guard = floor_frac * max(mv.max(), 1e-30)
    thr = med + np.maximum(k * mad, guard)
    return (mv > thr).astype(float)


def f_measure(est, ref):
    """Frame-level (precision, recall, F) of two binary piano rolls."""
    est = np.asarray(est).astype(bool)
    ref = np.asarray(ref).astype(bool)
    tp = np.sum(est & ref)
    p = tp / max(np.sum(est), 1)
    r = tp / max(np.sum(ref), 1)
    f = 0.0 if p + r == 0 else 2 * p * r / (p + r)
    return p, r, f


class AMT:
    """Windowed multi-pitch transcription.

        AMT(train_signals=[...], train_names=[...], fs=44100,
            test=(x, y), pitches=[60, 64, ...])

    Runs on ``device`` ('cuda' unless the caller asks for 'cpu') in
    ``dtype``.
    """

    def __init__(self, train_signals, train_names, fs, test, pitches,
                 window_size: int = 2001, kernel_mode: str = "fft",
                 max_par: int = 20, num_inducing: int | None = None,
                 saved_params=None, reg: bool = False, dec: int = 3,
                 y_scale: float = 20.0, pianoroll: Pianoroll | None = None,
                 device=DEFAULT_DEVICE, dtype: torch.dtype = torch.float32):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.fs = fs
        self.pitches = list(pitches)
        self.window_size = window_size
        self.y_scale = y_scale
        self.piano_roll = pianoroll
        self.params, self.kern_sampled = learn_pitch_params(
            train_signals, train_names, fs, mode=kernel_mode, max_par=max_par,
            saved=saved_params, device=self.device, dtype=dtype)

        self.x = np.asarray(test[0]).reshape(-1, 1)
        self.y = np.asarray(test[1]).reshape(-1, 1)
        self.xw = window_stack(self.x, window_size)
        self.yw = window_stack(self.y, window_size)
        self.nwin = self.xw.shape[0]

        # inducing points at each window's extrema, uniform for silent windows
        z_list = [init_liv_robust(self.xw[i], self.yw[i], dec=dec)
                  for i in range(self.nwin)]
        self.grid_dt = 1.0 / fs
        self.z = pad_inducing(z_list, num_inducing, grid_dt=self.grid_dt)
        self.reg = reg
        self.bank = self._build_bank()
        self.matrix_var = np.zeros((len(self.pitches), self.nwin))
        self.opt_info = None

    def _kern_builder(self):
        kerns = init_kern_com(len(self.pitches), self.params[0], self.params[1],
                              self.params[2], len_fixed=False, dtype=self.dtype)
        return sum_kernel(kerns)

    def _build_bank(self):
        kw = dict(noise_variance=1.0, reg=self.reg, y_scale=self.y_scale,
                  dtype=self.dtype, device=self.device)
        try:
            return build_window_bank(self.xw, self.yw, self.z, self._kern_builder,
                                     grid_dt=self.grid_dt, **kw)
        except ValueError as e:
            warnings.warn(
                f"AMT: on-grid (uniform-sampling) property unavailable ({e}); "
                "continuing without grid metadata — equivalent result",
                RuntimeWarning, stacklevel=2)
            return build_window_bank(self.xw, self.yw, self.z, self._kern_builder, **kw)

    def optimize(self, maxiter: int = 500, learning_rate: float = 0.01,
                 method: str = "adam", timed: bool = False,
                 window_chunk: int | None = None, mesh=None,
                 mesh_axis: str = "w", segment: int | None = 250):
        """All windows at once (see ``optimize_bank``): ``method`` "adam", or
        "lbfgs" (one solver per window, the reference's optimizer).
        Returns the per-step total loss (numpy), with ``timed=True``
        (losses, (first_s, run_s)); the run's counts are kept as
        ``opt_info``."""
        out = optimize_bank(self.bank, num_steps=maxiter,
                            learning_rate=learning_rate, method=method,
                            timed=timed, segment=segment,
                            window_chunk=window_chunk, mesh=mesh,
                            mesh_axis=mesh_axis, return_info=True)
        self.bank, losses, self.opt_info = out[0], out[1], out[-1]
        self.matrix_var = pitch_variances(self.bank).cpu().numpy()
        return (losses, out[2]) if timed else losses

    def pianoroll_estimate(self, threshold: float = 0.02,
                           per_pitch: bool = True, mode: str = "minmax",
                           k: float = 4.0):
        """``mode="minmax"``: per-pitch rescale and threshold;
        ``mode="mad"``: the silent-floor + k MAD rule (``mad_pianoroll``)."""
        if mode == "mad":
            return mad_pianoroll(self.matrix_var, k=k)
        return pianoroll_from_variances(self.matrix_var, threshold, per_pitch)

    def evaluate(self, threshold: float = 0.02, mode: str = "minmax",
                 k: float = 4.0):
        """Frame-level (precision, recall, F) against the attached
        ground-truth pianoroll, sampled at the window centres."""
        if self.piano_roll is None:
            raise ValueError("no ground-truth pianoroll attached")
        est = self.pianoroll_estimate(threshold, mode=mode, k=k)
        gt = self.piano_roll
        hop = (self.window_size - 1) // 2
        centers = (np.arange(self.nwin) * hop + self.window_size // 2) / self.fs
        rows = []
        for p in self.pitches:
            g = gt.pr_dic[str(p)][:, 0]
            idx = np.clip((centers * gt.fs).astype(int), 0, g.size - 1)
            rows.append(g[idx])
        return f_measure(est, np.stack(rows))

    def save_results(self, path):
        """matrix_var, the lengthscales and the pitches as plain float
        arrays (loadable with allow_pickle=False)."""
        np.savez(path, matrix_var=self.matrix_var,
                 params_len=np.asarray([float(np.asarray(l)) for l in self.params[0]]),
                 pitches=np.asarray(self.pitches))
