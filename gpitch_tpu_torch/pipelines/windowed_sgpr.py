"""Batched windowed-SGPR engine: the compute core of separation.

Counterpart of gpitch_tpu/pipelines/windowed_sgpr.py (the Adam path).  The
window axis is an explicit leading batch axis: one SGPRSS holds every
window's data, inducing points and free hyperparameters, its bound is one
batched computation, and Adam updates all windows at once.  Windows are
independent, so chunking the window axis is exact.
"""

from __future__ import annotations

import heapq
from typing import Callable

import numpy as np
import torch

from ..config import DEFAULT_DEVICE, resolve_device
from ..core.params import Param, cat_windows, map_params, take_windows, to_device
from ..kernels.base import StackedSum, Sum
from ..models.fit import adam_segments, first_segment_excess
from ..models.sgpr import SGPRSS, check_on_grid

__all__ = ["sum_kernel", "pad_inducing", "build_window_bank", "bank_loss",
           "optimize_bank", "predict_bank_sources", "predict_bank_mixture",
           "pitch_variances"]


def sum_kernel(kerns):
    """Sum over per-pitch kernels: a StackedSum when they are homogeneous
    (one batched op over the pitch axis), else a Sum."""
    kerns = list(kerns)
    if len(kerns) > 1:
        try:
            return StackedSum.create(kerns)
        except ValueError:
            pass
    return Sum(kern_list=tuple(kerns))


def _gap_fill_points(z_sorted: np.ndarray, need: int, grid_dt) -> np.ndarray:
    """``need`` new points at midpoints of the largest gaps of ``z_sorted``
    (snapped to the sample grid when ``grid_dt`` is given), largest gap
    first; leftover points go on-grid after the last point."""
    new_vals: list[float] = []
    if grid_dt is not None:
        base = z_sorted[0]
        idx = np.round((z_sorted - base) / grid_dt).astype(np.int64)
        heap = [(-(int(idx[i + 1]) - int(idx[i])), int(idx[i]), int(idx[i + 1]))
                for i in range(len(idx) - 1)]
        heapq.heapify(heap)
        while len(new_vals) < need and heap and -heap[0][0] >= 2:
            g, lo, hi = heapq.heappop(heap)
            mid = lo + (-g) // 2
            new_vals.append(base + mid * grid_dt)
            heapq.heappush(heap, (-(mid - lo), lo, mid))
            heapq.heappush(heap, (-(hi - mid), mid, hi))
        tail = need - len(new_vals)
        if tail:
            last = max(float(z_sorted[-1]),
                       max(new_vals) if new_vals else -np.inf)
            new_vals.extend(last + grid_dt * np.arange(1, tail + 1))
    else:
        heap = [(-(z_sorted[i + 1] - z_sorted[i]),
                 float(z_sorted[i]), float(z_sorted[i + 1]))
                for i in range(len(z_sorted) - 1)]
        heapq.heapify(heap)
        while len(new_vals) < need and heap and -heap[0][0] > 1e-12:
            g, lo, hi = heapq.heappop(heap)
            mid = 0.5 * (lo + hi)
            new_vals.append(mid)
            heapq.heappush(heap, (-(mid - lo), lo, mid))
            heapq.heappush(heap, (-(hi - mid), mid, hi))
        tail = need - len(new_vals)
        if tail:
            span = float(z_sorted[-1] - z_sorted[0]) or 1e-3
            step = max(span / max(len(z_sorted) + need, 1), 1e-6)
            last = max(float(z_sorted[-1]),
                       max(new_vals) if new_vals else -np.inf)
            new_vals.extend(last + step * np.arange(1, tail + 1))
    return np.asarray(new_vals, dtype=np.float64)


def pad_inducing(z_list, m: int | None = None, grid_dt=None) -> np.ndarray:
    """Ragged per-window inducing sets -> (nw, M, 1): larger sets are
    subsampled evenly, smaller ones gap-filled (well separated points keep
    Kuu away from a near-null subspace)."""
    z_list = [np.asarray(z).reshape(-1, 1) for z in z_list]
    for i, z in enumerate(z_list):
        if z.shape[0] == 0:
            raise ValueError(
                f"window {i}: empty inducing set — silent windows need the "
                "uniform fallback (pipelines.init.init_liv_robust)")
    m = m or max(z.shape[0] for z in z_list)
    out = []
    for z in z_list:
        k = z.shape[0]
        if k > m:
            z = z[np.linspace(0, k - 1, m).astype(int)]
        elif k < m:
            pad = _gap_fill_points(np.sort(z[:, 0]), m - k, grid_dt)
            z = np.concatenate([z, pad.reshape(-1, 1)], 0)
        out.append(z)
    return np.stack(out)


def build_window_bank(x_windows, y_windows, z_windows, kern_builder: Callable,
                      noise_variance: float = 1.0, reg: bool = False,
                      y_scale: float = 1.0, grid_dt=None, dtype=torch.float32,
                      device=DEFAULT_DEVICE):
    """One SGPRSS over all windows (leaves (nw, ...)), built on the host and
    moved to ``device`` once ('cuda' unless the caller asks for 'cpu').

    kern_builder() -> a fresh kernel; every window starts from that copy.
    Per-window centering runs vectorized in f64 (x0 = min of the inputs and
    the inducing points, split into an f32 (hi, lo) pair); ``grid_dt``
    validates that windows and inducing points sit on the sample grid;
    ``y_scale`` scales the targets.
    """
    xw = np.asarray(x_windows, dtype=np.float64)
    xw = xw.reshape(xw.shape[0], -1)
    yw = y_scale * np.asarray(y_windows, dtype=np.float64).reshape(xw.shape[0], -1)
    zw = np.asarray(z_windows, dtype=np.float64).reshape(xw.shape[0], -1)
    nw = xw.shape[0]
    x0 = np.minimum(xw.min(axis=1), zw.min(axis=1))
    x0_hi = x0.astype(np.float32).astype(np.float64)
    x0_lo = x0 - x0_hi
    Xc = xw - x0[:, None]
    Zc = zw - x0[:, None]
    if grid_dt is not None:
        check_on_grid(Xc, Zc, grid_dt)
    device = resolve_device(device)

    template = SGPRSS.create(
        Xc[0], yw[0], kern_builder(), Z=Zc[0], noise_variance=noise_variance,
        reg=reg, center=False, dtype=dtype)

    def tile(p: Param) -> Param:
        return Param(p.raw.detach().expand((nw,) + tuple(p.raw.shape)).clone(),
                     p.transform, p.trainable)

    def data(value) -> Param:
        return Param.create(value, trainable=False, dtype=dtype)

    bank = map_params(template, tile)
    bank.X, bank.Y, bank.Z = data(Xc[..., None]), data(yw[..., None]), data(Zc[..., None])
    bank.x0, bank.x0_lo = data(x0_hi), data(x0_lo)
    return to_device(bank, device)


def bank_loss(bank) -> torch.Tensor:
    """Sum of the per-window negative bounds."""
    return bank.loss().sum()


def optimize_bank(bank, num_steps: int = 500, learning_rate: float = 0.01,
                  method: str = "adam", timed: bool = False,
                  segment: int | None = 250, window_chunk: int | None = None,
                  mesh=None):
    """Adam on every window at once; returns (bank, losses) with losses the
    per-step total over windows (numpy), and with ``timed=True`` (bank,
    losses, (first_s, run_s)).

    ``segment``: a host fence (the losses' copy) every ``segment`` steps
    (``None``: one at the end).  ``window_chunk``: optimize the window axis
    in chunks of this size, one after another (exact: every leaf and Adam
    moment is per window).  ``timed``: eager torch has no compile step, so
    first_s is the first segment's excess over the median of all later
    segments (of every chunk), and run_s the rest of the wall time, the
    split the JAX package makes for its chunked runs.
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh=: window-parallel distribution is ROADMAP item 14, a later "
            "slice of the PyTorch port; run on one device")
    if method != "adam":
        raise NotImplementedError(
            f"method={method!r}: per-window L-BFGS is ported in a later slice "
            "of the PyTorch port; use method='adam'")
    nw = bank.X.raw.shape[0]
    chunk = nw if window_chunk is None else max(1, window_chunk)
    banks, losses, seconds = [], np.zeros(num_steps), []
    for c0 in range(0, nw, chunk):
        part = bank if chunk >= nw else take_windows(bank, slice(c0, c0 + chunk))
        part, ls, secs = adam_segments(part, bank_loss, num_steps, learning_rate,
                                       segment=segment or num_steps)
        banks.append(part)
        losses += ls
        seconds += secs
    bank = banks[0] if len(banks) == 1 else cat_windows(banks)
    if timed:
        return bank, losses, first_segment_excess(seconds)
    return bank, losses


def _centered_windows(bank, x_windows) -> np.ndarray:
    """Per-window Xnew - x0 on the host in f64 (x0 = hi + lo)."""
    x0s = (bank.x0.raw.detach().cpu().numpy().astype(np.float64)
           + bank.x0_lo.raw.detach().cpu().numpy().astype(np.float64)).reshape(-1)
    xc = np.asarray(x_windows, dtype=np.float64)
    return xc.reshape(xc.shape[0], -1) - x0s[:, None]


def _chunks(bank, x_windows, batch_size: int):
    xw = _centered_windows(bank, x_windows)
    X = bank.X.raw.detach()
    xt = torch.as_tensor(xw, dtype=X.dtype, device=X.device)[..., None]
    at_x = bool(torch.equal(xt, X))
    nw = xt.shape[0]
    for c0 in range(0, nw, batch_size):
        sl = slice(c0, c0 + batch_size)
        yield take_windows(bank, sl), xt[sl], at_x


@torch.no_grad()
def predict_bank_sources(bank, x_windows, batch_size: int = 8,
                         y_scale: float = 1.0):
    """Per-window per-source posteriors (smean, svar), each (S, nw, ws),
    windows in chunks of ``batch_size``.  When the prediction points are the
    windows' own samples (checked exactly), each chunk builds its
    per-source Grams once and reuses their sum as the full Gram.
    ``y_scale`` undoes the bank's target scaling (mean / y_scale, variance
    / y_scale^2)."""
    means, variances = [], []
    for part, x, at_x in _chunks(bank, x_windows, batch_size):
        m, v = part.predict_s(x, pre_centered=True, xnew_is_x=at_x)
        means.append(torch.stack([mm[..., 0] for mm in m], dim=0))
        variances.append(torch.stack([vv[..., 0] for vv in v], dim=0))
    return (torch.cat(means, dim=1) / y_scale,
            torch.cat(variances, dim=1) / (y_scale ** 2))


@torch.no_grad()
def predict_bank_mixture(bank, x_windows, batch_size: int = 8,
                         y_scale: float = 1.0):
    """Per-window mixture posterior: mean, var each (nw, ws), with the
    target scaling undone as in ``predict_bank_sources``."""
    means, variances = [], []
    for part, x, _ in _chunks(bank, x_windows, batch_size):
        m, v = part.predict_f(x, pre_centered=True)
        means.append(m[..., 0])
        variances.append(v[..., 0])
    return torch.cat(means) / y_scale, torch.cat(variances) / (y_scale ** 2)


def pitch_variances(bank) -> torch.Tensor:
    """Learned per-pitch variance per window, (num_pitches, nw)."""
    if isinstance(bank.kern, StackedSum):
        return bank.kern.stacked.variance.value.detach().mT
    return torch.stack([k.variance.value.detach() for k in bank.kern.kern_list])
