"""Overlap windows and Hann overlap-add merging (host numpy).

A copy of the parts of gpitch_tpu/audio/windowing.py that separation uses:
windows of ``ws`` samples with hop ll = (ws - 1) // 2; a symmetric Hann
window gives interior weights that sum to 1, and the first and last
windows are flattened on their outer halves.
"""

from __future__ import annotations

import numpy as np

__all__ = ["hann", "num_windows", "window_stack", "ola_weights",
           "overlap_add", "merged_mean", "merged_variance"]


def hann(ws: int) -> np.ndarray:
    """Symmetric Hann window."""
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(ws) / (ws - 1.0)))


def num_windows(n: int, ws: int) -> int:
    ll = (ws - 1) // 2
    return (n - ws) // ll + 1


def window_stack(y, ws: int) -> np.ndarray:
    """(nw, ws) overlap windows of y, through the native framer when it is
    enabled (as the JAX package dispatches)."""
    from .. import native
    y = np.asarray(y).reshape(-1)
    if native.enabled():
        return native.frame_windows(y, ws).astype(y.dtype, copy=False)
    ll = (ws - 1) // 2
    nw = num_windows(y.shape[0], ws)
    idx = np.arange(nw)[:, None] * ll + np.arange(ws)[None, :]
    return y[idx]


def ola_weights(nw: int, ws: int, squared: bool = False) -> np.ndarray:
    """(nw, ws) overlap-add weights: Hann, first/last windows flattened on
    their outer halves; squared for variances."""
    ll = (ws - 1) // 2
    W = np.tile(hann(ws), (nw, 1))
    if nw > 0:
        W[0, :ll] = 1.0
        W[-1, -ll:] = 1.0
    return W ** 2 if squared else W


def overlap_add(windows, n: int, weights) -> np.ndarray:
    """Weighted overlap-add of (nw, ws) windows with hop (ws - 1) // 2 -> (n,)."""
    windows = np.asarray(windows)
    nw, ws = windows.shape
    ll = (ws - 1) // 2
    idx = (np.arange(nw)[:, None] * ll + np.arange(ws)[None, :]).reshape(-1)
    contrib = windows * weights
    out = np.zeros((n,), dtype=contrib.dtype)
    np.add.at(out, idx, contrib.reshape(-1))
    return out


def merged_mean(y, ws: int, n: int) -> np.ndarray:
    """Hann overlap-add of (nw, ws) posterior means -> (n, 1)."""
    y = np.asarray(y)
    return overlap_add(y, n, ola_weights(y.shape[0], ws)).reshape(-1, 1)


def merged_variance(y, ws: int, n: int) -> np.ndarray:
    """Hann^2 overlap-add of (nw, ws) posterior variances -> (n, 1)."""
    y = np.asarray(y)
    return overlap_add(y, n, ola_weights(y.shape[0], ws, squared=True)).reshape(-1, 1)
