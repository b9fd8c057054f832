"""Overlap windows and Hann overlap-add merging (host numpy).

A copy of gpitch_tpu/audio/windowing.py: windows of ``ws`` samples with
hop ll = (ws - 1) // 2; a symmetric Hann window gives interior weights
that sum to 1, and the first and last windows are flattened on their
outer halves.  Also disjoint segments, zero-padding augmentation and the
merges back to whole signals.
"""

from __future__ import annotations

import numpy as np

__all__ = ["hann", "windowed", "segmented", "augmentate", "trim_n_merge",
           "num_windows", "window_stack", "ola_weights", "overlap_add",
           "merged_mean", "merged_variance", "merged_x", "merged_y",
           "get_results_arrays", "get_results_arrays_noov"]


def hann(ws: int) -> np.ndarray:
    """Symmetric Hann window."""
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(ws) / (ws - 1.0)))


def num_windows(n: int, ws: int) -> int:
    ll = (ws - 1) // 2
    return (n - ws) // ll + 1


def windowed(x, y, ws: int):
    """50%-overlap framing, hop (ws - 1) // 2: lists of (ws, 1) windows."""
    x = np.asarray(x).reshape(-1, 1)
    y = np.asarray(y).reshape(-1, 1)
    ll = (ws - 1) // 2
    nw = num_windows(x.shape[0], ws)
    return ([x[i * ll: i * ll + ws].copy() for i in range(nw)],
            [y[i * ll: i * ll + ws].copy() for i in range(nw)])


def segmented(x, y, window_size: int = 32000, aug: bool = False):
    """Disjoint segments of ``window_size`` samples, optionally augmented."""
    x = np.asarray(x).reshape(-1, 1)
    y = np.asarray(y).reshape(-1, 1)
    xs, ys = [], []
    for i in range(y.shape[0] // window_size):
        xa = x[i * window_size:(i + 1) * window_size].copy()
        ya = y[i * window_size:(i + 1) * window_size].copy()
        if aug:
            xa, ya = augmentate(xa, ya)
        xs.append(xa)
        ys.append(ya)
    return xs, ys


def augmentate(x, y, augment_size: int = 1600, fs: float = 16000.0):
    """Zero-pad both ends and extend the time vector to match."""
    zeros = np.zeros((augment_size, 1))
    yaug = np.concatenate([zeros, np.asarray(y).reshape(-1, 1), zeros], axis=0)
    alpha = augment_size / fs
    x = np.asarray(x).reshape(-1)
    xaug = np.linspace(float(x[0]) - alpha, float(x[-1]) + alpha,
                       x.size + 2 * augment_size).reshape(-1, 1)
    return xaug, yaug


def trim_n_merge(windows, trim_size: int = 1600, aug: bool = True):
    """Trim the augmentation padding and concatenate."""
    parts = [np.asarray(w).reshape(-1, 1) for w in windows]
    return np.concatenate([w[trim_size:-trim_size] if aug else w for w in parts], axis=0)


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
    """Hann overlap-add of (nw, ws) posterior means (or a list of (ws, 1)
    windows) -> (n, 1)."""
    y = _asarray2d(y)
    return overlap_add(y, n, ola_weights(y.shape[0], ws)).reshape(-1, 1)


def merged_variance(y, ws: int, n: int) -> np.ndarray:
    """Hann^2 overlap-add of (nw, ws) posterior variances -> (n, 1)."""
    y = _asarray2d(y)
    return overlap_add(y, n, ola_weights(y.shape[0], ws, squared=True)).reshape(-1, 1)


def merged_x(x, ws: int) -> np.ndarray:
    """The window time vectors merged back into one, (n, 1)."""
    ll = (ws - 1) // 2
    nw = len(x)
    out = np.zeros(ll * (nw - 1) + ws)
    out[:ws] = np.asarray(x[0]).reshape(-1)
    for i in range(1, nw):
        out[i * ll: i * ll + ws] = np.asarray(x[i]).reshape(-1)
    return out.reshape(-1, 1)


def merged_y(y, ws: int) -> np.ndarray:
    """Hann overlap-add of windows back into one signal, (n, 1): merging
    what ``windowed`` cut returns the signal."""
    windows = _asarray2d(y)
    n = (ws - 1) // 2 * (windows.shape[0] - 1) + ws
    return merged_mean(windows, ws, n)


def get_results_arrays(x, y, sl, ws: int):
    """Per-source window lists ``sl`` merged into whole signals: (x, y,
    [s_i]), each trimmed of its last sample."""
    s_trim = [merged_y(s, ws)[:-1].reshape(-1, 1) for s in sl]
    return merged_x(x, ws)[:-1].reshape(-1, 1), merged_y(y, ws)[:-1].reshape(-1, 1), s_trim


def get_results_arrays_noov(x, y, results, window_size: int):
    """The non-overlapping variant: every quantity of ``results`` as a list
    of column vectors."""
    out = [[np.asarray(src).reshape(-1, 1) for src in quantity] for quantity in results]
    return np.asarray(x).reshape(-1, 1), np.asarray(y).reshape(-1, 1), out


def _asarray2d(y) -> np.ndarray:
    if isinstance(y, (list, tuple)):
        return np.stack([np.asarray(w).reshape(-1) for w in y])
    y = np.asarray(y)
    return y if y.ndim == 2 else y.reshape(1, -1)
