"""FFT peak picking for the kernel initialization (host numpy).

A copy of gpitch_tpu/audio/spectrum.py's ``peak_indexes`` and
``init_cparam``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["peak_indexes", "init_cparam"]


def peak_indexes(y, thres: float = 0.3, min_dist: int = 1):
    """Strict local maxima above ``thres``, then greedy ``min_dist``
    suppression keeping the highest peaks first."""
    y = np.asarray(y).reshape(-1)
    if y.size < 3:
        return np.array([], dtype=int)
    mid = y[1:-1]
    cand = np.where((mid > y[:-2]) & (mid >= y[2:]) & (mid > thres))[0] + 1
    if cand.size == 0 or min_dist <= 1:
        return cand
    order = cand[np.argsort(y[cand])[::-1]]
    keep = np.zeros(y.size, dtype=bool)
    blocked = np.zeros(y.size, dtype=bool)
    for idx in order:
        if not blocked[idx]:
            keep[idx] = True
            lo, hi = max(0, idx - min_dist), min(y.size, idx + min_dist + 1)
            blocked[lo:hi] = True
    return np.sort(np.where(keep)[0])


def init_cparam(y, fs, maxh: int, ideal_f0: float, scaled: bool = True,
                thres: float = 0.1, min_dis: float = 0.8):
    """Component-kernel (frequency, energy) initialization from the FFT of an
    isolated note: peaks of the normalized log spectrum at least ~0.8 f0
    apart, none below 0.75 f0, the top ``maxh`` by energy, energies
    normalized to sum 1 when ``scaled``.

    Returns [frequencies, energies, F, S, threshold].
    """
    y = np.asarray(y).reshape(-1)
    n = y.size
    S = 2.0 / n * np.abs(np.fft.fft(y)[: n // 2])
    F = np.linspace(0.0, fs / 2.0, n // 2)

    logS = np.log(np.maximum(S, 1e-300))
    logS = logS + np.abs(np.min(logS))
    logS = logS / np.max(logS)

    thres_abs = thres * np.max(logS)
    min_dist = int(min_dis * np.argmin(np.abs(F - ideal_f0)))
    idx = peak_indexes(logS, thres=thres_abs, min_dist=max(min_dist, 1))

    f_star, s_star = F[idx], S[idx]
    keep = f_star >= 0.75 * ideal_f0
    f_star, s_star = f_star[keep], s_star[keep]
    if f_star.size == 0:  # degenerate input: fall back to the f0 bin
        f_star = np.array([ideal_f0])
        s_star = np.array([1.0])

    top = np.argsort(s_star)[::-1][:maxh]
    freqs, energies = f_star[top], s_star[top]
    if scaled:
        energies = energies / np.sum(energies)
    order = np.argsort(freqs)
    return [freqs[order], energies[order], F, S, thres_abs]
