"""FFT peak picking for the kernel initialization (host numpy).

A copy of gpitch_tpu/audio/spectrum.py: ``peak_indexes``, ``init_cparam``
and ``get_features``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["peak_indexes", "init_cparam", "get_features"]


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


def get_features(f, s, f_centers=None, nfpc: int = 1, use_centers: bool = True,
                 totalnumf: int = 10):
    """Kernel features from an FFT (frequencies f, magnitudes s): ``nfpc``
    bins around each harmonic center, or the global top ``totalnumf`` bins.
    Returns (frequency, energy), energies normalized to sum 1."""
    f = np.asarray(f).reshape(-1)
    s = np.asarray(s).reshape(-1)
    if use_centers:
        freq_l, var_l = [], []
        for fc in np.asarray(f_centers).reshape(-1):
            idx = int(np.argmin(np.abs(f - fc)))
            sl = (slice(idx, idx + 1) if nfpc == 1
                  else slice(max(idx - nfpc // 2, 0), idx + nfpc // 2))
            freq_l.append(f[sl])
            var_l.append(s[sl])
        frequency = np.concatenate(freq_l)
        energy = np.concatenate(var_l)
        return frequency, energy / np.sum(energy)
    idx = np.argsort(s)[::-1][:totalnumf]
    energy = s[idx].copy()
    return f[idx].copy(), energy / np.sum(energy)
