"""Audio input and the synthetic piano note (host numpy).

A copy of gpitch_tpu/audio/io.py's ``read_wav`` and ``synth_piano_note``.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["read_wav", "synth_piano_note"]

_PCM_SCALE = {np.dtype(np.int16): 32768.0, np.dtype(np.int32): 2147483648.0,
              np.dtype(np.uint8): 128.0}


def read_wav(path):
    """(samples float64 array, fs) for PCM 8/16/32-bit and float WAVs, through
    the native decoder when it is enabled, else scipy."""
    from .. import native
    if isinstance(path, (str, os.PathLike)) and native.enabled():
        try:
            return native.wav_read(os.fspath(path))
        except (IOError, RuntimeError):
            pass  # an encoding the decoder does not take: scipy below
    from scipy.io import wavfile
    fs, data = wavfile.read(path)
    data = np.asarray(data)
    if data.dtype in _PCM_SCALE:
        offset = 128.0 if data.dtype == np.uint8 else 0.0
        data = (data.astype(np.float64) - offset) / _PCM_SCALE[data.dtype]
    else:
        data = data.astype(np.float64)
    return data, fs


def synth_piano_note(fs=16000, seconds=2.0, f0=261.626, onset=0.0,
                     num_partials=8, inharmonicity=3e-4, noise=3e-4, seed=0):
    """Piano-like isolated note: inharmonic decaying partials under a
    fast-attack, exponential-decay envelope, peak-normalized, plus a little
    seeded noise.  Returns (x, y) column vectors of fs * seconds samples."""
    n = int(round(fs * seconds))
    t = np.linspace(0.0, (n - 1.0) / fs, n)
    tau = np.maximum(t - onset, 0.0)
    rng = np.random.default_rng(seed)
    y = np.zeros(n)
    for k in range(1, num_partials + 1):
        fk = k * f0 * np.sqrt(1.0 + inharmonicity * k * k)
        amp = k ** -1.5
        decay = np.exp(-tau * (1.5 + 0.6 * k))
        y += amp * decay * np.sin(2 * np.pi * fk * tau + rng.uniform(0, 2 * np.pi))
    env = (1.0 - np.exp(-tau * 200.0)) * np.exp(-tau * 1.2)
    y = y * env * (t >= onset)
    peak = np.max(np.abs(y))
    y = y / (peak if peak > 0 else 1.0)
    if noise:
        y = y + noise * rng.standard_normal(n)
    return t.reshape(-1, 1), y.reshape(-1, 1)
