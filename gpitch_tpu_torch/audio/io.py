"""Audio input, test signals and the windowed audio container (host numpy).

A copy of gpitch_tpu/audio/io.py.
"""

from __future__ import annotations

import os

import numpy as np

from .windowing import segmented, windowed

__all__ = ["read_wav", "readaudio", "Audio", "synth_tone", "synth_piano_note"]

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


def readaudio(fname, frames=-1, start=0, aug=False, scaled=False):
    """(x, y, fs): a mono column vector from ``start`` for ``frames``
    samples, optionally peak-normalized and left-padded with 1000 zeros,
    and its time vector."""
    y, fs = read_wav(fname)
    if y.ndim == 2:
        y = y.mean(axis=1)
    y = y.reshape(-1, 1)
    if start:
        y = y[start:]
    if frames is not None and frames > 0:
        y = y[:frames]
    if scaled:
        beta = np.max(np.abs(y))
        y = y / (beta if beta != 0.0 else 1.0)
    if aug:
        y = np.concatenate([np.zeros((1000, 1)), y], axis=0)
    n = y.shape[0]
    return np.linspace(0.0, (n - 1.0) / fs, n).reshape(-1, 1), y, fs


def synth_tone(fs=16000, seconds=1.0, freq=440.0):
    """(x, cos(2 pi freq x)) column vectors of fs * seconds samples."""
    n = int(round(fs * seconds))
    x = np.linspace(0.0, (n - 1.0) / fs, n).reshape(-1, 1)
    return x, np.cos(2.0 * np.pi * freq * x)


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


class Audio:
    """A recording (or, without ``path``, a 1 s 440 Hz tone at 16 kHz) and
    its windows ``X``, ``Y``: lists of (ws, 1) arrays, 50%-overlap frames
    when ``overlap`` else disjoint segments."""

    def __init__(self, path=None, filename=None, frames=-1, start=0, scaled=False,
                 window_size=None, overlap=True, aug=False):
        self.path = path
        if path is None:
            self.name = "unnamed"
            self.fs = 16000
            self.x, self.y = synth_tone(self.fs, 1.0, 440.0)
        else:
            self.read(filename=filename, frames=frames, start=start, scaled=scaled,
                      aug=aug)
        self.wsize = window_size if window_size is not None else self.x.shape[0]
        self.X, self.Y = self.windowed(overlap)

    def read(self, filename, frames=-1, start=0, scaled=False, aug=False):
        self.name = filename
        self.x, self.y, self.fs = readaudio((self.path or "") + filename, frames=frames,
                                            start=start, scaled=scaled, aug=aug)

    def windowed(self, overlap=True):
        self.X, self.Y = (windowed if overlap else segmented)(self.x, self.y, self.wsize)
        return self.X, self.Y
