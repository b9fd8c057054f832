"""Music-math helpers (host numpy): a copy of gpitch_tpu/utils/math.py's
``midi2freq``, ``freq2midi`` and ``find_ideal_f0``."""

from __future__ import annotations

import numpy as np

__all__ = ["midi2freq", "freq2midi", "find_ideal_f0"]


def midi2freq(midi):
    return 2.0 ** ((np.asarray(midi, dtype=float) - 69.0) / 12.0) * 440.0


def freq2midi(freq):
    return int(69.0 + 12.0 * np.log2(float(freq) / 440.0))


def find_ideal_f0(names):
    """f0 of every MIDI number written like 'M60' in the names."""
    out = []
    for name in names:
        for midi in range(21, 109):
            if f"M{midi}" in name:
                out.append(midi2freq(midi))
    return out
