"""MAPS ground-truth piano rolls (host numpy).

A copy of gpitch_tpu/audio/pianoroll.py: parse a MAPS annotation table
(OnsetTime / OffsetTime / MidiPitch) into per-pitch binary activations
sampled at ``fs`` Hz and an 88 x T matrix (MIDI 21..108, highest pitch
first).
"""

from __future__ import annotations

import csv
import os

import numpy as np

__all__ = ["Pianoroll", "read_note_table"]

MIDI_LO, MIDI_HI = 21, 109  # the piano's range


def read_note_table(path):
    """Rows of (onset, offset, midi) from a MAPS .txt annotation file."""
    rows = []
    with open(path, "r") as fh:
        reader = csv.reader(fh, delimiter="\t")
        header = next(reader)
        cols = {name.strip(): i for i, name in enumerate(header)}
        i_on, i_off = cols["OnsetTime"], cols["OffsetTime"]
        i_pitch = cols["MidiPitch"]
        for row in reader:
            if not row or not row[0].strip():
                continue
            rows.append((float(row[i_on]), float(row[i_off]), int(float(row[i_pitch]))))
    return rows


class Pianoroll:
    """Binary piano roll at ``fs`` Hz (20 by default), from a MAPS file
    (``path``, ``filename``) or from ``notes`` [(onset, offset, midi)]."""

    def __init__(self, path=None, filename=None, fs=20, duration=10.0, notes=None):
        self.path = path
        self.duration = duration
        self.fs = fs
        self.xn = int(round(duration * fs))
        self.x = np.linspace(0.0, (self.xn - 1.0) / fs, self.xn).reshape(-1, 1)
        self.pr_dic = {str(i): np.zeros((self.xn, 1)) for i in range(MIDI_LO, MIDI_HI)}

        if notes is None and filename is not None:
            self.name = self._resolve_name(filename)
            notes = read_note_table(os.path.join(self.path or "", self.name))
        else:
            self.name = "unnamed"
            notes = notes or []

        # notes whose onset lies inside the duration
        notes = [r for r in notes if r[0] < self.duration]
        self.pitch_list = sorted({r[2] for r in notes})

        for onset, offset, midi in notes:
            key = str(midi)
            if key in self.pr_dic:
                m = (onset <= self.x) & (self.x < offset)
                self.pr_dic[key][m] = 1.0

        # 88 x T, highest pitch on top
        mat = [self.pr_dic[str(p)].copy() for p in range(MIDI_LO, MIDI_HI)]
        self.matrix = np.flipud(np.asarray(mat).reshape(88, -1))

    def _resolve_name(self, filename):
        stem = filename[:-4] if filename.endswith(".wav") else filename
        if os.path.exists(os.path.join(self.path or "", stem + ".txt")):
            return stem + ".txt"
        base = self.path or "."
        for cand in sorted(os.listdir(base)):
            if cand.endswith(".txt") and stem in cand:
                return cand
        raise FileNotFoundError(f"no annotation .txt for {filename} in {base}")
