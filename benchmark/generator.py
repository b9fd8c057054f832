"""The benchmark's one traffic generator: seeded piano-like recordings.

A frozen copy of the synthetic notes and mixes the port was brought up on
(``audio/io.synth_piano_note`` and the separation and transcription mixes of
the port's smoke script), so that a later change to the program cannot move
the yardstick.  Everything here is host numpy and imports nothing of the
program.

A configuration gives the sample rate ``fs``, the length ``seconds``, the
``pitches``, the note shape (``notes``) and the onsets of one bar
(``score``), repeated every ``bar_seconds``.  The seed draws each note's partial phases
and noise and moves every onset by up to ``jitter_s``: every seed gives the
same number of samples, windows and notes, in another arrangement.
"""

from __future__ import annotations

import numpy as np

__all__ = ["f0_of", "piano_note", "make_recording", "job_seed"]


def f0_of(midi: int) -> float:
    return 440.0 * 2.0 ** ((midi - 69) / 12.0)


def piano_note(rng: np.random.Generator, fs: float, seconds: float, f0: float,
               num_partials: int = 8, inharmonicity: float = 3e-4,
               noise: float = 3e-4) -> np.ndarray:
    """An isolated piano-like note (fs * seconds samples): inharmonic
    decaying partials, amplitude k^-1.5, under a fast-attack exponential
    envelope, peak-normalized, plus seeded noise."""
    n = int(round(fs * seconds))
    tau = np.linspace(0.0, (n - 1.0) / fs, n)
    y = np.zeros(n)
    for k in range(1, num_partials + 1):
        fk = k * f0 * np.sqrt(1.0 + inharmonicity * k * k)
        decay = np.exp(-tau * (1.5 + 0.6 * k))
        y += k ** -1.5 * decay * np.sin(2 * np.pi * fk * tau + rng.uniform(0, 2 * np.pi))
    env = (1.0 - np.exp(-tau * 200.0)) * np.exp(-tau * 1.2)
    y = y * env
    peak = np.max(np.abs(y))
    y = y / (peak if peak > 0 else 1.0)
    if noise:
        y = y + noise * rng.standard_normal(n)
    return y


def job_seed(seed: int, job: int) -> list[int]:
    """The generator seed of job ``job`` of a run seeded ``seed``."""
    return [int(seed) & 0xFFFFFFFF, int(seed) >> 32, int(job)]


def make_recording(config: dict, seed) -> dict:
    """The configuration's recording drawn from ``seed`` (an int or a list
    of ints): {"fs", "x" (n,), "mix" (n,), "notes" {midi: isolated note},
    "onsets" [(midi, s)]}."""
    rec, score = config["notes"], config["score"]
    rng = np.random.default_rng(seed)
    fs, seconds = float(config["fs"]), float(config["seconds"])
    n = int(fs * seconds)
    pitches = list(config["pitches"])
    notes = {p: piano_note(rng, fs, rec["seconds"], f0_of(p),
                           num_partials=rec["num_partials"],
                           inharmonicity=rec["inharmonicity"], noise=rec["noise"])
             for p in pitches}
    bar, jitter = float(score["bar_seconds"]), float(score["jitter_s"])
    onsets = []
    for k in range(int(np.ceil(seconds / bar))):
        for p, on in score["onsets"]:
            t = on + k * bar
            shift = rng.uniform(-jitter, jitter)
            if t < seconds:          # which notes sound is the seed's to move, not to choose
                onsets.append((int(p), float(min(max(t + shift, 0.0), seconds - 1.0 / fs))))
    sources = {p: np.zeros(n) for p in pitches}
    for p, on in onsets:
        i0 = int(on * fs)
        seg = notes[p][: n - i0]
        sources[p][i0: i0 + len(seg)] += seg
    return {"fs": fs, "x": np.arange(n) / fs, "mix": sum(sources.values()),
            "notes": notes, "onsets": onsets}
