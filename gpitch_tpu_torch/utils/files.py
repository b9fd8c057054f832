"""Dataset filename helpers (MAPS-style corpora) and result merging.

A copy of gpitch_tpu/utils/files.py on the host (numpy): ``load_filenames``,
``merge_all_results``/``merge_all``, ``loadm``, ``load_pitch_params_data``
and ``append_sources``, every archive read with ``allow_pickle=False``.
"""

from __future__ import annotations

import fnmatch
import os

import numpy as np


__all__ = ["load_filenames", "merge_all_results", "merge_all",
           "append_sources", "loadm", "load_pitch_params_data"]


def load_filenames(directory, pattern, pitches=None, ext=".wav"):
    """Filter a directory for '*pattern*ext', optionally one file per MIDI
    pitch via the '_M<midi>_' MAPS convention (methods.py:183-190)."""
    names = fnmatch.filter(sorted(os.listdir(directory)), "*" + pattern + "*" + ext)
    if pitches is not None:
        names = [fnmatch.filter(names, f"*_M{p}_*")[0] for p in pitches]
    return np.asarray(names).reshape(-1)


def merge_all_results(inlist):
    """Transpose a per-segment list of result tuples into per-quantity lists of
    per-source segment lists (window_overlap.py:77-92): inlist[segment][quantity]
    [source] -> out[quantity][source][segment]."""
    nq = len(inlist[0])
    ns = len(inlist[0][0])
    return [[[seg[q][s] for seg in inlist] for s in range(ns)] for q in range(nq)]


# Reference name for the result-list transpose (window_overlap.py:77-92).
merge_all = merge_all_results


def loadm(directory, pattern=""):
    """Load every checkpointed object in ``directory`` matching ``pattern``
    -> (objects, filenames).  Rebuilds methods.py:16-23, with plain-array numpy
    archives instead of the reference's pickles; ``allow_pickle=False`` so no
    arbitrary code can execute on load."""
    names = sorted(f for f in os.listdir(directory) if pattern in f)
    objs = []
    for f in names:
        d = np.load(os.path.join(directory, f), allow_pickle=False)
        objs.append({k: d[k] for k in d.files} if hasattr(d, "files") else d)
    return objs, names


def load_pitch_params_data(pitch_list, data_loc, params_loc,
                           intensity="F", frames=32000, start=5000,
                           fs=16000.0):
    """Per-pitch MAPS training data + learned kernel params
    (methods.py:236-263, repaired: the reference calls undefined
    ``load_filename_list``/``wavread``).  Matches pitches against filenames by
    the MAPS '_M<midi>_' convention, reads ``frames`` samples from ``start``,
    loads 'params_act_<name>.npz' archives."""
    from ..audio.io import readaudio

    pitch_list = np.asarray(pitch_list).reshape(-1)
    wavs = sorted(f for f in os.listdir(data_loc) if f.endswith(".wav"))
    final_list, train_data, params = [], [], []
    for pitch in pitch_list:
        hits = [f for f in wavs if f"_M{int(pitch)}_" in f and intensity in f]
        if not hits:
            continue
        name = hits[0][:-4]
        final_list.append(name)
        x, y, _ = readaudio(os.path.join(data_loc, hits[0]),
                            frames=frames, start=start)
        train_data.append(y)
        ppath = os.path.join(params_loc, "params_act_" + name + ".npz")
        params.append(dict(np.load(ppath, allow_pickle=False))
                      if os.path.exists(ppath) else None)
    return np.asarray(final_list).reshape(-1), train_data, params


def _logistic(x):
    """``utils.math.logistic`` on the host: 1 / (1 + exp(-2 (x - pi)))."""
    return 0.5 * (np.tanh(np.asarray(x) - np.pi) + 1.0)


def append_sources(rmerged):
    """Per-window source estimates logistic(m_act) * m_com for 3 sources
    (window_overlap.py:95-103): rmerged[0]=activation means per source,
    rmerged[2]=component means per source."""
    out = []
    for s in range(3):
        out.append([_logistic(a) * np.asarray(c)
                    for a, c in zip(rmerged[0][s], rmerged[2][s])])
    return tuple(out)
