"""The numbers that decide ``correct``, each held to a limit of its own.

A leaf is one kind of parameter (variance, energy, frequency, noise,
lengthscale) of one window: every window is a problem of its own.  A gap
of norms is taken by the worst leaf: the gap between the program's norm of
the leaf and the reference's, over the larger of the reference's norm of
that leaf and the median leaf's.  The change a fit makes is compared over
the parameters that ``moved`` keeps.
"""

from __future__ import annotations

import json
import os

import numpy as np

__all__ = ["leaf_norms", "worst_leaf_gap", "max_rel", "moved",
           "load_limits", "judge"]


def leaf_norms(leaves: dict, keep: dict | None = None) -> np.ndarray:
    """(nw, kinds) norms of each window's part of each named leaf, over
    the elements ``keep`` (by name, boolean, the leaf's shape) keeps."""
    out = []
    for k, v in sorted(leaves.items()):
        v = np.asarray(v, dtype=np.float64)
        if keep is not None:
            v = np.where(keep[k], v, 0.0)
        out.append(np.linalg.norm(v.reshape(v.shape[0], -1), axis=1))
    return np.stack(out, 1)


def moved(ref_grad: dict) -> dict:
    """The parameters whose reference gradient is not nought to rounding:
    at least a thousandth of the median magnitude of its kind's.  Adam
    moves every parameter by about its learning rate whatever its
    gradient's size, so where the gradient is nought to rounding the
    float32 program and the reference step in directions that round-off
    alone chooses."""
    out = {}
    for k, g in ref_grad.items():
        g = np.abs(np.asarray(g, dtype=np.float64))
        out[k] = g >= 1e-3 * np.median(g)
    return out


def worst_leaf_gap(prog: dict, ref: dict, keep: dict | None = None) -> float:
    """max over leaves of |norm(prog) - norm(ref)| / max(norm(ref), the
    median leaf's norm), the norms over the parameters ``keep`` keeps."""
    a, b = leaf_norms(prog, keep), leaf_norms(ref, keep)
    gap = np.abs(a - b) / np.maximum(b, np.median(b))
    return float(np.max(gap))


def max_rel(prog, ref) -> float:
    """max |program - reference| over max |reference|."""
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(prog - ref)) / np.max(np.abs(ref)))


def load_limits(root: str, workload: str) -> dict:
    """The cell's limits, ``limits/<workload>.json`` beside this file:
    {number: limit}."""
    with open(os.path.join(root, "limits", f"{workload}.json")) as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(every reading finite and within its limit, {name: {"value",
    "limit"}}); a reading without a limit, or a limit without a reading,
    fails."""
    names = sorted(set(readings) | set(limits))
    out = {n: {"value": readings.get(n), "limit": limits.get(n)} for n in names}
    ok = all(r["value"] is not None and r["limit"] is not None
             and np.isfinite(r["value"]) and r["value"] <= r["limit"] for r in out.values())
    return ok, out
