"""Checkpoints of models, optimizer states and learned kernel parameters.

Counterpart of gpitch_tpu/utils/checkpoint.py: plain-array numpy archives,
no object arrays, so every load runs with ``allow_pickle=False`` and a
checkpoint file cannot execute code when it is read.

``save_params``/``load_params`` use the JAX package's keys, so a file
written by either package loads in the other.  ``save_model`` stores each
leaf of a tree under its path: a Param's raw under the path
``core.params.named_params`` gives it (the JAX pytree path without the
leaf index, which ``load_raw`` reads), and tensors, arrays and numbers in
tuples, lists, dicts and dataclasses likewise, e.g. ``[1]['m'][0]`` for the
first moment of an optimizer state in a ``(bank, state)`` pair.  A sha256
fingerprint of the paths, shapes and dtypes guards the restore.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Any

import numpy as np
import torch

from ..core.params import Param

__all__ = ["save_params", "load_params", "save_model", "load_model",
           "list_checkpoints"]


def save_params(path: str, lengthscale, energy, frequency, xkern=None, skern=None):
    """Per-pitch kernel hyperparameters (and, when given, the sampled
    kernels): one plain array per (quantity, pitch) key."""
    n = len(lengthscale)
    data = {"n_pitches": np.asarray(n)}
    for i in range(n):
        data[f"lengthscale_{i}"] = np.asarray(lengthscale[i])
        data[f"energy_{i}"] = np.asarray(energy[i])
        data[f"frequency_{i}"] = np.asarray(frequency[i])
        if xkern is not None:
            data[f"xkern_{i}"] = np.asarray(xkern[i])
        if skern is not None:
            data[f"skern_{i}"] = np.asarray(skern[i])
    np.savez(path, **data)


def load_params(path: str):
    """-> [lengthscales, energies, frequencies], one list entry a pitch."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    d = np.load(path, allow_pickle=False)
    n = int(d["n_pitches"])
    return [[d[f"lengthscale_{i}"] for i in range(n)],
            [d[f"energy_{i}"] for i in range(n)],
            [d[f"frequency_{i}"] for i in range(n)]]


def _leaves(obj, prefix: str = ""):
    """(path, leaf) for every leaf of the tree: a Param's raw tensor, a
    tensor, an array or a number."""
    if isinstance(obj, Param):
        yield prefix, obj.raw
    elif isinstance(obj, (torch.Tensor, np.ndarray, int, float, np.number)):
        yield prefix, obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            if not f.metadata.get("static"):
                yield from _leaves(getattr(obj, f.name), f"{prefix}.{f.name}")
    elif isinstance(obj, (tuple, list)):
        for i, c in enumerate(obj):
            yield from _leaves(c, f"{prefix}[{i}]")
    elif isinstance(obj, dict):
        for k, c in obj.items():
            yield from _leaves(c, f"{prefix}[{k!r}]")


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _fingerprint(model: Any) -> str:
    """sha256 of every leaf's path, shape and dtype."""
    desc = ";".join(f"{path}:{tuple(_host(leaf).shape)}:{_host(leaf).dtype}"
                    for path, leaf in _leaves(model))
    return hashlib.sha256(desc.encode()).hexdigest()


def save_model(directory: str, model: Any, step: int = 0):
    """Checkpoint a tree as ``<directory>/<step>.npz``: each leaf under its
    path, with the structure's fingerprint."""
    os.makedirs(directory, exist_ok=True)
    arrays = {path: _host(leaf) for path, leaf in _leaves(model)}
    np.savez(os.path.join(directory, f"{step}.npz"),
             __fingerprint__=np.asarray(_fingerprint(model)), **arrays)


def _rebuild(obj, arrays, prefix: str = ""):
    """A copy of ``obj`` with every leaf taken from ``arrays`` by path, in
    the leaf's own dtype and on its own device."""
    if isinstance(obj, Param):
        raw = torch.as_tensor(arrays[prefix], dtype=obj.raw.dtype).to(obj.raw.device)
        return Param(raw, obj.transform, obj.trainable)
    if isinstance(obj, torch.Tensor):
        return torch.as_tensor(arrays[prefix], dtype=obj.dtype).to(obj.device)
    if isinstance(obj, np.ndarray):
        return np.asarray(arrays[prefix], dtype=obj.dtype)
    if isinstance(obj, (int, float, np.number)):
        return type(obj)(arrays[prefix][()])
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _rebuild(getattr(obj, f.name), arrays, f"{prefix}.{f.name}")
            for f in dataclasses.fields(obj) if not f.metadata.get("static")})
    if isinstance(obj, (tuple, list)):
        return type(obj)(_rebuild(c, arrays, f"{prefix}[{i}]") for i, c in enumerate(obj))
    if isinstance(obj, dict):
        return {k: _rebuild(c, arrays, f"{prefix}[{k!r}]") for k, c in obj.items()}
    return obj


def load_model(directory: str, like: Any, step: int = 0):
    """Restore ``<directory>/<step>.npz`` into the structure of ``like``;
    a checkpoint of another structure (paths, shapes or dtypes) raises
    ValueError."""
    d = np.load(os.path.join(directory, f"{step}.npz"), allow_pickle=False)
    if "__fingerprint__" in d.files:
        want = str(d["__fingerprint__"])
        have = _fingerprint(like)
        if want != have:
            raise ValueError(
                "checkpoint structure mismatch: the saved tree's paths/leaf "
                f"shapes (fingerprint {want[:12]}…) do not match `like` "
                f"({have[:12]}…)")
    missing = [path for path, _ in _leaves(like) if path not in d.files]
    if missing:
        raise ValueError(f"checkpoint lacks the leaves {missing[:5]}")
    return _rebuild(like, {path: d[path] for path, _ in _leaves(like)})


def list_checkpoints(directory: str):
    """The steps of the checkpoints in ``directory``, in order."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(f[:-4]) for f in os.listdir(directory)
                  if f.endswith(".npz") and f[:-4].isdigit())
