"""Parameters of the port: a raw (unconstrained) tensor, a transform and a
trainable flag.

Counterpart of gpitch_tpu/core/params.py.  Models are plain dataclasses
whose fields are Params, sub-modules, tuples of modules or static metadata;
the helpers here walk that tree.  A Param that is not trainable holds a
tensor with ``requires_grad=False``, so it gets no gradient and no optimizer
update: the counterpart of ``zero_untrainable_grads``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Iterator

import numpy as np
import torch

from ..config import numpy_dtype
from .transforms import Identity, Positive, Transform

__all__ = ["Param", "named_params", "map_params", "map_named_params", "static_field", "trainable_tensors",
           "copy_params", "to_device", "take_windows", "cat_windows", "load_raw",
           "with_raw", "load_adam_state", "param", "positive_param", "module",
           "constrained", "n_params"]


class Param:
    """A (possibly array-valued) constrained parameter.

    ``raw`` is always a leaf tensor of its own; it requires grad iff the
    Param is trainable.
    """

    __slots__ = ("raw", "transform", "trainable")

    def __init__(self, raw: torch.Tensor, transform: Transform = Identity(),
                 trainable: bool = True):
        self.raw = raw.detach().requires_grad_(trainable)
        self.transform = transform
        self.trainable = trainable

    @classmethod
    def create(cls, value, transform: Transform = Identity(),
               trainable: bool = True, dtype: torch.dtype = torch.float32,
               device="cpu") -> "Param":
        """From a constrained host value; the inverse transform runs in numpy
        in ``dtype``, as the JAX package's does."""
        value = np.asarray(value, dtype=numpy_dtype(dtype))
        raw = np.asarray(transform.inverse(value), dtype=value.dtype)
        return cls(torch.as_tensor(raw, device=device), transform, trainable)

    @classmethod
    def wrap(cls, raw: torch.Tensor, transform: Transform = Identity(),
             trainable: bool = True) -> "Param":
        """A Param over ``raw`` as it is, not detached: a raw computed from
        other tensors, which a gradient flows back through."""
        p = cls.__new__(cls)
        p.raw, p.transform, p.trainable = raw, transform, trainable
        return p

    @property
    def value(self) -> torch.Tensor:
        return self.transform.forward(self.raw)

    def with_value(self, value) -> "Param":
        """This Param (transform, trainability, the raw's dtype and device)
        holding the constrained ``value``.  A tensor goes through the
        transform's inverse in torch into a computed raw (``wrap``), which a
        gradient flows back through, as the JAX package's inverse in jnp
        inside a traced function; a host value becomes a leaf of its own."""
        if isinstance(value, torch.Tensor):
            raw = self.transform.inverse_tensor(value.to(self.raw.dtype))
            return Param.wrap(raw, self.transform, self.trainable)
        return Param.create(value, self.transform, self.trainable, dtype=self.raw.dtype,
                            device=self.raw.device)

    def with_trainable(self, trainable: bool) -> "Param":
        """This Param's raw (the same storage) with ``trainable`` set."""
        return Param(self.raw, self.transform, trainable)

    def __repr__(self):
        return (f"Param(shape={tuple(self.raw.shape)}, transform={self.transform},"
                f" trainable={self.trainable})")


def _children(obj) -> Iterator[tuple[str, Any]]:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            if not f.metadata.get("static"):
                yield "." + f.name, getattr(obj, f.name)
    elif isinstance(obj, (tuple, list)):
        for i, c in enumerate(obj):
            yield f"[{i}]", c


def named_params(obj, prefix: str = "") -> Iterator[tuple[str, Param]]:
    """(path, Param) for every Param in the tree; paths read like the JAX
    package's pytree key strings without the trailing leaf index
    (``.kern.stacked.variance``)."""
    if isinstance(obj, Param):
        yield prefix, obj
        return
    for name, child in _children(obj):
        yield from named_params(child, prefix + name)


def map_named_params(obj, fn: Callable[[str, Param], Param], prefix: str = ""):
    """A copy of the tree with ``fn(path, param)`` applied to every Param
    (paths as in ``named_params``)."""
    if isinstance(obj, Param):
        return fn(prefix, obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changes = {f.name: map_named_params(getattr(obj, f.name), fn, prefix + "." + f.name)
                   for f in dataclasses.fields(obj)
                   if not f.metadata.get("static")}
        return dataclasses.replace(obj, **changes)
    if isinstance(obj, (tuple, list)):
        return type(obj)(map_named_params(c, fn, f"{prefix}[{i}]") for i, c in enumerate(obj))
    return obj


def with_raw(obj, leaves: dict):
    """A copy of the tree whose Params at the paths of ``leaves`` (as
    ``named_params`` gives them) take those tensors as their raws, not
    detached (``Param.wrap``): a gradient flows back to ``leaves``.  Raises
    on a path that names no Param."""
    unknown = set(leaves) - {name for name, _ in named_params(obj)}
    if unknown:
        raise KeyError(f"{sorted(unknown)} name no Param of the model")
    return map_named_params(obj, lambda name, p: Param.wrap(
        leaves[name], p.transform, p.trainable) if name in leaves else p)


def map_params(obj, fn: Callable[[Param], Param]):
    """A copy of the tree with ``fn`` applied to every Param."""
    return map_named_params(obj, lambda _, p: fn(p), "")


def param(value, trainable: bool = True, dtype: torch.dtype = torch.float32,
          device="cpu") -> Param:
    """An unconstrained Param from a host value."""
    return Param.create(value, Identity(), trainable, dtype, device)


def positive_param(value, trainable: bool = True, lower: float = 1e-6,
                   dtype: torch.dtype = torch.float32, device="cpu") -> Param:
    """A Param constrained above ``lower`` by a softplus."""
    return Param.create(value, Positive(lower=lower), trainable, dtype, device)


def module(cls):
    """Class decorator: a dataclass with a ``replace`` method, the form of
    every model of the port (fields made by ``static_field`` hold
    metadata, the others Params, sub-modules or tuples of them)."""
    cls = dataclasses.dataclass(cls)
    cls.replace = dataclasses.replace
    return cls


def constrained(obj):
    """The tree with every Param replaced by its constrained value (for
    inspection)."""
    return map_named_params(obj, lambda _, p: p.value.detach())


def n_params(obj) -> int:
    """The number of scalars in the tree's Params."""
    return int(sum(p.raw.numel() for _, p in named_params(obj)))


def static_field(default=None, **kw):
    """A dataclass field that holds metadata, not Params."""
    return dataclasses.field(default=default, metadata={"static": True}, **kw)


def trainable_tensors(obj) -> list[torch.Tensor]:
    return [p.raw for _, p in named_params(obj) if p.trainable]


def copy_params(obj):
    """A copy of the tree whose raw leaves are fresh copies."""
    return map_params(obj, lambda p: Param(p.raw.detach().clone(), p.transform,
                                           p.trainable))


def to_device(obj, device):
    return map_params(obj, lambda p: Param(p.raw.to(device), p.transform,
                                           p.trainable))


def take_windows(obj, sl: slice):
    """The tree restricted to windows ``sl`` of the leading (window) axis;
    the raw leaves are fresh copies."""
    return map_params(obj, lambda p: Param(p.raw.detach()[sl].clone(),
                                           p.transform, p.trainable))


def cat_windows(objs: list):
    """Inverse of ``take_windows`` over consecutive window ranges."""
    flat = [dict(named_params(o)) for o in objs]
    return map_named_params(objs[0], lambda name, p: Param(
        torch.cat([f[name].raw.detach() for f in flat], 0), p.transform,
        p.trainable), "")


_KEY_TOKEN = re.compile(r"\.(\w+)|\[(\d+)\]|\[<flat index \d+>\]")


def load_raw(model, leaves: dict) -> int:
    """Fill the model's raw leaves from host arrays keyed by JAX pytree path
    strings (``jax.tree_util.keystr`` of ``tree_flatten_with_path``), e.g.
    ``.kern.stacked.variance[<flat index 0>]``.  Raw layouts are the JAX
    package's, window axis first, so the copy is one-to-one.  Returns the
    number of leaves filled; raises on an unknown path or a shape mismatch.
    """
    n = 0
    for key, arr in leaves.items():
        obj = model
        for attr, idx in _KEY_TOKEN.findall(key):
            if attr:
                obj = getattr(obj, attr)
            elif idx:
                obj = obj[int(idx)]
        if not isinstance(obj, Param):
            raise KeyError(f"{key!r} does not name a Param of the model")
        src = torch.as_tensor(np.array(arr), dtype=obj.raw.dtype)
        if tuple(src.shape) != tuple(obj.raw.shape):
            raise ValueError(f"{key!r}: shape {tuple(src.shape)} != "
                             f"{tuple(obj.raw.shape)}")
        with torch.no_grad():
            obj.raw.copy_(src.to(obj.raw.device))
        n += 1
    return n


def load_adam_state(optimizer, model, mu: dict, nu: dict, count) -> None:
    """Carry a JAX ``optax.adam`` state into the port's ``models.fit.Adam``
    over ``model``'s trainable leaves: ``mu`` -> m, ``nu`` -> v, ``count``
    -> t, each written in place (t is the optimizer's 0-d count on the
    device).  ``mu`` and ``nu`` are keyed as ``load_raw``'s leaves (the
    moments have the model's own tree), so a run started in one package
    continues in the other from the same mid-run state."""
    moments = []
    for tree in (mu, nu):
        target = copy_params(model)
        load_raw(target, tree)
        moments.append(trainable_tensors(target))
    with torch.no_grad():
        torch._foreach_copy_(optimizer.m, moments[0])
        torch._foreach_copy_(optimizer.v, moments[1])
        optimizer.t.fill_(int(np.asarray(count)))
