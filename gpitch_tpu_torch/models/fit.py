"""Adam training loops and the ModGP training entry point.

Counterpart of the Adam part of gpitch_tpu/models/fit.py.  ``Adam`` is
optax.adam's update (b1 = 0.9, b2 = 0.999, eps = 1e-8, eps_root = 0), the
same arithmetic as torch.optim.Adam's multi-tensor path.  It is written out
here because constructing the first torch.optim optimizer of a process
imports torch._dynamo and its dependencies (hundreds of modules), a one-time
cost of seconds that dwarfs a short training run.  The loss recorded at
step i is the loss before update i.  Only trainable Params are optimized;
the others hold tensors that need no gradient.

With a ``batch_fn`` (see ``minibatch_fn``) each step draws a fresh batch and
calls ``loss_fn(model, *batch)``; without one, ``loss_fn(model)``.  The JAX
package draws its batches with ``jax.random`` keys, which torch cannot
reproduce, so minibatch trajectories of the two packages differ; full-batch
ones agree.
"""

from __future__ import annotations

import math
import time
from typing import Callable

import numpy as np
import torch

from ..core.params import Param, map_params, trainable_tensors

__all__ = ["Adam", "minibatch_fn", "adam_segments", "first_segment_excess",
           "fit_adam", "fit_adam_segmented", "fit_adam_timed", "fit_modgp"]


class Adam:
    """Adam over a list of leaf tensors, one multi-tensor launch per stage
    of the update:

        m <- b1 m + (1 - b1) g,   v <- b2 v + (1 - b2) g^2
        p <- p - lr / (1 - b1^t) * m / (sqrt(v / (1 - b2^t)) + eps)
    """

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        grads = [p.grad for p in self.params]
        torch._foreach_lerp_(self.m, grads, 1.0 - self.b1)
        torch._foreach_mul_(self.v, self.b2)
        torch._foreach_addcmul_(self.v, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_sqrt(self.v)
        torch._foreach_div_(denom, math.sqrt(1.0 - self.b2 ** self.t))
        torch._foreach_add_(denom, self.eps)
        torch._foreach_addcdiv_(self.params, self.m, denom,
                                value=-self.lr / (1.0 - self.b1 ** self.t))


def minibatch_fn(x: torch.Tensor, y: torch.Tensor, size: int,
                 generator: torch.Generator | None = None) -> Callable:
    """batch_fn() -> (x[idx], y[idx]) with ``size`` indices drawn uniformly
    with replacement by ``generator``, a torch.Generator on the data's
    device (seeded with 0 when none is given).  The generator is kept as
    ``batch_fn.generator``."""
    n = x.shape[0]
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)

    def batch_fn():
        idx = torch.randint(n, (size,), generator=generator, device=x.device)
        return x[idx], y[idx]

    batch_fn.generator = generator
    return batch_fn


def adam_segments(model, loss_fn: Callable, num_steps: int,
                  learning_rate: float = 0.005, batch_fn: Callable | None = None,
                  segment: int = 100):
    """``num_steps`` Adam steps on a copy of the model, as ceil(num_steps /
    segment) segments with one host fence (the losses' copy) at the end of
    each; between fences the losses stay on the device.  The caller's model
    is left unchanged, as the JAX package's fits leave theirs.  Returns
    (the trained copy, losses (num_steps,) numpy, the wall seconds of each
    segment)."""
    model = map_params(model, lambda p: Param(p.raw.detach().clone(), p.transform,
                                              p.trainable))
    params = trainable_tensors(model)
    optimizer = Adam(params, lr=learning_rate)
    out = torch.empty(num_steps, dtype=params[0].dtype, device=params[0].device)
    host = np.empty(num_steps)
    seconds = []
    segment = max(1, segment)
    for start in range(0, num_steps, segment):
        t0 = time.perf_counter()
        stop = min(start + segment, num_steps)
        for i in range(start, stop):
            optimizer.zero_grad()
            loss = loss_fn(model) if batch_fn is None else loss_fn(model, *batch_fn())
            loss.backward()
            optimizer.step()
            out[i] = loss.detach()
        host[start:stop] = out[start:stop].cpu().numpy()
        seconds.append(time.perf_counter() - t0)
    return model, host, seconds


def first_segment_excess(seconds) -> tuple[float, float]:
    """(first_s, run_s) of a run's segment times: first_s is the first
    segment's excess over the median of the others (eager torch compiles
    nothing, so this is what a first pass costs: CUDA module loads, the
    allocator's growth), 0 when there is no other segment; run_s the rest
    of the wall time."""
    if len(seconds) < 2:
        return 0.0, float(sum(seconds))
    first = max(seconds[0] - float(np.median(seconds[1:])), 0.0)
    return first, float(sum(seconds)) - first


def fit_adam(model, loss_fn: Callable, num_steps: int,
             learning_rate: float = 0.005, batch_fn: Callable | None = None):
    """``num_steps`` Adam steps on the model's trainable Params.  Returns
    (the trained copy, losses (num_steps,) numpy); the input is unchanged."""
    model, losses, _ = adam_segments(model, loss_fn, num_steps, learning_rate,
                                     batch_fn, segment=num_steps)
    return model, losses


def fit_adam_segmented(model, loss_fn: Callable, num_steps: int,
                       learning_rate: float = 0.005,
                       batch_fn: Callable | None = None, segment: int = 100):
    """fit_adam with a host fence every ``segment`` steps; the optimizer
    state threads through, so the trajectory equals fit_adam's.  Returns
    (model, losses numpy, first_s, run_s) as ``first_segment_excess``
    splits the segments' times."""
    model, losses, seconds = adam_segments(model, loss_fn, num_steps,
                                           learning_rate, batch_fn, segment)
    return (model, losses) + first_segment_excess(seconds)


def fit_adam_timed(model, loss_fn: Callable, num_steps: int,
                   learning_rate: float = 0.005, batch_fn: Callable | None = None):
    """fit_adam run twice from the same state (each run trains its own copy
    of the model, with the minibatch generator's state restored in
    between), each ending in one host fence.  Returns (model, losses,
    first_s, run_s): run_s is the second run's wall time, first_s the first
    run's excess over it."""
    generator = getattr(batch_fn, "generator", None)
    state = None if generator is None else generator.get_state()
    _, _, first = adam_segments(model, loss_fn, num_steps, learning_rate, batch_fn,
                                segment=num_steps)
    if generator is not None:
        generator.set_state(state)
    model, losses, run = adam_segments(model, loss_fn, num_steps, learning_rate,
                                       batch_fn, segment=num_steps)
    return model, losses, max(sum(first) - sum(run), 0.0), float(sum(run))


def fit_modgp(model, x, y, num_steps: int = 2000, method: str = "adam",
              learning_rate: float = 0.005, minibatch_size: int | None = 100,
              num_data: int | None = None, generator: torch.Generator | None = None,
              segment: int | None = 500):
    """Train a ModGP: minibatch Adam on ``loss(xb, yb, num_data)`` (full
    batch with ``minibatch_size=None``).  x, y go to the model's device and
    dtype.  Returns (model, losses numpy)."""
    if method == "natgrad_adam":
        raise NotImplementedError(
            "method='natgrad_adam': natural gradients (models/natgrad.py) are "
            "ROADMAP item 10, a later slice of the PyTorch port; use 'adam'")
    if method == "lbfgs":
        raise NotImplementedError(
            "method='lbfgs': on-device L-BFGS is ROADMAP item 11, a later "
            "slice of the PyTorch port; use 'adam'")
    if method != "adam":
        raise ValueError(f"unknown method {method!r}")
    raw = model.za.raw
    x = torch.as_tensor(x, dtype=raw.dtype, device=raw.device)
    y = torch.as_tensor(y, dtype=raw.dtype, device=raw.device)
    n = num_data if num_data is not None else x.shape[0]
    batch_fn = minibatch_fn(x, y, minibatch_size, generator) if minibatch_size else None

    def loss_fn(m, *batch):
        return m.loss(*(batch or (x, y)), num_data=n)

    model, losses, _, _ = fit_adam_segmented(
        model, loss_fn, num_steps, learning_rate, batch_fn,
        segment=max(1, min(segment or num_steps, num_steps)))
    return model, losses
