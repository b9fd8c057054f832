"""Training loops (Adam, L-BFGS) and the ModGP training entry point.

Counterpart of gpitch_tpu/models/fit.py.  ``Adam`` is
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

``lbfgs_solve`` and ``fit_lbfgs`` run the batched L-BFGS of ``_lbfgs``
(optax's L-BFGS and zoom linesearch, written out) on a model's trainable
raw leaves, as one problem; the window bank runs one problem per window
(``pipelines.windowed_sgpr``).  The returned model is the best-visited
state, and the caller's model is left unchanged.
"""

from __future__ import annotations

import math
import time
from typing import Callable

import numpy as np
import torch

from ..core.params import Param, copy_params, map_params, trainable_tensors
from ._lbfgs import lbfgs_run

__all__ = ["Adam", "adam_step_fn", "minibatch_fn", "adam_segments", "first_segment_excess",
           "fit_adam", "fit_adam_segmented", "fit_adam_timed", "ParamRows",
           "lbfgs_solve", "fit_lbfgs", "fit_modgp"]


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
        self.commit(*self.propose([p.grad for p in self.params]))

    @torch.no_grad()
    def propose(self, grads):
        """The next step's (params, m, v), out of place: a step that may
        be discarded (see ``commit``)."""
        t = self.t + 1
        m = torch._foreach_lerp(self.m, grads, 1.0 - self.b1)
        v = torch._foreach_mul(self.v, self.b2)
        torch._foreach_addcmul_(v, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_sqrt(v)
        torch._foreach_div_(denom, math.sqrt(1.0 - self.b2 ** t))
        torch._foreach_add_(denom, self.eps)
        params = torch._foreach_addcdiv(self.params, m, denom,
                                        value=-self.lr / (1.0 - self.b1 ** t))
        return params, m, v

    @torch.no_grad()
    def commit(self, params, m, v) -> None:
        """Take a proposed step: the params in place, the moments, and one
        more count."""
        torch._foreach_copy_(self.params, params)
        self.m, self.v = m, v
        self.t += 1


def adam_step_fn(loss_fn: Callable, optimizer: Adam) -> Callable:
    """step((model, optimizer), batch) -> ((model, optimizer), loss): one
    step of ``optimizer`` (an ``Adam`` over ``trainable_tensors(model)``,
    which holds the moments and the count and updates the leaves in place)
    on ``loss_fn(model, *batch)``; the loss is the value before the
    update."""

    def step(carry, batch=()):
        model, _ = carry
        optimizer.zero_grad()
        loss = loss_fn(model, *batch)
        loss.backward()
        optimizer.step()
        return (model, optimizer), loss.detach()

    return step


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
    model = copy_params(model)
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


class ParamRows:
    """A copy of ``model`` whose trainable raw leaves are read and written
    as one (B, D) tensor, with ``loss_fn(model)`` and its gradient as
    functions of it.  With ``batched`` every leaf's leading axis is the
    problem axis (a window bank: ``loss_fn`` gives one value per window and
    the gradient of their sum gives each window's gradient); without it the
    model is one problem (B = 1).  Untrainable leaves take no part, which
    gives the directions and norms of the JAX package's
    ``zero_untrainable_grads``."""

    def __init__(self, model, loss_fn: Callable, batched: bool):
        self.model = copy_params(model)
        self.loss_fn = loss_fn
        self.leaves = trainable_tensors(self.model)
        self.b = self.leaves[0].shape[0] if batched else 1
        self.sizes = [t.numel() // self.b for t in self.leaves]

    def rows(self, model=None) -> torch.Tensor:
        """The (B, D) rows of ``model`` (this copy when None)."""
        leaves = self.leaves if model is None else trainable_tensors(model)
        return torch.cat([t.detach().reshape(self.b, -1) for t in leaves], 1)

    def _load(self, w: torch.Tensor) -> None:
        with torch.no_grad():
            for t, part in zip(self.leaves, w.split(self.sizes, 1)):
                t.copy_(part.reshape(t.shape))

    def value_and_grad(self, w: torch.Tensor):
        self._load(w)
        with torch.enable_grad():
            loss = self.loss_fn(self.model)
            grads = torch.autograd.grad(loss.sum(), self.leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(self.leaves, grads)]
        return (loss.detach().reshape(self.b),
                torch.cat([g.reshape(self.b, -1) for g in grads], 1))

    def value(self, w: torch.Tensor) -> torch.Tensor:
        self._load(w)
        with torch.no_grad():
            return self.loss_fn(self.model).reshape(self.b)

    def model_at(self, w: torch.Tensor):
        """A new model with the trainable leaves of ``w``."""
        parts = iter(w.split(self.sizes, 1))
        return map_params(self.model, lambda p: Param(
            (next(parts).reshape(p.raw.shape) if p.trainable else p.raw).detach().clone(),
            p.transform, p.trainable))


def lbfgs_solve(model, loss_fn: Callable, num_steps: int = 1000,
                memory_size: int = 20, grad_tol: float = 1e-9,
                opt_state=None, return_state: bool = False,
                active_steps: int | None = None, best_in=None):
    """``num_steps`` iterations of L-BFGS with optax's zoom linesearch on
    the model's trainable leaves (``loss_fn(model)`` a scalar).

    The loss recorded at step i is the value before update i.  The solver
    freezes once the gradient norm is <= ``grad_tol``, an update is not
    finite, or the step reaches ``active_steps``.  The returned model is
    the best-visited state (the final state's value is evaluated once and
    compared too).  ``opt_state``/``return_state`` and ``best_in`` thread
    the solver state and the (best model, best value) pair across calls,
    so segments of a solve equal the whole solve.  Returns (best model,
    losses numpy), with ``return_state`` (last model, losses, state, (best
    model, best value)).  The caller's model is left unchanged."""
    rows = ParamRows(model, loss_fn, batched=False)
    w = rows.rows()
    best = None
    if best_in is not None:
        best = (rows.rows(best_in[0]),
                torch.as_tensor(best_in[1], dtype=w.dtype, device=w.device).reshape(1))
    w, losses, state, (best_w, best_v), _ = lbfgs_run(
        rows.value_and_grad, rows.value, w, num_steps, memory_size, grad_tol,
        opt_state, active_steps, best)
    losses = losses[0].cpu().numpy()
    if return_state:
        return rows.model_at(w), losses, state, (rows.model_at(best_w), best_v[0])
    return rows.model_at(best_w), losses


def fit_lbfgs(model, loss_fn: Callable, num_steps: int = 1000,
              memory_size: int = 20, grad_tol: float = 1e-9):
    """L-BFGS over the whole model (see ``lbfgs_solve``): the counterpart
    of the reference's scipy L-BFGS-B.  Returns (best model, losses)."""
    return lbfgs_solve(model, loss_fn, num_steps=num_steps,
                       memory_size=memory_size, grad_tol=grad_tol)


def fit_modgp(model, x, y, num_steps: int = 2000, method: str = "adam",
              learning_rate: float = 0.005, minibatch_size: int | None = 100,
              num_data: int | None = None, generator: torch.Generator | None = None,
              segment: int | None = 500, **kw):
    """Train a ModGP; x, y go to the model's device and dtype.  Returns
    (model, losses numpy), with what ``kw`` asks of the method (e.g.
    ``return_info``).

    method:
      * "adam"          minibatch Adam on ``loss(xb, yb, num_data)`` (full
                        batch with ``minibatch_size=None``), a host fence
                        every ``segment`` steps;
      * "natgrad_adam"  natural-gradient steps on the variational banks
                        alternating with Adam on the hyperparameters
                        (``natgrad.fit_natgrad_adam``, ``kw`` passed on);
      * "lbfgs"         full-batch L-BFGS (``fit_lbfgs``, ``kw`` passed on).
    """
    raw = model.za.raw
    x = torch.as_tensor(x, dtype=raw.dtype, device=raw.device)
    y = torch.as_tensor(y, dtype=raw.dtype, device=raw.device)
    n = num_data if num_data is not None else x.shape[0]
    batch_fn = minibatch_fn(x, y, minibatch_size, generator) if minibatch_size else None
    segment = max(1, min(segment or num_steps, num_steps))

    if method == "adam":
        def loss_fn(m, *batch):
            return m.loss(*(batch or (x, y)), num_data=n)

        model, losses, _, _ = fit_adam_segmented(
            model, loss_fn, num_steps, learning_rate, batch_fn, segment=segment, **kw)
        return model, losses
    if method == "natgrad_adam":
        from .natgrad import fit_natgrad_adam
        return fit_natgrad_adam(model, x, y, num_steps=num_steps,
                                learning_rate=learning_rate, num_data=n,
                                batch_fn=batch_fn, segment=segment, **kw)
    if method == "lbfgs":
        return fit_lbfgs(model, lambda m: m.loss(x, y, num_data=n),
                         num_steps=num_steps, **kw)
    raise ValueError(f"unknown method {method!r}")
