"""Training loops (Adam, L-BFGS) and the ModGP training entry point.

Counterpart of gpitch_tpu/models/fit.py.  ``Adam`` is
optax.adam's update (b1 = 0.9, b2 = 0.999, eps = 1e-8, eps_root = 0), the
same arithmetic as torch.optim.Adam's multi-tensor path.  It is written out
here because constructing the first torch.optim optimizer of a process
imports torch._dynamo and its dependencies (hundreds of modules), a one-time
cost of seconds that dwarfs a short training run.  The loss recorded at
step i is the loss before update i.  Only trainable Params are optimized;
the others hold tensors that need no gradient.  ``AdamSteps`` runs the
steps: on the card one captured CUDA graph of a step, replayed, as the JAX
package runs one compiled segment; on the CPU the same step eagerly.

With a ``batch_fn`` (see ``minibatch_fn``) each step draws a fresh batch and
calls ``loss_fn(model, *batch)``; without one, ``loss_fn(model)``.  The JAX
package draws its batches with ``jax.random`` keys, which torch cannot
reproduce, so minibatch trajectories of the two packages differ; full-batch
ones agree.

``lbfgs_solve`` and ``fit_lbfgs`` run the batched L-BFGS of ``_lbfgs``
(optax's L-BFGS and zoom linesearch, written out; on the card an iteration
is a replay of captured CUDA graphs, ``_lbfgs.LbfgsSteps``) on a model's
trainable raw leaves, as one problem; the window bank runs one problem per
window (``pipelines.windowed_sgpr``).  The returned model is the best-visited
state, and the caller's model is left unchanged.
"""

from __future__ import annotations

import gc
import time
from typing import Callable

import numpy as np
import torch

from ..core.params import Param, copy_params, map_params, named_params, trainable_tensors
from ..linalg import _cuda
from ..utils.profiling import span
from ._lbfgs import lbfgs_run

__all__ = ["Adam", "CapturedSteps", "AdamSteps", "adam_step_fn", "minibatch_fn",
           "adam_segments", "first_segment_excess",
           "fit_adam", "fit_adam_segmented", "fit_adam_timed", "ParamRows",
           "lbfgs_solve", "fit_lbfgs", "fit_modgp"]


def _sqrt_rn(a: torch.Tensor) -> torch.Tensor:
    """sqrt of a float64 tensor, correctly rounded as ``math.sqrt`` is:
    torch's CPU sqrt of float64 may be an ulp off.  One Newton correction,
    s + (a - s^2) / 2s, with a - s^2 exact (Dekker's product of s by
    itself, Sterbenz's difference)."""
    s = torch.sqrt(a)
    c = s * 134217729.0                          # 2^27 + 1: Veltkamp's split
    hi = c - (c - s)
    lo = s - hi
    p = s * s
    e = ((hi * hi - p) + 2.0 * hi * lo) + lo * lo
    return s + ((a - p) - e) / (2.0 * s)


class Adam:
    """Adam over a list of leaf tensors, one multi-tensor launch per stage
    of the update:

        m <- b1 m + (1 - b1) g,   v <- b2 v + (1 - b2) g^2
        p <- p - lr / (1 - b1^t) * m / (sqrt(v / (1 - b2^t)) + eps)

    The count t is a 0-d int64 tensor on the leaves' device, and the bias
    corrections are computed there from it in float64 and rounded once to
    the leaves' type, as the Python scalars of the host count were: the
    update reads nothing from the host, so a CUDA graph can capture it.
    ``commit`` writes the leaves, the moments and the count in place.
    """

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        device = self.params[0].device
        self.t = torch.zeros((), dtype=torch.int64, device=device)
        self._neg_lr = torch.full((), -lr, dtype=torch.float64, device=device)

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
        t = self.t.double() + 1.0
        dtype = self.params[0].dtype
        bc2 = _sqrt_rn(1.0 - torch.pow(self.b2, t)).to(dtype)
        step = self._neg_lr.div(1.0 - torch.pow(self.b1, t)).to(dtype)
        m = torch._foreach_lerp(self.m, grads, 1.0 - self.b1)
        v = torch._foreach_mul(self.v, self.b2)
        torch._foreach_addcmul_(v, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_sqrt(v)
        torch._foreach_div_(denom, bc2)
        torch._foreach_add_(denom, self.eps)
        # p + (step m) / denom: addcdiv's association, with a tensor step
        update = torch._foreach_mul(m, step)
        torch._foreach_div_(update, denom)
        params = torch._foreach_add(self.params, update)
        return params, m, v

    @torch.no_grad()
    def commit(self, params, m, v, ok: torch.Tensor | None = None) -> None:
        """Take a proposed step: the params, the moments and one more count,
        all in place.  With ``ok`` (a 0-d bool on the leaves' device) the
        step is taken only where it holds, decided on the device: otherwise
        every leaf, moment and the count keep their values."""
        if ok is not None:
            params, m, v = ([torch.where(ok, a, b) for a, b in zip(new, old)]
                            for new, old in ((params, self.params), (m, self.m),
                                             (v, self.v)))
        torch._foreach_copy_(self.params, params)
        torch._foreach_copy_(self.m, m)
        torch._foreach_copy_(self.v, v)
        self.t.add_(1 if ok is None else ok)

    @torch.no_grad()
    def reset(self) -> None:
        """Moments and count back to 0, in place."""
        torch._foreach_zero_(self.m)
        torch._foreach_zero_(self.v)
        self.t.zero_()


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


_SIDE_STREAMS: dict = {}


def _side_stream(device) -> torch.cuda.Stream:
    """The one side stream of ``device`` on which every warm-up step and
    capture runs: a new stream would get cuBLAS a new workspace (kept for
    the process) and a capture its own copies of the per-stream state."""
    device = torch.device(device)
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


class CapturedSteps:
    """Steps that read nothing from the host, run as the JAX package runs a
    compiled segment.  A subclass gives ``step()``, which writes its
    results into static tensors and its loss at the step count into
    ``losses``, and draws its batch, if any, from ``batch_fn()``.

    On the card the first ``WARMUP`` steps run eagerly on a side stream, as
    steps of the trajectory: they fill what a step reads once (cuBLAS's
    handles, the fused kernels' split plans, the kernels' modules, cached
    constants).  Then one step is captured as a CUDA graph, the counterpart
    of JAX's one compile, and every later step replays it; a minibatch
    draw's generator is registered with the graph, so each replay draws the
    next batch.  A capture that fails raises.  On the CPU every step runs
    eagerly, the plain version of the capture.

    A step that sums over gloo ranks (a ModGP whose sources are split,
    ``parallel.mesh``) holds host all-reduces, which no graph can: its
    capture is split at each (``mesh.HOST_POINTS``) into graphs captured
    one after another in one memory pool, so that autograd's graph runs
    across them (a backward needs no collective: ``_SumOverRanks``'s is
    the identity).  A replay runs the graphs in their order and, between
    two, copies the all-reduce's input into pinned host memory, waits on
    one event, all-reduces there and copies the sum into the static tensor
    the next graph reads: one fence a host point (``host_points``).

    Counters of the run (never of a step): ``eager_steps`` (the card's
    warm-up; every step on the CPU), ``warmup_s`` (the host seconds of the
    card's warm-up), ``captures``, ``capture_s`` and ``replays``.
    """

    WARMUP = 3

    def __init__(self, losses: torch.Tensor, batch_fn: Callable | None = None):
        self.losses, self.batch_fn = losses, batch_fn
        self.at = 0                    # the count, as the host knows it
        self.eager_steps = 0           # steps ``run`` ran eagerly
        self.warmup_s = 0.0            # host seconds of the card's warm-up
        self.captures = 0
        self.replays = 0
        self.graphs = []               # the captured step's graphs, in their order
        self.points = []               # the host all-reduces between them
        self.pool = None               # the graphs' memory pool (None: their own)
        self.capture_s = 0.0           # host seconds of the capture
        self.calls = {}                # kernel wrapper -> its calls in the graph

    @property
    def graph(self):
        """The captured step's (first) graph, None before the capture."""
        return self.graphs[0] if self.graphs else None

    @property
    def host_points(self) -> int:
        """Host all-reduces (fences) in a captured step."""
        return len(self.points)

    def nodes(self) -> int:
        """The captured step's graph nodes, over all its graphs."""
        return sum(_cuda.graph_nodes(g) for g in self.graphs)

    def step(self) -> None:
        raise NotImplementedError

    def eager(self, n: int) -> None:
        """``n`` steps run eagerly: the plain version of the captured step,
        which the CPU runs and the card's checks hold the capture against."""
        for _ in range(n):
            self.step()
        self.at += n

    def run(self, n: int) -> None:
        """``n`` more steps, with no host fence but one at each host point
        of a split step."""
        if not self.losses.is_cuda:
            self.eager_steps += n
            return self.eager(n)
        self.at += n
        if self.graph is None:
            warm = min(n, self.WARMUP - self.eager_steps)
            if warm > 0:
                t0 = time.perf_counter()
                with span("gpitch.fit.warmup"):
                    side = _side_stream(self.losses.device)
                    side.wait_stream(torch.cuda.current_stream())
                    with torch.cuda.stream(side):
                        for _ in range(warm):
                            self.step()
                    torch.cuda.current_stream().wait_stream(side)
                self.warmup_s += time.perf_counter() - t0
                self.eager_steps += warm
                n -= warm
            if n == 0:
                return
            self._capture()
        with span("gpitch.fit.replay"):
            for _ in range(n):
                self.replay()
        self.replays += n
        _cuda.record_replays(self.calls, n)

    def replay(self) -> None:
        """One captured step."""
        self.graphs[0].replay()
        for graph, point in zip(self.graphs[1:], self.points):
            point.all_reduce()
            graph.replay()

    def _capture(self) -> None:
        from ..parallel import mesh
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        generator = getattr(self.batch_fn, "generator", None)
        if generator is not None:
            graph.register_generator_state(generator)
        pool = self.pool if self.pool is not None else torch.cuda.graph_pool_handle()
        graphs, points = [graph], []

        def split(x: torch.Tensor, group) -> torch.Tensor:
            # a host point: this graph ends, the next begins, and the sum's
            # static tensor stands for x's sum in it
            graphs[-1].capture_end()
            points.append(_HostPoint(x, group))
            graphs.append(torch.cuda.CUDAGraph(keep_graph=True))
            graphs[-1].capture_begin(pool=pool)
            return points[-1].out.clone()

        before = _cuda.launch_counts()
        t0 = time.perf_counter()
        with span("gpitch.fit.capture"):
            # as torch.cuda.graph does: no garbage left whose freeing inside
            # the capture would query events of other streams; and no
            # collection during it
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.empty_cache()
            collecting = gc.isenabled()
            gc.disable()
            side = _side_stream(self.losses.device)
            side.wait_stream(torch.cuda.current_stream())
            mesh.HOST_POINTS.append(split)
            try:
                with torch.cuda.stream(side):
                    graph.capture_begin(pool=pool)
                    try:
                        self.step()
                    finally:
                        graphs[-1].capture_end()
            finally:
                mesh.HOST_POINTS.pop()
                if collecting:
                    gc.enable()
            torch.cuda.current_stream().wait_stream(side)
            for g in graphs:
                g.instantiate()
        self.graphs, self.points = graphs, points
        self.capture_s = time.perf_counter() - t0
        self.captures += 1
        after = _cuda.launch_counts()
        self.calls = {k: n - before.get(k, 0) for k, n in after.items()
                      if n != before.get(k, 0)}
        _cuda.record_capture(self.calls, len(self.points))


class _HostPoint:
    """A gloo all-reduce between two graphs of a split step: ``x`` the
    static tensor the graph before it leaves, ``out`` the one the graph
    after it reads, and a pinned host buffer between them."""

    def __init__(self, x: torch.Tensor, group):
        self.x, self.group = x, group
        self.out = torch.empty_like(x)
        self.host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        self.ready = torch.cuda.Event()

    def all_reduce(self) -> None:
        import torch.distributed as dist
        self.host.copy_(self.x, non_blocking=True)
        self.ready.record()
        self.ready.synchronize()
        dist.all_reduce(self.host, group=self.group)
        self.out.copy_(self.host, non_blocking=True)


class AdamSteps(CapturedSteps):
    """The counterpart of the JAX package's jitted Adam segment
    (``fit_adam_segmented``): Adam on ``model``'s trainable leaves, trained
    in place, with the count on the device and the loss of step t written
    at index t of ``losses`` (``num_steps`` long), so that a step reads
    nothing from the host and writes nothing to it; on the card one step
    captured and replayed (``CapturedSteps``).  ``load`` puts another model
    of the same structure into the static leaves with a fresh Adam state,
    so one capture serves every chunk of a window bank, as one executable
    serves them in the JAX package.  The fits hand it a copy of the caller's
    model: leaves that a live autograd graph of other steps still holds
    would tie the capture to the stream those steps ran on.
    """

    def __init__(self, model, loss_fn: Callable, num_steps: int,
                 learning_rate: float, batch_fn: Callable | None = None):
        self.model, self.loss_fn = model, loss_fn
        self.leaves = [p.raw for _, p in named_params(model)]
        self.optimizer = Adam(trainable_tensors(model), lr=learning_rate)
        p = self.optimizer.params[0]
        super().__init__(torch.zeros(num_steps, dtype=p.dtype, device=p.device), batch_fn)

    def step(self) -> None:
        """One step: the loss and its gradient, the loss written at the
        count, then Adam (which adds one to the count)."""
        opt = self.optimizer
        opt.zero_grad()
        batch = () if self.batch_fn is None else self.batch_fn()
        loss = self.loss_fn(self.model, *batch)
        loss.backward()
        with torch.no_grad():
            self.losses.index_copy_(0, opt.t.reshape(1),
                                    loss.detach().reshape(1).to(self.losses.dtype))
        opt.step()

    def _capture(self) -> None:
        self.optimizer.zero_grad()
        super()._capture()

    def segments(self, num_steps: int, segment: int):
        """``num_steps`` steps from the count on, with one host fence (the
        losses' copy) every ``segment`` steps.  Returns (their losses numpy,
        the wall seconds of each segment)."""
        host, seconds = np.empty(num_steps), []
        for start in range(0, num_steps, max(1, segment)):
            t0 = time.perf_counter()
            n = min(segment, num_steps - start)
            self.run(n)
            with span("gpitch.fit.fence"):
                host[start:start + n] = self.losses[self.at - n:self.at].cpu().numpy()
            seconds.append(time.perf_counter() - t0)
        return host, seconds

    @torch.no_grad()
    def load(self, model, count: int = 0) -> None:
        """``model``'s raw leaves (the structure of this one's) into the
        static leaves, the moments set to 0 and the count to ``count``."""
        for leaf, (_, p) in zip(self.leaves, named_params(model)):
            leaf.copy_(p.raw)
        self.optimizer.reset()
        self.optimizer.t.fill_(count)
        self.at = count

    def result(self):
        """The trained model, its gradients dropped."""
        self.optimizer.zero_grad()
        return self.model


def adam_segments(model, loss_fn: Callable, num_steps: int,
                  learning_rate: float = 0.005, batch_fn: Callable | None = None,
                  segment: int = 100):
    """``num_steps`` Adam steps (``AdamSteps``) on a copy of the model, as
    ceil(num_steps / segment) segments with one host fence (the losses'
    copy) at the end of each; between fences the losses stay on the device.
    The caller's model is left unchanged, as the JAX package's fits leave
    theirs.  Returns (the trained copy, losses (num_steps,) numpy, the wall
    seconds of each segment)."""
    run = AdamSteps(copy_params(model), loss_fn, num_steps, learning_rate, batch_fn)
    losses, seconds = run.segments(num_steps, max(1, segment))
    return run.result(), losses, seconds


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
    """fit_adam run twice from the same state (the model loaded again and
    the minibatch generator's state restored in between), each run ending
    in one host fence.  On the card the second run replays the first run's
    captured step throughout, as the JAX package's second run re-invokes
    its compiled scan.  Returns (model, losses, first_s, run_s): run_s is
    the second run's wall time, first_s the first run's excess over it."""
    generator = getattr(batch_fn, "generator", None)
    state = None if generator is None else generator.get_state()
    run = AdamSteps(copy_params(model), loss_fn, num_steps, learning_rate, batch_fn)
    _, first = run.segments(num_steps, num_steps)
    run.load(model)
    if generator is not None:
        generator.set_state(state)
    losses, second = run.segments(num_steps, num_steps)
    return run.result(), losses, max(sum(first) - sum(second), 0.0), float(sum(second))


class ParamRows:
    """A copy of ``model`` whose trainable raw leaves are read and written
    as one (B, D) tensor, with ``loss_fn(model)`` and its gradient as
    functions of it.  With ``batched`` every leaf's leading axis is the
    problem axis (a window bank: ``loss_fn`` gives one value per window and
    the gradient of their sum gives each window's gradient); without it the
    model is one problem (B = 1).  Untrainable leaves take no part, which
    gives the directions and norms of the JAX package's
    ``zero_untrainable_grads``.  The leaves are static, and so are the
    values and gradients the functions return (written in place, read
    before the next call): a CUDA graph of a solver that calls them reads
    and writes the same memory at every replay."""

    def __init__(self, model, loss_fn: Callable, batched: bool):
        self.model = copy_params(model)
        self.loss_fn = loss_fn
        self.leaves = trainable_tensors(self.model)
        self.b = self.leaves[0].shape[0] if batched else 1
        self.sizes = [t.numel() // self.b for t in self.leaves]
        w = self.rows()
        self.value_out, self.grad_out = w.new_empty(self.b), torch.empty_like(w)

    def rows(self, model=None) -> torch.Tensor:
        """The (B, D) rows of ``model`` (this copy when None)."""
        leaves = self.leaves if model is None else trainable_tensors(model)
        return torch.cat([t.detach().reshape(self.b, -1) for t in leaves], 1)

    @torch.no_grad()
    def load(self, model) -> None:
        """Every raw leaf of ``model`` (this copy's structure and shapes)
        into this copy's leaves."""
        for (_, mine), (_, p) in zip(named_params(self.model), named_params(model)):
            mine.raw.copy_(p.raw)

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
        with torch.no_grad():
            self.value_out.copy_(loss.reshape(self.b))
            torch.cat([g.reshape(self.b, -1) for g in grads], 1, out=self.grad_out)
        return self.value_out, self.grad_out

    def value(self, w: torch.Tensor) -> torch.Tensor:
        self._load(w)
        with torch.no_grad():
            return self.value_out.copy_(self.loss_fn(self.model).reshape(self.b))

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
    model, best value)).  The caller's model is left unchanged.

    A ModGP whose sources are split over ranks (``source_group``) is one
    problem across them: every inner product and finite test of the solver
    is summed over the ranks, the replicated noise variance counted once,
    so every rank takes the decisions of one process.  On the card that
    needs an NCCL group (its all-reduces are captured); over gloo it raises
    ValueError."""
    from ..parallel.mesh import on_host, source_row_reduce
    rows = ParamRows(model, loss_fn, batched=False)
    w = rows.rows()
    group = getattr(model, "source_group", None)
    if group is not None and w.is_cuda and on_host(group):
        raise ValueError(
            "L-BFGS over a ModGP whose sources are split over gloo ranks cannot run "
            "on the card: every inner product of the solver is a host all-reduce, "
            "and the captured iteration's conditional graphs can hold none; use an "
            "NCCL group, or the CPU")
    best = None
    if best_in is not None:
        best = (rows.rows(best_in[0]),
                torch.as_tensor(best_in[1], dtype=w.dtype, device=w.device).reshape(1))
    w, losses, state, (best_w, best_v), _ = lbfgs_run(
        rows.value_and_grad, rows.value, w, num_steps, memory_size, grad_tol,
        opt_state, active_steps, best, reduce=source_row_reduce(rows.model))
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
