"""L-BFGS with a zoom linesearch, batched over independent problems.

Counterpart of what gpitch_tpu/models/fit.py:lbfgs_solve takes from optax
(0.2.6): ``optax.lbfgs(memory_size)``, which chains ``scale_by_lbfgs``
(scaled identity, ring memory of the last ``memory_size`` differences),
``scale(-1)`` and ``scale_by_zoom_linesearch(max_linesearch_steps=20,
initial_guess_strategy='one')``, with ``value_and_grad_from_state``
reusing the linesearch's last value and gradient.  Written out in torch
(``torch.optim.LBFGS`` is another algorithm: strong Wolfe, no best state,
and its first use imports torch._dynamo).

Every problem is a flat parameter vector, a row of a (B, D) tensor, and
every scalar of the solver (the curvature weights, the identity scale, the
step size, the linesearch's low, high and safe values, done, failed) is a
(B,) tensor.  Each problem's linesearch advances on its own: at each trial
every problem still searching proposes its own step size and one batched
evaluation of value and gradient serves them all; a problem that is done
keeps its state.  This is what the JAX package gets from ``jax.vmap`` over
``lbfgs_solve`` (the per-window solvers of a window bank).

``LbfgsSteps`` keeps all of it in static device tensors, with the counts
on the device, and on the card replays an iteration from CUDA graphs whose
conditional nodes (CUDA IF nodes) decide on the device whether a problem
still needs an evaluation or a trial: the counterpart of the JAX package's
``lax.scan`` over iterations with the linesearch's bounded ``while_loop``
inside.  The host reads the losses and the counts at a segment's fence.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..utils.profiling import span

__all__ = ["LbfgsState", "LbfgsSteps", "lbfgs_run", "LbfgsStats"]

# optax.lbfgs's linesearch: scale_by_zoom_linesearch defaults
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INTERVAL_THRESHOLD = 1e-5
INCREASE_FACTOR = 2.0

# f(w (B, D)) -> (values (B,), gradients (B, D)); g(w) -> values (B,)
ValueAndGrad = Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]
Value = Callable[[torch.Tensor], torch.Tensor]
# x (B, D) -> (B,): the sums of the rows over every rank's share of them
# (``parallel.mesh.source_row_reduce``)
Reduce = Callable[[torch.Tensor], torch.Tensor]


def _vdot(a: torch.Tensor, b: torch.Tensor, reduce: Reduce | None = None) -> torch.Tensor:
    """The rows' inner products (B,); with ``reduce``, over every rank's
    share of the rows."""
    return (a * b).sum(-1) if reduce is None else reduce(a * b)


def _all_finite(x: torch.Tensor, reduce: Reduce | None = None) -> torch.Tensor:
    """Whether every entry of each row is finite (B,), on every rank."""
    if reduce is None:
        return torch.isfinite(x).all(-1)
    return reduce((~torch.isfinite(x)).to(x.dtype)) == 0


def _where(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Per-problem select: ``mask`` (B,) against (B, ...) tensors."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)), new, old)


@dataclasses.dataclass
class LbfgsState:
    """What the solver threads between iterations, per problem: optax's
    ScaleByLBFGSState (count, the last params and updates, the memories of
    their differences and the weights 1/<du, dw>) and the linesearch's
    carried value and gradient (its step size is not carried: each
    linesearch starts from 1)."""

    count: torch.Tensor           # (B,) int64
    params: torch.Tensor          # (B, D)
    updates: torch.Tensor         # (B, D)
    diff_params: torch.Tensor     # (B, m, D)
    diff_updates: torch.Tensor    # (B, m, D)
    weights: torch.Tensor         # (B, m)
    value: torch.Tensor           # (B,)
    grad: torch.Tensor            # (B, D)

    @classmethod
    def init(cls, w: torch.Tensor, memory_size: int = 20) -> "LbfgsState":
        b, d = w.shape
        zeros = torch.zeros_like(w)
        return cls(count=torch.zeros(b, dtype=torch.int64, device=w.device),
                   params=zeros, updates=zeros,
                   diff_params=w.new_zeros((b, memory_size, d)),
                   diff_updates=w.new_zeros((b, memory_size, d)),
                   weights=w.new_zeros((b, memory_size)),
                   value=w.new_full((b,), float("inf")), grad=zeros)

    def where(self, mask: torch.Tensor, other: "LbfgsState") -> "LbfgsState":
        """This state where ``mask``, ``other`` elsewhere."""
        return LbfgsState(**{f.name: _where(mask, getattr(self, f.name),
                                            getattr(other, f.name))
                             for f in dataclasses.fields(self)})


@dataclasses.dataclass
class LbfgsStats:
    """Counts of a run: iterations, linesearch trials (one batched value and
    gradient each), other batched evaluations (of value and gradient where
    a carried value was not finite; of the value alone for the final
    state), host reads (fences, and the conditionals of eager iterations),
    and the trials of each iteration."""

    iterations: int = 0
    trials: int = 0
    grad_evaluations: int = 0
    value_evaluations: int = 0
    syncs: int = 0
    trials_per_iteration: list = dataclasses.field(default_factory=list)


# ------------------------------------------------------------ the direction
def _direction(g: torch.Tensor, st: LbfgsState, w: torch.Tensor,
               reduce: Reduce | None = None):
    """scale_by_lbfgs: store (w - st.params, g - st.updates) in the ring
    memory and return (P g, the new memories), P the two-loop product
    (every inner product over the ranks with ``reduce``)."""
    b, m = st.weights.shape
    rows = torch.arange(b, device=w.device)
    idx = st.count % m
    prev = (st.count - 1) % m
    started = st.count > 0
    dw = _where(started, w - st.params, torch.zeros_like(w))
    du = _where(started, g - st.updates, torch.zeros_like(g))
    vd = _vdot(du, dw, reduce)
    weight = torch.where(vd == 0.0, torch.zeros_like(vd), 1.0 / vd)
    weight = torch.where(started, weight, torch.zeros_like(weight))
    dwm, dum, wm = st.diff_params.clone(), st.diff_updates.clone(), st.weights.clone()
    dwm[rows, prev] = dw
    dum[rows, prev] = du
    wm[rows, prev] = weight

    den = _vdot(du, du, reduce)
    scale = torch.where(den > 0.0, vd / den, torch.ones_like(den))
    capped = torch.minimum(torch.ones_like(den), 1.0 / torch.sqrt(_vdot(g, g, reduce)))
    scale = torch.where(started, scale, capped)

    # the memory from oldest to newest: slots idx, idx + 1, ... (mod m)
    order = (idx[:, None] + torch.arange(m, device=w.device)) % m
    odw = dwm.gather(1, order[..., None].expand(-1, -1, dwm.shape[-1]))
    odu = dum.gather(1, order[..., None].expand(-1, -1, dum.shape[-1]))
    orho = wm.gather(1, order)
    vec = g
    alphas = [None] * m
    for k in reversed(range(m)):
        alpha = orho[:, k] * _vdot(odw[:, k], vec, reduce)
        vec = vec + (-alpha)[:, None] * odu[:, k]
        alphas[k] = alpha
    vec = scale[:, None] * vec
    for k in range(m):
        beta = orho[:, k] * _vdot(odu[:, k], vec, reduce)
        vec = vec + (alphas[k] - beta)[:, None] * odw[:, k]
    return vec, (dwm, dum, wm)


# ------------------------------------------------------------ the linesearch
def _decrease_error(stepsize, value_step, slope_step, value_init, slope_init):
    """Armijo's error, or the approximate-decrease error (Hager and Zhang)
    where that is smaller and the value is within 1e-6 |f0| of f0; 0 when
    met, inf for NaN."""
    dec = value_step - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope_step - (2 * SLOPE_RTOL - 1.0) * slope_init
    delta = value_step - value_init - APPROX_DEC_RTOL * value_init.abs()
    dec = torch.minimum(torch.maximum(approx, delta), dec)
    dec = torch.maximum(dec, torch.zeros_like(dec))
    return torch.where(torch.isnan(dec), torch.full_like(dec, float("inf")), dec)


def _curvature_error(slope_step, slope_init):
    curv = slope_step.abs() - CURV_RTOL * slope_init.abs()
    curv = torch.maximum(curv, torch.zeros_like(curv))
    return torch.where(torch.isnan(curv), torch.full_like(curv, float("inf")), curv)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Minimizer of the cubic through (a, fa), (b, fb), (c, fc) with slope
    fpa at a (NaN where it has none)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    r1 = fb - fa - C * db
    r2 = fc - fa - C * dc
    A = (dc * dc * r1 + (-(db * db)) * r2) / denom
    B = ((-(dc * dc * dc)) * r1 + db * db * db * r2) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Minimizer of the quadratic through (a, fa), (b, fb) with slope fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * B)


def _zoom_middle(s: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """The zoom's next trial in [low, high] (cubic, else quadratic, else
    bisection) and whether the interval is below the threshold."""
    low, high = s["low"], s["high"]
    delta = (high - low).abs()
    left, right = torch.minimum(high, low), torch.maximum(high, low)
    mc = _cubicmin(low, s["value_low"], s["slope_low"], high, s["value_high"],
                   s["cubic_ref"], s["value_cubic_ref"])
    use_cubic = (mc > left + 0.2 * delta) & (mc < right - 0.2 * delta)
    mq = _quadmin(low, s["value_low"], s["slope_low"], high, s["value_high"])
    use_quad = ~use_cubic & (mq > left + 0.1 * delta) & (mq < right - 0.1 * delta)
    middle = torch.where(use_cubic, mc, s["cubic_ref"])
    middle = torch.where(use_quad, mq, middle)
    middle = torch.where(~use_cubic & ~use_quad, (low + high) / 2.0, middle)
    return middle, delta <= INTERVAL_THRESHOLD



_LS_FLOAT = ("stepsize", "value", "slope", "decrease_error", "low", "value_low",
             "slope_low", "high", "value_high", "slope_high", "cubic_ref",
             "value_cubic_ref", "safe_stepsize", "safe_value")
_LS_BOOL = ("interval_found", "done", "failed")
_LS_ROWS = ("grad", "safe_grad")


def _readback(*tensors: torch.Tensor) -> list:
    """The tensors on the host, as numpy arrays, after one wait: on the card
    each is copied into pinned memory without blocking, then the stream is
    synchronized once."""
    if not tensors[0].is_cuda:
        return [t.detach().numpy().copy() for t in tensors]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [h.numpy() for h in host]


class LbfgsSteps:
    """The counterpart of the JAX package's compiled L-BFGS segment: the
    solver's state, the linesearch's, the best-visited point, the losses
    (B, num_steps) and the counts live in static device tensors, indexed by
    an iteration count on the device, so that an iteration reads nothing
    from the host and writes nothing to it.

    An iteration is five parts: ``need`` (which problems carry a value that
    is not finite); ``evaluation``, where any does (optax's
    ``value_and_grad_from_state``); ``head`` (the loss written at the count,
    the best-visited update, the direction and the linesearch's start);
    ``trial``, ``MAX_LINESEARCH_STEPS`` times while any problem searches
    (one batched evaluation at w + step u and the zoom's update of every
    problem still searching; a problem that is done keeps its state bit
    for bit); ``tail`` (the update, the state's select, the count + 1).
    ``evaluation`` and ``trial`` leave everything as it was when no problem
    needs them, so running them anyway (the masked form) equals skipping
    them (the early-exit form).

    On the card the first ``WARMUP`` iterations run eagerly on a side
    stream (each condition a host read), as ``AdamSteps`` warms up; then
    each part is captured as a CUDA graph, all in one memory pool, and
    chained (``linalg._cuda.GraphChain``) into three graphs: need ->
    [IF any_need] evaluation -> head; [IF any_active] trial; tail.  The
    device decides each condition (a CUDA IF node), so an iteration is a
    replay of the first, ``MAX_LINESEARCH_STEPS`` replays of the second and
    one of the third, and a trial whose condition is false launches nothing:
    the counterpart of the vmapped ``while_loop`` that stops when the last
    problem is done.  A capture that fails raises.  On the CPU every
    iteration runs eagerly in the early-exit form, the plain version of the
    capture.  The host reads the losses and the counts at ``read`` (a
    segment's fence) and nothing else; ``stats.syncs`` counts every host
    read, the eager conditions' included.  ``load`` puts another start into
    the static tensors, so one capture serves every chunk of a window bank.
    """

    WARMUP = 1

    def __init__(self, f: ValueAndGrad, fvalue: Value, w: torch.Tensor, num_steps: int,
                 memory_size: int = 20, grad_tol: float = 1e-9,
                 stats: LbfgsStats | None = None, reduce: Reduce | None = None):
        self.f, self.fvalue, self.grad_tol, self.reduce = f, fvalue, grad_tol, reduce
        self.stats = LbfgsStats() if stats is None else stats
        b = w.shape[0]
        self.num_steps = num_steps
        self.w = w.detach().clone()
        fresh = LbfgsState.init(self.w, memory_size)     # its rows share one zeros
        self.state = LbfgsState(**{f.name: getattr(fresh, f.name).clone()
                                   for f in dataclasses.fields(fresh)})
        self.best_w, self.best_v = self.w.clone(), self.w.new_full((b,), float("inf"))
        flag = torch.zeros(b, dtype=torch.bool, device=w.device)
        self.nonfinite, self.need, self.searching, self.active = (flag.clone() for _ in range(4))
        self.any_need, self.any_active = flag[0].clone(), flag[0].clone()
        self.losses = w.new_zeros((b, num_steps))
        self.i = torch.zeros((), dtype=torch.int64, device=w.device)
        self.active_steps = torch.full_like(self.i, num_steps)
        # iterations, linesearch trials, evaluations of value and gradient
        # where a carried value was not finite, of the value alone
        self.counts = torch.zeros(4, dtype=torch.int64, device=w.device)
        self.trials = torch.zeros(num_steps, dtype=torch.int64, device=w.device)
        self.value, self.value_init, self.slope_init = (w.new_zeros(b) for _ in range(3))
        self.grad, self.u = torch.zeros_like(w), torch.zeros_like(w)
        self.memory = (torch.zeros_like(self.state.diff_params),
                       torch.zeros_like(self.state.diff_updates),
                       torch.zeros_like(self.state.weights))
        self.s = {"count": torch.zeros_like(self.i.expand(b))}
        self.s.update({k: w.new_zeros(b) for k in _LS_FLOAT})
        self.s.update({k: flag.clone() for k in _LS_BOOL})
        self.s.update({k: torch.zeros_like(w) for k in _LS_ROWS})
        self.parts = {}                # part -> its captured graph
        self.graphs = None             # the head, the trial and the tail chains
        self.capture_s = 0.0           # host seconds of the captures and the chains
        self.calls = {}                # part -> {kernel wrapper: calls in it}
        self.eager_iterations = 0
        self.counted = np.zeros(4, dtype=np.int64)     # counts as last read
        self.replayed = np.zeros(4, dtype=np.int64)    # counts whose replays are recorded

    # ------------------------------------------------------------ the parts
    def _if(self, pred: torch.Tensor, body: Callable[[], None]) -> bool:
        """``body`` where the 0-d bool ``pred`` holds, read on the host:
        the eager form of a CUDA IF node.  Returns whether it ran."""
        self.stats.syncs += 1
        if bool(pred):
            body()
            return True
        return False

    def _evaluate_need(self) -> None:
        v, g = self.f(self.w)
        self.value.copy_(torch.where(self.need, v, self.value))
        self.grad.copy_(_where(self.need, g, self.grad))
        self.counts[2:3].add_(self.any_need)

    def _head_need(self) -> None:
        st = self.state
        torch.logical_not(torch.isfinite(st.value), out=self.need)
        self.any_need.copy_(self.need.any())
        self.value.copy_(st.value)
        self.grad.copy_(st.grad)

    def _head(self) -> None:
        st, value, grad = self.state, self.value, self.grad
        self.losses.index_copy_(1, self.i.reshape(1), value[:, None])
        self.nonfinite.logical_or_(~torch.isfinite(value))
        better = torch.isfinite(value) & (value < self.best_v)
        self.best_w.copy_(_where(better, self.w, self.best_w))
        self.best_v.copy_(torch.where(better, value, self.best_v))
        run = self.i < self.active_steps
        self.counts[0:1].add_(run)
        torch.logical_and(torch.sqrt(_vdot(grad, grad, self.reduce)) > self.grad_tol, run,
                          out=self.searching)
        direction, memory = _direction(grad, st, self.w, self.reduce)
        torch.mul(direction, -1.0, out=self.u)
        for static, new in zip(self.memory, memory):
            static.copy_(new)
        # the linesearch's start: step 0, the value and slope at w
        s, slope = self.s, _vdot(self.u, grad, self.reduce)
        self.value_init.copy_(value)
        self.slope_init.copy_(slope)
        for key in ("count", "stepsize", "low", "high", "cubic_ref", "safe_stepsize"):
            s[key].zero_()
        for key in ("value", "value_low", "value_high", "value_cubic_ref", "safe_value"):
            s[key].copy_(value)
        for key in ("slope", "slope_low", "slope_high"):
            s[key].copy_(slope)
        s["grad"].copy_(grad)
        s["safe_grad"].copy_(grad)
        s["decrease_error"].fill_(float("inf"))
        s["interval_found"].zero_()
        s["failed"].zero_()
        torch.logical_not(self.searching, out=s["done"])
        self.active.copy_(self.searching)
        self.any_active.copy_(self.active.any())

    def _trial(self) -> None:
        """One trial of optax's zoom linesearch for every problem still
        searching (``active``); the others keep their state."""
        s, u, active = self.s, self.u, self.active
        value_init, slope_init = self.value_init, self.slope_init
        found = s["interval_found"]
        middle, too_small = _zoom_middle(s)
        grown = torch.where(s["count"] == 0, torch.ones_like(value_init),
                            INCREASE_FACTOR * s["stepsize"])
        step = torch.where(found, middle, grown)
        vt, gt = self.f(self.w + step[:, None] * u)
        self.counts[1:2].add_(self.any_active)
        self.trials.index_add_(0, self.i.reshape(1), self.any_active.reshape(1).long())
        self.nonfinite.logical_or_(active & ~torch.isfinite(vt))
        st_ = _vdot(gt, u, self.reduce)
        dec = _decrease_error(step, vt, st_, value_init, slope_init)
        err = torch.maximum(dec, _curvature_error(st_, slope_init))
        done = err <= 0.0
        last = s["count"] + 1 >= MAX_LINESEARCH_STEPS
        safe_dec = dec <= 0.0

        # interval search (Nocedal and Wright, algorithm 3.5)
        set_high = (dec > 0.0) | ((vt >= s["value"]) & (s["count"] > 0))
        set_low = (st_ >= 0.0) & ~set_high
        search = {
            "low": torch.where(set_low, step, s["stepsize"]),
            "value_low": torch.where(set_low, vt, s["value"]),
            "slope_low": torch.where(set_low, st_, s["slope"]),
            "high": torch.where(set_low, s["stepsize"], step),
            "value_high": torch.where(set_low, s["value"], vt),
            "slope_high": torch.where(set_low, s["slope"], st_),
            "interval_found": set_high | set_low | done,
            "failed": last & ~done,
            "safe": safe_dec}
        search["cubic_ref"], search["value_cubic_ref"] = search["low"], search["value_low"]

        # zoom (algorithm 3.6)
        high_to_mid = (dec > 0.0) | (vt >= s["value_low"])
        high_to_low = (st_ * (s["high"] - s["low"]) >= 0.0) & ~high_to_mid
        zoom = {"interval_found": found, "safe": safe_dec & (vt < s["safe_value"])}
        for key, t in (("", step), ("value_", vt), ("slope_", st_)):
            h = torch.where(high_to_mid, t, s[key + "high"])
            zoom[key + "high"] = torch.where(high_to_low, s[key + "low"], h)
            zoom[key + "low"] = torch.where(~high_to_mid, t, s[key + "low"])
        moved = high_to_mid | high_to_low
        zoom["cubic_ref"] = torch.where(moved, s["high"], s["low"])
        zoom["value_cubic_ref"] = torch.where(moved, s["value_high"], s["value_low"])

        new = {key: torch.where(found, zoom[key], search[key]) for key in search
               if key not in ("failed", "safe")}
        safe = torch.where(found, zoom["safe"], search["safe"])
        new["safe_stepsize"] = torch.where(safe, step, s["safe_stepsize"])
        new["safe_value"] = torch.where(safe, vt, s["safe_value"])
        new["safe_grad"] = _where(safe, gt, s["safe_grad"])
        zoom_failed = (last | (too_small & (new["safe_stepsize"] > 0.0))) & ~done
        failed = torch.where(found, zoom_failed, search["failed"])
        new.update(count=s["count"] + 1, stepsize=step, value=vt, grad=gt, slope=st_,
                   decrease_error=dec, done=done, failed=failed)
        # a failed search falls back on the safe step (sufficient decrease
        # without curvature), or on it anyway when the trial left the domain
        fall = failed & ((new["safe_stepsize"] > 0.0) | torch.isinf(dec))
        new["stepsize"] = torch.where(fall, new["safe_stepsize"], new["stepsize"])
        new["value"] = torch.where(fall, new["safe_value"], new["value"])
        new["grad"] = _where(fall, new["safe_grad"], new["grad"])

        for key, old in s.items():
            old.copy_(_where(active, new[key], old))
        torch.logical_not(s["done"] | s["failed"], out=active)
        self.any_active.copy_(active.any())

    def _tail(self) -> None:
        st, s, w = self.state, self.s, self.w
        update = s["stepsize"][:, None] * self.u
        ok = self.searching & _all_finite(update, self.reduce)
        dwm, dum, wm = self.memory
        new = LbfgsState(count=st.count + 1, params=w, updates=self.grad,
                         diff_params=dwm, diff_updates=dum, weights=wm,
                         value=s["value"], grad=s["grad"]).where(ok, st)
        w_new = _where(ok, w + update, w)
        for f in dataclasses.fields(st):
            getattr(st, f.name).copy_(getattr(new, f.name))
        w.copy_(w_new)
        self.i.add_(1)

    def iteration(self) -> None:
        """One iteration run eagerly, in the early-exit form: the plain
        version of a captured iteration."""
        self._head_need()
        self._if(self.any_need, self._evaluate_need)
        self._head()
        for _ in range(MAX_LINESEARCH_STEPS):
            if not self._if(self.any_active, self._trial):
                break
        self._tail()

    # ------------------------------------------------------------ running
    def run(self, n: int) -> None:
        """``n`` more iterations, with no host fence on the card once the
        iteration is captured."""
        with torch.no_grad():
            if not self.w.is_cuda:
                for _ in range(n):
                    self.iteration()
                return
            if self.graphs is None:
                warm = min(n, self.WARMUP - self.eager_iterations)
                if warm > 0:
                    with span("gpitch.fit.warmup"):
                        side = torch.cuda.Stream(self.w.device)
                        side.wait_stream(torch.cuda.current_stream())
                        with torch.cuda.stream(side):
                            for _ in range(warm):
                                self.iteration()
                        torch.cuda.current_stream().wait_stream(side)
                    self.eager_iterations += warm
                    n -= warm
                if n == 0:
                    return
                self._capture()
            head, trial, tail = self.graphs
            with span("gpitch.fit.replay"):
                for _ in range(n):
                    head.replay()
                    for _ in range(MAX_LINESEARCH_STEPS):
                        trial.replay()
                    tail.replay()

    def _capture(self) -> None:
        from ..linalg import _cuda
        # what the eager iterations counted: the replays' launches are
        # recorded from the counts that follow (``read``)
        self.replayed = _readback(self.counts)[0].copy()
        self.stats.syncs += 1
        pool = torch.cuda.graph_pool_handle()
        parts = self.parts
        t0 = time.perf_counter()
        with span("gpitch.fit.capture"):
            for name, part in (("need", self._head_need), ("evaluation", self._evaluate_need),
                               ("head", self._head), ("trial", self._trial),
                               ("tail", self._tail)):
                graph = torch.cuda.CUDAGraph(keep_graph=True)
                before = _cuda.launch_counts()
                with torch.cuda.graph(graph, pool=pool):
                    part()
                after = _cuda.launch_counts()
                self.calls[name] = {k: n - before.get(k, 0) for k, n in after.items()
                                    if n != before.get(k, 0)}
                _cuda.record_capture(self.calls[name])
                parts[name] = graph
            self.graphs = (_cuda.GraphChain([(parts["need"], None),
                                             (parts["evaluation"], self.any_need),
                                             (parts["head"], None)]),
                           _cuda.GraphChain([(parts["trial"], self.any_active)]),
                           _cuda.GraphChain([(parts["tail"], None)]))
        self.capture_s = time.perf_counter() - t0

    @torch.no_grad()
    def finish(self) -> None:
        """The value at the current point, evaluated once and compared with
        the best visited (``lbfgs_run``'s end of a run)."""
        final = self.fvalue(self.w)
        self.counts[3:4].add_(1)
        better = torch.isfinite(final) & (final < self.best_v)
        self.best_w.copy_(_where(better, self.w, self.best_w))
        self.best_v.copy_(torch.where(better, final, self.best_v))

    def read(self, start: int, stop: int, *more: torch.Tensor) -> list:
        """The host fence: losses[:, start:stop], the counts and ``more``
        read in one wait; the counts go into ``stats`` (with the trials of
        iterations start..stop-1), and on the card the launches of the
        conditionals' bodies that ran in replays are recorded.  Returns
        [losses, *more] as numpy."""
        from ..linalg import _cuda
        n = stop - start
        with span("gpitch.fit.fence"):
            host = _readback(self.losses[:, start:stop], self.counts,
                             self.trials[start:stop], *more)
        counts = host[1]
        delta = counts - self.counted
        self.counted = counts.copy()
        st = self.stats
        st.iterations += int(delta[0])
        st.trials += int(delta[1])
        st.grad_evaluations += int(delta[2])
        st.value_evaluations += int(delta[3])
        # iterations from ``active_steps`` on count no trials and no iteration
        st.trials_per_iteration += [int(t) for t in host[2][:min(n, int(delta[0]))]]
        st.syncs += 1
        if self.graphs is not None:
            ran = counts - self.replayed
            self.replayed = counts.copy()
            _cuda.record_replays(self.calls["trial"], int(ran[1]))
            _cuda.record_replays(self.calls["evaluation"], int(ran[2]))
        return [host[0]] + host[3:]

    @torch.no_grad()
    def load(self, w: torch.Tensor, state: LbfgsState | None = None,
             best: tuple[torch.Tensor, torch.Tensor] | None = None,
             active_steps: int | None = None) -> None:
        """A new start in the static tensors: the point ``w``, the solver's
        ``state`` (fresh when None), the best visited (``w`` and +inf when
        None), no problem marked non-finite, the iteration count 0 and the
        iterations from ``active_steps`` on frozen."""
        self.w.copy_(w)
        fresh = LbfgsState.init(self.w, self.state.weights.shape[1]) if state is None else state
        for f in dataclasses.fields(self.state):
            getattr(self.state, f.name).copy_(getattr(fresh, f.name))
        best_w, best_v = (w, torch.full_like(self.best_v, float("inf"))) if best is None else best
        self.best_w.copy_(best_w)
        self.best_v.copy_(best_v)
        self.nonfinite.zero_()
        self.losses.zero_()
        self.trials.zero_()
        self.i.zero_()
        self.active_steps.fill_(self.num_steps if active_steps is None else active_steps)


# ------------------------------------------------------------ the solver
def lbfgs_run(f: ValueAndGrad, fvalue: Value, w: torch.Tensor, num_steps: int,
              memory_size: int = 20, grad_tol: float = 1e-9,
              state: LbfgsState | None = None, active_steps: int | None = None,
              best: tuple[torch.Tensor, torch.Tensor] | None = None,
              stats: LbfgsStats | None = None, nonfinite: torch.Tensor | None = None,
              reduce: Reduce | None = None):
    """``num_steps`` L-BFGS iterations from w (B, D), each problem on its
    own (``LbfgsSteps``: captured on the card, eager on the CPU).  The loss
    recorded at step i is the value before update i.  A problem freezes
    once its gradient norm is <= ``grad_tol`` or its update is not finite,
    and every problem at step ``active_steps``.  ``best`` (best_w, best_v)
    carries the best-visited point across calls; the final state's own
    value is evaluated once and compared too.  ``nonfinite`` (B,) bool,
    when given, is marked for every problem that meets a value that is not
    finite.  ``reduce``: the rows are each rank's share of the problems'
    parameters, and every inner product and finite test is taken over the
    ranks (a ModGP whose sources are split; None in one process).  Returns
    (w, losses (B, num_steps), state, (best_w, best_v), stats)."""
    run = LbfgsSteps(f, fvalue, w, num_steps, memory_size, grad_tol, stats, reduce)
    run.load(w, state, best, active_steps)
    run.run(num_steps)
    run.finish()
    run.read(0, num_steps)
    if nonfinite is not None:
        nonfinite |= run.nonfinite
    return run.w, run.losses, run.state, (run.best_w, run.best_v), run.stats
