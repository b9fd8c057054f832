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
``lbfgs_solve`` (the per-window solvers of a window bank).  Deciding
whether any problem still searches is one host sync per trial.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ["LbfgsState", "lbfgs_run", "LbfgsStats"]

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


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


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
    state), and host syncs."""

    iterations: int = 0
    trials: int = 0
    grad_evaluations: int = 0
    value_evaluations: int = 0
    syncs: int = 0
    trials_per_iteration: list = dataclasses.field(default_factory=list)


# ------------------------------------------------------------ the direction
def _direction(g: torch.Tensor, st: LbfgsState, w: torch.Tensor):
    """scale_by_lbfgs: store (w - st.params, g - st.updates) in the ring
    memory and return (P g, the new memories), P the two-loop product."""
    b, m = st.weights.shape
    rows = torch.arange(b, device=w.device)
    idx = st.count % m
    prev = (st.count - 1) % m
    started = st.count > 0
    dw = _where(started, w - st.params, torch.zeros_like(w))
    du = _where(started, g - st.updates, torch.zeros_like(g))
    vd = _vdot(du, dw)
    weight = torch.where(vd == 0.0, torch.zeros_like(vd), 1.0 / vd)
    weight = torch.where(started, weight, torch.zeros_like(weight))
    dwm, dum, wm = st.diff_params.clone(), st.diff_updates.clone(), st.weights.clone()
    dwm[rows, prev] = dw
    dum[rows, prev] = du
    wm[rows, prev] = weight

    den = _vdot(du, du)
    scale = torch.where(den > 0.0, _vdot(du, dw) / den, torch.ones_like(den))
    capped = torch.minimum(torch.ones_like(den), 1.0 / torch.sqrt(_vdot(g, g)))
    scale = torch.where(started, scale, capped)

    # the memory from oldest to newest: slots idx, idx + 1, ... (mod m)
    order = (idx[:, None] + torch.arange(m, device=w.device)) % m
    odw = dwm.gather(1, order[..., None].expand(-1, -1, dwm.shape[-1]))
    odu = dum.gather(1, order[..., None].expand(-1, -1, dum.shape[-1]))
    orho = wm.gather(1, order)
    vec = g
    alphas = [None] * m
    for k in reversed(range(m)):
        alpha = orho[:, k] * _vdot(odw[:, k], vec)
        vec = vec + (-alpha)[:, None] * odu[:, k]
        alphas[k] = alpha
    vec = scale[:, None] * vec
    for k in range(m):
        beta = orho[:, k] * _vdot(odu[:, k], vec)
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


def _linesearch(f: ValueAndGrad, w, u, value, grad, searching, stats: LbfgsStats,
                nonfinite: torch.Tensor):
    """optax's zoom linesearch from w along u for every problem that is
    ``searching`` (the others start done and are left as they are).
    Returns (step size, value and gradient there), each per problem; marks
    in ``nonfinite`` the problems a trial of which was not finite."""
    zero = torch.zeros_like(value)
    slope = _vdot(u, grad)
    inf = torch.full_like(value, float("inf"))
    s = {"count": torch.zeros_like(value, dtype=torch.int64),
         "stepsize": zero, "value": value, "grad": grad, "slope": slope,
         "decrease_error": inf,
         "interval_found": torch.zeros_like(searching), "done": ~searching,
         "failed": torch.zeros_like(searching),
         "low": zero, "value_low": value, "slope_low": slope,
         "high": zero, "value_high": value, "slope_high": slope,
         "cubic_ref": zero, "value_cubic_ref": value,
         "safe_stepsize": zero, "safe_value": value, "safe_grad": grad}
    value_init, slope_init = value, slope
    active = searching
    trials = 0
    stats.syncs += 1
    while bool(active.any()):
        found = s["interval_found"]
        middle, too_small = _zoom_middle(s)
        grown = torch.where(s["count"] == 0, torch.ones_like(value),
                            INCREASE_FACTOR * s["stepsize"])
        step = torch.where(found, middle, grown)
        vt, gt = f(w + step[:, None] * u)
        trials += 1
        nonfinite |= active & ~torch.isfinite(vt)
        st_ = _vdot(gt, u)
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

        s = {key: _where(active, new[key], old) for key, old in s.items()}
        active = ~(s["done"] | s["failed"])
        stats.syncs += 1
    stats.trials += trials
    stats.trials_per_iteration.append(trials)
    return s["stepsize"], s["value"], s["grad"]


# ------------------------------------------------------------ the solver
def lbfgs_run(f: ValueAndGrad, fvalue: Value, w: torch.Tensor, num_steps: int,
              memory_size: int = 20, grad_tol: float = 1e-9,
              state: LbfgsState | None = None, active_steps: int | None = None,
              best: tuple[torch.Tensor, torch.Tensor] | None = None,
              stats: LbfgsStats | None = None, nonfinite: torch.Tensor | None = None):
    """``num_steps`` L-BFGS iterations from w (B, D), each problem on its
    own.  The loss recorded at step i is the value before update i.  A
    problem freezes once its gradient norm is <= ``grad_tol`` or its update
    is not finite, and every problem at step ``active_steps``.  ``best``
    (best_w, best_v) carries the best-visited point across calls; the final
    state's own value is evaluated once and compared too.  ``nonfinite``
    (B,) bool, when given, is marked for every problem that meets a value
    that is not finite.  Returns (w, losses (B, num_steps), state,
    (best_w, best_v), stats)."""
    stats = LbfgsStats() if stats is None else stats
    if nonfinite is None:
        nonfinite = torch.zeros(w.shape[0], dtype=torch.bool, device=w.device)
    state = LbfgsState.init(w, memory_size) if state is None else state
    active = num_steps if active_steps is None else active_steps
    if best is None:
        best = (w, torch.full_like(w[:, 0], float("inf")))
    best_w, best_v = best
    losses = w.new_empty((w.shape[0], num_steps))
    with torch.no_grad():
        for i in range(num_steps):
            # value_and_grad_from_state: the carried value and gradient
            # unless the carried value is not finite
            need = ~torch.isfinite(state.value)
            stats.syncs += 1
            value, grad = state.value, state.grad
            if bool(need.any()):
                v, g = f(w)
                stats.grad_evaluations += 1
                value, grad = torch.where(need, v, value), _where(need, g, grad)
            losses[:, i] = value
            nonfinite |= ~torch.isfinite(value)
            better = torch.isfinite(value) & (value < best_v)
            best_w, best_v = _where(better, w, best_w), torch.where(better, value, best_v)
            if i >= active:
                continue
            stats.iterations += 1
            searching = torch.sqrt(_vdot(grad, grad)) > grad_tol
            direction, (dwm, dum, wm) = _direction(grad, state, w)
            u = -1.0 * direction
            lr, fval, fgrad = _linesearch(f, w, u, value, grad, searching, stats,
                                          nonfinite)
            update = lr[:, None] * u
            ok = searching & torch.isfinite(update).all(-1)
            new = LbfgsState(count=state.count + 1, params=w, updates=grad,
                             diff_params=dwm, diff_updates=dum, weights=wm,
                             value=fval, grad=fgrad)
            w = _where(ok, w + update, w)
            state = new.where(ok, state)
        final = fvalue(w)
        stats.value_evaluations += 1
        better = torch.isfinite(final) & (final < best_v)
        best_w, best_v = _where(better, w, best_w), torch.where(better, final, best_v)
    return w, losses, state, (best_w, best_v), stats
