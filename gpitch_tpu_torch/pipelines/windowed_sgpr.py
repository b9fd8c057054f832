"""Batched windowed-SGPR engine: the compute core of separation.

Counterpart of gpitch_tpu/pipelines/windowed_sgpr.py.  The window axis is
an explicit leading batch axis: one SGPRSS holds every window's data,
inducing points and free hyperparameters, and its bound is one batched
computation.  Adam updates all windows at once; L-BFGS runs one
independent solver per window, all advanced together.  Windows are
independent, so chunking the window axis is exact.
"""

from __future__ import annotations

import heapq
import time
from typing import Callable

import numpy as np
import torch

from ..config import DEFAULT_DEVICE, resolve_device
from ..core.params import Param, cat_windows, map_params, take_windows, to_device
from ..kernels.base import StackedSum, Sum, stack_modules
from ..models._lbfgs import LbfgsSteps
from ..models.fit import AdamSteps, ParamRows, first_segment_excess
from ..models.sgpr import SGPRSS, check_on_grid
from ..utils.profiling import span

__all__ = ["sum_kernel", "bank_route", "pad_inducing", "build_window_bank", "bank_loss",
           "optimize_bank", "predict_bank_sources", "predict_bank_mixture",
           "pitch_variances", "chunked_vmap"]


def sum_kernel(kerns):
    """Sum over per-pitch kernels: a StackedSum when they are homogeneous
    (one batched op over the pitch axis), else a Sum (pitches whose FFTs
    gave different partial counts; ``bank_route`` reads "sum" then)."""
    kerns = list(kerns)
    if len(kerns) > 1:
        try:
            return StackedSum.create(kerns)
        except ValueError:
            pass
    return Sum(kern_list=tuple(kerns))


def bank_route(bank) -> str:
    """How the bank's bound is computed: "fused" (a StackedSum through the
    fused pair, ``SGPR.fused_eligible``), "stacked" (a StackedSum on the
    unfused route: a mask, a lag table, M > 160 or float64 on the card) or
    "sum" (``sum_kernel``'s Sum: one covariance build a pitch)."""
    if bank.fused_eligible():
        return "fused"
    return "stacked" if isinstance(bank.kern, StackedSum) else "sum"


def _gap_fill_points(z_sorted: np.ndarray, need: int, grid_dt) -> np.ndarray:
    """``need`` new points at midpoints of the largest gaps of ``z_sorted``
    (snapped to the sample grid when ``grid_dt`` is given), largest gap
    first; leftover points go on-grid after the last point."""
    new_vals: list[float] = []
    if grid_dt is not None:
        base = z_sorted[0]
        idx = np.round((z_sorted - base) / grid_dt).astype(np.int64)
        heap = [(-(int(idx[i + 1]) - int(idx[i])), int(idx[i]), int(idx[i + 1]))
                for i in range(len(idx) - 1)]
        heapq.heapify(heap)
        while len(new_vals) < need and heap and -heap[0][0] >= 2:
            g, lo, hi = heapq.heappop(heap)
            mid = lo + (-g) // 2
            new_vals.append(base + mid * grid_dt)
            heapq.heappush(heap, (-(mid - lo), lo, mid))
            heapq.heappush(heap, (-(hi - mid), mid, hi))
        tail = need - len(new_vals)
        if tail:
            last = max(float(z_sorted[-1]),
                       max(new_vals) if new_vals else -np.inf)
            new_vals.extend(last + grid_dt * np.arange(1, tail + 1))
    else:
        heap = [(-(z_sorted[i + 1] - z_sorted[i]),
                 float(z_sorted[i]), float(z_sorted[i + 1]))
                for i in range(len(z_sorted) - 1)]
        heapq.heapify(heap)
        while len(new_vals) < need and heap and -heap[0][0] > 1e-12:
            g, lo, hi = heapq.heappop(heap)
            mid = 0.5 * (lo + hi)
            new_vals.append(mid)
            heapq.heappush(heap, (-(mid - lo), lo, mid))
            heapq.heappush(heap, (-(hi - mid), mid, hi))
        tail = need - len(new_vals)
        if tail:
            span = float(z_sorted[-1] - z_sorted[0]) or 1e-3
            step = max(span / max(len(z_sorted) + need, 1), 1e-6)
            last = max(float(z_sorted[-1]),
                       max(new_vals) if new_vals else -np.inf)
            new_vals.extend(last + step * np.arange(1, tail + 1))
    return np.asarray(new_vals, dtype=np.float64)


def pad_inducing(z_list, m: int | None = None, grid_dt=None) -> np.ndarray:
    """Ragged per-window inducing sets -> (nw, M, 1): larger sets are
    subsampled evenly, smaller ones gap-filled (well separated points keep
    Kuu away from a near-null subspace)."""
    z_list = [np.asarray(z).reshape(-1, 1) for z in z_list]
    for i, z in enumerate(z_list):
        if z.shape[0] == 0:
            raise ValueError(
                f"window {i}: empty inducing set — silent windows need the "
                "uniform fallback (pipelines.init.init_liv_robust)")
    m = m or max(z.shape[0] for z in z_list)
    out = []
    for z in z_list:
        k = z.shape[0]
        if k > m:
            z = z[np.linspace(0, k - 1, m).astype(int)]
        elif k < m:
            pad = _gap_fill_points(np.sort(z[:, 0]), m - k, grid_dt)
            z = np.concatenate([z, pad.reshape(-1, 1)], 0)
        out.append(z)
    return np.stack(out)


def _build_window_bank_loop(x_windows, y_windows, z_windows, kern_builder,
                            noise_variance=1.0, masks=None, reg=False,
                            y_scale=1.0, grid_dt=None, lag_table=False,
                            dtype=torch.float32, device=DEFAULT_DEVICE):
    """The bank as nw ``SGPRSS.create`` calls stacked on a window axis: the
    oracle ``build_window_bank`` is held against."""
    nw = np.asarray(x_windows).shape[0]
    num_lags = None
    if grid_dt is not None and lag_table:
        num_lags = max(int(np.round(np.ptp(np.concatenate(
            [np.asarray(x_windows[i]).reshape(-1), np.asarray(z_windows[i]).reshape(-1)])
            / grid_dt))) + 1 for i in range(nw))
    models = [SGPRSS.create(np.asarray(x_windows[i], dtype=np.float64).reshape(-1, 1),
                            y_scale * np.asarray(y_windows[i]).reshape(-1, 1),
                            kern_builder(), Z=np.asarray(z_windows[i]),
                            noise_variance=noise_variance,
                            mask=None if masks is None else np.asarray(masks[i]),
                            reg=reg, grid_dt=grid_dt, num_lags=num_lags,
                            lag_table=lag_table, dtype=dtype)
              for i in range(nw)]
    return to_device(stack_modules(models), resolve_device(device))


def build_window_bank(x_windows, y_windows, z_windows, kern_builder: Callable,
                      noise_variance: float = 1.0, masks=None, reg: bool = False,
                      y_scale: float = 1.0, grid_dt=None, lag_table: bool = False,
                      dtype=torch.float32, device=DEFAULT_DEVICE):
    """One SGPRSS over all windows (leaves (nw, ...)), built on the host and
    moved to ``device`` once ('cuda' unless the caller asks for 'cpu').

    kern_builder() -> a fresh kernel; every window starts from that copy.
    Per-window centering runs vectorized in f64 (x0 = min of the valid
    inputs and the inducing points, split into an f32 (hi, lo) pair);
    ``masks`` ((nw, ws) in {0, 1}) marks each window's valid samples and
    becomes the bank's mask leaf; ``grid_dt`` validates that windows and
    inducing points sit on the sample grid; ``lag_table`` (with
    ``grid_dt``) takes the table route, one table length for the whole
    bank; ``y_scale`` scales the targets.
    """
    with span("gpitch.bank.build"):
        xw = np.asarray(x_windows, dtype=np.float64)
        xw = xw.reshape(xw.shape[0], -1)
        yw = y_scale * np.asarray(y_windows, dtype=np.float64).reshape(xw.shape[0], -1)
        zw = np.asarray(z_windows, dtype=np.float64).reshape(xw.shape[0], -1)
        nw = xw.shape[0]
        mk = None
        xmin = xw.min(axis=1)
        if masks is not None:
            mk = np.asarray(masks, dtype=np.float64).reshape(nw, -1)
            valid = mk > 0
            xmin = np.where(valid.any(axis=1),
                            np.min(np.where(valid, xw, np.inf), axis=1), xmin)
        x0 = np.minimum(xmin, zw.min(axis=1))
        x0_hi = x0.astype(np.float32).astype(np.float64)
        x0_lo = x0 - x0_hi
        Xc = xw - x0[:, None]
        Zc = zw - x0[:, None]
        num_lags = None
        if grid_dt is not None:
            check_on_grid(Xc, Zc, grid_dt)
            if lag_table:
                # one table length for the stacked bank: the largest per-window
                # index span max - min (not max alone: centering on the valid
                # samples leaves masked leading samples at negative positions,
                # and the table's offset starts at the least of all of them)
                xv, zv = Xc / grid_dt, Zc / grid_dt
                hi = np.maximum(xv.max(axis=1), zv.max(axis=1))
                lo = np.minimum(xv.min(axis=1), zv.min(axis=1))
                num_lags = int(np.round((hi - lo).max())) + 1
        device = resolve_device(device)

        template = SGPRSS.create(
            Xc[0], yw[0], kern_builder(), Z=Zc[0], noise_variance=noise_variance,
            mask=None if mk is None else mk[0], reg=reg, grid_dt=grid_dt,
            num_lags=num_lags, lag_table=lag_table, center=False, dtype=dtype)

        def tile(p: Param) -> Param:
            return Param(p.raw.detach().expand((nw,) + tuple(p.raw.shape)).clone(),
                         p.transform, p.trainable)

        def data(value) -> Param:
            return Param.create(value, trainable=False, dtype=dtype)

        bank = map_params(template, tile)
        bank.X, bank.Y, bank.Z = data(Xc[..., None]), data(yw[..., None]), data(Zc[..., None])
        bank.x0, bank.x0_lo = data(x0_hi), data(x0_lo)
        if mk is not None:
            bank.mask = data(mk)
        return to_device(bank, device)


def bank_loss(bank) -> torch.Tensor:
    """Sum of the per-window negative bounds."""
    return bank.loss().sum()


def optimize_bank(bank, num_steps: int = 500, learning_rate: float = 0.01,
                  method: str = "adam", timed: bool = False,
                  segment: int | None = 250, window_chunk: int | None = None,
                  mesh=None, mesh_axis: str = "w", return_info: bool = False):
    """Train every window of the bank; returns (the trained bank, losses)
    with losses the per-step total over windows (numpy), with ``timed=True``
    (bank, losses, (first_s, run_s)), and with ``return_info`` a dict of
    the run's counts last.  The input bank is left unchanged.

    ``method="adam"``: Adam on every window at once, a host fence (the
    losses' copy) every ``segment`` steps (``None``: one at the end).
    ``method="lbfgs"``: one independent L-BFGS solver per window (see
    ``_optimize_bank_lbfgs``; ``learning_rate`` and ``segment`` do not
    apply), the reference's per-window optimizer; the returned bank is
    each window's best-visited state.  ``window_chunk``: optimize the
    window axis in chunks of this size, one after another (exact: every
    leaf and optimizer state is per window).  ``timed``: eager torch has
    no compile step, so first_s is the first segment's excess over the
    median of all later segments (of every chunk), and run_s the rest of
    the wall time, the split the JAX package makes for its chunked runs.
    The Adam route's info: its host fences (``syncs``), and its steps'
    ``captures``, ``capture_s``, ``warmup_s``, ``eager_steps`` and
    ``replays`` over all its chunks (``models.fit.CapturedSteps``).

    ``mesh`` (a DeviceMesh of ``parallel.make_mesh``): the windows split
    over the ranks of its ``mesh_axis``, each rank training its own
    contiguous slice (with ``window_chunk`` and ``segment`` as above) and
    no collective inside a step; the window axis is padded to a multiple
    of the rank count by copies of the last window, whose losses are
    excluded exactly.  At the end one all-reduce sums the per-step loss
    totals and one all-gather brings every rank the whole trained bank
    (with L-BFGS also every window's losses; the solver's counts are this
    rank's).
    """
    if method not in ("adam", "lbfgs"):
        raise ValueError(f"unknown method {method!r}")
    with span("gpitch.fit"):
        if mesh is not None:
            bank, losses, seconds, info = _optimize_bank_mesh(
                bank, num_steps, learning_rate, method, segment, window_chunk, mesh,
                mesh_axis)
        else:
            bank, losses, seconds, info = _optimize_windows(
                bank, num_steps, learning_rate, method, segment, window_chunk)
    out = (bank, losses) + ((first_segment_excess(seconds),) if timed else ())
    return out + (info,) if return_info else out


def _chunk_plan(bank, window_chunk: int | None, weights=None):
    """Adam's chunks of a bank, as the JAX package's ``_chunk_plan`` pads
    them: (chunk size, chunk count, the bank padded to whole chunks by
    copies of its last window, the padded bank's per-window weights: 0 for
    a pad, ``weights`` (or 1) for the others; None when nothing is padded
    and no ``weights`` are given)."""
    nw = bank.X.raw.shape[0]
    chunk = nw if window_chunk is None else min(max(1, window_chunk), nw)
    nc = -(-nw // chunk)
    pad = nc * chunk - nw
    if not pad:
        return chunk, nc, bank, weights
    from ..parallel.mesh import repeat_last_window
    x = bank.X.raw
    w = torch.ones(nw, dtype=x.dtype, device=x.device) if weights is None else weights
    return chunk, nc, repeat_last_window(bank, pad), torch.cat([w, w.new_zeros(pad)])


def _weighted_loss(w: torch.Tensor) -> Callable:
    """loss_fn(bank): the per-window negative bounds weighted by ``w`` (read
    at every call, so its values may change between calls), summed."""
    def loss_fn(b):
        return (b.loss() * w).sum()
    return loss_fn


def _optimize_windows(bank, num_steps: int, learning_rate: float, method: str,
                      segment: int | None, window_chunk: int | None, weights=None):
    """One process's run of ``optimize_bank``: (bank, losses, the wall
    seconds of each segment, info).  ``weights`` ((nw,) of 1 and 0) leaves
    the windows of weight 0 out of the Adam losses and gradients.

    Adam in chunks, as the JAX package's ``_optimize_bank_chunked``: the
    window axis is padded to whole chunks (``_chunk_plan``), so that every
    chunk has one shape and one captured step (``AdamSteps``) serves them
    all; each chunk's leaves and weights go into the step's static tensors,
    with a fresh Adam state."""
    if method == "lbfgs":
        return _optimize_bank_lbfgs(bank, num_steps, window_chunk=window_chunk)
    nw = bank.X.raw.shape[0]
    chunk, nc, bank, w_all = _chunk_plan(bank, window_chunk, weights)
    w = None if w_all is None else w_all[:chunk].clone()
    loss_fn = bank_loss if w is None else _weighted_loss(w)
    with span("gpitch.fit.build"):
        run = AdamSteps(take_windows(bank, slice(0, chunk)), loss_fn, num_steps,
                        learning_rate)
    segment = segment or num_steps
    banks, losses, seconds = [], np.zeros(num_steps), []
    for ci in range(nc):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        if ci:
            run.load(take_windows(bank, sl))
            if w is not None:
                w.copy_(w_all[sl])
        ls, secs = run.segments(num_steps, segment)
        banks.append(run.result() if nc == 1 else take_windows(run.model, slice(None)))
        losses += ls
        seconds += secs
    bank = banks[0] if nc == 1 else take_windows(cat_windows(banks), slice(0, nw))
    return bank, losses, seconds, {
        "syncs": len(seconds), "captures": run.captures, "capture_s": run.capture_s,
        "warmup_s": run.warmup_s, "eager_steps": run.eager_steps, "replays": run.replays}


def _optimize_bank_mesh(bank, num_steps: int, learning_rate: float, method: str,
                        segment: int | None, window_chunk: int | None, mesh,
                        mesh_axis: str):
    """``optimize_bank`` over the ranks of ``mesh`` (see there)."""
    import torch.distributed as dist

    from ..parallel.mesh import (axis_info, comm_device, gather_rows, gather_windows,
                                 repeat_last_window)
    group, size, rank = axis_info(mesh, mesh_axis)
    nw = bank.X.raw.shape[0]
    per = -(-nw // size)
    pad = per * size - nw
    padded = repeat_last_window(bank, pad) if pad else bank
    local = take_windows(padded, slice(rank * per, (rank + 1) * per))
    real = min(per, max(nw - rank * per, 0))
    weights = None
    if real < per:
        weights = torch.zeros(per, dtype=bank.X.raw.dtype, device=bank.X.raw.device)
        weights[:real] = 1.0
    local, losses, seconds, info = _optimize_windows(
        local, num_steps, learning_rate, method, segment, window_chunk, weights)
    if method == "lbfgs":
        lw = info["window_losses"]
        losses = lw[:real].astype(np.float64).sum(0)
        info["window_losses"] = gather_rows(torch.as_tensor(lw), group)[:nw].numpy()
    total = torch.as_tensor(losses, dtype=torch.float64, device=comm_device(group))
    dist.all_reduce(total, group=group)
    info.update(ranks=size, rank_windows=(rank * per, rank * per + real))
    return gather_windows(bank, local, nw, group), total.cpu().numpy(), seconds, info


def _optimize_bank_lbfgs(bank, num_steps: int, window_chunk: int | None = None,
                         step_segment: int = 100):
    """One independent L-BFGS solver per window (``models._lbfgs``: optax's
    L-BFGS and zoom linesearch batched over the window axis, each window's
    linesearch on its own): the counterpart of the JAX package's vmapped
    ``lbfgs_solve`` and of the reference's per-window scipy L-BFGS-B.

    A window's values are ``bank.loss()``'s entry and its gradient the
    gradient of their sum.  The solver (``LbfgsSteps``: on the card one
    captured iteration, replayed) has a host fence every ``step_segment``
    iterations, where the value at the segment's end is compared with the
    best visited, as the JAX package's segments do, so segments are exact.
    Chunks of ``window_chunk`` windows are padded to one shape by copies of
    the last window, as the JAX package pads them, so that one capture
    serves them all; the pads' results are dropped.  A window whose bound
    goes NaN at a trial (a step that makes its Kuu indefinite) turns only
    its own values NaN; its linesearch shrinks the step, or it freezes.

    Returns (bank of each window's best-visited state, losses: the
    per-step total over windows, the wall seconds of each segment, info):
    info holds the per-window losses (nw, num_steps), the solver's counts
    (iterations, linesearch trials, other evaluations, host reads, trials
    per iteration), the capture's host seconds (0 on the CPU), the windows
    that end at their initial state and the windows that ever met a
    non-finite value."""
    nw = bank.X.raw.shape[0]
    chunk, nc, padded, _ = _chunk_plan(bank, window_chunk)
    step_segment = max(1, min(step_segment, num_steps))
    rows = ParamRows(take_windows(padded, slice(0, chunk)), lambda b: b.loss(), batched=True)
    run = LbfgsSteps(rows.value_and_grad, rows.value, rows.rows(), num_steps)
    banks, window_losses, seconds = [], [], []
    at_initial, nonfinite = 0, 0
    for ci in range(nc):
        real = min(chunk, nw - ci * chunk)
        if ci:
            rows.load(take_windows(padded, slice(ci * chunk, (ci + 1) * chunk)))
        w0 = rows.rows()
        run.load(w0)
        lw = []
        for start in range(0, num_steps, step_segment):
            t0 = time.perf_counter()
            stop = min(start + step_segment, num_steps)
            run.run(stop - start)
            run.finish()
            more = ((run.best_w == w0).all(-1), run.nonfinite) if stop == num_steps else ()
            host = run.read(start, stop, *more)               # the host fence
            lw.append(host[0][:real])
            seconds.append(time.perf_counter() - t0)
        window_losses.append(np.concatenate(lw, axis=1))
        at_initial += int(host[1][:real].sum())
        nonfinite += int(host[2][:real].sum())
        best = rows.model_at(run.best_w)
        banks.append(best if real == chunk else take_windows(best, slice(0, real)))
    window_losses = np.concatenate(window_losses)
    info = {"window_losses": window_losses,
            "windows_at_initial_state": at_initial, "windows_nonfinite": nonfinite,
            "capture_s": run.capture_s, **vars(run.stats)}
    bank = banks[0] if len(banks) == 1 else cat_windows(banks)
    return bank, window_losses.astype(np.float64).sum(0), seconds, info


def chunked_vmap(fn: Callable, bank, batch_size: int = 8):
    """``fn`` over the window axis in chunks of ``batch_size`` windows:
    ``bank`` is a model, a tensor, or a tuple of them with a window axis
    first; ``fn`` takes one chunk of it and returns a tensor or a tuple of
    tensors with the window axis first, concatenated over the chunks.
    Bounds the peak memory of predictions that build (ws, ws) Grams per
    window."""
    def take(obj, sl):
        if isinstance(obj, tuple):
            return tuple(take(o, sl) for o in obj)
        return obj[sl] if isinstance(obj, torch.Tensor) else take_windows(obj, sl)

    first = bank[0] if isinstance(bank, tuple) else bank
    nw = first.shape[0] if isinstance(first, torch.Tensor) else first.X.raw.shape[0]
    outs = [fn(take(bank, slice(c0, c0 + batch_size))) for c0 in range(0, nw, batch_size)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def _centered_windows(bank, x_windows) -> np.ndarray:
    """Per-window Xnew - x0 on the host in f64 (x0 = hi + lo)."""
    x0s = (bank.x0.raw.detach().cpu().numpy().astype(np.float64)
           + bank.x0_lo.raw.detach().cpu().numpy().astype(np.float64)).reshape(-1)
    xc = np.asarray(x_windows, dtype=np.float64)
    return xc.reshape(xc.shape[0], -1) - x0s[:, None]


def _chunks(bank, x_windows, batch_size: int):
    xw = _centered_windows(bank, x_windows)
    X = bank.X.raw.detach()
    xt = torch.as_tensor(xw, dtype=X.dtype, device=X.device)[..., None]
    at_x = bool(torch.equal(xt, X))
    nw = xt.shape[0]
    for c0 in range(0, nw, batch_size):
        sl = slice(c0, c0 + batch_size)
        yield take_windows(bank, sl), xt[sl], at_x


@torch.no_grad()
def predict_bank_sources(bank, x_windows, batch_size: int = 8,
                         y_scale: float = 1.0):
    """Per-window per-source posteriors (smean, svar), each (S, nw, ws),
    windows in chunks of ``batch_size``.  When the prediction points are the
    windows' own samples (checked exactly), each chunk builds its
    per-source Grams once and reuses their sum as the full Gram.
    ``y_scale`` undoes the bank's target scaling (mean / y_scale, variance
    / y_scale^2)."""
    means, variances = [], []
    with span("gpitch.predict"):
        for part, x, at_x in _chunks(bank, x_windows, batch_size):
            m, v = part.predict_s(x, pre_centered=True, xnew_is_x=at_x)
            means.append(torch.stack([mm[..., 0] for mm in m], dim=0))
            variances.append(torch.stack([vv[..., 0] for vv in v], dim=0))
        return (torch.cat(means, dim=1) / y_scale,
                torch.cat(variances, dim=1) / (y_scale ** 2))


@torch.no_grad()
def predict_bank_mixture(bank, x_windows, batch_size: int = 8,
                         y_scale: float = 1.0):
    """Per-window mixture posterior: mean, var each (nw, ws), with the
    target scaling undone as in ``predict_bank_sources``."""
    means, variances = [], []
    with span("gpitch.predict"):
        for part, x, _ in _chunks(bank, x_windows, batch_size):
            m, v = part.predict_f(x, pre_centered=True)
            means.append(m[..., 0])
            variances.append(v[..., 0])
        return torch.cat(means) / y_scale, torch.cat(variances) / (y_scale ** 2)


def pitch_variances(bank) -> torch.Tensor:
    """Learned per-pitch variance per window, (num_pitches, nw)."""
    if isinstance(bank.kern, StackedSum):
        return bank.kern.stacked.variance.value.detach().mT
    return torch.stack([k.variance.value.detach() for k in bank.kern.kern_list])
