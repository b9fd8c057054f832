"""Tracing and timing.

Counterpart of gpitch_tpu/utils/profiling.py: a torch.profiler trace
context (Chrome trace), the program's spans, and a timer fenced by
``torch.cuda.synchronize``.

``span(name)`` marks a stretch of the program's host code.  While a torch
profiler records (``trace``, or any ``torch.profiler.profile``) it is a
``record_function`` range: a host annotation on the clock the profile's
device operations share, so every idle gap of the card falls under the
span that was open at it.  Otherwise it is one shared no-op, a flag check
(an ungated ``record_function`` costs microseconds even with no profiler).
Spans sit at the program's layer boundaries, a few dozen in a separation
job, never inside a step, a captured graph or a loop over replays.  The
names start with ``gpitch.``:

- ``gpitch.sosp.init``, ``gpitch.amt.init``: a pipeline's constructor;
  within it ``gpitch.pitch_params`` (``learn_pitch_params``),
  ``gpitch.windows`` (windowing and the inducing points) and
  ``gpitch.bank.build`` (``build_window_bank``, its copy to the device
  included);
- ``gpitch.predict``: ``predict_bank_sources`` / ``predict_bank_mixture``
  over their chunks; ``gpitch.predict.merge``: the posteriors' copy to the
  host and their overlap-add merge;
- ``gpitch.fit``: one ``optimize_bank`` call; within it
  ``gpitch.fit.build`` (the steps' static state), ``gpitch.fit.warmup``
  (the eager steps before a capture), ``gpitch.fit.capture`` (one capture,
  from its fence to the graphs' instantiation), ``gpitch.fit.replay`` (the
  host's enqueue of one segment's replays) and ``gpitch.fit.fence`` (a
  host read that waits for the card).
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

__all__ = ["trace", "span", "Timer"]

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager over a stretch of the program named ``name``: a
    ``record_function`` range while a torch profiler records, else one
    shared no-op."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(logdir: str = "gpitch_trace"):
    """torch.profiler over the block (host ops, the program's spans, and the
    card's kernels when there is one); writes ``<logdir>/trace.json``, a
    Chrome trace (chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _fence(out) -> None:
    """Wait for the work behind ``out``: the card's queue when a result
    lies on it."""
    leaves = out if isinstance(out, (tuple, list)) else [out]
    if any(isinstance(x, torch.Tensor) and x.is_cuda for x in leaves):
        torch.cuda.synchronize()


class Timer:
    """Wall-clock timer (a context manager: ``elapsed`` seconds)."""

    def __init__(self):
        self.t0 = None
        self.elapsed = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0

    @staticmethod
    def time_fn(fn, *args, iters: int = 10, warmup: int = 2):
        """Median seconds per call of ``fn(*args)``, each call fenced by
        ``torch.cuda.synchronize`` when its result lies on the card."""
        for _ in range(warmup):
            _fence(fn(*args))
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            _fence(fn(*args))
            times.append(time.perf_counter() - t0)
        return float(np.median(times))
