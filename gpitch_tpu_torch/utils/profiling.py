"""Tracing, timing and FLOPs accounting.

Counterpart of gpitch_tpu/utils/profiling.py: a torch.profiler trace
context (Chrome trace), a timer fenced by ``torch.cuda.synchronize`` and
one that replays a captured CUDA graph, the JAX package's analytical FLOPs
and bytes models (copied as they are), and utilization reports against an
H100 peak table (NVIDIA's data sheet for the H100 SXM: 67 TFLOP/s FP32
outside the tensor cores, 3.35 TB/s HBM3).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["trace", "Timer", "flops_specmix", "flops_cholesky",
           "flops_trisolve", "flops_gh_expectations", "flops_svgp_step",
           "flops_sgpr_bank_step", "utilization_report", "MetricsLogger"]


@contextlib.contextmanager
def trace(logdir: str = "gpitch_trace"):
    """torch.profiler over the block (host ops, and the card's kernels when
    there is one); writes ``<logdir>/trace.json``, a Chrome trace
    (chrome://tracing or Perfetto)."""
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

    @staticmethod
    def time_fn_loop(make_fn, loop_iters: int = 50, reps: int = 5,
                     warmup: int = 1):
        """Seconds per call without the host's per-call cost.

        ``make_fn(eps)`` returns a tensor whose value depends on the scalar
        tensor ``eps``; each iteration feeds a tiny scalar taken from the
        full sum of the previous output into the next call, so no iteration
        can be skipped.  On the card the ``loop_iters`` calls are captured
        once as a CUDA graph and the graph is replayed (CUDA events time
        the replays); on the CPU the loop runs as it is.  Returns the median
        over ``reps`` of the time per call."""
        def loop(eps):
            for _ in range(loop_iters):
                eps = make_fn(eps).sum().real.to(torch.float32) * 1e-20
            return eps

        if not torch.cuda.is_available():
            zero = torch.zeros((), dtype=torch.float32)
            for _ in range(warmup):
                loop(zero)
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                loop(zero)
                times.append(time.perf_counter() - t0)
            return float(np.median(times)) / loop_iters
        eps0 = torch.zeros((), dtype=torch.float32, device="cuda")
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            for _ in range(warmup):
                loop(eps0)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            loop(eps0)
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / 1e3)
        graph.reset()
        return float(np.median(times)) / loop_iters


# --- analytical FLOPs models ------------------------------------------------

def flops_specmix(n: int, m: int, p: int) -> int:
    """Spectral-mixture covariance via cos/sin features: feature build
    ~6(N+M)P (trig) + matmul 2*N*M*2P + envelope ~4NM."""
    return 6 * (n + m) * p + 4 * n * m * p + 4 * n * m


def flops_cholesky(m: int, batch: int = 1) -> int:
    return batch * m ** 3 // 3


def flops_trisolve(m: int, k: int, batch: int = 1) -> int:
    return batch * m * m * k


def flops_gh_expectations(n: int, s: int, h: int) -> int:
    """GH moments: evaluate nlin on (N,S,H) (~10 flops) + 2 reductions."""
    return n * s * h * 14


def flops_sgpr_bank_step(nw: int, n: int, m: int, s: int, p: int) -> int:
    """One loss+grad Adam step of a windowed-SGPRSS bank (models/sgpr.py
    ``_common``+``elbo``): per window, S-source covariance builds (Kuu M x M,
    Kuf M x N as cos/sin feature matmuls), chol_inv of Kuu and of B
    (chol ~M^3/3 + explicit triangular inverse ~M^3), the matmul chain
    A = Linv Kuf (2 M^2 N), AAT (2 M^2 N), Aerr (2 M N); backward ~2x the
    forward (the custom chol_inv VJP is matmul-only)."""
    fwd = s * (flops_specmix(m, m, p) + flops_specmix(m, n, p))
    fwd += 2 * (flops_cholesky(m) + flops_trisolve(m, m))   # chol_inv x2
    fwd += 2 * flops_trisolve(m, n)                          # A, AAT
    fwd += 2 * m * n                                         # Aerr
    return 3 * fwd * nw


def flops_svgp_step(n_batch: int, m: int, s: int, p: int, h: int = 20) -> int:
    """One ELBO+grad step of ModGP: 2S conditionals (Kuu build, chol,
    2 trisolves, Kuf build), GH expectations, KL; backward ~2x forward."""
    fwd = 2 * s * (flops_specmix(m, m, p) + flops_cholesky(m)
                   + 2 * flops_trisolve(m, n_batch) + flops_specmix(m, n_batch, p))
    fwd += flops_gh_expectations(n_batch, s, h)
    fwd += 2 * s * flops_cholesky(m)  # KL terms
    return 3 * fwd


# the card's peak rates, NVIDIA's data sheet for the H100 SXM (FP32 outside
# the tensor cores; HBM3); the CPU row is a nominal figure for a host
PEAK_FLOPS = {"h100": 67e12, "cpu": 1e11}
PEAK_BW = {"h100": 3.35e12, "cpu": 5e10}


def _device_kind(device_kind: str | None) -> str:
    if device_kind is not None:
        return device_kind.lower()
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0).lower()
    return "cpu"


def bank_step_bytes(nw: int, n: int, m: int, s: int) -> int:
    """HBM traffic model for one bank loss+grad step: the dominant buffers
    are the kuf-shaped (S, M, N) covariance blocks per window — ~3 passes
    forward (build write, A-chain read, AAT read) and ~2x that backward
    (docs/ROOFLINE.md section 1)."""
    kuf = s * m * n * 4
    return nw * kuf * 9


def achievable_report(flops_per_step: int, bytes_per_step: int,
                      seconds_per_step: float,
                      device_kind: str | None = None) -> dict:
    """Roofline 'achievable' utilization: the step's floor time is
    max(bytes / bandwidth, flops / peak), and mfu_achievable = floor /
    measured, how close the step runs to its own roofline."""
    kind = _device_kind(device_kind)
    peak = next((v for k, v in PEAK_FLOPS.items() if k in kind), 1e12)
    bw = next((v for k, v in PEAK_BW.items() if k in kind), 1e11)
    t_bw = bytes_per_step / bw
    t_fl = flops_per_step / peak
    floor = max(t_bw, t_fl)
    return {"t_bandwidth_floor_ms": round(t_bw * 1e3, 3),
            "t_flops_floor_ms": round(t_fl * 1e3, 3),
            "bound": "bandwidth" if t_bw >= t_fl else "flops",
            "mfu_achievable": round(floor / seconds_per_step, 4)}


def utilization_report(flops_per_step: int, seconds_per_step: float,
                       device_kind: str | None = None) -> dict:
    kind = _device_kind(device_kind)
    peak = next((v for k, v in PEAK_FLOPS.items() if k in kind), 1e12)
    achieved = flops_per_step / seconds_per_step
    return {"device": kind, "achieved_flops": achieved, "peak_flops": peak,
            "mfu": achieved / peak, "seconds_per_step": seconds_per_step}


@dataclass
class MetricsLogger:
    """Structured JSONL metrics (ELBO curve, steps/s, audio-seconds/s)."""

    path: str | None = None
    records: list = field(default_factory=list)

    def log(self, **kv):
        rec = {"t": time.time(), **kv}
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as fh:
                fh.write(json.dumps(rec) + "\n")

    def summary(self):
        return self.records[-1] if self.records else {}
