"""Host spans, and the device trace of a traced run reduced to numbers.

``Spans`` keeps named host-clock spans in memory around the benchmark's
calls into the program's layers.  ``profile`` runs a callable under
torch.profiler (CPU and CUDA activities) and returns a ``Profile``: every
device operation (kernels, copies, sets; the kernels a CUDA graph's replay
launches included) and every host event, on the profiler's one clock.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

__all__ = ["Spans", "Profile", "profile"]


class Spans:
    """Host-clock spans by name, kept in memory."""

    def __init__(self):
        self.seconds = defaultdict(list)

    def timed(self, name: str, fn, *args, **kw):
        """fn(*args, **kw), its wall time kept under ``name``.  The caller
        fences: a call that returns host data has waited for the device."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        self.seconds[name].append(time.perf_counter() - t0)
        return out


class Profile:
    """A profiled stretch: ``device`` (name, start_ns, end_ns) sorted by
    start, ``host`` (name, start_ns, end_ns, is_annotation), and the
    stretch's bounds ``t0``, ``t1`` (ns)."""

    def __init__(self, device, host, t0: int, t1: int):
        self.device, self.host, self.t0, self.t1 = device, host, t0, t1

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def busy_intervals(self):
        """The union of the device operations' intervals, clipped to the
        stretch, as sorted disjoint (start, end)."""
        out = []
        for _, a, b in self.device:
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def kernel_seconds(self, match) -> tuple[float, int]:
        """(summed device seconds, count) of the operations whose name
        satisfies ``match``."""
        got = [(b - a) for name, a, b in self.device if match(name)]
        return sum(got) * 1e-9, len(got)

    def owned_seconds(self, own, shared=()) -> float:
        """Summed device seconds of the operations whose name holds one of
        ``own``, and of those holding one of ``shared`` that run right
        after one of ``own`` (a kernel that two callers launch)."""
        total, owner = 0, False
        for name, a, b in self.device:
            if any(o in name for o in own):
                total, owner = total + b - a, True
            elif any(o in name for o in shared):
                total += (b - a) if owner else 0
            else:
                owner = False
        return total * 1e-9

    def top_ops(self, k: int = 10):
        """The ``k`` device operations that took most time, [name, s]."""
        by = defaultdict(int)
        for name, a, b in self.device:
            by[_short(name)] += b - a
        return [[n, v * 1e-9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10):
        """The device's idle time, by what the host was doing: each gap
        between busy intervals (and at the stretch's ends) is named by the
        outermost benchmark span and the innermost host operation around
        its middle ("Python" where no torch operation or CUDA call was
        running); the ``k`` names with most idle time, [name, s]."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        host = sorted(self.host, key=lambda e: e[1])
        by, active, i = defaultdict(int), [], 0
        for a, b in gaps:
            mid = (a + b) // 2
            while i < len(host) and host[i][1] <= mid:
                active.append(host[i])
                i += 1
            active = [e for e in active if e[2] >= mid]
            spans = [e for e in active if e[3] and e[0].startswith("bench.")]
            ops = [e for e in active if not e[3]]
            outer = min(spans, key=lambda e: e[1])[0] if spans else "-"
            inner = max(ops, key=lambda e: e[1])[0] if ops else "Python"
            by[f"{outer} / {_short(inner)}"] += b - a
        return [[n, v * 1e-9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def _short(name: str) -> str:
    """A kernel's name without its return type and argument list, at most
    160 characters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:160]


def profile(fn, label: str):
    """(fn(), its Profile): ``fn`` runs under torch.profiler inside the host
    annotation ``label`` (which starts with "bench."), fenced before and
    after, and the stretch is that annotation's span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with record_function(label):
            out = fn()
            torch.cuda.synchronize()
    device, host, t0, t1 = [], [], None, None
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.name(), a, b))
        else:
            host.append((e.name(), a, b, e.is_user_annotation()))
            if e.name() == label:
                t0, t1 = a, b
    if t0 is None:
        raise RuntimeError(f"the profiler recorded no span {label!r}")
    device.sort(key=lambda d: d[1])
    return out, Profile(device, host, t0, t1)
