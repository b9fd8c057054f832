#!/usr/bin/env python3
"""Time the SoSp bank step of one or more checkouts on one CUDA card.

    python3 ab_step.py TREE [TREE ...]

Each TREE is the root of a checkout holding ``chip_smoke.py`` and
``gpitch_tpu_torch``; give them in the order to run, e.g. ``A B B A B A A
B`` to alternate which goes first.  Each run is a fresh process that builds
chip_smoke's sosp-4s workload (62 windows, f32), takes 30 warm-up Adam steps
and then times 3 x 20 steps at three points: fresh, after predict_f and
predict_s, and after the tree's own ``chip_smoke`` kernel phases (``chol``,
``specmix``), which precede the ``sosp`` phase in chip_smoke.py; then for a
second model built after those phases, as the ``sosp`` phase builds it.  The card
memory the caching allocator holds is read at each point.  Last, a probe of
that model's step: the host time spent inside the Cholesky wrapper, and
torch.profiler's device time and CUDA runtime calls per step.  Prints one JSON
line per run, then one with the median ms per step of each tree at each
point.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

_CHILD = r"""
import contextlib, io, json, sys, time
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
dev = torch.device("cuda")
model, _ = cs.make_sosp(4.0, dev, torch.float32)
model.optimize(maxiter=30, learning_rate=0.01)
torch.cuda.synchronize()

def steady(model):
    ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        model.optimize(maxiter=20, learning_rate=0.01)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) / 20 * 1e3)
    return {"ms_per_step": ms, "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30}

out = {"fresh": steady(model)}
model.predict_f()
model.predict_s()
out["after_predict"] = steady(model)
with contextlib.redirect_stdout(io.StringIO()):
    cs.phase_chol(dev)
    cs.phase_specmix(dev)
torch.cuda.synchronize()
out["after_kernel_phases"] = steady(model)
model, _ = cs.make_sosp(4.0, dev, torch.float32)
model.optimize(maxiter=30, learning_rate=0.01)
out["built_after_kernel_phases"] = steady(model)

# where a step's host time goes: 20 steps with the host time inside each
# Cholesky call summed, then torch.profiler over 5 steps (device time of
# the kernels, and the CUDA runtime calls that can block the host)
from gpitch_tpu_torch.linalg import ops
inner, host = ops.cholesky_batched, [0.0, 0]
def timed(K):
    t0 = time.perf_counter()
    L = inner(K)
    host[0] += time.perf_counter() - t0
    host[1] += 1
    return L
ops.cholesky_batched = timed
t0 = time.perf_counter()
model.optimize(maxiter=20, learning_rate=0.01)
torch.cuda.synchronize()
probe = {"ms_per_step": (time.perf_counter() - t0) / 20 * 1e3,
         "chol_calls_per_step": host[1] / 20,
         "chol_host_ms_per_call": host[0] / max(host[1], 1) * 1e3}
ops.cholesky_batched = inner
from torch.profiler import ProfilerActivity, profile
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    model.optimize(maxiter=5, learning_rate=0.01)
    torch.cuda.synchronize()
cuda = torch.autograd.DeviceType.CUDA
rows = prof.key_averages()
kern = sorted((e for e in rows if e.device_type == cuda), key=cs._device_us, reverse=True)
probe["device_ms_per_step"] = sum(cs._device_us(e) for e in kern) / 5e3
probe["top_kernels"] = [[e.key[:60], cs._device_us(e) / 5e3, e.count / 5] for e in kern[:6]]
probe["runtime_calls"] = {e.key: [e.count / 5, e.cpu_time_total / 5e3] for e in rows
                          if e.key.startswith("cuda") and e.key != "cudaLaunchKernel"
                          and e.count > 0}
probe["launches_per_step"] = sum(e.count for e in rows if e.key == "cudaLaunchKernel") / 5
out["probe"] = probe
print(json.dumps(out))
"""

POINTS = ("fresh", "after_predict", "after_kernel_phases", "built_after_kernel_phases")


def main() -> int:
    trees = [os.path.abspath(t) for t in sys.argv[1:]]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for i, tree in enumerate(trees):
        res = subprocess.run([sys.executable, "-c", _CHILD, tree], capture_output=True,
                             text=True, timeout=600, cwd=tree)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return 1
        run = {"run": i, "tree": sys.argv[1 + i],
               **json.loads(res.stdout.strip().splitlines()[-1])}
        print(json.dumps(run), flush=True)
        runs.append(run)
    summary = {}
    for name in dict.fromkeys(r["tree"] for r in runs):
        summary[name] = {p: statistics.median(ms for r in runs if r["tree"] == name
                                              for ms in r[p]["ms_per_step"])
                         for p in POINTS}
    print(json.dumps({"median_ms_per_step": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
