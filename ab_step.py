#!/usr/bin/env python3
"""Time bank steps (and kernel B) of one or more checkouts on one CUDA card.

    python3 ab_step.py TREE [TREE ...]
    python3 ab_step.py --amt TREE [TREE ...]
    python3 ab_step.py --full TREE [TREE ...]
    python3 ab_step.py --whiten TREE [TREE ...]

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
point.  With ``--amt`` each run is instead the tree's own ``chip_smoke``
phase ``amt_full`` in a fresh process (the 439-window 8 x 10 bank of 10 s
in windows of 64 and the 88-pitch Sum bank of 2 s, 2 warm-up and 10 timed
bank steps each, then 2 steps of the 10 s bank under torch.profiler), and
the summary is the median ms per bank step of each case.  With ``--full``
each run is the tree's own phase ``full`` (the 14 s SoSp mix, 222
windows: 2 warm-up and 20 timed bank steps, then predict_s).  With
``--whiten`` each run times the tree's own fused pair
(``chip_smoke._whiten_case``) at the SoSp width (222 windows, M 112, 3 x
5) and the AMT width (43 windows, M 160, 8 x 10), then each kernel's
device time by CUDA kernel (torch.profiler), and the summary is the median
ms of kernels A and B at each.  Needs a CUDA card.
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

_AMT_CHILD = r"""
import contextlib, io, json, sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
with contextlib.redirect_stdout(io.StringIO()):
    out, model, _ = cs.phase_amt_full(torch.device("cuda"))
res = {k: {"ms_per_step": [v["ms_per_bank_step"]], "peak_gib": v["peak_gib"],
           "loss_last": v["loss_last"]} for k, v in out.items()}
# then 2 bank steps of the 10 s bank under torch.profiler: device time and
# launches a step against the wall time of the same steps
import time
from torch.profiler import ProfilerActivity, profile
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    model.optimize(maxiter=2, learning_rate=0.01, window_chunk=64)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 2 * 1e3
rows = prof.key_averages()
cuda = torch.autograd.DeviceType.CUDA
res["sounding"]["probe"] = {
    "wall_ms_per_step_profiled": wall,
    "device_ms_per_step": sum(cs._device_us(e) for e in rows if e.device_type == cuda) / 2e3,
    "launches_per_step": sum(e.count for e in rows if e.key == "cudaLaunchKernel") / 2}
print(json.dumps(res))
"""

_FULL_CHILD = r"""
import contextlib, io, json, sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
with contextlib.redirect_stdout(io.StringIO()) as buf:
    cs.phase_full(torch.device("cuda"))
out = json.loads(buf.getvalue().strip().splitlines()[-1])
print(json.dumps({"full": {"ms_per_step": [out["ms_per_bank_step"]],
                           "predict_s_s": out["predict_s_s"]}}))
"""

_WHITEN_CHILD = r"""
import contextlib, io, json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
dev = torch.device("cuda")
amt_f0 = 261.6 * 2 ** (np.arange(8) / 12)
sosp_f0 = 261.6 * 2 ** (np.array([0, 4, 7]) / 12)
cases = {"a_sosp": cs._whiten_inputs(222, 2001, 112, cs._harmonics(sosp_f0, 5, 16000.0),
                                     16000.0),
         "b_amt": cs._whiten_inputs(43, 2001, 160, cs._harmonics(amt_f0, 10, 44100.0),
                                    44100.0)}
with contextlib.redirect_stdout(io.StringIO()):
    out = {k: cs._whiten_case(k, d, dev, timing=True)["times"] for k, d in cases.items()}
# then each kernel's device time by CUDA kernel (torch.profiler, 5 calls)
import importlib
from torch.profiler import ProfilerActivity, profile
fw = importlib.import_module("gpitch_tpu_torch.linalg.fused_whiten")
names = ("zc", "xc", "err", "linv", "du", "dv", "energy", "freq", "var", "inv_l")
for k, d in cases.items():
    args = [torch.as_tensor(np.array(d[n]), dtype=torch.float32, device=dev) for n in names]
    for part, call in (("A", lambda: fw._forward_kernel(*args[:4], *args[6:])),
                       ("B", lambda: fw.fused_whiten_bwd(*args))):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call()
            torch.cuda.synchronize()
        out[k][f"kernel_{part}_parts_ms"] = {e.key[:60]: cs._device_us(e) / 5e3
                                             for e in prof.key_averages() if cs._device_us(e) > 0}
res = {}
for k, v in out.items():
    res[f"{k}_A"] = {"ms_per_step": [v["kernel_A_ms"]]}
    res[f"{k}_B"] = {"ms_per_step": [v["kernel_B_ms"]]}
    res[k] = v
print(json.dumps(res))
"""

POINTS = ("fresh", "after_predict", "after_kernel_phases", "built_after_kernel_phases")


def main() -> int:
    args = sys.argv[1:]
    modes = {"--amt": (_AMT_CHILD, ("sounding", "piano88")),
             "--full": (_FULL_CHILD, ("full",)),
             "--whiten": (_WHITEN_CHILD, ("a_sosp_A", "b_amt_A", "a_sosp_B", "b_amt_B"))}
    child, points = modes.get(args[0], (_CHILD, POINTS)) if args else (_CHILD, POINTS)
    names = args[1:] if args and args[0] in modes else args
    trees = [os.path.abspath(t) for t in names]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for i, tree in enumerate(trees):
        res = subprocess.run([sys.executable, "-c", child, tree], capture_output=True,
                             text=True, timeout=600, cwd=tree)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return 1
        run = {"run": i, "tree": names[i],
               **json.loads(res.stdout.strip().splitlines()[-1])}
        print(json.dumps(run), flush=True)
        runs.append(run)
    summary = {}
    for name in dict.fromkeys(r["tree"] for r in runs):
        summary[name] = {p: statistics.median(ms for r in runs if r["tree"] == name
                                              for ms in r[p]["ms_per_step"])
                         for p in points}
    print(json.dumps({"median_ms_per_step": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
