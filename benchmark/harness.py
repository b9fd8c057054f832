"""One run of one cell: set-up, the window, the traced stretch, the check.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``,
its configuration's file, ``traffic/<traffic>.json`` (whose ``kind`` names
the driver), ``limits/<workload>.json`` and, for a traced run, one reader
per per-layer metric: ``metrics/<metric>.py``, or ``metrics/<quantity>.py``
for the names ``<quantity>.<part>`` of a quantity split by what it moves.  A new cell, configuration,
mix or metric is new files and new entries, with no edit here.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

from . import check, counts, drivers

__all__ = ["BENCH_DIR", "FORBIDDEN", "load_cell", "run", "forbidden_modules",
           "device_line"]

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
# top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "gpitch_tpu")


def load_cell(root: str, workload: str):
    """(the spec, the cell, its configuration, its traffic) by name."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(BENCH_DIR, "traffic", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    return spec, cell, config, traffic


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def device_line() -> str:
    """The card's name and power limit."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi unavailable ({e})"
    return f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}"


def _reader(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, or
    for a quantity split by what it moves (``mfu.job``) the quantity's
    own ``metrics/<name before the first dot>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    if not os.path.exists(path):
        name = name.split(".")[0]
        path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _listed(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def run(root: str, workload: str, seed: int, seconds: float, trace: bool,
        device="cuda", started: float | None = None, config: dict | None = None,
        limits: dict | None = None) -> dict:
    """One run of ``workload``: returns the result (the keys of the result
    line, ``checks`` last).  ``started``: the process's start on the host
    clock (set-up is counted from it); ``config`` and ``limits`` replace the
    cell's own (tests run a cell at a small size on the CPU)."""
    started = time.perf_counter() if started is None else started
    spec, cell, cell_config, traffic = load_cell(root, workload)
    config = cell_config if config is None else config
    limits = check.load_limits(BENCH_DIR, workload) if limits is None else limits
    on_card = torch.device(device).type == "cuda"
    drv = drivers.KINDS[traffic["kind"]](config, traffic, seed, seconds, device)
    drv.setup()
    _sync(on_card)
    setup_s = time.perf_counter() - started
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    window = drv.window()
    prof = drv.profiled() if trace and on_card else None
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    got = drv.outputs()
    drv.release()
    truth = drv.reference_outputs(torch.float64)
    readings = drv.compare(got, truth)
    ok, checks = check.judge(readings, limits)

    if trace:
        ctx = SimpleNamespace(driver=drv, profile=prof, counts=counts)
        metrics = {}
        for m in spec["per_layer"]:
            if _listed(m, workload):
                value = _reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": window["metrics"][m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"]
                   if _listed(m, workload) and m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    result = {"correct": bool(ok and window["failed"] == 0),
              "attempted": window["attempted"], "failed": window["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                         "count": cell["chips"], "memory_peak_bytes": int(peak)}}
    if prof is not None:
        result["device"].update(busy_s=prof.busy_s, window_s=prof.window_s)
        result["breakdown"] = {"device_ops": prof.top_ops(), "idle_gaps": prof.idle_gaps()}
    result["checks"] = checks
    return result


def _sync(on_card: bool) -> None:
    if on_card:
        torch.cuda.synchronize()
