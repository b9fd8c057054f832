#!/usr/bin/env python3
"""Runs of cells one after another, each a fresh process, and their spread.

    python3 benchmark/series.py --seconds 30 --out chiprun_out/set1.jsonl \
        sosp14-adam:101:0 sosp14-adam:102:0 sosp14-adam:103:1

Each argument is workload:seed:trace.  Every run's result line (with its
wall time and exit code) is appended to ``--out``; at the end, for each
workload and trace, every metric's median and its spread (the distance
between the first and third quartiles by ``statistics.quantiles(n=4)``,
over the median) is printed.  A tool for setting bounds; the checks do not
run it.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spread(values):
    if len(values) < 2:
        return float("nan")
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("runs", nargs="+")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    got = defaultdict(lambda: defaultdict(list))
    for item in args.runs:
        workload, seed, trace = item.split(":")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                               "--workload", workload, "--seed", seed,
                               "--seconds", str(args.seconds), "--trace", trace],
                              cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            result = None
        rec = {"workload": workload, "seed": int(seed), "trace": int(trace), "rc": proc.returncode,
               "wall_s": wall, "result": result,
               "stderr_tail": proc.stderr[-3000:] if result is None or not result["correct"]
               else proc.stderr[-600:]}
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        short = None if result is None else {
            "correct": result["correct"],
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            "checks": {k: v["value"] for k, v in result["checks"].items()},
            "peak_gib": result["device"]["memory_peak_bytes"] / 2 ** 30}
        print(json.dumps({"run": item, "rc": proc.returncode, "wall_s": round(wall, 1),
                          "result": short}), flush=True)
        if result is None:
            print(proc.stderr[-3000:], flush=True)
            continue
        for k, v in result["metrics"].items():
            got[(workload, trace)][k].append(v["value"])
    for (workload, trace), metrics in got.items():
        for k, values in metrics.items():
            print(json.dumps({"workload": workload, "trace": trace, "metric": k,
                              "median": statistics.median(values),
                              "spread": spread(values), "values": values}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
