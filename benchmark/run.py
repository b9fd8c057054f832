#!/usr/bin/env python3
"""Run one cell of the benchmark of gpitch_tpu_torch once, on the card.

    python3 benchmark/run.py --workload sosp14-adam --seed 7 --seconds 30 --trace 0

from the root of a checkout.  The last line of standard output is the
result: {"correct", "attempted", "failed", "metrics", "device"[,
"breakdown"], "checks"}; with ``--trace 0`` the metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics.  The last
lines of standard error give each compared number beside its limit.
Without a CUDA card (or with fewer than the cell asks for) the run fails
and prints no result; so does a run whose process holds JAX or the JAX
package once its window has closed.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from benchmark import harness

    _, cell, _, _ = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(harness.device_line(), file=sys.stderr, flush=True)
    result = harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                         started=STARTED)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run's process holds modules it may not: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
