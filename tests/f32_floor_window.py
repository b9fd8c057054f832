"""Window 12 of amt-1s alone under per-window L-BFGS in float32, in the JAX
package and in the port, both on the CPU.

On an H100 the port's 43-window amt-1s run (``chip_smoke.py`` phase
``lbfgs`` c) drove window 12 to a best loss of -1.29e12, below the least
value any state of the window can give, 0.5 N log(2 pi sigma^2) at the
noise floor sigma^2 = 1e-6 (-11984 for N = 2001).  Windows are
independent, so the window is run alone here for 20 iterations: the JAX
package in f32 (x64 off: ``optimize_bank(method="lbfgs")``, optax's
L-BFGS) and the port in f32 on the CPU, where the bound's fused route runs
its plain versions.  Prints one JSON line per package: the loss at each
iteration, the best, whether it crosses the floor, and the count of
non-finite values.

    JAX_PLATFORMS=cpu python tests/f32_floor_window.py
    python tests/f32_floor_window.py --port-on cuda   # the port alone, on the card
"""

import json
import os
import sys

WINDOW, ITERATIONS, N = 12, 20, 2001


def _record(name, losses, sigma2_floor=1e-6):
    import numpy as np
    losses = np.asarray(losses, dtype=np.float64).reshape(-1)
    floor = 0.5 * N * np.log(2 * np.pi * sigma2_floor)
    finite = losses[np.isfinite(losses)]
    best = float(finite.min()) if finite.size else float("nan")
    return {"package": name, "window": WINDOW, "iterations": ITERATIONS,
            "losses": losses.tolist(), "best": best, "floor": float(floor),
            "below_floor": bool(finite.size and best < floor),
            "nonfinite": int((~np.isfinite(losses)).sum())}


def run_jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    from gpitch_tpu.pipelines import windowed_sgpr as jws
    from tests_tpu.workloads import make_amt
    bank = jax.tree_util.tree_map(lambda a: a[WINDOW:WINDOW + 1], make_amt(1.0).bank)
    assert bank.X.raw.dtype.name == "float32"
    _, losses = jws.optimize_bank(bank, num_steps=ITERATIONS, method="lbfgs")
    return _record("gpitch_tpu (JAX, f32, CPU)", losses)


def run_port(device="cpu"):
    import torch
    import chip_smoke
    from gpitch_tpu_torch.core.params import take_windows
    from gpitch_tpu_torch.pipelines.windowed_sgpr import optimize_bank
    model, _ = chip_smoke.make_amt(1.0, device, torch.float32)
    bank = take_windows(model.bank, slice(WINDOW, WINDOW + 1))
    _, losses, info = optimize_bank(bank, ITERATIONS, method="lbfgs", return_info=True)
    route = "plain versions" if device == "cpu" else "CUDA kernels"
    rec = _record(f"gpitch_tpu_torch (f32, {device}, {route})", losses)
    rec["fused_eligible"] = bank.fused_eligible()
    rec["windows_nonfinite"] = info["windows_nonfinite"]
    return rec


if __name__ == "__main__":
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    if "--port-on" in sys.argv:
        print(json.dumps(run_port(sys.argv[sys.argv.index("--port-on") + 1])), flush=True)
    else:
        for run in (run_jax, run_port):
            print(json.dumps(run()), flush=True)
