#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gpitch_tpu_torch) on one CUDA card.

Run from the repository root:   python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:
  1. device   the card, its power limit, and the f32 matmul mode (full f32);
  2. build    both CUDA kernels, one nvcc each, started together;
  3. chol     the Cholesky kernel against its plain version and
              torch.linalg.cholesky_ex, at the bank shapes, on random SPD,
              ill-conditioned and low-rank Grams;
  4. specmix  the spectral-mixture kernel against its plain version at the
              prediction shapes, both envelopes;
  5. sosp     separation end to end (4 s synthetic mix, ws 2001, M 112,
              3 pitches x 5 partials): 100 Adam steps in f32 held against
              the CPU-f64 golden trajectory (tests_tpu/goldens.npz), then
              predict_f, predict_s, the overlap-add merge and the RMSE;
              the kernels' launch counts are read over this phase only;
  6. small    a 0.5 s separation in f64 on the card and on the CPU, which
              must agree;
  7. first_use  a fresh process through the main path: import, build, each
              of three steps' parts, the first predictions, and what
              torch.optim.Adam would add;
  8. full     the 14 s mix (222 windows): 20 Adam steps and predict_s;
  9. profile  torch.profiler over 5 of those steps and one predict_s;
then the kernels line, the nvidia-smi line and the result line.
Exits non-zero without printing a result when there is no CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12           # H100 SXM f32 outside the tensor cores

FS = 16000.0
PITCHES = [60, 64, 67]
ONSETS = [(60, 0.1), (64, 0.8), (67, 1.6), (60, 2.4), (64, 3.1)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------- workload
def _f0(midi: int) -> float:
    return 440.0 * 2.0 ** ((midi - 69) / 12.0)


def make_sosp(seconds: float, device, dtype, onsets=ONSETS, max_par=5,
              num_inducing=112, note_seconds=2.0):
    """The separation workload of tests_tpu/workloads.make_sosp: piano-like
    notes (seeded by pitch) at the given onsets.  Returns (model, sources)."""
    from gpitch_tpu_torch.audio.io import synth_piano_note
    from gpitch_tpu_torch.pipelines import SoSp
    n = int(FS * seconds)
    notes = {p: synth_piano_note(fs=FS, seconds=note_seconds, f0=_f0(p), seed=p)[1][:, 0]
             for p in PITCHES}
    sources = {p: np.zeros(n) for p in PITCHES}
    for p, on in onsets:
        i0 = int(on * FS)
        seg = notes[p][: n - i0]
        sources[p][i0: i0 + len(seg)] += seg
    mix = sum(sources.values())
    x = (np.arange(n) / FS).reshape(-1, 1)
    model = SoSp(train_signals=[notes[p] for p in PITCHES],
                 train_names=[f"piano_M{p}_train.wav" for p in PITCHES],
                 fs=FS, mixture=(x, mix), window_size=2001, kernel_mode="fft",
                 max_par=max_par, num_inducing=num_inducing, dec=2,
                 device=device, dtype=dtype)
    return model, [sources[p] for p in PITCHES]


# ------------------------------------------------------------------- phases
def phase_device() -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    assert torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmuls are on"
    assert torch.get_float32_matmul_precision() == "highest"
    out = {"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "torch": torch.__version__,
           "cuda": torch.version.cuda, "allow_tf32": False}
    emit(out)
    return out


def phase_build() -> None:
    from gpitch_tpu_torch.linalg import _cuda
    t0 = time.perf_counter()
    built = _cuda.build()
    seconds = time.perf_counter() - t0
    ptxas = {}
    for name in built:
        lines = (_cuda.BUILD_DIR / f"{name}.ptxas.txt").read_text().splitlines()
        ptxas[name] = [ln.split("ptxas info    : ")[-1] for ln in lines
                       if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "built": built, "seconds": seconds, "ptxas": ptxas})


def _spd(b, m, gen, dtype):
    A = torch.randn(b, m, m, generator=gen, dtype=torch.float64) / np.sqrt(m)
    return (A @ A.mT + 0.5 * torch.eye(m, dtype=torch.float64)).to(dtype)


def _ill_gram(b, m, dtype):
    """The strongly correlated Gram of gpitch_tpu/linalg/ops.py:169-171."""
    i = np.arange(m, dtype=np.float64)
    corr = np.exp(-np.abs(i[:, None] - i[None, :]) / max(m / 3.0, 1.0))
    g = corr + 1e-3 * np.eye(m)
    return torch.as_tensor(np.broadcast_to(g, (b, m, m)).copy(), dtype=dtype)


def _low_rank_gram(b, dtype, device):
    """The summed rank-2P Mercer Gram of
    tests_tpu/test_shipped_defaults.py:61-74, after add_jitter."""
    from gpitch_tpu_torch.kernels import MercerMatern12sm, StackedSum
    from gpitch_tpu_torch.core.params import to_device
    from gpitch_tpu_torch.linalg import add_jitter
    m, fs = 160, 44100.0
    z = torch.as_tensor((np.arange(m) * 12.0 / fs).reshape(-1, 1), dtype=dtype,
                        device=device)
    kerns = []
    for i in range(8):
        f0 = 261.6 * 2 ** (i / 12.0)
        freqs = np.minimum(f0 * np.arange(1, 11), 0.45 * fs)
        energy = np.full(10, 1e-4)
        energy[0] = 4.0
        kerns.append(MercerMatern12sm.create(0.8 if i == 4 else 0.014, 3.4,
                                             energy, freqs, dtype=dtype))
    kern = to_device(StackedSum.create(kerns), device)
    with torch.no_grad():
        kuu = kern.K(z)
    return add_jitter(kuu.expand(b, m, m).contiguous())


def phase_chol(dev) -> dict:
    from gpitch_tpu_torch.linalg.chol import cholesky_batched, cholesky_plain
    gen = torch.Generator().manual_seed(0)
    cases = [("spd", (62, 112), torch.float32), ("spd", (63, 112), torch.float32),
             ("spd", (222, 112), torch.float32), ("spd", (64, 160), torch.float32),
             ("spd", (8, 256), torch.float32), ("spd", (5, 24), torch.float32),
             ("spd", (8, 256), torch.float64), ("spd", (62, 112), torch.float64),
             ("ill", (62, 112), torch.float32), ("ill", (64, 160), torch.float32),
             ("low_rank", (64, 160), torch.float32)]
    rows = []
    for kind, (b, m), dtype in cases:
        if kind == "spd":
            K = _spd(b, m, gen, dtype).to(dev)
        elif kind == "ill":
            K = _ill_gram(b, m, dtype).to(dev)
        else:
            K = _low_rank_gram(b, dtype, dev)
        L = cholesky_batched(K)
        Lp = cholesky_plain(K)
        Ll, info = torch.linalg.cholesky_ex(K)
        torch.cuda.synchronize()
        scale = float(Lp.abs().max())
        err_plain = float((L - Lp).abs().max())
        err_lib = float((L - Ll).abs().max())
        tol = (1e-4 if kind == "spd" else 1e-3) * scale
        if dtype == torch.float64:
            tol = 1e-10 * scale
        ok = (bool(torch.isfinite(L).all()) and int(info.max()) == 0
              and err_plain <= tol and err_lib <= tol
              and float(torch.triu(L, 1).abs().max()) == 0.0)
        row = {"kind": kind, "shape": [b, m, m], "dtype": str(dtype).split(".")[-1],
               "max_abs_err_plain": err_plain, "max_abs_err_library": err_lib,
               "scale": scale, "tol": tol, "ok": ok}
        if kind == "spd" and dtype == torch.float32 and m in (112, 160, 256):
            row["kernel_ms"] = cuda_ms(lambda: cholesky_batched(K), 50)
            row["plain_ms"] = cuda_ms(lambda: cholesky_plain(K), 3, warmup=1)
            row["library_ms"] = cuda_ms(lambda: torch.linalg.cholesky_ex(K), 50)
            # the kernel reads K's lower triangle and writes all of L
            nbytes = K.element_size() * b * (m * (m + 1) // 2 + m * m)
            row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 2 * b * m ** 3 / 3)
        rows.append(row)
        assert ok, f"cholesky kernel disagrees: {row}"
    out = {"phase": "chol", "cases": rows}
    emit(out)
    return out


def phase_specmix(dev) -> dict:
    from gpitch_tpu_torch.linalg.specmix import specmix_matrix, specmix_plain
    b, s, p = 8, 3, 5
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    def inputs(n, m):
        """predict_s builds (S, N, N) Grams of a window's points against
        themselves; predict_f sums the sources of the (N=112 inducing, M=2001)
        cross-covariance."""
        x = t(np.sort(rng.uniform(0.0, 0.125, (b, n)), axis=1))
        x2 = x if m == n else t(np.sort(rng.uniform(0.0, 0.125, (b, m)), axis=1))
        energy = rng.uniform(0.1, 1.0, (b, s, p))
        return (x, x2, t(energy / energy.sum(-1, keepdims=True)),
                t(rng.uniform(100.0, 4000.0, (b, s, p))), t(rng.uniform(0.5, 2.0, (b, s))),
                t(rng.uniform(0.05, 0.3, (b, s))))

    rows = []
    for n, m, m32, sum_sources in ((2001, 2001, False, False), (2001, 2001, True, False),
                                   (112, 2001, False, True)):
        args = inputs(n, m)
        with torch.no_grad():
            K = specmix_matrix(*args, m32=m32, sum_sources=sum_sources)
            Kp = specmix_plain(*args, m32=m32, sum_sources=sum_sources)
            Ks = specmix_matrix(*args, m32=m32, sum_sources=True)
            Ksp = Kp if sum_sources else Kp.sum(1)
        torch.cuda.synchronize()
        scale = float(Kp.abs().max())
        err = float((K - Kp).abs().max())
        err_sum = float((Ks - Ksp).abs().max())
        # same f32 arguments on both sides; cosf/expf vs torch's within a few
        # ulp, and up to P + 1 terms summed (S (P + 1) with sum_sources)
        tol = (3e-5 if sum_sources else 1e-5) * scale
        ok = bool(torch.isfinite(K).all()) and err <= tol and err_sum <= 3e-5 * scale
        nout = b * n * m * (1 if sum_sources else s)
        nbytes = 4 * b * (n + m + 4 * s * p) + 4 * nout
        flops = b * s * n * m * (4 * p + 6)
        row = {"m32": m32, "sum_sources": sum_sources, "shape": [b, s, n, m, p],
               "max_abs_err": err, "max_rel_err": err / scale,
               "max_abs_err_sum_sources": err_sum, "tol": tol, "ok": ok,
               "kernel_ms": cuda_ms(lambda: specmix_matrix(
                   *args, m32=m32, sum_sources=sum_sources), 20),
               "plain_ms": cuda_ms(lambda: specmix_plain(
                   *args, m32=m32, sum_sources=sum_sources), 3, warmup=1)}
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops)
        rows.append(row)
        assert ok, f"specmix kernel disagrees: {row}"
    out = {"phase": "specmix", "cases": rows}
    emit(out)
    return out


def phase_sosp(dev) -> dict:
    """The main path: SoSp built, trained, predicted and scored on the card."""
    from gpitch_tpu_torch.linalg.chol import cholesky_batched as chol
    from gpitch_tpu_torch.linalg.specmix import specmix_matrix as spec
    golden = np.load(os.path.join(ROOT, "tests_tpu", "goldens.npz"))["sosp_losses"]
    chol.launches = spec.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, sources = make_sosp(4.0, dev, torch.float32)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    losses = model.optimize(maxiter=100, learning_rate=0.01)
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t0
    chol_opt = chol.launches
    t0 = time.perf_counter()
    mean, var = model.predict_f()
    torch.cuda.synchronize()
    predict_f_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    est = model.predict_s()
    predict_s_s = time.perf_counter() - t0
    rmse = model.compute_rmse(sources)
    launches = {"cholesky_batched": chol.launches, "specmix_matrix": spec.launches}
    # steady state, after the main path: 20 more steps of the trained bank
    t0 = time.perf_counter()
    model.optimize(maxiter=20, learning_rate=0.01)
    torch.cuda.synchronize()
    steady_ms = (time.perf_counter() - t0) / 20 * 1e3
    out = {"phase": "sosp", "windows": model.nwin, "M": int(model.z.shape[1]),
           "loss0": float(losses[0]), "loss99": float(losses[-1]),
           "golden0": float(golden[0]), "golden99": float(golden[-1]),
           "rel0": float(abs(losses[0] / golden[0] - 1)),
           "rel99": float(abs(losses[-1] / golden[-1] - 1)),
           "steps_per_s": 100 / opt_s, "optimize_s": opt_s, "build_s": build_s,
           "steady_ms_per_bank_step": steady_ms,
           "first_use_overhead_s": opt_s - 100 * steady_ms / 1e3,
           "predict_f_s": predict_f_s, "predict_s_s": predict_s_s, "rmse": rmse,
           "source_rms": [float(np.sqrt(np.mean(s ** 2))) for s in sources],
           "chol_launches_per_step": chol_opt / 100, "launches": launches,
           "native_dsp": _native_path()}
    emit(out)
    assert np.isfinite(losses).all(), "non-finite losses"
    assert out["rel0"] <= 5e-3, f"loss[0] off the golden: {out['rel0']}"
    assert out["rel99"] <= 0.1, f"loss[99] off the golden: {out['rel99']}"
    assert losses[-1] < losses[0], "loss did not decrease"
    assert np.isfinite(mean).all() and np.isfinite(var).all()
    assert all(np.isfinite(e[0]).all() and np.isfinite(e[1]).all()
               and e[0].shape == (sources[0].shape[0], 1) for e in est)
    # predicting silence scores the mean source RMS (0.145); the CPU-f64 run
    # of the same 100 steps scores 0.0205
    assert np.isfinite(rmse) and rmse < 0.3 * np.mean(out["source_rms"]), \
        "separation failed"
    assert all(v > 0 for v in launches.values()), f"a kernel never ran: {launches}"
    return out


def _native_path() -> str:
    from gpitch_tpu_torch import native
    return "native" if native.enabled() else "numpy"


def phase_small(dev) -> dict:
    """A 0.5 s separation in f64 on the card against the same on the CPU."""
    onsets = [(60, 0.0), (64, 0.1), (67, 0.2)]
    res = {}
    for d in (dev, torch.device("cpu")):
        model, sources = make_sosp(0.5, d, torch.float64, onsets=onsets,
                                   max_par=3, num_inducing=32, note_seconds=1.0)
        losses = model.optimize(maxiter=5, learning_rate=0.01)
        est = model.predict_s()
        res[d.type] = (losses, np.stack([e[0] for e in est]))
    rel = float(np.abs(res["cuda"][0] / res["cpu"][0] - 1).max())
    err = float(np.abs(res["cuda"][1] - res["cpu"][1]).max())
    out = {"phase": "small", "loss_rel_err": rel, "source_max_abs_err": err}
    emit(out)
    # f64 on both sides; the factorizations differ in summation order only
    assert rel <= 1e-9 and err <= 1e-8, out
    return out


# A fresh process through the main path (4 s mix, 62 windows): import and
# context, the model build, three bank steps split into forward, backward
# and Adam update as fit_adam_segmented runs them, the first predict_f and
# predict_s; then whether a heavy module was imported on the way, and last
# the construction of a torch.optim.Adam over the same leaves, the one-time
# cost that the port's own Adam avoids.  argv: repository root, device.
_FIRST_STEPS = r"""
import json, sys, time
t0 = time.perf_counter()
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
from gpitch_tpu_torch.core.params import trainable_tensors
from gpitch_tpu_torch.models.fit import Adam
from gpitch_tpu_torch.pipelines.windowed_sgpr import bank_loss
dev = torch.device(sys.argv[2])
def sync():
    if dev.type == "cuda":
        torch.cuda.synchronize()
torch.zeros(1, device=dev)
sync()
out = {"import_and_context_s": time.perf_counter() - t0}
t0 = time.perf_counter()
model, _ = chip_smoke.make_sosp(4.0, dev, torch.float32)
sync()
out["model_build_s"] = time.perf_counter() - t0
opt = Adam(trainable_tensors(model.bank), lr=0.01)
out["steps"] = []
for _ in range(3):
    t = [time.perf_counter()]
    opt.zero_grad()
    loss = bank_loss(model.bank)
    sync(); t.append(time.perf_counter())
    loss.backward()
    sync(); t.append(time.perf_counter())
    opt.step()
    sync(); t.append(time.perf_counter())
    out["steps"].append({"forward_s": t[1] - t[0], "backward_s": t[2] - t[1],
                         "adam_s": t[3] - t[2]})
for name, run in (("predict_f_s", model.predict_f), ("predict_s_s", model.predict_s)):
    t0 = time.perf_counter()
    run()
    out[name] = time.perf_counter() - t0
out["heavy_imports"] = [m for m in ("torch._dynamo", "sympy") if m in sys.modules]
t0 = time.perf_counter()
torch.optim.Adam(trainable_tensors(model.bank), lr=0.01)
out["torch_optim_adam_construct_s"] = time.perf_counter() - t0
print(json.dumps(out))
"""


def phase_first_use() -> dict:
    """The one-time costs of a fresh process's first pass through the main
    path (CUDA's default lazy module loading: a kernel's module loads at its
    first launch)."""
    res = subprocess.run([sys.executable, "-c", _FIRST_STEPS, ROOT, "cuda"],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"first_use failed:\n{res.stderr[-4000:]}")
    out = {"phase": "first_use", **json.loads(res.stdout.strip().splitlines()[-1])}
    emit(out)
    assert not out["heavy_imports"], f"the main path imported {out['heavy_imports']}"
    return out


def phase_full(dev) -> dict:
    """14 s of the mix, the onset pattern repeated every 4 s (222 windows)."""
    onsets = [(p, on + 4.0 * k) for k in range(4) for p, on in ONSETS
              if on + 4.0 * k < 14.0]
    t0 = time.perf_counter()
    model, sources = make_sosp(14.0, dev, torch.float32, onsets=onsets)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.optimize(maxiter=2, learning_rate=0.01)        # warm-up
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    losses = model.optimize(maxiter=20, learning_rate=0.01)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.predict_s()
    predict_s = time.perf_counter() - t0
    rmse = model.compute_rmse(sources)
    out = {"phase": "full", "windows": model.nwin, "build_s": build_s,
           "warmup_2_steps_s": warmup_s, "ms_per_bank_step": step_ms,
           "predict_s_s": predict_s,
           "predict_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
           "rmse_after_22_steps": rmse}
    emit(out)
    assert np.isfinite(losses).all() and np.isfinite(rmse)
    return model


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def phase_profile(model) -> None:
    """Where a bank step and predict_s spend device time (222 windows):
    torch.profiler over 5 Adam steps and over one predict_s; top ops by
    self device time and the device's busy share of the host wall time."""
    from torch.profiler import ProfilerActivity, profile
    for what, run in (("5 bank steps", lambda: model.optimize(maxiter=5)),
                      ("predict_s", lambda: model.predict_s())):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        rows = prof.key_averages()
        cuda = torch.autograd.DeviceType.CUDA
        kernels = sorted((e for e in rows if getattr(e, "device_type", None) == cuda),
                         key=_device_us, reverse=True)
        ops = sorted((e for e in rows if getattr(e, "device_type", None) != cuda),
                     key=_device_us, reverse=True)
        device_us = sum(_device_us(e) for e in kernels)

        def top(evts, n):
            return [{"name": e.key[:70], "device_ms": _device_us(e) / 1e3,
                     "calls": e.count} for e in evts[:n]]

        emit({"phase": "profile", "window": what, "wall_ms": wall_us / 1e3,
              "device_ms": device_us / 1e3, "device_busy_share": device_us / wall_us,
              "top_ops": top(ops, 10), "top_kernels": top(kernels, 10)})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import gpitch_tpu_torch  # noqa: F401  (fails outside the repository)
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    device = phase_device()
    phase_build()
    chol = phase_chol(dev)
    spec = phase_specmix(dev)
    sosp = phase_sosp(dev)
    phase_small(dev)
    phase_first_use()
    phase_profile(phase_full(dev))

    main_chol = next(r for r in chol["cases"] if r["kind"] == "spd"
                     and r["shape"] == [sosp["windows"], 112, 112]
                     and r["dtype"] == "float32")
    main_spec = spec["cases"][0]
    kernels = [
        {"name": "cholesky_batched", "route": "cuda",
         "source": "gpitch_tpu_torch/csrc/chol.cu",
         "replaces": "gpitch_tpu/linalg/pallas/chol.py:131",
         "launches": sosp["launches"]["cholesky_batched"],
         "shape": main_chol["shape"],
         "max_abs_err": main_chol["max_abs_err_plain"], "ms": main_chol["kernel_ms"],
         "plain_ms": main_chol["plain_ms"], "bound_ms": main_chol["bound_ms"],
         "bound_by": main_chol["bound_by"], "library_ms": main_chol["library_ms"]},
        {"name": "specmix_matrix", "route": "cuda",
         "source": "gpitch_tpu_torch/csrc/specmix.cu",
         "replaces": "gpitch_tpu/linalg/pallas/specmix.py:49",
         "launches": sosp["launches"]["specmix_matrix"],
         "shape": main_spec["shape"],
         "max_abs_err": main_spec["max_abs_err"], "ms": main_spec["kernel_ms"],
         "plain_ms": main_spec["plain_ms"], "bound_ms": main_spec["bound_ms"],
         "bound_by": main_spec["bound_by"], "library_ms": None},
    ]
    emit({"kernels": kernels})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(device["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
