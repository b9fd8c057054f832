#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gpitch_tpu_torch) on one CUDA card.

Run from the repository root:   python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:
  1. device   the card, its power limit, and the f32 matmul mode (full f32);
  2. build    the three CUDA sources, one nvcc each, started together;
  3. chol     the Cholesky kernel against its plain version and
              torch.linalg.cholesky_ex, at the bank shapes, on random SPD,
              ill-conditioned and low-rank Grams;
  4. specmix  the spectral-mixture kernel against its plain version and the
              f64 plain version at the prediction shapes, both envelopes,
              and at the AMT width;
              in 3 and 4 the kernel, its plain version and the library call
              (or fill_) are each timed as device time (graph_ms), the
              kernel and the library call also from Python (cuda_ms);
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
  9. fused_whiten  the fused build -> whiten -> accumulate pair (kernel A
              through fused_whiten and fused_whiten_flat, kernel B) against
              its plain version: (a) the prototypes' inputs at the SoSp width,
              (b) the AMT width, (c) an 88-pitch dictionary, (d) the trained
              62- and 222-window banks' own bound (AAT, Aerr and every raw
              leaf's gradient; the pair's launch counts are read over (d)),
              (e) times at (a) and (b), and at each split of a window's
              tiles over blocks;
 10. amt      transcription end to end (tests_tpu/workloads.make_amt: 1 s
              at 44.1 kHz, 43 windows, M 160, 8 pitches x 10 partials,
              y x 20): 100 Adam steps in windows of 16 held against the
              CPU-f64 golden trajectory, matrix_var, the MAD pianoroll's
              F-measure; the Cholesky kernel's launches over this phase;
 11. amt_full the AMT bank at full width: 10 s (439 windows, 8 x 10,
              windows of 64) and the 88-pitch dictionary on 2 s (windows
              of 16): ms per bank step and peak memory;
 12. modgp    the ModGP SVGP model: the golden fixture in f64 and f32, the
              demo (N 16000, 1000 minibatch Adam steps, source RMSE) and
              the bench workload (M 128, 2000 steps, steps/s);
 13. profile  torch.profiler over 5 bank steps and one predict_s of 8's
              222-window bank, 5 bank steps of 11's 10 s bank and 50 ModGP
              steps, last because its tracing may stay attached;
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


def graph_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Mean device time of one call of ``fn``: ``reps`` calls captured in a
    CUDA graph, replayed, timed by CUDA events; free of the host's per-call
    cost, which ``cuda_ms`` includes when a call is short.  A kernel and
    what it is compared with are timed the same way."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    stop.synchronize()
    graph.reset()
    return start.elapsed_time(stop) / (replays * reps)


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


AMT_FS = 44100.0
AMT_PITCHES = [60, 62, 64, 65, 67, 69, 71, 72]          # C major, C4 to C5


def make_amt(seconds: float, device, dtype, pitches=AMT_PITCHES, max_par=10,
             reg=False):
    """The transcription workload of tests_tpu/workloads.make_amt: the C
    major scale as piano-like notes (seeded by pitch) with onsets 0.05 +
    0.11 i s, repeated every 1 s over ``seconds``, at 44.1 kHz; ws 2001, M
    160, dec 3, y x 20.  ``pitches`` is the model's dictionary (the scale's
    notes, or MIDI 21-108).  Returns (model, note events (onset, offset,
    midi))."""
    from gpitch_tpu_torch.audio.io import synth_piano_note
    from gpitch_tpu_torch.pipelines import AMT
    n = int(AMT_FS * seconds)
    notes = {p: synth_piano_note(fs=AMT_FS, seconds=2.0, f0=_f0(p), seed=p)[1][:, 0]
             for p in sorted(set(pitches) | set(AMT_PITCHES))}
    onsets = [(p, 0.05 + 0.11 * i + k) for k in range(int(np.ceil(seconds)))
              for i, p in enumerate(AMT_PITCHES) if 0.05 + 0.11 * i + k < seconds]
    mix = np.zeros(n)
    for p, on in onsets:
        i0 = int(on * AMT_FS)
        seg = notes[p][: n - i0]
        mix[i0: i0 + len(seg)] += seg
    x = (np.arange(n) / AMT_FS).reshape(-1, 1)
    model = AMT(train_signals=[notes[p] for p in pitches],
                train_names=[f"piano_M{p}_train.wav" for p in pitches], fs=AMT_FS,
                test=(x, mix), pitches=pitches, window_size=2001, kernel_mode="fft",
                max_par=max_par, num_inducing=160, dec=3, reg=reg, device=device,
                dtype=dtype)
    return model, [(on, on + 2.0, p) for p, on in onsets]


def golden_modgp(dtype, device):
    """The seeded 2-source ModGP of tests/test_golden.py:23-50 (random q_mu,
    scaled lower-triangular q_sqrt), built with the port.  Returns (model,
    x, y)."""
    import dataclasses
    from gpitch_tpu_torch.core.params import Param
    from gpitch_tpu_torch.core.transforms import FillTriangular
    from gpitch_tpu_torch.kernels import Matern32, MercerMatern12sm
    from gpitch_tpu_torch.models import ModGP
    rng = np.random.default_rng(42)
    n, m, fs = 32, 8, 800.0
    x = (np.arange(n) / fs).reshape(-1, 1)
    y = (np.sin(2 * np.pi * 50.0 * x) * np.exp(-30 * (x - 0.02) ** 2)
         + 0.3 * np.sin(2 * np.pi * 80.0 * x) + 0.01 * rng.standard_normal((n, 1)))
    z = x[:: n // m][:m]
    kern_act = [Matern32.create(1.0, 0.01, dtype=dtype), Matern32.create(0.8, 0.02, dtype=dtype)]
    kern_com = [MercerMatern12sm.create(1.0, 0.05, [1.0, 0.4], [50.0, 100.0], dtype=dtype),
                MercerMatern12sm.create(0.7, 0.04, [0.8, 0.3], [80.0, 160.0], dtype=dtype)]
    model = ModGP.create(z=[[z, z], [z, z]], kern=[kern_act, kern_com],
                         noise_variance=0.09, dtype=dtype, device=device)
    q_mu_a = 0.3 * rng.standard_normal((2, m, 1))
    q_mu_c = 0.2 * rng.standard_normal((2, m, 1))
    tril = np.tril(0.05 * rng.standard_normal((2, m, m))) + 0.7 * np.eye(m)[None]

    def param(value, *transform):
        return Param.create(value, *transform, dtype=dtype, device=device)

    model = dataclasses.replace(
        model, q_mu_act=param(q_mu_a), q_mu_com=param(q_mu_c),
        q_sqrt_act=param(tril, FillTriangular(m)),
        q_sqrt_com=param(0.9 * tril, FillTriangular(m)))
    return (model, torch.as_tensor(x, dtype=dtype, device=device),
            torch.as_tensor(y, dtype=dtype, device=device))


def golden_modgp_values(model, x, y) -> dict:
    """The modgp_* quantities of tests/golden_values.json, as floats and
    lists."""
    with torch.no_grad():
        elbo = float(model.elbo(x, y))
        kl = float(model.prior_kl())
        scaled = float(model.elbo(x[:16], y[:16], num_data=32))
    names = ("modgp_mean_act", "modgp_var_act", "modgp_mean_com", "modgp_var_com",
             "modgp_mean_src")
    preds = model.predict_act_n_com(x[::8])
    out = {"modgp_elbo_whitened": elbo, "modgp_prior_kl": kl,
           "modgp_elbo_minibatch_scaled": scaled}
    out.update({k: p.double().cpu().numpy().ravel().tolist() for k, p in zip(names, preds)})
    return out


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


def _chol_at_panel(K, nb):
    """The Cholesky kernel's f32 C entry at panel width ``nb``, called
    directly (the wrapper takes panel_width(M)): for the sweep of both
    widths.  Returns a function that launches it into a fixed output."""
    from gpitch_tpu_torch.linalg import _cuda
    lib = _cuda.load("chol")
    b, m = K.shape[0], K.shape[-1]
    out = torch.empty_like(K)
    elems = lib.gpitch_chol_scratch(m, nb, K.element_size())
    scratch = torch.empty((b, elems), dtype=K.dtype, device=K.device) if elems > 0 else None

    def run():
        _cuda.check(lib.gpitch_chol_f32(
            K.data_ptr(), out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            b, m, nb, torch.cuda.current_stream().cuda_stream), "chol sweep")
    return run


def phase_chol(dev) -> dict:
    from gpitch_tpu_torch.linalg.chol import cholesky_batched, cholesky_plain
    gen = torch.Generator().manual_seed(0)
    cases = [("spd", (62, 112), torch.float32), ("spd", (63, 112), torch.float32),
             ("spd", (222, 112), torch.float32), ("spd", (64, 160), torch.float32),
             ("spd", (43, 160), torch.float32),
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
            # device times (CUDA graphs), then calls from Python
            row["kernel_ms"] = graph_ms(lambda: cholesky_batched(K))
            row["plain_ms"] = graph_ms(lambda: cholesky_plain(K), reps=1, replays=3)
            row["library_ms"] = graph_ms(lambda: torch.linalg.cholesky_ex(K))
            row["kernel_call_ms"] = cuda_ms(lambda: cholesky_batched(K), 50)
            row["library_call_ms"] = cuda_ms(lambda: torch.linalg.cholesky_ex(K), 50)
            # both panel widths the kernel has; the wrapper takes panel_width(M)
            for nb in (16, 32):
                row[f"kernel_ms_nb{nb}"] = graph_ms(_chol_at_panel(K, nb))
            # the kernel reads K's lower triangle and writes all of L
            nbytes = K.element_size() * b * (m * (m + 1) // 2 + m * m)
            row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 2 * b * m ** 3 / 3)
        rows.append(row)
        assert ok, f"cholesky kernel disagrees: {row}"
    out = {"phase": "chol", "cases": rows}
    emit(out)
    torch.cuda.empty_cache()    # later phases start from the allocator state of before
    return out


def phase_specmix(dev) -> dict:
    """The kernel against its plain version in f32 (the same features) and
    against the f64 plain version on the same inputs (the truth): 1e-6 and
    2e-6 of max|K| per source, of sum_s max|K_s| for a source sum.  Cases:
    the prediction shapes at the SoSp width (16 kHz, 3 x 5 partials to
    4 kHz, times in [0, 0.125) s), both envelopes, and the AMT width (44.1
    kHz, a centred 2001-sample window, 8 pitches from C4 x 10 partials up
    to 0.45 fs)."""
    from gpitch_tpu_torch.linalg.specmix import specmix_matrix, specmix_plain
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    def inputs(b, s, p, n, m):
        """predict_s builds (S, N, N) Grams of a window's points against
        themselves; predict_f sums the sources of the (N=112 inducing, M=2001)
        cross-covariance."""
        x = t(np.sort(rng.uniform(0.0, 0.125, (b, n)), axis=1))
        x2 = x if m == n else t(np.sort(rng.uniform(0.0, 0.125, (b, m)), axis=1))
        energy = rng.uniform(0.1, 1.0, (b, s, p))
        return (x, x2, t(energy / energy.sum(-1, keepdims=True)),
                t(rng.uniform(100.0, 4000.0, (b, s, p))), t(rng.uniform(0.5, 2.0, (b, s))),
                t(rng.uniform(0.05, 0.3, (b, s))))

    def amt_inputs(b, s, p, n):
        fs = 44100.0
        x = t(np.broadcast_to((np.arange(n) - (n - 1) / 2) / fs, (b, n)).copy())
        f0 = 261.6 * 2 ** (np.arange(s) / 12)
        freq = np.minimum(f0[:, None] * np.arange(1, p + 1), 0.45 * fs)
        energy = rng.uniform(0.1, 1.0, (b, s, p))
        return (x, x, t(energy / energy.sum(-1, keepdims=True)),
                t(np.broadcast_to(freq, (b, s, p)).copy()), t(rng.uniform(0.5, 2.0, (b, s))),
                t(rng.uniform(0.01, 0.1, (b, s))))

    rows = []
    for name, args, m32, sum_sources in (
            ("sosp", inputs(8, 3, 5, 2001, 2001), False, False),
            ("sosp", inputs(8, 3, 5, 2001, 2001), True, False),
            ("sosp", inputs(8, 3, 5, 112, 2001), False, True),
            ("amt", amt_inputs(4, 8, 10, 2001), False, False)):
        b, n = args[0].shape
        m = args[1].shape[1]
        s, p = args[2].shape[1:]
        with torch.no_grad():
            K = specmix_matrix(*args, m32=m32, sum_sources=sum_sources)
            Kp = specmix_plain(*args, m32=m32)
            Kt = specmix_plain(*[a.double() for a in args], m32=m32)
            Ks = specmix_matrix(*args, m32=m32, sum_sources=True)
        torch.cuda.synchronize()
        scale = Kt.abs().amax((-1, -2))                       # (B, S)
        scale_sum = scale.sum(1)                              # (B,)

        def rel(got, want, sc):
            return float(((got.double() - want.double()).abs().amax((-1, -2)) / sc).max())

        if sum_sources:
            err_plain, err_truth = rel(K, Kp.sum(1), scale_sum), rel(K, Kt.sum(1), scale_sum)
        else:
            err_plain, err_truth = rel(K, Kp, scale), rel(K, Kt, scale)
        err_sum = rel(Ks, Kt.sum(1), scale_sum)
        err_plain_truth = rel(Kp, Kt, scale)
        ok = (bool(torch.isfinite(K).all()) and err_plain <= 1e-6 and err_truth <= 2e-6
              and err_sum <= 2e-6)
        del Kt, Ks
        nout = b * n * m * (1 if sum_sources else s)
        nbytes = 4 * b * (n + m + 4 * s * p) + 4 * nout
        flops = b * s * n * m * (4 * p + 6)
        ref = Kp.sum(1) if sum_sources else Kp
        row = {"case": name, "m32": m32, "sum_sources": sum_sources, "shape": [b, s, n, m, p],
               "max_abs_err": float((K - ref).abs().max()), "max_rel_err_plain": err_plain,
               "max_rel_err_f64": err_truth, "max_rel_err_sum_f64": err_sum,
               "plain_f32_rel_err_f64": err_plain_truth, "ok": ok,
               # device times (CUDA graphs), then the call from Python
               "kernel_ms": graph_ms(lambda: specmix_matrix(
                   *args, m32=m32, sum_sources=sum_sources), reps=5),
               "plain_ms": graph_ms(lambda: specmix_plain(
                   *args, m32=m32, sum_sources=sum_sources), reps=1, replays=3),
               # no torch call computes it; filling the same output with a
               # constant is the practical floor of its writes
               "library_ms": None, "fill_ms": graph_ms(lambda: K.fill_(1.0), reps=5),
               "kernel_call_ms": cuda_ms(lambda: specmix_matrix(
                   *args, m32=m32, sum_sources=sum_sources), 20)}
        del Kp, ref
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops)
        rows.append(row)
        assert ok, f"specmix kernel disagrees: {row}"
    out = {"phase": "specmix", "cases": rows}
    emit(out)
    torch.cuda.empty_cache()    # the f64 references and the graphs' pools take GBs
    return out


def phase_sosp(dev):
    """The main path: SoSp built, trained, predicted and scored on the card.
    Returns (the phase's record, the trained model)."""
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
    return out, model


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


# ------------------------------------------------------ transcription (AMT)
def phase_amt(dev) -> dict:
    """The AMT path: tests_tpu/workloads.make_amt (1 s, 43 windows, 8
    pitches x 10 partials, M 160) for 100 Adam steps in windows of 16,
    held against the CPU-f64 golden trajectory (goldens.npz amt_losses);
    then the MAD pianoroll scored against the piece's notes.  The Cholesky
    kernel's launches are read over this phase only."""
    from gpitch_tpu_torch.audio.pianoroll import Pianoroll
    from gpitch_tpu_torch.linalg.chol import cholesky_batched as chol
    from gpitch_tpu_torch.linalg.specmix import specmix_matrix as spec
    golden = np.load(os.path.join(ROOT, "tests_tpu", "goldens.npz"))["amt_losses"]
    chol.launches = spec.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, events = make_amt(1.0, dev, torch.float32)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    losses, (first_s, run_s) = model.optimize(maxiter=100, learning_rate=0.01,
                                              timed=True, window_chunk=16)
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t0
    launches = {"cholesky_batched": chol.launches, "specmix_matrix": spec.launches}
    model.piano_roll = Pianoroll(fs=20, duration=1.0, notes=events)
    p, r, f = model.evaluate(mode="mad")
    mv = model.matrix_var
    out = {"phase": "amt", "windows": model.nwin, "M": int(model.z.shape[1]),
           "pitches": len(model.pitches), "partials": model.bank.kern.stacked.num_partials,
           "loss0": float(losses[0]), "loss99": float(losses[-1]),
           "golden0": float(golden[0]), "golden99": float(golden[-1]),
           "rel0": float(abs(losses[0] / golden[0] - 1)),
           "rel99": float(abs(losses[-1] / golden[-1] - 1)),
           "build_s": build_s, "optimize_s": opt_s, "timed_first_s": first_s,
           "timed_run_s": run_s, "ms_per_bank_step": opt_s / 100 * 1e3,
           "matrix_var_shape": list(mv.shape), "matrix_var_finite": bool(np.isfinite(mv).all()),
           "launches": launches, "chol_launches_per_step": chol.launches / 100,
           "mad_pianoroll": {"precision": float(p), "recall": float(r), "f": float(f)}}
    emit(out)
    assert np.isfinite(losses).all(), "non-finite losses"
    assert out["rel0"] <= 5e-3, f"loss[0] off the golden: {out['rel0']}"
    assert out["rel99"] <= 0.1, f"loss[99] off the golden: {out['rel99']}"
    assert losses[-1] < losses[0], "loss did not decrease"
    assert out["matrix_var_shape"] == [8, 43] and out["matrix_var_finite"]
    assert launches["cholesky_batched"] > 0, f"the Cholesky kernel never ran: {launches}"
    return out


def _amt_bank_steps(name, model, window_chunk) -> dict:
    """2 warm-up bank steps, then 10 timed ones, with the peak memory of
    the timed run."""
    t0 = time.perf_counter()
    model.optimize(maxiter=2, learning_rate=0.01, window_chunk=window_chunk)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses, (first_s, run_s) = model.optimize(maxiter=10, learning_rate=0.01, timed=True,
                                              window_chunk=window_chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"phase": "amt_full", "case": name, "windows": model.nwin,
           "pitches": len(model.pitches), "stacked": hasattr(model.bank.kern, "stacked"),
           "window_chunk": window_chunk, "warmup_2_steps_s": warmup_s,
           "ms_per_bank_step": wall / 10 * 1e3, "timed_first_s": first_s,
           "timed_run_s": run_s, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
           "losses_finite": bool(np.isfinite(losses).all()),
           "matrix_var_finite": bool(np.isfinite(model.matrix_var).all())}
    emit(out)
    assert out["losses_finite"] and out["matrix_var_finite"], f"{name}: not finite"
    return out


def phase_amt_full(dev):
    """The AMT bank at full width: 10 s (439 windows) with the 8 sounding
    pitches x 10 partials in windows of 64, and the 88-pitch dictionary
    (MIDI 21-108, 8 partials, the L1 penalty on) on 2 s in windows of 16.
    Returns (the records, the 10 s model)."""
    out = {}
    t0 = time.perf_counter()
    model, _ = make_amt(10.0, dev, torch.float32)
    build_s = time.perf_counter() - t0
    out["sounding"] = _amt_bank_steps("sounding_8x10_10s", model, 64)
    out["sounding"]["build_s"] = build_s
    t0 = time.perf_counter()
    piano, _ = make_amt(2.0, dev, torch.float32, pitches=list(range(21, 109)),
                        max_par=8, reg=True)
    build_s = time.perf_counter() - t0
    out["piano88"] = _amt_bank_steps("piano88_2s", piano, 16)
    out["piano88"]["build_s"] = build_s
    del piano
    torch.cuda.empty_cache()
    return out, model


# ------------------------------------------------------------ ModGP (SVGP)
def make_modgp_demo(dev, n=16000, num_inducing=None, noise=1e-6):
    """The workload of demos/demo_modgp.py:37-54 (num_inducing None, noise
    1e-6) and of bench.py:37-66 (num_inducing 128 taken evenly from the
    extrema, noise 1e-6 -> 1e-3 variance): 1 s at 16 kHz of a 3-harmonic
    15 Hz component under a two-bump envelope, inducing points at the
    extrema (dec 1), a Matern32 activation and a 3-partial
    MercerMatern12sm, f32.  Returns (model, x, y, the true source)."""
    from gpitch_tpu_torch.kernels import Matern32, MercerMatern12sm
    from gpitch_tpu_torch.models import ModGP
    from gpitch_tpu_torch.pipelines import init_liv
    fs = 16000
    x = np.linspace(0.0, (n - 1.0) / fs, n).reshape(-1, 1)
    comp = sum(np.sin(2 * np.pi * x * (k + 1) * 15.0) for k in range(3))
    comp /= np.max(np.abs(comp))
    env = np.exp(-25 * (x - 0.33) ** 2) + np.exp(-75 * (x - 0.66) ** 2)
    env /= np.max(np.abs(env))
    y = comp * env + np.sqrt(noise) * np.random.default_rng(0).standard_normal((n, 1))
    z, _ = init_liv(x=x, y=y, win_size=31, thres=0.05, dec=1)
    if num_inducing is not None:
        zi = z[0][0]
        zi = zi[np.linspace(0, zi.shape[0] - 1, num_inducing).astype(int)]
        z = [[zi], [zi]]
    model = ModGP.create(z=z, kern=[[Matern32.create(1.0, 1.0)],
                                    [MercerMatern12sm.create(energy=[1.0, 1.0, 1.0],
                                                             frequency=[15.0, 30.0, 45.0])]],
                         device=dev)
    return model, x, y, comp * env


def phase_modgp(dev) -> tuple[dict, object]:
    """ModGP on the card: (a) the golden fixture in f64 against
    tests/golden_values.json (rtol 1e-9, atol 1e-12) and in f32 (the ELBO
    at rtol 2e-4); (b) the demo: 1000 minibatch-100 Adam steps at lr 0.005
    by fit_adam_timed, the source recovered on x[::4] (RMSE < 0.05);
    (c) the bench workload (M 128, noise variance 1e-3), 2000 steps.  The
    Cholesky kernel's launches are read over (b) and (c).  Returns (the
    record, the trained demo model with its data)."""
    from gpitch_tpu_torch.linalg.chol import cholesky_batched as chol
    from gpitch_tpu_torch.models import fit_adam_timed, minibatch_fn
    with open(os.path.join(ROOT, "tests", "golden_values.json")) as fh:
        golden = json.load(fh)
    model, x, y = golden_modgp(torch.float64, dev)
    got = golden_modgp_values(model, x, y)
    # each key's largest |got - want| / (atol + rtol |want|): <= 1 passes
    ratio = {k: float(np.max(np.abs(np.asarray(v) - np.asarray(golden[k]))
                             / (1e-12 + 1e-9 * np.abs(np.asarray(golden[k])))))
             for k, v in got.items()}
    ok64 = max(ratio.values()) <= 1.0
    model32, x32, y32 = golden_modgp(torch.float32, dev)
    with torch.no_grad():
        elbo32 = float(model32.elbo(x32, y32))
    rel32 = abs(elbo32 / golden["modgp_elbo_whitened"] - 1)
    out = {"phase": "modgp", "golden_f64_err_over_tol": ratio, "golden_f64_ok": ok64,
           "golden_f32_elbo": elbo32, "golden_f32_rel": rel32}

    chol.launches = 0
    runs = {}
    for name, steps, kw in (("demo", 1000, {}), ("bench", 2000, {"num_inducing": 128,
                                                                  "noise": 1e-3})):
        model, x, y, truth = make_modgp_demo(dev, **kw)
        xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
        yt = torch.as_tensor(y, dtype=torch.float32, device=dev)
        n = xt.shape[0]
        model, losses, first_s, run_s = fit_adam_timed(
            model, lambda m, xb, yb: m.loss(xb, yb, num_data=n), steps, 0.005,
            minibatch_fn(xt, yt, 100, torch.Generator(device=dev).manual_seed(0)))
        src = model.predict_source(xt[::4]).cpu().numpy()
        runs[name] = {"steps": steps, "M": int(model.za.raw.shape[1]),
                      "steps_per_s": steps / run_s, "ms_per_step": run_s / steps * 1e3,
                      "first_run_excess_s": first_s, "elbo": -float(losses[-1]),
                      "elbo_first": -float(losses[0]),
                      "rmse_source": float(np.sqrt(np.mean((src[:, :1] - truth[::4]) ** 2))),
                      "losses_finite": bool(np.isfinite(losses).all())}
        if name == "demo":
            demo = (model, xt, yt)
    out.update(runs)
    out["launches"] = {"cholesky_batched": chol.launches}
    emit(out)
    assert ok64, f"ModGP f64 off the goldens: {ratio}"
    assert rel32 <= 2e-4, f"ModGP f32 ELBO off the golden: {rel32}"
    assert all(r["losses_finite"] for r in runs.values())
    assert runs["demo"]["rmse_source"] < 0.05, "source recovery failed"
    return out, demo


# --------------------------------------------- fused whiten (kernels 3-5)
def _whiten_inputs(nw, n, m, freq, fs, seed=0):
    """The prototypes' recipe (scripts/proto_fused_whiten.py:321-342 and
    proto_fused_whiten_bwd.py:242-243), unpadded: f64 numpy arrays.
    ``freq`` is (S, P); energies 1/p, variances 1, lengthscales 0.1 s."""
    rng = np.random.default_rng(seed)
    s, p = freq.shape
    zc = np.stack([np.linspace(0, (n - 1) / fs, m) for _ in range(nw)])
    zc = zc + rng.uniform(0, 1e-4, zc.shape)
    err = rng.standard_normal((nw, n)) * 0.1
    linv = np.tril(rng.standard_normal((nw, m, m)) * 0.05 + np.eye(m)[None])
    du = rng.standard_normal((nw, m, m)) * 0.01
    dv = rng.standard_normal((nw, m, 1)) * 0.01
    return {"zc": zc[..., None], "xc": np.broadcast_to(np.arange(n) / fs, (nw, 1, n)),
            "err": err[:, None], "linv": linv, "du": du, "dv": dv,
            "energy": np.broadcast_to(1.0 / np.arange(1, p + 1), (s, p)), "freq": freq,
            "var": np.ones(s), "inv_l": np.full(s, 10.0)}


def _harmonics(f0, partials, fs):
    return np.minimum(np.asarray(f0)[:, None] * np.arange(1, partials + 1), 0.45 * fs)


def _whiten_bound(nw, m, n, s, p, backward):
    """bound_ms of kernel A or B, counting what the function needs: Linv is
    lower triangular in every input here (np.tril, chol_inv), so A = Linv
    Kuf is M (M + 1) N flops, and U = A A^T, symmetric, M (M + 1) N; v is
    2 M N and the build (4P + 4) S M N (a multiply-add pair per partial,
    the envelope, the variance and the sum).  Kernel B: A and the build
    again, dA = (dU + dU^T) A and the dense dLinv (every entry is an output)
    2 M^2 N each, dv err^T 2 M N, dK = Linv^T dA M (M + 1) N, and the
    per-source sums 8 P S M N.  Bytes: each input read once (Linv's lower
    triangle), each output written once."""
    build = (4 * p + 4) * s * m * n
    tri = m * (m + 1) * n
    params = 2 * s * p + 2 * s
    linv = m * (m + 1) // 2
    if backward:
        flops = nw * (2 * tri + 4 * m * m * n + 2 * m * n + build + 8 * p * s * m * n)
        floats = nw * (linv + 2 * m * m + 2 * m + 2 * n + params) + params
    else:
        flops = nw * (2 * tri + 2 * m * n + build)
        floats = nw * (linv + m * m + 2 * m + 2 * n) + params
    return bound_ms(4 * floats, flops)


def _no_grad(fn):
    def run():
        with torch.no_grad():
            return fn()
    return run


def _whiten_case(name, d, dev, arbiter=True, timing=False) -> dict:
    """Kernel A through both entry points and kernel B against the plain
    version: the f64 plain forward and autograd through it (``arbiter``),
    else the f32 ones.  Forward limit 1e-4 of max|ref| (the prototype's own,
    proto_fused_whiten.py:364); backward, per output, the larger of 1e-3 of
    max|ref| and 4x the error of autograd through the f32 plain version."""
    from gpitch_tpu_torch.linalg.fused_whiten import (
        fused_whiten, fused_whiten_bwd, fused_whiten_bwd_plain, fused_whiten_flat,
        fused_whiten_plain)

    def tensors(dtype):
        return {k: torch.as_tensor(np.array(v), dtype=dtype, device=dev) for k, v in d.items()}

    def plain_autograd(t):
        """(U, v) and kernel B's five outputs by autograd, per window."""
        nw = t["zc"].shape[0]
        leaves = [t["linv"].clone().requires_grad_(True)] + [
            t[k].expand((nw,) + t[k].shape).clone().requires_grad_(True)
            for k in ("energy", "freq", "var", "inv_l")]
        u, v = fused_whiten_plain(t["zc"], t["xc"], t["err"], *leaves)
        g = torch.autograd.grad((u * t["du"]).sum() + (v * t["dv"]).sum(), leaves)
        return (u.detach(), v.detach()), (g[0], g[3][:, None], g[4][:, None], g[1], g[2])

    t32 = tensors(torch.float32)
    ins = [t32[k] for k in ("zc", "xc", "err", "linv")]
    par = [t32[k] for k in ("energy", "freq", "var", "inv_l")]
    nw, m, _ = ins[0].shape
    n = ins[1].shape[-1]
    s, p = par[0].shape
    flat = torch.cat([par[0], par[1], par[2][:, None], par[3][:, None]], 1).reshape(1, -1)
    with torch.no_grad():
        fwd = {"fused_whiten": fused_whiten(*ins, *par),
               "fused_whiten_flat": fused_whiten_flat(*ins, flat, num_sources=s)}
    bwd = fused_whiten_bwd(*ins, t32["du"], t32["dv"], *par)
    torch.cuda.synchronize()
    fwd32, bwd32 = plain_autograd(t32)
    (fwd_ref, bwd_ref) = plain_autograd(tensors(torch.float64)) if arbiter else (fwd32, bwd32)
    out = {"phase": "fused_whiten", "case": name, "shape": [nw, m, n, s, p],
           "reference": "f64 plain" if arbiter else "f32 plain", "forward": {}, "backward": {}}
    ok = True
    for entry, got in fwd.items():
        for what, g, g32, ref in zip(("U", "v"), got, fwd32, fwd_ref):
            scale = float(ref.abs().max())
            err = float((g.double() - ref).abs().max())
            row = {"max_abs_err": err, "max_rel_err": err / scale,
                   "plain_f32_rel_err": float((g32.double() - ref).abs().max()) / scale,
                   "finite": bool(torch.isfinite(g).all())}
            row["ok"] = row["finite"] and err <= 1e-4 * scale
            out["forward"][f"{entry}.{what}"] = row
            ok &= row["ok"]
    for what, g, g32, ref in zip(("dlinv", "dvar", "dinvl", "de", "df"), bwd, bwd32, bwd_ref):
        scale = float(ref.abs().max())
        err = float((g.double() - ref).abs().max())
        err32 = float((g32.double() - ref).abs().max())
        tol = max(1e-3 * scale, 4 * err32)
        row = {"max_abs_err": err, "max_rel_err": err / scale, "plain_f32_abs_err": err32,
               "tol": tol, "finite": bool(torch.isfinite(g).all())}
        row["ok"] = row["finite"] and tuple(g.shape) == tuple(ref.shape) and err <= tol
        out["backward"][what] = row
        ok &= row["ok"]
    if timing:
        fw_leaves = [t.clone().requires_grad_(True) for t in [ins[3]] + par]

        def scalar(fn):
            u, v = fn(*ins[:3], *fw_leaves)
            return (u * t32["du"]).sum() + (v * t32["dv"]).sum()

        def fwd_bwd(fn):
            return lambda: torch.autograd.grad(scalar(fn), fw_leaves)

        graph = scalar(fused_whiten_plain)     # the unfused backward alone, on one graph

        tm = {"kernel_A_ms": cuda_ms(_no_grad(lambda: fused_whiten(*ins, *par)), 20),
              "kernel_A_flat_ms": cuda_ms(_no_grad(
                  lambda: fused_whiten_flat(*ins, flat, num_sources=s)), 20),
              "kernel_B_ms": cuda_ms(lambda: fused_whiten_bwd(
                  *ins, t32["du"], t32["dv"], *par), 10),
              "plain_fwd_ms": cuda_ms(_no_grad(lambda: fused_whiten_plain(*ins, *par)), 5),
              "plain_bwd_ms": cuda_ms(lambda: fused_whiten_bwd_plain(
                  *ins, t32["du"], t32["dv"], *par), 3, warmup=1),
              "unfused_bwd_ms": cuda_ms(lambda: torch.autograd.grad(
                  graph, fw_leaves, retain_graph=True), 3, warmup=1),
              "unfused_fwd_bwd_ms": cuda_ms(fwd_bwd(fused_whiten_plain), 3, warmup=1),
              "fused_fwd_bwd_ms": cuda_ms(fwd_bwd(fused_whiten), 10)}
        del graph
        tm["bound_A_ms"], tm["bound_A_by"] = _whiten_bound(nw, m, n, s, p, False)
        tm["bound_B_ms"], tm["bound_B_by"] = _whiten_bound(nw, m, n, s, p, True)
        out["times"] = tm
    out["ok"] = ok
    emit(out)
    assert ok, f"fused-whiten kernels disagree in case {name}"
    return out


_SPLITS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 11, 13, 16, 21, 32, 63)


def _whiten_splits(name, d, dev) -> dict:
    """Kernels A and B with a window's tiles split over each count of blocks
    in _SPLITS that leaves no block without a tile, and at the count that
    csrc/fused_whiten.cu's ``plan`` picks; U and dLinv at every split within
    1e-5 of max|ref| of splits=1's (the partial sums only change order)."""
    import importlib
    fw = importlib.import_module("gpitch_tpu_torch.linalg.fused_whiten")
    t = {k: torch.as_tensor(np.array(v), dtype=torch.float32, device=dev) for k, v in d.items()}
    ins = [t[k] for k in ("zc", "xc", "err", "linv")]
    par = [t[k] for k in ("energy", "freq", "var", "inv_l")]
    nw, m, _ = ins[0].shape
    n = ins[1].shape[-1]
    sizes = (nw, m, n) + tuple(par[0].shape)
    tiles = -(-n // fw.TILE_T)
    plan = {"A": fw._splits(False, sizes, dev.index), "B": fw._splits(True, sizes, dev.index)}

    def kernels(k):
        with torch.no_grad():
            return (fw._forward_kernel(*ins, *par, splits=k)[0],
                    fw._backward_kernel(*ins[:4], t["du"], t["dv"], *par, splits=k)[0])

    refs = kernels(1)
    out = {"phase": "fused_whiten", "case": f"splits_{name}", "shape": list(sizes),
           "tiles": tiles, "plan": plan, "A_ms": {}, "B_ms": {}, "max_rel_diff": 0.0}
    for k in sorted(set(_SPLITS) | set(plan.values())):
        if k > tiles or -(-tiles // -(-tiles // k)) != k:
            continue
        for got, ref in zip(kernels(k), refs):
            out["max_rel_diff"] = max(out["max_rel_diff"], float(
                (got - ref).abs().max() / ref.abs().max()))
        out["A_ms"][k] = cuda_ms(_no_grad(lambda: fw._forward_kernel(*ins, *par, splits=k)),
                                 5, warmup=1)
        out["B_ms"][k] = cuda_ms(lambda: fw._backward_kernel(
            *ins[:4], t["du"], t["dv"], *par, splits=k), 5, warmup=1)
    out["ok"] = out["max_rel_diff"] <= 1e-5
    emit(out)
    assert out["ok"], f"the split changes the kernels' result ({name})"
    return out


def _whiten_bank(name, model, dev) -> dict:
    """The pair on a trained bank's own bound: U / sigma^2 against _common's
    AAT and v against its Aerr (1e-4 of max|ref|); fused_whiten_flat with
    the per-window flat parameters gives the same; then, for a seeded
    (dU, dv), the gradient of <U, dU> + <v, dv> in every trainable raw leaf
    through fused_whiten (Linv from chol_inv under grad) and through
    _common's A (1e-3 of max|ref|)."""
    from gpitch_tpu_torch.core.params import named_params
    from gpitch_tpu_torch.linalg.fused_whiten import fused_whiten, fused_whiten_flat
    bank = model.bank
    assert bank.mask is None
    with torch.no_grad():
        err, _, _, A, AAT, _, _, sigma2 = bank._common()
        aerr = A @ err
        chain = bank.fused_whiten_args()
        u, v = fused_whiten(*chain)
        e, f, var, il = chain[4:]
        nw, s = var.shape
        flat = torch.cat([e, f, var[..., None], il[..., None]], -1).reshape(nw, -1)
        uf, vf = fused_whiten_flat(*chain[:4], flat, num_sources=s)
    torch.cuda.synchronize()
    out = {"phase": "fused_whiten", "case": name, "windows": nw, "M": int(u.shape[-1]),
           "N": int(err.shape[-2]), "S": s, "P": int(e.shape[-1]),
           "AAT_rel_err": float((u / sigma2 - AAT).abs().max() / AAT.abs().max()),
           "Aerr_rel_err": float((v - aerr).abs().max() / aerr.abs().max()),
           "flat_equal": bool(torch.equal(uf, u) and torch.equal(vf, v))}
    gen = torch.Generator().manual_seed(0)
    du = torch.randn(tuple(u.shape), generator=gen).to(dev)
    dv = torch.randn(tuple(v.shape), generator=gen).to(dev)
    grads = {}
    for route in ("fused", "common"):
        for _, prm in named_params(bank):
            prm.raw.grad = None
        if route == "fused":
            u, v = fused_whiten(*bank.fused_whiten_args())
        else:
            err, _, _, A, *_ = bank._common()
            u, v = A @ A.mT, A @ err
        ((u * du).sum() + (v * dv).sum()).backward()
        grads[route] = {k: prm.raw.grad.clone() for k, prm in named_params(bank)
                        if prm.raw.grad is not None}
    for _, prm in named_params(bank):
        prm.raw.grad = None
    out["grad_rel_err"] = {k: float((grads["fused"][k] - g).abs().max() / g.abs().max())
                           for k, g in grads["common"].items()}
    out["ok"] = (out["AAT_rel_err"] <= 1e-4 and out["Aerr_rel_err"] <= 1e-4
                 and out["flat_equal"] and sorted(grads["fused"]) == sorted(grads["common"])
                 and len(grads["common"]) > 0
                 and all(r <= 1e-3 for r in out["grad_rel_err"].values()))
    emit(out)
    assert out["ok"], f"the fused pair disagrees with the bank's bound ({name})"
    return out


def phase_fused_whiten(dev, sosp_model, full_model) -> dict:
    """Kernels A and B: (a) the prototypes' inputs at the SoSp width (222
    windows, N 2001, M 112, S 3, P 5, 16 kHz); (b) the AMT width (43
    windows, 44.1 kHz, M 160, 8 pitches from C4 x 10 harmonics); (c) an
    88-pitch dictionary (8 windows, M 160, S 88, P 20) against the f32
    plain version; (d) the trained 62- and 222-window SoSp banks' own bound,
    the launches counted over (d) alone; (e) times at (a) and (b), and both
    kernels at each split of a window's tiles over blocks at (a), at 62
    windows of (a)'s width, and at (b)."""
    from gpitch_tpu_torch.linalg.fused_whiten import (fused_whiten, fused_whiten_bwd,
                                                      fused_whiten_flat)
    sosp_f0 = 261.6 * 2 ** (np.array([0, 4, 7]) / 12)
    amt_f0 = 261.6 * 2 ** (np.arange(8) / 12)
    piano_f0 = 27.5 * 2 ** (np.arange(88) / 12)
    sosp = _harmonics(sosp_f0, 5, 16000.0)
    a = _whiten_inputs(222, 2001, 112, sosp, 16000.0)
    b = _whiten_inputs(43, 2001, 160, _harmonics(amt_f0, 10, 44100.0), 44100.0)
    cases = {
        "a_sosp": _whiten_case("a_sosp", a, dev, timing=True),
        "b_amt": _whiten_case("b_amt", b, dev, timing=True),
        "c_piano88": _whiten_case("c_piano88", _whiten_inputs(
            8, 2001, 160, _harmonics(piano_f0, 20, 44100.0), 44100.0), dev, arbiter=False),
    }
    for name, d in (("a", a), ("62", _whiten_inputs(62, 2001, 112, sosp, 16000.0)),
                    ("b", b)):
        cases[f"splits_{name}"] = _whiten_splits(name, d, dev)
    fused_whiten.launches = fused_whiten_flat.launches = fused_whiten_bwd.launches = 0
    for name, model in (("d_bank_62", sosp_model), ("d_bank_222", full_model)):
        cases[name] = _whiten_bank(name, model, dev)
    launches = {"fused_whiten": fused_whiten.launches,
                "fused_whiten_flat": fused_whiten_flat.launches,
                "fused_whiten_bwd": fused_whiten_bwd.launches}
    emit({"phase": "fused_whiten", "case": "launches_in_d", "launches": launches})
    assert all(n > 0 for n in launches.values()), f"a kernel never ran: {launches}"
    return {"cases": cases, "launches": launches}


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def phase_profile(windows) -> None:
    """Where each (label, run) of ``windows`` spends device time:
    torch.profiler over the run; top ops by self device time and the
    device's busy share of the host wall time."""
    from torch.profiler import ProfilerActivity, profile
    for what, run in windows:
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

        # the port's own kernels: device ms and launches by kernel name
        port = {}
        for e in kernels:
            for name in ("chol_kernel", "features_kernel", "specmix_kernel", "fused_whiten"):
                if name in e.key:
                    ms, n = port.get(name, (0.0, 0))
                    port[name] = (ms + _device_us(e) / 1e3, n + e.count)
        emit({"phase": "profile", "window": what, "wall_ms": wall_us / 1e3,
              "device_ms": device_us / 1e3, "device_busy_share": device_us / wall_us,
              "top_ops": top(ops, 10), "top_kernels": top(kernels, 10),
              "port_kernels": {k: {"device_ms": ms, "launches": n}
                               for k, (ms, n) in port.items()}})


def _new_path_windows(dev, amt_model, svgp, x, y):
    """The profile's windows on the AMT and ModGP paths: 5 bank steps of
    the 439-window 8 x 10 bank (windows of 64) and 50 minibatch Adam steps
    of the ModGP demo."""
    from gpitch_tpu_torch.models import fit_adam, minibatch_fn
    n = x.shape[0]
    batch = minibatch_fn(x, y, 100, torch.Generator(device=dev).manual_seed(1))
    return [("5 amt_full bank steps (8 x 10, 439 windows)",
             lambda: amt_model.optimize(maxiter=5, window_chunk=64)),
            ("50 ModGP steps (demo)",
             lambda: fit_adam(svgp, lambda m, xb, yb: m.loss(xb, yb, num_data=n), 50,
                              0.005, batch))]


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
    sosp, sosp_model = phase_sosp(dev)
    phase_small(dev)
    phase_first_use()
    full_model = phase_full(dev)
    whiten = phase_fused_whiten(dev, sosp_model, full_model)
    del sosp_model
    torch.cuda.empty_cache()
    amt = phase_amt(dev)
    _, amt_model = phase_amt_full(dev)
    _, (svgp, x, y) = phase_modgp(dev)
    # last: the profiler's tracing may stay attached to the process
    phase_profile([("5 bank steps", lambda: full_model.optimize(maxiter=5)),
                   ("predict_s", lambda: full_model.predict_s())]
                  + _new_path_windows(dev, amt_model, svgp, x, y))

    main_chol = next(r for r in chol["cases"] if r["kind"] == "spd"
                     and r["shape"] == [sosp["windows"], 112, 112]
                     and r["dtype"] == "float32")
    main_spec = spec["cases"][0]
    # rows 1-2: ms, plain_ms and library_ms are device times (graph_ms);
    # rows 3-5: all three from calls from Python (cuda_ms)
    kernels = [
        {"name": "cholesky_batched", "route": "cuda",
         "source": "gpitch_tpu_torch/csrc/chol.cu",
         "replaces": "gpitch_tpu/linalg/pallas/chol.py:131",
         "launches": sosp["launches"]["cholesky_batched"],
         "launches_amt": amt["launches"]["cholesky_batched"],
         "shape": main_chol["shape"],
         "max_abs_err": main_chol["max_abs_err_plain"], "ms": main_chol["kernel_ms"],
         "plain_ms": main_chol["plain_ms"], "bound_ms": main_chol["bound_ms"],
         "bound_by": main_chol["bound_by"], "library_ms": main_chol["library_ms"],
         "timed_by": "cuda_graph"},
        {"name": "specmix_matrix", "route": "cuda",
         "source": "gpitch_tpu_torch/csrc/specmix.cu",
         "replaces": "gpitch_tpu/linalg/pallas/specmix.py:49",
         "launches": sosp["launches"]["specmix_matrix"],
         "shape": main_spec["shape"],
         "max_abs_err": main_spec["max_abs_err"], "ms": main_spec["kernel_ms"],
         "plain_ms": main_spec["plain_ms"], "bound_ms": main_spec["bound_ms"],
         "bound_by": main_spec["bound_by"], "library_ms": None, "timed_by": "cuda_graph"},
    ]
    # kernels 3 and 4 are one CUDA kernel (A) behind two entry points; 5 is
    # kernel B.  Times at the prototypes' SoSp-width inputs (case a); the
    # library time is the unfused torch composition (cuBLAS SGEMM and
    # elementwise ops): its forward for A, its backward alone (autograd on a
    # built graph) for B.
    case_a = whiten["cases"]["a_sosp"]
    tm = case_a["times"]
    for name, replaces, ms, err, plain, lib, bound, by in (
            ("fused_whiten", "scripts/proto_fused_whiten.py:151", tm["kernel_A_ms"],
             case_a["forward"]["fused_whiten.U"]["max_abs_err"], tm["plain_fwd_ms"],
             tm["plain_fwd_ms"], tm["bound_A_ms"], tm["bound_A_by"]),
            ("fused_whiten_flat", "scripts/proto_fused_whiten.py:208", tm["kernel_A_flat_ms"],
             case_a["forward"]["fused_whiten_flat.U"]["max_abs_err"], tm["plain_fwd_ms"],
             tm["plain_fwd_ms"], tm["bound_A_ms"], tm["bound_A_by"]),
            ("fused_whiten_bwd", "scripts/proto_fused_whiten_bwd.py:157", tm["kernel_B_ms"],
             max(r["max_abs_err"] for r in case_a["backward"].values()), tm["plain_bwd_ms"],
             tm["unfused_bwd_ms"], tm["bound_B_ms"], tm["bound_B_by"])):
        kernels.append({"name": name, "route": "cuda",
                        "source": "gpitch_tpu_torch/csrc/fused_whiten.cu",
                        "replaces": replaces, "launches": whiten["launches"][name],
                        "shape": case_a["shape"], "max_abs_err": err, "ms": ms,
                        "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                        "library_ms": lib, "timed_by": "python_calls"})
    emit({"kernels": kernels})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(device["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
