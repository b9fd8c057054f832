#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gpitch_tpu_torch) on one CUDA card.

Run from the repository root:   python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:
  1. device   the card, its power limit, and the f32 matmul mode (full f32);
  2. build    the four CUDA sources (the three kernels' and graphs.cu, the
              conditional chains of the captured L-BFGS), one nvcc each,
              started together;
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
              3 pitches x 5 partials): 100 Adam steps in f32 (every Adam
              fit of the port replays one captured CUDA graph of a step,
              models.fit.AdamSteps; launches count each replay) held against
              the CPU-f64 golden trajectory (tests_tpu/goldens.npz), then
              predict_f, predict_s, the overlap-add merge and the RMSE;
              the kernels' launch counts (Cholesky, specmix and the fused
              pair, which the bound of a stacked bank goes through) are
              read over this phase only;
  6. small    a 0.5 s separation in f64 on the card and on the CPU, which
              must agree;
  7. first_use  a fresh process through the main path: import, build, each
              of three steps' parts, a captured Adam segment and 3 captured
              L-BFGS iterations (each with its capture's cost), the first
              predictions, and what torch.optim.Adam would add;
  8. full     the 14 s mix (222 windows): 20 Adam steps (the fused pair's
              launches counted: one each a step) and predict_s;
  9. fused_whiten  the fused build -> whiten -> accumulate pair (kernel A
              through fused_whiten and fused_whiten_flat, kernel B) against
              its plain version: (a) the prototypes' inputs at the SoSp width,
              (b) the AMT width, (c) an 88-pitch dictionary, (d) the trained
              62- and 222-window banks' own bound (AAT, Aerr and every raw
              leaf's gradient; the pair's launch counts are read over (d)),
              (e) 16 sosp-4s windows at an f64 L-BFGS state
              (tests/torch_fused_whiten_trained_state.npz): the f32
              gradient through the pair within 2e-4 of f64; times at (a)
              and (b) with each kernel's share of both bounds, and at each
              split of a window's tiles over blocks;
 10. amt      transcription end to end (tests_tpu/workloads.make_amt: 1 s
              at 44.1 kHz, 43 windows, M 160, 8 pitches x 10 partials,
              y x 20): 100 Adam steps in windows of 16 held against the
              CPU-f64 golden trajectory, matrix_var, the MAD pianoroll's
              F-measure; the Cholesky kernel's and the fused pair's
              launches over this phase;
 11. amt_full the AMT bank at full width: 10 s (439 windows, 8 x 10,
              windows of 64) and the 88-pitch dictionary on 2 s (windows
              of 16): ms per bank step, peak memory and the fused pair's
              launches (none for the 88-pitch Sum of kernels);
 12. modgp    the ModGP SVGP model: the golden fixture in f64 and f32, the
              demo (N 16000, 1000 minibatch Adam steps, source RMSE) and
              the bench workload (M 128, 1000 steps, steps/s);
 13. lbfgs    one L-BFGS solver per window (the reference's optimizer), an
              iteration replayed from captured CUDA graphs whose conditions
              (a trial's, an evaluation's) the device decides
              (models._lbfgs.LbfgsSteps):
              (a) the first 16 windows of sosp-4s, 30 iterations in f32,
              against the JAX package's f64 trajectories
              (tests/torch_lbfgs_goldens.npz); (b) sosp-14s at full width
              (222 windows), SoSp.optimize(method="lbfgs", maxiter=20),
              predict_s and the RMSE, with the kernels' launches,
              evaluations and host reads per iteration; (c) amt-1s,
              AMT.optimize(method="lbfgs", maxiter=20) and its F-measure;
              (d) (a) again with one window made NaN on purpose; after (a),
              (b), (c) and on amt-10s (439 windows in chunks of 64, 5
              iterations) captured against eager iterations in turns and
              the one-chain design: ms an iteration, evaluations and host
              reads an iteration (none inside a segment), capture s, node
              counts, peak memory, the trajectories' difference;
 14. natgrad  natural gradients with Adam and L-BFGS on the ModGP golden
              fixture in f32 against the goldens, the demo trained by 500
              minibatch natgrad_adam steps (source RMSE), and the demo's
              steps captured against eager in turns (steps/s);
 15. lag_table  (after 11) the lag-table route (one stationary table per
              window, Kuf and Kuu gathered from it): amt-10s and amt88-2s
              with lag_table=True, f64 bound against the direct route
              (1e-9), the f32 difference, 2 + 10 Adam steps (ms, peak
              memory, launches: the Cholesky kernel only); and a masked
              sosp-4s bank (the last window's trailing half) against that
              window cut to its valid samples (f64 1e-9), 5 Adam steps;
 15b. captured_step  (after 15) captured against eager Adam steps in
              turns, from the same state, on sosp-4s (100 steps: the
              trajectory within what two eager runs differ by and 1e-5),
              sosp-14s, amt-10s (chunks of 64), amt88-2s (the Sum route),
              the two lag-table banks and ModGP's bench (300 minibatch
              steps, every replay a new batch, equal to the eager draws):
              ms a step of each, the capture's cost, the kernels' calls
              held by one captured step;
 16. kernel_train  (after 14) learn_pitch_params(mode="train") on the notes
              of sosp-4s at full width (10000 windows of 441, 5 partials)
              against the JAX package's f64 parameters
              (tests/torch_kernel_learning_goldens.npz); sosp-14s from the
              learned kernels ('load'), 20 Adam steps and predict_s, RMSE
              and launches, beside the same run from the FFT kernels;
 17. hmc      (after 13) HMC: (a) the JAX package's two Gaussian targets
              in f32 at its thresholds; (b) run_hmc's 12 component-kernel
              raws of the Adam-fitted ModGP on the synthetic C4 note, 4
              chains, 8 leapfrog steps, 100 + 100 iterations (finite, rates
              > 0.2, split R-hat of the identified quantities); (c) the 16
              trained windows of 13(a), every window's kernel leaves, 4
              chains folded into the window axis (the Cholesky kernel, A
              and B launched): the value against one chain at a time
              (1e-5), the gradient against f64 as one chain's is and
              within 2e-4 both ways (each f32 part's share of that error:
              ``--check-hmc-state``); (b) and (c) run the sampler
              (models.hmc.HmcSteps) captured, each phase one graph
              replayed, against its eager plain version in turns: ms a
              leapfrog step, capture s, nodes, memory held against eager's
              peak, samples and rates equal (0.0), no host read inside a
              phase (torch's sync debug mode over the eager runs);
 18. distributed  (a) a one-rank NCCL group in a fresh process: the
              shard-map bank loss and optimize_bank(mesh=) on sosp-4s; (b)
              two processes on the one card (gloo): sosp-14s
              SoSp.optimize(2, then 20, mesh=) against 8's single-process
              steps (1e-5), ms a step and launches per rank; (c) per-window
              L-BFGS on 16 sosp-4s windows, two ranks against one process;
              (d) fit_modgp on a two-source bench ModGP whose sources are
              split over the ranks (one NCCL rank: adam, natgrad_adam,
              lbfgs, the all-reduces inside the graphs; two gloo ranks:
              adam and natgrad_adam, each step's graphs split at its host
              all-reduces, and lbfgs raising ValueError) against one
              process: losses within 1e-5, leaves, ms a step, host points;
 19. resume   optimize_bank_resumable on sosp-4s: 30 steps in one call
              against 20 and a resume to 30 in a fresh process, bit for bit;
              the same on 64 windows of 15's amt-10s table bank (reported);
              the checkpoint's size and write/read ms;
 20. demos    the four ``python -m gpitch_tpu_torch.demos.<name>``, each in
              its own process, all at once, each meeting its threshold;
 21. profile  torch.profiler over 15b's captured steps on each path
              (and eager ones on sosp-14s, amt-10s and ModGP: the device's
              busy share of each; the lag table's gather and its
              scatter-add backward by op), one predict_s of 8's 222-window
              bank, 3 captured and 3 eager L-BFGS iterations of 13(b)'s
              bank, 50 captured and 20 eager natgrad_adam steps of 14's
              demo (the profiler's own cost grows with the ops it records)
              and 10 captured and 10 eager HMC iterations of 17(b) and of
              17(c), last because its tracing may stay attached;
then the kernels line, the nvidia-smi line and the result line.
``python3 chip_smoke.py --worker <kind> <rank> <world> <store> ...`` runs
one rank of 18 or the fresh process of 19 (the phases start them).
``python3 chip_smoke.py --write-hmc-state [PATH]`` writes 17(c)'s state
(13(a)'s trained windows and the chains' start) for the CPU tests
(tests/torch_hmc_bank_state.npz); ``--check-hmc-state`` prints the check
and the f32 parts' shares at that saved state on the card.
Exits non-zero without printing a result when there is no CUDA device.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import time
from typing import Callable

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
TF32X3_FLOP_PER_S = 495e12 / 3   # dense TF32 tensor cores, 3 products per 3xTF32 product

FS = 16000.0
PITCHES = [60, 64, 67]
ONSETS = [(60, 0.1), (64, 0.8), (67, 1.6), (60, 2.4), (64, 3.1)]


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the seconds since the
    script started (``at_s``)."""
    if "phase" in obj:
        obj = {**obj, "at_s": round(time.perf_counter() - _T0, 1)}
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


def sosp_notes(note_seconds=2.0) -> dict:
    """The isolated notes of the separation workload: C4, E4 and G4 as
    ``synth_piano_note`` seeded by MIDI number, at 16 kHz."""
    from gpitch_tpu_torch.audio.io import synth_piano_note
    return {p: synth_piano_note(fs=FS, seconds=note_seconds, f0=_f0(p), seed=p)[1][:, 0]
            for p in PITCHES}


def make_sosp(seconds: float, device, dtype, onsets=ONSETS, max_par=5,
              num_inducing=112, note_seconds=2.0, kernel_mode="fft", saved_params=None):
    """The separation workload of tests_tpu/workloads.make_sosp: piano-like
    notes (seeded by pitch) at the given onsets; the pitch kernels from the
    notes' FFT, or with ``kernel_mode="load"`` from ``saved_params``.
    Returns (model, sources)."""
    from gpitch_tpu_torch.pipelines import SoSp
    n = int(FS * seconds)
    notes = sosp_notes(note_seconds)
    sources = {p: np.zeros(n) for p in PITCHES}
    for p, on in onsets:
        i0 = int(on * FS)
        seg = notes[p][: n - i0]
        sources[p][i0: i0 + len(seg)] += seg
    mix = sum(sources.values())
    x = (np.arange(n) / FS).reshape(-1, 1)
    model = SoSp(train_signals=[notes[p] for p in PITCHES],
                 train_names=[f"piano_M{p}_train.wav" for p in PITCHES],
                 fs=FS, mixture=(x, mix), window_size=2001, kernel_mode=kernel_mode,
                 max_par=max_par, num_inducing=num_inducing, dec=2,
                 saved_params=saved_params, device=device, dtype=dtype)
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
    golden = np.load(os.path.join(ROOT, "tests_tpu", "goldens.npz"))["sosp_losses"]
    _zero_all()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, sources = make_sosp(4.0, dev, torch.float32)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    losses = model.optimize(maxiter=100, learning_rate=0.01)
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t0
    chol_opt = _all_launches()["cholesky_batched"]
    t0 = time.perf_counter()
    mean, var = model.predict_f()
    torch.cuda.synchronize()
    predict_f_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    est = model.predict_s()
    predict_s_s = time.perf_counter() - t0
    rmse = model.compute_rmse(sources)
    launches = _all_launches()
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


def _zero_all() -> None:
    """Every kernel wrapper's launch count, and the record of the captured
    steps' graphs and replays, set to 0."""
    from gpitch_tpu_torch.linalg import _cuda
    _cuda.reset_launches()


def _launches(*names) -> dict:
    """The named kernels' launches on the card since ``_zero_all``
    (``linalg._cuda.device_launches``): a kernel that a captured Adam step
    holds counts once per replay of the step, and its call during the
    capture, which launched nothing, not at all."""
    from gpitch_tpu_torch.linalg import _cuda
    got = _cuda.device_launches()
    return {n: got[n] for n in names}


def _fused_launches() -> dict:
    """The fused pair's launches since ``_zero_all``: the bound of a
    StackedSum bank without a mask at M <= 160 goes through it."""
    return _launches("fused_whiten", "fused_whiten_bwd")


def _path_launches() -> dict:
    """The Cholesky kernel's and the fused pair's launches since
    ``_zero_all``."""
    return _launches(*_PATH)


def _all_launches() -> dict:
    """The Cholesky and specmix kernels' and the fused pair's launches since
    ``_zero_all``."""
    return _launches(*_PATH, "specmix_matrix")


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
# and Adam update, then the first capture of a step (AdamSteps: its eager
# warm-up steps, the capture, 10 replays), the first predict_f and
# predict_s; then whether a heavy module was imported on the way, and last
# the construction of a torch.optim.Adam over the same leaves, the one-time
# cost that the port's own Adam avoids.  argv: repository root, device.
_FIRST_STEPS = r"""
import json, sys, time
t0 = time.perf_counter()
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
from gpitch_tpu_torch.core.params import copy_params, trainable_tensors
from gpitch_tpu_torch.models.fit import Adam, AdamSteps
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
run = AdamSteps(copy_params(model.bank), bank_loss, AdamSteps.WARMUP + 10, 0.01)
t0 = time.perf_counter()
run.run(AdamSteps.WARMUP + 10)
sync()
out["warmup_capture_10_replays_s"] = time.perf_counter() - t0
out["capture_s"] = run.capture_s
from gpitch_tpu_torch.pipelines.windowed_sgpr import optimize_bank
t0 = time.perf_counter()
_, _, info = optimize_bank(model.bank, 3, method="lbfgs", return_info=True)
sync()
out["lbfgs_3_iterations_s"] = time.perf_counter() - t0
out["lbfgs_capture_s"] = info["capture_s"]
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


def _leaf_rows(bank) -> dict:
    """Every trainable raw leaf of a bank on the host, by path."""
    from gpitch_tpu_torch.core.params import named_params
    return {k: p.raw.detach().cpu().numpy() for k, p in named_params(bank) if p.trainable}


def phase_full(dev):
    """14 s of the mix, the onset pattern repeated every 4 s (222 windows):
    2 warm-up steps, then 20 Adam steps as a user's ``optimize`` takes them
    (3 eager steps, the capture, 17 replays; the fused pair's launches on
    the card counted: one each a step) and predict_s.  Returns (the model,
    the 20 steps' losses, their trained leaves)."""
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
    _zero_all()
    t0 = time.perf_counter()
    losses = model.optimize(maxiter=20, learning_rate=0.01)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 20 * 1e3
    launches = _fused_launches()
    roles = _launches("fused_whiten_bwd_roles")["fused_whiten_bwd_roles"]
    trained = _leaf_rows(model.bank)          # the distributed phase's reference
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
           "rmse_after_22_steps": rmse, "launches_in_20_steps": launches,
           "role_split_launches_in_20_steps": roles}
    emit(out)
    assert np.isfinite(losses).all() and np.isfinite(rmse)
    # one launch of each a step: 3 eager steps, 17 replays of the captured one;
    # at M 112 kernel B takes its role-split body
    assert launches == {"fused_whiten": 20, "fused_whiten_bwd": 20}, \
        f"the fused pair did not run once a step: {launches}"
    assert roles == 20, f"kernel B's role-split body did not run once a step: {roles}"
    return model, losses, trained


# ------------------------------------------------------ transcription (AMT)
def phase_amt(dev) -> dict:
    """The AMT path: tests_tpu/workloads.make_amt (1 s, 43 windows, 8
    pitches x 10 partials, M 160) for 100 Adam steps in windows of 16,
    held against the CPU-f64 golden trajectory (goldens.npz amt_losses);
    then the MAD pianoroll scored against the piece's notes.  The Cholesky
    kernel's launches are read over this phase only."""
    from gpitch_tpu_torch.audio.pianoroll import Pianoroll
    golden = np.load(os.path.join(ROOT, "tests_tpu", "goldens.npz"))["amt_losses"]
    _zero_all()
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
    launches = _all_launches()
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
           "launches": launches, "chol_launches_per_step": launches["cholesky_batched"] / 100,
           "mad_pianoroll": {"precision": float(p), "recall": float(r), "f": float(f)}}
    emit(out)
    assert np.isfinite(losses).all(), "non-finite losses"
    assert out["rel0"] <= 5e-3, f"loss[0] off the golden: {out['rel0']}"
    assert out["rel99"] <= 0.1, f"loss[99] off the golden: {out['rel99']}"
    assert losses[-1] < losses[0], "loss did not decrease"
    assert out["matrix_var_shape"] == [8, 43] and out["matrix_var_finite"]
    assert all(launches[k] > 0 for k in ("cholesky_batched", "fused_whiten",
                                         "fused_whiten_bwd")), f"a kernel never ran: {launches}"
    return out


def _amt_bank_steps(name, model, window_chunk) -> dict:
    """2 warm-up bank steps, then 10 timed ones, with the peak memory of
    the timed run."""
    t0 = time.perf_counter()
    model.optimize(maxiter=2, learning_rate=0.01, window_chunk=window_chunk)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _zero_all()
    t0 = time.perf_counter()
    losses, (first_s, run_s) = model.optimize(maxiter=10, learning_rate=0.01, timed=True,
                                              window_chunk=window_chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _fused_launches()
    roles = _launches("fused_whiten_bwd_roles")["fused_whiten_bwd_roles"]
    from gpitch_tpu_torch.linalg.fused_whiten import fused_whiten_source_chunks as chunks
    out = {"phase": "amt_full", "case": name, "windows": model.nwin,
           "pitches": len(model.pitches), "stacked": hasattr(model.bank.kern, "stacked"),
           "window_chunk": window_chunk, "warmup_2_steps_s": warmup_s,
           "ms_per_bank_step": wall / 10 * 1e3, "timed_first_s": first_s,
           "timed_run_s": run_s, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
           "losses_finite": bool(np.isfinite(losses).all()),
           "matrix_var_finite": bool(np.isfinite(model.matrix_var).all()),
           "fused": model.bank.fused_eligible(), "route": model.opt_info["route"],
           "launches_in_10_steps": launches, "role_split_launches_in_10_steps": roles,
           "source_chunks_last_launch": vars(chunks).copy()}
    emit(out)
    assert out["losses_finite"] and out["matrix_var_finite"], f"{name}: not finite"
    # M 160: kernel B keeps its present body
    assert roles == 0, f"{name}: the role-split body ran at M 160: {roles}"
    # a stacked bank takes the fused pair; a Sum of kernels does not
    assert out["fused"] == out["stacked"], out
    assert out["route"] == ("fused" if out["fused"] else "sum"), out
    assert all((n > 0) == out["fused"] for n in launches.values()), out
    return out


def phase_amt_full(dev):
    """The AMT bank at full width: 10 s (439 windows) with the 8 sounding
    pitches x 10 partials in windows of 64, and the 88-pitch dictionary
    (MIDI 21-108, 8 partials, the L1 penalty on) on 2 s in windows of 16.
    Returns (the records, the 10 s model, the 88-pitch model)."""
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
    torch.cuda.empty_cache()
    return out, model, piano


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


def phase_modgp(dev) -> dict:
    """ModGP on the card: (a) the golden fixture in f64 against
    tests/golden_values.json (rtol 1e-9, atol 1e-12) and in f32 (the ELBO
    at rtol 2e-4); (b) the demo: 1000 minibatch-100 Adam steps at lr 0.005
    by fit_adam_timed, the source recovered on x[::4] (RMSE < 0.05);
    (c) the bench workload (M 128, noise variance 1e-3), 1000 steps.  The
    Cholesky kernel's launches are read over (b) and (c)."""
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

    _zero_all()
    runs = {}
    for name, steps, kw in (("demo", 1000, {}), ("bench", 1000, {"num_inducing": 128,
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
    out.update(runs)
    out["launches"] = _launches("cholesky_batched")
    emit(out)
    assert ok64, f"ModGP f64 off the goldens: {ratio}"
    assert rel32 <= 2e-4, f"ModGP f32 ELBO off the golden: {rel32}"
    assert all(r["losses_finite"] for r in runs.values())
    assert runs["demo"]["rmse_source"] < 0.05, "source recovery failed"
    return out


# ------------------------------------------------- kernel learning
KL_GOLDENS = os.path.join(ROOT, "tests", "torch_kernel_learning_goldens.npz")
KL_TRAIN = dict(num_sam=10000, covsize=441, max_par=5)     # 250 L-BFGS steps


def learned_kernels(device, dtype, timings=None):
    """``learn_pitch_params(mode="train")`` on the notes of sosp-4s at full
    width (KL_TRAIN).  Returns (params, the sampled kernels (covsize,)
    each, the fit RMSE of each pitch)."""
    from gpitch_tpu_torch.pipelines.kernel_learning import approximate_kernel
    from gpitch_tpu_torch.pipelines.separation import learn_pitch_params
    notes = sosp_notes()
    params, (_, sk) = learn_pitch_params(
        [notes[p] for p in PITCHES], [f"piano_M{p}_train.wav" for p in PITCHES], FS,
        mode="train", timings=timings, device=device, dtype=dtype, **KL_TRAIN)
    n = KL_TRAIN["covsize"]
    x = np.linspace(0.0, (n - 1.0) / FS, n)
    rmse = []
    for i, kern in enumerate(sk):
        p = np.hstack([[0.0, float(params[0][i])], params[1][i], params[2][i]])
        fitted = approximate_kernel(torch.as_tensor(p, dtype=torch.float64), x).numpy()
        rmse.append(float(np.sqrt(np.mean((fitted - kern[:, 0]) ** 2))))
    return params, [k[:, 0] for k in sk], rmse


def learned_deviation(params, golden) -> dict:
    """Per quantity (lengthscale, energy, frequency), the largest deviation
    over the pitches of ``params`` from the golden ones, each as a share of
    the golden quantity's largest |value| for that pitch."""
    out = {}
    for k, name in enumerate(("lengthscale", "energy", "frequency")):
        out[name] = max(float(np.max(np.abs(np.asarray(a, float) - g)) / np.max(np.abs(g)))
                        for a, g in zip(params[k], golden[name]))
    return out


def _sosp14s(dev, **kw):
    onsets = [(p, on + 4.0 * k) for k in range(4) for p, on in ONSETS
              if on + 4.0 * k < 14.0]
    return make_sosp(14.0, dev, torch.float32, onsets=onsets, **kw)


def _steps_then_sources(model, sources, steps: int) -> dict:
    """``steps`` Adam steps, then predict_s and the separation RMSE."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = model.optimize(maxiter=steps, learning_rate=0.01)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    t0 = time.perf_counter()
    model.predict_s()
    predict_s = time.perf_counter() - t0
    return {"ms_per_bank_step": step_ms, "predict_s_s": predict_s,
            "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "losses_finite": bool(np.isfinite(losses).all()),
            "rmse": model.compute_rmse(sources)}


def phase_kernel_train(dev):
    """Kernel learning on the card, f32: learn_pitch_params(mode="train")
    on the three notes of sosp-4s at full width (KL_TRAIN: 10000 sampled
    windows of 441, 5 partials, 250 L-BFGS steps), held against the JAX
    package's f64 parameters within 3x the port's own f32 deviation on the
    CPU (tests/torch_kernel_learning_goldens.npz); then sosp-14s (222
    windows) with kernel_mode="load" from the learned parameters, 20 Adam
    steps and predict_s (the launches of the Cholesky kernel, kernels A and
    B and specmix over the build, the steps and the prediction; peak
    memory; RMSE < 0.3 x mean source RMS), and the same run from the FFT
    kernels beside it."""
    gold = np.load(KL_GOLDENS)
    timings = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, _, rmse = learned_kernels(dev, torch.float32, timings)
    learn_s = time.perf_counter() - t0
    dev_ = learned_deviation(params, gold)
    limits = {k: 3 * float(gold[f"port_f32_cpu_dev_{k}"]) for k in dev_}
    pitches = [{"midi": p, "sample_cov_s": timings["sample_cov"][i],
                "fit_s": timings["fit"][i], "lengthscale": float(params[0][i]),
                "energy": np.asarray(params[1][i], float).tolist(),
                "frequency": np.asarray(params[2][i], float).tolist(),
                "fit_rmse": rmse[i], "golden_fit_rmse": float(gold["rmse"][i])}
               for i, p in enumerate(PITCHES)]
    out = {"phase": "kernel_train", "case": "learn", "learn_s": learn_s,
           "pitches": pitches, "deviation": dev_, "limit": limits,
           "cpu_f32_fit_rmse_rel": float(gold["port_f32_cpu_rmse_rel"]),
           "fit_rmse_rel": float(np.max(np.abs(np.asarray(rmse) / gold["rmse"] - 1)))}
    emit(out)
    assert all(dev_[k] <= limits[k] for k in dev_), out

    runs = {}
    for mode in ("load", "fft"):
        _zero_all()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, sources = _sosp14s(dev, kernel_mode=mode, saved_params=params)
        torch.cuda.synchronize()
        rec = {"build_s": time.perf_counter() - t0, "windows": model.nwin,
               **_steps_then_sources(model, sources, 20),
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "launches": _all_launches()}
        runs[mode] = rec
        del model
    rms = float(np.mean([np.sqrt(np.mean(s ** 2)) for s in sources]))
    rec = {"phase": "kernel_train", "case": "sosp14s",
           "learned": runs["load"], "fft": runs["fft"], "rmse_limit": 0.3 * rms}
    emit(rec)
    learned = runs["load"]
    assert learned["losses_finite"] and np.isfinite(learned["rmse"]), rec
    assert learned["rmse"] < rec["rmse_limit"], "separation from learned kernels failed"
    assert all(n > 0 for n in learned["launches"].values()), f"a kernel never ran: {rec}"
    return {"learn": out, "sosp14s": rec}


def _rebuild_bank(model, dtype, windows=slice(None), samples=slice(None), **kw):
    """The bank of a SoSp or AMT ``model`` built anew from its windows
    (``windows``, cut to ``samples``), inducing points and kernel
    parameters, in ``dtype``, with ``kw`` (``lag_table``, ``masks``)
    passed to build_window_bank."""
    from gpitch_tpu_torch.pipelines.windowed_sgpr import build_window_bank
    saved, model.dtype = model.dtype, dtype
    try:
        return build_window_bank(model.xw[windows, samples], model.yw[windows, samples],
                                 model.z[windows], model._kern_builder, reg=model.reg,
                                 y_scale=getattr(model, "y_scale", 1.0),
                                 grid_dt=model.grid_dt, dtype=dtype, device=model.device,
                                 **kw)
    finally:
        model.dtype = saved


@torch.no_grad()
def _window_losses(bank, chunk: int) -> np.ndarray:
    """The per-window losses of a bank, ``chunk`` windows at a time."""
    from gpitch_tpu_torch.core.params import take_windows
    nw = bank.X.raw.shape[0]
    return np.concatenate([take_windows(bank, slice(c0, c0 + chunk)).loss().cpu().numpy()
                           for c0 in range(0, nw, chunk)]).astype(np.float64)


def _bank_rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.max(np.abs(a / b - 1)))


def _table_case(name, model, direct_rec, window_chunk) -> tuple[dict, object]:
    """One bank on the lag-table route against its direct route: the f64
    bound (table against direct, 1e-9), the f32 bound's difference, and 2 +
    10 Adam steps of the f32 table bank (ms a step, peak memory, the
    kernels' launches), beside the direct route's steps in ``direct_rec``
    (phase amt_full, this process).  Returns (the record, the table bank)."""
    from gpitch_tpu_torch.pipelines.windowed_sgpr import optimize_bank
    f64 = {}
    for table in (True, False):
        bank = _rebuild_bank(model, torch.float64, lag_table=table)
        f64[table] = _window_losses(bank, window_chunk)
        del bank
    f32 = {table: _rebuild_bank(model, torch.float32, lag_table=table)
           for table in (True, False)}
    loss32 = {table: _window_losses(b, window_chunk) for table, b in f32.items()}
    bank = f32[True]
    del f32
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bank, _ = optimize_bank(bank, 2, 0.01, window_chunk=window_chunk)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _zero_all()
    t0 = time.perf_counter()
    bank, losses = optimize_bank(bank, 10, 0.01, window_chunk=window_chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = {"phase": "lag_table", "case": name, "windows": model.nwin,
           "pitches": len(getattr(model, "pitches", PITCHES)), "M": int(model.z.shape[1]),
           "num_lags": bank.num_lags, "window_chunk": window_chunk,
           "fused_eligible": bank.fused_eligible(),
           "f64_table_vs_direct_rel": _bank_rel(f64[True], f64[False]),
           "f32_table_vs_direct_rel": _bank_rel(loss32[True], loss32[False]),
           "f32_table_vs_f64_rel": _bank_rel(loss32[True], f64[False]),
           "f32_direct_vs_f64_rel": _bank_rel(loss32[False], f64[False]),
           "warmup_2_steps_s": warmup_s, "ms_per_bank_step": wall / 10 * 1e3,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "losses_finite": bool(np.isfinite(losses).all()),
           "launches_in_10_steps": _all_launches(),
           "direct": {k: direct_rec[k] for k in ("ms_per_bank_step", "peak_gib", "fused",
                                                  "launches_in_10_steps")}}
    emit(rec)
    assert rec["f64_table_vs_direct_rel"] <= 1e-9, rec
    assert rec["losses_finite"] and not rec["fused_eligible"], rec
    launches = rec["launches_in_10_steps"]
    assert launches["cholesky_batched"] > 0 and launches["fused_whiten"] == 0 \
        and launches["fused_whiten_bwd"] == 0, rec
    return rec, bank


def phase_lag_table(dev, amt_model, amt_rec, piano, piano_rec) -> tuple[dict, tuple]:
    """The lag-table route on the card: (a) amt-10s (439 windows in chunks
    of 64, M 160, 8 x 10) and (b) amt88-2s (87 windows in chunks of 16, a
    Sum of 88 kernels) built with lag_table=True, against the same banks
    on their direct route (fused at amt-10s, unfused for the Sum); (c) a
    masked bank: sosp-4s with the last window's trailing half masked, its
    bound against the same window cut to its valid samples (f64 within
    1e-9; f32 reported), through the unfused route and the Cholesky
    kernel, and 5 Adam steps of it.  Returns (the records, (a)'s and (b)'s
    f32 table banks after their steps)."""
    from gpitch_tpu_torch.pipelines.windowed_sgpr import optimize_bank
    out = {}
    launches = {"cholesky_batched": 0, "fused_whiten": 0, "fused_whiten_bwd": 0,
                "specmix_matrix": 0}
    out["a"], table_bank = _table_case("a_amt10s", amt_model, amt_rec, 64)
    out["b"], table88 = _table_case("b_amt88_2s", piano, piano_rec, 16)
    for rec in (out["a"], out["b"]):
        for k, n in rec["launches_in_10_steps"].items():
            launches[k] += n
    torch.cuda.empty_cache()

    model, _ = make_sosp(4.0, dev, torch.float32)
    ws = model.window_size
    valid = ws // 2 + 1
    masks = np.ones(model.xw.shape)
    masks[-1, valid:] = 0.0
    last = slice(model.nwin - 1, model.nwin)
    rel = {}
    for dtype in (torch.float64, torch.float32):
        masked = _rebuild_bank(model, dtype, masks=masks)
        cut = _rebuild_bank(model, dtype, windows=last, samples=slice(0, valid))
        rel[str(dtype)] = float(_window_losses(masked, 64)[-1] / _window_losses(cut, 1)[0] - 1)
    _zero_all()
    masked, losses = optimize_bank(masked, 5, 0.01)
    torch.cuda.synchronize()
    rec = {"phase": "lag_table", "case": "c_masked_sosp4s", "windows": model.nwin,
           "valid_in_last": valid, "fused_eligible": masked.fused_eligible(),
           "f64_masked_vs_cut_rel": rel["torch.float64"],
           "f32_masked_vs_cut_rel": rel["torch.float32"],
           "losses_finite": bool(np.isfinite(losses).all()),
           "launches_in_5_steps": _all_launches()}
    emit(rec)
    out["c"] = rec
    assert abs(rec["f64_masked_vs_cut_rel"]) <= 1e-9, rec
    assert rec["losses_finite"] and not rec["fused_eligible"], rec
    ml = rec["launches_in_5_steps"]
    assert ml["cholesky_batched"] > 0 and ml["fused_whiten"] == ml["fused_whiten_bwd"] == 0, rec
    for k, n in ml.items():
        launches[k] += n
    out["launches"] = launches
    return out, (table_bank, table88)


# ------------------------------------------------- L-BFGS and natgrad
LBFGS_GOLDENS = os.path.join(ROOT, "tests", "torch_lbfgs_goldens.npz")
MODGP_LBFGS_ITERS = 15
NATGRAD = dict(num_steps=40, gamma=0.1, learning_rate=0.01, segment=10)


# ------------------------------------------ captured Adam steps (CUDA graphs)
class _BankSteps:
    """Adam steps of a whole bank as ``optimize_bank`` takes them: the window
    axis padded to whole chunks of ``chunk`` windows
    (``windowed_sgpr._chunk_plan``), one ``AdamSteps`` over a chunk's static
    leaves and weights, each chunk loaded in turn.  ``steps(n, eager)``: n
    steps of every chunk from the bank's state, replayed from the captured
    step or, with ``eager``, run eagerly (the plain version of the capture);
    returns the per-step totals over the chunks (numpy)."""

    def __init__(self, bank, chunk, steps: int, learning_rate: float = 0.01):
        from gpitch_tpu_torch.core.params import take_windows
        from gpitch_tpu_torch.models.fit import AdamSteps
        from gpitch_tpu_torch.pipelines import windowed_sgpr as tws
        self.size, nc, padded, self.w_all = tws._chunk_plan(bank, chunk)
        self.chunks = [take_windows(padded, slice(c * self.size, (c + 1) * self.size))
                       for c in range(nc)]
        self.w = None if self.w_all is None else self.w_all[:self.size].clone()
        loss = tws.bank_loss if self.w is None else tws._weighted_loss(self.w)
        self.run = AdamSteps(take_windows(self.chunks[0], slice(None)), loss, steps,
                             learning_rate)

    def steps(self, n: int, eager: bool = False) -> np.ndarray:
        total = np.zeros(n)
        for c, part in enumerate(self.chunks):
            self.run.load(part)
            if self.w is not None:
                self.w.copy_(self.w_all[c * self.size:(c + 1) * self.size])
            (self.run.eager if eager else self.run.run)(n)
            total += self.run.losses[:n].double().cpu().numpy()
        return total


class _ModgpSteps:
    """``steps(n, eager)`` for a ModGP's minibatch Adam, as ``_BankSteps``:
    the model loaded and the batch generator reseeded before each run."""

    def __init__(self, model, x, y, steps: int, dev):
        from gpitch_tpu_torch.core.params import copy_params
        from gpitch_tpu_torch.models.fit import AdamSteps, minibatch_fn
        n = x.shape[0]
        self.model = model
        self.generator = torch.Generator(device=dev)
        batch = minibatch_fn(x, y, 100, self.generator)
        self.run = AdamSteps(copy_params(model), lambda m, xb, yb: m.loss(xb, yb, num_data=n),
                             steps, 0.005, batch)

    def steps(self, n: int, eager: bool = False) -> np.ndarray:
        self.run.load(self.model)
        self.generator.manual_seed(0)
        (self.run.eager if eager else self.run.run)(n)
        return self.run.losses[:n].double().cpu().numpy()


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.max(np.abs(a / b - 1)))


def _captured_case(name, windows, make, n: int, strict: bool = False) -> tuple[dict, object]:
    """One path's Adam steps captured (C) and eager (E), each from the same
    state: a first captured run (the eager warm-up and the capture), a
    first eager run, then C E E C, each n steps; ms a step of each, the
    capture's host seconds, the kernels' calls held by a captured step,
    and the trajectories: C against E and E against E, relative, at every
    step.  ``strict``: C must be within E against E and within 1e-5;
    otherwise within the larger of the two.  Returns (the record, C)."""
    cap, eag = make(), make()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cap.steps(n)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    eag.steps(n, eager=True)
    runs = {"captured": [], "eager": []}
    for kind in ("captured", "eager", "eager", "captured"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = (cap if kind == "captured" else eag).steps(n, eager=kind == "eager")
        torch.cuda.synchronize()
        runs[kind].append(((time.perf_counter() - t0) / n * 1e3, losses))
    ms = {k: [r[0] for r in v] for k, v in runs.items()}
    spread = _rel(runs["eager"][1][1], runs["eager"][0][1])
    vs = max(_rel(r[1], runs["eager"][0][1]) for r in runs["captured"])
    out = {"phase": "captured_step", "case": name, "windows": windows, "steps": n,
           "ms_per_step_captured": ms["captured"], "ms_per_step_eager": ms["eager"],
           "speedup": float(np.median(ms["eager"]) / np.median(ms["captured"])),
           "first_captured_run_s": first_s, "capture_s": cap.run.capture_s,
           "calls_per_captured_step": cap.run.calls,
           "captured_vs_eager_rel": vs, "eager_vs_eager_rel": spread,
           "losses_finite": bool(np.isfinite(runs["captured"][0][1]).all()),
           "distinct_losses": int(len(np.unique(runs["captured"][0][1])))}
    emit(out)
    assert out["losses_finite"], f"{name}: not finite"
    assert cap.run.graph is not None, f"{name}: no step was captured"
    if strict:
        assert vs <= spread and vs <= 1e-5, f"{name}: captured off eager: {vs} ({spread})"
    else:
        assert vs <= max(spread, 1e-5), f"{name}: captured off eager: {vs} ({spread})"
    return out, cap


def _padded_vs_ragged(dev) -> dict:
    """amt-1s (43 windows) in chunks of 16, 100 steps: ``optimize_bank``'s
    padded layout (the last chunk 11 windows and 5 pads, captured) against
    the same layout run eagerly (within 1e-5) and against the parent tree's
    ragged layout (the last chunk's 11 windows alone, eagerly): in f32 the
    kernels' split plans follow the window count, so that difference is
    reported, not limited."""
    from gpitch_tpu_torch.core.params import take_windows
    from gpitch_tpu_torch.models.fit import AdamSteps
    from gpitch_tpu_torch.pipelines.windowed_sgpr import bank_loss, optimize_bank
    model, _ = make_amt(1.0, dev, torch.float32)
    nw = int(model.bank.X.raw.shape[0])
    _, padded = optimize_bank(model.bank, 100, 0.01, window_chunk=16)
    ragged = np.zeros(100)
    for c0 in range(0, nw, 16):
        run = AdamSteps(take_windows(model.bank, slice(c0, c0 + 16)), bank_loss, 100, 0.01)
        run.eager(100)
        ragged += run.losses.double().cpu().numpy()
    eager = _BankSteps(model.bank, 16, 100).steps(100, eager=True)
    out = {"phase": "captured_step", "case": "amt1s_padded_vs_ragged", "windows": nw,
           "captured_padded_vs_eager_padded_rel": _rel(padded, eager),
           "padded_vs_ragged_rel": _rel(padded, ragged),
           "padded_vs_ragged_rel_step0": _rel(padded[:1], ragged[:1])}
    emit(out)
    assert out["captured_padded_vs_eager_padded_rel"] <= 1e-5, out
    return out


def phase_captured_step(dev, sosp_model, full_model, amt_model, piano, table_bank,
                        table88) -> tuple[dict, dict]:
    """The port's Adam fits replay one captured step (``models.fit.AdamSteps``):
    captured against eager steps in turns on every path, each from the same
    state, through the chunking ``optimize_bank`` takes (``_BankSteps``):
    sosp-4s (62 windows, 100 steps, its trajectory within what two eager
    runs differ by and within 1e-5 at every step), sosp-14s (222, 20),
    amt-10s (439 in chunks of 64, 5), amt88-2s (the Sum route, 87 in chunks
    of 16, 2), the lag-table banks of amt-10s (5) and amt88-2s (2), and
    ModGP's bench workload (minibatch Adam, 300 steps: each replay draws the
    next batch, equal to the eager run's draws); then amt-1s's padded chunks
    against the ragged ones (``_padded_vs_ragged``).  Returns (the records,
    the captured runners the profile phase replays)."""
    out, keep = {}, {}
    cases = [("sosp4s", sosp_model.bank, None, 100, True),
             ("sosp14s", full_model.bank, None, 20, False),
             ("amt10s", amt_model.bank, 64, 5, False),
             ("amt88_2s_sum", piano.bank, 16, 2, False),
             ("amt10s_lag_table", table_bank, 64, 5, False),
             ("amt88_2s_lag_table", table88, 16, 2, False)]
    for name, bank, chunk, n, strict in cases:
        out[name], keep[name] = _captured_case(
            name, int(bank.X.raw.shape[0]), lambda: _BankSteps(bank, chunk, n), n, strict)
        if name == "amt88_2s_sum":          # its graph pool holds ~8 GiB
            del keep[name]
            torch.cuda.empty_cache()
    model, x, y, _ = make_modgp_demo(dev, num_inducing=128, noise=1e-3)
    xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
    yt = torch.as_tensor(y, dtype=torch.float32, device=dev)
    out["modgp_bench"], keep["modgp_bench"] = _captured_case(
        "modgp_bench", 0, lambda: _ModgpSteps(model, xt, yt, 300, dev), 300, strict=True)
    assert out["modgp_bench"]["distinct_losses"] == 300, "replays drew one batch"
    out["amt1s_padded_vs_ragged"] = _padded_vs_ragged(dev)
    return out, keep


def best_visited_totals(window_losses: np.ndarray) -> np.ndarray:
    """Per step, the sum over windows of each window's lowest loss so far
    (NaN losses never count as lower)."""
    lw = np.where(np.isnan(window_losses), np.inf, window_losses)
    return np.minimum.accumulate(lw, axis=1).sum(0)


def best_totals_dev(window_losses: np.ndarray, golden: np.ndarray) -> float:
    """The largest gap between two runs' best-visited totals, as a share of
    the golden run's whole decrease (its totals cross zero, so a gap
    relative to the total itself says little there)."""
    want = best_visited_totals(golden)
    return float(np.max(np.abs(best_visited_totals(window_losses) - want))
                 / (want[0] - want[-1]))


def _lbfgs_counts(info, seconds: float) -> dict:
    """An L-BFGS run's counts (``optimize_bank``'s info) per iteration and
    per evaluation of the bank's bound and gradient, by the host clock."""
    it = info["iterations"]
    evals = info["trials"] + info["grad_evaluations"] + info["value_evaluations"]
    return {"iterations": it, "evaluations": evals,
            "evaluations_per_iteration": evals / it,
            "syncs_per_iteration": info["syncs"] / it,
            "trials_per_iteration": info["trials_per_iteration"],
            "ms_per_iteration": seconds / it * 1e3,
            "ms_per_evaluation": seconds / evals * 1e3,
            "windows_at_initial_state": info["windows_at_initial_state"],
            "windows_nonfinite": info["windows_nonfinite"]}


class _LbfgsBank:
    """Per-window L-BFGS of a whole bank as ``optimize_bank(method="lbfgs")``
    runs it (``windowed_sgpr._optimize_bank_lbfgs``): the window axis padded
    to whole chunks of ``chunk`` windows, one ``LbfgsSteps`` over a chunk's
    static rows, each chunk loaded in turn.  ``iterations(n, how)``: n
    iterations of every chunk from the bank's state, "captured" (the three
    chained graphs replayed), "eager" (the plain version, every condition
    read on the host) or "one_chain" (the other design: the whole iteration,
    with ``MAX_LINESEARCH_STEPS`` conditional trials, as one chain built from
    the captured parts; ``one_chain()`` builds it).  Returns the per-window
    losses (nw, n) and the counts of the run."""

    def __init__(self, bank, chunk, iters: int):
        from gpitch_tpu_torch.core.params import take_windows
        from gpitch_tpu_torch.models._lbfgs import LbfgsSteps
        from gpitch_tpu_torch.models.fit import ParamRows
        from gpitch_tpu_torch.pipelines import windowed_sgpr as tws
        self.nw = int(bank.X.raw.shape[0])
        size, nc, padded, _ = tws._chunk_plan(bank, chunk)
        self.chunks = [take_windows(padded, slice(c * size, (c + 1) * size))
                       for c in range(nc)]
        self.rows = ParamRows(self.chunks[0], lambda b: b.loss(), batched=True)
        self.run = LbfgsSteps(self.rows.value_and_grad, self.rows.value,
                              self.rows.rows(), iters)
        self.one = None
        self.one_chain_s = None

    def one_chain(self) -> int:
        """Build the one-chain iteration from the captured parts; returns
        its node count."""
        from gpitch_tpu_torch.linalg._cuda import GraphChain
        from gpitch_tpu_torch.models._lbfgs import MAX_LINESEARCH_STEPS
        run, p = self.run, self.run.parts
        t0 = time.perf_counter()
        self.one = GraphChain([(p["need"], None), (p["evaluation"], run.any_need),
                               (p["head"], None)]
                              + [(p["trial"], run.any_active)] * MAX_LINESEARCH_STEPS
                              + [(p["tail"], None)])
        self.one_chain_s = time.perf_counter() - t0
        return self.one.nodes

    def iterations(self, n: int, how: str = "captured"):
        run, st = self.run, self.run.stats
        before = (st.iterations, st.trials + st.grad_evaluations + st.value_evaluations,
                  st.syncs)
        out = []
        for part in self.chunks:
            self.rows.load(part)
            run.load(self.rows.rows())
            with torch.no_grad():
                if how == "captured":
                    run.run(n)
                elif how == "eager":
                    for _ in range(n):
                        run.iteration()
                else:
                    for _ in range(n):
                        self.one.replay()
            run.finish()
            out.append(run.read(0, n)[0])
        counts = {"iterations": n, "chunk_iterations": st.iterations - before[0],
                  "evaluations": st.trials + st.grad_evaluations + st.value_evaluations
                  - before[1], "host_reads": st.syncs - before[2]}
        return np.concatenate(out)[:self.nw], counts


def _rel_nan(a: np.ndarray, b: np.ndarray) -> float:
    """The largest |a / b - 1| over the entries where b is finite; inf when
    a and b are not finite at the same entries."""
    bad = ~np.isfinite(b)
    if not np.array_equal(bad, ~np.isfinite(a)):
        return float("inf")
    return float(np.max(np.abs(a[~bad] / b[~bad] - 1), initial=0.0))


def _lbfgs_captured_case(name, bank, chunk, n: int) -> tuple[dict, tuple]:
    """One bank's per-window L-BFGS captured (C) and eager (E), each from the
    same state: a first captured run (the eager warm-up iteration and the
    captures), a first eager run, then C E E C and the one-chain design
    twice (O O), each n iterations; ms an iteration of each, evaluations
    and host reads an iteration, the captures' host seconds, the chains'
    nodes, the device memory the captured runner holds (its static tensors
    and its graphs' pool: the reserved memory it added, the cache emptied
    before and after its first run; a replay allocates nothing) against the
    eager runner's peak (its static tensors and its run's temporaries, above
    what was allocated before it), and the largest relative difference of the
    per-window losses: C and O against E, and E against E (C and O must be
    within E against E and within 1e-5, NaN at the same places).  No host
    read may fall inside a chunk's iterations.  Returns (the record, (C, E)).
    """
    gib = 2.0 ** 30
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    cap = _LbfgsBank(bank, chunk, n)
    t0 = time.perf_counter()
    cap.iterations(n)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    held = (torch.cuda.memory_reserved() - reserved) / gib
    allocated = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eag = _LbfgsBank(bank, chunk, n)
    eag.iterations(n, "eager")
    torch.cuda.synchronize()
    eager_peak = (torch.cuda.max_memory_allocated() - allocated) / gib
    one_nodes = cap.one_chain()
    runs = {"captured": [], "eager": [], "one_chain": []}
    for how in ("captured", "eager", "eager", "captured", "one_chain", "one_chain"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lw, counts = (eag if how == "eager" else cap).iterations(n, how)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n * 1e3
        runs[how].append((ms, lw, counts))
    lw = {k: [r[1].astype(np.float64) for r in v] for k, v in runs.items()}
    spread = _rel_nan(lw["eager"][1], lw["eager"][0])
    vs = max(_rel_nan(t, lw["eager"][0]) for t in lw["captured"] + lw["one_chain"])
    c0 = runs["captured"][0][2]
    e0 = runs["eager"][0][2]
    out = {"phase": "lbfgs", "case": name, "windows": cap.nw, "window_chunk": chunk,
           "chunks": len(cap.chunks), "iterations": n,
           "ms_per_iteration_captured": [r[0] for r in runs["captured"]],
           "ms_per_iteration_eager": [r[0] for r in runs["eager"]],
           "ms_per_iteration_one_chain": [r[0] for r in runs["one_chain"]],
           "speedup": float(np.median([r[0] for r in runs["eager"]])
                            / np.median([r[0] for r in runs["captured"]])),
           "evaluations_per_iteration": c0["evaluations"] / (n * len(cap.chunks)),
           "host_reads_per_iteration_captured": c0["host_reads"] / n,
           "host_reads_per_iteration_eager": e0["host_reads"] / n,
           "host_reads_inside_a_segment": c0["host_reads"] - len(cap.chunks),
           "first_captured_run_s": first_s, "capture_s": cap.run.capture_s,
           "nodes_head_trial_tail": [g.nodes for g in cap.run.graphs],
           "one_chain_nodes": one_nodes, "one_chain_build_s": cap.one_chain_s,
           "calls_per_evaluation": cap.run.calls["trial"],
           "held_gib_captured": held, "peak_gib_eager": eager_peak,
           "captured_vs_eager_rel": vs, "eager_vs_eager_rel": spread,
           "windows_not_finite": int((~np.isfinite(lw["captured"][0])).any(1).sum())}
    emit(out)
    assert out["host_reads_inside_a_segment"] == 0, out
    assert vs <= spread and vs <= 1e-5, f"{name}: captured off eager: {vs} ({spread})"
    return out, (cap, eag)


def phase_lbfgs(dev, amt_model):
    """Per-window L-BFGS on the card, f32: (a) the first 16 windows of
    sosp-4s for 30 iterations against the JAX package's f64 per-window
    trajectories, loss[0] within rtol 5e-3 and the best-visited totals
    within 3x the port's own f32 spread on the CPU (both from
    tests/torch_lbfgs_goldens.npz); (d) the same windows with window 5's
    first inducing point made NaN: it stays NaN and every other window
    follows (a) (rtol 1e-6); (b) sosp-14s at full width through
    SoSp.optimize(method="lbfgs", maxiter=20, timed=True), then predict_s
    and the RMSE limit of the Adam path, and the launches of the Cholesky
    kernel and kernels A and B; (c) amt-1s through AMT.optimize(
    method="lbfgs", maxiter=20), with the windows whose best f32 value lies
    below what any state can give, and their state's value by the plain
    versions on the CPU and in f64 (reported, not limited; see PERF.md
    §6).  Every run goes through the captured solver (``LbfgsSteps``: one
    eager warm-up iteration, the captures, then replays), and after (a),
    (b) and (c), and on amt-10s (``amt_model``'s 439 windows in chunks of
    64, 5 iterations), ``_lbfgs_captured_case`` holds the captured
    iterations against eager ones in turns.  Returns (the records, (b)'s
    model, (a)'s trained windows, (b)'s captured and eager runners)."""
    from gpitch_tpu_torch.audio.pianoroll import Pianoroll
    from gpitch_tpu_torch.core.params import Param, map_params, take_windows, to_device
    from gpitch_tpu_torch.pipelines.windowed_sgpr import optimize_bank
    gold = np.load(LBFGS_GOLDENS)
    gl = gold["sosp16_window_losses"]
    nwin, iters = gl.shape
    out = {}

    model, _ = make_sosp(4.0, dev, torch.float32)
    sub = take_windows(model.bank, slice(0, nwin))
    del model
    _zero_all()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trained_sub, losses, info = optimize_bank(sub, iters, method="lbfgs", return_info=True)
    seconds = time.perf_counter() - t0
    spread = float(gold["port_f32_cpu_sosp16_best_dev"])
    rec = {"phase": "lbfgs", "case": "a_sosp4s_16", "windows": nwin,
           "loss0": float(losses[0]), "golden0": float(gl[:, 0].sum()),
           "rel0": float(abs(losses[0] / gl[:, 0].sum() - 1)),
           "best_final": float(best_visited_totals(info["window_losses"])[-1]),
           "golden_best_final": float(best_visited_totals(gl)[-1]),
           "best_dev": best_totals_dev(info["window_losses"], gl),
           "best_dev_limit": 3 * spread, "cpu_f32_best_dev": spread,
           "launches": _path_launches(), **_lbfgs_counts(info, seconds)}
    emit(rec)
    out["a"] = rec
    assert rec["rel0"] <= 5e-3, f"L-BFGS loss[0] off the golden: {rec['rel0']}"
    assert rec["best_dev"] <= rec["best_dev_limit"], rec
    out["captured_sosp4s16"], _ = _lbfgs_captured_case("sosp4s16", sub, None, iters)

    bad = take_windows(sub, slice(0, nwin))
    with torch.no_grad():
        bad.Z.raw[5, 0, 0] = float("nan")
    _, _, binfo = optimize_bank(bad, iters, method="lbfgs", return_info=True)
    keep = [i for i in range(nwin) if i != 5]
    a_lw, b_lw = info["window_losses"][keep], binfo["window_losses"][keep]
    rec = {"phase": "lbfgs", "case": "d_nan_window", "bad_window": 5,
           "bad_all_nan": bool(np.isnan(binfo["window_losses"][5]).all()),
           "others_max_rel_diff": float(np.max(np.abs(b_lw / a_lw - 1))),
           "windows_nonfinite": binfo["windows_nonfinite"],
           "windows_nonfinite_clean": info["windows_nonfinite"],
           "windows_at_initial_state": binfo["windows_at_initial_state"]}
    emit(rec)
    out["d"] = rec
    assert rec["bad_all_nan"] and rec["others_max_rel_diff"] <= 1e-6, rec
    assert rec["windows_nonfinite"] == info["windows_nonfinite"] + 1, rec
    del sub, bad

    onsets = [(p, on + 4.0 * k) for k in range(4) for p, on in ONSETS
              if on + 4.0 * k < 14.0]
    model, sources = make_sosp(14.0, dev, torch.float32, onsets=onsets)
    bank0 = model.bank
    _zero_all()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, (first_s, run_s) = model.optimize(maxiter=20, method="lbfgs", timed=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _path_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    best = best_visited_totals(model.opt_info["window_losses"])
    t0 = time.perf_counter()
    model.predict_s()
    predict_s = time.perf_counter() - t0
    rmse = model.compute_rmse(sources)
    rms = float(np.mean([np.sqrt(np.mean(s ** 2)) for s in sources]))
    rec = {"phase": "lbfgs", "case": "b_sosp14s", "windows": model.nwin,
           "loss_first": float(losses[0]), "best_first": float(best[0]),
           "best_last": float(best[-1]), "timed_first_s": first_s, "timed_run_s": run_s,
           "peak_gib": peak, "predict_s_s": predict_s, "rmse": rmse,
           "rmse_limit": 0.3 * rms, "launches": launches,
           **_lbfgs_counts(model.opt_info, seconds)}
    emit(rec)
    out["b"] = rec
    assert np.isfinite(best).all() and best[-1] < best[0], rec
    assert np.isfinite(rmse) and rmse < rec["rmse_limit"], "separation failed"
    assert all(n > 0 for n in launches.values()), f"a kernel never ran: {launches}"
    out["captured_sosp14s"], runners = _lbfgs_captured_case("sosp14s", bank0, None, 20)
    del bank0

    amt, events = make_amt(1.0, dev, torch.float32)
    amt_bank0 = amt.bank
    _zero_all()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    amt.optimize(maxiter=20, method="lbfgs")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    amt.piano_roll = Pianoroll(fs=20, duration=1.0, notes=events)
    p, r, f = amt.evaluate(mode="mad")
    abest = best_visited_totals(amt.opt_info["window_losses"])
    # no state of a window gives a loss below 0.5 N log(2 pi sigma^2) (the
    # bound is at most log N(y | 0, Q + sigma^2 I)): a best value below it
    # is the f32 bound broken down at that state
    with torch.no_grad():
        sigma2 = amt.bank.variance.value.double().cpu().numpy().reshape(-1)
    floor = 0.5 * amt.window_size * np.log(2 * np.pi * sigma2)
    best_w = np.nanmin(amt.opt_info["window_losses"], axis=1)
    broken = np.flatnonzero(best_w < floor).tolist()
    # those windows' returned state by the plain versions (f32, CPU) and in f64
    plain, f64 = [], []
    if broken:
        with torch.no_grad():
            part = take_windows(amt.bank, broken)
            plain = to_device(part, "cpu").loss().tolist()
            f64 = map_params(part, lambda q: Param(q.raw.detach().double(), q.transform,
                                                   q.trainable)).loss().tolist()
    rec = {"phase": "lbfgs", "case": "c_amt1s", "windows": amt.nwin,
           "best_first": float(abest[0]), "best_last": float(abest[-1]),
           "windows_below_the_exact_floor": broken, "their_best": best_w[broken].tolist(),
           "their_floor": floor[broken].tolist(), "their_plain_f32_cpu": plain,
           "their_f64": f64,
           "launches": _path_launches(),
           "mad_pianoroll": {"precision": float(p), "recall": float(r), "f": float(f)},
           **_lbfgs_counts(amt.opt_info, seconds)}
    emit(rec)
    out["c"] = rec
    assert np.isfinite(abest).all() and np.all(np.diff(abest) <= 0) and abest[-1] < abest[0], rec
    assert np.isfinite(amt.matrix_var).all()
    out["captured_amt1s"], _ = _lbfgs_captured_case("amt1s", amt_bank0, None, 20)
    del amt, amt_bank0
    out["captured_amt10s"], _ = _lbfgs_captured_case("amt10s", amt_model.bank, 64, 5)
    return out, model, trained_sub, runners


def phase_natgrad(dev) -> tuple[dict, Callable]:
    """ModGP's other optimizers on the card, f32, each captured
    (``NatgradSteps``, ``LbfgsSteps``): (a) the golden fixture,
    full-batch natgrad_adam (NATGRAD) and L-BFGS (15 iterations), against
    the JAX package's f64 trajectories (tests/torch_lbfgs_goldens.npz)
    within 2e-4 (the fixture's f32 ELBO limit; the port's f32 spread on the
    CPU is printed beside it); (b) the demo (N 16000, M 76) trained by 500
    minibatch-100 natgrad_adam steps (gamma 0.1, lr 0.005, segments of
    100): source RMSE < 0.05, skipped steps and steps/s; (c) the demo's
    steps captured against eager (``_natgrad_captured``).  Returns (the
    records, (c)'s runs for the profile)."""
    from gpitch_tpu_torch.models import fit_modgp
    from gpitch_tpu_torch.models.natgrad import fit_natgrad_adam
    gold = np.load(LBFGS_GOLDENS)
    model, x, y = golden_modgp(torch.float32, dev)
    _, ng = fit_natgrad_adam(model, x, y, **NATGRAD)
    _, lb = fit_modgp(model, x, y, num_steps=MODGP_LBFGS_ITERS, method="lbfgs",
                      minibatch_size=None)
    run_min = np.minimum.accumulate
    out = {"phase": "natgrad",
           "golden_natgrad_rel": float(np.max(np.abs(ng / gold["modgp_natgrad_losses"] - 1))),
           "cpu_f32_natgrad_rel": float(gold["port_f32_cpu_natgrad_rel"]),
           "golden_lbfgs_min_rel": float(np.max(np.abs(
               run_min(lb) / run_min(gold["modgp_lbfgs_losses"]) - 1))),
           "cpu_f32_lbfgs_min_rel": float(gold["port_f32_cpu_lbfgs_min_rel"]),
           "golden_limit": 2e-4}

    model, x, y, truth = make_modgp_demo(dev)
    xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
    yt = torch.as_tensor(y, dtype=torch.float32, device=dev)
    steps = 500
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, losses, info = fit_modgp(
        model, xt, yt, num_steps=steps, method="natgrad_adam", learning_rate=0.005,
        minibatch_size=100, segment=100, gamma=0.1,
        generator=torch.Generator(device=dev).manual_seed(0), return_info=True)
    seconds = time.perf_counter() - t0
    src = model.predict_source(xt[::4]).cpu().numpy()
    out["demo"] = {"steps": steps, "steps_per_s": steps / seconds,
                   "ms_per_step": seconds / steps * 1e3, "n_skipped": info["n_skipped"],
                   "adam_steps": info["adam_steps"], "returned": info["returned"],
                   "full_loss_at_segments": info["full_loss_at_segments"],
                   "rmse_source": float(np.sqrt(np.mean((src[:, :1] - truth[::4]) ** 2)))}
    emit(out)
    assert out["golden_natgrad_rel"] <= out["golden_limit"], out
    assert out["golden_lbfgs_min_rel"] <= out["golden_limit"], out
    assert np.isfinite(out["demo"]["rmse_source"]) and out["demo"]["rmse_source"] < 0.05, \
        "source recovery failed"
    model, x, y, _ = make_modgp_demo(dev)
    xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
    yt = torch.as_tensor(y, dtype=torch.float32, device=dev)
    out["captured"], steps = _natgrad_captured(model, xt, yt, dev, 200)
    return out, steps


def _natgrad_captured(model, x, y, dev, n: int) -> tuple[dict, Callable]:
    """``fit_natgrad_adam``'s steps (``NatgradSteps``: minibatch 100, gamma
    0.1, lr 0.005) on the demo, captured (C) and eager (E), each from the
    model with the batch generator reseeded: a first captured run (3 eager
    warm-up steps and the capture), a first eager run, then C E E C, each n
    steps; steps/s of each, the capture's host seconds, and the losses: C
    against E relative, NaN (skipped steps) at the same places (C must be
    within E against E and within 1e-5).  Returns (the record, steps(kind,
    k=n): one more such run of k steps)."""
    from gpitch_tpu_torch.core.params import copy_params
    from gpitch_tpu_torch.models.fit import minibatch_fn
    from gpitch_tpu_torch.models.natgrad import NatgradSteps
    runs = {}
    for kind in ("captured", "eager"):
        batch = minibatch_fn(x, y, 100, torch.Generator(device=dev))
        runs[kind] = NatgradSteps(copy_params(model), x, y, n, 0.1, x.shape[0], 0.005,
                                  batch_fn=batch)

    def steps(kind, k=n):
        run = runs[kind]
        run.load(model)
        run.batch_fn.generator.manual_seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (run.run if kind == "captured" else run.eager)(k)
        losses = run.losses[:k].double().cpu().numpy()
        return k / (time.perf_counter() - t0), losses

    t0 = time.perf_counter()
    steps("captured")
    first_s = time.perf_counter() - t0
    steps("eager")
    timed = {"captured": [], "eager": []}
    for kind in ("captured", "eager", "eager", "captured"):
        timed[kind].append(steps(kind))
    spread = _rel_nan(timed["eager"][1][1], timed["eager"][0][1])
    vs = max(_rel_nan(r[1], timed["eager"][0][1]) for r in timed["captured"])
    out = {"steps": n, "steps_per_s_captured": [r[0] for r in timed["captured"]],
           "steps_per_s_eager": [r[0] for r in timed["eager"]],
           "first_captured_run_s": first_s, "capture_s": runs["captured"].capture_s,
           "skipped": int(np.isnan(timed["captured"][0][1]).sum()),
           "distinct_losses": int(len(np.unique(timed["captured"][0][1]))),
           "captured_vs_eager_rel": vs, "eager_vs_eager_rel": spread}
    emit({"phase": "natgrad", "case": "captured_demo", **out})
    assert runs["captured"].graph is not None, "no natgrad step was captured"
    assert vs <= spread and vs <= 1e-5, f"natgrad captured off eager: {vs} ({spread})"
    return out, steps


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
    the envelope, the variance and the sum).  Kernel B, in the association
    it takes (the prototype's): G = dU + dU^T M^2 per window, then per
    sample A = Linv Kuf again M (M + 1), dA = G A + dv err^T 2 M^2 + 2 M,
    the dense dLinv = dA Kuf^T (every entry is an output) 2 M^2 and dK =
    Linv^T dA M (M + 1), plus the build and the per-source sums 8 P S M N.
    Bytes: each input read once (Linv's lower triangle), each output
    written once.

    Two readings of the operations.  ``fp32``: all of them at the CUDA
    cores' f32 rate.  The least time (the bound): the products (everything
    but the build's envelope, variance and source sum, 4 S M N; the
    mixture is a K = 2P contraction, the per-source sums too) at the 3xTF32
    tensor-core rate, 165 TFLOP/s, beside that rest at the f32 rate; the two
    units run at once, so the larger time counts.  Returns (bound ms, by,
    fp32 ms, by)."""
    build = (4 * p + 4) * s * m * n
    tri = m * (m + 1) * n
    params = 2 * s * p + 2 * s
    linv = m * (m + 1) // 2
    if backward:
        flops = nw * (m * m + 2 * tri + 4 * m * m * n + 2 * m * n + build
                      + 8 * p * s * m * n)
        floats = nw * (linv + 2 * m * m + 2 * m + 2 * n + params) + params
    else:
        flops = nw * (2 * tri + 2 * m * n + build)
        floats = nw * (linv + m * m + 2 * m + 2 * n) + params
    rest = nw * 4 * s * m * n
    t_bytes = 4 * floats / HBM_BYTES_PER_S * 1e3
    t_ops = max((flops - rest) / TF32X3_FLOP_PER_S, rest / F32_FLOP_PER_S) * 1e3
    least = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return least + bound_ms(4 * floats, flops)


def _no_grad(fn):
    def run():
        with torch.no_grad():
            return fn()
    return run


_WHITEN_ARGS = ("zc", "xc", "err", "linv", "energy", "freq", "var", "inv_l")


def _forward_rows(got, fwd32, fwd64, ref) -> dict:
    """Each output of kernel A within 1e-4 of max|ref| of ``ref`` (the
    prototype's own limit, proto_fused_whiten.py:364; ``ref`` is the f64
    plain forward, or the f32 one where a case says so) and, against the
    f64 plain forward, within 4x the f32 plain version's own error, which a
    kernel that took its products in plain TF32 (~1e-3) would miss."""
    rows = {}
    for what, g, g32, g64, r in zip(("U", "v"), got, fwd32, fwd64, ref):
        scale = float(r.abs().max())
        err = float((g.double() - r.double()).abs().max())
        err64 = float((g.double() - g64).abs().max())
        err32 = float((g32.double() - g64).abs().max())
        row = {"max_abs_err": err, "max_rel_err": err / scale, "tol": 1e-4 * scale,
               "f64_rel_err": err64 / float(g64.abs().max()),
               "plain_f32_f64_rel_err": err32 / float(g64.abs().max()),
               "tol_f64": 4 * err32, "finite": bool(torch.isfinite(g).all())}
        row["ok"] = row["finite"] and err <= 1e-4 * scale and err64 <= 4 * err32
        rows[what] = row
    return rows


def _whiten_case(name, d, dev, arbiter=True, timing=False) -> dict:
    """Kernel A through both entry points and kernel B against the plain
    version: the f64 plain forward and autograd through it (``arbiter``),
    else the f32 ones, are the reference; kernel A within the limits of
    ``_forward_rows`` (also against the f64 plain forward in either case),
    kernel B per output within the larger of 1e-3 of max|ref| and 4x the
    error of autograd through the f32 plain version."""
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
    if arbiter:
        fwd64, bwd_ref = plain_autograd(tensors(torch.float64))
    else:
        t64 = tensors(torch.float64)
        with torch.no_grad():
            fwd64 = fused_whiten_plain(*(t64[k] for k in _WHITEN_ARGS))
        del t64
        bwd_ref = bwd32
    out = {"phase": "fused_whiten", "case": name, "shape": [nw, m, n, s, p],
           "reference": "f64 plain" if arbiter else "f32 plain", "forward": {},
           "backward": {}}
    ok = True
    for entry, got in fwd.items():
        for what, row in _forward_rows(got, fwd32, fwd64,
                                       fwd64 if arbiter else fwd32).items():
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
        for k, backward in (("A", False), ("B", True)):
            (tm[f"bound_{k}_ms"], tm[f"bound_{k}_by"], tm[f"bound_{k}_fp32_ms"],
             tm[f"bound_{k}_fp32_by"]) = _whiten_bound(nw, m, n, s, p, backward)
            # the share of each bound that the kernel reaches
            tm[f"kernel_{k}_of_bound"] = tm[f"bound_{k}_ms"] / tm[f"kernel_{k}_ms"]
            tm[f"kernel_{k}_of_fp32_bound"] = tm[f"bound_{k}_fp32_ms"] / tm[f"kernel_{k}_ms"]
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
    1e-5 of max|ref| of splits=1's (the partial sums only change order), and
    kernel A's U and v at every split within the limits of
    ``_forward_rows``."""
    import importlib
    fw = importlib.import_module("gpitch_tpu_torch.linalg.fused_whiten")
    t = {k: torch.as_tensor(np.array(v), dtype=torch.float32, device=dev) for k, v in d.items()}
    ins = [t[k] for k in ("zc", "xc", "err", "linv")]
    par = [t[k] for k in ("energy", "freq", "var", "inv_l")]
    with torch.no_grad():
        fwd32 = fw.fused_whiten_plain(*ins, *par)
        fwd64 = fw.fused_whiten_plain(*(torch.as_tensor(np.array(d[k]), dtype=torch.float64,
                                                        device=dev) for k in _WHITEN_ARGS))
    nw, m, _ = ins[0].shape
    n = ins[1].shape[-1]
    sizes = (nw, m, n) + tuple(par[0].shape)
    tiles = -(-n // fw.TILE_T)
    plan = {"A": fw._splits(False, sizes, dev.index), "B": fw._splits(True, sizes, dev.index)}

    def kernels(k):
        with torch.no_grad():
            return (fw._forward_kernel(*ins, *par, splits=k),
                    fw._backward_kernel(*ins[:4], t["du"], t["dv"], *par, splits=k)[0])

    refs = kernels(1)
    out = {"phase": "fused_whiten", "case": f"splits_{name}", "shape": list(sizes),
           "tiles": tiles, "plan": plan, "A_ms": {}, "B_ms": {}, "max_rel_diff": 0.0,
           "forward": {}}
    forward_ok = True
    for k in sorted(set(_SPLITS) | set(plan.values())):
        if k > tiles or -(-tiles // -(-tiles // k)) != k:
            continue
        fwd, dl = kernels(k)
        for got, ref in ((fwd[0], refs[0][0]), (dl, refs[1])):
            out["max_rel_diff"] = max(out["max_rel_diff"], float(
                (got - ref).abs().max() / ref.abs().max()))
        rows = _forward_rows(fwd, fwd32, fwd64, fwd64)
        forward_ok &= all(r["ok"] for r in rows.values())
        for what, row in rows.items():
            worst = out["forward"].setdefault(what, row)
            if row["max_rel_err"] > worst["max_rel_err"] or not row["ok"]:
                out["forward"][what] = row
        out["A_ms"][k] = cuda_ms(_no_grad(lambda: fw._forward_kernel(*ins, *par, splits=k)),
                                 5, warmup=1)
        out["B_ms"][k] = cuda_ms(lambda: fw._backward_kernel(
            *ins[:4], t["du"], t["dv"], *par, splits=k), 5, warmup=1)
    out["ok"] = out["max_rel_diff"] <= 1e-5 and forward_ok
    emit(out)
    assert out["ok"], f"the split changes the kernels' result ({name})"
    return out


def _whiten_bank(name, model, dev) -> dict:
    """The pair on a trained bank's own bound: U / sigma^2 against the
    unfused composition's AAT (``_common_unfused``) and v against its Aerr
    (1e-4 of max|ref|); the bank's Linv has an exactly zero strict upper
    triangle (``triu_max``: kernel A reads the lower one only);
    fused_whiten_flat with the per-window flat parameters gives the same;
    then, for a seeded (dU, dv), the gradient of
    <U, dU> + <v, dv> in every trainable raw leaf through fused_whiten (Linv
    from chol_inv under grad) and through the unfused A (1e-3 of
    max|ref|)."""
    from gpitch_tpu_torch.core.params import named_params
    from gpitch_tpu_torch.linalg.fused_whiten import fused_whiten, fused_whiten_flat
    bank = model.bank
    assert bank.mask is None
    with torch.no_grad():
        err, _, _, A, AAT, _, _, sigma2 = bank._common_unfused()
        aerr = A @ err
        chain = bank.fused_whiten_args()
        triu_max = float(torch.triu(chain[3], 1).abs().max())
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
           "flat_equal": bool(torch.equal(uf, u) and torch.equal(vf, v)),
           "triu_max": triu_max}
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
            err, _, _, A, *_ = bank._common_unfused()
            u, v = A @ A.mT, A @ err
        ((u * du).sum() + (v * dv).sum()).backward()
        grads[route] = {k: prm.raw.grad.clone() for k, prm in named_params(bank)
                        if prm.raw.grad is not None}
    for _, prm in named_params(bank):
        prm.raw.grad = None
    out["grad_rel_err"] = {k: float((grads["fused"][k] - g).abs().max() / g.abs().max())
                           for k, g in grads["common"].items()}
    out["ok"] = (out["AAT_rel_err"] <= 1e-4 and out["Aerr_rel_err"] <= 1e-4
                 and out["flat_equal"] and triu_max == 0.0
                 and sorted(grads["fused"]) == sorted(grads["common"])
                 and len(grads["common"]) > 0
                 and all(r <= 1e-3 for r in out["grad_rel_err"].values()))
    emit(out)
    assert out["ok"], f"the fused pair disagrees with the bank's bound ({name})"
    return out


TRAINED_STATE = os.path.join(ROOT, "tests", "torch_fused_whiten_trained_state.npz")
TRAINED_WINDOWS = 16


def trained_bank(device, dtype):
    """The first 16 windows of sosp-4s at the f64 per-window L-BFGS state
    saved in TRAINED_STATE (30 iterations: written by
    tests/test_torch_fused_whiten_trained.py), as a bank in ``dtype``."""
    from gpitch_tpu_torch.core.params import named_params, take_windows
    model, _ = make_sosp(4.0, device, dtype)
    bank = take_windows(model.bank, slice(0, TRAINED_WINDOWS))
    state = np.load(TRAINED_STATE)
    for key, prm in named_params(bank):
        if key in state.files:
            with torch.no_grad():
                prm.raw.copy_(torch.as_tensor(state[key], dtype=prm.raw.dtype))
    return bank


@contextlib.contextmanager
def f32_jitters(m: int):
    """Within it, every dtype takes float32's jitters (1e-4 absolute, the
    M-aware 8e-7 M relative of linalg.ops.add_jitter): an f64 evaluation
    then arbitrates an f32 one of the same function."""
    from gpitch_tpu_torch import config
    config.set_jitter(config.default_jitter(torch.float32))
    config.set_jitter_rel(max(config.default_jitter_rel(torch.float32), 8e-7 * m))
    try:
        yield
    finally:
        config.set_jitter(None)
        config.set_jitter_rel(None)


def bank_grad(bank) -> tuple[float, torch.Tensor]:
    """(the bank's total loss, the gradient of the total in its trainable
    raw leaves, flat in f64, in ``named_params`` order)."""
    from gpitch_tpu_torch.core.params import named_params
    raws = [p.raw for _, p in named_params(bank) if p.trainable]
    loss = bank.loss().sum()
    grads = torch.autograd.grad(loss, raws)
    return float(loss.detach()), torch.cat([g.double().reshape(-1) for g in grads])


def pair_cotangents(bank):
    """(``bank_grad(bank)``, the fused pair's inputs in the bank's bound,
    and the cotangents du, dv of its (U, v) in that gradient), by a spy on
    the bound's call of fused_whiten."""
    from gpitch_tpu_torch.models import sgpr
    inner, seen = sgpr.fused_whiten, {}

    def spy(*args):
        u, v = inner(*args)
        seen["args"] = [a.detach() for a in args]
        u.register_hook(lambda g: seen.__setitem__("du", g.contiguous()))
        v.register_hook(lambda g: seen.__setitem__("dv", g.contiguous()))
        return u, v

    sgpr.fused_whiten = spy
    try:
        out = bank_grad(bank)
    finally:
        sgpr.fused_whiten = inner
    return out, seen["args"], seen["du"], seen["dv"]


def _whiten_trained(dev) -> dict:
    """(e) The pair at a state that per-window L-BFGS reaches, where the
    bound is ill-conditioned (|G| ~ 4e7): the f32 bank of TRAINED_STATE's
    16 sosp-4s windows through its own bound (kernels A and B), its
    gradient in the trainable raws within 2e-4 (relative norm,
    docs/F32_ACCURACY.md) of the same bound in f64 with the f32 jitters,
    on the card by the unfused route; and kernel B's outputs at the bound's
    own cotangent against the f64 plain version on the same inputs, output
    by output (reported)."""
    from gpitch_tpu_torch.core.params import Param, map_params
    fw = _fused_whiten_module()
    bank64 = trained_bank(dev, torch.float64)
    bank = map_params(bank64, lambda p: Param(p.raw.detach().float(), p.transform,
                                              p.trainable))
    m = int(bank.Z.raw.shape[-2])
    with f32_jitters(m):
        loss64, grad64 = bank_grad(bank64)
    _zero_all()
    (loss, grad), chain, du, dv = pair_cotangents(bank)
    torch.cuda.synchronize()
    out = {"phase": "fused_whiten", "case": "e_trained", "windows": TRAINED_WINDOWS, "M": m,
           "loss": loss, "loss_f64": loss64, "value_rel": abs(loss / loss64 - 1),
           "grad_rel_norm": float((grad - grad64).norm() / grad64.norm()), "tol": 2e-4,
           "launches": _fused_launches()}
    out["max_abs_G"] = float((du + du.mT).abs().max())
    out["max_abs_linv"] = float(chain[3].abs().max())
    with torch.no_grad():
        got = fw.fused_whiten_bwd(*chain[:4], du, dv, *chain[4:])
        c64 = [a.double() for a in chain]
        ref = fw.fused_whiten_bwd_plain(*c64[:4], du.double(), dv.double(), *c64[4:])
        p32 = fw.fused_whiten_bwd_plain(*chain[:4], du, dv, *chain[4:])
    out["backward"] = {}
    for what, g, r, q in zip(("dlinv", "dvar", "dinvl", "de", "df"), got, ref, p32):
        scale = float(r.abs().max())
        out["backward"][what] = {
            "max_rel_err": float((g.double() - r).abs().max()) / scale,
            "plain_f32_max_rel_err": float((q.double() - r).abs().max()) / scale,
            "finite": bool(torch.isfinite(g).all())}
    out["ok"] = (out["grad_rel_norm"] <= out["tol"] and out["value_rel"] <= 1e-5
                 and all(n > 0 for n in out["launches"].values()))
    emit(out)
    assert out["ok"], f"the f32 gradient at the trained state misses f64: {out}"
    return out


def phase_fused_whiten(dev, sosp_model, full_model) -> dict:
    """Kernels A and B: (a) the prototypes' inputs at the SoSp width (222
    windows, N 2001, M 112, S 3, P 5, 16 kHz); (b) the AMT width (43
    windows, 44.1 kHz, M 160, 8 pitches from C4 x 10 harmonics); (c) an
    88-pitch dictionary (8 windows, M 160, S 88, P 20) against the f32
    plain version (and kernel A also against the f64 one); (d) the trained
    62- and 222-window SoSp banks' own bound, the launches counted over (d)
    alone; (e) the 16 windows of TRAINED_STATE, the f32 gradient against
    f64 (``_whiten_trained``); times at (a) and (b), and both kernels at
    each split of a window's tiles over blocks at (a), at 62 windows of
    (a)'s width, and at (b)."""
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
    _zero_all()
    for name, model in (("d_bank_62", sosp_model), ("d_bank_222", full_model)):
        cases[name] = _whiten_bank(name, model, dev)
    launches = _launches("fused_whiten", "fused_whiten_flat", "fused_whiten_bwd")
    emit({"phase": "fused_whiten", "case": "launches_in_d", "launches": launches})
    assert all(n > 0 for n in launches.values()), f"a kernel never ran: {launches}"
    cases["e_trained"] = _whiten_trained(dev)
    return {"cases": cases, "launches": launches}


# ------------------------------------------------------------------- HMC
# the kernels of a bank's bound and gradient (specmix builds predictions only)
_PATH = ("cholesky_batched", "fused_whiten", "fused_whiten_bwd")
HMC_MODGP = dict(num_chains=4, num_leapfrog=8, num_warmup=100, num_samples=100,
                 fit_steps=500)
HMC_BANK = dict(num_chains=4, num_leapfrog=8, num_warmup=20, num_samples=20)


def _split_rhat(x: np.ndarray) -> float:
    """Split R-hat of (chains, samples) draws (scripts/run_quality.py's)."""
    c, n = x.shape
    half = n // 2
    xs = np.concatenate([x[:, :half], x[:, half:2 * half]], 0)
    w = xs.var(axis=1, ddof=1).mean()
    b = half * xs.mean(axis=1).var(ddof=1)
    var = (half - 1) / half * w + b / half
    return float(np.sqrt(var / max(w, 1e-30)))


def hmc_runner(logprob, init, seed: int, **kw):
    """The ``HmcSteps`` that ``hmc_sample(logprob, init, generator, **kw)``
    runs, its noise drawn by a generator seeded ``seed`` on the card."""
    from gpitch_tpu_torch.models.hmc import hmc_steps
    dev = next(iter(init.values())).device
    return hmc_steps(logprob, init, torch.Generator(device=dev).manual_seed(seed), **kw)


def host_syncs(fn):
    """(fn(), the host reads it made): the CUDA calls that wait on the card
    (a copy to the host, a stream's synchronize), counted by torch's sync
    debug mode."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in seen)


def _hmc_turns(logprob, init, seed: int, turns, kw) -> tuple[dict, tuple]:
    """HMC on one route from one seed's noise, the sampler captured (C:
    each phase's graph replayed) and eager (E: its plain version) in
    ``turns``, each run building its ``HmcSteps`` (the captures included)
    and reading its samples and rates on the host once, at its end: ms a
    leapfrog step of each run; the first C's capture s, graph nodes by
    phase and the device memory it holds (reserved memory it added, the
    cache emptied) against the first E's peak (above what was allocated
    before it); the host reads inside the E runs' phases (torch's sync
    debug mode: none may fall there, so none is in the captured graphs);
    and the largest difference of every C's samples and rates from the
    first E's (0.0: the same arithmetic).  Returns (the record, the first
    C's (samples, rates) on the host).  The kernels' launches are read over
    each run."""
    gib = 2.0 ** 30
    leapfrog = (kw["num_warmup"] + kw["num_samples"]) * kw["num_leapfrog"]
    runs, rec = {"captured": [], "eager": []}, {}
    for how in turns:
        torch.cuda.synchronize()
        gc.collect()                  # an earlier runner's graphs (a reference cycle)
        torch.cuda.empty_cache()
        reserved, allocated = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _zero_all()
        t0 = time.perf_counter()
        runner = hmc_runner(logprob, init, seed, **kw)
        if how == "eager":
            (samples, rates), syncs = host_syncs(lambda: runner.run(eager=True))
            rec.setdefault("host_reads_inside_phases_eager", []).append(syncs)
        else:
            samples, rates = runner.run()
        host = ({k: v.double().cpu().numpy() for k, v in samples.items()},
                rates.double().cpu().numpy())
        seconds = time.perf_counter() - t0
        rec.setdefault("launches_by_run", []).append(_all_launches())
        if how == "eager" and not runs["eager"]:
            rec["peak_gib_eager"] = (torch.cuda.max_memory_allocated() - allocated) / gib
        if how == "captured" and not runs["captured"]:
            torch.cuda.empty_cache()
            rec["held_gib_captured"] = (torch.cuda.memory_reserved() - reserved) / gib
            rec["capture_s"] = runner.capture_s
            rec["nodes_by_phase"] = {k: p.nodes() for k, p in runner.phases.items()}
            rec["graphs"] = len(runner.phases)
        runs[how].append((seconds, host))
        del runner
    ref = runs["eager"][0][1]
    diff = max(max(float(np.abs(s[k] - ref[0][k]).max()) for k in ref[0])
               + float(np.abs(r - ref[1]).max()) for _, (s, r) in runs["captured"])
    rec.update({"turns": list(turns),
                "ms_per_leapfrog_step_captured": [t * 1e3 / leapfrog
                                                  for t, _ in runs["captured"]],
                "ms_per_leapfrog_step_eager": [t * 1e3 / leapfrog for t, _ in runs["eager"]],
                "captured_vs_eager_max_abs": diff, "host_reads_per_run": 1})
    rec["speedup"] = float(np.median(rec["ms_per_leapfrog_step_eager"])
                           / np.median(rec["ms_per_leapfrog_step_captured"]))
    return rec, runs["captured"][0][1]


def _hmc_targets(dev) -> dict:
    """tests/test_hmc_natgrad.py's two Gaussian targets in f32 on the card."""
    from gpitch_tpu_torch.models import hmc_sample
    f32 = torch.float32
    cov = torch.tensor([[1.0, 0.6], [0.6, 1.0]], dtype=f32, device=dev)
    prec, mean = torch.linalg.inv(cov), torch.tensor([1.0, -2.0], dtype=f32, device=dev)
    std, amean = (torch.tensor(v, dtype=f32, device=dev) for v in ([0.05, 20.0], [2.0, -30.0]))
    out = {}
    for name, fn, init, kw, seed in (
            ("correlated", lambda q: -0.5 * (((q["theta"] - mean) @ prec) * (q["theta"] - mean)).sum(-1),
             torch.zeros(2, dtype=f32, device=dev),
             dict(num_samples=1500, num_warmup=500, num_leapfrog=12, num_chains=4), 0),
            ("anisotropic", lambda q: -0.5 * ((q["theta"] - amean) / std).square().sum(-1),
             amean + torch.tensor([0.1, 5.0], dtype=f32, device=dev),
             dict(num_samples=800, num_warmup=400, num_leapfrog=12, num_chains=4,
                  jitter_init=0.01), 3)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samples, rates = hmc_sample(fn, {"theta": init},
                                    torch.Generator(device=dev).manual_seed(seed), **kw)
        th = samples["theta"].reshape(-1, 2).double().cpu().numpy()
        seconds = time.perf_counter() - t0
        rec = {"rates": rates.tolist(), "seconds": seconds,
               "ms_per_leapfrog_step": seconds * 1e3 / (
                   (kw["num_samples"] + kw["num_warmup"]) * kw["num_leapfrog"])}
        if name == "correlated":
            rec["mean_err"] = float(np.abs(th.mean(0) - [1.0, -2.0]).max())
            rec["cov_err"] = float(np.abs(np.cov(th.T) - [[1.0, 0.6], [0.6, 1.0]]).max())
            rec["ok"] = bool(min(rec["rates"]) > 0.5 and rec["mean_err"] <= 0.1
                             and rec["cov_err"] <= 0.2)
        else:
            rec["mean_err_sd"] = (np.abs(th.mean(0) - [2.0, -30.0]) / [0.05, 20.0]).tolist()
            rec["std_rel_err"] = (np.abs(th.std(0) / [0.05, 20.0] - 1)).tolist()
            rec["ok"] = bool(min(rec["rates"]) > 0.5 and max(rec["mean_err_sd"]) < 0.25
                             and max(rec["std_rel_err"]) <= 0.35)
        out[name] = rec
    return out


def make_hmc_modgp(dev):
    """scripts/run_quality.py's run_hmc model on the synthetic C4 note that
    demos/demo_modgp_real_audio.py falls back to (2 s at 16 kHz, 5 partials
    from the FFT, inducing points at the extrema, dec 9), fitted by
    HMC_MODGP["fit_steps"] minibatch Adam steps (lr 0.0025).  Returns (the
    fitted model, x, y)."""
    from gpitch_tpu_torch.audio import init_cparam, synth_piano_note
    from gpitch_tpu_torch.kernels import Matern32, MercerMatern12sm
    from gpitch_tpu_torch.models import ModGP, fit_adam_segmented, minibatch_fn
    from gpitch_tpu_torch.pipelines import init_liv
    fs, f0 = 16000, _f0(60)
    x, y = synth_piano_note(fs=fs, seconds=2.0, f0=f0)
    freqs, energies, _, _, _ = init_cparam(y, fs=fs, maxh=5, ideal_f0=f0)
    z, _ = init_liv(x=x, y=y, win_size=31, thres=0.05, dec=9)
    model = ModGP.create(z=z, kern=[[Matern32.create(variance=3.5, lengthscales=0.2)],
                                    [MercerMatern12sm.create(variance=1.0, lengthscales=0.5,
                                                             energy=energies,
                                                             frequency=freqs)]],
                         device=dev)
    xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
    yt = torch.as_tensor(y, dtype=torch.float32, device=dev)
    n = xt.shape[0]
    model, _, _, _ = fit_adam_segmented(
        model, lambda m, xb, yb: m.loss(xb, yb, num_data=n), HMC_MODGP["fit_steps"], 0.0025,
        minibatch_fn(xt, yt, 100, torch.Generator(device=dev).manual_seed(0)), segment=500)
    return model, xt, yt


def hmc_modgp_logprob(model, x, y):
    """run_hmc's log density: the full-data ELBO with the component
    kernel's lengthscale, variance, energies and frequencies substituted,
    plus N(init, max(10, 0.25 |init|)^2) priors on those raws.  Returns
    (logprob, init leaves)."""
    from gpitch_tpu_torch.core.params import named_params, with_raw
    paths = [f".kern_com.{k}" for k in ("lengthscales", "variance", "energy", "frequency")]
    raws = dict(named_params(model))
    init = {k: raws[k].raw.detach().clone() for k in paths}
    scale = {k: torch.clamp(0.25 * v.abs(), min=10.0) for k, v in init.items()}
    n = x.shape[0]

    def one(leaves):
        prior = -0.5 * sum(((leaves[k] - init[k]) / scale[k]).square().sum() for k in paths)
        return with_raw(model, leaves).elbo(x, y, n) + prior

    return torch.func.vmap(one), init


def _hmc_modgp(dev) -> tuple[dict, tuple]:
    from gpitch_tpu_torch.core.params import named_params
    t0 = time.perf_counter()
    model, x, y = make_hmc_modgp(dev)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    logprob, init = hmc_modgp_logprob(model, x, y)
    kw = {k: v for k, v in HMC_MODGP.items() if k != "fit_steps"}
    turns, (s, rates) = _hmc_turns(logprob, init, 2, ("captured", "eager", "captured"),
                                   dict(kw, jitter_init=0.05))
    s = {k.split(".")[-1]: v for k, v in s.items()}
    raws = {k.split(".")[-1]: p for k, p in named_params(model.kern_com)}
    vals = {k: raws[k].transform.forward(torch.as_tensor(v)).numpy().reshape(
        kw["num_chains"], kw["num_samples"], -1) for k, v in s.items()}
    prod = vals["variance"][..., :1] * vals["energy"]
    rhat = {"var_x_energy": [_split_rhat(prod[..., j]) for j in range(prod.shape[-1])],
            "lengthscale": [_split_rhat(vals["lengthscales"][..., j])
                            for j in range(vals["lengthscales"].shape[-1])],
            "frequency": [_split_rhat(vals["frequency"][..., j])
                          for j in range(vals["frequency"].shape[-1])]}
    rec = {"workload": "run_hmc on the synthetic C4 note (12 component-kernel raws)",
           "N": int(x.shape[0]), "M": int(model.za.raw.shape[1]), **kw,
           "fit_steps": HMC_MODGP["fit_steps"], "fit_s": fit_s,
           "ms_per_leapfrog_step": float(np.median(turns["ms_per_leapfrog_step_captured"])),
           **turns, "rates": rates.tolist(),
           "finite": bool(all(np.isfinite(v).all() for v in s.values())),
           "rhat_identified": rhat,
           "rhat_identified_max": max(max(v) for v in rhat.values())}
    return rec, (logprob, init)


HMC_BANK_STATE = os.path.join(ROOT, "tests", "torch_hmc_bank_state.npz")


def hmc_bank_start(bank):
    """(paths, init, chains) of HMC over a bank's kernel leaves: every
    window's trainable kernel leaves, their values, and the sampler's own
    start, init + 0.1 N(0, 1) per chain (a torch.Generator seeded 4 on the
    bank's device)."""
    from gpitch_tpu_torch.core.params import named_params
    paths = [k for k, p in named_params(bank) if p.trainable and k.startswith(".kern.")]
    init = {k: p.raw.detach().clone() for k, p in named_params(bank) if k in paths}
    dev = bank.Z.raw.device
    c = HMC_BANK["num_chains"]
    gen = torch.Generator(device=dev).manual_seed(4)
    chains = {k: v[None] + 0.1 * torch.randn((c,) + tuple(v.shape), generator=gen,
                                             device=dev) for k, v in init.items()}
    return paths, init, chains


def _chain_value_and_grad(fn, leaves):
    ls = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
    lp = fn(ls)
    grads = torch.autograd.grad(lp.sum(), list(ls.values()))
    return lp.detach().double(), [g.double() for g in grads]


def _chain_flat(grads, i):
    return torch.cat([g[i].reshape(-1) for g in grads])


def hmc_bank_arbiter(bank, chains):
    """The chains' log density and gradient in f64 with the f32 jitters (1e-4
    absolute, the M-aware 8e-7 M relative: linalg.ops.add_jitter), the
    arbiter of an f32 evaluation (on the card the unfused route: the pair
    is f32 only)."""
    from gpitch_tpu_torch.core.params import Param, map_params, with_raw
    from gpitch_tpu_torch.models import model_logprob_fn
    bank64 = map_params(bank, lambda p: Param(p.raw.detach().double(), p.transform,
                                              p.trainable))
    with f32_jitters(bank.Z.raw.shape[1]):
        return _chain_value_and_grad(model_logprob_fn(bank64, with_raw, prior_scale=1e3),
                                     {k: v.double() for k, v in chains.items()})


def hmc_bank_check(bank, chains, arbiter=None) -> dict:
    """At the chains' start: the f32 log density folded (the C chains in the
    window axis, one evaluation of C nw windows) against one chain at a
    time, and both against ``hmc_bank_arbiter`` (relative value, relative
    norm of the gradient, the largest over chains)."""
    from gpitch_tpu_torch.core.params import with_raw
    from gpitch_tpu_torch.models import model_logprob_fn
    paths = list(chains)
    logprob = model_logprob_fn(bank, with_raw, prior_scale=1e3)
    lp, grads = _chain_value_and_grad(logprob, chains)
    lp64, grads64 = arbiter or hmc_bank_arbiter(bank, chains)
    check = {"value_rel": 0.0, "grad_rel_norm": 0.0, "grad_rel_per_leaf": {},
             "f64_value_rel_folded": 0.0, "f64_value_rel_one": 0.0,
             "f64_grad_rel_norm_folded": 0.0, "f64_grad_rel_norm_one": 0.0}
    for i in range(next(iter(chains.values())).shape[0]):
        lp1, g1 = _chain_value_and_grad(logprob, {k: v[i:i + 1] for k, v in chains.items()})
        check["value_rel"] = max(check["value_rel"], float(abs(lp[i] / lp1[0] - 1)))
        ref, one, f64 = _chain_flat(g1, 0), _chain_flat(grads, i), _chain_flat(grads64, i)
        check["grad_rel_norm"] = max(check["grad_rel_norm"],
                                     float((one - ref).norm() / ref.norm()))
        for k, g, h in zip(paths, grads, g1):
            check["grad_rel_per_leaf"][k] = max(
                check["grad_rel_per_leaf"].get(k, 0.0),
                float((g[i] - h[0]).abs().max() / h[0].abs().max()))
        for key, val, gv in (("folded", lp[i], one), ("one", lp1[0], ref)):
            check[f"f64_value_rel_{key}"] = max(check[f"f64_value_rel_{key}"],
                                                float(abs(val / lp64[i] - 1)))
            check[f"f64_grad_rel_norm_{key}"] = max(check[f"f64_grad_rel_norm_{key}"],
                                                    float((gv - f64).norm() / f64.norm()))
    return check


# the f32 parts of the fused bound, each of which ``f64_parts`` can swap
F32_PARTS = ("kuu", "chol", "fwd", "bwd", "finish")


def _fused_whiten_module():
    """gpitch_tpu_torch.linalg.fused_whiten, the module (the package exports
    a function of the same name)."""
    import importlib
    return importlib.import_module("gpitch_tpu_torch.linalg.fused_whiten")


class _PairInParts(torch.autograd.Function):
    """fused_whiten with its forward and its backward each in f32 (kernels A
    and B on the card, their plain versions on the CPU) or in f64 (the plain
    versions on f64 copies, rounded once to f32)."""

    @staticmethod
    def forward(ctx, fwd64, bwd64, *args):
        fw = _fused_whiten_module()
        ctx.save_for_backward(*args)
        ctx.bwd64 = bwd64
        if fwd64:
            return tuple(t.float() for t in fw.fused_whiten_plain(*(a.double() for a in args)))
        return fw.fused_whiten(*args)

    @staticmethod
    def backward(ctx, du, dv):
        fw = _fused_whiten_module()
        zc, xc, err, linv, energy, freq, var, inv_l = ctx.saved_tensors
        args = (zc, xc, err, linv, du.contiguous(), dv.contiguous(), energy, freq, var, inv_l)
        if ctx.bwd64:
            outs = [t.float() for t in fw.fused_whiten_bwd_plain(*(a.double() for a in args))]
        else:
            outs = fw.fused_whiten_bwd(*args)
        dlinv, dvar, dinvl, de, df = outs
        fold = (lambda g: g.sum(0)) if energy.dim() == 2 else (lambda g: g)
        return (None, None, None, None, None, dlinv, fold(de), fold(df), fold(dvar[:, 0]),
                fold(dinvl[:, 0]))


@contextlib.contextmanager
def f64_parts(parts):
    """Within it, the named parts of an f32 bank's fused bound run in f64,
    their results rounded once to f32 (their gradients flow back in f64;
    a bank of another dtype is left as it is): ``kuu`` the StackedSum's Kuu, ``chol`` the factor and inverse of the
    jittered Kuu (linalg.ops.chol_inv), ``fwd`` and ``bwd`` the fused
    pair's forward (Kuf, U, v) and backward, ``finish`` the bound's tail
    from AAT and Aerr (SGPR._finish: B's factors and c; the bound is then
    summed in f64)."""
    from gpitch_tpu_torch.core.params import Param, map_params
    from gpitch_tpu_torch.linalg.ops import add_jitter, chol_inv
    from gpitch_tpu_torch.models import sgpr
    unknown = set(parts) - set(F32_PARTS)
    if unknown:
        raise ValueError(f"unknown parts {sorted(unknown)}")
    cls = sgpr.SGPR
    saved = (cls.fused_whiten_args, cls._linv, sgpr.fused_whiten, cls.__dict__["_finish"])

    def args_kuu64(self):
        args = list(saved[0](self))
        z = self.Z.value
        if z.dtype != torch.float32:
            return tuple(args)
        m = z.shape[-2]
        kern64 = map_params(self.kern, lambda p: Param.wrap(p.raw.double(), p.transform,
                                                            p.trainable))
        args[3] = self._linv(kern64.K(z.double()).float()).reshape(-1, m, m)
        return tuple(args)

    def linv64(self, kuu):
        if kuu.dtype != torch.float32:
            return saved[1](self, kuu)
        kj = add_jitter(kuu, self.numerics.jitter_value(kuu.dtype))
        return chol_inv(kj.double())[1].to(kuu.dtype)

    if "kuu" in parts:
        cls.fused_whiten_args = args_kuu64
    if "chol" in parts:
        cls._linv = linv64
    if "finish" in parts:
        cls._finish = staticmethod(lambda aat, aerr, sigma2: saved[3].__func__(
            aat.double(), aerr.double(), sigma2.double()))
    if "fwd" in parts or "bwd" in parts:
        sgpr.fused_whiten = lambda *a: (
            _PairInParts.apply("fwd" in parts, "bwd" in parts, *a)
            if a[0].dtype == torch.float32 else saved[2](*a))
    try:
        yield
    finally:
        cls.fused_whiten_args, cls._linv, sgpr.fused_whiten, cls._finish = saved


def hmc_bank_parts(bank, chains) -> dict:
    """Each f32 part's share of the f32 gradient's error at the chains'
    start (``hmc_bank_check``'s f64_grad_rel_norm, folded and one chain):
    every part in f32, each part (and the pair's forward and backward
    together) alone in f64, each of Kuu, its factor, the pair and the tail
    alone in f32 (the others in f64), and every part in f64 (what is left:
    the rest of the bound in f32: the kernel's parameters, Kdiag, the
    prior)."""
    arbiter = hmc_bank_arbiter(bank, chains)
    # the pair's forward and backward share the f32 features (angles of ~6e3
    # rad) and their errors: each is also swapped with the other
    units = {"kuu": ("kuu",), "chol": ("chol",), "pair": ("fwd", "bwd"),
             "finish": ("finish",)}
    configs = {"all_f32": ()}
    configs.update({f"{p}_in_f64": (p,) for p in F32_PARTS})
    configs["pair_in_f64"] = units["pair"]
    configs.update({f"only_{u}_in_f32": tuple(q for q in F32_PARTS if q not in parts)
                    for u, parts in units.items()})
    configs["all_parts_in_f64"] = F32_PARTS
    out = {}
    for name, parts in configs.items():
        with f64_parts(parts):
            chk = hmc_bank_check(bank, chains, arbiter)
        out[name] = {"folded": chk["f64_grad_rel_norm_folded"],
                     "one": chk["f64_grad_rel_norm_one"]}
    return out


def saved_hmc_bank(device, dtype=torch.float32):
    """(the 16 sosp-4s windows at the state saved in HMC_BANK_STATE, in
    ``dtype`` on ``device``, the chains' start, the state file)."""
    from gpitch_tpu_torch.core.params import Param, map_params, named_params, take_windows
    state = np.load(HMC_BANK_STATE)
    model, _ = make_sosp(4.0, device, torch.float32)
    bank = take_windows(model.bank, slice(0, TRAINED_WINDOWS))
    for key, prm in named_params(bank):
        if key in state.files:
            with torch.no_grad():
                prm.raw.copy_(torch.as_tensor(state[key]))
    if dtype != torch.float32:
        bank = map_params(bank, lambda p: Param(p.raw.detach().to(dtype), p.transform,
                                                p.trainable))
    chains = {k[len("chain"):]: torch.as_tensor(state[k], dtype=dtype, device=device)
              for k in state.files if k.startswith("chain")}
    return bank, chains, state


def check_saved_hmc_bank() -> dict:
    """On the card: ``hmc_bank_check`` and ``hmc_bank_parts`` at the saved
    state (the parent tree's own L-BFGS state on the card), emitted."""
    bank, chains, _ = saved_hmc_bank(torch.device("cuda"))
    rec = {"phase": "hmc_bank_saved_state", "check": hmc_bank_check(bank, chains),
           "parts": hmc_bank_parts(bank, chains)}
    emit(rec)
    return rec


def write_hmc_bank_state(path: str) -> dict:
    """On the card: the 16 sosp-4s windows after lbfgs (a)'s 30 f32 L-BFGS
    iterations and the 4 chains' start of hmc (c), saved to ``path``: every
    raw leaf of the bank but X and Y (their sums instead), and the chains
    (``chain`` + path).  Emits the card's check and part shares there."""
    from gpitch_tpu_torch.core.params import named_params, take_windows
    from gpitch_tpu_torch.pipelines.windowed_sgpr import optimize_bank
    dev = torch.device("cuda")
    nwin, iters = np.load(LBFGS_GOLDENS)["sosp16_window_losses"].shape
    model, _ = make_sosp(4.0, dev, torch.float32)
    sub = take_windows(model.bank, slice(0, nwin))
    bank, losses, _ = optimize_bank(sub, iters, method="lbfgs", return_info=True)
    _, _, chains = hmc_bank_start(bank)
    state = {}
    for k, p in named_params(bank):
        raw = p.raw.detach().cpu().numpy()
        if k in (".X", ".Y"):
            state[f"sum{k}"] = np.array([raw.astype(np.float64).sum(),
                                         np.square(raw.astype(np.float64)).sum()])
        else:
            state[k] = raw
    state.update({f"chain{k}": v.cpu().numpy() for k, v in chains.items()})
    np.savez(path, **state)
    rec = {"phase": "hmc_bank_state", "path": path, "windows": nwin, "iterations": iters,
           "loss0": float(losses[0]), "loss_last": float(losses[-1]),
           "check": hmc_bank_check(bank, chains), "parts": hmc_bank_parts(bank, chains)}
    emit(rec)
    return rec


def _hmc_bank(dev, bank) -> tuple[dict, tuple]:
    """HMC over every window's trainable kernel leaves of a trained bank
    (the noise fixed), the chains folded into the window axis, captured
    against eager in turns (C E E C; ``launches``: the kernels' over the
    first C).  The folded log density and gradient against one chain at a
    time, and both against the same evaluation in f64
    (``hmc_bank_check``).  Returns (the record, (log density, init))."""
    from gpitch_tpu_torch.core.params import with_raw
    from gpitch_tpu_torch.models import model_logprob_fn
    paths, init, chains = hmc_bank_start(bank)
    logprob = model_logprob_fn(bank, with_raw, prior_scale=1e3)
    check = hmc_bank_check(bank, chains)
    turns, (samples, rates) = _hmc_turns(logprob, init, 5,
                                         ("captured", "eager", "eager", "captured"), HMC_BANK)
    return {"windows": int(bank.X.raw.shape[0]),
            "folded_windows": HMC_BANK["num_chains"] * int(bank.X.raw.shape[0]),
            "leaves": paths, "dims_per_chain": int(sum(v.numel() for v in init.values())),
            **HMC_BANK, "folded_vs_one_chain": check,
            "ms_per_leapfrog_step": float(np.median(turns["ms_per_leapfrog_step_captured"])),
            **turns, "rates": rates.tolist(),
            "finite": bool(all(np.isfinite(v).all() for v in samples.values())),
            "launches": turns["launches_by_run"][0]}, (logprob, init)


def phase_hmc(dev, bank):
    """HMC on the card: (a) the JAX package's two Gaussian targets in f32 at
    its thresholds; (b) ModGP: run_hmc's 12 component-kernel raws of the
    Adam-fitted synthetic C4 note, 4 chains, 8 leapfrog steps, 100 + 100
    iterations (every sample finite, every rate > 0.2; split R-hat of the
    identified quantities); (c) the 16 trained sosp-4s windows of lbfgs (a):
    every window's kernel leaves, 4 chains folded into the window axis (64
    windows through the Cholesky kernel and kernels A and B), 8 leapfrog
    steps, 20 + 20 iterations (every sample finite; at the chains' start the
    folded log density within 1e-5 of one chain at a time, and its gradient
    no further from the same evaluation in f64, with the f32 jitters, than
    twice one chain's, and within 2e-4).  (b) and (c) run ``HmcSteps``
    captured (each phase one graph, replayed) against its eager plain
    version in turns (``_hmc_turns``): equal samples and rates (0.0), no
    host read inside a phase, and on (c) the Cholesky kernel and kernels A
    and B launched.  Returns (the records, (b)'s and (c)'s log density and
    init for the profile)."""
    out = {"phase": "hmc", "targets": _hmc_targets(dev)}
    out["modgp"], modgp = _hmc_modgp(dev)
    out["bank"], bank_fn = _hmc_bank(dev, bank)
    emit(out)
    for name, rec in out["targets"].items():
        assert rec["ok"], f"HMC missed the {name} target: {rec}"
    m, b = out["modgp"], out["bank"]
    assert m["finite"] and min(m["rates"]) > 0.2, m
    assert b["finite"], b
    chk = b["folded_vs_one_chain"]
    assert chk["value_rel"] <= 1e-5, b
    # the gradients of a trained bank in f32 differ by the kernels' plans
    # (the splits follow the window count) far above 1e-5: the folded one
    # is held to the f64 arbiter as closely as one chain alone is, and both
    # within 2e-4 (docs/F32_ACCURACY.md:57)
    assert chk["f64_grad_rel_norm_folded"] <= 2 * chk["f64_grad_rel_norm_one"] + 1e-5, b
    assert max(chk["f64_grad_rel_norm_folded"], chk["f64_grad_rel_norm_one"]) <= 2e-4, b
    assert all(b["launches"][k] > 0 for k in _PATH), f"a kernel never ran: {b['launches']}"
    for r in (m, b):
        assert r["captured_vs_eager_max_abs"] == 0.0, r
        assert not any(r["host_reads_inside_phases_eager"]), r
    return out, (modgp, bank_fn)


def _hmc_windows(name: str, logprob, init, iterations: int, kw) -> list:
    """The profile's windows of ``iterations`` HMC sampling iterations (no
    warm-up): replays of a captured iteration (the sampler's eager
    iteration and capture run before the window) and eager iterations."""
    runners = [hmc_runner(logprob, init, 9, num_samples=iterations + 2, num_warmup=0,
                          jitter_init=0.05, **kw) for _ in range(2)]
    for r in runners:
        r.begin("adapt")
        r.end("adapt", 0)
        r.begin("sample")
    runners[0].phases["sample"].run(2)
    torch.cuda.synchronize()
    counts = {"iterations": iterations, "leapfrog_steps": iterations * kw["num_leapfrog"]}
    label = f"{iterations} %s HMC iterations ({name}, {kw['num_chains']} chains, " \
            f"{kw['num_leapfrog']} leapfrog steps)"
    return [(label % "captured", lambda: runners[0].phases["sample"].run(iterations) or counts),
            (label % "eager", lambda: runners[1].phases["sample"].eager(iterations) or counts)]


# ---------------------------------------------------------- distribution
DIST_TIMEOUT_S = 300


def _run_workers(kind: str, world: int, extra=()) -> list[dict]:
    """``world`` worker processes of this script (``--worker``), joined
    through a file store in a fresh temporary directory; each prints one
    JSON line.  Any failure or timeout raises."""
    import tempfile
    d = tempfile.mkdtemp(prefix="gpitch_dist_")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", kind,
                               str(rank), str(world), os.path.join(d, "store"), *extra],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=ROOT) for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DIST_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (so, se) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"worker {kind} failed ({p.returncode}):\n{se[-4000:]}")
    return [json.loads(so.strip().splitlines()[-1]) for so, _ in outs]


def _rows_of(bank) -> np.ndarray:
    from gpitch_tpu_torch.core.params import trainable_tensors
    leaves = trainable_tensors(bank)
    nw = leaves[0].shape[0]
    return torch.cat([t.detach().reshape(nw, -1) for t in leaves], 1).double().cpu().numpy()


# fit_modgp's methods on the source-sharded ModGP (``make_modgp_sharded``),
# on the ranks and in one process; L-BFGS raises over gloo on the card
MODGP_SHARDED = {
    "adam": dict(method="adam", num_steps=100, learning_rate=0.005, minibatch_size=100),
    "natgrad_adam": dict(method="natgrad_adam", num_steps=50, learning_rate=0.005,
                         minibatch_size=100),
    "lbfgs": dict(method="lbfgs", num_steps=10, minibatch_size=None)}


def make_modgp_sharded(dev):
    """bench.py's workload (N 16000, M 128 taken evenly from the extrema,
    noise variance 1e-3) with two sources, so that they split over two
    ranks: each a Matern32 activation and a 3-partial MercerMatern12sm
    component, the first's partials at 15/30/45 Hz (bench.py's), the
    second's at 20/40/60.  Returns (model, x, y) in f32."""
    from gpitch_tpu_torch.kernels import Matern32, MercerMatern12sm
    from gpitch_tpu_torch.models import ModGP
    one, x, y, _ = make_modgp_demo(dev, num_inducing=128, noise=1e-3)
    z = one.za.raw[0].detach().cpu().numpy()
    model = ModGP.create(z=[[z, z], [z, z]],
                         kern=[[Matern32.create(1.0, 1.0) for _ in range(2)],
                               [MercerMatern12sm.create(energy=[1.0] * 3, frequency=f)
                                for f in ([15.0, 30.0, 45.0], [20.0, 40.0, 60.0])]],
                         device=dev)
    return (model, torch.as_tensor(x, dtype=torch.float32, device=dev),
            torch.as_tensor(y, dtype=torch.float32, device=dev))


def _modgp_leaves(model, group=None) -> dict:
    """Every raw leaf of a ModGP as f64 numpy; with ``group`` (its sources
    split over the ranks) the per-source leaves gathered in rank order and
    the replicated ones (the likelihood's) as this rank holds them."""
    from gpitch_tpu_torch.core.params import named_params
    from gpitch_tpu_torch.parallel.mesh import gather_rows
    out = {}
    for n, p in named_params(model):
        raw = p.raw.detach()
        if group is not None and not n.startswith(".likelihood."):
            raw = gather_rows(raw.reshape(raw.shape[0], -1), group).reshape(
                (-1,) + raw.shape[1:])
        out[n] = raw.double().cpu().numpy()
    return out


def fit_sharded_modgp(dev, mesh, prefix: str, rank: int) -> dict:
    """fit_modgp on this rank's share of ``make_modgp_sharded``'s sources,
    each method of MODGP_SHARDED (the minibatch generator seeded 0 on
    every rank, as in one process), each fit twice: ms a step of the
    second (its warm-up and capture included) and of the first (the
    process's first use too), the graphs the second captured, their
    replays and host points, the kernels' launches.  Over gloo on the card
    L-BFGS must raise ValueError at the start.  Rank 0 writes the losses
    and the gathered leaves to ``prefix``.modgp.npz."""
    from gpitch_tpu_torch.linalg import _cuda
    from gpitch_tpu_torch.models import fit_modgp
    from gpitch_tpu_torch.parallel import shard_modgp_sources
    from gpitch_tpu_torch.parallel.mesh import on_host
    model, x, y = make_modgp_sharded(dev)
    local, _ = shard_modgp_sources(model, mesh)
    group = local.source_group
    assert group is not None, "the sources did not split"
    out, arrays = {"sources_on_this_rank": local.num_sources}, {}
    for name, kw in MODGP_SHARDED.items():
        if name == "lbfgs" and on_host(group):
            try:
                fit_modgp(local, x, y, **kw)
            except ValueError as e:
                out[name] = {"raises_value_error": str(e)}
                continue
            raise AssertionError("L-BFGS over gloo ranks on the card did not raise")
        seconds = []
        for _ in range(2):
            _zero_all()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fitted, losses = fit_modgp(
                local, x, y, generator=torch.Generator(device=dev).manual_seed(0), **kw)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        g = _cuda.GRAPHS
        out[name] = {"steps": kw["num_steps"],
                     "ms_per_step": seconds[1] * 1e3 / kw["num_steps"],
                     "first_fit_ms_per_step": seconds[0] * 1e3 / kw["num_steps"],
                     "graphs_captured": g["graphs"], "replays": g["replays"],
                     "host_points_per_step": g["host_points"] / max(g["graphs"], 1),
                     "launches": _all_launches()}
        arrays[name + "_losses"] = np.asarray(losses, dtype=np.float64)
        arrays.update({name + n: v for n, v in _modgp_leaves(fitted, group).items()})
    if rank == 0:
        np.savez(prefix + ".modgp.npz", **arrays)
    return out


def _worker(kind: str, rank: int, world: int, store: str, *extra) -> dict:
    """One rank of the distributed or resume phase (see there)."""
    from gpitch_tpu_torch.linalg import _cuda
    from gpitch_tpu_torch.parallel import (init_multihost, make_bank_loss_shard_map,
                                           make_mesh)
    from gpitch_tpu_torch.pipelines.windowed_sgpr import bank_loss, optimize_bank
    dev = torch.device("cuda")
    rebuilt = _cuda.build()                    # the parent built them: nothing to do
    out = {"rank": rank, "rebuilt": rebuilt}
    if kind == "resume":
        from gpitch_tpu_torch.pipelines import optimize_bank_resumable
        model, _ = make_sosp(4.0, dev, torch.float32)
        _zero_all()
        bank, losses, start = optimize_bank_resumable(model.bank, 30, extra[0], 10)
        torch.cuda.synchronize()
        np.savez(extra[1], losses=losses, rows=_rows_of(bank))
        return {**out, "start": start, "launches": _all_launches()}
    backend = "nccl" if kind == "nccl" else "gloo"
    assert init_multihost(f"file://{store}", world, rank, backend=backend, timeout_s=120)
    mesh = make_mesh(world)
    if kind == "nccl":
        from gpitch_tpu_torch.core.params import named_params
        model, _ = make_sosp(4.0, dev, torch.float32)
        leaves = [p.raw for _, p in named_params(model.bank) if p.trainable]
        loss = make_bank_loss_shard_map(mesh)(model.bank)
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
        ref = bank_loss(model.bank)
        r = torch.autograd.grad(ref, leaves, allow_unused=True)
        out["loss_rel"] = float(abs(loss.item() / ref.item() - 1))
        out["grad_rel"] = max(float((a - b).abs().max() / b.abs().max())
                              for a, b in zip(g, r) if b is not None)
        mb, ml = optimize_bank(model.bank, 5, 0.01, mesh=mesh)
        lb, ll = optimize_bank(model.bank, 5, 0.01)
        out["steps_loss_rel"] = float(np.max(np.abs(ml / ll - 1)))
        out["steps_leaf_max_diff"] = float(np.abs(_rows_of(mb) - _rows_of(lb)).max())
        del model
        out["modgp_sources"] = fit_sharded_modgp(dev, mesh, extra[0], rank)
    else:
        model, _ = _sosp14s(dev)
        model.optimize(maxiter=2, learning_rate=0.01, mesh=mesh)       # the full phase's warm-up
        _zero_all()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = model.optimize(maxiter=20, learning_rate=0.01, mesh=mesh)
        torch.cuda.synchronize()
        out["ms_per_bank_step"] = (time.perf_counter() - t0) / 20 * 1e3
        out["launches"] = _all_launches()
        out["rank_windows"] = list(model.opt_info["rank_windows"])
        np.savez(extra[0] + f".{rank}.npz", losses=losses, rows=_rows_of(model.bank))
        from gpitch_tpu_torch.core.params import take_windows
        sub, _ = make_sosp(4.0, dev, torch.float32)
        sub = take_windows(sub.bank, slice(0, 16))
        t0 = time.perf_counter()
        _, lb_losses = optimize_bank(sub, 10, method="lbfgs", mesh=mesh)
        torch.cuda.synchronize()
        out["lbfgs_s"] = time.perf_counter() - t0
        out["lbfgs_losses"] = lb_losses.tolist()
        del sub
        out["modgp_sources"] = fit_sharded_modgp(dev, mesh, extra[0] + ".sources", rank)
    import torch.distributed as dist
    dist.destroy_process_group()
    return out


def phase_distributed(dev, full_losses, full_rows) -> dict:
    """Window-parallel distribution on the card: (a) a one-rank NCCL group
    in a fresh process: on the sosp-4s bank, make_bank_loss_shard_map
    against bank_loss (value and gradient) and optimize_bank(mesh=, 5
    steps) against no mesh; (b) two processes on the one card (gloo, which
    NCCL refuses): sosp-14s (222 windows, 111 a rank), SoSp.optimize(
    maxiter=2, then 20, mesh=) against the full phase's single-process 2 +
    20 steps: the per-step totals within 1e-5 relative, the largest
    per-window leaf difference, ms a step, each rank's launches; (c) per-
    window L-BFGS on the 16 sosp-4s windows, 10 iterations, the two ranks
    against one process in chunks of a rank's 8 windows within 1e-5 (and,
    reported, unchunked: the kernels' split plans follow the window count,
    and L-BFGS's linesearch turns f32 rounding into other trial steps);
    (d) fit_modgp on ``make_modgp_sharded``'s two sources split over the
    ranks of (a) and (b) (``fit_sharded_modgp``) against one process
    (``_sharded_modgp_vs_one_process``): every fit captured, losses within
    1e-5, gloo's L-BFGS a ValueError.  The workers load the kernels the
    parent built (no nvcc run)."""
    import tempfile

    from gpitch_tpu_torch.core.params import take_windows
    from gpitch_tpu_torch.pipelines.windowed_sgpr import optimize_bank
    prefix = os.path.join(tempfile.mkdtemp(prefix="gpitch_dist_out_"), "rank")
    t0 = time.perf_counter()
    (one,) = _run_workers("nccl", 1, (prefix + ".nccl",))
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = _run_workers("gloo", 2, (prefix,))
    two_s = time.perf_counter() - t0
    got = [np.load(prefix + f".{r}.npz") for r in range(2)]
    loss_rel = max(float(np.max(np.abs(g["losses"] / full_losses - 1))) for g in got)
    rows = _rows_of_dict(full_rows)
    leaf_diff = max(float(np.abs(g["rows"] - rows).max()) for g in got)
    model, _ = make_sosp(4.0, dev, torch.float32)
    sub = take_windows(model.bank, slice(0, 16))
    del model
    # one process in chunks of a rank's 8 windows: the batches the ranks run,
    # so the kernels' plans (splits of a window's tiles over blocks, which
    # follow the window count) are theirs; and unchunked
    _, ref = optimize_bank(sub, 10, method="lbfgs", window_chunk=8)
    _, whole = optimize_bank(sub, 10, method="lbfgs")
    got = np.asarray(ranks[0]["lbfgs_losses"])
    lbfgs_rel = float(np.max(np.abs(got / ref - 1)))
    whole_rel = float(np.max(np.abs(got / whole - 1)))
    modgp = _sharded_modgp_vs_one_process(dev, {"one_rank_nccl": (one, prefix + ".nccl"),
                                               "two_ranks_gloo": (ranks, prefix + ".sources")})
    out = {"phase": "distributed",
           "a_one_rank_nccl": {**one, "process_s": one_s},
           "b_two_ranks_gloo_sosp14s": {
               "windows": ranks[-1]["rank_windows"][1], "loss_rel_vs_one_process": loss_rel,
               "leaf_max_abs_diff_vs_one_process": leaf_diff,
               "ms_per_bank_step": [r["ms_per_bank_step"] for r in ranks],
               "launches_per_rank": [r["launches"] for r in ranks],
               "rank_windows": [r["rank_windows"] for r in ranks],
               "rebuilt": [r["rebuilt"] for r in ranks], "processes_s": two_s},
           "c_lbfgs_two_ranks": {"windows": 16, "iterations": 10,
                                 "loss_rel_vs_one_process_chunks_of_8": lbfgs_rel,
                                 "loss_rel_vs_one_process_unchunked": whole_rel,
                                 "ranks_equal": bool(all(r["lbfgs_losses"] == ranks[0][
                                     "lbfgs_losses"] for r in ranks)),
                                 "seconds": [r["lbfgs_s"] for r in ranks]},
           "d_modgp_sources": modgp}
    emit(out)
    assert not one["rebuilt"] and not any(r["rebuilt"] for r in ranks), "a worker ran nvcc"
    assert one["loss_rel"] <= 1e-6 and one["grad_rel"] <= 1e-5, one
    assert one["steps_loss_rel"] <= 1e-6, one
    assert loss_rel <= 1e-5, out["b_two_ranks_gloo_sosp14s"]
    assert all(r["launches"][k] > 0 for r in ranks for k in _PATH), "a kernel never ran"
    assert lbfgs_rel <= 1e-5 and out["c_lbfgs_two_ranks"]["ranks_equal"], \
        out["c_lbfgs_two_ranks"]
    for route, rec in modgp.items():
        for name, r in rec["fits"].items():
            if "raises_value_error" in r:
                assert route == "two_ranks_gloo" and name == "lbfgs", (route, name, r)
                continue
            assert r["loss_rel_vs_one_process"] <= 1e-5, (route, name, r)
            assert all(g >= 1 for g in r["graphs_captured"]), (route, name, r)
    return out


def _sharded_modgp_vs_one_process(dev, routes: dict) -> dict:
    """Each route's source-sharded fits (``fit_sharded_modgp``) against
    fit_modgp in this process on the whole model: the largest loss
    difference over max|loss| (<= 1e-5), the largest leaf difference over
    the leaf's max (reported), and each rank's ms a step, graphs, replays,
    host points a step and launches."""
    from gpitch_tpu_torch.models import fit_modgp
    model, x, y = make_modgp_sharded(dev)
    ref = {}
    for name, kw in MODGP_SHARDED.items():
        fitted, losses = fit_modgp(model, x, y,
                                   generator=torch.Generator(device=dev).manual_seed(0), **kw)
        ref[name] = (np.asarray(losses, dtype=np.float64), _modgp_leaves(fitted))
    out = {}
    for route, (ranks, prefix) in routes.items():
        ranks = ranks if isinstance(ranks, list) else [ranks]
        got = dict(np.load(prefix + ".modgp.npz"))
        fits = {}
        for name in MODGP_SHARDED:
            per = [r["modgp_sources"][name] for r in ranks]
            if "raises_value_error" in per[0]:
                fits[name] = per[0]
                continue
            losses, leaves = ref[name]
            fits[name] = {
                "loss_rel_vs_one_process": float(np.max(np.abs(got[name + "_losses"] - losses))
                                                 / np.max(np.abs(losses))),
                "leaf_rel_vs_one_process": max(float(np.max(np.abs(got[name + n] - v))
                                                     / max(np.max(np.abs(v)), 1e-30))
                                               for n, v in leaves.items()),
                **{k: [p[k] for p in per] for k in ("ms_per_step", "first_fit_ms_per_step",
                                                      "graphs_captured", "replays",
                                                      "host_points_per_step", "launches")}}
        out[route] = {"ranks": len(ranks), "fits": fits}
    return out


def _rows_of_dict(rows: dict) -> np.ndarray:
    nw = next(iter(rows.values())).shape[0]
    return np.concatenate([v.reshape(nw, -1).astype(np.float64) for v in rows.values()], 1)


# ------------------------------------------------------------- resume
def _resume_pair(bank, tmp: str) -> dict:
    """optimize_bank_resumable: 30 steps in one call, against 20 and then a
    resumed call to 30 in this process; the largest differences."""
    from gpitch_tpu_torch.pipelines import optimize_bank_resumable
    b_full, l_full, _ = optimize_bank_resumable(bank, 30, os.path.join(tmp, "full"), 10)
    _, l_a, _ = optimize_bank_resumable(bank, 20, os.path.join(tmp, "part"), 10)
    b_res, l_b, start = optimize_bank_resumable(bank, 30, os.path.join(tmp, "part"), 10)
    return {"start": start,
            "loss_max_abs_diff": float(np.abs(np.concatenate([l_a, l_b]) - l_full).max()),
            "leaf_max_abs_diff": float(np.abs(_rows_of(b_res) - _rows_of(b_full)).max())}


def phase_resume(dev, table_bank) -> dict:
    """optimize_bank_resumable on the card: the sosp-4s bank (the fused
    route) 30 steps in one call, against 20 steps and a resume to 30 in a
    fresh process: losses and every raw leaf bit for bit.  Reported: the
    same comparison on the first 64 windows of amt-10s's lag-table bank
    (its gather's backward is a scatter-add with atomics) in this process,
    and the (bank, Adam state) checkpoint's size and write/read ms."""
    import tempfile

    from gpitch_tpu_torch.core.params import take_windows, trainable_tensors
    from gpitch_tpu_torch.pipelines import optimize_bank_resumable
    from gpitch_tpu_torch.utils.checkpoint import load_model, save_model
    tmp = tempfile.mkdtemp(prefix="gpitch_resume_")
    model, _ = make_sosp(4.0, dev, torch.float32)
    _zero_all()
    b_full, l_full, _ = optimize_bank_resumable(model.bank, 30, os.path.join(tmp, "full"), 10)
    part = os.path.join(tmp, "part")
    _, l_a, _ = optimize_bank_resumable(model.bank, 20, part, 10)
    torch.cuda.synchronize()
    launches = _all_launches()
    (w,) = _run_workers("resume", 1, (part, os.path.join(tmp, "resumed.npz")))
    got = np.load(os.path.join(tmp, "resumed.npz"))
    launches = {k: v + w["launches"][k] for k, v in launches.items()}
    fused = {"start": w["start"],
             "losses_equal": bool(np.array_equal(np.concatenate([l_a, got["losses"]]), l_full)),
             "leaves_equal": bool(np.array_equal(got["rows"], _rows_of(b_full))),
             "launches": launches}
    table = _resume_pair(take_windows(table_bank, slice(0, 64)), os.path.join(tmp, "table"))
    state = (b_full, {"m": tuple(torch.zeros_like(t) for t in trainable_tensors(b_full)),
                      "v": tuple(torch.zeros_like(t) for t in trainable_tensors(b_full)),
                      "t": 30})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_model(os.path.join(tmp, "timed"), state, step=1)
    write_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    load_model(os.path.join(tmp, "timed"), state, step=1)
    torch.cuda.synchronize()
    read_ms = (time.perf_counter() - t0) * 1e3
    out = {"phase": "resume", "a_sosp4s_fused": fused,
           "b_amt10s_table_64": {**table, "windows": 64},
           "checkpoint": {"bytes": os.path.getsize(os.path.join(tmp, "timed", "1.npz")),
                          "write_ms": write_ms, "read_ms": read_ms, "windows": 62}}
    emit(out)
    assert fused["start"] == 20 and fused["losses_equal"] and fused["leaves_equal"], fused
    assert all(launches[k] > 0 for k in _PATH), f"a kernel never ran: {launches}"
    assert table["start"] == 20
    return out


# --------------------------------------------------------------- demos
DEMOS = {
    "modgp": (["--steps", "1000"], r"source recovery RMSE: ([0-9.]+)"),
    "modgp_real_audio": (["--steps", "1000"], r"reconstruction RMSE: ([0-9.]+)"),
    "separation": ([], r"mean per-source RMSE: ([0-9.]+)"),
    "transcription": ([], r"F-measure ([0-9.]+)"),
}


def phase_demos() -> dict:
    """The four demos as users run them, ``python -m
    gpitch_tpu_torch.demos.<name>`` (no --plot), each in its own process,
    all four at once: each prints its result line and exits 0 (its
    threshold met)."""
    import re
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, "-m", f"gpitch_tpu_torch.demos.{name}",
                                     *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True, cwd=ROOT)
             for name, (args, _) in DEMOS.items()}
    res = {}
    try:
        for name, p in procs.items():
            so, se = p.communicate(timeout=DIST_TIMEOUT_S)
            match = re.search(DEMOS[name][1], so)
            steps = re.search(r"\(([0-9.]+) steps/s", so)
            res[name] = {"rc": p.returncode, "args": DEMOS[name][0],
                         "result": float(match.group(1)) if match else None,
                         "steps_per_s": float(steps.group(1)) if steps else None,
                         "lines": so.strip().splitlines()[-4:], "stderr": se[-600:]}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    out = {"phase": "demos", "seconds": time.perf_counter() - t0, **res}
    emit(out)
    for name, r in res.items():
        assert r["rc"] == 0 and r["result"] is not None, f"demo {name} failed: {r}"
    return out


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
            counts = run()
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
        # the lag table's gather and its backward (a scatter-add), by op
        gather = {e.key: {"device_ms": _device_us(e) / 1e3, "calls": e.count}
                  for e in ops if e.key in ("aten::gather", "aten::scatter_add_")}
        rec = {"phase": "profile", "window": what, "wall_ms": wall_us / 1e3,
               "device_ms": device_us / 1e3, "device_busy_share": device_us / wall_us,
               "top_ops": top(ops, 10), "top_kernels": top(kernels, 10),
               "port_kernels": {k: {"device_ms": ms, "launches": n}
                                for k, (ms, n) in port.items()},
               "gather_ops": gather}
        if isinstance(counts, dict) and "evaluations" in counts:
            rec.update(counts, device_ms_per_evaluation=device_us / 1e3 / counts["evaluations"],
                       wall_ms_per_iteration=wall_us / 1e3 / counts["iterations"])
        emit(rec)


def _captured_windows(captured: dict) -> list:
    """The profile's windows of Adam steps: on each path of the
    captured_step phase, n steps replayed from its captured step, and on
    sosp-14s, amt-10s and ModGP the same steps run eagerly."""
    wins = []
    for name, n, eager in (("sosp4s", 20, False), ("sosp14s", 10, True),
                           ("amt10s", 3, True), ("amt10s_lag_table", 3, False),
                           ("amt88_2s_lag_table", 1, False), ("modgp_bench", 100, True)):
        for e in (False, True) if eager else (False,):
            wins.append((f"{n} {'eager' if e else 'captured'} Adam steps ({name})",
                         lambda r=captured[name], n=n, e=e: r.steps(n, eager=e)))
    return wins


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
    full_model, full_losses, full_rows = phase_full(dev)
    whiten = phase_fused_whiten(dev, sosp_model, full_model)
    amt = phase_amt(dev)
    amt_full, amt_model, piano = phase_amt_full(dev)
    lag, (table_bank, table88) = phase_lag_table(dev, amt_model, amt_full["sounding"],
                                                 piano, amt_full["piano88"])
    _, captured = phase_captured_step(dev, sosp_model, full_model, amt_model, piano,
                                      table_bank, table88)
    del sosp_model, piano
    torch.cuda.empty_cache()
    phase_modgp(dev)
    lbfgs, _, lbfgs_sub, (lbfgs_cap, lbfgs_eager) = phase_lbfgs(dev, amt_model)
    hmc, ((hmc_logprob, hmc_init), (bank_logprob, bank_init)) = phase_hmc(dev, lbfgs_sub)
    hmc_windows = (_hmc_windows("ModGP", hmc_logprob, hmc_init, 10,
                                dict(num_chains=HMC_MODGP["num_chains"],
                                     num_leapfrog=HMC_MODGP["num_leapfrog"]))
                   + _hmc_windows("16 windows folded 4x", bank_logprob, bank_init, 10,
                                  dict(num_chains=HMC_BANK["num_chains"],
                                       num_leapfrog=HMC_BANK["num_leapfrog"])))
    del lbfgs_sub
    _, natgrad_steps = phase_natgrad(dev)
    train = phase_kernel_train(dev)
    dist = phase_distributed(dev, full_losses, full_rows)
    resume = phase_resume(dev, table_bank)
    phase_demos()
    # last: the profiler's tracing may stay attached to the process
    phase_profile(_captured_windows(captured)
                  + [("predict_s", lambda: full_model.predict_s()),
                     ("3 captured L-BFGS iterations (sosp14s, 222 windows)",
                      lambda: lbfgs_cap.iterations(3)[1]),
                     ("3 eager L-BFGS iterations (sosp14s, 222 windows)",
                      lambda: lbfgs_eager.iterations(3, "eager")[1]),
                     ("50 captured natgrad_adam steps (ModGP demo)",
                      lambda: natgrad_steps("captured", 50)),
                     ("20 eager natgrad_adam steps (ModGP demo)",
                      lambda: natgrad_steps("eager", 20))]
                  + hmc_windows)

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
         "launches_lbfgs": lbfgs["b"]["launches"]["cholesky_batched"],
         "launches_train": train["sosp14s"]["learned"]["launches"]["cholesky_batched"],
         "launches_lag": lag["launches"]["cholesky_batched"],
         "launches_hmc": hmc["bank"]["launches"]["cholesky_batched"],
         "launches_dist": [r["cholesky_batched"] for r in
                           dist["b_two_ranks_gloo_sosp14s"]["launches_per_rank"]],
         "launches_resume": resume["a_sosp4s_fused"]["launches"]["cholesky_batched"],
         "calls_per_captured_sosp_step":
             captured["sosp4s"].run.calls.get("cholesky_batched", 0),
         "shape": main_chol["shape"],
         "max_abs_err": main_chol["max_abs_err_plain"], "ms": main_chol["kernel_ms"],
         "plain_ms": main_chol["plain_ms"], "bound_ms": main_chol["bound_ms"],
         "bound_by": main_chol["bound_by"], "library_ms": main_chol["library_ms"],
         "timed_by": "cuda_graph"},
        {"name": "specmix_matrix", "route": "cuda",
         "source": "gpitch_tpu_torch/csrc/specmix.cu",
         "replaces": "gpitch_tpu/linalg/pallas/specmix.py:49",
         "launches": sosp["launches"]["specmix_matrix"],
         "launches_train": train["sosp14s"]["learned"]["launches"]["specmix_matrix"],
         "launches_lag": lag["launches"]["specmix_matrix"],
         "launches_hmc": hmc["bank"]["launches"]["specmix_matrix"],
         "launches_dist": [r["specmix_matrix"] for r in
                           dist["b_two_ranks_gloo_sosp14s"]["launches_per_rank"]],
         "launches_resume": resume["a_sosp4s_fused"]["launches"]["specmix_matrix"],
         "shape": main_spec["shape"],
         "max_abs_err": main_spec["max_abs_err"], "ms": main_spec["kernel_ms"],
         "plain_ms": main_spec["plain_ms"], "bound_ms": main_spec["bound_ms"],
         "bound_by": main_spec["bound_by"], "library_ms": None, "timed_by": "cuda_graph"},
    ]
    # kernels 3 and 4 are one CUDA kernel (A) behind two entry points; 5 is
    # kernel B.  Times at the prototypes' SoSp-width inputs (case a); the
    # library time is the unfused torch composition (cuBLAS SGEMM and
    # elementwise ops): its forward for A, its backward alone (autograd on a
    # built graph) for B.  Launches: the sosp phase's (``launches``, also
    # ``launches_sosp``) and the amt phase's; kernel A's flat entry point is
    # called by no path, so row 4 counts kernel A's launches there and its
    # own entry's in run (d) of the fused_whiten phase.
    # (``ms_b`` and ``bound*_b``: the same kernel at the AMT width, case b)
    case_a = whiten["cases"]["a_sosp"]
    tm, tb = case_a["times"], whiten["cases"]["b_amt"]["times"]
    for name, replaces, timed, err, plain, lib, k, counter in (
            ("fused_whiten", "scripts/proto_fused_whiten.py:151", "kernel_A_ms",
             case_a["forward"]["fused_whiten.U"]["max_abs_err"], tm["plain_fwd_ms"],
             tm["plain_fwd_ms"], "A", "fused_whiten"),
            ("fused_whiten_flat", "scripts/proto_fused_whiten.py:208", "kernel_A_flat_ms",
             case_a["forward"]["fused_whiten_flat.U"]["max_abs_err"], tm["plain_fwd_ms"],
             tm["plain_fwd_ms"], "A", "fused_whiten"),
            ("fused_whiten_bwd", "scripts/proto_fused_whiten_bwd.py:157", "kernel_B_ms",
             max(r["max_abs_err"] for r in case_a["backward"].values()), tm["plain_bwd_ms"],
             tm["unfused_bwd_ms"], "B", "fused_whiten_bwd")):
        kernels.append({"name": name, "route": "cuda",
                        "source": "gpitch_tpu_torch/csrc/fused_whiten.cu",
                        "replaces": replaces, "launches": sosp["launches"][counter],
                        "launches_sosp": sosp["launches"][counter],
                        "launches_amt": amt["launches"][counter],
                        "launches_lbfgs": lbfgs["b"]["launches"][counter],
                        "launches_train": train["sosp14s"]["learned"]["launches"][counter],
                        "launches_lag": lag["launches"][counter],
                        "launches_hmc": hmc["bank"]["launches"][counter],
                        "launches_dist": [r[counter] for r in
                                          dist["b_two_ranks_gloo_sosp14s"]["launches_per_rank"]],
                        "launches_resume": resume["a_sosp4s_fused"]["launches"][counter],
                        "entry_launches_in_d": whiten["launches"][name],
                        "calls_per_captured_sosp_step":
                            captured["sosp4s"].run.calls.get(counter, 0),
                        "shape": case_a["shape"], "max_abs_err": err, "ms": tm[timed],
                        "plain_ms": plain, "bound_ms": tm[f"bound_{k}_ms"],
                        "bound_by": tm[f"bound_{k}_by"],
                        "bound_fp32_ms": tm[f"bound_{k}_fp32_ms"],
                        "library_ms": lib, "timed_by": "python_calls",
                        "shape_b": whiten["cases"]["b_amt"]["shape"], "ms_b": tb[timed],
                        "bound_ms_b": tb[f"bound_{k}_ms"],
                        "bound_fp32_ms_b": tb[f"bound_{k}_fp32_ms"]})
    emit({"kernels": kernels})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(device["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        # one rank of the distributed or resume phase: prints one JSON line
        if not torch.cuda.is_available():
            sys.exit(2)
        sys.path.insert(0, ROOT)
        kind, rank, world, store, *extra = sys.argv[2:]
        emit(_worker(kind, int(rank), int(world), store, *extra))
        sys.exit(0)
    if sys.argv[1:2] == ["--write-hmc-state"]:
        # the card's own L-BFGS state of hmc (c), for the CPU tests
        if not torch.cuda.is_available():
            sys.exit(2)
        sys.path.insert(0, ROOT)
        write_hmc_bank_state(sys.argv[2] if len(sys.argv) > 2 else HMC_BANK_STATE)
        sys.exit(0)
    if sys.argv[1:2] == ["--check-hmc-state"]:
        if not torch.cuda.is_available():
            sys.exit(2)
        sys.path.insert(0, ROOT)
        check_saved_hmc_bank()
        sys.exit(0)
    sys.exit(main())
