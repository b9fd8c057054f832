"""Separation end to end (gpitch_tpu_torch.pipelines.SoSp) against
gpitch_tpu's SoSp, on the same synthetic mix.

A small case in the fast tier: 0.3 s at 16 kHz, windows of 1001 samples
(8 windows), M = 32, 3 pitches x 3 partials, 5 Adam steps, f64 on the CPU.
Both packages pick the same inducing points (same native/numpy dispatch),
so the trajectories agree to f64 rounding: 1e-7 relative is the stated
tolerance, 1e-9 for the merged sources (absolute, sources ~1).
The flagship workload (tests_tpu/workloads.make_sosp, 100 steps) is held
against the CPU-f64 goldens in the slow tier.
"""

import os

import numpy as np
import pytest
import torch

from gpitch_tpu.audio.io import synth_piano_note
from gpitch_tpu.pipelines import SoSp as JSoSp
from gpitch_tpu.pipelines.windowed_sgpr import optimize_bank as j_optimize_bank
from gpitch_tpu_torch.pipelines import SoSp as TSoSp

FS = 16000.0
PITCHES = [60, 64, 67]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _f0(midi):
    return 440.0 * 2.0 ** ((midi - 69) / 12.0)


def _piece(seconds, onsets, note_seconds):
    n = int(FS * seconds)
    notes = {p: synth_piano_note(fs=FS, seconds=note_seconds, f0=_f0(p), seed=p)[1][:, 0]
             for p in PITCHES}
    sources = {p: np.zeros(n) for p in PITCHES}
    for p, on in onsets:
        i0 = int(on * FS)
        seg = notes[p][: n - i0]
        sources[p][i0: i0 + len(seg)] += seg
    kw = dict(train_signals=[notes[p] for p in PITCHES],
              train_names=[f"piano_M{p}_train.wav" for p in PITCHES], fs=FS,
              mixture=((np.arange(n) / FS).reshape(-1, 1), sum(sources.values())),
              kernel_mode="fft")
    return kw, [sources[p] for p in PITCHES]


@pytest.fixture(scope="module")
def small():
    kw, sources = _piece(0.3, [(60, 0.0), (64, 0.1), (67, 0.2)], 1.0)
    kw.update(window_size=1001, max_par=3, num_inducing=32, dec=2)
    jm = JSoSp(**kw)
    # the schedule of SoSp.optimize, with a segment as long as the run
    jm.bank, jl = j_optimize_bank(jm.bank, num_steps=5, learning_rate=0.01, segment=5)
    tm = TSoSp(**kw, device="cpu", dtype=torch.float64)
    tl = tm.optimize(maxiter=5, learning_rate=0.01)
    return jm, np.asarray(jl), tm, tl, sources


def test_small_sosp_setup_matches(small):
    jm, _, tm, _, _ = small
    assert tm.nwin == jm.nwin == 8
    np.testing.assert_array_equal(tm.z, jm.z)
    for a, b in zip(tm.params, jm.params):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


def test_small_sosp_trajectory_matches(small):
    _, jl, _, tl, _ = small
    assert tl.shape == (5,) and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-7)


def test_small_sosp_sources_match(small):
    jm, _, tm, _, sources = small
    want = jm.predict_s()
    got = tm.predict_s()
    assert len(got) == 3
    for (gm, gv), (wm, wv) in zip(got, want):
        assert gm.shape == wm.shape == (sources[0].shape[0], 1)
        np.testing.assert_allclose(gm, wm, rtol=0, atol=1e-9)
        np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-9)
    assert tm.compute_rmse(sources) == pytest.approx(jm.compute_rmse(sources), rel=1e-9)


def test_small_sosp_mixture_prediction_matches(small):
    jm, _, tm, _, _ = small
    for got, want in zip(tm.predict_f(), jm.predict_f()):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_train_mode_is_left_to_a_later_slice():
    """The 'train' kernel mode, ported since: a one-note SoSp learns its
    kernel from the sampled covariance as the JAX package does (1e-8)."""
    kw, _ = _piece(0.2, [(60, 0.0)], 0.5)
    kw["kernel_mode"] = "train"
    tm = TSoSp(**kw, window_size=1001, device="cpu", dtype=torch.float64)
    jm = JSoSp(**kw, window_size=1001)
    for k in range(3):
        np.testing.assert_allclose(np.asarray(tm.params[k][0], float), jm.params[k][0],
                                   rtol=1e-8)


@pytest.mark.slow
def test_torch_sosp_tracks_cpu_f64_goldens():
    """tests_tpu/workloads.make_sosp (4 s, ws 2001, M 112, 3 x 5 partials)
    for 100 Adam steps in f64 on the CPU through the port, against the JAX
    package's CPU-f64 trajectory: rtol 1e-6 at step 0, 1e-4 at step 99."""
    golden = np.load(os.path.join(ROOT, "tests_tpu", "goldens.npz"))["sosp_losses"]
    kw, _ = _piece(4.0, [(60, 0.1), (64, 0.8), (67, 1.6), (60, 2.4), (64, 3.1)], 2.0)
    model = TSoSp(**kw, window_size=2001, max_par=5, num_inducing=112, dec=2,
                  device="cpu", dtype=torch.float64)
    losses = model.optimize(maxiter=100, learning_rate=0.01)
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses[0], golden[0], rtol=1e-6)
    np.testing.assert_allclose(losses[-1], golden[-1], rtol=1e-4)
