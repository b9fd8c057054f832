"""Transcription end to end (gpitch_tpu_torch.pipelines.AMT, the MAPS
pianoroll and the scoring rules) against gpitch_tpu, on the same synthetic
piece.

A small AMT in the fast tier: 0.04 s at 44.1 kHz, windows of 401 samples
(8 windows), M = 24, 3 pitches x 3 partials, y x 20, 5 Adam steps, f64 on
the CPU.  Both packages pick the same inducing points, so the losses and
``matrix_var`` agree to f64 rounding: rtol 1e-9 is the stated tolerance,
1e-8 of the largest value for the predictions.  The pianoroll parser and
the scoring rules are numpy in both packages and must agree exactly.  The
flagship workload (tests_tpu/workloads.make_amt, 100 steps) is held
against the CPU-f64 goldens in the slow tier.
"""

import copy
import os

import numpy as np
import pytest
import torch

from gpitch_tpu.audio.io import synth_piano_note
from gpitch_tpu.audio.pianoroll import Pianoroll as JPianoroll
from gpitch_tpu.audio.pianoroll import read_note_table as j_read
from gpitch_tpu.kernels import MercerMatern12sm as JMercer
from gpitch_tpu.pipelines import AMT as JAMT
from gpitch_tpu.pipelines import transcription as jtr
from gpitch_tpu.pipelines import windowed_sgpr as jws
from gpitch_tpu_torch.audio.pianoroll import Pianoroll as TPianoroll
from gpitch_tpu_torch.audio.pianoroll import read_note_table as t_read
from gpitch_tpu_torch.kernels import MercerMatern12sm as TMercer
from gpitch_tpu_torch.pipelines import AMT as TAMT
from gpitch_tpu_torch.pipelines import transcription as ttr
from gpitch_tpu_torch.pipelines import windowed_sgpr as tws

FS = 44100.0
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _f0(midi):
    return 440.0 * 2.0 ** ((midi - 69) / 12.0)


def _piece(seconds, pitches, onsets, note_seconds):
    """The recipe of tests_tpu/workloads._piece: seeded piano-like notes at
    the given onsets.  Returns (AMT keyword arguments, notes as
    (onset, offset, midi))."""
    n = int(FS * seconds)
    notes = {p: synth_piano_note(fs=FS, seconds=note_seconds, f0=_f0(p), seed=p)[1][:, 0]
             for p in pitches}
    mix = np.zeros(n)
    for p, on in onsets:
        i0 = int(on * FS)
        seg = notes[p][: n - i0]
        mix[i0: i0 + len(seg)] += seg
    kw = dict(train_signals=[notes[p] for p in pitches],
              train_names=[f"piano_M{p}_train.wav" for p in pitches], fs=FS,
              test=((np.arange(n) / FS).reshape(-1, 1), mix), pitches=pitches,
              kernel_mode="fft")
    return kw, [(on, on + note_seconds, p) for p, on in onsets]


# ----------------------------------------------------------- host numpy
def test_read_note_table_and_pianoroll_match_jax(tmp_path):
    """A MAPS annotation file (tab-separated, a blank line, a float pitch)
    through both parsers and both Pianorolls: identical."""
    txt = ("OnsetTime\tOffsetTime\tMidiPitch\n0.10\t0.50\t60\n0.30\t0.80\t64.0\n"
           "\n1.20\t1.40\t60\n2.5\t2.9\t72\n")
    (tmp_path / "MAPS_piece.txt").write_text(txt)
    path = str(tmp_path / "MAPS_piece.txt")
    assert t_read(path) == j_read(path) == [(0.1, 0.5, 60), (0.3, 0.8, 64),
                                            (1.2, 1.4, 60), (2.5, 2.9, 72)]
    for kw in (dict(filename="MAPS_piece.wav"), dict(filename="piece")):
        got = TPianoroll(path=str(tmp_path), fs=20, duration=2.0, **kw)
        want = JPianoroll(path=str(tmp_path), fs=20, duration=2.0, **kw)
        assert got.name == want.name == "MAPS_piece.txt"
        assert got.pitch_list == want.pitch_list == [60, 64]
        np.testing.assert_array_equal(got.matrix, want.matrix)
        assert sorted(got.pr_dic) == sorted(want.pr_dic)
        for k in want.pr_dic:
            np.testing.assert_array_equal(got.pr_dic[k], want.pr_dic[k])
    with pytest.raises(FileNotFoundError):
        TPianoroll(path=str(tmp_path), filename="other.wav")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pianoroll_rules_and_f_measure_match_jax(seed):
    """mad_pianoroll, pianoroll_from_variances (both modes) and f_measure
    on seeded envelopes with silent rows: identical."""
    rng = np.random.default_rng(seed)
    mv = np.abs(rng.normal(0.01, 0.003, (6, 80)))
    mv[0, 10:30] += 0.5
    mv[2, 40:70] += rng.uniform(0.2, 1.0, 30)
    mv[5] = 0.0
    ref = (rng.uniform(size=mv.shape) > 0.7).astype(float)
    for k in (2.0, 4.0):
        np.testing.assert_array_equal(ttr.mad_pianoroll(mv, k=k), jtr.mad_pianoroll(mv, k=k))
    for per_pitch in (True, False):
        np.testing.assert_array_equal(
            ttr.pianoroll_from_variances(mv, 0.1, per_pitch),
            jtr.pianoroll_from_variances(mv, 0.1, per_pitch))
    est = ttr.mad_pianoroll(mv)
    assert ttr.f_measure(est, ref) == jtr.f_measure(est, ref)
    assert ttr.f_measure(np.zeros_like(ref), ref) == (0.0, 0.0, 0.0)


# ------------------------------------------------------------- small AMT
@pytest.fixture(scope="module")
def small():
    kw, notes = _piece(0.041, [60, 64, 67], [(60, 0.0), (64, 0.01), (67, 0.02)], 0.3)
    kw.update(window_size=401, max_par=3, num_inducing=24, dec=3)
    jm = JAMT(**kw, pianoroll=JPianoroll(fs=200, duration=0.05, notes=notes))
    jl = np.asarray(jm.optimize(maxiter=5, learning_rate=0.01))
    tm = TAMT(**kw, pianoroll=TPianoroll(fs=200, duration=0.05, notes=notes),
              device="cpu", dtype=torch.float64)
    tl = tm.optimize(maxiter=5, learning_rate=0.01)
    return kw, jm, jl, tm, tl


def test_small_amt_setup_matches(small):
    _, jm, _, tm, _ = small
    assert tm.nwin == jm.nwin == 8 and tm.z.shape == (8, 24, 1)
    np.testing.assert_array_equal(tm.z, jm.z)
    for a, b in zip(tm.params, jm.params):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    assert tm.bank.kern.stacked.lengthscales.trainable


def test_small_amt_trajectory_and_matrix_var_match(small):
    _, jm, jl, tm, tl = small
    assert tl.shape == (5,) and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-9)
    assert tm.matrix_var.shape == (3, 8)
    np.testing.assert_allclose(tm.matrix_var, np.asarray(jm.matrix_var), rtol=1e-9)


def test_small_amt_scoring_matches(small, tmp_path):
    """pianoroll_estimate (both modes), evaluate against the attached
    pianoroll, and save_results: identical to JAX's."""
    _, jm, _, tm, _ = small
    for kw in (dict(threshold=0.3), dict(mode="mad", k=2.0)):
        np.testing.assert_array_equal(tm.pianoroll_estimate(**kw),
                                      jm.pianoroll_estimate(**kw))
        assert tm.evaluate(**kw) == pytest.approx(jm.evaluate(**kw), abs=0)
    tm.save_results(tmp_path / "amt.npz")
    saved = np.load(tmp_path / "amt.npz", allow_pickle=False)
    np.testing.assert_array_equal(saved["matrix_var"], tm.matrix_var)
    np.testing.assert_array_equal(saved["pitches"], [60, 64, 67])
    bare = copy.copy(tm)
    bare.piano_roll = None
    with pytest.raises(ValueError, match="pianoroll"):
        bare.evaluate()


def test_small_amt_timed_segments_and_chunks_are_exact(small):
    """timed=True with a fence every 2 steps and windows in chunks of 3:
    the same losses as the plain run (1e-12), and (first_s, run_s) >= 0;
    mesh= names the ROADMAP item that ports it."""
    kw, _, _, _, tl = small
    tm = TAMT(**kw, device="cpu", dtype=torch.float64)
    losses, (first_s, run_s) = tm.optimize(maxiter=5, learning_rate=0.01, timed=True,
                                           window_chunk=3, segment=2)
    np.testing.assert_allclose(losses, tl, rtol=1e-12)
    assert first_s >= 0.0 and run_s > 0.0
    with pytest.raises(NotImplementedError, match="item 16"):
        tm.optimize(maxiter=1, mesh=object())


def test_small_amt_predictions_undo_y_scale(small):
    """predict_bank_sources / predict_bank_mixture of the trained AMT bank
    (targets x 20) with y_scale=20 against JAX's (1e-8 of the largest
    value), and equal to the unscaled prediction divided by 20 (mean) and
    400 (variance): without y_scale the port's predictions were 20x too
    large."""
    _, jm, _, tm, _ = small
    assert tm.y_scale == 20.0
    for t_fn, j_fn in ((tws.predict_bank_sources, jws.predict_bank_sources),
                       (tws.predict_bank_mixture, jws.predict_bank_mixture)):
        got = t_fn(tm.bank, tm.xw, batch_size=3, y_scale=20.0)
        want = j_fn(jm.bank, jm.xw, batch_size=3, y_scale=20.0)
        raw = t_fn(tm.bank, tm.xw, batch_size=3)
        for g, w, r, p in zip(got, want, raw, (1, 2)):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-8 * np.abs(w).max())
            np.testing.assert_allclose(g.numpy(), r.numpy() / 20.0 ** p, rtol=1e-14)
        assert np.abs(raw[0].numpy()).max() > 10 * np.abs(got[0].numpy()).max()


def test_amt_entry_point_defaults_to_the_card(small):
    kw = small[0]
    if torch.cuda.is_available():
        assert TAMT(**kw).bank.X.raw.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TAMT(**kw)


def test_tiny_88_pitch_bank_builds_steps_and_predicts():
    """The full piano dictionary on three 64-sample windows (the bank of
    tests/test_pipelines.py:145-183): the port's 5-step losses against
    JAX's (rtol 1e-9), (88, nw) variances, finite (88, nw, ws) sources."""
    fs, ws, hop, nw = 16000.0, 64, 32, 3
    n = hop * (nw - 1) + ws
    rng = np.random.default_rng(2)
    x = (np.arange(n) / fs).reshape(-1, 1)
    y = np.cos(2 * np.pi * _f0(60) * x) + 0.01 * rng.standard_normal((n, 1))
    xw = np.stack([x[i * hop:i * hop + ws, 0] for i in range(nw)])
    yw = np.stack([y[i * hop:i * hop + ws, 0] for i in range(nw)])
    z = tws.pad_inducing([xw[i, ::4].reshape(-1, 1) for i in range(nw)], None,
                         grid_dt=1.0 / fs)

    def kerns(cls, **kw):
        return [cls.create(0.1, 0.05, [1.0, 0.5], [_f0(m), 2 * _f0(m)], **kw)
                for m in range(21, 109)]

    jb = jws.build_window_bank(xw, yw, z, lambda: jws.sum_kernel(kerns(JMercer)),
                               grid_dt=1.0 / fs)
    tb = tws.build_window_bank(xw, yw, z, lambda: tws.sum_kernel(
        kerns(TMercer, dtype=torch.float64)), grid_dt=1.0 / fs,
        dtype=torch.float64, device="cpu")
    assert tb.kern.num_terms == 88
    _, jl = jws.optimize_bank(jb, num_steps=5, learning_rate=0.01)
    tb, tl = tws.optimize_bank(tb, num_steps=5, learning_rate=0.01)
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-9)
    assert tws.pitch_variances(tb).shape == (88, nw)
    smean, svar = tws.predict_bank_sources(tb, xw, batch_size=2)
    assert smean.shape == (88, nw, ws)
    assert bool(torch.isfinite(smean).all()) and bool((svar > -1e-8).all())


@pytest.mark.slow
def test_torch_amt_tracks_cpu_f64_goldens():
    """tests_tpu/workloads.make_amt (1 s at 44.1 kHz, ws 2001, M 160, 8
    pitches x 10 partials, y x 20) for 100 Adam steps in windows of 16, f64
    on the CPU through the port, against the JAX package's CPU-f64
    trajectory: rtol 1e-6 at step 0, 1e-4 at step 99."""
    golden = np.load(os.path.join(ROOT, "tests_tpu", "goldens.npz"))["amt_losses"]
    pitches = [60, 62, 64, 65, 67, 69, 71, 72]
    kw, _ = _piece(1.0, pitches, [(p, 0.05 + 0.11 * i) for i, p in enumerate(pitches)],
                   2.0)
    model = TAMT(**kw, window_size=2001, max_par=10, num_inducing=160, dec=3,
                 device="cpu", dtype=torch.float64)
    losses, _ = model.optimize(maxiter=100, learning_rate=0.01, timed=True, window_chunk=16)
    assert model.nwin == 43 and np.isfinite(losses).all()
    np.testing.assert_allclose(losses[0], golden[0], rtol=1e-6)
    np.testing.assert_allclose(losses[-1], golden[-1], rtol=1e-4)
