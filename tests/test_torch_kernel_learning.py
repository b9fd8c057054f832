"""Kernel learning ('train' mode) and the host helpers of the port
(gpitch_tpu_torch.pipelines.kernel_learning, .separation, .init; audio io,
windowing and get_features) against gpitch_tpu.

Same seeded numpy inputs through both packages, f64 on the CPU.
Tolerances: the sampling helpers and every numpy host function exactly;
the fit forms 1e-12 of max|ref|; fitted parameters and kernels (L-BFGS,
the port's against optax's) 1e-8; the bank loss of a 'train'-mode SoSp
1e-8 relative.

``tests/torch_kernel_learning_goldens.npz`` holds the JAX package's f64
learned parameters and fit RMSEs for the three notes of sosp-4s at full
width (10000 samples, covsize 441, max_par 5, 250 L-BFGS steps), and the
port's own f32 deviation from them on the CPU, which ``chip_smoke.py``'s
``kernel_train`` phase takes (times 3) as its limit.  Write it anew with

    JAX_PLATFORMS=cpu python -m tests.test_torch_kernel_learning --write-goldens
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import gpitch_tpu.audio as ja
import gpitch_tpu.audio.windowing as jw
import gpitch_tpu.pipelines.init as jinit
import gpitch_tpu.pipelines.kernel_learning as jkl
from gpitch_tpu.pipelines import SoSp as JSoSp
from gpitch_tpu.pipelines.separation import learn_pitch_params as j_learn
from gpitch_tpu.pipelines.separation import load_mixture_from_sources as j_load_mix
import gpitch_tpu_torch.audio as ta
import gpitch_tpu_torch.audio.windowing as tw
import gpitch_tpu_torch.pipelines.init as tinit
import gpitch_tpu_torch.pipelines.kernel_learning as tkl
from gpitch_tpu_torch.pipelines import SoSp as TSoSp
from gpitch_tpu_torch.pipelines.separation import learn_pitch_params as t_learn
from gpitch_tpu_torch.pipelines.separation import load_mixture_from_sources as t_load_mix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
import chip_smoke  # noqa: E402  (the port's workloads, as the card runs them)
from chip_smoke import KL_GOLDENS as GOLDENS  # noqa: E402
from chip_smoke import KL_TRAIN, PITCHES, learned_deviation, learned_kernels  # noqa: E402

F64 = torch.float64
FS = 16000.0
SMALL = dict(num_sam=500, covsize=101, max_par=3)   # the fits of 30 steps
# learn_pitch_params runs 250 steps: at covsize 101 (6 ms of lags) the
# frequencies are too weakly determined for 250 steps of two L-BFGS codes
# to stay together, at the full covsize 441 they agree to ~2e-10
TRAIN = dict(SMALL, covsize=441)


def close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.fixture(scope="module")
def notes():
    """Half-second notes C4, E4, G4 (seeded by pitch) and their names."""
    ns = chip_smoke.sosp_notes(0.5)
    return [ns[p] for p in PITCHES], [f"piano_M{p}_train.wav" for p in PITCHES]


# ------------------------------------------------------------ sampling
def test_sampling_helpers_are_the_jax_packages_exactly(notes):
    y = notes[0][0]
    for name in ("sample_cov", "get_cov"):
        for got, want in zip(getattr(tkl, name)(y, num_sam=300, size=101, seed=4),
                             getattr(jkl, name)(y, num_sam=300, size=101, seed=4)):
            equal(got, want)
    s = tkl.get_samples(y, 200, 64, seed=2)
    equal(s, jkl.get_samples(y, 200, 64, seed=2))
    equal(tkl.comatrix(s), jkl.comatrix(s))
    equal(tkl.autocorr(y, 101), jkl.autocorr(y, 101))
    got, want = tkl.sample_cov_psd(y, niter=200, msize=64), jkl.sample_cov_psd(
        y, niter=200, msize=64)
    equal(got[0], want[0])
    equal(np.stack(got[1]), np.stack(want[1]))


def test_fit_forms_match():
    rng = np.random.default_rng(0)
    x = np.linspace(-0.01, 0.02, 77)
    p = np.hstack([[0.1, -0.004], rng.random(4), 200.0 * (1 + np.arange(4))])
    for name in ("approximate_kernel", "approximate_kernel_expdecay"):
        close(getattr(tkl, name)(torch.as_tensor(p), x), getattr(jkl, name)(p, x), 1e-12)
    g = np.stack([rng.random(3), 0.002 + 0.01 * rng.random(3), 300.0 * rng.random(3)], 1)
    close(tkl.gabor_sum(x, torch.as_tensor(g.reshape(-1))), jkl.gabor_sum(x, g.reshape(-1)),
          1e-12)
    # a batch of rows is each row's own evaluation
    rows = torch.as_tensor(np.stack([p, p * 1.1]))
    close(tkl.approximate_kernel(rows, x)[1], jkl.approximate_kernel(p * 1.1, x), 1e-12)


# ------------------------------------------------------------ the fits
def _sampled(y):
    return jkl.sample_cov(y, num_sam=SMALL["num_sam"], size=SMALL["covsize"])[1]


def test_fit_kernel_matches_jax(notes):
    """30 L-BFGS steps at covsize 101 (500 samples, 3 partials): the fitted
    parameters and the initial and fitted kernels within 1e-8."""
    y, name = notes[0][0], notes[1][0]
    kern = _sampled(y)
    got = tkl.fit_kernel(kern, y, name, SMALL["max_par"], FS, num_steps=30, device="cpu",
                         dtype=F64)
    want = jkl.fit_kernel(kern, y, name, SMALL["max_par"], FS, num_steps=30)
    for a, b in zip(got[0], want[0]):
        close(a, b, 1e-8)
    close(got[1], want[1], 1e-8)
    close(got[2], want[2], 1e-8)
    assert np.sqrt(np.mean((got[2] - kern[:, 0]) ** 2)) < np.sqrt(
        np.mean((got[1] - kern[:, 0]) ** 2))


def test_fit_kernels_batches_pitches_as_one_by_one(notes):
    """Three pitches in one batched solve give each pitch's own solve
    (1e-10); a pure tone (one FFT peak, so fewer parameters) beside a note
    goes through a solve of its own size."""
    kerns = [_sampled(y) for y in notes[0]]
    batched, secs = tkl.fit_kernels(kerns, notes[0], notes[1], 3, FS, num_steps=30,
                                    device="cpu", dtype=F64)
    assert len(secs) == 3 and secs[0] == secs[1] == secs[2] > 0
    for i in range(3):
        one = tkl.fit_kernel(kerns[i], notes[0][i], notes[1][i], 3, FS, num_steps=30,
                             device="cpu", dtype=F64)
        for a, b in zip(batched[i][0] + [batched[i][2]], one[0] + [one[2]]):
            close(a, b, 1e-10)
    # a silent-ish note with one FFT peak: its parameter count differs
    tone = np.sin(2 * np.pi * 261.626 * np.arange(8000) / FS)
    mixed, _ = tkl.fit_kernels([kerns[0], _sampled(tone)], [notes[0][0], tone],
                               [notes[1][0], notes[1][0]], 3, FS, num_steps=30,
                               device="cpu", dtype=F64)
    assert len(mixed[1][0][1]) == 1 and len(mixed[0][0][1]) == 3
    for a, b in zip(mixed[0][0], batched[0][0]):
        close(a, b, 1e-10)


def test_fit_kernel_gabor_and_optimize_kern_match_jax(notes):
    y, name = notes[0][1], notes[1][1]
    kern = _sampled(y)
    got = tkl.fit_kernel_gabor(kern, y, name, SMALL["max_par"], FS, num_steps=30,
                               device="cpu", dtype=F64)
    want = jkl.fit_kernel_gabor(kern, y, name, SMALL["max_par"], FS, num_steps=30)
    for a, b in zip(got, want):
        close(a, b, 1e-8)
    x = np.linspace(0.0, 100 / FS, 101)
    p0 = np.array([0.0, 0.01, 0.5, 0.3, 330.0, 660.0])
    close(tkl.optimize_kern(x, kern, p0, num_steps=30, device="cpu", dtype=F64),
          jkl.optimize_kern(x, kern, p0, num_steps=30), 1e-8)


def test_learn_pitch_params_train_matches_jax(notes):
    """learn_pitch_params(mode="train") (250 steps, covsize 441, 500
    samples, 3 partials) on three half-second notes: parameters within 1e-8, the sampled kernels exactly, and the
    stage timings per pitch."""
    timings = {}
    tp, (txk, tsk) = t_learn(*notes, FS, mode="train", timings=timings, device="cpu",
                             dtype=F64, **TRAIN)
    jp, (jxk, jsk) = j_learn(*notes, FS, mode="train", **TRAIN)
    for k in range(3):
        for a, b in zip(tp[k], jp[k]):
            close(a, b, 1e-8)
    for a, b in zip(txk + tsk, jxk + jsk):
        equal(a, b)
    assert len(timings["sample_cov"]) == len(timings["fit"]) == 3


def test_small_sosp_from_trained_kernels_matches_jax(notes):
    """SoSp(kernel_mode="train") on a 0.3 s mix (8 windows of 1001, M 32;
    the default sampling, 10000 windows of 441): the learned parameters
    (1e-8) and the bank's per-window loss before training (1e-8
    relative)."""
    n = int(0.3 * FS)
    mix = sum(np.pad(y[: n - i0], (i0, 0)) for y, i0 in zip(notes[0], (0, 1600, 3200)))
    kw = dict(train_signals=notes[0], train_names=notes[1], fs=FS,
              mixture=((np.arange(n) / FS).reshape(-1, 1), mix), window_size=1001,
              kernel_mode="train", max_par=3, num_inducing=32, dec=2)
    jm = JSoSp(**kw)
    tm = TSoSp(**kw, device="cpu", dtype=F64)
    for k in range(3):
        for a, b in zip(tm.params[k], jm.params[k]):
            close(a, b, 1e-8)
    want = np.asarray(jax.jit(jax.vmap(lambda m: m.loss()))(jm.bank))
    np.testing.assert_allclose(tm.bank.loss().detach().numpy(), want, rtol=1e-8)


# ------------------------------------------------------------ the goldens
@pytest.fixture(scope="module")
def goldens():
    return np.load(GOLDENS)


def test_kernel_learning_goldens_hold_for_the_port_in_f64(goldens):
    """The goldens file against the port in f64 on the CPU, at full width:
    the learned parameters and the fit RMSEs within 1e-8."""
    params, _, rmse = learned_kernels("cpu", F64)
    dev = learned_deviation(params, goldens)
    assert max(dev.values()) <= 1e-8, dev
    np.testing.assert_allclose(rmse, goldens["rmse"], rtol=1e-8)
    assert all(goldens[f"port_f32_cpu_dev_{k}"] > 0 for k in dev)


def make_goldens(path: str = GOLDENS) -> dict:
    """Write the goldens: the JAX package in f64 on the CPU learns the
    three notes of sosp-4s at full width (chip_smoke.KL_TRAIN); the RMSE
    of each fitted kernel against its sampled kernel; then the port in f32
    on the CPU, and the file keeps its largest deviation per quantity
    (``learned_deviation``) and of the RMSEs.  Returns what was written."""
    notes = chip_smoke.sosp_notes()
    params, (_, sk) = j_learn([notes[p] for p in PITCHES],
                              [f"piano_M{p}_train.wav" for p in PITCHES], FS, mode="train",
                              **KL_TRAIN)
    n = KL_TRAIN["covsize"]
    x = np.linspace(0.0, (n - 1.0) / FS, n)
    rmse = [float(np.sqrt(np.mean((np.asarray(jkl.approximate_kernel(
        np.hstack([[0.0, float(params[0][i])], params[1][i], params[2][i]]), x))
        - sk[i][:, 0]) ** 2))) for i in range(len(PITCHES))]
    out = {"lengthscale": np.asarray(params[0], dtype=np.float64).reshape(-1, 1),
           "energy": np.stack([np.asarray(e, np.float64) for e in params[1]]),
           "frequency": np.stack([np.asarray(f, np.float64) for f in params[2]]),
           "rmse": np.asarray(rmse)}
    p32, _, rmse32 = learned_kernels("cpu", torch.float32)
    for k, v in learned_deviation(p32, out).items():
        out[f"port_f32_cpu_dev_{k}"] = v
    out["port_f32_cpu_rmse_rel"] = float(np.max(np.abs(np.asarray(rmse32) / out["rmse"] - 1)))
    np.savez(path, **out)
    return out


# ------------------------------------------------------------ host helpers
def test_init_helpers_match(notes):
    x = np.arange(1600) / FS
    for a, b in zip(tinit.init_iv(x, 2, 100, 50, FS), jinit.init_iv(x, 2, 100, 50, FS)):
        for u, v in zip(a, b):
            equal(u, v)
    xs = np.linspace(0.0, 0.01, 19).reshape(-1, 1)
    (tka, tkc), tpar = tinit.init_kernel_training(notes[0], notes[1], FS, maxh=4, dtype=F64)
    (jka, jkc), jpar = jinit.init_kernel_training(notes[0], notes[1], FS, maxh=4)
    for tp_, jp_ in zip(tpar, jpar):
        for u, v in zip(tp_, jp_):
            equal(u, v)
    for t, j in zip(tka + tkc, jka + jkc):
        close(t.K(torch.as_tensor(xs)), j.K(xs), 1e-12)
    assert [p.trainable for p in (tkc[0].variance, tkc[0].frequency)] == [False, True]
    e, f = [[0.6, 0.4]] * 2, [[261.6, 523.2], [329.6, 659.3]]
    t_lists = tinit.init_kern(2, [0.1, 0.2], e, f, dtype=F64) + tinit.init_kern_mercer_product(
        2, e, f, dtype=F64)
    j_lists = jinit.init_kern(2, [0.1, 0.2], e, f) + jinit.init_kern_mercer_product(2, e, f)
    for tl, jl in zip(t_lists, j_lists):
        for t, j in zip(tl, jl):
            close(t.K(torch.as_tensor(xs)), j.K(xs), 1e-12)
    assert all(not k.kern_list[0].variance.trainable for k in t_lists[3])


def test_init_kernel_with_trained_models_matches():
    """From the ModGP golden fixture (both packages, same leaves), both
    options: the new kernels' covariances within 1e-12."""
    from test_torch_svgp import _jax_golden, _port_of
    jm, _, _ = _jax_golden()
    tm = _port_of(jm)
    xs = np.linspace(0.0, 0.01, 19).reshape(-1, 1)
    for option_two in (False, True):
        t_out = tinit.init_kernel_with_trained_models([tm], option_two, dtype=F64)
        j_out = jinit.init_kernel_with_trained_models([jm], option_two)
        for t, j in zip(t_out[0] + t_out[1], j_out[0] + j_out[1]):
            close(t.K(torch.as_tensor(xs)), j.K(xs), 1e-12)


def _write_wav(path, y, fs=16000):
    wavfile.write(path, fs, (np.clip(y, -1, 1) * 32767).astype(np.int16))


def test_audio_io_on_a_written_wav(tmp_path, notes):
    path = str(tmp_path / "piano_M60_train.wav")
    _write_wav(path, notes[0][0])
    for kw in ({}, {"frames": 3000, "start": 100, "scaled": True, "aug": True}):
        for a, b in zip(ta.readaudio(path, **kw), ja.readaudio(path, **kw)):
            equal(a, b)
    for kw in ({"window_size": 1001}, {"window_size": 1000, "overlap": False}):
        t = ta.Audio(path=str(tmp_path) + os.sep, filename="piano_M60_train.wav", **kw)
        j = ja.Audio(path=str(tmp_path) + os.sep, filename="piano_M60_train.wav", **kw)
        assert len(t.X) == len(j.X) > 1 and t.fs == j.fs
        for a, b in zip(t.X + t.Y, j.X + j.Y):
            equal(a, b)
    for a, b in zip(ta.Audio().Y, ja.Audio().Y):
        equal(a, b)
    for a, b in zip(ta.synth_tone(8000, 0.5, 300.0), ja.synth_tone(8000, 0.5, 300.0)):
        equal(a, b)


def test_windowing_helpers_match(notes):
    y = notes[0][0][:5000]
    x = np.arange(y.size) / FS
    tx, ty = tw.windowed(x, y, 1001)
    jx, jy = jw.windowed(x, y, 1001)
    for a, b in zip(tx + ty, jx + jy):
        equal(a, b)
    for a, b in zip(tw.segmented(x, y, 1200, aug=True), jw.segmented(x, y, 1200, aug=True)):
        for u, v in zip(a, b):
            equal(u, v)
    for a, b in zip(tw.augmentate(x, y, 100), jw.augmentate(x, y, 100)):
        equal(a, b)
    segs = jw.segmented(x, y, 1200, aug=True)[1]
    equal(tw.trim_n_merge(segs), jw.trim_n_merge(segs))
    equal(tw.merged_x(tx, 1001), jw.merged_x(jx, 1001))
    equal(tw.merged_y(ty, 1001), jw.merged_y(jy, 1001))
    srcs = [ty, [w * 0.5 for w in ty]]
    for a, b in zip(tw.get_results_arrays(tx, ty, srcs, 1001),
                    jw.get_results_arrays(jx, jy, srcs, 1001)):
        for u, v in zip(a if isinstance(a, list) else [a], b if isinstance(b, list) else [b]):
            equal(u, v)
    res = [[y[:10], y[10:20]]] * 5
    got, want = tw.get_results_arrays_noov(x, y, res, 10), jw.get_results_arrays_noov(
        x, y, res, 10)
    equal(got[0], want[0])
    for a, b in zip(got[2], want[2]):
        for u, v in zip(a, b):
            equal(u, v)


def test_get_features_matches(notes):
    f, s = ja.init_cparam(notes[0][0], FS, 8, 261.6)[2:4]
    for kw in ({"f_centers": [261.6, 523.2], "nfpc": 1}, {"f_centers": [261.6], "nfpc": 4},
               {"use_centers": False, "totalnumf": 6}):
        for a, b in zip(ta.get_features(f, s, **kw), ja.get_features(f, s, **kw)):
            equal(a, b)


def test_mixture_from_sources_and_save_results(tmp_path, notes):
    """load_mixture_from_sources on three WAVs the test writes, exactly as
    the JAX package; then a small SoSp's save_results, read back."""
    for y, tag in zip(notes[0], ("_C_", "_E_", "_G_")):
        _write_wav(str(tmp_path / f"test_piano{tag}note.wav"), 0.5 * y[:4000])
    tx, tmix, tsrc = t_load_mix(str(tmp_path), "piano", window_size=1001)
    jx, jmix, jsrc = j_load_mix(str(tmp_path), "piano", window_size=1001)
    equal(tx, jx)
    equal(tmix, jmix)
    assert [s.name for s in tsrc] == [s.name for s in jsrc]
    model = TSoSp(train_signals=notes[0], train_names=notes[1], fs=FS,
                  mixture=(tx, tmix), window_size=1001, max_par=2, num_inducing=16,
                  dec=2, device="cpu", dtype=F64)
    model.optimize(maxiter=2)
    est = model.predict_s()
    out = str(tmp_path / "results.npz")
    model.save_results(out, real_sources=[s.y for s in tsrc])
    saved = np.load(out, allow_pickle=True)
    equal(saved["esrc"], np.stack([e[0] for e in est]))
    equal(saved["vsrc"], np.stack([e[1] for e in est]))
    equal(saved["matrix_var"], model.matrix_var)
    assert saved["src"].shape == (3, 4000, 1)


if __name__ == "__main__" and "--write-goldens" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    written = make_goldens()
    print({k: (v.tolist() if np.ndim(v) else float(v)) for k, v in written.items()})
