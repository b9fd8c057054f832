"""The program's spans (``utils.profiling.span``) and the counts a fit
returns, on the CPU.

With no profiler a span is one shared no-op; under ``torch.profiler`` a
tiny SoSp's construction, fit (Adam and L-BFGS) and prediction open the
spans of the pipeline and optimizer layers, each nested in its parent and
none of the card's own (capture, replays); the Adam route's counts sum
over the chunks of a call; ``trace`` writes the spans into its Chrome
trace."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpitch_tpu_torch.audio.io import synth_piano_note
from gpitch_tpu_torch.pipelines import AMT, SoSp
from gpitch_tpu_torch.utils import profiling

FS = 16000.0
PITCHES = [60, 64, 67]


@pytest.fixture(scope="module")
def piece():
    """0.3 s at 16 kHz in windows of 1001 samples (8 windows), M = 32, 3
    pitches x 3 partials, float64 on the CPU."""
    n = int(FS * 0.3)
    notes = [synth_piano_note(fs=FS, seconds=1.0, f0=440.0 * 2.0 ** ((p - 69) / 12.0),
                              seed=p)[1][:, 0] for p in PITCHES]
    mix = sum(np.pad(y[:n - int(on * FS)], (int(on * FS), 0))
              for y, on in zip(notes, (0.0, 0.1, 0.2)))
    return dict(train_signals=notes, train_names=[f"piano_M{p}_train.wav" for p in PITCHES],
                fs=FS, window_size=1001, max_par=3, num_inducing=32, dec=2,
                kernel_mode="fft", device="cpu", dtype=torch.float64,
                x=(np.arange(n) / FS).reshape(-1, 1), y=mix)


def _sosp(piece):
    kw = {k: v for k, v in piece.items() if k not in ("x", "y")}
    return SoSp(mixture=(piece["x"], piece["y"]), **kw)


def _spans(prof) -> list:
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation() and e.name().startswith("gpitch.")]


def test_span_without_a_profiler_is_one_shared_no_op(monkeypatch):
    def recorded(name):
        raise AssertionError(f"{name} recorded with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", recorded)
    assert profiling.span("gpitch.a") is profiling.span("gpitch.b")
    with profiling.span("gpitch.fit"):
        torch.ones(2).sum()


@pytest.mark.parametrize("method", ["adam", "lbfgs"])
def test_sosp_spans_nest_under_the_profiler(piece, method):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model = _sosp(piece)
        model.optimize(maxiter=6, method=method)
        model.predict_s()
    got = _spans(prof)
    names = {n for n, _, _ in got}
    want = {"gpitch.sosp.init", "gpitch.pitch_params", "gpitch.windows", "gpitch.bank.build",
            "gpitch.fit", "gpitch.fit.fence", "gpitch.predict", "gpitch.predict.merge"}
    assert names == want | ({"gpitch.fit.build"} if method == "adam" else set())
    assert not names & {"gpitch.fit.capture", "gpitch.fit.replay", "gpitch.fit.warmup"}

    def inside(child, parent):
        return parent[1] <= child[1] and child[2] <= parent[2]
    # every two spans are nested or disjoint
    for i, s in enumerate(got):
        for t in got[i + 1:]:
            assert inside(s, t) or inside(t, s) or s[2] <= t[1] or t[2] <= s[1], (s, t)
    by = {n: [s for s in got if s[0] == n] for n in names}
    (init,), (fit,), (predict,), (merge,) = (by[n] for n in (
        "gpitch.sosp.init", "gpitch.fit", "gpitch.predict", "gpitch.predict.merge"))
    for n in ("gpitch.pitch_params", "gpitch.windows", "gpitch.bank.build"):
        assert len(by[n]) == 1 and inside(by[n][0], init), n
    for s in by.get("gpitch.fit.build", []):
        assert inside(s, fit)
    # the segment's fence inside the fit, the variances' copy after it
    fences = by["gpitch.fit.fence"]
    assert len(fences) == 2 and inside(fences[0], fit) and fences[1][1] >= fit[2]
    assert init[2] <= fit[1] and fences[1][2] <= predict[1] and predict[2] <= merge[1]


@pytest.mark.parametrize("window_chunk,chunks", [(None, 1), (4, 2)])
def test_adam_counts_of_a_call_on_the_cpu(piece, window_chunk, chunks):
    model = _sosp(piece)
    model.optimize(maxiter=6, window_chunk=window_chunk)
    # one segment a chunk; every step eager, none captured
    assert model.opt_info == {"syncs": chunks, "captures": 0, "capture_s": 0.0,
                              "warmup_s": 0.0, "eager_steps": 6 * chunks, "replays": 0}


def test_trace_writes_the_programs_spans(piece, tmp_path):
    kw = {k: v for k, v in piece.items() if k not in ("x", "y")}
    with profiling.trace(str(tmp_path / "trace")) as logdir:
        _sosp(piece)
        AMT(test=(piece["x"], piece["y"]), pitches=PITCHES, **kw)
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"gpitch.sosp.init", "gpitch.amt.init", "gpitch.pitch_params", "gpitch.windows",
            "gpitch.bank.build"} <= names
