"""The harness driven on the CPU at a small size, past its look for a
card: a sound run is correct, and each fault a cell can have, planted in
the program underneath, makes ``correct`` false under the cell's own
limits.  The set-up holds no module of JAX or the JAX package."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import calibrate, harness

from benchmark.tests.conftest import ROOT, tiny

CELLS = {"sosp14-adam": "sosp-14s", "sosp14-job": "sosp-14s"}


def _run(workload, seed=2 ** 31 + 5, trace=False, config=None):
    return harness.run(ROOT, workload, seed, 0.5, trace, device="cpu",
                       config=config or tiny(CELLS[workload]))


@pytest.mark.parametrize("workload,config", [("sosp14-adam", "sosp-14s"),
                                             ("sosp14-adam", "transcription"),
                                             ("sosp14-job", "sosp-14s")])
def test_sound_run_is_correct(workload, config):
    # the separation configuration as the cells run it; the transcription
    # path in float64, where the program and the reference agree to far
    # below the separation cell's float32 limits
    config = tiny(config) if config != "transcription" else dict(tiny(config), dtype="float64")
    result = _run(workload, config=config)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 1 and result["failed"] == 0


FAULTS = [(w, f) for w, kind in (("sosp14-adam", "adam_fit"), ("sosp14-job", "separation_job"))
          for f in calibrate.FAULTS[kind]]


@pytest.mark.parametrize("workload,fault", FAULTS, ids=[f"{w}-{f}" for w, f in FAULTS])
def test_planted_fault_is_not_correct(workload, fault):
    # the fault planted in the program, as the card's calibration plants it
    with calibrate.planted(fault):
        result = _run(workload)
    assert not result["correct"], result["checks"]


def test_adam_steps_after_the_capture_leaving_the_state_is_not_correct(monkeypatch):
    # from the fifth step of each call on (the card's replays), every step
    # leaves the state unchanged and the count advances
    from gpitch_tpu_torch.models import fit
    real = fit.Adam.commit

    def commit(self, params, m, v, ok=None):
        if int(self.t) < 4:
            return real(self, params, m, v, ok)
        self.t.add_(1)
    monkeypatch.setattr(fit.Adam, "commit", commit)
    result = _run("sosp14-adam")
    assert not result["correct"], result["checks"]


def test_traced_run_on_the_cpu_reads_no_device_metric():
    result = _run("sosp14-job", trace=True)
    names = set(result["metrics"])
    assert {"build_s.job", "fit_s.job", "predict_ms.job", "mfu.job"} <= names
    assert not any("roofline" in n or "idle" in n for n in names)
    assert "breakdown" not in result and result["device"]["platform"] == "cpu"


def test_set_up_holds_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import harness\n"
            "from benchmark.tests.conftest import tiny\n"
            "harness.run(%r, 'sosp14-adam', 3, 0.2, False, device='cpu', "
            "config=tiny('sosp-14s'))\n"
            "print(harness.forbidden_modules())\n") % (ROOT, ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "gpitch_tpu_torch_extra", sys)
    assert "gpitch_tpu_torch_extra" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax.numpy"]


def test_without_a_card_the_run_fails_and_prints_no_result(monkeypatch, capsys):
    sys.path.insert(0, ROOT)
    import benchmark.run as run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "sosp14-adam", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert np.isfinite(rc)
