"""The transcription cell (amt63-adam) driven through the harness on the
CPU at a small size of its own configuration: the same kinds of parameter
(20-partial notes, y x 20, trained lengthscales) with 6 keys of 4 partials,
M 32 and 7 windows.  A sound run is correct under the cell's own limits;
every Adam step leaving its state unchanged, planted in the program, is
not.  The reader of ``source_chunks`` gives the program's counter, and
nothing where a program has none (an older tree) or launched no kernel B."""

import copy
import importlib
import json
import os
from types import SimpleNamespace

import pytest

from benchmark import calibrate, harness

from benchmark.tests.conftest import ROOT

CELL = "amt63-adam"


def _tiny() -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", "amt63x20-2s.json")) as f:
        config = copy.deepcopy(json.load(f))
    config.update(seconds=0.2, pitches=[48, 55, 60, 64, 67, 72], max_par=4, num_inducing=32,
                  reference_block=4)
    config["score"]["onsets"] = [[48, 0.01], [60, 0.02], [64, 0.03], [67, 0.08], [55, 0.1],
                                 [72, 0.12]]
    return config


def _run(trace=False):
    return harness.run(ROOT, CELL, 2 ** 31 + 5, 0.5, trace, device="cpu", config=_tiny())


def test_sound_run_of_the_transcription_cell_is_correct():
    result = _run(trace=True)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 500 and result["failed"] == 0
    # on the CPU the plain versions run: no kernel B, so no source chunks
    assert "source_chunks" not in result["metrics"] and "mfu.bank_step" in result["metrics"]


@pytest.mark.parametrize("fault", ["unchanged"])
def test_planted_fault_in_the_transcription_cell_is_not_correct(fault):
    with calibrate.planted(fault):
        result = _run()
    assert not result["correct"], result["checks"]


def test_source_chunks_reads_the_programs_counter(monkeypatch):
    module = importlib.import_module("gpitch_tpu_torch.linalg.fused_whiten")
    read = harness._reader("source_chunks")
    ctx = SimpleNamespace(profile=None)
    monkeypatch.setattr(module.fused_whiten_source_chunks, "bwd", 0)
    assert read(ctx) is None
    monkeypatch.setattr(module.fused_whiten_source_chunks, "bwd", 32)
    assert read(ctx) == 32.0
    monkeypatch.delattr(module, "fused_whiten_source_chunks")
    assert read(ctx) is None
