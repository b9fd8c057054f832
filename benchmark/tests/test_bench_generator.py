"""The generator: one seed gives one recording, every seed the same
number of samples, windows and notes."""

import json
import os

import numpy as np
import pytest

from benchmark import generator, reference

from benchmark.tests.conftest import ROOT


def _config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name,windows,notes", [("sosp-14s", 222, 18)])
def test_recording_is_fixed_by_the_seed_and_sized_by_the_config(name, windows, notes):
    config = _config(name)
    seeds = [0, 7, 2 ** 31 + 11, 3 * 2 ** 32 + 5]
    recs = [generator.make_recording(config, generator.job_seed(s, 0)) for s in seeds]
    again = generator.make_recording(config, generator.job_seed(seeds[2], 0))
    assert np.array_equal(again["mix"], recs[2]["mix"])
    assert all(np.array_equal(again["notes"][p], recs[2]["notes"][p]) for p in config["pitches"])
    for rec in recs:
        assert rec["mix"].shape == (int(config["fs"] * config["seconds"]),)
        assert reference.window_stack(rec["mix"], config["window_size"]).shape[0] == windows
        assert len(rec["onsets"]) == notes
        assert np.isfinite(rec["mix"]).all()
    assert not np.array_equal(recs[0]["mix"], recs[1]["mix"])
    other_job = generator.make_recording(config, generator.job_seed(seeds[2], 1))
    assert not np.array_equal(other_job["mix"], recs[2]["mix"])


@pytest.mark.parametrize("name", ["sosp-14s"])
def test_every_pitch_gets_the_configured_partials(name):
    # the bank is stacked (one kernel over the pitches) only when every
    # pitch's FFT gives max_par peaks
    config = _config(name)
    for seed in (1, 2 ** 33 + 3):
        rec = generator.make_recording(config, generator.job_seed(seed, 0))
        for p in config["pitches"]:
            f, e = reference.fft_init(rec["notes"][p], rec["fs"], config["max_par"],
                                      generator.f0_of(p))
            assert f.size == config["max_par"] and np.isclose(e.sum(), 1.0)
