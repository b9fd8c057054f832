"""The transcription cell's dictionary stacks (benchmark configuration
amt63x20-2s: keys A0-B5, 20 partials each, 2 s notes at 44.1 kHz).

The bank is one StackedSum, and so takes the fused pair, only where every
key's FFT gives the same number of peaks; the benchmark's reference and
driver refuse a ragged dictionary.  So for 8 seeds of the configuration's
generator, at the full note length, both the port's FFT init and the
reference's give exactly 20 partials for each of the 63 keys, and the
port's ``AMT`` built from the configuration holds a StackedSum bank that
takes the fused route on the CPU (the plain versions of kernels A and B).
"""

import json
import os

import numpy as np
import pytest

from benchmark import drivers, generator, reference
from gpitch_tpu_torch.audio.spectrum import init_cparam
from gpitch_tpu_torch.kernels.base import StackedSum
from gpitch_tpu_torch.pipelines.windowed_sgpr import bank_route
from gpitch_tpu_torch.utils.math import find_ideal_f0

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = [0, 1, 7, 2 ** 31 + 11, 3 * 2 ** 32 + 5, 123456789, 4_000_000_001, 2 ** 33 + 7]


@pytest.fixture(scope="module")
def config():
    with open(os.path.join(ROOT, "benchmark", "configs", "amt63x20-2s.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("seed", SEEDS)
def test_every_key_gives_twenty_partials_and_the_bank_stacks(config, seed):
    assert config["pitches"] == list(range(21, 84)) and config["max_par"] == 20
    rec = generator.make_recording(config, generator.job_seed(seed, 0))
    fs, p = rec["fs"], config["max_par"]
    for key in config["pitches"]:
        note = rec["notes"][key]
        assert note.size == int(fs * config["notes"]["seconds"])
        freq, energy = reference.fft_init(note, fs, p, generator.f0_of(key))
        assert freq.size == p and np.isclose(energy.sum(), 1.0), key
        f0 = find_ideal_f0([f"piano_M{key}_train.wav"])[0]
        port = init_cparam(note, fs=fs, maxh=p, ideal_f0=f0)
        assert np.asarray(port[0]).size == p, key
    model = drivers.build_model(config, rec, "cpu")
    bank = model.bank
    assert isinstance(bank.kern, StackedSum) and bank.fused_eligible()
    assert bank_route(bank) == "fused"
    assert tuple(bank.kern.stacked.energy.raw.shape) == (87, 63, 20)
    assert tuple(bank.Z.raw.shape) == (87, 160, 1) and tuple(bank.X.raw.shape) == (87, 2001, 1)
