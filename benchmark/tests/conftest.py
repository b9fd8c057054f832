"""The benchmark's own tests: the counts, the generator, the reference
against the port, the harness on the CPU at a small size (its faults
planted underneath), and the control on the card.

    python -m pytest benchmark/tests -q

Tests that need the card take the ``cuda`` fixture, which skips without
one; whether there is a card is decided inside the fixture, never when a
module is imported."""

import copy
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


# a transcription configuration (``AMT``) in the form of a configuration
# file: no cell runs one yet, so the tests keep it to hold the harness's
# transcription path to the reference
TRANSCRIPTION = {
    "name": "transcription", "task": "transcription", "dtype": "float32", "fs": 44100,
    "seconds": 0.2, "window_size": 2001, "pitches": [60, 64, 67], "max_par": 4,
    "num_inducing": 32, "dec": 3, "lengthscale": 0.1, "train_lengthscale": True,
    "y_scale": 20.0,
    "notes": {"seconds": 2.0, "num_partials": 8, "inharmonicity": 0.0003, "noise": 0.0003},
    "score": {"bar_seconds": 1.0, "jitter_s": 0.02,
              "onsets": [[60, 0.01], [64, 0.05], [67, 0.1]]},
    "reference_block": 4, "predict_block": 2}


def tiny(name: str) -> dict:
    """The configuration ``name`` (a file of ``benchmark/configs``, or
    ``"transcription"``) at a size the CPU runs in seconds: the same kinds
    of parameter, fewer windows, inducing points and partials."""
    if name == "transcription":
        return copy.deepcopy(TRANSCRIPTION)
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        config = copy.deepcopy(json.load(f))
    config.update(seconds=1.0, num_inducing=32, max_par=3, reference_block=4,
                  predict_block=2)
    config["score"]["onsets"] = [[60, 0.1], [64, 0.3], [67, 0.5]]
    return config


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
