"""The port's fits return a trained copy and leave their input unchanged, as
the JAX package's do (gpitch_tpu/models/fit.py copies the model before it
donates it; JAX arrays are immutable).

Bank input: 4 windows of 64 samples at 16 kHz, 8 inducing points per window
(every 8th sample), y = 0.3 N(0, 1) from ``np.random.default_rng(0)``, a
StackedSum of 2 MercerMatern12sm kernels with 2 partials each, f64 on the
CPU.  The ModGP input is the golden fixture of tests/test_golden.py.
Tolerance: exact (the input's leaves are never written).
"""

import os
import sys

import numpy as np
import pytest
import torch

from gpitch_tpu_torch.core.params import named_params
from gpitch_tpu_torch.kernels import MercerMatern12sm
from gpitch_tpu_torch.models import (fit_adam, fit_adam_segmented, fit_adam_timed,
                                     fit_modgp, minibatch_fn)
from gpitch_tpu_torch.pipelines import windowed_sgpr as tws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the port's golden ModGP fixture)

F64 = torch.float64
FS = 16000.0
# the input bank's loss, before and after any fit
BANK_LOSS = 283.3971543654425


def _bank():
    rng = np.random.default_rng(0)
    x = (np.arange(4 * 64) / FS).reshape(4, 64)
    y = 0.3 * rng.standard_normal((4, 64))

    def kern():
        return tws.sum_kernel([
            MercerMatern12sm.create(1.0, 0.1, [0.7, 0.3], [220.0, 440.0], dtype=F64),
            MercerMatern12sm.create(1.0, 0.1, [0.7, 0.3], [330.0, 660.0], dtype=F64)])

    return tws.build_window_bank(x, y, x[:, ::8, None], kern, dtype=F64, device="cpu")


def _leaves(model):
    return {name: p.raw.detach().clone() for name, p in named_params(model)}


def _assert_unchanged(model, before):
    after = _leaves(model)
    assert sorted(after) == sorted(before)
    for name, raw in before.items():
        assert torch.equal(after[name], raw), name


@pytest.mark.parametrize("window_chunk", [None, 2])
def test_optimize_bank_leaves_its_input_unchanged(window_chunk):
    bank = _bank()
    assert isinstance(bank.kern.stacked, MercerMatern12sm)
    before = _leaves(bank)
    loss0 = float(tws.bank_loss(bank).detach())
    np.testing.assert_allclose(loss0, BANK_LOSS, rtol=1e-12)
    trained, losses = tws.optimize_bank(bank, 5, 0.05, window_chunk=window_chunk)
    _assert_unchanged(bank, before)
    assert float(tws.bank_loss(bank).detach()) == loss0
    assert losses[0] == loss0 and losses[-1] < loss0
    assert float(tws.bank_loss(trained).detach()) < losses[-1]


@pytest.mark.parametrize("fit", ["fit_adam", "fit_adam_segmented", "fit_adam_timed",
                                 "fit_modgp"])
def test_modgp_fits_leave_their_input_unchanged(fit):
    model, x, y = chip_smoke.golden_modgp(F64, "cpu")
    before = _leaves(model)
    with torch.no_grad():
        elbo0 = float(model.elbo(x, y))

    def loss(m, xb, yb):
        return m.loss(xb, yb, num_data=32)

    batch = minibatch_fn(x, y, 8, torch.Generator().manual_seed(1))
    if fit == "fit_modgp":
        trained, losses = fit_modgp(model, x, y, num_steps=6, learning_rate=0.01,
                                    minibatch_size=8, segment=3,
                                    generator=torch.Generator().manual_seed(1))
    else:
        fn = {"fit_adam": fit_adam, "fit_adam_segmented": fit_adam_segmented,
              "fit_adam_timed": fit_adam_timed}[fit]
        trained, losses = fn(model, loss, 6, 0.01, batch)[:2]
    assert losses.shape == (6,) and np.isfinite(losses).all()
    _assert_unchanged(model, before)
    with torch.no_grad():
        assert float(model.elbo(x, y)) == elbo0
        assert float(trained.elbo(x, y)) != elbo0
