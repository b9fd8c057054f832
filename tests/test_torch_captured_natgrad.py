"""The port's natural-gradient steps as the card captures them
(gpitch_tpu_torch.models.natgrad ``NatgradSteps``: the step index, the gamma
scale and the decision to skip a step are device tensors, a skipped step
keeps every leaf and Adam's state through ``torch.where``, the loss of step
t is written at index t) against gpitch_tpu.models.natgrad's jitted scans.

On the CPU the steps run eagerly, the plain version of the card's captured
step.  Same seeded numpy inputs through both packages, f64 on the CPU (the
ModGP golden fixture of tests/test_golden.py).  Tolerances: loss traces
1e-9 (NaN at the same steps), raw leaves 1e-9 of max|ref|, the device's
gamma scale against the JAX package's rule 1e-15, segments against one run
exactly.
"""

import os
import sys

import numpy as np
import pytest
import torch

from gpitch_tpu.models import natgrad as jng
from gpitch_tpu_torch.core.params import copy_params, named_params
from gpitch_tpu_torch.models import natgrad as tng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from test_torch_lbfgs import close_leaves  # noqa: E402
from test_torch_svgp import _jax_golden, _port_of  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    jm, x, y = _jax_golden()
    return jm, _port_of(jm), x, y, torch.as_tensor(x.copy()), torch.as_tensor(y.copy())


def _steps(tm, xt, yt, n, gamma, learning_rate=0.01, warmup=1):
    return tng.NatgradSteps(copy_params(tm), xt, yt, n, gamma, None, learning_rate, warmup)


def _jax_gscales(finite):
    """The JAX package's gamma scale after each step, from which steps were
    finite: x1.05 (at most 1) after a finite step, x0.5 (at least 1e-3)
    after a skipped one."""
    g, out = 1.0, []
    for ok in finite:
        g = min(g * 1.05, 1.0) if ok else max(g * 0.5, 1e-3)
        out.append(g)
    return np.asarray(out)


def test_torch_natgrad_steps_skip_on_the_device_as_jax(golden):
    """gamma 3 with no warm-up, 12 steps: NaN at the same steps as the JAX
    package, the other losses at rtol 1e-9, the raw leaves within 1e-9;
    on the device Adam's count is the number of finite steps, the step
    index 12, and the gamma scale the JAX package's rule at 1e-15."""
    jm, tm, x, y, xt, yt = golden
    jo, jl = jng.fit_natgrad_adam(jm, x, y, num_steps=12, gamma=3.0, learning_rate=0.01,
                                  gamma_warmup=1)
    jl = np.asarray(jl)
    run = _steps(tm, xt, yt, 12, 3.0)
    gscales = []
    for _ in range(12):
        run.run(1)
        gscales.append(float(run.gscale))
    losses = run.losses.numpy()
    np.testing.assert_array_equal(np.isnan(losses), np.isnan(jl))
    assert 0 < np.isnan(losses).sum() < 12
    np.testing.assert_allclose(losses, jl, rtol=1e-9)
    close_leaves(run.model, jo, 1e-9)
    assert int(run.adam.t) == int(np.isfinite(losses).sum())
    assert float(run.step_i) == 12.0 and int(run.i) == 12
    np.testing.assert_allclose(gscales, _jax_gscales(np.isfinite(losses)), rtol=1e-15)


def test_torch_natgrad_polish_steps_skip_as_jax(golden):
    """natgrad_polish at gamma 4 (a full-batch natural step with the
    hyperparameters frozen, some steps skipped): the loss trace with NaN at
    the JAX package's steps and at rtol 1e-9, the raw leaves within 1e-9."""
    jm, tm, x, y, xt, yt = golden
    jp, jl = jng.natgrad_polish(jm, x, y, num_steps=10, gamma=4.0)
    tp, tl = tng.natgrad_polish(tm, xt, yt, num_steps=10, gamma=4.0)
    jl = np.asarray(jl)
    np.testing.assert_array_equal(np.isnan(tl), np.isnan(jl))
    assert 0 < np.isnan(tl).sum() < 10
    np.testing.assert_allclose(tl, jl, rtol=1e-9)
    close_leaves(tp, jp, 1e-9)


def test_torch_natgrad_skipped_steps_keep_every_leaf(golden):
    """At gamma 1e4 every step is skipped: every raw leaf of the model and
    Adam's moments equal their start bit for bit, Adam's count stays 0,
    the losses are NaN and the gamma scale sits at its floor 1e-3."""
    _, tm, _, _, xt, yt = golden
    run = _steps(tm, xt, yt, 14, 1e4)
    run.run(14)
    assert np.isnan(run.losses.numpy()).all()
    for (name, a), (_, b) in zip(named_params(run.model), named_params(tm)):
        assert torch.equal(a.raw, b.raw), name
    assert int(run.adam.t) == 0
    assert all(torch.equal(m, torch.zeros_like(m)) for m in run.adam.m + run.adam.v)
    assert float(run.gscale) == 1e-3


@pytest.mark.parametrize("lengths", [(5, 7), (1, 3, 8)])
def test_torch_natgrad_segments_equal_one_run(golden, lengths):
    """The steps run in segments (a host fence each) against one run of 12,
    gamma 3 (skips included), and a load then the same run again: the
    losses and the raw leaves bit for bit."""
    _, tm, _, _, xt, yt = golden
    one = _steps(tm, xt, yt, 12, 3.0)
    whole = one.segment(12)
    parts = _steps(tm, xt, yt, 12, 3.0)
    got = np.concatenate([parts.segment(n) for n in lengths])
    np.testing.assert_array_equal(got, whole)
    for (name, a), (_, b) in zip(named_params(parts.model), named_params(one.model)):
        assert torch.equal(a.raw, b.raw), name
    one.load(tm)
    np.testing.assert_array_equal(one.segment(12), whole)


def test_torch_natgrad_minibatch_draws_inside_the_step(golden):
    """With a minibatch generator the step draws its own batch: two runs
    from the same seed are equal, a third from another seed is not."""
    _, tm, _, _, xt, yt = golden
    from gpitch_tpu_torch.models.fit import minibatch_fn

    def run(seed):
        batch = minibatch_fn(xt, yt, 16, torch.Generator().manual_seed(seed))
        steps = tng.NatgradSteps(copy_params(tm), xt, yt, 6, 0.1, xt.shape[0], 0.01, 100,
                                 batch)
        return steps.segment(6)

    a, b, c = run(0), run(0), run(1)
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all() and not np.array_equal(a, c)
