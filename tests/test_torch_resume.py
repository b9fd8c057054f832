"""The port's checkpoints and resume (gpitch_tpu_torch.utils.checkpoint,
pipelines.resume) against gpitch_tpu's.

f64 on the CPU.  ``save_model``/``load_model`` round trip and refuse a
checkpoint of another structure; ``save_params`` files load in both
packages, whichever wrote them.  ``optimize_bank_resumable``: the
counterparts of tests/test_aux.py's resume tests (an interrupted and
resumed run equals an uninterrupted one bit for bit), a bank-only
checkpoint's RuntimeWarning, and the port resumed at step 20 from the JAX
package's own state (bank and optax Adam state carried by ``load_raw`` and
``load_adam_state``) follows the JAX package's uninterrupted 30 steps
within 1e-10.
"""

import os
import sys

import numpy as np
import optax
import pytest
import torch

from gpitch_tpu.kernels import Matern12sm as JMatern12sm
from gpitch_tpu.kernels import Sum as JSum
from gpitch_tpu.pipelines import build_window_bank as j_build_window_bank
from gpitch_tpu.pipelines import optimize_bank_resumable as j_resumable
from gpitch_tpu.utils import checkpoint as jck
from gpitch_tpu_torch.core.params import (load_adam_state, load_raw, named_params,
                                          trainable_tensors)
from gpitch_tpu_torch.kernels import Matern12sm, Matern32, Sum
from gpitch_tpu_torch.models.fit import Adam
from gpitch_tpu_torch.pipelines import build_window_bank, optimize_bank_resumable
from gpitch_tpu_torch.utils import checkpoint as tck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from test_torch_lbfgs import jax_leaves  # noqa: E402

F64 = torch.float64


def _windows(seed, nw, ws):
    """tests/test_aux.py's resume inputs: nw windows of ws points on [i, i+1],
    y = 0.3 N(0, 1), every 8th point an inducing point."""
    rng = np.random.default_rng(seed)
    xw = np.stack([np.linspace(0, 1, ws).reshape(-1, 1) + i for i in range(nw)])
    return xw, rng.standard_normal((nw, ws, 1)) * 0.3, xw[:, ::8]


def _bank(seed=1, nw=2, ws=40):
    xw, yw, zw = _windows(seed, nw, ws)
    return build_window_bank(
        xw, yw, zw, lambda: Sum(kern_list=(Matern12sm.create(1.0, 0.2, [1.0], [8.0],
                                                             dtype=F64),)),
        dtype=F64, device="cpu")


def _j_bank(seed=1, nw=2, ws=40):
    xw, yw, zw = _windows(seed, nw, ws)
    return j_build_window_bank(
        xw, yw, zw, lambda: JSum(kern_list=(JMatern12sm.create(1.0, 0.2, [1.0], [8.0]),)))


def _raws(model):
    return {name: p.raw.detach().clone() for name, p in named_params(model)}


def test_torch_save_load_model_roundtrip(tmp_path):
    kern = Matern32.create(1.7, 0.23, dtype=F64)
    d = str(tmp_path / "ckpt")
    tck.save_model(d, kern, step=5)
    assert tck.list_checkpoints(d) == [5]
    back = tck.load_model(d, Matern32.create(1.0, 1.0, dtype=F64), step=5)
    np.testing.assert_allclose(back.variance.value.item(), 1.7, rtol=1e-12)
    np.testing.assert_allclose(back.lengthscales.value.item(), 0.23, rtol=1e-12)
    bank = _bank()
    state = {"m": tuple(torch.randn_like(t) for t in trainable_tensors(bank)), "t": 7}
    tck.save_model(d, (bank, state), step=9)
    got_bank, got_state = tck.load_model(d, (_bank(seed=2), {"m": state["m"], "t": 0}),
                                         step=9)
    for name, raw in _raws(bank).items():
        assert torch.equal(_raws(got_bank)[name], raw), name
    assert got_state["t"] == 7 and all(torch.equal(a, b)
                                       for a, b in zip(got_state["m"], state["m"]))
    assert tck.list_checkpoints(d) == [5, 9]


def test_torch_load_model_structure_mismatch_raises(tmp_path):
    d = str(tmp_path / "ckpt")
    tck.save_model(d, Matern32.create(1.7, 0.23, dtype=F64), step=0)
    with pytest.raises(ValueError):
        tck.load_model(d, Matern12sm.create(1.0, 1.0, [1.0, 2.0], [3.0, 4.0], dtype=F64))
    with pytest.raises(ValueError):                       # same paths, another dtype
        tck.load_model(d, Matern32.create(1.0, 1.0))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_torch_save_params_files_load_in_both_packages(tmp_path, writer):
    p = str(tmp_path / "hypers")
    ls = [np.array(0.1), np.array(0.2)]
    en = [np.array([1.0, 0.5]), np.array([0.3])]
    fr = [np.array([100.0, 200.0]), np.array([150.0])]
    xk = [np.linspace(0, 1, 4), np.linspace(0, 1, 3)]
    (jck if writer == "jax" else tck).save_params(p, ls, en, fr, xkern=xk, skern=xk)
    for reader in (jck, tck):
        got = reader.load_params(p)
        for q, want in enumerate((ls, en, fr)):
            for a, b in zip(got[q], want):
                np.testing.assert_array_equal(a, b)


def test_torch_optimize_bank_resumable(tmp_path):
    """test_optimize_bank_resumable: 20 steps checkpointed every 10; a
    second call finds step 20 and runs nothing."""
    bank = _bank(seed=0, nw=3, ws=48)
    d = str(tmp_path / "run")
    b1, l1, s1 = optimize_bank_resumable(bank, num_steps=20, checkpoint_dir=d,
                                         checkpoint_every=10)
    assert s1 == 0 and len(l1) == 20
    assert tck.list_checkpoints(d) == [10, 20]
    b2, l2, s2 = optimize_bank_resumable(bank, num_steps=20, checkpoint_dir=d,
                                         checkpoint_every=10)
    assert s2 == 20 and len(l2) == 0
    for name, raw in _raws(b1).items():
        assert torch.equal(_raws(b2)[name], raw), name


def test_torch_resume_is_faithful(tmp_path):
    """test_resume_is_faithful: 30 steps in one call against 20, then a
    resumed call to 30: the losses and every raw leaf bit for bit (the
    checkpoint carries both moments and the step count)."""
    b_full, l_full, _ = optimize_bank_resumable(_bank(), 30, str(tmp_path / "a"), 10)
    d = str(tmp_path / "b")
    _, l_a, _ = optimize_bank_resumable(_bank(), 20, d, 10)
    b_res, l_b, start = optimize_bank_resumable(_bank(), 30, d, 10)
    assert start == 20 and len(l_b) == 10
    np.testing.assert_array_equal(np.concatenate([l_a, l_b]), l_full)
    for name, raw in _raws(b_full).items():
        assert torch.equal(_raws(b_res)[name], raw), name


def test_torch_bank_only_checkpoint_resumes_with_a_warning(tmp_path):
    """A checkpoint without the Adam state restores the bank with fresh
    moments, under a RuntimeWarning."""
    d = str(tmp_path / "old")
    bank = _bank()
    tck.save_model(d, bank, step=10)
    with pytest.warns(RuntimeWarning, match="optimizer state"):
        _, losses, start = optimize_bank_resumable(_bank(seed=5), 15, d, 10)
    assert start == 10 and len(losses) == 5
    assert losses[0] == pytest.approx(
        optimize_bank_resumable(bank, 1, str(tmp_path / "fresh"), 10)[1][0], rel=1e-12)


def test_torch_resume_from_the_jax_state_follows_jax(tmp_path):
    """The JAX package runs 20 checkpointed steps; its bank and optax Adam
    state are carried into the port (load_raw, load_adam_state) and saved
    as the port's step-20 checkpoint; the port's resumed steps 21-30 and
    its final leaves follow the JAX package's uninterrupted 30 steps within
    1e-10."""
    j_full, jl_full, _ = j_resumable(_j_bank(), 30, str(tmp_path / "j_full"), 10)
    jd = str(tmp_path / "j_part")
    j_resumable(_j_bank(), 20, jd, 10)
    jbank, (jadam, _) = jck.load_model(jd, (_j_bank(), optax.adam(0.01).init(_j_bank())),
                                       step=20)
    bank = _bank()
    load_raw(bank, jax_leaves(jbank))
    adam = Adam(trainable_tensors(bank), lr=0.01)
    load_adam_state(adam, bank, jax_leaves(jadam.mu), jax_leaves(jadam.nu), jadam.count)
    assert adam.t == 20
    d = str(tmp_path / "port")
    tck.save_model(d, (bank, {"m": tuple(adam.m), "v": tuple(adam.v), "t": adam.t}), step=20)
    out, losses, start = optimize_bank_resumable(_bank(), 30, d, 10)
    assert start == 20
    want = np.asarray(jl_full)[20:]
    np.testing.assert_allclose(losses, want, rtol=0, atol=1e-10 * np.abs(want).max())
    jl = jax_leaves(j_full)
    for name, p in named_params(out):
        w = jl[name + "[<flat index 0>]"]
        np.testing.assert_allclose(p.raw.detach().numpy(), w, rtol=0,
                                   atol=1e-10 * max(np.abs(w).max(), 1e-300), err_msg=name)
