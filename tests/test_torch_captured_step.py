"""The port's one-dispatch Adam segment (gpitch_tpu_torch.models.fit.AdamSteps)
against gpitch_tpu's jitted segments, run on the CPU as the card's capture
runs it: the same step function, with the Adam count on the device, the
loss written into a device buffer at that count and, for a chunked bank,
one set of static leaves padded to whole chunks, but eagerly.

Bank input: 5 windows of 201 samples at 16 kHz (hop 100), 16 inducing
points each, y = sin(2 pi 300 x) + 0.1 N(0, 1) from
``np.random.default_rng(0)``, a StackedSum of three 4-partial
MercerMatern12sm (the fused route's plain versions), f64.  Tolerances: the
losses within 1e-9 relative and the raw leaves within 1e-9 of their largest
magnitude against the JAX package; the Adam arithmetic, resume and the
eager loop of the parent tree bit for bit.
"""

import dataclasses
from typing import Any

import jax
import numpy as np
import pytest
import torch

from gpitch_tpu.kernels import MercerMatern12sm as JMercer
from gpitch_tpu.models.fit import fit_adam_segmented as j_fit_adam_segmented
from gpitch_tpu.pipelines import windowed_sgpr as jws
from gpitch_tpu_torch.core import quadrature, transforms
from gpitch_tpu_torch.core.params import Param, copy_params, named_params, trainable_tensors
from gpitch_tpu_torch.kernels import MercerMatern12sm as TMercer
from gpitch_tpu_torch.linalg import _cuda
from gpitch_tpu_torch.models import fit, sgpr
from gpitch_tpu_torch.pipelines import optimize_bank_resumable
from gpitch_tpu_torch.pipelines import windowed_sgpr as tws
from gpitch_tpu_torch.utils import checkpoint as tck

F64 = torch.float64


def _kerns(cls, **kw):
    out = []
    for i in range(3):
        e = np.linspace(1.0, 0.3, 4)
        out.append(cls.create(0.6 + 0.3 * i, 0.05 + 0.03 * i, e / e.sum(),
                              (220.0 + 60.0 * i) * np.arange(1, 5), **kw))
    return out


def _banks(nw=5, ws=201, m=16):
    rng = np.random.default_rng(0)
    n = ws + (nw - 1) * 100
    x = np.arange(n) / 16000.0 + 2.0
    y = np.sin(2 * np.pi * 300 * x) + 0.1 * rng.standard_normal(n)
    idx = np.arange(nw)[:, None] * 100 + np.arange(ws)[None, :]
    xw, yw = x[idx], y[idx]
    zw = np.stack([np.sort(rng.choice(xw[i], m, replace=False)) for i in range(nw)])[..., None]
    jb = jws.build_window_bank(xw, yw, zw, lambda: jws.sum_kernel(_kerns(JMercer)),
                               grid_dt=1 / 16000.0)
    tb = tws.build_window_bank(xw, yw, zw, lambda: tws.sum_kernel(_kerns(TMercer, dtype=F64)),
                               grid_dt=1 / 16000.0, dtype=F64, device="cpu")
    return jb, tb


def _jax_leaves(tree):
    return {jax.tree_util.keystr(p).split("[")[0]: np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_leaves_close(tmodel, jmodel, tol=1e-9):
    want = _jax_leaves(jmodel)
    for name, p in named_params(tmodel):
        got, w = p.raw.detach().numpy(), want[name]
        assert got.shape == w.shape, name
        np.testing.assert_allclose(got, w, rtol=0, atol=tol * max(np.abs(w).max(), 1e-300),
                                   err_msg=name)


class _HostCountAdam:
    """The parent tree's Adam: a host int count, the bias corrections as
    Python floats, one addcdiv."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = list(params), lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        grads = [p.grad for p in self.params]
        t = self.t + 1
        m = torch._foreach_lerp(self.m, grads, 1.0 - self.b1)
        v = torch._foreach_mul(self.v, self.b2)
        torch._foreach_addcmul_(v, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_sqrt(v)
        torch._foreach_div_(denom, float(np.sqrt(1.0 - self.b2 ** t)))
        torch._foreach_add_(denom, self.eps)
        params = torch._foreach_addcdiv(self.params, m, denom,
                                        value=-self.lr / (1.0 - self.b1 ** t))
        torch._foreach_copy_(self.params, params)
        self.m, self.v, self.t = m, v, t


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_adam_with_the_device_count_is_the_host_count_arithmetic(dtype):
    """500 steps on four leaves (a 0-d one among them) with gradients of
    scales 1e-3 to 1e3: leaves and moments equal the host-count Adam's bit
    for bit; the count is a 0-d int64 tensor on the leaves' device."""
    g = torch.Generator().manual_seed(0)
    shapes = [(7,), (3, 5, 33), (), (64, 17)]
    a_leaves = [torch.randn(s, generator=g, dtype=dtype) for s in shapes]
    b_leaves = [t.clone() for t in a_leaves]
    new, old = fit.Adam(a_leaves, 0.01), _HostCountAdam(b_leaves, 0.01)
    assert new.t.dtype == torch.int64 and new.t.dim() == 0
    assert new.t.device == a_leaves[0].device
    for i in range(500):
        for a, b, s in zip(a_leaves, b_leaves, shapes):
            a.grad = torch.randn(s, generator=g, dtype=dtype) * 10.0 ** (i % 7 - 3)
            b.grad = a.grad.clone()
        new.step()
        old.step()
        for x, y in zip(a_leaves + list(new.m) + list(new.v),
                        b_leaves + list(old.m) + list(old.v)):
            assert torch.equal(x, y), i
    assert int(new.t) == old.t == 500


def _parent_eager_loop(model, loss_fn, num_steps, lr, batch_fn=None):
    """The parent tree's adam_segments without its fences: one eager step
    after another with the host-count Adam."""
    model = copy_params(model)
    opt = _HostCountAdam(trainable_tensors(model), lr)
    out = []
    for _ in range(num_steps):
        for p in opt.params:
            p.grad = None
        loss = loss_fn(model) if batch_fn is None else loss_fn(model, *batch_fn())
        loss.backward()
        opt.step()
        out.append(loss.detach())
    return model, torch.stack(out).numpy()


def test_adam_steps_equal_the_parent_eager_loop_bit_for_bit():
    """fit_adam_segmented (AdamSteps, segments of 4 of 10 steps) on the bank
    equals the parent tree's eager loop bit for bit: losses and leaves."""
    _, tb = _banks()
    got, gl, _, _ = fit.fit_adam_segmented(tb, tws.bank_loss, 10, 0.01, segment=4)
    want, wl = _parent_eager_loop(tb, tws.bank_loss, 10, 0.01)
    assert np.array_equal(gl, wl)
    for (_, a), (_, b) in zip(named_params(got), named_params(want)):
        assert torch.equal(a.raw, b.raw)


@dataclasses.dataclass
class _Mean:
    w: Any = None


def test_minibatch_steps_equal_the_parent_eager_loop_bit_for_bit():
    """With a minibatch draw in the step (minibatch_fn, a seeded generator)
    the steps and their draws equal the parent tree's loop bit for bit, and
    fit_adam_timed's second run (the same runner loaded again, the
    generator restored) equals its first."""
    x = torch.arange(40, dtype=F64)[:, None]
    y = torch.sin(x / 3.0)
    model = _Mean(w=Param(torch.zeros(1, dtype=F64)))

    def loss_fn(m, xb, yb):
        return ((m.w.value - yb * xb / 40.0) ** 2).sum()

    def batch(seed):
        return fit.minibatch_fn(x, y, 8, torch.Generator().manual_seed(seed))

    _, gl = fit.fit_adam(model, loss_fn, 25, 0.05, batch(3))
    _, wl = _parent_eager_loop(model, loss_fn, 25, 0.05, batch(3))
    assert np.array_equal(gl, wl) and len(np.unique(gl)) > 20
    _, tl, _, _ = fit.fit_adam_timed(model, loss_fn, 25, 0.05, batch(3))
    assert np.array_equal(tl, gl)


@pytest.mark.parametrize("num_steps,segment", [(10, 4), (8, 8), (9, 100)])
def test_adam_steps_match_jax_fit_adam_segmented(num_steps, segment):
    """The whole bank against the JAX package's fit_adam_segmented (one
    segment-length scan re-invoked, its last segment masked where
    ``segment`` does not divide ``num_steps``): losses within 1e-9, leaves
    within 1e-9 of their largest magnitude."""
    jb, tb = _banks()
    jmodel, jl, _, _ = j_fit_adam_segmented(jb, jws.bank_loss, num_steps=num_steps,
                                            learning_rate=0.01, segment=segment)
    tmodel, tl, _, _ = fit.fit_adam_segmented(tb, tws.bank_loss, num_steps, 0.01,
                                              segment=segment)
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-9)
    _assert_leaves_close(tmodel, jmodel)


@pytest.mark.parametrize("window_chunk,num_steps,segment",
                         [(2, 7, 3), (3, 6, 6), (5, 4, 3), (4, 5, 2)])
def test_chunked_bank_matches_jax_optimize_bank_chunked(window_chunk, num_steps, segment):
    """optimize_bank in chunks against the JAX package's
    _optimize_bank_chunked (both pad the window axis to a multiple of
    window_chunk by copies of the last window and leave the pad out of the
    losses): nw 5 with chunks of 2, 3 and 4 pads, of 5 does not; segments
    that do not divide the steps.  Losses within 1e-9, leaves within 1e-9
    of their largest magnitude."""
    jb, tb = _banks()
    jmodel, jl = jws.optimize_bank(jb, num_steps=num_steps, learning_rate=0.01,
                                   segment=segment, window_chunk=window_chunk)
    tmodel, tl = tws.optimize_bank(tb, num_steps, 0.01, segment=segment,
                                   window_chunk=window_chunk)
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-9)
    assert tmodel.X.raw.shape[0] == 5
    _assert_leaves_close(tmodel, jmodel)


def test_one_static_step_serves_every_chunk(monkeypatch):
    """A chunked run builds one AdamSteps on one chunk's static leaves and
    loads each later chunk into them (3 chunks of 2 for 5 windows, the last
    padded), and its windows equal the unchunked run's within 1e-12."""
    made, loads = [], []

    class Counting(fit.AdamSteps):
        def __init__(self, model, *a, **kw):
            made.append(model.X.raw.shape[0])
            super().__init__(model, *a, **kw)

        def load(self, model, count=0):
            loads.append(model.X.raw.shape[0])
            super().load(model, count)

    monkeypatch.setattr(tws, "AdamSteps", Counting)
    _, tb = _banks()
    chunked, lc = tws.optimize_bank(tb, 4, 0.01, window_chunk=2)
    assert made == [2] and loads == [2, 2]
    whole, lw = tws.optimize_bank(tb, 4, 0.01)
    np.testing.assert_allclose(lc, lw, rtol=1e-12)
    for (_, a), (_, b) in zip(named_params(chunked), named_params(whole)):
        np.testing.assert_allclose(a.raw.detach().numpy(), b.raw.detach().numpy(),
                                   rtol=1e-12, atol=1e-14)


def _raws(model):
    return {name: p.raw.detach().clone() for name, p in named_params(model)}


@pytest.mark.parametrize("count_form", ["device", "host_int"])
def test_resume_with_the_device_count_is_bit_for_bit(tmp_path, count_form):
    """30 steps in one call against 20 and a resumed 10, checkpointed every
    10: losses and leaves bit for bit.  The checkpoint holds the count as a
    0-d int64 array, as it did when the count was a host int; a checkpoint
    whose count was written as an int resumes alike."""
    _, tb = _banks(nw=3)
    _, full, _ = optimize_bank_resumable(tb, 30, str(tmp_path / "a"), 10)
    d = str(tmp_path / "b")
    optimize_bank_resumable(tb, 20, d, 10)
    saved = np.load(f"{d}/20.npz")
    assert saved["[1]['t']"].dtype == np.int64 and saved["[1]['t']"].shape == ()
    assert int(saved["[1]['t']"]) == 20
    if count_form == "host_int":
        like = (tb, {"m": tuple(trainable_tensors(tb)), "v": tuple(trainable_tensors(tb)),
                     "t": torch.zeros((), dtype=torch.int64)})
        bank, state = tck.load_model(d, like, step=20)
        tck.save_model(d, (bank, {"m": state["m"], "v": state["v"], "t": int(state["t"])}),
                       step=20)
    bank, rest, start = optimize_bank_resumable(tb, 30, d, 10)
    assert start == 20 and np.array_equal(rest, full[20:])
    whole, _, _ = optimize_bank_resumable(tb, 30, str(tmp_path / "a"), 10)
    for name, raw in _raws(whole).items():
        assert torch.equal(_raws(bank)[name], raw), name


def test_step_constants_are_cached_tensors_equal_to_their_former_values():
    """The constants a step reads are made once per (value, dtype, device)
    and are the same tensors on every call, holding what the parent tree
    made at each call: the Gauss-Hermite nodes and weights, the H^D grid,
    FillTriangular's index tensors and the bound's data count."""
    cpu = torch.device("cpu")
    a, b = quadrature.hermgauss(20, F64, "cpu"), quadrature.hermgauss(20, F64, cpu)
    assert a[0] is b[0] and a[1] is b[1]
    x, w = np.polynomial.hermite.hermgauss(20)
    assert np.array_equal(a[0].numpy(), x) and np.array_equal(a[1].numpy(), w / np.sqrt(np.pi))

    means = torch.tensor([[0.1, -0.2], [0.3, 0.4]], dtype=F64)
    covs = torch.eye(2, dtype=F64).expand(2, 2, 2) * 0.5
    (g1, w1), (g2, w2) = quadrature.mvhermgauss(means, covs, 5, 2), \
        quadrature.mvhermgauss(means, covs, 5, 2)
    assert w1 is w2 and torch.equal(g1, g2)
    raw_x, raw_w = np.polynomial.hermite.hermgauss(5)
    wn = np.prod(np.array(np.meshgrid(raw_w, raw_w, indexing="ij")).reshape(2, -1), 0)
    np.testing.assert_array_equal(w1.numpy(), wn * np.pi ** -1.0)

    ft = transforms.FillTriangular(4)
    i1 = transforms._tril_slot_tensors(4, cpu)
    y = torch.arange(16, dtype=F64).reshape(4, 4)
    assert torch.equal(ft.inverse_tensor(y), torch.as_tensor(ft.inverse(y.numpy())))
    assert transforms._tril_slot_tensors(4, cpu)[0] is i1[0]
    k = np.arange(10)
    slots = np.concatenate([k[4:], k[::-1]]).reshape(4, 4)
    ii, jj = np.tril_indices(4)
    order = np.argsort(slots[ii, jj])
    assert np.array_equal(i1[0].numpy(), ii[order]) and np.array_equal(i1[1].numpy(), jj[order])
    packed = torch.arange(10, dtype=F64)
    assert torch.equal(ft.inverse_tensor(ft.forward(packed)), packed)

    _, tb = _banks(nw=2)
    before = sgpr._constant.cache_info()
    tb.elbo()
    tb.elbo()
    n = sgpr._constant(201.0, F64, cpu)
    assert sgpr._constant(201.0, F64, cpu) is n and float(n) == 201.0 and n.dtype == F64
    assert sgpr._constant.cache_info().hits >= before.hits + 2


def test_launch_record_counts_replays_not_captures():
    """A wrapper's count less its calls made while capturing, plus the
    captured calls times the replays, is what ran on the card."""
    saved = _cuda.launch_counts()
    try:
        _cuda.reset_launches()
        fn = _cuda.COUNTED["cholesky_batched"]
        fn.launches = 3 + 2                 # 3 eager launches, 2 calls captured
        _cuda.record_capture({"cholesky_batched": 2})
        _cuda.record_replays({"cholesky_batched": 2}, 7)
        assert _cuda.device_launches()["cholesky_batched"] == 3 + 2 * 7
        assert _cuda.GRAPHS["graphs"] == 1 and _cuda.GRAPHS["replays"] == 7
        _cuda.reset_launches()
        assert _cuda.device_launches()["cholesky_batched"] == 0
    finally:
        for name, n in saved.items():
            _cuda.COUNTED[name].launches = n
