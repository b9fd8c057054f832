"""The last names of the JAX package's exports that the port lacked, held
against gpitch_tpu in f64 on the CPU: the transform instances ``positive``
and ``identity``, ``native.overlap_add_native`` (the C++ library and its
numpy fallback), the reference's names ``SGPR.build_likelihood``,
``ModGP.build_prior_kl`` and ``ModGP.build_likelihood``, and
``Param.with_value`` / ``Param.with_trainable``."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpitch_tpu import native as jnative
from gpitch_tpu.core import transforms as jtr
from gpitch_tpu.core.params import Param as JParam
from gpitch_tpu_torch import native as tnative
from gpitch_tpu_torch.audio.windowing import ola_weights, overlap_add
from gpitch_tpu_torch.core import transforms as ttr
from gpitch_tpu_torch.core.params import Param

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__))))
from test_torch_lbfgs import _sgpr_pair  # noqa: E402
from test_torch_svgp import _jax_golden, _port_of  # noqa: E402

F64 = torch.float64


def test_torch_positive_and_identity_instances_match_jax():
    assert isinstance(ttr.positive, ttr.Positive) and isinstance(ttr.identity, ttr.Identity)
    assert ttr.positive.lower == jtr.positive.lower
    x = np.linspace(-40.0, 40.0, 81)
    y = np.linspace(1e-5, 50.0, 81)
    for t, j in ((ttr.positive, jtr.positive), (ttr.identity, jtr.identity)):
        np.testing.assert_allclose(t.forward(torch.as_tensor(x)).numpy(),
                                   np.asarray(j.forward(jnp.asarray(x))), rtol=1e-14)
        np.testing.assert_allclose(t.inverse(y), j.inverse(y), rtol=1e-14)


@pytest.mark.parametrize("route", ["library", "numpy"])
@pytest.mark.parametrize("squared", [False, True])
def test_torch_overlap_add_native_matches_jax(route, squared, monkeypatch):
    """The library's merge, and without it audio.windowing's numpy version,
    equal the JAX package's overlap_add_native (tests/test_native.py:77)."""
    if route == "library":
        assert tnative.load_library() is not None and jnative.load_library() is not None
    else:
        monkeypatch.setitem(tnative._LIB, "handle", None)
        monkeypatch.setitem(tnative._LIB, "tried", True)
        monkeypatch.setitem(jnative._LIB, "handle", None)
        monkeypatch.setitem(jnative._LIB, "tried", True)
    ws, nw = 201, 6
    n = (ws - 1) // 2 * (nw - 1) + ws
    wins = np.random.default_rng(0).standard_normal((nw, ws))
    got = tnative.overlap_add_native(wins, n, squared=squared)
    np.testing.assert_allclose(got, jnative.overlap_add_native(wins, n, squared=squared),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, overlap_add(wins, n, ola_weights(nw, ws, squared)),
                               rtol=0, atol=1e-12)


def test_torch_sgpr_build_likelihood_is_the_bound_as_in_jax():
    jm, tm = _sgpr_pair()
    got = tm.build_likelihood()
    assert torch.equal(got, tm.elbo())
    np.testing.assert_allclose(got.item(), float(jm.build_likelihood()), rtol=1e-9)


def test_torch_modgp_build_names_are_prior_kl_and_elbo_as_in_jax():
    jm, x, y = _jax_golden()
    tm = _port_of(jm)
    assert torch.equal(tm.build_prior_kl(), tm.prior_kl())
    assert torch.equal(tm.build_likelihood(x, y), tm.elbo(x, y))
    np.testing.assert_allclose(tm.build_prior_kl().item(), float(jm.build_prior_kl()),
                               rtol=1e-10)
    np.testing.assert_allclose(tm.build_likelihood(x, y, num_data=4 * len(x)).item(),
                               float(jm.build_likelihood(x, y, num_data=4 * len(x))),
                               rtol=1e-10)


@pytest.mark.parametrize("transform", ["identity", "positive", "logistic"])
def test_torch_param_with_value_and_with_trainable_match_jax(transform):
    """with_value: the same raw as the JAX package's, from a host value and
    from a tensor (through which a gradient flows, as through JAX's); the
    value read back; with_trainable keeps the raw and sets the flag."""
    tt, jt = {"identity": (ttr.Identity(), jtr.Identity()),
              "positive": (ttr.Positive(), jtr.Positive()),
              "logistic": (ttr.Logistic(0.1, 3.0), jtr.Logistic(0.1, 3.0))}[transform]
    start, new = np.array([0.5, 1.5, 2.5]), np.array([0.2, 1.1, 2.9])
    tp = Param.create(start, tt, dtype=F64)
    jp = JParam.create(start, jt, dtype=jnp.float64)
    jw = jp.with_value(new)
    for value in (new, torch.as_tensor(new)):
        tw = tp.with_value(value)
        assert tw.transform == tt and tw.trainable and tw.raw.dtype == F64
        np.testing.assert_allclose(tw.raw.detach().numpy(), np.asarray(jw.raw), rtol=1e-13)
        np.testing.assert_allclose(tw.value.detach().numpy(), new, rtol=1e-13)
    v = torch.as_tensor(new).requires_grad_(True)
    (g,) = torch.autograd.grad(tp.with_value(v).value.sum(), v)
    (jg,) = jax.grad(lambda u: jp.with_value(u).value.sum(), argnums=(0,))(jnp.asarray(new))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-10)
    frozen = tp.with_trainable(False)
    assert not frozen.trainable and not frozen.raw.requires_grad
    assert torch.equal(frozen.raw, tp.raw) and frozen.transform == tt
    assert jp.with_trainable(False).trainable is False
    assert frozen.with_trainable(True).raw.requires_grad
