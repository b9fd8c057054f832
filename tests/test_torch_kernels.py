"""The port's kernels and parameters (gpitch_tpu_torch.kernels, .core)
against gpitch_tpu, on the same seeded inputs and raw leaves.

Raw leaves go across with ``load_raw``, keyed by the JAX pytree paths.  All
in f64; covariance builds agree to ~1e-13 relative (the same formula,
summed in another order), so 1e-10 is the stated tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpitch_tpu.core import transforms as jtr
from gpitch_tpu.kernels import MercerMatern12sm as JMercer
from gpitch_tpu.kernels import Matern12sm as JMatern
from gpitch_tpu.kernels import spectral as jspec
from gpitch_tpu.kernels.base import StackedSum as JStacked
from gpitch_tpu.kernels.base import Sum as JSum
from gpitch_tpu.kernels.base import stack_modules as j_stack
from gpitch_tpu_torch.core import transforms as ttr
from gpitch_tpu_torch.core.params import load_raw, named_params
from gpitch_tpu_torch.kernels import MercerMatern12sm as TMercer
from gpitch_tpu_torch.kernels import Matern12sm as TMatern
from gpitch_tpu_torch.kernels import spectral as tspec
from gpitch_tpu_torch.kernels.base import StackedSum as TStacked
from gpitch_tpu_torch.kernels.base import Sum as TSum
from gpitch_tpu_torch.kernels.base import stack_modules as t_stack

RTOL = 1e-10


def jax_leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def perturbed(tree, seed, scale=0.1):
    """The JAX tree with seeded noise on every raw leaf."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return jax.tree_util.tree_unflatten(
        treedef, [np.asarray(l) + scale * rng.standard_normal(np.shape(l))
                  for l in leaves])


def close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _pitch(i, cls, p=4):
    f0 = 200.0 * 1.3 ** i
    e = np.linspace(1.0, 0.2, p)
    kw = {"dtype": torch.float64} if cls in (TMatern, TMercer) else {}
    return cls.create(0.5 + i, 0.05 + 0.02 * i, e / e.sum(), f0 * np.arange(1, p + 1),
                      **kw)


def _port_of(jkern, tkern, seed):
    """Perturb the JAX kernel's raw leaves and copy them into the port's."""
    jkern = perturbed(jkern, seed)
    assert load_raw(tkern, jax_leaves(jkern)) == len(list(named_params(tkern)))
    return jkern, tkern


@pytest.fixture
def xs(rng):
    x = np.sort(rng.uniform(0.0, 0.1, 60)).reshape(-1, 1)
    x2 = np.sort(rng.uniform(0.0, 0.1, 25)).reshape(-1, 1)
    return x, x2


@pytest.mark.parametrize("name", ["Identity", "Positive", "Logistic"])
def test_transforms_match(name, rng):
    jt = getattr(jtr, name)() if name != "Logistic" else jtr.Logistic(0.5, 2.0)
    tt = getattr(ttr, name)() if name != "Logistic" else ttr.Logistic(0.5, 2.0)
    raw = rng.standard_normal(50) * 20.0
    close(tt.forward(torch.as_tensor(raw)), jt.forward(jnp.asarray(raw)), 1e-14)
    y = np.asarray(jt.forward(raw))
    np.testing.assert_allclose(tt.inverse(y), jt.inverse(y), rtol=1e-14, atol=1e-14)


def test_cosine_features_and_mixture_match(xs, rng):
    x, x2 = xs
    e, f = rng.uniform(0.1, 1.0, 5), rng.uniform(50.0, 900.0, 5)
    t = [torch.as_tensor(a) for a in (x, x2, e, f)]
    close(tspec.cosine_features(t[0], t[2], t[3]), jspec.cosine_features(x, e, f))
    close(tspec.cos_mixture(t[0], t[1], t[2], t[3]), jspec.cos_mixture(x, x2, e, f))
    close(tspec.cos_mixture(t[0], None, t[2], t[3]), jspec.cos_mixture(x, None, e, f))


@pytest.mark.parametrize("jcls,tcls", [(JMatern, TMatern), (JMercer, TMercer)])
def test_matern12sm_matches(jcls, tcls, xs):
    x, x2 = xs
    jk, tk = _port_of(_pitch(1, jcls), _pitch(1, tcls), seed=1)
    X, X2 = torch.as_tensor(x), torch.as_tensor(x2)
    close(tk.K(X), jk.K(x))
    close(tk.K(X, X2), jk.K(x, x2))
    close(tk.Kdiag(X), jk.Kdiag(x))
    with torch.no_grad():
        close(tk.K_fwd(X, X2), jk.K(x, x2))
    assert [p.trainable for _, p in named_params(tk)] == \
        [p.trainable for p in (jk.variance, jk.lengthscales, jk.energy, jk.frequency)]


def test_stacked_sum_matches(xs):
    """K, Kdiag, K_terms, Kdiag_terms, and the forward-only builds through
    the specmix plain version, against the JAX StackedSum."""
    x, x2 = xs
    jk, tk = _port_of(JStacked.create([_pitch(i, JMercer) for i in range(3)]),
                      TStacked.create([_pitch(i, TMercer) for i in range(3)]), seed=2)
    X, X2 = torch.as_tensor(x), torch.as_tensor(x2)
    close(tk.K(X), jk.K(x))
    close(tk.K(X, X2), jk.K(x, x2))
    close(tk.Kdiag(X), jk.Kdiag(x))
    close(tk.K_terms(X, X2), jk.K_terms(x, x2))
    close(tk.Kdiag_terms(X), jk.Kdiag_terms(x))
    with torch.no_grad():
        close(tk.K_fwd(X, X2), jk.K(x, x2))
        close(tk.K_terms_fwd(X, X2), jk.K_terms(x, x2))
        close(tk.K_terms_fwd(X, X2, slice(1, 3)), jk.K_terms(x, x2)[1:])


def test_stacked_sum_window_batched_matches_vmap(rng):
    """A window axis in front of the term axis (the bank layout): one
    batched build equals the JAX vmap over windows."""
    nw = 4
    jk = JStacked.create([_pitch(i, JMercer) for i in range(3)])
    jbank = jax.tree_util.tree_map(lambda a: np.broadcast_to(a, (nw,) + a.shape).copy(), jk)
    tk = TStacked.create([_pitch(i, TMercer) for i in range(3)])
    from gpitch_tpu_torch.core.params import Param, map_params
    tbank = map_params(tk, lambda p: Param(p.raw.expand((nw,) + p.raw.shape).clone(),
                                           p.transform, p.trainable))
    jbank, tbank = _port_of(jbank, tbank, seed=3)
    x = np.sort(rng.uniform(0.0, 0.1, (nw, 40, 1)), axis=1)
    z = np.sort(rng.uniform(0.0, 0.1, (nw, 12, 1)), axis=1)
    X, Z = torch.as_tensor(x), torch.as_tensor(z)
    close(tbank.K(Z, X), jax.vmap(lambda k, a, b: k.K(a, b))(jbank, z, x))
    close(tbank.K_terms(Z), jax.vmap(lambda k, a: k.K_terms(a))(jbank, z))
    close(tbank.Kdiag(X), jax.vmap(lambda k, a: k.Kdiag(a))(jbank, x))
    with torch.no_grad():
        close(tbank.K_terms_fwd(X), jax.vmap(lambda k, a: k.K_terms(a))(jbank, x))


def test_sum_of_kernels_matches(xs):
    x, x2 = xs
    jk, tk = _port_of(JSum(kern_list=(_pitch(0, JMercer), _pitch(1, JMercer, p=2))),
                      TSum(kern_list=(_pitch(0, TMercer), _pitch(1, TMercer, p=2))),
                      seed=4)
    X, X2 = torch.as_tensor(x), torch.as_tensor(x2)
    close(tk.K(X, X2), jk.K(x, x2))
    close(tk.Kdiag(X), jk.Kdiag(x))
    with torch.no_grad():
        close(tk.K_fwd(X, X2), jk.K(x, x2))


def test_stack_modules_matches_and_rejects_mixed_shapes():
    kerns = [_pitch(i, TMercer) for i in range(3)]
    want = jax_leaves(j_stack([_pitch(i, JMercer) for i in range(3)]))
    got = {name: p.raw.detach().numpy() for name, p in named_params(t_stack(kerns))}
    assert sorted(got) == sorted(k.split("[")[0] for k in want)
    for key, arr in want.items():
        np.testing.assert_allclose(got[key.split("[")[0]], arr, rtol=1e-15)
    with pytest.raises(ValueError):
        t_stack([_pitch(0, TMercer, p=3), _pitch(1, TMercer, p=4)])


def test_load_raw_rejects_unknown_paths_and_shapes():
    tk = _pitch(0, TMercer)
    with pytest.raises(AttributeError):
        load_raw(tk, {".nothing[<flat index 0>]": np.zeros(1)})
    with pytest.raises(ValueError):
        load_raw(tk, {".energy[<flat index 0>]": np.zeros(7)})
