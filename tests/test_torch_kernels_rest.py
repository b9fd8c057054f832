"""The rest of the port's kernel zoo and GPR (gpitch_tpu_torch.kernels,
.models.GPR) against gpitch_tpu.

Every kernel is built in both packages from the same arguments; the JAX
kernel's trainable raw leaves get seeded noise and are carried across with
``load_raw``.  All in f64 on the CPU.  Tolerances, of max|ref|: 1e-12 for
the closed forms (K, Kdiag, k_r); 1e-10 for what passes through a
Cholesky (Env, MeanGP, KernelGPR, GPR's log marginal likelihood, its
predictions and its gradient).  ``k_r`` of every stationary kernel is also
held against its own K on a uniform grid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpitch_tpu.kernels as jk
from gpitch_tpu.core.params import Param as JParam
from gpitch_tpu.core.transforms import Positive
from gpitch_tpu.models import GPR as JGPR
import gpitch_tpu_torch.kernels as tk
from gpitch_tpu_torch.core.params import load_raw, named_params
from gpitch_tpu_torch.models import GPR as TGPR

F64 = torch.float64
E4 = np.array([0.5, 0.3, 0.15, 0.05])
F4 = 220.0 * np.arange(1, 5)


def jax_leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def perturbed(tree, seed, scale=0.1):
    """The JAX tree with seeded noise on the raw leaf of every trainable
    Param (data leaves are left as they are)."""
    rng = np.random.default_rng(seed)

    def one(p):
        if not isinstance(p, JParam) or not p.trainable:
            return p
        raw = np.asarray(p.raw)
        return JParam(raw + scale * rng.standard_normal(raw.shape), p.transform, p.trainable)

    return jax.tree_util.tree_map(one, tree, is_leaf=lambda x: isinstance(x, JParam))


def close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def pair(build, seed=0):
    """build(module, **kw) in both packages, the port's raw leaves set to
    the (perturbed) JAX ones."""
    jkern = perturbed(build(jk), seed)
    tkern = build(tk, dtype=F64)
    leaves = jax_leaves(jkern)
    assert load_raw(tkern, leaves) == len(leaves) == len(list(named_params(tkern)))
    return jkern, tkern


# name -> build(module, **kw); stationary kernels have k_r
STATIONARY = {
    "RBF": lambda m, **kw: m.RBF.create(0.8, 0.004, **kw),
    "Matern12": lambda m, **kw: m.Matern12.create(1.1, 0.003, **kw),
    "Matern32": lambda m, **kw: m.Matern32.create(0.9, 0.005, **kw),
    "Matern52": lambda m, **kw: m.Matern52.create(1.2, 0.004, **kw),
    "Cosine": lambda m, **kw: m.Cosine.create(0.7, 300.0, **kw),
    "Gammaexponential": lambda m, **kw: m.Gammaexponential.create(1.0, 0.004, 1.3, **kw),
    "LogisticHat": lambda m, **kw: m.LogisticHat.create(1.0, 0.004, **kw),
    "Matern12sm": lambda m, **kw: m.Matern12sm.create(0.9, 0.01, E4, F4, **kw),
    "MercerMatern12sm": lambda m, **kw: m.MercerMatern12sm.create(1.1, 0.02, E4, F4, **kw),
    "Matern32sm": lambda m, **kw: m.Matern32sm.create(lengthscales=0.3, variances=E4 / 3,
                                                      frequencies=F4, **kw),
    "Matern32sm_default": lambda m, **kw: m.Matern32sm.create(num_partials=3, **kw),
    "Matern32smOld": lambda m, **kw: m.Matern32smOld.create(lengthscales=4.0,
                                                            variances=E4, frequencies=F4, **kw),
    "Matern32sml": lambda m, **kw: m.Matern32sml.create(lengthscales=[0.3, 0.5, 0.8, 1.2],
                                                        variances=E4, frequencies=F4, **kw),
    "Matern32sml_default": lambda m, **kw: m.Matern32sml.create(num_partials=2, **kw),
    "MercerCosMix": lambda m, **kw: m.MercerCosMix.create(E4, F4, 0.2, **kw),
    "Spectrum": lambda m, **kw: m.Spectrum.create(F4, E4, 0.9, **kw),
    "Spectrum2": lambda m, **kw: m.Spectrum2.create(F4, E4, 1.3, **kw),
    "Sum": lambda m, **kw: m.Matern32.create(0.5, 0.004, **kw) + m.MercerCosMix.create(
        E4, F4, 0.2, **kw),
    "StackedSum": lambda m, **kw: m.StackedSum.create(
        [m.Matern12sm.create(0.5 + i, 0.01 * (i + 1), E4, F4 * (1 + 0.2 * i),
                             train_energy=True, **kw) for i in range(3)]),
    "Product": lambda m, **kw: m.Matern52.create(1.0, 0.005, **kw) * m.MercerCosMix.create(
        E4, F4, 0.25, **kw),
}


def _gpr_kernel(m, **kw):
    """KernelGPR over a 12-point GPR with an RBF kernel."""
    rng = np.random.default_rng(3)
    x = np.linspace(0.0, 0.01, 12).reshape(-1, 1)
    y = np.exp(-x / 0.004) + 0.01 * rng.standard_normal((12, 1))
    gpr = (TGPR if m is tk else JGPR).create(x, y, m.RBF.create(1.0, 0.003, **kw), 0.01,
                                             **kw)
    return m.KernelGPR.create(gpr, 0.8, **kw)


OTHERS = {
    "White": lambda m, **kw: m.White.create(0.3, **kw) if m is tk else m.White(
        variance=JParam.create(0.3, Positive())),
    "Constant": lambda m, **kw: m.Constant.create(0.6, **kw) if m is tk else m.Constant(
        variance=JParam.create(0.6, Positive())),
    "Sig": lambda m, **kw: m.Sig.create(300.0, -1.0, **kw),
    "Hann": lambda m, **kw: m.Hann(n=33, fs=16000.0),
    "Env": lambda m, **kw: m.Env.create(np.linspace(0.0, 0.004, 6),
                                        np.linspace(-1.0, 1.0, 6).reshape(-1, 1), 0.002,
                                        1.0, **kw),
    "MeanGP": lambda m, **kw: m.MeanGP.create(np.linspace(0.0, 0.01, 6),
                                              np.exp(-np.linspace(0.0, 0.01, 6) / 0.004),
                                              0.7, plen=0.002, pvar=1.0, **kw),
    "KernelGPR": _gpr_kernel,
}
THROUGH_A_CHOLESKY = {"Env", "MeanGP", "KernelGPR"}


@pytest.fixture
def xs():
    rng = np.random.default_rng(1)
    x = np.sort(rng.random((23, 1)) * 0.01, axis=0)
    x2 = np.sort(rng.random((17, 1)) * 0.01, axis=0)
    return x, x2


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


@pytest.mark.parametrize("name", sorted(STATIONARY) + sorted(OTHERS))
def test_kernel_K_and_Kdiag_match(name, xs):
    build = {**STATIONARY, **OTHERS}[name]
    jkern, tkern = pair(build, seed=len(name))
    rtol = 1e-10 if name in THROUGH_A_CHOLESKY else 1e-12
    x, x2 = xs
    close(tkern.K(_t(x), _t(x2)), jkern.K(jnp.asarray(x), jnp.asarray(x2)), rtol)
    close(tkern.K(_t(x)), jkern.K(jnp.asarray(x)), rtol)
    close(tkern.Kdiag(_t(x)), jkern.Kdiag(jnp.asarray(x)), rtol)


@pytest.mark.parametrize("name", sorted(STATIONARY))
def test_kernel_k_r_matches_jax_and_its_own_K_on_a_grid(name):
    """k_r at the lags of a 16 kHz grid against the JAX package's k_r, and
    the port's k_r at |i - j| grid steps against the port's K on the grid
    (1e-12)."""
    jkern, tkern = pair(STATIONARY[name], seed=len(name) + 7)
    r = np.arange(64) / 16000.0
    close(tkern.k_r(_t(r)), jkern.k_r(jnp.asarray(r)), 1e-12)
    x = (5.0 + np.arange(40)) / 16000.0
    x = x.reshape(-1, 1) - x.min()
    lags = np.abs(np.arange(40)[:, None] - np.arange(40)[None, :])
    close(tkern.k_r(_t(r))[lags], tkern.K(_t(x)).detach().numpy(), 1e-12)


def test_stacked_sum_k_r_terms_and_kern_list_match():
    jkern, tkern = pair(STATIONARY["StackedSum"], seed=11)
    r = np.arange(50) / 16000.0
    close(tkern.k_r_terms(_t(r)), jkern.k_r_terms(jnp.asarray(r)), 1e-12)
    for a, b in zip(tkern.kern_list, jkern.kern_list):
        close(a.k_r(_t(r)), b.k_r(jnp.asarray(r)), 1e-12)
    assert len(tk.unstack_modules(tkern.stacked, 3)) == 3


def test_k_r_of_a_window_batched_stacked_kernel():
    """A StackedSum whose Params carry a window axis (nw, S): k_r of one
    r (L,) is one table per window, each the unbatched kernel's."""
    kerns = [tk.Matern12sm.create(0.5 + i, 0.01 * (i + 1), E4, F4 * (1 + 0.2 * i),
                                  dtype=F64) for i in range(3)]
    one = tk.StackedSum.create(kerns)
    bank = tk.StackedSum(stacked=tk.stack_modules([one.stacked, one.stacked]), num_terms=3)
    r = _t(np.arange(30) / 16000.0)
    tables = bank.k_r(r)
    assert tables.shape == (2, 30)
    close(tables[1], one.k_r(r).detach().numpy(), 1e-15)


def test_distances_match():
    rng = np.random.default_rng(5)
    x, x2 = rng.random((9, 2)), rng.random((6, 2))
    close(tk.sqdist(_t(x), _t(x2)), jk.sqdist(jnp.asarray(x), jnp.asarray(x2)), 1e-12)
    close(tk.euclid_dist(_t(x)), jk.euclid_dist(jnp.asarray(x)), 1e-12)


def test_non_param_and_vars_n_freqs_fixed_match():
    jkern, tkern = pair(lambda m, **kw: m.NonParam.create(5, 0.7, **kw), seed=2)
    close(tkern.K(), jkern.K(), 1e-12)
    jm = jk.Matern32sm.create(num_partials=3).vars_n_freqs_fixed(fix_var=True, fix_freq=False)
    tm = tk.Matern32sm.create(num_partials=3, dtype=F64).vars_n_freqs_fixed(
        fix_var=True, fix_freq=False)
    assert [p.trainable for _, p in named_params(tm)] == [True, False, True]
    assert (jm.variance.trainable, jm.frequency.trainable) == (False, True)


def test_white_and_constant_between_two_input_sets():
    w = tk.White.create(0.3, dtype=F64)
    x, x2 = _t(np.ones((4, 1))), _t(np.ones((3, 1)))
    assert float(w.K(x, x2).abs().max()) == 0.0
    close(w.K(x), 0.3 * np.eye(4), 1e-15)


# ------------------------------------------------------------------ GPR
def _gpr_pair():
    rng = np.random.default_rng(7)
    x = np.sort(rng.random((30, 1)), axis=0)
    y = np.sin(6 * x) + 0.1 * rng.standard_normal((30, 1))
    jm = perturbed(JGPR.create(x, y, jk.Matern32.create(1.0, 0.3), 0.1), seed=4)
    tm = TGPR.create(x, y, tk.Matern32.create(1.0, 0.3, dtype=F64), 0.1, dtype=F64)
    assert load_raw(tm, jax_leaves(jm)) == 5
    return jm, tm


def test_gpr_lml_gradient_and_predictions_match():
    jm, tm = _gpr_pair()
    close(tm.log_marginal_likelihood(), jm.log_marginal_likelihood(), 1e-10)
    close(tm.loss(), jm.loss(), 1e-10)
    xnew = np.linspace(-0.1, 1.1, 17).reshape(-1, 1)
    for got, want in zip(tm.predict_f(_t(xnew)), jax.jit(lambda m, xx: m.predict_f(xx))(
            jm, jnp.asarray(xnew))):
        close(got, want, 1e-10)
    grads = jax_leaves(jax.jit(jax.grad(lambda m: m.log_marginal_likelihood()))(jm))
    tm.log_marginal_likelihood().backward()
    for name, p in named_params(tm):
        if p.trainable:
            close(p.raw.grad, grads[name + "[<flat index 0>]"], 1e-10)


def test_kernel_gpr_and_mean_gp_gradients_match(xs):
    """d K / d(raw leaves) of KernelGPR and MeanGP (a sum of K's entries)
    against jax.grad, within 1e-10 of the largest gradient entry (MeanGP's
    inner variance moves the interpolation only through the jitter: its
    entry is 1e-6 of the largest and made of rounding-sized differences)."""
    x, _ = xs
    for build in (OTHERS["KernelGPR"], OTHERS["MeanGP"]):
        jkern, tkern = pair(build, seed=9)
        want = jax_leaves(jax.jit(jax.grad(lambda k: jnp.sum(k.K(jnp.asarray(x)))))(jkern))
        tkern.K(_t(x)).sum().backward()
        pairs = [(p.raw.grad.numpy(), want[name + "[<flat index 0>]"])
                 for name, p in named_params(tkern) if p.trainable]
        scale = max(np.abs(w).max() for _, w in pairs)
        for got, w in pairs:
            np.testing.assert_allclose(got, w, rtol=0, atol=1e-10 * scale)
