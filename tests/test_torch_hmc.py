"""The port's HMC (gpitch_tpu_torch.models.hmc) against gpitch_tpu.models.hmc.

Replay: the JAX package's key splits (hmc.py:159-162 init jitter, 132-133
the per-chain step keys, 86 each step's (momentum, uniform) pair, 44-51 a
key per leaf) are recomputed here with jax.random, and those normals and
uniforms are fed to the port's sampler core; its chains then match
``hmc_sample``'s within 1e-8 (f64, CPU) on the correlated Gaussian, the
anisotropic Gaussian with mass adaptation (num_warmup >= 20) and the tiny
ModGP of test_hmc_over_kernel_hypers.  Statistics: the three JAX HMC tests
again with the port's own generator, at their thresholds.
``model_logprob_fn``: value and gradient against JAX's within 1e-12 for a
ModGP and a window bank; the chain-folded bank equals a chain-at-a-time
evaluation within 1e-12.  Divergence: a chain that diverges rejects, and the
other chains are bit-for-bit those of a run without it.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpitch_tpu.core.params import Param as JParam
from gpitch_tpu.models.hmc import hmc_sample as j_hmc_sample
from gpitch_tpu.models.hmc import model_logprob_fn as j_model_logprob_fn
from gpitch_tpu.pipelines.windowed_sgpr import bank_loss as j_bank_loss
from gpitch_tpu_torch.core.params import load_raw, named_params, with_raw
from gpitch_tpu_torch.kernels import Matern32 as TMatern32
from gpitch_tpu_torch.kernels import MercerMatern12sm as TMercer
from gpitch_tpu_torch.models import ModGP, hmc_sample, model_logprob_fn
from gpitch_tpu_torch.models.hmc import _hmc_core

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from test_svgp import make_model, synth_data  # noqa: E402
from test_torch_lbfgs import _bank_pair, jax_leaves  # noqa: E402

F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    """Thousands of tiny torch ops: one intra-op thread each, so they do not
    spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_noise(key, init: dict, num_chains: int, num_warmup: int, num_samples: int):
    """The noise ``hmc_sample`` draws from ``key``, in the port core's
    layout: init normals (C, ...), momentum normals (T, C, ...) and
    uniforms (T, C), T = num_warmup + num_samples."""
    names = [k for k in sorted(init)]          # a dict's leaves, in jax's order
    keys = jax.random.split(key, num_chains + 1)
    total = num_warmup + num_samples
    inits = {k: np.stack([np.asarray(jax.random.normal(keys[1 + c], init[k].shape,
                                                       init[k].dtype))
                          for c in range(num_chains)]) for k in names}
    mom = {k: np.zeros((total, num_chains) + init[k].shape) for k in names}
    unif = np.zeros((total, num_chains))
    for c in range(num_chains):
        step_keys = jax.random.split(keys[1 + c], total + 1)
        for t in range(total):
            k1, k2 = jax.random.split(step_keys[t])
            leaf_keys = jax.random.split(k1, len(names))
            for i, k in enumerate(names):
                mom[k][t, c] = np.asarray(jax.random.normal(leaf_keys[i], init[k].shape,
                                                            init[k].dtype))
            unif[t, c] = float(jax.random.uniform(k2))
    t = {k: torch.as_tensor(v) for k, v in inits.items()}
    return t, {k: torch.as_tensor(v) for k, v in mom.items()}, torch.as_tensor(unif)


# ------------------------------------------------------------------ targets
COV = np.array([[1.0, 0.6], [0.6, 1.0]])
MEAN = np.array([1.0, -2.0])
STD = np.array([0.05, 20.0])
AMEAN = np.array([2.0, -30.0])


def j_correlated(q):
    d = q["theta"] - MEAN
    return -0.5 * d @ jnp.linalg.inv(COV) @ d


def t_correlated(q):
    d = q["theta"] - torch.as_tensor(MEAN)
    return -0.5 * ((d @ torch.as_tensor(np.linalg.inv(COV))) * d).sum(-1)


def j_anisotropic(q):
    return -0.5 * jnp.sum(jnp.square((q["theta"] - AMEAN) / STD))


def t_anisotropic(q):
    return -0.5 * ((q["theta"] - torch.as_tensor(AMEAN)) / torch.as_tensor(STD)).square().sum(-1)


def _modgp_pair():
    """test_hmc_over_kernel_hypers' ModGP (s 1, M 8, 80 points) in both
    packages, the port's leaves carried from JAX's."""
    jm = make_model(s=1, m=8)
    x, y, _, _ = synth_data(80)
    z = np.zeros((8, 1))
    tm = ModGP.create(z=[[z], [z]], kern=[[TMatern32.create(dtype=F64)],
                                          [TMercer.create(1.0, 1.0, [1.0, 1.0], [1.0, 1.0],
                                                          dtype=F64)]],
                      dtype=F64, device="cpu")
    assert load_raw(tm, jax_leaves(jm)) == len(list(named_params(tm)))
    return jm, tm, np.array(x), np.array(y)


def _j_log_ls(m, leaves):
    """test_hmc_over_kernel_hypers' substitution: lengthscale exp(log_ls)."""
    kc = m.kern_com
    return m.replace(kern_com=kc.replace(
        lengthscales=kc.lengthscales.with_value(jnp.exp(leaves["log_ls"]))))


def _t_sub(m, leaves):
    """The port's ``_j_log_ls``: the lengthscale set to exp(log_ls)."""
    import dataclasses
    kc = m.kern_com
    return dataclasses.replace(m, kern_com=dataclasses.replace(
        kc, lengthscales=kc.lengthscales.with_value(torch.exp(leaves["log_ls"]))))


def _replay_case(name):
    if name == "correlated":
        init = {"theta": np.zeros(2)}
        kw = dict(num_warmup=20, num_samples=6, num_leapfrog=4, num_chains=2)
        return j_correlated, t_correlated, init, jax.random.PRNGKey(0), kw
    if name == "anisotropic":
        init = {"theta": AMEAN + np.array([0.1, 5.0])}
        kw = dict(num_warmup=20, num_samples=6, num_leapfrog=4, num_chains=2,
                  jitter_init=0.01)
        return j_anisotropic, t_anisotropic, init, jax.random.PRNGKey(3), kw
    jm, tm, x, y = _modgp_pair()
    init = {"log_ls": np.log(np.asarray(jm.kern_com.lengthscales.value))}
    jfn = j_model_logprob_fn(jm, _j_log_ls, jnp.asarray(x), jnp.asarray(y), prior_scale=1.0)
    tfn = model_logprob_fn(tm, _t_sub, torch.as_tensor(x), torch.as_tensor(y), prior_scale=1.0)
    kw = dict(num_warmup=20, num_samples=6, num_leapfrog=4, num_chains=2)
    return jfn, tfn, init, jax.random.PRNGKey(1), kw


@pytest.mark.parametrize("name", ["correlated", "anisotropic", "modgp"])
def test_torch_hmc_replays_jax_chains(name):
    """The port's core on the JAX package's own draws gives its chains:
    samples within 1e-8 of max|ref|, the accept rates equal."""
    jfn, tfn, init, key, kw = _replay_case(name)
    jinit = {k: jnp.asarray(v) for k, v in init.items()}
    jsamples, jrates = j_hmc_sample(jfn, jinit, key, **kw)
    inits, mom, unif = jax_noise(key, init, kw["num_chains"], kw["num_warmup"],
                                 kw["num_samples"])
    tsamples, trates = _hmc_core(
        tfn, {k: torch.as_tensor(v) for k, v in init.items()}, inits, mom, unif,
        kw["num_warmup"], kw["num_samples"], kw["num_leapfrog"], 0.01, 0.8,
        kw.get("jitter_init", 0.1), True)
    for k in init:
        want = np.asarray(jsamples[k])
        got = tsamples[k].numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-8 * np.abs(want).max())
    np.testing.assert_allclose(trates.numpy(), np.asarray(jrates), rtol=0, atol=1e-7)


def test_torch_hmc_gaussian_target():
    """test_hmc_gaussian_target with the port's generator: every rate > 0.5,
    the mean within 0.1, the covariance within 0.2."""
    samples, rates = hmc_sample(t_correlated, {"theta": torch.zeros(2, dtype=F64)},
                                torch.Generator().manual_seed(0), num_samples=1500,
                                num_warmup=500, num_leapfrog=12, num_chains=4)
    th = samples["theta"].reshape(-1, 2).numpy()
    assert float(rates.min()) > 0.5
    np.testing.assert_allclose(th.mean(0), MEAN, atol=0.1)
    np.testing.assert_allclose(np.cov(th.T), COV, atol=0.2)


def test_torch_hmc_mass_adaptation_anisotropic():
    """test_hmc_mass_adaptation_anisotropic with the port's generator: the
    400x badly scaled Gaussian mixes; mean within 0.25 sd, std within 35%."""
    init = {"theta": torch.as_tensor(AMEAN + np.array([0.1, 5.0]))}
    samples, rates = hmc_sample(t_anisotropic, init, torch.Generator().manual_seed(3),
                                num_samples=800, num_warmup=400, num_leapfrog=12,
                                num_chains=4, jitter_init=0.01)
    th = samples["theta"].reshape(-1, 2).numpy()
    assert float(rates.min()) > 0.5
    err = np.abs(th.mean(0) - AMEAN) / STD
    assert (err < 0.25).all(), err
    np.testing.assert_allclose(th.std(0), STD, rtol=0.35)


def test_torch_hmc_over_kernel_hypers():
    """test_hmc_over_kernel_hypers with the port's generator: the sampled
    lengthscales finite and positive, every rate > 0.2."""
    jm, tm, x, y = _modgp_pair()
    tfn = model_logprob_fn(tm, _t_sub, torch.as_tensor(x), torch.as_tensor(y), prior_scale=1.0)
    init = {"log_ls": torch.log(tm.kern_com.lengthscales.value.detach())}
    samples, rates = hmc_sample(tfn, init, torch.Generator().manual_seed(1), num_samples=60,
                                num_warmup=60, num_leapfrog=8, num_chains=2)
    ls = torch.exp(samples["log_ls"]).numpy()
    assert np.isfinite(ls).all() and (ls > 0).all()
    assert float(rates.min()) > 0.2


# ---------------------------------------------------------- model_logprob_fn
def _chains(base: dict, num_chains: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {k: v[None] + 0.02 * np.abs(v[None]) * rng.standard_normal((num_chains,) + v.shape)
            for k, v in base.items()}


def _j_substitute(model, leaves):
    """JAX: the Params at these paths (``.kern_com.<field>`` or
    ``.kern.stacked.<field>``) take the raws of ``leaves``."""
    for path, raw in leaves.items():
        names = path.strip(".").split(".")

        def put(obj, names):
            if len(names) == 1:
                old = getattr(obj, names[0])
                return obj.replace(**{names[0]: JParam(raw, old.transform, old.trainable)})
            return obj.replace(**{names[0]: put(getattr(obj, names[0]), names[1:])})
        model = put(model, names)
    return model


class _JBank:
    """A JAX bank whose ``loss()`` is the summed bank loss (what
    ``model_logprob_fn`` reads when x is None)."""

    def __init__(self, bank):
        self.bank = bank

    def loss(self):
        return j_bank_loss(self.bank)


def _logprob_pair(which):
    if which == "modgp":
        jm, tm, x, y = _modgp_pair()
        paths = [".kern_com.lengthscales", ".kern_com.variance", ".kern_com.energy",
                 ".kern_com.frequency"]
        jfn = j_model_logprob_fn(jm, _j_substitute, jnp.asarray(x), jnp.asarray(y))
        tfn = model_logprob_fn(tm, with_raw, torch.as_tensor(x), torch.as_tensor(y))
    else:
        jm, tm = _bank_pair()
        paths = [".kern.stacked.variance", ".kern.stacked.lengthscales",
                 ".kern.stacked.energy"]
        jfn = j_model_logprob_fn(jm, lambda m, l: _JBank(_j_substitute(m, l)))
        tfn = model_logprob_fn(tm, with_raw)
    raws = dict(named_params(tm))
    base = {p: raws[p].raw.detach().numpy() for p in paths}
    return jfn, tfn, _chains(base, 3, seed=5)


@pytest.mark.parametrize("which", ["modgp", "bank"])
def test_torch_model_logprob_fn_matches_jax(which):
    """(C,) log densities and each chain's gradient of every leaf within
    1e-12 of max|ref| (3 chains; for the bank the chains folded into the
    window axis)."""
    jfn, tfn, leaves = _logprob_pair(which)
    jl = {k: jnp.asarray(v) for k, v in leaves.items()}
    want, want_g = jax.jit(jax.vmap(jax.value_and_grad(jfn)))(jl)
    want = np.asarray(want)
    tl = {k: torch.as_tensor(v).requires_grad_(True) for k, v in leaves.items()}
    got = tfn(tl)
    grads = torch.autograd.grad(got.sum(), list(tl.values()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    for (k, _), g in zip(tl.items(), grads):
        w = np.asarray(want_g[k])
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-12 * np.abs(w).max(),
                                   err_msg=k)


def test_torch_folded_bank_equals_chain_at_a_time():
    """The chain-folded bank (3 chains x 4 windows, one evaluation) against
    each chain alone: values and gradients within 1e-12."""
    _, tfn, leaves = _logprob_pair("bank")
    tl = {k: torch.as_tensor(v).requires_grad_(True) for k, v in leaves.items()}
    folded = tfn(tl)
    grads = torch.autograd.grad(folded.sum(), list(tl.values()))
    for c in range(3):
        one = {k: torch.as_tensor(v[c:c + 1]).requires_grad_(True) for k, v in leaves.items()}
        val = tfn(one)
        g1 = torch.autograd.grad(val.sum(), list(one.values()))
        np.testing.assert_allclose(folded[c].item(), val.item(), rtol=1e-12)
        for g, gc in zip(grads, g1):
            np.testing.assert_allclose(g[c].numpy(), gc[0].numpy(), rtol=0,
                                       atol=1e-12 * gc.abs().max().item())


def test_torch_hmc_diverged_chain_rejects_and_the_others_carry_on():
    """Chain 1 starts where the density is NaN: every proposal of it is
    rejected (it stays at its start, rate 0), and chains 0 and 2 are bit for
    bit those of a run where chain 1 starts in the well."""
    def logprob(q):
        x = q["x"]
        lp = -0.5 * x.square().sum(-1)
        return torch.where(x[:, 0] > 5.0, torch.full_like(lp, float("nan")), lp)

    q0 = {"x": torch.zeros(2, dtype=F64)}
    gen = torch.Generator().manual_seed(0)
    total, c = 30, 3
    mom = {"x": torch.randn((total, c, 2), generator=gen, dtype=F64)}
    unif = torch.rand((total, c), generator=gen, dtype=F64)
    good = {"x": torch.randn((c, 2), generator=gen, dtype=F64)}
    bad = {"x": good["x"].clone()}
    bad["x"][1] = torch.tensor([100.0, 0.0], dtype=F64)
    args = (20, 10, 5, 0.1, 0.8, 0.1, True)
    s_good, r_good = _hmc_core(logprob, q0, good, mom, unif, *args)
    s_bad, r_bad = _hmc_core(logprob, q0, bad, mom, unif, *args)
    assert r_bad[1].item() == 0.0
    assert torch.equal(s_bad["x"][1], (0.1 * bad["x"][1]).expand(10, 2))
    for k in (0, 2):
        assert torch.equal(s_bad["x"][k], s_good["x"][k])
        assert r_bad[k].item() == r_good[k].item()
    assert torch.isfinite(s_good["x"]).all()
