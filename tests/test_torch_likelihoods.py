"""The port's quadrature, nonlinearities and modulated likelihoods
(gpitch_tpu_torch.core.quadrature, .utils.math, .likelihoods) against
gpitch_tpu, f64 on the CPU, on seeded inputs.

Tolerances: nodes and weights 1e-14, nonlinearities 1e-13, moments and
expected log-likelihoods 1e-12 relative to the largest value (the same
formulas, summed in another order), and their gradients 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpitch_tpu.core import quadrature as jq
from gpitch_tpu.likelihoods import modulated as jlik
from gpitch_tpu.utils import math as jmath
from gpitch_tpu_torch.core import quadrature as tq
from gpitch_tpu_torch.core.params import load_raw
from gpitch_tpu_torch.likelihoods import modulated as tlik
from gpitch_tpu_torch.utils import math as tmath


def close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("h", [1, 5, 20])
def test_hermgauss_nodes_match_jax(h):
    x, w = tq.hermgauss(h, torch.float64)
    jx, jw = jq.hermgauss(h, jnp.float64)
    close(x, jx, 1e-14)
    close(w, jw, 1e-14)
    assert float(w.sum()) == pytest.approx(1.0, abs=1e-13)


@pytest.mark.parametrize("nlin", ["logistic", "gaussfun"])
def test_gauss_hermite_moments_match_jax(nlin):
    """E[phi(g)], E[phi(g)^2] and E[phi(g)] alone over an (N, S) grid of
    Gaussians: 1e-12; and the gradient of their weighted sum in mean and
    var: 1e-10."""
    rng = np.random.default_rng(0)
    mean = rng.normal(3.0, 1.5, (40, 3))
    var = rng.uniform(0.01, 2.0, (40, 3))
    w1, w2 = rng.standard_normal((2, 40, 3))
    tf, jf = getattr(tmath, nlin), getattr(jmath, nlin)
    m, v = torch.as_tensor(mean).requires_grad_(True), torch.as_tensor(var).requires_grad_(True)
    e1, e2 = tq.gauss_hermite_moments(m, v, tf, 20)
    je1, je2 = jq.gauss_hermite_moments(jnp.asarray(mean), jnp.asarray(var), jf, 20)
    close(e1, je1, 1e-12)
    close(e2, je2, 1e-12)
    close(tq.expectation_gaussian_nonlin(m, v, tf, 20), je1, 1e-12)
    close(tq.hermgauss1d(m, v, 20, tf)[1], je2, 1e-12)
    ((e1 * torch.as_tensor(w1)).sum() + (e2 * torch.as_tensor(w2)).sum()).backward()
    jg = jax.grad(lambda a, b: sum((e * w).sum() for e, w in zip(
        jq.gauss_hermite_moments(a, b, jf, 20), (w1, w2))), argnums=(0, 1))(
        jnp.asarray(mean), jnp.asarray(var))
    close(m.grad, jg[0], 1e-10)
    close(v.grad, jg[1], 1e-10)


def test_mvhermgauss_matches_jax():
    rng = np.random.default_rng(1)
    means = rng.standard_normal((4, 2))
    A = rng.standard_normal((4, 2, 2))
    covs = A @ np.swapaxes(A, 1, 2) + 0.1 * np.eye(2)
    X, w = tq.mvhermgauss(torch.as_tensor(means), torch.as_tensor(covs), 5, 2)
    jX, jw = jq.mvhermgauss(jnp.asarray(means), jnp.asarray(covs), 5, 2)
    close(X, jX, 1e-13)
    close(w, jw, 1e-14)


@pytest.mark.parametrize("name", ["logistic", "ilogistic", "softplus", "isoftplus",
                                  "gaussfun", "igaussfun", "norm"])
def test_nonlinearities_match_jax(name):
    x = np.random.default_rng(2).uniform(0.05, 0.95, 50)
    close(getattr(tmath, name)(torch.as_tensor(x)), getattr(jmath, name)(jnp.asarray(x)),
          1e-13)


def _fg(seed, n, s):
    """Seeded (Fmu, Fvar, Y) for S sources in the [g.., f..] order."""
    rng = np.random.default_rng(seed)
    fmu = np.concatenate([rng.normal(3.0, 1.0, (n, s)), rng.normal(0.0, 1.0, (n, s))], 1)
    fvar = rng.uniform(0.01, 1.0, (n, 2 * s))
    return fmu, fvar, rng.standard_normal((n, 1))


def _interleave(F, s):
    """[g.., f..] -> [f_1, g_1, f_2, g_2, ..]."""
    out = np.empty_like(F)
    out[:, 0::2], out[:, 1::2] = F[:, s:], F[:, :s]
    return out


_LIKS = [("ModulatedLikelihood", 1, {}), ("ModulatedLikelihood", 2, {}),
         ("ModulatedLikelihood", 3, {}), ("ModulatedLikelihood", 3, {"closed_form": True}),
         ("ModLik", 1, {}), ("LooLik", 2, {}), ("SsLik", 3, {}), ("SsLik", 3, {"quad": False})]


@pytest.mark.parametrize("name,s,kw", _LIKS, ids=[f"{n}-{s}-{'-'.join(k) or 'quad'}"
                                                  for n, s, k in _LIKS])
def test_likelihood_matches_jax(name, s, kw):
    """variational_expectations (quadrature or closed form) and logp for
    S = 1, 2, 3, the noise variance carried across as a raw leaf; values
    1e-12, the gradient of the summed expectation in Fmu, Fvar and the raw
    noise variance 1e-10."""
    fmu, fvar, y = _fg(s, 30, s)
    if name != "ModulatedLikelihood":
        fmu, fvar = _interleave(fmu, s), _interleave(fvar, s)
    if name == "ModulatedLikelihood":
        kw = dict(kw, num_sources=s)
    jl = getattr(jlik, name).create(variance=0.3, **kw)
    tl = getattr(tlik, name).create(variance=0.3, dtype=torch.float64, **kw)
    load_raw(tl, {".variance[<flat index 0>]": np.asarray(jl.variance.raw) + 0.1})
    jl = jl.replace(variance=jl.variance.__class__(
        jnp.asarray(jl.variance.raw) + 0.1, jl.variance.transform, True))
    m, v = torch.as_tensor(fmu).requires_grad_(True), torch.as_tensor(fvar).requires_grad_(True)
    ve = tl.variational_expectations(m, v, torch.as_tensor(y))
    close(ve, jl.variational_expectations(fmu, fvar, y), 1e-12)
    close(tl.logp(torch.as_tensor(fmu), torch.as_tensor(y)), jl.logp(fmu, y), 1e-12)
    ve.sum().backward()
    jg = jax.grad(lambda lk, a, b: lk.variational_expectations(a, b, y).sum(),
                  argnums=(0, 1, 2))(jl, jnp.asarray(fmu), jnp.asarray(fvar))
    close(m.grad, jg[1], 1e-10)
    close(v.grad, jg[2], 1e-10)
    close(tl.variance.raw.grad, jg[0].variance.raw, 1e-10)


def test_closed_form_and_log_lik_exp_match_jax():
    rng = np.random.default_rng(3)
    mean, var = rng.standard_normal((2, 25, 3))
    var = np.abs(var) + 0.05
    for b in (0.5, 0.25):
        close(tlik.exp_value_closed_form(torch.as_tensor(mean), torch.as_tensor(var), b),
              jlik.exp_value_closed_form(mean, var, b), 1e-13)
    y = rng.standard_normal((25, 1))
    args = [rng.standard_normal((25, 3)) for _ in range(4)]
    close(tlik.log_lik_exp(torch.as_tensor(y), *map(torch.as_tensor, args),
                           torch.tensor(0.2, dtype=torch.float64)),
          jlik.log_lik_exp(y, *args, 0.2), 1e-13)
    close(tlik.gaussian_logdensity(torch.as_tensor(y), torch.as_tensor(args[0][:, :1]),
                                   torch.tensor(0.2, dtype=torch.float64)),
          jlik.gaussian_logdensity(y, args[0][:, :1], 0.2), 1e-13)
