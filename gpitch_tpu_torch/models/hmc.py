"""Hamiltonian Monte Carlo over model hyperparameters.

Counterpart of gpitch_tpu/models/hmc.py: HMC with dual-averaging step-size
adaptation (Hoffman & Gelman 2014, algorithm 5 constants) and Stan-style
diagonal mass adaptation.  The chains are a leading batch axis of every
leaf: each chain adapts its own step size (C,) and its own diagonal inverse
mass (C, ...), as the JAX package's vmapped chains do, and the accept
decision is a ``torch.where`` on the device, so a step makes no host sync.

Parameters are a dict of tensors (raw, unconstrained leaves).
``logprob_fn`` takes the dict with a leading chain axis on every leaf and
returns the (C,) log densities; the gradient is autograd of their sum, as
the chains are independent.

The random numbers come from an explicit ``torch.Generator``.  ``jax.random``
draws cannot be reproduced in torch, so the sampler is a core that takes
its noise as tensors (the chains' init normals, each step's unscaled
momentum normals and uniforms) and ``hmc_sample`` draws that noise and
calls it; the JAX package's own draws fed to the core give its chains.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..core.params import Param, map_params

__all__ = ["hmc_sample", "model_logprob_fn"]


def _per_chain(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(C,) -> (C, 1, ..) broadcasting against ``like`` (C, ...)."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def _chain_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over every axis but the leading chain axis: (C,)."""
    return x.reshape(x.shape[0], -1).sum(1)


def _value_and_grad(logprob_fn: Callable, q: dict):
    """(C,) log densities and their gradients, each chain's own."""
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_(True) for k, v in q.items()}
        lp = logprob_fn(leaves)
        grads = torch.autograd.grad(lp.sum(), list(leaves.values()), allow_unused=True)
    g = {k: torch.zeros_like(v) if d is None else d
         for (k, v), d in zip(leaves.items(), grads)}
    return lp.detach(), g


def _kinetic(p: dict, inv_mass: dict) -> torch.Tensor:
    """0.5 p^T M^-1 p per chain, with diagonal M^-1 = inv_mass."""
    return 0.5 * sum(_chain_sum(p[k].square() * inv_mass[k]) for k in p)


def _hmc_core(logprob_fn: Callable, q0: dict, init_normals: dict,
              momentum_normals: dict, uniforms: torch.Tensor, num_warmup: int,
              num_samples: int, num_leapfrog: int, init_step_size: float,
              target_accept: float, jitter_init: float, mass_adapt: bool):
    """The sampler on given noise.

    q0[k]: a leaf without the chain axis; init_normals[k]: (C, *shape);
    momentum_normals[k]: (T, C, *shape) unscaled N(0, 1) draws, scaled
    here by 1 / sqrt(inv_mass) since the mass changes mid-warmup;
    uniforms: (T, C).  T = num_warmup + num_samples, warmup steps first.
    Returns (samples {k: (C, num_samples, *shape)}, accept rates (C,))."""
    c = uniforms.shape[1]
    q = {k: q0[k] + jitter_init * init_normals[k] for k in q0}
    lp, g = _value_and_grad(logprob_fn, q)
    dtype, device = lp.dtype, lp.device

    def hmc_step(t, q, lp, g, eps, inv_mass):
        p = {k: momentum_normals[k][t] / torch.sqrt(inv_mass[k]) for k in q}
        h0 = -lp + _kinetic(p, inv_mass)
        q1, lp1, g1 = q, lp, g
        for _ in range(num_leapfrog):
            p = {k: p[k] + 0.5 * _per_chain(eps, p[k]) * g1[k] for k in p}
            q1 = {k: q1[k] + _per_chain(eps, p[k]) * inv_mass[k] * p[k] for k in q1}
            lp1, g1 = _value_and_grad(logprob_fn, q1)
            p = {k: p[k] + 0.5 * _per_chain(eps, p[k]) * g1[k] for k in p}
        h1 = -lp1 + _kinetic(p, inv_mass)
        log_alpha = torch.clamp(h0 - h1, max=0.0)
        # a diverged chain (non-finite energy) rejects and carries on
        log_alpha = torch.where(torch.isfinite(log_alpha), log_alpha,
                                torch.full_like(log_alpha, -math.inf))
        accept = torch.log(uniforms[t]) < log_alpha

        def pick(new, old):
            return torch.where(_per_chain(accept, new), new, old)

        q = {k: pick(q1[k], q[k]) for k in q}
        g = {k: pick(g1[k], g[k]) for k in g}
        return q, torch.where(accept, lp1, lp), g, torch.exp(log_alpha), accept

    def adapt(t0, steps, q, lp, g, inv_mass, eps0, welford):
        """Dual averaging of the step size over ``steps`` steps, with a
        Welford estimate of each parameter's variance when asked."""
        mu = torch.log(10.0 * eps0)
        log_eps = log_eps_avg = torch.log(eps0)
        h_avg = torch.zeros(c, dtype=dtype, device=device)
        wmean = {k: torch.zeros_like(v) for k, v in q.items()}
        wm2 = {k: torch.zeros_like(v) for k, v in q.items()}
        for i in range(steps):
            q, lp, g, alpha, _ = hmc_step(t0 + i, q, lp, g, torch.exp(log_eps), inv_mass)
            t = i + 1.0
            h_avg = (1.0 - 1.0 / (t + 10.0)) * h_avg + (target_accept - alpha) / (t + 10.0)
            log_eps = mu - math.sqrt(t) / 0.05 * h_avg
            w = t ** -0.75
            log_eps_avg = w * log_eps + (1.0 - w) * log_eps_avg
            if welford:
                for k in q:
                    delta = q[k] - wmean[k]
                    wmean[k] = wmean[k] + delta / t
                    wm2[k] = wm2[k] + delta * (q[k] - wmean[k])
        return q, lp, g, torch.exp(log_eps_avg), wm2

    identity = {k: torch.ones_like(v) for k, v in q.items()}
    eps0 = torch.full((c,), init_step_size, dtype=dtype, device=device)
    if mass_adapt and num_warmup >= 20:
        wa = num_warmup // 2
        q, lp, g, eps_a, wm2 = adapt(0, wa, q, lp, g, identity, eps0, True)
        n = float(wa)
        # Stan's regularization: shrink toward 1e-3 with a pseudo-count of 5
        inv_mass = {k: (n / ((n + 5.0) * max(n - 1.0, 1.0))) * v + 5e-3 / (n + 5.0)
                    for k, v in wm2.items()}
        q, lp, g, eps, _ = adapt(wa, num_warmup - wa, q, lp, g, inv_mass, eps_a, False)
    else:
        inv_mass = identity
        q, lp, g, eps, _ = adapt(0, num_warmup, q, lp, g, identity, eps0, False)

    samples = {k: [] for k in q}
    accepts = []
    for s in range(num_samples):
        q, lp, g, _, accept = hmc_step(num_warmup + s, q, lp, g, eps, inv_mass)
        for k in q:
            samples[k].append(q[k])
        accepts.append(accept)
    samples = {k: torch.stack(v, 1) if v else q[k][:, None][:, :0] for k, v in samples.items()}
    rates = (torch.stack(accepts, 1).to(dtype).mean(1) if accepts
             else torch.zeros(c, dtype=dtype, device=device))
    return samples, rates


def hmc_sample(logprob_fn: Callable, init_params, generator: torch.Generator | None = None,
               num_samples: int = 500, num_warmup: int = 200, num_leapfrog: int = 16,
               init_step_size: float = 0.01, target_accept: float = 0.8,
               num_chains: int = 4, jitter_init: float = 0.1, mass_adapt: bool = True):
    """Run ``num_chains`` HMC chains at once.

    logprob_fn(leaves with a leading chain axis) -> (C,) log densities
    (unnormalized).  ``init_params``: a dict of tensors; each chain starts
    at init + jitter_init N(0, 1).  ``generator``: the
    torch.Generator on the parameters' device that draws every random
    number (seeded with 0 when None).  Returns (samples with leading
    (num_chains, num_samples) axes, accept rates (num_chains,)).

    ``mass_adapt``: warmup runs in two halves when num_warmup >= 20; the
    first adapts the step size under an identity metric while a Welford
    estimate of each parameter's variance accumulates, and the regularized
    variances become the diagonal inverse mass of the second half, which
    adapts the step size again.  Raw parameters on very different scales
    (frequencies O(100) beside lengthscales O(0.1)) need it: one step size
    under an identity metric is throttled by the stiffest direction.
    """
    q0 = dict(init_params)
    first = next(iter(q0.values()))
    if generator is None:
        generator = torch.Generator(device=first.device).manual_seed(0)
    total = num_warmup + num_samples

    def normal(shape, like):
        return torch.randn(shape + tuple(like.shape), generator=generator,
                           dtype=like.dtype, device=like.device)

    init_normals = {k: normal((num_chains,), v) for k, v in q0.items()}
    momentum = {k: normal((total, num_chains), v) for k, v in q0.items()}
    uniforms = torch.rand((total, num_chains), generator=generator, dtype=first.dtype,
                          device=first.device)
    samples, rates = _hmc_core(logprob_fn, q0, init_normals, momentum, uniforms,
                               num_warmup, num_samples, num_leapfrog, init_step_size,
                               target_accept, jitter_init, mass_adapt)
    return samples, rates


def _is_bank(model) -> bool:
    """A window bank: an SGPR whose data carry a leading window axis."""
    x = getattr(model, "X", None)
    return isinstance(x, Param) and x.raw.dim() == 3


def _fold_chains(bank, num_chains: int):
    """The bank repeated ``num_chains`` times along its window axis, chain
    major (window c * nw + w is chain c's window w)."""
    return map_params(bank, lambda p: Param(
        p.raw.detach().repeat((num_chains,) + (1,) * (p.raw.dim() - 1)),
        p.transform, p.trainable))


def model_logprob_fn(model, loss_leaves: Callable, x=None, y=None, num_data=None,
                     prior_scale: float = 10.0):
    """logprob(leaves) -> (C,): the ELBO of ``loss_leaves(model, leaves)``
    (``-loss()`` when ``x`` is None) plus an N(0, prior_scale^2) prior on
    every substituted raw leaf, per chain.

    ``leaves`` carry a leading chain axis.  ``loss_leaves(model, leaves)``
    returns the model with the leaves substituted (``core.params.with_raw``
    does it by ``named_params`` path).  For a window bank the chain axis is
    folded into the window axis: ``loss_leaves`` gets the bank repeated per
    chain and the leaves reshaped to (C nw, ...), and one evaluation of the
    C nw windows' bounds (through the fused pair where the bank is
    eligible) gives every chain's value.  For any other model the chains
    are ``torch.func.vmap``-ed over ``loss_leaves`` and the ELBO.
    """
    folded = {}

    def value(m):
        return m.elbo(x, y, num_data) if x is not None else -m.loss()

    def logprob(leaves):
        c = next(iter(leaves.values())).shape[0]
        prior = -0.5 * sum(_chain_sum((v / prior_scale).square()) for v in leaves.values())
        if _is_bank(model):
            if c not in folded:
                folded.clear()
                folded[c] = _fold_chains(model, c)
            flat = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in leaves.items()}
            out = value(loss_leaves(folded[c], flat)).reshape(c, -1).sum(1)
        else:
            out = torch.func.vmap(lambda one: value(loss_leaves(model, one)))(leaves)
        return out + prior

    return logprob
