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
from .fit import CapturedSteps

__all__ = ["hmc_sample", "hmc_steps", "model_logprob_fn", "HmcSteps"]


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


def _transition(logprob_fn: Callable, q: dict, lp, g: dict, normals: dict, uniform,
                eps, inv_mass: dict, num_leapfrog: int):
    """One HMC iteration of every chain: momenta from the unscaled
    ``normals`` (scaled here by 1 / sqrt(inv_mass)), ``num_leapfrog``
    leapfrog steps of size ``eps`` (C,), the accept test against
    ``uniform`` (C,).  Returns (q, lp, g, alpha, accept)."""
    p = {k: normals[k] / torch.sqrt(inv_mass[k]) for k in q}
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
    accept = torch.log(uniform) < log_alpha

    def pick(new, old):
        return torch.where(_per_chain(accept, new), new, old)

    q = {k: pick(q1[k], q[k]) for k in q}
    g = {k: pick(g1[k], g[k]) for k in g}
    return q, torch.where(accept, lp1, lp), g, torch.exp(log_alpha), accept


def _dual_averaging(t, h_avg, log_eps_avg, alpha, mu, target_accept: float):
    """Hoffman & Gelman's update after the t-th step of a phase: ``t`` a
    0-d tensor of the chains' dtype (the JAX package's ``da.step + 1``: f32
    under f32, f64 under x64).  Returns (h_avg, log_eps, log_eps_avg)."""
    h_avg = (1.0 - 1.0 / (t + 10.0)) * h_avg + (target_accept - alpha) / (t + 10.0)
    log_eps = mu - torch.sqrt(t) / 0.05 * h_avg
    w = t ** -0.75
    return h_avg, log_eps, w * log_eps + (1.0 - w) * log_eps_avg


def _welford(t, q: dict, wmean: dict, wm2: dict) -> None:
    """Welford's running mean and sum of squared deviations of ``q`` after
    its t-th value, in place."""
    for k in q:
        delta = q[k] - wmean[k]
        wmean[k] = wmean[k] + delta / t
        wm2[k] = wm2[k] + delta * (q[k] - wmean[k])


def _stan_inv_mass(wm2: dict, n: int) -> dict:
    """The variances of ``n`` draws (Welford's sums) shrunk toward 1e-3 with
    a pseudo-count of 5, Stan's regularization: the diagonal inverse mass."""
    n = float(n)
    return {k: (n / ((n + 5.0) * max(n - 1.0, 1.0))) * v + 5e-3 / (n + 5.0)
            for k, v in wm2.items()}


def _phases(num_warmup: int, num_samples: int, mass_adapt: bool) -> list:
    """(kind, iterations) of a run: warm-up with a Welford estimate of the
    variances (half A) and without it (half B), or the whole warm-up
    without it; then the samples."""
    if mass_adapt and num_warmup >= 20:
        wa = num_warmup // 2
        return [("welford", wa), ("adapt", num_warmup - wa), ("sample", num_samples)]
    return [("adapt", num_warmup), ("sample", num_samples)]


def _hmc_core(logprob_fn: Callable, q0: dict, init_normals: dict,
              momentum_normals: dict, uniforms: torch.Tensor, num_warmup: int,
              num_samples: int, num_leapfrog: int, init_step_size: float,
              target_accept: float, jitter_init: float, mass_adapt: bool):
    """The sampler on given noise, one iteration after another from Python
    loops: the plain version of ``HmcSteps``.

    q0[k]: a leaf without the chain axis; init_normals[k]: (C, *shape);
    momentum_normals[k]: (T, C, *shape) unscaled N(0, 1) draws, scaled
    by 1 / sqrt(inv_mass) since the mass changes mid-warmup;
    uniforms: (T, C).  T = num_warmup + num_samples, warmup steps first.
    Returns (samples {k: (C, num_samples, *shape)}, accept rates (C,))."""
    c = uniforms.shape[1]
    q = {k: q0[k] + jitter_init * init_normals[k] for k in q0}
    lp, g = _value_and_grad(logprob_fn, q)
    dtype, device = lp.dtype, lp.device

    def hmc_step(t, q, lp, g, eps, inv_mass):
        return _transition(logprob_fn, q, lp, g, {k: momentum_normals[k][t] for k in q},
                           uniforms[t], eps, inv_mass, num_leapfrog)

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
            t = torch.tensor(i + 1.0, dtype=dtype, device=device)
            h_avg, log_eps, log_eps_avg = _dual_averaging(t, h_avg, log_eps_avg, alpha, mu,
                                                          target_accept)
            if welford:
                _welford(t, q, wmean, wm2)
        return q, lp, g, torch.exp(log_eps_avg), wm2

    inv_mass = {k: torch.ones_like(v) for k, v in q.items()}
    eps = torch.full((c,), init_step_size, dtype=dtype, device=device)
    t0 = 0
    for kind, n in _phases(num_warmup, num_samples, mass_adapt)[:-1]:
        q, lp, g, eps, wm2 = adapt(t0, n, q, lp, g, inv_mass, eps, kind == "welford")
        if kind == "welford":
            inv_mass = _stan_inv_mass(wm2, n)
        t0 += n

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


class _Phase(CapturedSteps):
    """One phase of an ``HmcSteps`` run, an iteration a step: captured once
    on the card and replayed, every phase's graph in the run's pool.  Its
    ``losses`` are the chains' log densities, which each step writes."""

    def __init__(self, sampler: "HmcSteps", kind: str, warmup: int):
        super().__init__(sampler.lp)
        self.sampler, self.kind, self.WARMUP = sampler, kind, warmup
        self.pool = sampler.pool

    def step(self) -> None:
        self.sampler.iteration(self.kind)


class HmcSteps:
    """The counterpart of the JAX package's compiled sampler (one jitted
    ``vmap(one_chain)``: the leapfrog a ``fori_loop``, the adaptation and
    the sampling ``lax.scan``s): every iteration of every chain reads and
    writes static device tensors, indexed by counts on the device, so an
    iteration reads nothing from the host and writes nothing to it.

    The state: the chains' q, log density and gradient; the iteration index
    ``t`` into the noise (momentum normals (T, C, ...), uniforms (T, C));
    the dual averaging's mu, log_eps, log_eps_avg and h_avg (C,) and its
    count within the phase (a 0-d tensor of the chains' dtype, as the JAX
    package's ``da.step``); Welford's sums; the inverse mass; the step size
    (a phase's start, then the sampling's); the samples (C, num_samples,
    ...), written at the sample index by ``index_copy_``; and the accept
    count.

    A run is two or three phases (``_phases``): warm-up with Welford,
    warm-up without it, sampling; each is one ``CapturedSteps`` whose step
    is one whole iteration (``num_leapfrog`` evaluations, the accept test
    and the update), so on the card each phase runs its first iteration(s)
    eagerly and replays one captured graph after (the first phase 3 eager
    iterations, as ``AdamSteps``, the later ones 1), and a capture that
    fails raises.  Between phases (``begin``, ``end``) the inverse mass's
    regularization and the next phase's mu and step size are computed on
    the device.  On the CPU every iteration runs eagerly, the plain version
    of the capture.
    The sampler reads the host nowhere: ``result()`` returns device
    tensors.  ``logprob_fn`` is evaluated once eagerly at the start (a
    folded bank fills its cache there, not inside a capture).
    """

    def __init__(self, logprob_fn: Callable, q0: dict, init_normals: dict,
                 momentum_normals: dict, uniforms: torch.Tensor, num_warmup: int,
                 num_samples: int, num_leapfrog: int, init_step_size: float,
                 target_accept: float, jitter_init: float, mass_adapt: bool):
        self.fn, self.momentum, self.uniforms = logprob_fn, momentum_normals, uniforms
        self.num_leapfrog, self.target_accept = num_leapfrog, target_accept
        self.num_samples = num_samples
        c = uniforms.shape[1]
        q = {k: q0[k] + jitter_init * init_normals[k] for k in q0}
        lp, g = _value_and_grad(logprob_fn, q)
        self.q = {k: v.detach().clone() for k, v in q.items()}
        self.g = {k: v.clone() for k, v in g.items()}
        self.lp = lp.clone()
        dtype, device = lp.dtype, lp.device
        zeros = lp.new_zeros(c)
        self.mu, self.log_eps, self.log_eps_avg, self.h_avg = (zeros.clone() for _ in range(4))
        self.eps = torch.full_like(zeros, init_step_size)
        self.count = torch.zeros((), dtype=dtype, device=device)
        self.t = torch.zeros((), dtype=torch.int64, device=device)
        self.s = torch.zeros_like(self.t)
        self.accepts = zeros.clone()
        self.wmean = {k: torch.zeros_like(v) for k, v in self.q.items()}
        self.wm2 = {k: torch.zeros_like(v) for k, v in self.q.items()}
        self.inv_mass = {k: torch.ones_like(v) for k, v in self.q.items()}
        self.samples = {k: v.new_zeros((c, num_samples) + tuple(v.shape[1:]))
                        for k, v in self.q.items()}
        self.pool = torch.cuda.graph_pool_handle() if lp.is_cuda else None
        self.plan = _phases(num_warmup, num_samples, mass_adapt)
        self.phases = {kind: _Phase(self, kind, CapturedSteps.WARMUP if i == 0 else 1)
                       for i, (kind, _) in enumerate(self.plan)}

    def iteration(self, kind: str) -> None:
        """One iteration of phase ``kind`` ('welford', 'adapt' or 'sample')."""
        at = self.t.reshape(1)
        adapt = kind != "sample"
        eps = torch.exp(self.log_eps) if adapt else self.eps
        q, lp, g, alpha, accept = _transition(
            self.fn, self.q, self.lp, self.g,
            {k: v.index_select(0, at)[0] for k, v in self.momentum.items()},
            self.uniforms.index_select(0, at)[0], eps, self.inv_mass, self.num_leapfrog)
        with torch.no_grad():
            for static, new in ((self.q, q), (self.g, g)):
                for k in static:
                    static[k].copy_(new[k])
            self.lp.copy_(lp)
            if adapt:
                self.count.add_(1.0)
                for static, new in zip((self.h_avg, self.log_eps, self.log_eps_avg),
                                       _dual_averaging(self.count, self.h_avg,
                                                       self.log_eps_avg, alpha, self.mu,
                                                       self.target_accept)):
                    static.copy_(new)
                if kind == "welford":
                    wmean, wm2 = dict(self.wmean), dict(self.wm2)
                    _welford(self.count, self.q, wmean, wm2)
                    for k in self.q:
                        self.wmean[k].copy_(wmean[k])
                        self.wm2[k].copy_(wm2[k])
            else:
                for k, v in self.q.items():
                    self.samples[k].index_copy_(1, self.s.reshape(1), v[:, None])
                self.accepts.add_(accept.to(self.accepts.dtype))
                self.s.add_(1)
            self.t.add_(1)

    @torch.no_grad()
    def begin(self, kind: str) -> None:
        """Before phase ``kind``: a warm-up phase starts its dual averaging
        from the step size ``eps`` (C,) and its Welford sums from 0."""
        if kind == "sample":
            return
        self.mu.copy_(torch.log(10.0 * self.eps))
        self.log_eps.copy_(torch.log(self.eps))
        self.log_eps_avg.copy_(self.log_eps)
        self.h_avg.zero_()
        self.count.zero_()
        for v in (*self.wmean.values(), *self.wm2.values()):
            v.zero_()

    @torch.no_grad()
    def end(self, kind: str, n: int) -> None:
        """After ``n`` iterations of phase ``kind``: a warm-up phase leaves
        its averaged step size in ``eps``, and the Welford phase its
        regularized variances in the inverse mass."""
        if kind == "sample":
            return
        self.eps.copy_(torch.exp(self.log_eps_avg))
        if kind == "welford":
            for k, v in _stan_inv_mass(self.wm2, n).items():
                self.inv_mass[k].copy_(v)

    def run(self, eager: bool = False):
        """Every phase, captured on the card (``eager``: the plain version
        there too); returns ``result()``."""
        for kind, n in self.plan:
            self.begin(kind)
            phase = self.phases[kind]
            phase.eager(n) if eager else phase.run(n)
            self.end(kind, n)
        return self.result()

    def result(self):
        """(samples {k: (C, num_samples, ...)}, accept rates (C,)), on the
        device."""
        n = self.num_samples
        rates = self.accepts / n if n else torch.zeros_like(self.accepts)
        return {k: v.clone() for k, v in self.samples.items()}, rates

    @property
    def capture_s(self) -> float:
        return sum(p.capture_s for p in self.phases.values())

    @property
    def calls(self) -> dict:
        """Each phase's kernel calls in its captured graph."""
        return {kind: p.calls for kind, p in self.phases.items()}


def hmc_sample(logprob_fn: Callable, init_params, generator: torch.Generator | None = None,
               num_samples: int = 500, num_warmup: int = 200, num_leapfrog: int = 16,
               init_step_size: float = 0.01, target_accept: float = 0.8,
               num_chains: int = 4, jitter_init: float = 0.1, mass_adapt: bool = True):
    """Run ``num_chains`` HMC chains at once (``HmcSteps``: on the card
    each phase replays a captured iteration).

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
    return hmc_steps(logprob_fn, init_params, generator, num_samples, num_warmup,
                     num_leapfrog, init_step_size, target_accept, num_chains, jitter_init,
                     mass_adapt).run()


def hmc_steps(logprob_fn: Callable, init_params, generator: torch.Generator | None = None,
              num_samples: int = 500, num_warmup: int = 200, num_leapfrog: int = 16,
              init_step_size: float = 0.01, target_accept: float = 0.8,
              num_chains: int = 4, jitter_init: float = 0.1, mass_adapt: bool = True):
    """The ``HmcSteps`` that ``hmc_sample`` runs (same arguments), its
    noise drawn by ``generator`` and nothing run yet: the chains' init
    normals, then each step's momentum normals, then the uniforms."""
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
    return HmcSteps(logprob_fn, q0, init_normals, momentum, uniforms, num_warmup,
                    num_samples, num_leapfrog, init_step_size, target_accept, jitter_init,
                    mass_adapt)


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
