"""Natural-gradient updates for the Gaussian variational banks of a ModGP.

Counterpart of gpitch_tpu/models/natgrad.py.  With expectation parameters
xi = (m, S + m m^T) and natural parameters (lambda1, lambda2) = (S^-1 m,
-S^-1 / 2), a natural-gradient ascent step of size gamma on the ELBO F is

    lambda1 <- lambda1 + gamma dF/dxi1,   dF/dxi1 = dF/dm - 2 (dF/dS) m,
    lambda2 <- lambda2 + gamma dF/dS,

then S' = -lambda2'^-1 / 2 and m' = S' lambda1'.  The gradients with
respect to (m, S) are taken by autograd through torch.linalg's Cholesky
of S, as the JAX package takes them through jnp.linalg.cholesky; the new
q_sqrt goes back through FillTriangular's inverse.  Factorizations that
fail give NaN (they do not raise), and a step that leaves a non-finite
model is skipped.

``fit_natgrad_adam`` alternates a natural step on the banks with an Adam
step on the hyperparameters.  A skipped step leaves the model and Adam's
moments and count as they were while the schedule's step index advances,
as the JAX package's ``pick(st2, st)`` does.  ``NatgradSteps`` runs the
steps as the JAX package's jitted scan does: the step index, the gamma
scale and the skip decision are device tensors, a skipped step keeps every
leaf through ``torch.where``, and on the card one step is captured as a
CUDA graph and replayed (``fit.CapturedSteps``); the host reads the losses
at a segment's fence.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..core.params import Param, copy_params, named_params
from ..linalg.ops import add_jitter, safe_cholesky
from ..parallel.mesh import all_over_ranks
from .fit import Adam, CapturedSteps, _sqrt_rn

__all__ = ["natgrad_step", "natgrad_polish", "fit_natgrad_adam", "NatgradSteps"]

_BANKS = ("q_mu_act", "q_sqrt_act", "q_mu_com", "q_sqrt_com")


def _sym(a: torch.Tensor) -> torch.Tensor:
    return 0.5 * (a + a.mT)


def _solve_lower(L, B):
    return torch.linalg.solve_triangular(L, B, upper=False)


def _nat_update_bank(q_mu, q_sqrt, grad_m, grad_S, gamma, jitter: float = 1e-8):
    """One natural-gradient step for a stacked bank, in the whitened frame.

    q_mu (S, M, 1), q_sqrt (S, M, M) lower triangular, grad_m and grad_S the
    ELBO's gradients in m and (symmetric) S.  Returns (q_mu, q_sqrt) new.
    The textbook update inverts S and -2 lambda2' (kappa(S)^2 each, NaN in
    f32 near convergence); this form is conditioned like the identity:

        C     = I - 2 gamma L^T grad_S L
        S_new = L C^-1 L^T
        m_new = L C^-1 (L^-1 m + gamma L^T dxi1)

    with every solve triangular, on L or on chol(C)."""
    L = torch.tril(q_sqrt)
    Lt = L.mT
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    dxi1 = grad_m - 2.0 * (grad_S @ q_mu)
    C = eye - 2.0 * gamma * _sym(Lt @ grad_S @ L)
    Lc = safe_cholesky(C, jitter)
    # W = L Lc^-T: solve Lc X = L^T, W = X^T; S_new = W W^T
    W = _solve_lower(Lc, Lt).mT
    S_new = W @ W.mT
    b = _solve_lower(L, q_mu) + gamma * (Lt @ dxi1)
    c = torch.linalg.solve_triangular(Lc.mT, _solve_lower(Lc, b), upper=True)
    return L @ c, safe_cholesky(_sym(S_new), jitter)


def _wrap(p: Param, value: torch.Tensor) -> Param:
    """A Param of ``p``'s transform whose value is ``value`` (differentiable)."""
    return Param.wrap(p.transform.inverse_tensor(value), p.transform, p.trainable)


def _natgrad_values(model, x, y, gamma, num_data: int | None = None):
    """The constrained values (q_mu_act, q_sqrt_act, q_mu_com, q_sqrt_com)
    after one natural-gradient step of size ``gamma`` (a float, or a 0-d
    tensor on the model's device) on both variational banks."""
    mu_a = model.q_mu_act.value.detach()
    mu_c = model.q_mu_com.value.detach()
    La = torch.tril(model.q_sqrt_act.value.detach())
    Lc = torch.tril(model.q_sqrt_com.value.detach())
    leaves = [t.clone().requires_grad_() for t in
              (mu_a, add_jitter(La @ La.mT, 1e-10), mu_c, add_jitter(Lc @ Lc.mT, 1e-10))]
    with torch.enable_grad():
        m2 = dataclasses.replace(
            model, q_mu_act=_wrap(model.q_mu_act, leaves[0]),
            q_sqrt_act=_wrap(model.q_sqrt_act, safe_cholesky(leaves[1], 0.0, 0.0)),
            q_mu_com=_wrap(model.q_mu_com, leaves[2]),
            q_sqrt_com=_wrap(model.q_sqrt_com, safe_cholesky(leaves[3], 0.0, 0.0)))
        g_ma, g_Sa, g_mc, g_Sc = torch.autograd.grad(m2.elbo(x, y, num_data), leaves)
    with torch.no_grad():
        mu_a2, La2 = _nat_update_bank(mu_a, La, g_ma, _sym(g_Sa), gamma)
        mu_c2, Lc2 = _nat_update_bank(mu_c, Lc, g_mc, _sym(g_Sc), gamma)
    return mu_a2, La2, mu_c2, Lc2


def natgrad_step(model, x, y, gamma: float = 0.1, num_data: int | None = None):
    """One natural-gradient step on both variational banks of a ModGP
    (activation and component); the hyperparameters are untouched.
    Returns a new model."""
    values = _natgrad_values(model, x, y, gamma, num_data)

    def param(p: Param, value):
        return Param(p.transform.inverse_tensor(value), p.transform, p.trainable)

    return dataclasses.replace(model, **{b: param(getattr(model, b), v)
                                         for b, v in zip(_BANKS, values)})


def _finite(model, loss, extra=()) -> torch.Tensor:
    """Whether the loss and every raw leaf of the model (and ``extra``)
    are finite: a 0-d bool on their device.  For a model whose sources are
    split over ranks, on every rank: all skip a step where one rank's
    leaves are not finite, as one process does."""
    flat = [loss.detach().reshape(-1)] + [t.detach().reshape(-1) for t in extra]
    flat += [p.raw.detach().reshape(-1) for _, p in named_params(model)]
    return all_over_ranks(torch.isfinite(torch.cat(flat)).all(), model.source_group)


class NatgradSteps(CapturedSteps):
    """Natural-gradient steps on ``model``'s variational banks, trained in
    place, as the JAX package's scans run them: ``fit_natgrad_adam``'s
    (``learning_rate`` given: gamma on its ramp and decay, ``gamma_warmup``
    steps, and an Adam step on the hyperparameters at the model after the
    natural step, on ``batch_fn()``'s minibatch when given) or
    ``natgrad_polish``'s (``learning_rate`` None: gamma fixed, the full
    batch, the hyperparameters frozen).

    The step index, the gamma scale and the decision to skip a step are
    device tensors.  A step that leaves the loss or a leaf (or Adam's
    proposal) non-finite is skipped: every leaf, Adam's moments and count
    keep their values through ``torch.where``, the loss trace gets NaN, and
    the gamma scale halves (floor 1e-3); it grows by 5% (at most 1) after a
    finite step.  The loss of step t is written at index t of ``losses``;
    on the card one step is captured and replayed (``CapturedSteps``)."""

    def __init__(self, model, x, y, num_steps: int, gamma: float,
                 num_data: int | None = None, learning_rate: float | None = None,
                 gamma_warmup: int = 100, batch_fn: Callable | None = None):
        self.model, self.x, self.y, self.num_data = model, x, y, num_data
        self.gamma = gamma
        banks = ["." + b for b in _BANKS]
        hypers = [p.raw for name, p in named_params(model)
                  if p.trainable and name not in banks]
        self.adam = None if learning_rate is None else Adam(hypers, lr=learning_rate)
        self.warm = float(max(gamma_warmup, 1))
        raw = model.q_mu_act.raw
        self.step_i = torch.zeros((), dtype=torch.float64, device=raw.device)
        self.gscale = torch.ones_like(self.step_i)
        self.i = torch.zeros((), dtype=torch.int64, device=raw.device)
        super().__init__(raw.new_zeros(num_steps), batch_fn)

    def _gamma(self):
        if self.adam is None:
            return self.gamma * self.gscale
        ramp = torch.clamp((self.step_i + 1.0) / self.warm, max=1.0)
        # 1/sqrt decay after ~20x warmup: a fixed-size natural step under
        # minibatch noise oscillates around the optimum once converged
        decay = 1.0 / _sqrt_rn(1.0 + self.step_i / (20.0 * self.warm))
        return self.gamma * (0.02 + 0.98 * ramp) * self.gscale * decay

    def step(self) -> None:
        m = self.model
        xb, yb = (self.x, self.y) if self.batch_fn is None else self.batch_fn()
        values = _natgrad_values(m, xb, yb, self._gamma(), self.num_data)
        raws = [getattr(m, b).transform.inverse_tensor(v).detach()
                for b, v in zip(_BANKS, values)]
        m2 = dataclasses.replace(m, **{
            b: Param.wrap(r, getattr(m, b).transform, getattr(m, b).trainable)
            for b, r in zip(_BANKS, raws)})
        if self.adam is None:
            with torch.no_grad():
                loss = m2.loss(xb, yb, self.num_data)
            finite = _finite(m2, loss)
        else:
            hypers = self.adam.params
            with torch.enable_grad():
                loss = m2.loss(xb, yb, self.num_data)
                grads = torch.autograd.grad(loss, hypers, allow_unused=True)
            grads = [torch.zeros_like(h) if g is None else g for h, g in zip(hypers, grads)]
            proposal = self.adam.propose(grads)
            finite = _finite(m2, loss, proposal[0])
            self.adam.commit(*proposal, ok=finite)
        with torch.no_grad():
            for b, r in zip(_BANKS, raws):
                leaf = getattr(m, b).raw
                leaf.copy_(torch.where(finite, r, leaf))
            nan = torch.full_like(loss, float("nan"))
            self.losses.index_copy_(0, self.i.reshape(1),
                                    torch.where(finite, loss.detach(), nan).reshape(1))
            self.gscale.copy_(torch.where(finite, torch.clamp(self.gscale * 1.05, max=1.0),
                                          torch.clamp(self.gscale * 0.5, min=1e-3)))
            self.step_i.add_(1.0)
            self.i.add_(1)

    @torch.no_grad()
    def load(self, model) -> None:
        """``model``'s raw leaves (this one's structure) into the static
        leaves, and the step index, the gamma scale, the count and Adam's
        state back to their start."""
        for (_, mine), (_, p) in zip(named_params(self.model), named_params(model)):
            mine.raw.copy_(p.raw)
        if self.adam is not None:
            self.adam.reset()
        self.step_i.zero_()
        self.gscale.fill_(1.0)
        self.i.zero_()
        self.at = 0

    def segment(self, n: int) -> np.ndarray:
        """``n`` more steps and their losses (NaN where skipped), read at
        one host fence."""
        self.run(n)
        return self.losses[self.at - n:self.at].cpu().numpy().astype(np.float64)


def natgrad_polish(model, x, y, num_steps: int = 200, gamma: float = 0.05,
                   num_data: int | None = None):
    """Full-batch natural-gradient steps only (hyperparameters frozen): from
    a (near-)converged state, fixed-size natural steps on the full-data ELBO
    walk q to its optimum for the current hyperparameters.  A non-finite
    step is skipped with the backoff of ``fit_natgrad_adam``.  Returns
    (model, losses numpy) with NaN on skipped steps; the input is
    unchanged."""
    run = NatgradSteps(copy_params(model), x, y, num_steps, gamma, num_data)
    losses = run.segment(num_steps)
    return run.model, losses


def fit_natgrad_adam(model, x, y, num_steps: int, gamma: float = 0.1,
                     learning_rate: float = 0.01, num_data: int | None = None,
                     batch_fn: Callable | None = None,
                     segment: int | None = None, gamma_warmup: int = 100,
                     polish_steps: int = 0, polish_gamma: float = 0.05,
                     return_info: bool = False):
    """Alternate a natural-gradient step on the variational banks and an
    Adam step on the hyperparameters (the Adam step sees the model after
    the natural step).  ``batch_fn()`` draws a minibatch (else x, y).

    gamma ramps linearly from gamma/50 to gamma over ``gamma_warmup`` steps
    and decays as 1/sqrt(1 + i / (20 warmup)).  A step that leaves the
    loss or any leaf non-finite is skipped: NaN in the loss trace, the
    model and Adam's state kept, and an adaptive scale on gamma halved
    (floor 1e-3; it recovers by 5% a finite step).  The steps run in
    ``NatgradSteps``.

    ``segment=None``: one run, the final state returned.  ``segment=k``: a
    host fence every k steps, and at each the full-data loss; the returned
    model is the best of the final state, the segment-boundary state of
    the lowest full-data loss and, with ``polish_steps``, that state
    refined by ``natgrad_polish``.  Returns (model, losses numpy), or with
    ``return_info`` (model, losses, info): n_skipped, the steps Adam took,
    the full-data losses at segment boundaries, which state was returned,
    and the polish's record.  The caller's model is left unchanged."""
    run = NatgradSteps(copy_params(model), x, y, num_steps, gamma, num_data,
                       learning_rate, gamma_warmup, batch_fn)
    model = run.model

    def full_loss(m) -> float:
        with torch.no_grad():
            return float(m.loss(x, y, num_data))

    if segment is None:
        losses = run.segment(num_steps)
        info = {"n_skipped": int(np.isnan(losses).sum()), "adam_steps": int(run.adam.t),
                "returned": "final"}
        return (model, losses, info) if return_info else (model, losses)

    lengths = [segment] * (num_steps // segment)
    if num_steps % segment:
        lengths.append(num_steps % segment)
    losses_out, full_trace = [], []
    best_model, best_full = None, np.inf
    for length in lengths:
        losses_out.append(run.segment(length))
        # best-state selection on the full-data objective, at segment ends
        fl = full_loss(model)
        full_trace.append(fl)
        if np.isfinite(fl) and fl < best_full:
            # a copy: later steps write the leaves in place
            best_full, best_model = fl, copy_params(model)
    losses = np.concatenate(losses_out)
    final_full = full_trace[-1]
    returned, out = "final", model
    if best_model is not None and best_full < final_full:
        returned, out = "best_segment", best_model
    polish_info = None
    if polish_steps and best_model is not None:
        pol, pol_losses = natgrad_polish(out, x, y, num_steps=polish_steps,
                                         gamma=polish_gamma, num_data=num_data)
        pol_full = full_loss(pol)
        polish_info = {"steps": polish_steps, "gamma": polish_gamma,
                       "full_loss_before": min(best_full, final_full),
                       "full_loss_after": pol_full,
                       "n_skipped": int(np.isnan(pol_losses).sum())}
        if np.isfinite(pol_full) and pol_full < min(best_full, final_full):
            returned, out = "polished", pol
    if return_info:
        info = {"n_skipped": int(np.isnan(losses).sum()), "adam_steps": int(run.adam.t),
                "full_loss_at_segments": [round(v, 2) for v in full_trace],
                "returned": returned, "polish": polish_info}
        return out, losses, info
    return out, losses
