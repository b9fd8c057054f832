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
as the JAX package's ``pick(st2, st)`` does.  Deciding that on the host is
one sync per step; the step is host-bound (the device idles between its
launches), so the sync costs little, and Adam's bias corrections stay the
host-side ones of ``fit.Adam``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from ..core.params import Param, copy_params, named_params
from ..linalg.ops import add_jitter, safe_cholesky
from .fit import Adam

__all__ = ["natgrad_step", "natgrad_polish", "fit_natgrad_adam"]

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


def natgrad_step(model, x, y, gamma: float = 0.1, num_data: int | None = None):
    """One natural-gradient step on both variational banks of a ModGP
    (activation and component); the hyperparameters are untouched.
    Returns a new model."""
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

    def param(p: Param, value):
        return Param(p.transform.inverse_tensor(value), p.transform, p.trainable)

    return dataclasses.replace(
        model, q_mu_act=param(model.q_mu_act, mu_a2),
        q_sqrt_act=param(model.q_sqrt_act, La2),
        q_mu_com=param(model.q_mu_com, mu_c2),
        q_sqrt_com=param(model.q_sqrt_com, Lc2))


def _all_finite(model, loss, extra=()) -> bool:
    """Whether the loss and every raw leaf of the model (and ``extra``)
    are finite: one host sync."""
    flat = [loss.detach().reshape(-1)] + [t.detach().reshape(-1) for t in extra]
    flat += [p.raw.detach().reshape(-1) for _, p in named_params(model)]
    return bool(torch.isfinite(torch.cat(flat)).all())


def _backoff(gscale: float, finite: bool) -> float:
    """The step-size scale: x1.05 (at most 1) after a finite step, x0.5 (at
    least 1e-3) after a skipped one."""
    return min(gscale * 1.05, 1.0) if finite else max(gscale * 0.5, 1e-3)


def natgrad_polish(model, x, y, num_steps: int = 200, gamma: float = 0.05,
                   num_data: int | None = None):
    """Full-batch natural-gradient steps only (hyperparameters frozen): from
    a (near-)converged state, fixed-size natural steps on the full-data ELBO
    walk q to its optimum for the current hyperparameters.  A non-finite
    step is skipped with the backoff of ``fit_natgrad_adam``.  Returns
    (model, losses numpy) with NaN on skipped steps."""
    losses = np.empty(num_steps)
    gscale = 1.0
    for i in range(num_steps):
        m2 = natgrad_step(model, x, y, gamma * gscale, num_data)
        with torch.no_grad():
            loss = m2.loss(x, y, num_data)
        finite = _all_finite(m2, loss)
        if finite:
            model = m2
        losses[i] = float(loss) if finite else np.nan
        gscale = _backoff(gscale, finite)
    return model, losses


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
    (floor 1e-3; it recovers by 5% a finite step).

    ``segment=None``: one run, the final state returned.  ``segment=k``: a
    host fence every k steps, and at each the full-data loss; the returned
    model is the best of the final state, the segment-boundary state of
    the lowest full-data loss and, with ``polish_steps``, that state
    refined by ``natgrad_polish``.  Returns (model, losses numpy), or with
    ``return_info`` (model, losses, info): n_skipped, the steps Adam took,
    the full-data losses at segment boundaries, which state was returned,
    and the polish's record.  The caller's model is left unchanged."""
    model = copy_params(model)
    hypers = [p.raw for name, p in named_params(model)
              if p.trainable and name not in ["." + b for b in _BANKS]]
    adam = Adam(hypers, lr=learning_rate)
    warm = max(gamma_warmup, 1)
    step_i, gscale = 0, 1.0

    def full_loss(m) -> float:
        with torch.no_grad():
            return float(m.loss(x, y, num_data))

    def run(m, length):
        nonlocal step_i, gscale
        out = torch.empty(length, dtype=hypers[0].dtype, device=hypers[0].device)
        skipped = []
        for i in range(length):
            xb, yb = batch_fn() if batch_fn is not None else (x, y)
            ramp = min(1.0, (step_i + 1.0) / warm)
            decay = 1.0 / math.sqrt(1.0 + step_i / (20.0 * warm))
            m2 = natgrad_step(m, xb, yb, gamma * (0.02 + 0.98 * ramp) * gscale * decay,
                              num_data)
            with torch.enable_grad():
                loss = m2.loss(xb, yb, num_data)
                grads = torch.autograd.grad(loss, hypers, allow_unused=True)
            grads = [torch.zeros_like(h) if g is None else g for h, g in zip(hypers, grads)]
            proposal = adam.propose(grads)
            finite = _all_finite(m2, loss, proposal[0])
            if finite:
                adam.commit(*proposal)
                m = m2
            else:
                skipped.append(i)
            out[i] = loss.detach()
            gscale = _backoff(gscale, finite)
            step_i += 1
        losses = out.cpu().numpy().astype(np.float64)
        losses[skipped] = np.nan
        return m, losses

    if segment is None:
        model, losses = run(model, num_steps)
        info = {"n_skipped": int(np.isnan(losses).sum()), "adam_steps": int(adam.t),
                "returned": "final"}
        return (model, losses, info) if return_info else (model, losses)

    lengths = [segment] * (num_steps // segment)
    if num_steps % segment:
        lengths.append(num_steps % segment)
    losses_out, full_trace = [], []
    best_model, best_full = None, np.inf
    for length in lengths:
        model, losses = run(model, length)
        losses_out.append(losses)
        # best-state selection on the full-data objective, at segment ends
        fl = full_loss(model)
        full_trace.append(fl)
        if np.isfinite(fl) and fl < best_full:
            # a copy: later Adam steps write the hyperparameters in place
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
        info = {"n_skipped": int(np.isnan(losses).sum()), "adam_steps": int(adam.t),
                "full_loss_at_segments": [round(v, 2) for v in full_trace],
                "returned": returned, "polish": polish_info}
        return out, losses, info
    return out, losses
