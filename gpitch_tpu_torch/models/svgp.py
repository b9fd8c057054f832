"""Sparse variational modulated-GP model, ModGP (the reference's Pdgp).

Counterpart of gpitch_tpu/models/svgp.py.  Per source i an activation GP
g_i and a component GP f_i, each with its own inducing set and whitened
variational distribution, combined by ``ModulatedLikelihood`` (y = sum_i
nlin(g_i) f_i + eps).  Inducing inputs and variational parameters carry a
leading source axis, and a homogeneous kernel bank is stacked
(``stack_modules``), so every covariance, factorization and solve is one
batched op over the sources; with equal inducing counts the activation and
component banks are joined into one (2S, M, M) batch.

The factorization is torch.linalg's Cholesky and triangular solves, as the
JAX package takes jnp.linalg.cholesky and solve_triangular here: the
activation Gram at dense extrema inducing points is ill-conditioned, and
an explicit triangular inverse loses about cond(L)^2 in f32.  ``q_sqrt``
is stored packed (``FillTriangular``) in the JAX package's layout.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from ..config import DEFAULT_DEVICE, NumericsConfig, resolve_device
from ..core.params import Param, named_params, static_field, to_device
from ..core.transforms import FillTriangular
from ..kernels.base import stack_modules
from ..likelihoods import ModulatedLikelihood
from ..linalg.ops import base_conditional, gauss_kl, safe_cholesky
from ..utils.math import logistic

__all__ = ["ModGP", "predict_windowed"]


def _stack_z(z_list: Sequence[np.ndarray]) -> np.ndarray:
    """Per-source inducing inputs stacked to (S, M, 1): a shorter set is
    padded by repeating its last point, shifted by 1e-3 per copy."""
    z_list = [np.asarray(z).reshape(-1, 1) for z in z_list]
    m = max(z.shape[0] for z in z_list)
    padded = []
    for z in z_list:
        if z.shape[0] < m:
            pad = np.repeat(z[-1:], m - z.shape[0], axis=0)
            pad = pad + np.arange(1, m - z.shape[0] + 1).reshape(-1, 1) * 1e-3
            z = np.concatenate([z, pad], 0)
        padded.append(z)
    return np.stack(padded)


def _maybe_stack(kerns, dtype):
    """(True, stacked bank) for homogeneous kernels, else (False, tuple)."""
    for k in kerns:
        for name, p in named_params(k):
            if p.raw.dtype != dtype:
                raise ValueError(f"kernel Param {name} is {p.raw.dtype}: create the "
                                 f"kernels with dtype={dtype}, the model's")
    try:
        return True, stack_modules(kerns)
    except ValueError:
        return False, tuple(kerns)


@dataclasses.dataclass
class ModGP:
    """Modulated-GP SVGP model."""

    kern_act: Any = None          # stacked kernel bank (leading source axis) or tuple
    kern_com: Any = None
    likelihood: Any = None
    za: Any = None                # (S, Ma, 1)
    zc: Any = None                # (S, Mc, 1)
    q_mu_act: Any = None          # (S, Ma, 1)
    q_mu_com: Any = None          # (S, Mc, 1)
    q_sqrt_act: Any = None        # packed lower triangle (S, Ma (Ma + 1) / 2)
    q_sqrt_com: Any = None
    whiten: bool = static_field(True)
    num_sources: int = static_field(1)
    stacked_act: bool = static_field(True)
    stacked_com: bool = static_field(True)
    join_banks: bool = static_field(True)
    numerics: NumericsConfig = static_field(NumericsConfig())
    # the process group over which the sources are split
    # (parallel.mesh.shard_modgp_sources), or None
    source_group: Any = static_field(None)

    @classmethod
    def create(cls, z, kern, nlinfun=logistic, whiten=True, noise_variance=1.0,
               gh_points=20, numerics=NumericsConfig(), train_z=False,
               dtype=torch.float32, device=DEFAULT_DEVICE):
        """z: [za_list, zc_list]; kern: [kern_act_list, kern_com_list], the
        kernels created in ``dtype``.  q_mu starts at zero, q_sqrt at the
        identity; the inducing inputs are fixed unless ``train_z``.  Built
        on the host, moved to ``device`` ('cuda' unless the caller asks for
        'cpu') once."""
        kern_act, kern_com = list(kern[0]), list(kern[1])
        s = len(kern_act)
        za, zc = _stack_z(z[0]), _stack_z(z[1])
        ma, mc = za.shape[1], zc.shape[1]
        stacked_act, k_act = _maybe_stack(kern_act, dtype)
        stacked_com, k_com = _maybe_stack(kern_com, dtype)

        def eye(m):
            return np.tile(np.eye(m)[None], (s, 1, 1))

        model = cls(
            kern_act=k_act, kern_com=k_com,
            likelihood=ModulatedLikelihood.create(
                num_sources=s, nlinfun=nlinfun, variance=noise_variance,
                gh_points=gh_points, dtype=dtype),
            za=Param.create(za, trainable=train_z, dtype=dtype),
            zc=Param.create(zc, trainable=train_z, dtype=dtype),
            q_mu_act=Param.create(np.zeros((s, ma, 1)), dtype=dtype),
            q_mu_com=Param.create(np.zeros((s, mc, 1)), dtype=dtype),
            q_sqrt_act=Param.create(eye(ma), FillTriangular(ma), dtype=dtype),
            q_sqrt_com=Param.create(eye(mc), FillTriangular(mc), dtype=dtype),
            whiten=whiten, num_sources=s, stacked_act=stacked_act,
            stacked_com=stacked_com, numerics=numerics)
        return to_device(model, resolve_device(device))

    def _tensor(self, a) -> torch.Tensor:
        """An input as a tensor of the model's dtype on its device."""
        raw = self.za.raw
        return torch.as_tensor(a, dtype=raw.dtype, device=raw.device)

    def _jitter(self) -> float:
        return self.numerics.jitter_value(self.za.raw.dtype)

    # ------------------------------------------------------- conditionals
    def _can_join(self) -> bool:
        """Joining act and com into one (2S, M, M) batch needs equal
        inducing counts and stacked banks."""
        return (self.join_banks and self.stacked_act and self.stacked_com
                and self.za.raw.shape[1] == self.zc.raw.shape[1])

    def _banks_joint(self, xnew):
        """(mean, var) each (N, 2S), columns [act..., com...]."""
        za, zc = self.za.value, self.zc.value
        kmm = torch.cat([self.kern_act.K(za), self.kern_com.K(zc)])
        kmn = torch.cat([self.kern_act.K(za, xnew), self.kern_com.K(zc, xnew)])
        knn = torch.cat([self.kern_act.Kdiag(xnew), self.kern_com.Kdiag(xnew)])
        q_mu = torch.cat([self.q_mu_act.value, self.q_mu_com.value])
        q_sqrt = torch.cat([self.q_sqrt_act.value, self.q_sqrt_com.value])
        # an absolute jitter only, as the JAX package adds here
        lm = safe_cholesky(kmm, self._jitter(), jitter_rel=0.0)
        a = torch.linalg.solve_triangular(lm, kmn, upper=False)     # (2S, M, N)
        fvar = knn - a.square().sum(1)                              # (2S, N)
        if not self.whiten:
            a = torch.linalg.solve_triangular(lm.mT, a, upper=True)
        fmean = (a.mT @ q_mu)[..., 0]                                # (2S, N)
        fvar = fvar + (torch.tril(q_sqrt).mT @ a).square().sum(1)
        return fmean.mT, fvar.mT

    def _bank(self, which: str, xnew):
        """Marginal q(f) of every source of one bank: mean, var (N, S)."""
        if which == "act":
            kerns, stacked = self.kern_act, self.stacked_act
            z, q_mu, q_sqrt = self.za.value, self.q_mu_act.value, self.q_sqrt_act.value
        else:
            kerns, stacked = self.kern_com, self.stacked_com
            z, q_mu, q_sqrt = self.zc.value, self.q_mu_com.value, self.q_sqrt_com.value
        jitter = self._jitter()

        def one(kern, z_i, mu_i, sq_i):
            lm = safe_cholesky(kern.K(z_i), jitter)
            m, v = base_conditional(kern.K(z_i, xnew), lm, kern.Kdiag(xnew),
                                    mu_i, sq_i, self.whiten)
            return m[..., 0], v[..., 0]

        if stacked:
            means, variances = one(kerns, z, q_mu, q_sqrt)
        else:
            outs = [one(k, z[i], q_mu[i], q_sqrt[i]) for i, k in enumerate(kerns)]
            means = torch.stack([o[0] for o in outs])
            variances = torch.stack([o[1] for o in outs])
        return means.mT, variances.mT

    # --------------------------------------------------------------- ELBO
    def prior_kl(self):
        """Sum of the per-source KLs of both banks."""
        jitter = self._jitter()

        def kl_bank(kerns, stacked, z, q_mu, q_sqrt):
            if self.whiten:
                return gauss_kl(q_mu, q_sqrt).sum()
            if stacked:
                return gauss_kl(q_mu, q_sqrt, kerns.K(z), jitter).sum()
            return sum(gauss_kl(q_mu[i], q_sqrt[i], k.K(z[i]), jitter)
                       for i, k in enumerate(kerns))

        return (kl_bank(self.kern_act, self.stacked_act, self.za.value,
                        self.q_mu_act.value, self.q_sqrt_act.value)
                + kl_bank(self.kern_com, self.stacked_com, self.zc.value,
                          self.q_mu_com.value, self.q_sqrt_com.value))

    def elbo(self, x, y, num_data: int | None = None):
        """The ELBO; with ``num_data`` the data term of a minibatch is
        scaled by num_data / len(x)."""
        x, y = self._tensor(x), self._tensor(y)
        if self._can_join():
            fmu, fvar = self._banks_joint(x)
        else:
            mean_a, var_a = self._bank("act", x)
            mean_c, var_c = self._bank("com", x)
            fmu = torch.cat([mean_a, mean_c], dim=1)
            fvar = torch.cat([var_a, var_c], dim=1)
        reduce = None
        if self.source_group is not None:
            from ..parallel.mesh import sum_over_ranks

            def reduce(t):
                return sum_over_ranks(t, self.source_group)
        var_exp = self.likelihood.variational_expectations(fmu, fvar, y, reduce=reduce)
        scale = 1.0 if num_data is None else num_data / x.shape[0]
        kl = self.prior_kl()
        return var_exp.sum() * scale - (kl if reduce is None else reduce(kl))

    def loss(self, x, y, num_data: int | None = None):
        return -self.elbo(x, y, num_data)

    # --------------------------------------------------------- prediction
    @torch.no_grad()
    def predict_act(self, xnew):
        """(mean, var) of the activations, each (N, S)."""
        return self._bank("act", self._tensor(xnew))

    @torch.no_grad()
    def predict_com(self, xnew):
        """(mean, var) of the components, each (N, S)."""
        return self._bank("com", self._tensor(xnew))

    @torch.no_grad()
    def predict_act_n_com(self, xnew):
        """(m_a, v_a, m_c, v_c, m_s) each (N, S), with the source mean m_s =
        nlin(m_a) m_c."""
        mean_a, var_a = self.predict_act(xnew)
        mean_c, var_c = self.predict_com(xnew)
        return mean_a, var_a, mean_c, var_c, self.likelihood.nlinfun(mean_a) * mean_c

    def predict_source(self, xnew):
        return self.predict_act_n_com(xnew)[4]


def predict_windowed(model, xnew, ws: int = 1600, predict_fn=None):
    """``predict_act_n_com`` (or ``predict_fn(model, x)``) over chunks of
    ``ws`` points, concatenated: (m_a, v_a, m_c, v_c, m_s) each (N, S)."""
    predict_fn = predict_fn or (lambda m, x: m.predict_act_n_com(x))
    xnew = model._tensor(xnew)
    outs = [predict_fn(model, xnew[i:i + ws]) for i in range(0, xnew.shape[0], ws)]
    return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))
