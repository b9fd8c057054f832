"""Dense GP regression (GPR), the collapsed sparse GP regression bound
(SGPR, Titsias) and the source-separation variant SGPRSS.

Counterpart of gpitch_tpu/models/sgpr.py.  Every tensor of an SGPR may
carry leading batch axes: a window bank is one SGPRSS whose leaves have a
window axis first, ``elbo`` returns one bound per window, and each
covariance, factorization and product is one batched op over the windows.
With ``lag_table`` the covariances of an on-grid model are gathered from
one stationary table per window instead of built directly.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from ..config import NumericsConfig
from ..core.params import Param, static_field
from ..core.transforms import Positive
from ..kernels.base import StackedSum
from ..kernels.spectral import Matern12sm
from ..linalg.fused_whiten import MAX_M, fused_whiten
from ..linalg.ops import safe_chol_inv, safe_cholesky, solve_lower

__all__ = ["GPR", "SGPR", "SGPRSS", "check_on_grid"]

_LOG2PI = 1.8378770664093453


def check_on_grid(X, Z, grid_dt: float) -> None:
    """Raise ValueError unless every X and Z value is a multiple of the
    sample spacing ``grid_dt`` (to 1e-3 of a step)."""
    for v in (np.asarray(X) / grid_dt, np.asarray(Z) / grid_dt):
        if np.max(np.abs(v - np.round(v))) > 1e-3:
            raise ValueError("grid_dt: inputs are not on the grid")


@functools.lru_cache(maxsize=64)
def _constant(value: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A 0-d tensor of ``value``, made once per (value, dtype, device): made
    at every bound evaluation it would be a host-to-device copy, which a
    CUDA graph cannot capture."""
    return torch.tensor(value, dtype=dtype, device=device)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


@dataclasses.dataclass
class GPR:
    """Dense GP regression through torch.linalg (the model KernelGPR
    interpolates with)."""

    kern: Any = None
    variance: Any = None          # likelihood noise
    X: Any = None                 # (N, D), fixed
    Y: Any = None                 # (N, 1), fixed
    numerics: NumericsConfig = static_field(NumericsConfig())

    @classmethod
    def create(cls, X, Y, kern, noise_variance=1.0, numerics=NumericsConfig(),
               dtype=torch.float32):
        return cls(kern=kern,
                   variance=Param.create(noise_variance, Positive(), dtype=dtype),
                   X=Param.create(X, trainable=False, dtype=dtype),
                   Y=Param.create(Y, trainable=False, dtype=dtype), numerics=numerics)

    def _chol(self):
        K = self.kern.K(self.X.value)
        Ky = K + self.variance.value * _eye(K.shape[-1], K)
        return safe_cholesky(Ky, self.numerics.jitter_value(K.dtype))

    def log_marginal_likelihood(self):
        y = self.Y.value
        L = self._chol()
        alpha = solve_lower(L, y)
        return (-0.5 * alpha.square().sum()
                - torch.log(torch.diagonal(L)).sum()
                - 0.5 * y.shape[0] * _LOG2PI)

    def build_likelihood(self):
        return self.log_marginal_likelihood()

    def loss(self):
        return -self.log_marginal_likelihood()

    def predict_f(self, Xnew):
        """Posterior mean (Nnew, 1) and variance (Nnew, 1) at Xnew."""
        L = self._chol()
        A = solve_lower(L, self.kern.K(self.X.value, Xnew))
        V = solve_lower(L, self.Y.value)
        var = self.kern.Kdiag(Xnew) - A.square().sum(0)
        return A.mT @ V, var[:, None]


@dataclasses.dataclass
class SGPR:
    """Collapsed SGPR.  ``mask`` ((..., N) in {0, 1}, optional) marks valid
    data points: with zero-padded rows the bound equals the unpadded one.

    X and Z are stored centered on ``x0`` (the f64 minimum of the valid
    inputs, subtracted on the host before the cast), which keeps f32
    distances and cosine arguments small; ``x0`` is kept as a double-single
    (hi, lo) pair so Xnew - hi - lo is exact to f32.

    ``lag_table`` (off by default, as in the JAX package): on a uniform
    grid of step ``grid_dt`` a stationary k(|x - x'|) takes only
    ``num_lags`` distinct values, so Kuf, Kuu and the diagonal are gathered
    from one table k(l grid_dt), l < num_lags, of the (summed) kernel per
    window: exact, not an approximation.  Such a model never takes the
    fused pair (``fused_eligible``).  Its covariances are gathered by
    rounded integer lag, so d(bound)/dX and d(bound)/dZ are zero there;
    X and Z are not trainable.
    """

    kern: Any = None
    variance: Any = None          # likelihood noise, (...)
    X: Any = None                 # (..., N, 1), centered
    Y: Any = None                 # (..., N, 1)
    Z: Any = None                 # (..., M, 1), centered
    x0: Any = None                # (...), high part of the offset
    x0_lo: Any = None             # (...), low part
    mask: Any = None              # (..., N) or None
    reg: bool = static_field(False)
    reg_beta: float = static_field(1000.0)
    grid_dt: Any = static_field(None)      # uniform-grid spacing or None
    num_lags: int = static_field(0)        # lag-table length (grid mode)
    lag_table: bool = static_field(False)  # the lag-table route
    numerics: NumericsConfig = static_field(NumericsConfig())

    @classmethod
    def create(cls, X, Y, kern, Z, noise_variance=1.0, mask=None, reg=False,
               numerics=NumericsConfig(), grid_dt=None, num_lags=None,
               center=True, lag_table=False, dtype=torch.float32):
        """One model from host arrays.  ``grid_dt``: validate that every X and
        Z value is a multiple of the sample spacing (raises ValueError
        otherwise).  With it, ``lag_table=True`` takes the table route:
        ``num_lags`` (default: the index span of X and Z) must cover that
        span, and the kernel must have ``k_r`` (NotImplementedError
        otherwise)."""
        xarr = np.asarray(X, dtype=np.float64).reshape(-1)
        zarr = np.asarray(Z, dtype=np.float64).reshape(-1)
        xvalid = xarr
        if mask is not None:
            mvalid = np.asarray(mask).reshape(-1) > 0
            xvalid = xarr[mvalid] if mvalid.any() else xarr
        x0 = float(min(xvalid.min(), zarr.min())) if center else 0.0
        x0_hi = float(np.float32(x0))
        x0_lo = x0 - x0_hi
        X = (xarr - x0).reshape(-1, 1)
        Z = (zarr - x0).reshape(-1, 1)
        if grid_dt is not None:
            check_on_grid(X, Z, grid_dt)
            allv = np.concatenate([X.reshape(-1), Z.reshape(-1)]) / grid_dt
            span = int(np.round(allv.max() - allv.min())) + 1
            if num_lags is not None and num_lags < span:
                # a short table would clamp lags and corrupt Kuf and Kuu
                raise ValueError(f"num_lags={num_lags} < index span {span} of X union Z")
            if lag_table:
                kern.k_r(torch.zeros(1, dtype=dtype))   # raises if not stationary
                num_lags = span if num_lags is None else num_lags
            else:
                num_lags = 0
        else:
            num_lags = 0

        def data(v):
            return Param.create(v, trainable=False, dtype=dtype)

        return cls(kern=kern,
                   variance=Param.create(noise_variance, Positive(), dtype=dtype),
                   X=data(X), Y=data(np.asarray(Y).reshape(-1, 1)), Z=data(Z),
                   x0=data(x0_hi), x0_lo=data(x0_lo),
                   mask=None if mask is None else data(np.asarray(mask).reshape(-1)),
                   reg=reg, grid_dt=grid_dt, num_lags=num_lags,
                   lag_table=bool(lag_table and grid_dt is not None), numerics=numerics)

    @property
    def mask_value(self):
        return None if self.mask is None else self.mask.value

    # ------------------------------------------------- the lag-table route
    def _grid_t0(self):
        """(...) the least of X and Z, masked samples included."""
        return torch.minimum(self.X.value[..., 0].amin(-1), self.Z.value[..., 0].amin(-1))

    def _grid_index(self, v, t0):
        """Integer grid positions of v (..., K) from t0 (...), int64 (the
        index type of torch.gather)."""
        return torch.round((v - t0[..., None]) / self.grid_dt).long()

    def _grid_indices(self):
        """Grid positions of X and Z, offset to start at 0."""
        t0 = self._grid_t0()
        return (self._grid_index(self.X.value[..., 0], t0),
                self._grid_index(self.Z.value[..., 0], t0))

    def _lag_table(self):
        """(..., num_lags): k(l grid_dt) of the whole (summed) kernel, one
        table per model."""
        x = self.X.value
        r = torch.arange(self.num_lags, dtype=x.dtype, device=x.device) * self.grid_dt
        return self.kern.k_r(r)

    @staticmethod
    def _gather(table, i, j):
        """table[..., |i[:, None] - j[None, :]|]: (..., len(i), len(j))."""
        lags = (i[..., :, None] - j[..., None, :]).abs()
        return torch.gather(table[..., None, :].expand(lags.shape[:-1] + table.shape[-1:]),
                            -1, lags)

    # ------------------------------------------------------------- bound
    def _covs(self):
        """(err, kdiag, kuf, kuu) with the mask applied."""
        x, y, z = self.X.value, self.Y.value, self.Z.value
        err = y
        if self.lag_table:
            ix, iz = self._grid_indices()
            table = self._lag_table()
            kuf = self._gather(table, iz, ix)
            kuu = self._gather(table, iz, iz)
            kdiag = table[..., :1].expand(x.shape[:-1])
        else:
            kdiag = self.kern.Kdiag(x)
            kuf = self.kern.K(z, x)
            kuu = self.kern.K(z)
        if self.mask is not None:
            mv = self.mask_value
            err = err * mv[..., :, None]
            kdiag = kdiag * mv
            kuf = kuf * mv[..., None, :]
        return err, kdiag, kuf, kuu

    def _linv(self, kuu):
        """Linv of Kuu as the bound factors it."""
        return safe_chol_inv(kuu, self.numerics.jitter_value(kuu.dtype))[1]

    def _stacked_matern12sm(self) -> bool:
        """A StackedSum of Matern12sm, no mask, no lag table: the chain the
        pair takes."""
        return (self.mask is None and not self.lag_table
                and isinstance(self.kern, StackedSum)
                and isinstance(self.kern.stacked, Matern12sm))

    def fused_eligible(self) -> bool:
        """Whether the bound takes the fused route (see ``_common``): a
        StackedSum of Matern12sm, no mask, no lag table, M <= MAX_M, and
        float32 on the card (the kernels' type) or any type on the CPU (the
        plain versions).  Decided from the model's structure and dtype
        alone."""
        if not self._stacked_matern12sm():
            return False
        z = self.Z.raw
        if z.shape[-2] > MAX_M:
            return False
        return z.device.type == "cpu" or (z.is_cuda and z.dtype == torch.float32)

    def fused_whiten_args(self):
        """(zc, xc, err, Linv, energy, freq, var, inv_l): the arguments of
        ``linalg.fused_whiten`` for this bound's Kuf -> A -> (A A^T, A err)
        chain, so that its U / sigma^2 and v are ``_common``'s AAT and Aerr.
        The leading axes are flattened into the window axis (a model without
        one gets a window axis of 1).  Differentiable in the kernel's
        parameters; needs a stacked Matern12sm kernel, no mask and no lag
        table."""
        if not self._stacked_matern12sm():
            raise ValueError("fused_whiten_args: needs a StackedSum of "
                             "Matern12sm, no mask and no lag table")
        st = self.kern.stacked
        z, x, y = self.Z.value, self.X.value, self.Y.value
        m, n = z.shape[-2], x.shape[-2]
        params = (st.energy.value, st.frequency.value, st.variance.value,
                  1.0 / st.lengthscales.value)
        if params[0].dim() > 2:            # per-window parameters
            s, p = params[0].shape[-2:]
            params = (params[0].reshape(-1, s, p), params[1].reshape(-1, s, p),
                      params[2].reshape(-1, s), params[3].reshape(-1, s))
        return (z.reshape(-1, m, 1), x.reshape(-1, 1, n), y.reshape(-1, 1, n),
                self._linv(self.kern.K(z)).reshape(-1, m, m)) + params

    def _common(self):
        """(err, kdiag, L_inv, A, AAT, (LB, LB_inv), c, sigma2) of the bound.

        Routing, by the model's structure and dtype before any launch
        (``fused_eligible``): a StackedSum of Matern12sm with no mask, M <=
        MAX_M (160), in float32 on the card or any type on the CPU, takes
        the fused pair: ``fused_whiten`` (kernel A forward, kernel B
        backward; their plain versions on the CPU) gives AAT * sigma2 and
        Aerr without writing Kuf or A, and A is returned as None.  Every
        other model (a Sum, a mask, a lag table, M > 160, float64 on the
        card) takes ``_common_unfused``.  A kernel that fails to build or launch
        raises: no route gives way to the other."""
        if not self.fused_eligible():
            return self._common_unfused()
        err = self.Y.value
        kdiag = self.kern.Kdiag(self.X.value)
        sigma2 = self.variance.value[..., None, None]
        args = self.fused_whiten_args()
        lead, m = err.shape[:-2], args[3].shape[-1]
        L_inv = args[3].reshape(lead + (m, m))
        U, v = fused_whiten(*args)
        AAT = U.reshape(lead + (m, m)) / sigma2
        Aerr = v.reshape(lead + (m, 1))
        return (err, kdiag, L_inv, None) + self._finish(AAT, Aerr, sigma2)

    def _common_unfused(self):
        """``_common`` by the plain composition: Kuf and A = L_inv Kuf built
        as tensors (A is returned)."""
        err, kdiag, kuf, kuu = self._covs()
        sigma2 = self.variance.value[..., None, None]
        L_inv = self._linv(kuu)
        # 1/sigma2 scales the (M, M) and (M, 1) products, not the (M, N) A
        A = L_inv @ kuf
        AAT = (A @ A.mT) / sigma2
        return (err, kdiag, L_inv, A) + self._finish(AAT, A @ err, sigma2)

    @staticmethod
    def _finish(AAT, Aerr, sigma2):
        """(AAT, (LB, LB_inv), c, sigma2) from AAT and Aerr."""
        B = AAT + _eye(AAT.shape[-1], AAT)
        # B = I + AAT has eigenvalues >= 1: no jitter of either kind.  At a
        # small noise variance its condition number nears 1 / eps of
        # float32, and float32 factors of it put the gradient at a state
        # that L-BFGS reaches 1.7e-4 to 3.0e-4 from f64, the largest error
        # left there (tests/test_torch_fused_whiten_trained.py): B is
        # factored in float64 and its factors rounded once.  c = LB^-1 Aerr
        # / sigma2 is formed from the float64 factor and rounded once too:
        # at the card's own f32 L-BFGS state a float32 c put the gradient
        # 2.9e-4 from f64 on the CPU, 1.5e-4 with this c, the largest part
        # (tests/test_torch_hmc_bank_state.py).
        LB, LB_inv = safe_chol_inv(B.double(), 0.0, jitter_rel=0.0)
        c = ((LB_inv @ Aerr.to(LB_inv.dtype)) / sigma2.to(LB_inv.dtype)).to(B.dtype)
        LB, LB_inv = LB.to(B.dtype), LB_inv.to(B.dtype)
        return AAT, (LB, LB_inv), c, sigma2

    def elbo(self):
        """The collapsed bound, (...) per model."""
        err, kdiag, _, _, AAT, (LB, _), c, sigma2 = self._common()
        sigma2 = sigma2[..., 0, 0]
        if self.mask is not None:
            num_data = self.mask_value.sum(-1)
        else:
            num_data = _constant(float(err.shape[-2]), err.dtype, err.device)
        outdim = err.shape[-1]
        bound = -0.5 * num_data * outdim * _LOG2PI
        bound = bound - outdim * torch.log(torch.diagonal(LB, dim1=-2, dim2=-1)).sum(-1)
        bound = bound - 0.5 * num_data * outdim * torch.log(sigma2)
        bound = bound - 0.5 * err.square().sum((-2, -1)) / sigma2
        bound = bound + 0.5 * c.square().sum((-2, -1))
        bound = bound - 0.5 * outdim * kdiag.sum(-1) / sigma2
        bound = bound + 0.5 * outdim * torch.diagonal(AAT, dim1=-2, dim2=-1).sum(-1)
        if self.reg:
            pen = self.reg_beta * self._l1_variances()
            if self.mask is not None:
                # a fully masked window contributes exactly zero
                pen = torch.where(num_data > 0, pen, torch.zeros_like(pen))
            bound = bound - pen
        return bound

    def build_likelihood(self):
        """The reference's name for the collapsed bound (``elbo``)."""
        return self.elbo()

    def _l1_variances(self):
        """L1 penalty over the per-pitch kernel variances."""
        if isinstance(self.kern, StackedSum):
            return self.kern.stacked.variance.value.abs().sum(-1)
        kerns = getattr(self.kern, "kern_list", (self.kern,))
        return sum(k.variance.value.abs() for k in kerns)

    def loss(self):
        return -self.elbo()

    def _center(self, Xnew, pre_centered: bool):
        if pre_centered:
            return Xnew
        # stored X/Z are centered; the (hi, lo) subtraction keeps f32 exact
        return ((Xnew - self.x0.value[..., None, None])
                - self.x0_lo.value[..., None, None])

    # ----------------------------------------------------------- predict
    @torch.no_grad()
    def predict_f(self, Xnew, pre_centered: bool = False):
        """Titsias posterior (mean (..., Nnew, 1), var (..., Nnew, 1)) at Xnew;
        the cross-covariance is built by the spectral-mixture kernel."""
        Xnew = self._center(Xnew, pre_centered)
        _, _, L_inv, _, _, (_, LB_inv), c, _ = self._common()
        kus = self.kern.K_fwd(self.Z.value, Xnew)
        tmp1 = L_inv @ kus
        tmp2 = LB_inv @ tmp1
        mean = tmp2.mT @ c
        var = (self.kern.Kdiag(Xnew) + tmp2.square().sum(-2)
               - tmp1.square().sum(-2))
        return mean, var[..., None]


@dataclasses.dataclass
class SGPRSS(SGPR):
    """SGPR with per-source posterior prediction: the model kernel is a sum
    over per-pitch kernels, and ``predict_s`` returns the posterior of each
    additive component given the mixture, through the full-data Cholesky of
    K + sigma^2 I."""

    @torch.no_grad()
    def predict_s(self, Xnew, pre_centered: bool = False,
                  source_batch: int = 8, xnew_is_x: bool = False):
        """([(..., Nnew, 1) means], [(..., Nnew, 1) variances]), one per
        source.

        ``source_batch``: sources are built in chunks of this size, bounding
        the (chunk, N, Nnew) intermediates.  ``xnew_is_x``: the caller asserts
        Xnew is the training input; the per-source Grams are then built once
        and their sum is the full Gram (only when all sources fit one chunk).
        Each source's variance is taken from its own diagonal.
        """
        Xnew = self._center(Xnew, pre_centered)
        x, y = self.X.value, self.Y.value
        sigma2 = self.variance.value[..., None, None]
        stacked = isinstance(self.kern, StackedSum)
        s = self.kern.num_terms if stacked else None
        reuse = xnew_is_x and not self.lag_table and stacked and s <= source_batch

        kis = None
        if reuse:
            kis = self.kern.K_terms_fwd(x, Xnew)             # (..., S, N, N)
            kxx = kis.sum(-3)
        elif self.lag_table:
            ix = self._grid_index(x[..., 0], self._grid_t0())
            kxx = self._gather(self._lag_table(), ix, ix)
        else:
            kxx = self.kern.K_fwd(x)
        mv = self.mask_value
        if mv is not None:
            # padded rows/cols become unit-diagonal noise, decoupled from data
            kxx = kxx * (mv[..., :, None] * mv[..., None, :])
            y = y * mv[..., :, None]
        ky = kxx + sigma2 * _eye(kxx.shape[-1], kxx)
        _, L_inv = safe_chol_inv(ky, self.numerics.jitter_value(ky.dtype))
        V = L_inv @ y

        def finish(kxi, kdiag_i):
            """(..., S', N, Nnew) cross-covs + (..., S', Nnew) prior diags."""
            if mv is not None:
                kxi = kxi * mv[..., None, :, None]
            A = L_inv[..., None, :, :] @ kxi
            mean = A.mT @ V[..., None, :, :]                 # (..., S', Nnew, 1)
            return mean, kdiag_i - A.square().sum(-2)

        if stacked:
            kdiags = self.kern.Kdiag_terms(Xnew)             # (..., S, Nnew)
            if reuse:
                mean, svar = finish(kis, kdiags)
            else:
                cs = max(1, min(source_batch, s))
                parts = [finish(self.kern.K_terms_fwd(x, Xnew, slice(c0, c0 + cs)),
                                kdiags[..., c0:c0 + cs, :])
                         for c0 in range(0, s, cs)]
                mean = torch.cat([p[0] for p in parts], dim=-3)
                svar = torch.cat([p[1] for p in parts], dim=-2)
            return ([mean[..., i, :, :] for i in range(s)],
                    [svar[..., i, :, None] for i in range(s)])

        means, variances = [], []
        for k in self.kern.kern_list:
            mean, svar = finish(k.K_fwd(x, Xnew)[..., None, :, :],
                                k.Kdiag(Xnew)[..., None, :])
            means.append(mean[..., 0, :, :])
            variances.append(svar[..., 0, :, None])
        return means, variances
