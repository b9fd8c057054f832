"""Collapsed sparse GP regression (Titsias bound) and the source-separation
variant SGPRSS.

Counterpart of gpitch_tpu/models/sgpr.py (SGPR, SGPRSS; the lag-table path
is not ported yet).  Every tensor may carry leading batch axes: a window
bank is one SGPRSS whose leaves have a window axis first, ``elbo`` returns
one bound per window, and each covariance, factorization and product is
one batched op over the windows.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..config import NumericsConfig
from ..core.params import Param, static_field
from ..core.transforms import Positive
from ..kernels.base import StackedSum
from ..kernels.spectral import Matern12sm
from ..linalg.fused_whiten import MAX_M, fused_whiten
from ..linalg.ops import safe_chol_inv

__all__ = ["SGPR", "SGPRSS", "check_on_grid"]

_LOG2PI = 1.8378770664093453


def check_on_grid(X, Z, grid_dt: float) -> None:
    """Raise ValueError unless every X and Z value is a multiple of the
    sample spacing ``grid_dt`` (to 1e-3 of a step)."""
    for v in (np.asarray(X) / grid_dt, np.asarray(Z) / grid_dt):
        if np.max(np.abs(v - np.round(v))) > 1e-3:
            raise ValueError("grid_dt: inputs are not on the grid")


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


@dataclasses.dataclass
class SGPR:
    """Collapsed SGPR.  ``mask`` ((..., N) in {0, 1}, optional) marks valid
    data points: with zero-padded rows the bound equals the unpadded one.

    X and Z are stored centered on ``x0`` (the f64 minimum of the valid
    inputs, subtracted on the host before the cast), which keeps f32
    distances and cosine arguments small; ``x0`` is kept as a double-single
    (hi, lo) pair so Xnew - hi - lo is exact to f32.
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
    numerics: NumericsConfig = static_field(NumericsConfig())

    @classmethod
    def create(cls, X, Y, kern, Z, noise_variance=1.0, mask=None, reg=False,
               numerics=NumericsConfig(), grid_dt=None, center=True,
               dtype=torch.float32):
        """One model from host arrays.  ``grid_dt``: validate that every X and
        Z value is a multiple of the sample spacing (raises ValueError
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

        def data(v):
            return Param.create(v, trainable=False, dtype=dtype)

        return cls(kern=kern,
                   variance=Param.create(noise_variance, Positive(), dtype=dtype),
                   X=data(X), Y=data(np.asarray(Y).reshape(-1, 1)), Z=data(Z),
                   x0=data(x0_hi), x0_lo=data(x0_lo),
                   mask=None if mask is None else data(np.asarray(mask).reshape(-1)),
                   reg=reg, numerics=numerics)

    @property
    def mask_value(self):
        return None if self.mask is None else self.mask.value

    # ------------------------------------------------------------- bound
    def _covs(self):
        """(err, kdiag, kuf, kuu) with the mask applied."""
        x, y, z = self.X.value, self.Y.value, self.Z.value
        err = y
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
        """A StackedSum of Matern12sm and no mask: the chain the pair takes."""
        return (self.mask is None and isinstance(self.kern, StackedSum)
                and isinstance(self.kern.stacked, Matern12sm))

    def fused_eligible(self) -> bool:
        """Whether the bound takes the fused route (see ``_common``): a
        StackedSum of Matern12sm, no mask, M <= MAX_M, and float32 on the
        card (the kernels' type) or any type on the CPU (the plain
        versions).  Decided from the model's structure and dtype alone."""
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
        parameters; needs a stacked Matern12sm kernel and no mask."""
        if not self._stacked_matern12sm():
            raise ValueError("fused_whiten_args: needs a StackedSum of "
                             "Matern12sm and no mask")
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
        other model (a Sum, a mask, M > 160, float64 on the card) takes
        ``_common_unfused``.  A kernel that fails to build or launch
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
        # B = I + AAT has eigenvalues >= 1: no jitter of either kind
        LB, LB_inv = safe_chol_inv(B, 0.0, jitter_rel=0.0)
        c = (LB_inv @ Aerr) / sigma2
        return AAT, (LB, LB_inv), c, sigma2

    def elbo(self):
        """The collapsed bound, (...) per model."""
        err, kdiag, _, _, AAT, (LB, _), c, sigma2 = self._common()
        sigma2 = sigma2[..., 0, 0]
        if self.mask is not None:
            num_data = self.mask_value.sum(-1)
        else:
            num_data = torch.tensor(float(err.shape[-2]), dtype=err.dtype,
                                    device=err.device)
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
        reuse = xnew_is_x and stacked and s <= source_batch

        kis = None
        if reuse:
            kis = self.kern.K_terms_fwd(x, Xnew)             # (..., S, N, N)
            kxx = kis.sum(-3)
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
