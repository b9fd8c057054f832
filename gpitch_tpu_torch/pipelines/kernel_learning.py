"""Kernel learning from isolated-note recordings (the 'train' kernel mode).

Counterpart of gpitch_tpu/pipelines/kernel_learning.py:

* ``sample_cov`` and the other sampling helpers: a Monte-Carlo covariance
  of random windows of the note, on the host in numpy with the same
  ``default_rng(seed)`` draws as the JAX package, which keeps this data
  preprocessing on the host on purpose (the windows live there and the
  product is small); so the sampled matrices are the JAX package's bit for
  bit;
* ``fit_kernel``: the Matern-3/2-enveloped cosine mixture fitted to the
  sampled kernel by RMSE, with the sqrt(p^2) positivity, through the
  port's L-BFGS (models/_lbfgs.py: optax's L-BFGS and zoom linesearch,
  memory 20) on the port's device.  Problems are independent, so
  ``fit_kernels`` solves every pitch with the same parameter count in one
  batched solve, each with its own linesearch, and freezes a problem once
  its gradient norm is <= 1e-9 or its update is not finite.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..audio.spectrum import init_cparam
from ..config import DEFAULT_DEVICE, resolve_device
from ..models._lbfgs import lbfgs_run
from ..utils.math import find_ideal_f0

__all__ = ["sample_cov", "autocorr", "approximate_kernel", "fit_kernel",
           "fit_kernels", "gabor_sum", "fit_kernel_gabor", "get_samples",
           "comatrix", "get_cov", "fit", "fit2", "sample_cov_psd",
           "approximate_kernel_expdecay", "optimize_kern"]

_SQRT3 = math.sqrt(3.0)


# ------------------------------------------------------------ sampling (host)
def get_samples(y, num_sam: int = 10000, size: int = 441, seed: int = 0):
    """(num_sam, size) matrix of random windows of y."""
    y = np.asarray(y).reshape(-1)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, y.size - size, size=num_sam)
    return y[idx[:, None] + np.arange(size)[None, :]]


def comatrix(samples):
    """Average outer product of the sample windows, one X^T X product."""
    w = np.asarray(samples)
    return np.matmul(w.T, w) / w.shape[0]


def sample_cov(y, num_sam: int = 10000, size: int = 441, seed: int = 0):
    """(cov, kern, samples): the covariance of ``num_sam`` random windows of
    length ``size``, its first row peak-normalized as an (size, 1) column,
    and the windows."""
    windows = get_samples(y, num_sam=num_sam, size=size, seed=seed)
    cov = np.matmul(windows.T, windows) / num_sam
    kern = cov[0, :].copy().reshape(-1, 1)
    kern /= np.max(np.abs(kern))
    return cov, kern, windows


def get_cov(y, num_sam: int = 10000, size: int = 441, seed: int = 0):
    """``sample_cov`` under the reference's public name."""
    return sample_cov(y, num_sam=num_sam, size=size, seed=seed)


def autocorr(y, size: int):
    """Peak-normalized autocorrelation of y at lags 0..size-1, by FFT."""
    y = np.asarray(y).reshape(-1)
    nfft = int(2 ** np.ceil(np.log2(2 * y.size)))
    spec = np.fft.rfft(y, nfft)
    r_full = np.fft.irfft(spec * np.conj(spec), nfft)[:size]
    return (r_full / np.max(np.abs(r_full))).reshape(-1, 1)


def sample_cov_psd(y, niter: int = 1000, msize: int = 441, seed: int = 0):
    """The sampled covariance (summed, peak-normalized) projected onto the
    PSD cone by a Cholesky of the jittered estimate; and the samples."""
    s = get_samples(y, num_sam=niter, size=msize, seed=seed)
    cov = comatrix(s) * niter
    cov = cov / np.max(cov)
    lower = np.linalg.cholesky(cov + 1e-6 * np.eye(msize))
    return lower @ lower.T, list(s)


# ------------------------------------------------------------- fit forms
def _rows(p, x):
    """p as a tensor (..., D) and x as an (N,) tensor of p's type."""
    p = torch.as_tensor(p)
    return p, torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                              dtype=p.dtype, device=p.device).reshape(-1)


def _mixture(p, x):
    """sum_i v_i cos(2 pi f_i |x|) with sqrt(p^2) positivity, (..., N), and
    |x|; p = [bias, lengthscale, v_1..v_P, f_1..f_P] (..., D)."""
    npartials = (p.shape[-1] - 2) // 2
    x = x.abs()
    v = torch.sqrt(p[..., 2:2 + npartials].square())
    f = torch.sqrt(p[..., 2 + npartials:2 + 2 * npartials].square())
    ang = 2.0 * math.pi * f[..., None, :] * x[:, None]
    return (v[..., None, :] * torch.cos(ang)).sum(-1), x


def approximate_kernel(p, x):
    """The Matern-3/2-enveloped cosine mixture at x, (..., N)."""
    p, x = _rows(p, x)
    mix, x = _mixture(p, x)
    ell = torch.sqrt(p[..., 1:2] * p[..., 1:2])
    return (1.0 + _SQRT3 * x / ell) * torch.exp(-_SQRT3 * x / ell) * mix


def approximate_kernel_expdecay(p, x):
    """The exponential-decay (Matern-1/2) envelope variant, (..., N)."""
    p, x = _rows(p, x)
    mix, x = _mixture(p, x)
    ell = torch.sqrt(p[..., 1:2] * p[..., 1:2])
    return torch.exp(-x / ell) * mix


def gabor_sum(x, p):
    """Sum of Gabor atoms v exp(-|x| / l) cos(2 pi f x), p as (P, 3) rows
    [v, l, f] (a leading batch axis allowed: (..., 3 P))."""
    p, x = _rows(p, x)
    p = p.reshape(p.shape[:-1] + (-1, 3))
    v, l, f = p[..., 0], p[..., 1], p[..., 2]
    atoms = (v[..., None, :] * torch.exp(-x.abs()[:, None] / l[..., None, :])
             * torch.cos(2.0 * math.pi * f[..., None, :] * x[:, None]))
    return atoms.sum(-1)


def _rmse(form, p, x, target):
    return torch.sqrt((form(p, x) - target).square().mean(-1))


def _solve(form, p0, x, target, num_steps: int, best: bool):
    """L-BFGS (memory 20, zoom linesearch) on the RMSE of ``form`` against
    ``target``, one problem per row of p0 (B, D); returns the last rows
    (``best`` False) or the best-visited ones, and the losses (B, steps)."""
    def value(w):
        with torch.no_grad():
            return _rmse(form, w, x, target)

    def value_and_grad(w):
        with torch.enable_grad():
            p = w.detach().requires_grad_(True)
            v = _rmse(form, p, x, target)
            (g,) = torch.autograd.grad(v.sum(), p)
        return v.detach(), g

    w, losses, _, (best_w, _), _ = lbfgs_run(value_and_grad, value, p0, num_steps,
                                             memory_size=20, grad_tol=1e-9)
    return (best_w if best else w), losses


def _init_fit(audio, file_name, max_par: int, fs: float):
    """(frequencies, energies) of the note's FFT peaks, unscaled."""
    if0 = find_ideal_f0([file_name])[0]
    return init_cparam(np.asarray(audio).reshape(-1), fs=fs, maxh=max_par,
                       ideal_f0=if0, scaled=False)[0:2]


def fit_kernels(kerns, audios, file_names, max_par: int, fs: float,
                num_steps: int = 250, device=DEFAULT_DEVICE,
                dtype: torch.dtype = torch.float32):
    """``fit_kernel`` of every pitch: pitches whose FFTs give the same
    number of partials go through one batched solve.  Returns
    [(params, kern_init, kern_approx)] in the pitches' order, and the
    seconds of the solve each pitch was in."""
    import time
    dev = resolve_device(device)
    problems = []
    for kern, audio, name in zip(kerns, audios, file_names):
        kern = np.asarray(kern).reshape(-1)
        init_f, init_v = _init_fit(audio, name, max_par, fs)
        problems.append((kern, np.hstack([[0.0, 1.0], init_v, init_f])))
    out, seconds = [None] * len(problems), [0.0] * len(problems)
    for size in sorted({p0.size for _, p0 in problems}):
        group = [i for i, (_, p0) in enumerate(problems) if p0.size == size]
        n = problems[group[0]][0].size
        x = torch.as_tensor(np.linspace(0.0, (n - 1.0) / fs, n), dtype=dtype, device=dev)
        p0 = torch.as_tensor(np.stack([problems[i][1] for i in group]), dtype=dtype,
                             device=dev)
        target = torch.as_tensor(np.stack([problems[i][0] for i in group]), dtype=dtype,
                                 device=dev)
        t0 = time.perf_counter()
        pstar, _ = _solve(approximate_kernel, p0, x, target, num_steps, best=False)
        pstar = torch.sqrt(pstar.square())
        with torch.no_grad():
            k_init = approximate_kernel(p0, x).cpu().numpy()
            k_approx = approximate_kernel(pstar, x).cpu().numpy()
        pstar = pstar.cpu().numpy()
        spent = time.perf_counter() - t0
        npartials = (size - 2) // 2
        for row, i in enumerate(group):
            params = [pstar[row, 1], pstar[row, 2:npartials + 2], pstar[row, npartials + 2:]]
            out[i] = (params, k_init[row], k_approx[row])
            seconds[i] = spent
    return out, seconds


def fit_kernel(kern, audio, file_name, max_par: int, fs: float,
               num_steps: int = 250, device=DEFAULT_DEVICE,
               dtype: torch.dtype = torch.float32):
    """Fit [lengthscale, variances, frequencies] of the Matern-3/2 mixture
    to the sampled kernel ``kern``, from the FFT peaks of ``audio``: 250
    L-BFGS steps on the RMSE.  Returns (params, initial kernel, fitted
    kernel), numpy."""
    (res,), _ = fit_kernels([kern], [audio], [file_name], max_par, fs, num_steps,
                            device, dtype)
    return res


def fit_kernel_gabor(kern, audio, file_name, max_par: int, fs: float,
                     num_steps: int = 250, device=DEFAULT_DEVICE,
                     dtype: torch.dtype = torch.float32):
    """The Gabor-sum form fitted the same way (best-visited state).
    Returns (popt, initial sum, fitted sum), numpy."""
    kern = np.asarray(kern).reshape(-1)
    n = kern.size
    dev = resolve_device(device)
    x = torch.as_tensor(np.linspace(0.0, (n - 1.0) / fs, n), dtype=dtype, device=dev)
    init_f, init_v = _init_fit(audio, file_name, max_par, fs)
    p0 = torch.as_tensor(np.stack([init_v, 0.1 * np.ones_like(init_v), init_f], 1)
                         .reshape(1, -1), dtype=dtype, device=dev)
    target = torch.as_tensor(kern, dtype=dtype, device=dev)
    popt, _ = _solve(lambda p, xx: gabor_sum(xx, p), p0, x, target, num_steps, best=True)
    popt = torch.sqrt(popt.square())
    with torch.no_grad():
        return (popt[0].cpu().numpy(), gabor_sum(x, p0[0]).cpu().numpy(),
                gabor_sum(x, popt[0]).cpu().numpy())


# The reference's entry-point names.
fit = fit_kernel
fit2 = fit_kernel_gabor


def optimize_kern(x, y, p0, num_steps: int = 250, device=DEFAULT_DEVICE,
                  dtype: torch.dtype = torch.float32):
    """Fit the exponential-decay form to observations (x, y) from p0 by
    L-BFGS on the RMSE (best-visited state); returns sqrt(p^2), numpy."""
    dev = resolve_device(device)
    xt = torch.as_tensor(np.asarray(x).reshape(-1), dtype=dtype, device=dev)
    target = torch.as_tensor(np.asarray(y).reshape(-1), dtype=dtype, device=dev)
    p0 = torch.as_tensor(np.asarray(p0).reshape(1, -1), dtype=dtype, device=dev)
    pstar, _ = _solve(approximate_kernel_expdecay, p0, xt, target, num_steps, best=True)
    return np.sqrt(pstar[0].cpu().numpy() ** 2)
