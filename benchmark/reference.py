"""The plain reference of the benchmark's cells: plain numpy and torch.

It imports nothing of the program, and works out again from the raw
recording everything the program's set-up derives from it: the overlap
windows, the inducing points at each window's extrema, the pitch kernels
from the isolated notes' FFT, the collapsed SGPR bound of every window
(Titsias), its gradient by autograd, Adam, the per-source posteriors and
their Hann overlap-add merge.  The mathematics follows the reference
system's separation and transcription (arXiv:1810.12679, arXiv:1705.07104)
in the form the port states it: a window's kernel is a sum over pitches of
var_s exp(-|t - t'| / l_s) sum_p e_sp cos(2 pi f_sp (t - t')), every
positive parameter is softplus(raw) + 1e-6, and a model adds the jitter
of its configured type to its Grams (``JITTER``).

It runs in float64 for the truth, and in float32 with TF32 products (the
control: the next precision below the configuration's float32) where the
caller asks, always in blocks of windows so that it fits.
"""

from __future__ import annotations

import heapq
import math

import numpy as np
import torch

__all__ = ["JITTER", "window_stack", "extrema_points", "pad_inducing",
           "fft_init", "Problem", "make_problem", "bound", "loss_and_grad",
           "adam_steps", "predict_sources", "merge"]

LOG2PI = math.log(2.0 * math.pi)
# the jitter a model of each type adds to its Grams: absolute, relative to
# the mean diagonal, and the relative floor per row of the Gram (in float32
# 1e-4 + max(1e-5, 8e-7 M) mean(diag))
JITTER = {"float32": (1e-4, 1e-5, 8e-7), "float64": (1e-6, 0.0, 0.0)}
POSITIVE_FLOOR = 1e-6
ADAM = (0.9, 0.999, 1e-8)


# --------------------------------------------------------------- the host
def hann(ws: int) -> np.ndarray:
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(ws) / (ws - 1.0)))


def window_stack(y: np.ndarray, ws: int) -> np.ndarray:
    """(nw, ws) windows of y with hop (ws - 1) // 2."""
    hop = (ws - 1) // 2
    nw = (y.shape[0] - ws) // hop + 1
    return y[np.arange(nw)[:, None] * hop + np.arange(ws)[None, :]]


def _smooth(y: np.ndarray, win: int) -> np.ndarray:
    w = hann(win)
    return np.convolve(y, w, mode="same") / np.sum(w)


def extrema_points(x: np.ndarray, y: np.ndarray, dec: int, win: int = 9,
                   energy_win: int = 1600, thres: float = 0.0025,
                   min_points: int = 8) -> np.ndarray:
    """A window's inducing inputs: the extrema of the smoothed signal where
    the smoothed energy exceeds ``thres`` of its peak, every ``dec``-th;
    where fewer than ``min_points`` remain, 16 evenly spaced samples."""
    energy = _smooth(np.abs(y), energy_win)
    peak = energy.max()
    energy = energy / (peak if peak > 0 else 1.0)
    sign = np.sign(np.gradient(_smooth(y, win)))
    idx = np.where(np.diff(sign) != 0)[0]
    idx = idx[energy[idx] > thres][::dec]
    if idx.size < min_points:
        step = max(1, x.shape[0] // 16)
        return x[::step][:16].copy()
    return x[idx]


def _gap_fill(z: np.ndarray, need: int, dt: float) -> np.ndarray:
    """``need`` points at the middles of the widest gaps of the sorted
    on-grid ``z``, widest first, then after the last point."""
    base = z[0]
    idx = np.round((z - base) / dt).astype(np.int64)
    heap = [(-(int(b) - int(a)), int(a), int(b)) for a, b in zip(idx[:-1], idx[1:])]
    heapq.heapify(heap)
    new: list[float] = []
    while len(new) < need and heap and -heap[0][0] >= 2:
        g, lo, hi = heapq.heappop(heap)
        mid = lo + (-g) // 2
        new.append(base + mid * dt)
        heapq.heappush(heap, (-(mid - lo), lo, mid))
        heapq.heappush(heap, (-(hi - mid), mid, hi))
    if need > len(new):
        last = max(float(z[-1]), max(new) if new else -np.inf)
        new.extend(last + dt * np.arange(1, need - len(new) + 1))
    return np.asarray(new)


def pad_inducing(z_list, m: int, dt: float) -> np.ndarray:
    """(nw, m): larger sets thinned evenly, smaller ones gap-filled."""
    out = []
    for z in z_list:
        k = z.shape[0]
        if k > m:
            z = z[np.linspace(0, k - 1, m).astype(int)]
        elif k < m:
            z = np.concatenate([z, _gap_fill(np.sort(z), m - k, dt)])
        out.append(z)
    return np.stack(out)


def _peaks(y: np.ndarray, thres: float, min_dist: int) -> np.ndarray:
    mid = y[1:-1]
    cand = np.where((mid > y[:-2]) & (mid >= y[2:]) & (mid > thres))[0] + 1
    if cand.size == 0 or min_dist <= 1:
        return cand
    keep = np.zeros(y.size, dtype=bool)
    blocked = np.zeros(y.size, dtype=bool)
    for i in cand[np.argsort(y[cand])[::-1]]:
        if not blocked[i]:
            keep[i] = True
            blocked[max(0, i - min_dist):i + min_dist + 1] = True
    return np.sort(np.where(keep)[0])


def fft_init(y: np.ndarray, fs: float, maxh: int, f0: float):
    """(frequencies, energies) of a note: peaks of its normalized log
    spectrum at least 0.8 f0 apart and above 0.1 of the top, none under
    0.75 f0, the ``maxh`` strongest, energies summing to 1, by frequency."""
    n = y.size
    S = 2.0 / n * np.abs(np.fft.fft(y)[: n // 2])
    F = np.linspace(0.0, fs / 2.0, n // 2)
    logS = np.log(np.maximum(S, 1e-300))
    logS = logS + np.abs(logS.min())
    logS = logS / logS.max()
    idx = _peaks(logS, 0.1 * logS.max(), max(int(0.8 * np.argmin(np.abs(F - f0))), 1))
    f, s = F[idx], S[idx]
    f, s = f[f >= 0.75 * f0], s[f >= 0.75 * f0]
    top = np.argsort(s)[::-1][:maxh]
    f, s = f[top], s[top] / s[top].sum()
    order = np.argsort(f)
    return f[order], s[order]


# ------------------------------------------------------------ the problem
class Problem:
    """Every window's data and starting parameters, as tensors.

    X, Y (nw, N) and Z (nw, M): inputs centered on each window's least
    input; ``raw``: the trainable leaves by name, unconstrained, with a
    window axis first; ``fixed``: the other parameters, constrained."""

    def __init__(self, X, Y, Z, raw: dict, fixed: dict, jitter: tuple):
        self.X, self.Y, self.Z, self.raw, self.fixed = X, Y, Z, raw, fixed
        self.jitter = jitter

    @property
    def nw(self) -> int:
        return self.X.shape[0]

    def to(self, dtype, device) -> "Problem":
        def cast(d):
            return {k: v.to(device=device, dtype=dtype) for k, v in d.items()}
        return Problem(self.X.to(device, dtype), self.Y.to(device, dtype),
                       self.Z.to(device, dtype), cast(self.raw), cast(self.fixed),
                       self.jitter)


def _softplus_inv(v: np.ndarray) -> np.ndarray:
    v = v - POSITIVE_FLOOR
    return np.where(v > 30.0, v, np.log(np.expm1(np.minimum(v, 30.0))))


def positive(raw: torch.Tensor) -> torch.Tensor:
    return torch.where(raw > 30.0, raw, torch.log1p(torch.exp(raw.clamp(max=30.0)))) \
        + POSITIVE_FLOOR


def make_problem(config: dict, recording: dict) -> Problem:
    """The configuration's window bank from the raw recording, in float64
    on the host."""
    fs, ws = recording["fs"], config["window_size"]
    pitches = list(config["pitches"])
    xw = window_stack(recording["x"], ws)
    yw = window_stack(recording["mix"], ws)
    z_list = [extrema_points(xw[i], yw[i], config["dec"]) for i in range(xw.shape[0])]
    zw = pad_inducing(z_list, config["num_inducing"], 1.0 / fs)
    x0 = np.minimum(xw.min(1), zw.min(1))[:, None]
    freq, energy = zip(*[fft_init(recording["notes"][p], fs, config["max_par"],
                                  440.0 * 2.0 ** ((p - 69) / 12.0)) for p in pitches])
    if len({f.size for f in freq}) != 1:
        raise ValueError("the pitches' kernels have different partial counts")
    nw, s = xw.shape[0], len(pitches)
    tile = lambda a: np.broadcast_to(a, (nw,) + np.shape(a)).copy()     # noqa: E731
    values = {"variance": tile(np.ones(s)), "energy": tile(np.stack(energy)),
              "frequency": tile(np.stack(freq)), "noise": tile(np.ones(())),
              "lengthscale": tile(np.full(s, config["lengthscale"]))}
    names = ["variance", "energy", "frequency", "noise"]
    if config["train_lengthscale"]:
        names.insert(1, "lengthscale")
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)           # noqa: E731
    raw = {k: t(_softplus_inv(values[k])) for k in names}
    fixed = {k: t(v) for k, v in values.items() if k not in names}
    return Problem(t(xw - x0), t(config.get("y_scale", 1.0) * yw), t(zw - x0), raw, fixed,
                   JITTER[config["dtype"]])


# --------------------------------------------------------------- the bound
def _params(raw: dict, fixed: dict) -> dict:
    out = {k: positive(v) for k, v in raw.items()}
    out.update(fixed)
    return out


def _cov_terms(t1, t2, p) -> torch.Tensor:
    """(B, S, len1, len2) covariance of every pitch."""
    def feat(t):
        ang = 2.0 * math.pi * t[:, None, :, None] * p["frequency"][:, :, None, :]
        w = torch.sqrt(p["energy"])[:, :, None, :]
        return torch.cat([w * torch.cos(ang), w * torch.sin(ang)], -1)
    mix = feat(t1) @ feat(t2).mT
    r = (t1[:, :, None] - t2[:, None, :]).abs()
    env = torch.exp(-r[:, None] / p["lengthscale"][:, :, None, None])
    return p["variance"][:, :, None, None] * env * mix


def _jittered(K: torch.Tensor, jitter: tuple) -> torch.Tensor:
    j_abs, j_rel, j_row = jitter
    m = K.shape[-1]
    j = j_abs + (max(j_rel, j_row * m) if j_rel else 0.0) * torch.diagonal(K, dim1=-2, dim2=-1).mean(-1)
    return K + j[:, None, None] * torch.eye(m, dtype=K.dtype, device=K.device)


def bound(X, Y, Z, p, jitter: tuple) -> torch.Tensor:
    """The collapsed bound of each window of a block, (B,)."""
    n = X.shape[-1]
    kuu = _cov_terms(Z, Z, p).sum(1)
    kuf = _cov_terms(Z, X, p).sum(1)
    kdiag = n * (p["variance"] * p["energy"].sum(-1)).sum(-1)
    s2 = p["noise"]
    L = torch.linalg.cholesky(_jittered(kuu, jitter))
    A = torch.linalg.solve_triangular(L, kuf, upper=False)
    AAT = A @ A.mT / s2[:, None, None]
    LB = torch.linalg.cholesky(AAT + torch.eye(AAT.shape[-1], dtype=A.dtype, device=A.device))
    c = torch.linalg.solve_triangular(LB, A @ Y[..., None], upper=False) / s2[:, None, None]
    return (-0.5 * n * LOG2PI
            - torch.log(torch.diagonal(LB, dim1=-2, dim2=-1)).sum(-1)
            - 0.5 * n * torch.log(s2)
            - 0.5 * Y.square().sum(-1) / s2
            + 0.5 * c.square().sum((-2, -1))
            - 0.5 * kdiag / s2
            + 0.5 * torch.diagonal(AAT, dim1=-2, dim2=-1).sum(-1))


def loss_and_grad(prob: Problem, raw: dict, block: int):
    """(each window's negative bound (nw,), the gradient of their sum by
    leaf name), by autograd, ``block`` windows at a time."""
    losses = torch.empty(prob.nw, dtype=prob.X.dtype, device=prob.X.device)
    grads = {k: torch.empty_like(v) for k, v in raw.items()}
    for b0 in range(0, prob.nw, block):
        sl = slice(b0, b0 + block)
        leaves = {k: v[sl].detach().requires_grad_(True) for k, v in raw.items()}
        with torch.enable_grad():
            neg = -bound(prob.X[sl], prob.Y[sl], prob.Z[sl],
                         _params(leaves, {k: v[sl] for k, v in prob.fixed.items()}),
                         prob.jitter)
            got = torch.autograd.grad(neg.sum(), list(leaves.values()))
        losses[sl] = neg.detach()
        for k, g in zip(leaves, got):
            grads[k][sl] = g
    return losses, grads


def adam_steps(prob: Problem, steps: int, lr: float, block: int,
               keep_at: int | None = None):
    """``steps`` Adam steps on every window from the problem's start.
    Returns (the total loss before each step (steps,), the first step's
    gradient by leaf, the leaves after ``keep_at`` steps (after all by
    default), the leaves after all steps)."""
    b1, b2, eps = ADAM
    raw = {k: v.clone() for k, v in prob.raw.items()}
    m = {k: torch.zeros_like(v) for k, v in raw.items()}
    v2 = {k: torch.zeros_like(v) for k, v in raw.items()}
    totals, first, kept = [], None, None
    for t in range(1, steps + 1):
        losses, grads = loss_and_grad(prob, raw, block)
        totals.append(float(losses.double().sum()))
        first = grads if first is None else first
        for k in raw:
            m[k] = b1 * m[k] + (1 - b1) * grads[k]
            v2[k] = b2 * v2[k] + (1 - b2) * grads[k].square()
            raw[k] = raw[k] - lr * (m[k] / (1 - b1 ** t)) / (
                torch.sqrt(v2[k] / (1 - b2 ** t)) + eps)
        if t == keep_at:
            kept = dict(raw)
    return np.asarray(totals), first, raw if kept is None else kept, raw


# ------------------------------------------------------------- prediction
@torch.no_grad()
def predict_sources(prob: Problem, raw: dict, block: int):
    """Per-source posterior means and variances at each window's own
    samples, (S, nw, N) each: mean_s = K_s Ky^-1 y, var_s = diag(K_s -
    K_s Ky^-1 K_s), Ky = sum_s K_s + noise I + the model's jitter."""
    means, variances = [], []
    for b0 in range(0, prob.nw, block):
        sl = slice(b0, b0 + block)
        p = _params({k: v[sl] for k, v in raw.items()},
                    {k: v[sl] for k, v in prob.fixed.items()})
        x, y = prob.X[sl], prob.Y[sl]
        ks = _cov_terms(x, x, p)
        n = x.shape[-1]
        ky = ks.sum(1) + p["noise"][:, None, None] * torch.eye(n, dtype=x.dtype,
                                                               device=x.device)
        L = torch.linalg.cholesky(_jittered(ky, prob.jitter))
        alpha = torch.cholesky_solve(y[..., None], L)
        means.append((ks @ alpha[:, None])[..., 0])
        V = torch.linalg.solve_triangular(L[:, None], ks, upper=False)
        variances.append(torch.diagonal(ks, dim1=-2, dim2=-1) - V.square().sum(-2))
    return torch.cat(means).transpose(0, 1), torch.cat(variances).transpose(0, 1)


def merge(windows: np.ndarray, n: int, squared: bool = False) -> np.ndarray:
    """Hann overlap-add of (nw, ws) windows into n samples, the first and
    last windows flat on their outer halves (squared weights for
    variances)."""
    nw, ws = windows.shape
    hop = (ws - 1) // 2
    w = np.tile(hann(ws), (nw, 1))
    w[0, :hop] = 1.0
    w[-1, -hop:] = 1.0
    w = w ** 2 if squared else w
    out = np.zeros(n)
    np.add.at(out, (np.arange(nw)[:, None] * hop + np.arange(ws)).reshape(-1),
              (windows * w).reshape(-1))
    return out
