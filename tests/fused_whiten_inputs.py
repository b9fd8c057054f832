"""Inputs of the fused build -> whiten -> accumulate chain for the tests of
gpitch_tpu_torch/linalg/fused_whiten.py (CPU and card).  Imports nothing of
JAX."""

import numpy as np


def prototype_inputs(nw, m, n, s, p, per_window=False, seed=0, fs=16000.0):
    """The prototypes' recipe (scripts/proto_fused_whiten.py:321-342) at
    (nw, M, N, S, P), numpy f64: zc (nw, M, 1); xc, err (nw, 1, N); linv
    (nw, M, M), lower triangular; energy, freq (S, P), or (nw, S, P) with
    ``per_window``; var, inv_l (S,) or (nw, S).  Sources are semitones
    from C4 with P harmonics each."""
    rng = np.random.default_rng(seed)
    x = np.broadcast_to(np.arange(n) / fs, (nw, n))
    z = np.linspace(0, (n - 1) / fs, m) + rng.uniform(0, 1e-4, (nw, m))
    err = rng.standard_normal((nw, n)) * 0.1
    linv = np.tril(rng.standard_normal((nw, m, m)) * 0.05 + np.eye(m))
    f0 = 261.6 * 2 ** (np.arange(s) / 12)
    energy = np.broadcast_to(1.0 / np.arange(1, p + 1), (s, p))
    freq = f0[:, None] * np.arange(1, p + 1)
    var, inv_l = np.linspace(1.0, 0.5, s), np.linspace(10.0, 20.0, s)
    if per_window:
        w = rng.uniform(0.8, 1.2, (nw, 1, 1))
        energy, freq = energy * w, freq * w[::-1]
        var, inv_l = var * w[:, 0], inv_l * w[::-1, 0]
    return tuple(np.array(a) for a in (
        z[..., None], x[:, None], err[:, None], linv, energy, freq, var, inv_l))
