"""Kernels A and B at the transcription cell's shape (benchmark cell
amt63-adam: 87 windows, M 160, N 2001, 63 keys x 20 partials), on the card,
against their plain versions.  At this width both kernels walk the sources
in many chunks a tile in their builds (kernel A 16, kernel B 32), and kernel
B takes its two-phase body (its per-source sums as products over each
window's samples, 2 sources an item); at the separation cell's width it
does not.

Every test needs a CUDA card and skips without one.  The file imports
nothing of JAX, so on a machine with a card and without JAX it runs as

    python -m pytest --noconftest tests/test_torch_cuda_amt63.py -q
"""

import numpy as np
import pytest
import torch

from fused_whiten_inputs import prototype_inputs

SHAPE = (87, 160, 2001, 63, 20)     # nw, M, N, S, P
FS = 44100.0
BLOCK = 4                           # windows a plain call takes at once


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


def _dictionary_inputs(device):
    """prototype_inputs at SHAPE (per window, at 44.1 kHz) with the cell's
    dictionary in place of the prototype's sources: keys A0-B5, 20 inharmonic
    partials k f0 sqrt(1 + 3e-4 k^2), energies k^-1.5 summing to 1; float32
    on ``device``, and cotangents (du, dv)."""
    nw, m, n, s, p = SHAPE
    zc, xc, err, linv, _, _, var, inv_l = prototype_inputs(
        nw, m, n, s, p, per_window=True, seed=5, fs=FS)
    k = np.arange(1, p + 1)
    f0 = 27.5 * 2.0 ** (np.arange(s) / 12.0)
    rng = np.random.default_rng(7)          # each window its own dictionary
    freq = f0[:, None] * k * np.sqrt(1.0 + 3e-4 * k * k) * rng.uniform(0.98, 1.02, (nw, 1, 1))
    energy = k ** -1.5 / np.sum(k ** -1.5) * rng.uniform(0.8, 1.2, (nw, s, 1))
    gen = torch.Generator().manual_seed(6)
    du = torch.randn(nw, m, m, generator=gen, dtype=torch.float64) * 0.01
    dv = torch.randn(nw, m, 1, generator=gen, dtype=torch.float64) * 0.01
    args = [torch.as_tensor(a) for a in (zc, xc, err, linv, energy, freq, var, inv_l)]
    return [a.to(device, torch.float32) for a in args], du.to(device, torch.float32), \
        dv.to(device, torch.float32)


def _blocked(fn, args, dtype):
    """fn over windows BLOCK at a time, its outputs concatenated."""
    outs = [fn(*[a[w0:w0 + BLOCK].to(dtype) for a in args])
            for w0 in range(0, args[0].shape[0], BLOCK)]
    return [torch.cat(parts) for parts in zip(*outs)]


def _max_gap(got, want) -> float:
    return float((got.double() - want).abs().max())


def test_cuda_kernels_at_the_transcription_cell_match_plain(cuda):
    """Kernel A's (U, v) and kernel B's five outputs, each within 1e-4 of
    max|ref| of the f64 plain versions, or (kernel B, as the card tests'
    ``_bwd_rows`` allow) within 4x the f32 plain version's own gap to f64
    where that is larger: f32 sums over 63 x 20 components of every Kuf
    entry and over 2001 samples of every source's gradient.  The plan walks
    the sources in 16 chunks in kernel A and 32 in kernel B's build, and the
    counter records it; kernel B takes its two-phase body (2 sources a
    phase-2 item), and two of its launches give the same bits."""
    from gpitch_tpu_torch.linalg.fused_whiten import (
        fused_whiten, fused_whiten_bwd, fused_whiten_bwd_phases, fused_whiten_bwd_plain,
        fused_whiten_plain, fused_whiten_source_chunks)
    args, du, dv = _dictionary_inputs(cuda)
    with torch.no_grad():
        got_a = fused_whiten(*args)
        phases = fused_whiten_bwd_phases.launches
        got_b = fused_whiten_bwd(*args[:4], du, dv, *args[4:])
        again = fused_whiten_bwd(*args[:4], du, dv, *args[4:])
        torch.cuda.synchronize()
        assert (fused_whiten_source_chunks.fwd, fused_whiten_source_chunks.bwd) == (16, 32)
        assert fused_whiten_source_chunks.sums == 2
        assert fused_whiten_bwd_phases.launches == phases + 2
        assert all(torch.equal(g, h) for g, h in zip(got_b, again))
        want_a = _blocked(fused_whiten_plain, args, torch.float64)
        bwd = (*args[:4], du, dv, *args[4:])
        want_b = _blocked(fused_whiten_bwd_plain, bwd, torch.float64)
        plain_b = _blocked(fused_whiten_bwd_plain, bwd, torch.float32)
    gaps = {}
    for name, g, w in zip(("U", "v"), got_a, want_a):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        gaps[name] = _max_gap(g, w) / float(w.abs().max())
        assert gaps[name] <= 1e-4, gaps
    for name, g, w, q in zip(("dlinv", "dvar", "dinvl", "de", "df"), got_b, want_b, plain_b):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        scale = float(w.abs().max())
        gaps[name] = _max_gap(g, w) / scale
        assert _max_gap(g, w) <= max(1e-4 * scale, 4 * _max_gap(q, w)), gaps
    print(gaps)


def test_cuda_kernel_b_keeps_its_role_split_body_at_the_separation_width(cuda):
    """At the separation cells' width (sosp-14s: 222 windows, M 112, N 2001,
    3 x 5) kernel B takes its role-split body, not the two phases: the
    phases' counter does not move, the role-split body's does, and the
    outputs are finite."""
    from fused_whiten_inputs import prototype_inputs as inputs
    from gpitch_tpu_torch.linalg.fused_whiten import (
        fused_whiten_bwd, fused_whiten_bwd_phases, fused_whiten_bwd_roles,
        fused_whiten_source_chunks)
    nw, m, n, s, p = 222, 112, 2001, 3, 5
    args = [torch.as_tensor(a).to(cuda, torch.float32)
            for a in inputs(nw, m, n, s, p, per_window=True, seed=3)]
    gen = torch.Generator().manual_seed(4)
    du = (torch.randn(nw, m, m, generator=gen) * 0.01).to(cuda)
    dv = (torch.randn(nw, m, 1, generator=gen) * 0.01).to(cuda)
    before = (fused_whiten_bwd_phases.launches, fused_whiten_bwd_roles.launches)
    with torch.no_grad():
        out = fused_whiten_bwd(*args[:4], du, dv, *args[4:])
        torch.cuda.synchronize()
    assert (fused_whiten_bwd_phases.launches, fused_whiten_bwd_roles.launches) == \
        (before[0], before[1] + 1)
    assert fused_whiten_source_chunks.sums == 0
    assert all(bool(torch.isfinite(g).all()) for g in out)
