"""Kernels A and B (gpitch_tpu_torch/csrc/fused_whiten.cu) where their
shared memory cannot hold every source's features, so that a tile walks
the sources in several chunks, as at the transcription cell's width (63
keys x 20 partials: kernel A 16 chunks, kernel B 32), run on the CPU
through the emulation of tests/cuda_emulation and held to the f64 plain
versions.  The plan's chunk count is read from the source's own query
(``gpitch_fused_whiten_source_chunks``), the one the program's counter
``fused_whiten_source_chunks`` reports.  At M 160 kernel B takes its
two-phase body there: phase 1 builds Kuf over the chunks and runs the four
products, dK's tiles to the workspace; phase 2 runs the per-source sums as
products over each window's samples.  Skips where no g++ that takes
-std=c++20 is found.
"""

import math

import pytest
import torch

from test_torch_fused_whiten_emulated import _inputs, _rel, lib, run_bwd, run_fwd  # noqa: F401
from gpitch_tpu_torch.linalg.fused_whiten import fused_whiten_bwd_plain, fused_whiten_plain

# (nw, M, N, S, P, splits): 20 partials a source, as the transcription
# cell's; M 16 (RU 1) and 40 (RU 4); a ragged last tile; a window's tiles
# split over blocks, so that every block walks every chunk
_SHAPES = [(2, 16, 40, 32, 20, 1), (1, 40, 77, 27, 20, 2), (2, 16, 45, 33, 20, 2)]


@pytest.mark.parametrize("shape", _SHAPES)
def test_emulated_plans_walk_the_sources_in_several_chunks(lib, shape):
    """At these sizes both kernels' plans take at least two source chunks
    (kernel B on its present body: the role-split body holds every source
    and takes one)."""
    _, m, _, s, p, _ = shape
    assert lib.gpitch_fused_whiten_bwd_roles(m, s, p) == 0
    assert lib.gpitch_fused_whiten_source_chunks(0, m, s, p) >= 2
    assert lib.gpitch_fused_whiten_source_chunks(1, m, s, p) >= 2


def test_emulated_source_chunks_at_the_cells_widths(lib):
    """The chunks a launch walks at the benchmark's widths: the
    transcription cell (M 160, 63 x 20) 16 and 32; the separation cell (M
    112, 3 x 5) one each, kernel B on its role-split body; sizes no kernel
    takes (M over 160) 0."""
    assert lib.gpitch_fused_whiten_source_chunks(0, 160, 63, 20) == 16
    assert lib.gpitch_fused_whiten_source_chunks(1, 160, 63, 20) == 32
    assert lib.gpitch_fused_whiten_source_chunks(0, 112, 3, 5) == 1
    assert lib.gpitch_fused_whiten_source_chunks(1, 112, 3, 5) == 1
    assert lib.gpitch_fused_whiten_bwd_roles(112, 3, 5) == 1
    assert lib.gpitch_fused_whiten_source_chunks(1, 161, 3, 5) == 0


@pytest.mark.parametrize("shape", _SHAPES)
def test_emulated_kernels_over_source_chunks_match_the_f64_plain_versions(lib, shape):
    """Kernel A's (U, v) and kernel B's five outputs within 1e-5 of
    max|ref| of the f64 plain versions, the limit of the emulated tests at
    one chunk, or within twice the f32 plain version's own gap where that
    is larger: the inputs' f32 rounding alone (a frequency's rounding turned
    into phase by 20 partials; S P = 640-660 components summed into each
    Kuf entry) puts de 1.3e-5 off at 32 x 20 and M 16, N 70, in the kernel
    and in the f32 plain version alike."""
    *size, splits = shape
    a, du, dv = _inputs(*size, seed=11)
    a32 = [t.float() for t in a]
    plain = (fused_whiten_plain(*a), fused_whiten_plain(*a32))
    got = run_fwd(lib, a, splits)
    plain_b = (fused_whiten_bwd_plain(*a[:4], du, dv, *a[4:]),
               fused_whiten_bwd_plain(*a32[:4], du.float(), dv.float(), *a32[4:]))
    got_b = run_bwd(lib, a, du, dv, splits)
    for g, w, q in zip(got + got_b, plain[0] + plain_b[0], plain[1] + plain_b[1]):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert _rel(g, w) <= max(1e-5, 2 * _rel(q, w))


# (nw, M, N, S, P, splits) at M 160 (RU 10), where kernel B takes its two
# phases (3 build chunks or more): 20 partials as the transcription cell's,
# a ragged last tile, M 150 (padded rows), a last phase-2 item of one source
# (S 5 and 7, 2 an item), more phase-1 items a window than tiles (splits 3
# of 3 tiles, one tile an item), P 13 (3 groups of 5 partials a source, 2
# of the 8 warps idle, partials past P padded in a group), and P 25 (one
# source a build chunk, so the build's ring has one slot; a phase-2 item
# holds one source)
_PHASES = [(2, 160, 45, 5, 20, 2), (2, 150, 70, 7, 20, 3), (1, 160, 40, 9, 13, 1),
           (1, 160, 40, 4, 25, 1)]


def _counters(lib, ws, m, n, s, p):
    """The two-phase body's counters after a launch: each window's phase-1
    items done, and the queue's next item (window 0's second counter)."""
    q = lib.gpitch_fused_whiten_bwd_workspace(m, n, s, p)
    ints = ws.view(torch.int32)
    return ints[:, q - 4].tolist(), int(ints[0, q - 3])


@pytest.mark.parametrize("shape", _PHASES)
def test_emulated_kernel_b_two_phases_match_the_f64_plain_backward(lib, shape):
    """Kernel B's two-phase body: its five outputs within the file's limit
    of the f64 plain backward (1e-5 of max|ref|, or twice the f32 plain
    version's own gap), and two launches give the same bits.  The queue
    hands out every item once: in the emulation the blocks run one after
    another, so the first block takes every item in the queue's order, the
    phase-1 items of every window and then their phase-2 items (one block
    takes both phases' items of different windows, and a phase-2 item
    finds its window's phase 1 counted), and each later block takes one
    past the end; every window counts its `splits` phase-1 items."""
    *size, splits = shape
    nw, m, n, s, p = size
    si = lib.gpitch_fused_whiten_bwd_phases(m, s, p)
    assert si == 8 // math.ceil(p / 5)
    assert lib.gpitch_fused_whiten_source_chunks(1, m, s, p) >= 2
    a, du, dv = _inputs(*size, seed=13)
    a32 = [t.float() for t in a]
    want = fused_whiten_bwd_plain(*a[:4], du, dv, *a[4:])
    plain = fused_whiten_bwd_plain(*a32[:4], du.float(), dv.float(), *a32[4:])
    ws = []
    got = run_bwd(lib, a, du, dv, splits, ws=ws)
    again = run_bwd(lib, a, du, dv, splits)
    for g, h, w, q in zip(got, again, want, plain):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert torch.equal(g, h)
        assert _rel(g, w) <= max(1e-5, 2 * _rel(q, w))
    # phase 2 splits a window's tiles into ranges, each its own item and
    # record slot, until every block has items (132 here): at these few
    # windows as many as the phase-1 items or tiles allow
    ranges = min(splits, math.ceil(n / 32))
    items = nw * splits + nw * math.ceil(s / si) * ranges
    done, head = _counters(lib, ws[0], m, n, s, p)
    assert done == [splits] * nw
    assert head == items + min(132, items)


# ((nw, M, N, S, P, splits), two phases?) at M 160: 3 build chunks (12 x
# 10) take the two phases; 2 (8 x 10) and one (3 x 5) the present body, as
# does P 42, the most partials its plan holds there (one source a chunk);
# and the separation width (M 112, 3 x 5), the role-split body
_BODIES = [((1, 160, 40, 12, 10, 1), True), ((1, 160, 40, 8, 10, 1), False),
           ((1, 160, 70, 3, 5, 2), False), ((1, 160, 40, 2, 42, 1), False),
           ((1, 112, 40, 3, 5, 1), False)]


@pytest.mark.parametrize("shape,phases", _BODIES)
def test_emulated_kernel_b_counts_its_two_phase_launches(lib, shape, phases):
    """The program's counter ``fused_whiten_bwd_phases`` counts a launch
    where the plan's query ``gpitch_fused_whiten_bwd_phases`` reads nonzero;
    the query names the body the launch took: after a launch the two-phase
    body's queue counters in its workspace read each window's phase-1
    items, the present body's workspace holds the z features alone and the
    role-split body's is empty.  The outputs are within the file's limit of
    the f64 plain backward."""
    *size, splits = shape
    nw, m, n, s, p = size
    assert (lib.gpitch_fused_whiten_bwd_phases(m, s, p) > 0) == phases
    a, du, dv = _inputs(*size, seed=17)
    want = fused_whiten_bwd_plain(*a[:4], du, dv, *a[4:])
    a32 = [t.float() for t in a]
    plain = fused_whiten_bwd_plain(*a32[:4], du.float(), dv.float(), *a32[4:])
    ws = []
    for g, w, q in zip(run_bwd(lib, a, du, dv, splits, ws=ws), want, plain):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert _rel(g, w) <= max(1e-5, 2 * _rel(q, w))
    zfeat = s * p * 2 * -(-m // 16) * 16
    if phases:
        assert _counters(lib, ws[0], m, n, s, p)[0] == [splits] * nw
    elif lib.gpitch_fused_whiten_bwd_roles(m, s, p):
        assert ws[0].shape[1] == 0
    else:
        assert ws[0].shape[1] == zfeat
    if p == 42:     # one partial more does not fit kernel B's plan at M 160
        assert lib.gpitch_fused_whiten_source_chunks(1, m, s, p) == 2
        assert lib.gpitch_fused_whiten_source_chunks(1, m, s, p + 1) == 0
