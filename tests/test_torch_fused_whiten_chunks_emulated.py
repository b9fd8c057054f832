"""Kernels A and B (gpitch_tpu_torch/csrc/fused_whiten.cu) where their
shared memory cannot hold every source's features, so that a tile walks
the sources in several chunks, as at the transcription cell's width (63
keys x 20 partials: kernel A 16 chunks, kernel B 32), run on the CPU
through the emulation of tests/cuda_emulation and held to the f64 plain
versions.  The plan's chunk count is read from the source's own query
(``gpitch_fused_whiten_source_chunks``), the one the program's counter
``fused_whiten_source_chunks`` reports.  Skips where no g++ that takes
-std=c++20 is found.
"""

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
