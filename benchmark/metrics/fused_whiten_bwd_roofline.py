"""fused_whiten_bwd_roofline: kernel B's share of its roofline (its launches
times the least time of one, ``counts.kernel_b``, over the profiled device
time of all its CUDA kernels), in %."""

from benchmark.metrics import _pair


def read(ctx):
    return _pair.roofline(ctx, "bwd", ctx.counts.kernel_b)
