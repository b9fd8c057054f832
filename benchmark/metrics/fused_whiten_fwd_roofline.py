"""fused_whiten_fwd_roofline: kernel A's share of its roofline (its launches
times the least time of one, ``counts.kernel_a``, over its profiled device
time), in %."""

from benchmark.metrics import _pair


def read(ctx):
    return _pair.roofline(ctx, "fwd", ctx.counts.kernel_a)
