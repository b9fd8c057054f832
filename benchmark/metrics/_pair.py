"""The fused pair's rooflines, shared by its two readers: kernel A (the
forward: ``fwd_zfeat_kernel``, ``fused_whiten_fwd_kernel`` and the split
sums after it) and kernel B (the backward: ``bwd_zfeat_kernel``,
``fused_whiten_bwd_kernel`` and the split sums after it)."""

KERNELS = {"fwd": ("fwd_zfeat_kernel", "fused_whiten_fwd_kernel"),
           "bwd": ("bwd_zfeat_kernel", "fused_whiten_bwd_kernel")}
SHARED = ("reduce_splits_kernel",)


def roofline(ctx, which: str, count):
    """launches x the least time of a launch over the kernel's profiled
    device time, in %; a launch computes the bank's windows over its
    chunks (the pads' work is not needed work)."""
    p = ctx.profile
    if p is None:
        return None
    own = KERNELS[which]
    _, launches = p.kernel_seconds(lambda n: own[1] in n)
    if not launches:
        return None
    seconds = p.owned_seconds(own, SHARED)
    sh, chunk = ctx.driver.shape, ctx.driver.traffic.get("window_chunk")
    chunks = -(-sh["nw"] // chunk) if chunk else 1
    per_window = ctx.counts.least_s(count(sh["m"], sh["n"], sh["s"], sh["p"]))
    return 100.0 * launches * per_window * sh["nw"] / chunks / seconds
