"""chol_roofline: the Cholesky kernel's share of its roofline: every launch
of ``chol_kernel`` (Kuu in float32 and B = I + A A^T / sigma^2 in float64,
each over one chunk's windows) times the least time of its factors
(``counts.cholesky``), over their profiled device time, in %."""


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    sh, chunk = ctx.driver.shape, ctx.driver.traffic.get("window_chunk")
    per_launch = sh["nw"] / (-(-sh["nw"] // chunk) if chunk else 1)
    least, seconds = 0.0, 0.0
    for itemsize, kind in ((4, "chol_kernel<float"), (8, "chol_kernel<double")):
        s, n = p.kernel_seconds(lambda name: kind in name)
        least += n * per_launch * ctx.counts.least_s(ctx.counts.cholesky(sh["m"], itemsize))
        seconds += s
    return 100.0 * least / seconds if seconds else None
