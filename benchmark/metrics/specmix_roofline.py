"""specmix_roofline: the spectral-mixture kernel's share of its roofline in
the profiled job's ``predict_s``: every window's (S, N, N) covariances
(``counts.specmix``) at their least time over the profiled device time of
``specmix_kernel`` and ``features_kernel``, in %."""


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    seconds, launches = p.kernel_seconds(
        lambda n: "specmix_kernel" in n or "features_kernel" in n)
    if not launches:
        return None
    sh = ctx.driver.shape
    least = sh["nw"] * ctx.counts.least_s(ctx.counts.specmix(sh["n"], sh["n"], sh["s"], sh["p"]))
    return 100.0 * least / seconds
