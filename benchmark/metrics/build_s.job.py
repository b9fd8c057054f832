"""build_s.job: seconds a separation job spends in ``SoSp(...)`` (windows,
inducing points, the pitch kernels from the FFT, the bank moved to the
card), the mean over the window's jobs, from the benchmark's host span."""


def read(ctx):
    got = ctx.driver.spans.seconds.get("build")
    return sum(got) / len(got) if got else None
