"""fit_s.job: seconds a separation job spends in ``optimize(maxiter)``
(returning its losses to the host fences it), the mean over the window's
jobs, from the benchmark's host span."""


def read(ctx):
    got = ctx.driver.spans.seconds.get("fit")
    return sum(got) / len(got) if got else None
