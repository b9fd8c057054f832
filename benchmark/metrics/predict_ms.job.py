"""predict_ms.job: milliseconds a separation job spends in ``predict_s()``
(the per-source posteriors and their overlap-add merge, returned as numpy,
so fenced), the mean over the window's jobs, from the benchmark's host
span."""


def read(ctx):
    got = ctx.driver.spans.seconds.get("predict")
    return 1e3 * sum(got) / len(got) if got else None
