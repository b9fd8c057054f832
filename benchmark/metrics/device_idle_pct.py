"""device_idle_pct.<cell kind>: the share of a traced run's profiled
stretch (Adam steps, a separation job) in which no operation ran on the
card (1 - the union of the device operations' intervals over the
stretch), in %."""


def read(ctx):
    p = ctx.profile
    if p is None or not p.device:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
