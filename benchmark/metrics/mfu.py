"""mfu.<unit>: the frozen operation count of one unit of the window's work
(``mfu.bank_step``: an Adam step, ``counts.bank_step``; ``mfu.job``: a
separation job, its Adam steps and ``counts.predict_sources``, the host's
build counting nothing) over the unit's wall time in the traced run's own
window (the profiler off) times the card's 495 TFLOP/s, in %."""


def read(ctx):
    drv = ctx.driver
    if not drv.unit_s:
        return None
    return 100.0 * drv.flops_per_unit() / (drv.unit_s * ctx.counts.PRODUCT_FLOP_PER_S)
