"""capture_s.<cell kind>: the summed seconds of the program's
``gpitch.fit.capture`` spans in the traced stretch (one capture of the
Adam step a fit), from the synchronize before it to the graphs'
instantiation."""

from benchmark.metrics import _spans


def read(ctx):
    got = _spans.spans(ctx.profile, "gpitch.fit.capture")
    return sum(b - a for _, a, b in got) * 1e-9 if got else None
