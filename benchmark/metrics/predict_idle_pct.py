"""predict_idle_pct.<cell kind>: the card's idle share within the
program's ``gpitch.predict`` spans (the posteriors over the bank's chunks)
and ``gpitch.predict.merge`` spans (their copy to the host and the
overlap-add merge) of the traced stretch, in %."""

from benchmark.metrics import _spans


def read(ctx):
    got = _spans.spans(ctx.profile)
    if got is None:
        return None
    return _spans.idle_pct(ctx.profile, [(a, b) for n, a, b in got
                                         if n in ("gpitch.predict", "gpitch.predict.merge")])
