"""replay_idle_pct.<cell kind>: the card's idle share from the end of each
fit's last ``gpitch.fit.capture`` span to the end of its ``gpitch.fit``
span (the steady replays, their fences and the host code between
segments), over every fit of the traced stretch, in %."""

from benchmark.metrics import _spans


def read(ctx):
    fits = _spans.spans(ctx.profile, "gpitch.fit")
    if not fits:
        return None
    captures = _spans.spans(ctx.profile, "gpitch.fit.capture")
    steady = []
    for _, a, b in fits:
        ends = [e for _, s, e in captures if a <= s and e <= b]
        if ends:
            steady.append((max(ends), b))
    return _spans.idle_pct(ctx.profile, steady)
