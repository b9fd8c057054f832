"""unnamed_idle_pct.<cell kind>: the share of the traced stretch's device
idle time whose gap, placed by its middle as ``Profile.idle_gaps`` places
it, lies under no leaf program span (a ``gpitch.`` span that contains no
other): how much of the idle time the program's spans leave unexplained,
in %."""

from benchmark.metrics import _spans


def read(ctx):
    p = ctx.profile
    got = _spans.spans(p)
    if not got:
        return None
    leaves = _spans.leaves(got)
    edges = [p.t0] + [x for ab in p.busy_intervals() for x in ab] + [p.t1]
    idle = unnamed = 0
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        idle += b - a
        if not any(s <= mid <= e for _, s, e in leaves):
            unnamed += b - a
    return 100.0 * unnamed / idle if idle else 0.0
