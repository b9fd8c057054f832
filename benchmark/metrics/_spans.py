"""The program's own spans in a traced run's profile, shared by their
readers: the host annotations whose name starts with ``gpitch.``
(``gpitch_tpu_torch.utils.profiling.span``), on the clock the card's
operations share, and the card's idle time under them.  A program without
spans (an older tree) gives none, and each reader then returns None."""

PREFIX = "gpitch."


def spans(profile, name: str | None = None) -> list:
    """The program's spans (name, start_ns, end_ns) sorted by start; only
    those named ``name`` when it is given.  None without a profile."""
    if profile is None:
        return None
    got = [(n, a, b) for n, a, b, note in profile.host
           if note and n.startswith(PREFIX) and (name is None or n == name)]
    return sorted(got, key=lambda s: s[1])


def union(intervals) -> list:
    """Sorted disjoint [start, end] covering ``intervals``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return out


def idle_pct(profile, intervals):
    """The card's idle share of the union of ``intervals``, in %: 1 - the
    device operations' union within it over its length.  None when the
    intervals cover no time."""
    within = union(intervals)
    total = sum(b - a for a, b in within)
    if not total:
        return None
    busy, j, ops = 0, 0, profile.busy_intervals()
    for a, b in within:
        while j < len(ops) and ops[j][1] <= a:
            j += 1
        k = j
        while k < len(ops) and ops[k][0] < b:
            busy += min(b, ops[k][1]) - max(a, ops[k][0])
            k += 1
    return 100.0 * (1.0 - busy / total)


def leaves(got) -> list:
    """The spans of ``got`` that contain no other span of it."""
    return [s for i, s in enumerate(got)
            if not any(j != i and s[1] <= t[1] and t[2] <= s[2] for j, t in enumerate(got))]
