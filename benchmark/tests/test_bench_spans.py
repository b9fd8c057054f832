"""The readers of the program's spans, on a hand-made profile whose
spans and device operations are known, and on profiles without them."""

from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.trace import Profile

READERS = ("capture_s.adam", "replay_idle_pct.job", "predict_idle_pct.job",
           "unnamed_idle_pct.adam")


def _profile(with_spans=True, with_capture=True):
    """A stretch 0-1000 ns: a fit (warm-up, capture, two segments of
    replays, each with its fence) and a prediction, and four device
    operations.  Busy 160-290, 410-580, 610-850, 930-970; idle 0-160
    (before the fit), 290-410 (the capture), 580-610 (a fence), 850-930
    (a fence), 970-1000 (the merge): 420 ns."""
    spans = [("gpitch.fit", 100, 900), ("gpitch.fit.build", 100, 150),
             ("gpitch.fit.warmup", 150, 300), ("gpitch.fit.capture", 300, 400),
             ("gpitch.fit.replay", 400, 500), ("gpitch.fit.fence", 500, 600),
             ("gpitch.fit.replay", 600, 700), ("gpitch.fit.fence", 700, 900),
             ("gpitch.predict", 920, 960), ("gpitch.predict.merge", 960, 990)]
    if not with_capture:
        spans = [s for s in spans if s[0] != "gpitch.fit.capture"]
    host = [("bench.optimize", 0, 1000, True), ("aten::mm", 420, 430, False),
            ("gpitch.not_an_annotation", 0, 1000, False)]
    host += [(n, a, b, True) for n, a, b in spans] if with_spans else []
    device = [("k", 160, 290), ("k", 410, 580), ("k", 610, 850), ("k", 930, 970)]
    return Profile(device, host, 0, 1000)


def _read(name, profile):
    return harness._reader(name)(SimpleNamespace(profile=profile))


def test_readers_give_the_exact_values():
    p = _profile()
    assert _read("capture_s.adam", p) == 100 * 1e-9
    # from the capture's end (400) to the fit's end (900): 410 ns busy
    assert _read("replay_idle_pct.job", p) == 100.0 * (1.0 - 410 / 500)
    # the prediction and its merge, 920-990: 40 ns busy
    assert _read("predict_idle_pct.job", p) == 100.0 * (1.0 - 40 / 70)
    # only the gap before the fit (middle 80) lies under no leaf span
    assert _read("unnamed_idle_pct.adam", p) == 100.0 * 160 / 420


def test_a_fit_without_a_capture_gives_no_capture_numbers():
    p = _profile(with_capture=False)
    assert _read("capture_s.job", p) is None
    assert _read("replay_idle_pct.adam", p) is None
    # the warm-up (150-300) is a leaf now as before; the gap 290-410 is
    # under the fit alone, which holds other spans
    assert _read("unnamed_idle_pct.job", p) == 100.0 * (160 + 120) / 420


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("profile", [None, "no spans"])
def test_readers_give_none_without_the_spans(name, profile):
    p = None if profile is None else _profile(with_spans=False)
    assert _read(name, p) is None
