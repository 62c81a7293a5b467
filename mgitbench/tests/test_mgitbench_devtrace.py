"""The idle-gap labels of a traced run: each gap goes to the shortest host
span over its middle, as a direct search finds it."""

import random

from mgitbench.devtrace import label_gaps


def _direct(gaps, spans):
    total = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        over = [(s1 - s0, name) for name, s0, s1 in spans if s0 <= mid <= s1]
        name = min(over)[1] if over else "no span"
        total[name] = total.get(name, 0.0) + (b - a)
    return total


def test_gaps_go_to_the_innermost_span():
    rng = random.Random(7)
    spans = []
    for k in range(200):
        t = rng.uniform(0, 100)
        spans.append((f"s{k % 5}", t, t + rng.uniform(0.01, 5)))
    gaps = [(t, t + rng.uniform(0, 0.01))
            for t in (rng.uniform(0, 105) for _ in range(2000))]
    got = dict(label_gaps(gaps, spans, top=100))
    want = _direct(gaps, spans)
    assert got.keys() == want.keys()
    for name in want:
        assert abs(got[name] - want[name]) < 1e-9


def test_busy_within_spans_is_the_direct_overlap():
    from mgitbench.devtrace import DeviceTrace
    rng = random.Random(8)
    trace = DeviceTrace()
    trace.t0_host, trace.t1_host = 0.0, 100.0
    events = []
    for _ in range(3000):
        a = rng.uniform(-1, 101)
        events.append(("k", a, a + rng.uniform(0, 0.2)))
    trace.events = sorted(events, key=lambda e: e[1])
    spans = []
    t = 0.0
    while t < 100:
        a = t + rng.uniform(0, 2)
        spans.append((a, min(a + rng.uniform(0, 3), 100.0)))
        t = spans[-1][1]
    step = 1e-3
    grid = [(k + 0.5) * step for k in range(int(100 / step))]
    busy = trace.busy()
    inside = [any(a <= x < b for a, b in spans) for x in grid]
    direct, i = 0.0, 0
    for x, keep in zip(grid, inside):
        while i < len(busy) and busy[i][1] <= x:
            i += 1
        if keep and i < len(busy) and busy[i][0] <= x:
            direct += step
    got = trace.busy_within(spans)
    assert abs(got - direct) < 0.01 * direct
    assert abs(trace.busy_s() - sum(b - a for a, b in busy)) < 1e-9
    assert trace.busy_s() <= 100.0
