"""The device trace of a traced run, and the kernel calls it is held to.

``DeviceTrace`` profiles the card (``torch.profiler``, CUDA activity only,
so a window of many thousands of launches stays cheap to read) over the
traced window and reduces the trace to:

* ``busy_s``: seconds in which a kernel, copy or memset ran (the union of
  their intervals), and ``window_s``, the traced window;
* ``by_name``: device seconds and launch counts by operation name;
* ``idle_gaps``: the gaps between device operations, labelled by the host
  span (the benchmark's own, or the program's ``obs`` spans) that covered
  the middle of each gap.

Device times are mapped to the host clock by a marker: the first device
operation of the window is launched right after a synchronisation at a
known host time.

``Probe`` wraps, for the traced window, the kernel entry points that the
run's metrics declare, and records for each call on the card the least
seconds an H100 could take for it (the metric's bound, from
``formulas``). Calls are counted so that a reader can see whether they
account for every launch of that kernel in the trace.
"""

from __future__ import annotations

import functools
import heapq
import importlib
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch


class DeviceTrace:
    def __init__(self):
        self.prof = None
        self.t0_host = 0.0
        self.t1_host = 0.0
        # (name, start, end) of each device operation, on the host clock
        self.events: List[Tuple[str, float, float]] = []

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t0_host = time.perf_counter()
        torch.zeros(1, device="cuda")                   # the marker
        torch.cuda.synchronize()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t1_host = time.perf_counter()
        self.prof.__exit__(None, None, None)
        t_stopped = time.perf_counter()
        raw = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            if hasattr(e, "start_ns"):
                start, dur = e.start_ns() / 1e9, e.duration_ns() / 1e9
            else:
                start, dur = e.start_us() / 1e6, e.duration_us() / 1e6
            raw.append((e.name(), start, start + dur))
        self.prof = None
        print(f"mgitbench: device trace of {len(raw)} operations: profiler "
              f"stop {t_stopped - self.t1_host:.1f} s, read "
              f"{time.perf_counter() - t_stopped:.1f} s (torch "
              f"{torch.__version__})", file=sys.stderr)
        if not raw:
            return
        raw.sort(key=lambda r: r[1])
        shift = self.t0_host - raw[0][1]       # the marker starts at t0
        self.events = [(n, a + shift, b + shift) for n, a, b in raw[1:]]

    @property
    def window_s(self) -> float:
        return self.t1_host - self.t0_host

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals in the window,
        in time order."""
        out: List[Tuple[float, float]] = []
        end = self.t0_host
        for _, a, b in self.events:
            a, b = max(a, end), min(b, self.t1_host)
            if b > a:
                if out and out[-1][1] >= a:
                    out[-1] = (out[-1][0], b)
                else:
                    out.append((a, b))
                end = b
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def busy_within(self, spans: Sequence[Tuple[float, float]]) -> float:
        """Device-busy seconds inside ``spans`` (disjoint host intervals)."""
        total, i = 0.0, 0
        busy = self.busy()
        for s0, s1 in sorted(spans):
            while i < len(busy) and busy[i][1] <= s0:
                i += 1
            j = i
            while j < len(busy) and busy[j][0] < s1:
                total += min(busy[j][1], s1) - max(busy[j][0], s0)
                j += 1
        return total

    @functools.cached_property
    def by_name(self) -> Dict[str, Tuple[float, int]]:
        out: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
        for n, a, b in self.events:
            out[n][0] += b - a
            out[n][1] += 1
        return {n: (s, c) for n, (s, c) in out.items()}

    def kernel_time(self, fragment: str) -> Tuple[float, int]:
        """Device seconds and launches of the kernels whose name holds
        ``fragment``."""
        s = c = 0
        for n, (secs, count) in self.by_name.items():
            if fragment in n:
                s += secs
                c += count
        return s, c

    def gaps(self) -> List[Tuple[float, float]]:
        out, end = [], self.t0_host
        for _, a, b in self.events:
            if a > end:
                out.append((end, a))
            end = max(end, b)
        if self.t1_host > end:
            out.append((end, self.t1_host))
        return out


def label_gaps(gaps, spans: List[Tuple[str, float, float]], top: int = 10
               ) -> List[Tuple[str, float]]:
    """Idle seconds summed by the innermost (shortest) host span over each
    gap's middle, the longest ``top``. One sweep over the gaps in time
    order, with the open spans in a heap by length."""
    total: Dict[str, float] = defaultdict(float)
    order = sorted(spans, key=lambda s: s[1])
    open_spans: List[Tuple[float, float, str]] = []
    i = 0
    for a, b in sorted(gaps):
        mid = 0.5 * (a + b)
        while i < len(order) and order[i][1] <= mid:
            name, s0, s1 = order[i]
            heapq.heappush(open_spans, (s1 - s0, s1, name))
            i += 1
        while open_spans and open_spans[0][1] < mid:
            heapq.heappop(open_spans)
        total[open_spans[0][2] if open_spans else "no span"] += b - a
    return sorted(total.items(), key=lambda kv: -kv[1])[:top]


def top_ops(trace: DeviceTrace, top: int = 10) -> List[Tuple[str, float]]:
    items = sorted(trace.by_name.items(), key=lambda kv: -kv[1][0])
    return [(n[:96], s) for n, (s, _) in items[:top]]


# -- kernel calls ------------------------------------------------------------

def dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


class Probe:
    """While installed, records the least seconds of each call on the card
    of the kernel entry points that the run's metrics declare (a metric
    module's ``PROBE``: module, entry point, device kernel name fragment,
    bound), keyed by (module, entry point), and host spans around the
    entry points the generator names (``timed``), which label idle
    gaps."""

    def __init__(self):
        self.calls: Dict[Tuple[str, str], List[float]] = defaultdict(list)
        self.spans: List[Tuple[str, float, float]] = []
        self._saved = []

    def time(self, module: str, attr: str, name: str) -> None:
        mod = importlib.import_module(module)
        fn = getattr(mod, attr)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.spans.append((name, t0, time.perf_counter()))

        self._saved.append((mod, attr, fn))
        setattr(mod, attr, timed)

    def wrap(self, module: str, attr: str, kernel: str, bound) -> None:
        key = (module, attr)
        if any((m.__name__, a) == key for m, a, _ in self._saved):
            return
        mod = importlib.import_module(module)
        fn = getattr(mod, attr)
        calls = self.calls[key]

        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            if args and isinstance(args[0], torch.Tensor) and args[0].is_cuda:
                calls.append(bound(*args, **kwargs))
            return out

        self._saved.append((mod, attr, fn))
        setattr(mod, attr, wrapped)

    def remove(self) -> None:
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved = []


def roofline_percent(run, probe) -> Optional[float]:
    """100 x the recorded calls' summed bound over the device seconds of
    ``probe``'s kernel in the run's trace, or None when the trace holds no
    launch of it or the recorded calls do not account for every launch."""
    module, attr, kernel, _ = probe
    trace, recorded = run.device_trace, run.probe
    if trace is None or recorded is None:
        return None
    secs, launches = trace.kernel_time(kernel)
    bounds = recorded.calls.get((module, attr), [])
    if not launches or launches != len(bounds) or secs <= 0:
        return None
    return 100.0 * sum(bounds) / secs
