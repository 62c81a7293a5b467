"""One traced benchmark run that also says how well the program's trace
clock lines up with the device trace.

    python3 experiments/trace_clock_offset.py --workload <cell> --seed <n> \\
        --seconds 48 --trace 1

runs ``mgitbench/run.py`` in this process, unchanged but for what it
records, and prints after its result line one line ``trace_clock {...}``:

* ``offset_us``: where the benchmark's marker mapping (a device trace's
  first operation, launched right after a synchronisation at a known host
  time) puts the device trace on the host clock, minus where the program's
  ``metadata.clock`` pair (``perf_counter_ns`` and ``time_ns`` read at
  ``reset_trace``) puts it, since kineto's events are on Unix nanoseconds;
* ``drift_us``: how far the two host clocks moved apart over the window
  (the pair read again after it), which neither mapping corrects;
* the span and dropped-event counts of the program's trace, its counts,
  the device trace's copies (count and seconds by name, inside the
  benchmark's commit and checkout spans or not), and the cell's
  end-to-end metrics as the traced run measured them (a
  traced run reports only per-layer metrics), to set against untraced runs
  for what tracing costs.
"""

import time

T_START = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (os.path.join(ROOT, "src"), ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)

import torch  # noqa: E402

from mgitbench import devtrace, harness  # noqa: E402
from mgitbench import run as run_module  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402

SEEN = {}


class MarkedTrace(devtrace.DeviceTrace):
    """``DeviceTrace`` keeping the marker's Unix start (its ``stop`` with
    one line more: the trace's events are read once)."""

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t1_host = time.perf_counter()
        self.prof.__exit__(None, None, None)
        raw = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            start, dur = e.start_ns() / 1e9, e.duration_ns() / 1e9
            raw.append((e.name(), start, start + dur))
        self.prof = None
        if not raw:
            return
        raw.sort(key=lambda r: r[1])
        shift = self.t0_host - raw[0][1]
        SEEN["marker_shift_s"] = shift
        SEEN["pair_after"] = obs_trace._clock_pair()
        self.events = [(n, a + shift, b + shift) for n, a, b in raw[1:]]


def export():
    doc = EXPORT()
    SEEN["metadata"] = doc["metadata"]
    SEEN["spans"] = sum(1 for e in doc["traceEvents"] if e.get("ph") == "X")
    return doc


def result(run, bench):
    out = RESULT(run, bench)
    SEEN["end_to_end"] = {m["name"]: harness.read_metric(m["name"], run)
                          for m in harness.metrics_for(bench,
                                                       run.cell["name"],
                                                       False)}
    if run.device_trace is not None:
        spans = [(a, b) for name, a, b in run.spans
                 if name in ("lineage.commit", "lineage.checkout")]
        copies = {}
        for name, a, b in run.device_trace.events:
            if name.startswith("Memcpy"):
                mid = 0.5 * (a + b)
                where = ("storage" if any(s0 <= mid <= s1
                                          for s0, s1 in spans) else "other")
                key = f"{name} {where}"
                n, secs = copies.get(key, (0, 0.0))
                copies[key] = (n + 1, secs + b - a)
        SEEN["memcpy"] = copies
    return out


EXPORT, RESULT = obs.export_chrome_trace, harness.result


def main(argv=None) -> int:
    devtrace.DeviceTrace = MarkedTrace
    obs.export_chrome_trace = export
    harness.result = result
    run_module.T_START = T_START
    rc = run_module.main(argv)
    meta = SEEN.get("metadata")
    line = {"end_to_end": SEEN.get("end_to_end"), "spans": SEEN.get("spans"),
            "memcpy": SEEN.get("memcpy")}
    if meta is not None and "marker_shift_s" in SEEN:
        clock = meta["clock"]
        clock_shift_ns = clock["perf_counter_ns"] - clock["unix_ns"]
        perf, unix, _ = SEEN["pair_after"]
        line.update(
            offset_us=(SEEN["marker_shift_s"] - clock_shift_ns / 1e9) * 1e6,
            drift_us=((perf - unix) - clock_shift_ns) / 1e3,
            read_gap_ns=clock["read_gap_ns"],
            dropped_events=meta.get("dropped_events", 0),
            counts=meta["counts"])
    print("trace_clock " + json.dumps(line), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
