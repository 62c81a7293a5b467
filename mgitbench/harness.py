"""One run of one cell: set-up, the measured window, the check, the result.

The cell, its configuration and its traffic mix are found by name from
``BENCHMARK.json``. The mix's ``kind`` names the general generator that
drives it (``mgitbench/<kind>.py``: ``lineage`` or ``serve``), which reads
only the mix's parameters. Each metric is a module
``mgitbench/metrics/<name>.py`` with ``read(run) -> float | None``; a run
reports its cell's end-to-end metrics, or with ``--trace 1`` its per-layer
metrics, and leaves out a per-layer metric whose reader finds nothing.

The result is the last line of standard output, one JSON object; the
numbers the correctness check compared, each beside its limit, are the
last lines of standard error and the last key of that object.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import importlib.util
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# top-level module names that must not be loaded by the end of a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """Everything one run knows: its inputs, what it recorded and how it
    was checked. The generators fill it; the metric readers read it."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    backend: Optional[str] = None       # the store's: None is the card
    scratch: Optional[Path] = None
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    records: Dict[str, List[dict]] = dataclasses.field(default_factory=dict)
    checks: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    device_trace: Any = None            # devtrace.DeviceTrace of the window
    probe: Any = None                   # devtrace.Probe of the window
    spans: List[Tuple[str, float, float]] = dataclasses.field(
        default_factory=list)           # host spans (name, t0, t1)
    program_spans: List[dict] = dataclasses.field(default_factory=list)
    memory_peak_bytes: int = 0
    # the control: the plain reference one precision below the
    # configuration's answers in the program's place, through the same
    # check, which has to find it not correct
    control: bool = False
    bench: dict = dataclasses.field(default_factory=dict)

    @property
    def model(self) -> dict:
        return self.config["model"]

    def check(self, name: str, value: float, limit: float) -> None:
        """Record one compared number: the run is correct only while every
        value is at most its limit."""
        self.checks[name] = {"value": float(value), "limit": float(limit)}

    @property
    def correct(self) -> bool:
        return bool(self.checks) and self.failed == 0 and all(
            c["value"] <= c["limit"] for c in self.checks.values())


class Window:
    """The measured window: with ``run.trace``, the device trace, the
    kernel-call probe and the program's own spans run inside it. The probe
    wraps the entry points that the run's per-layer metrics declare
    (``PROBE``) and times those named in ``timed``: (module, function,
    span name)."""

    def __init__(self, run: Run, timed=()):
        self.run = run
        self.timed = timed
        self.t0 = 0.0

    def __enter__(self) -> "Window":
        run = self.run
        if run.trace:
            from mgitbench import devtrace
            from repro_torch import obs
            run.probe = devtrace.Probe()
            for m in metrics_for(run.bench, run.cell["name"], True):
                probe = getattr(metric_module(m["name"]), "PROBE", None)
                if probe is not None:
                    run.probe.wrap(*probe)
            for spec in self.timed:
                run.probe.time(*spec)
            obs.reset_trace()
            obs.enable()
            self._obs_t0 = time.perf_counter()
            if run.device == "cuda":
                run.device_trace = devtrace.DeviceTrace()
                run.device_trace.start()
        self.t0 = time.perf_counter()
        return self

    @property
    def deadline(self) -> float:
        return self.t0 + self.run.seconds

    def __exit__(self, *exc) -> bool:
        run = self.run
        if run.device == "cuda":
            import torch
            torch.cuda.synchronize()
        run.window_s = time.perf_counter() - self.t0
        if run.trace:
            from repro_torch import obs
            if run.device_trace is not None:
                run.device_trace.stop()
            obs.disable()
            base = self._obs_t0
            for ev in obs.export_chrome_trace()["traceEvents"]:
                if ev.get("ph") == "X":
                    t0 = base + ev["ts"] / 1e6
                    run.program_spans.append(
                        {"name": ev["name"], "t0": t0,
                         "t1": t0 + ev["dur"] / 1e6})
            obs.reset_trace()
            run.probe.remove()
            run.spans.extend(run.probe.spans)
        return False

    def span(self, name: str):
        return _Span(self.run, name)


class _Span:
    def __init__(self, run: Run, name: str):
        self.run, self.name = run, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.run.spans.append((self.name, self.t0, time.perf_counter()))
        return False


# -- finding things by name --------------------------------------------------

def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def make_run(name: str, root: Path = ROOT, **kwargs) -> Run:
    """A ``Run`` of cell ``name``, not yet driven; ``kwargs`` are its
    fields (``seed``, ``seconds``, ...)."""
    bench, cell, config, traffic = find_cell(name, root)
    return Run(cell=cell, config=config, traffic=traffic, bench=bench,
               **kwargs)


def find_cell(name: str, root: Path = ROOT) -> Tuple[dict, dict, dict, dict]:
    """(benchmark, cell, configuration, traffic) of cell ``name``."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(root / entry["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return bench, cell, config, traffic


def metrics_for(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones."""
    def applies(m):
        return "workloads" not in m or cell in m["workloads"]
    if not trace:
        return [m for m in bench["end_to_end"] if applies(m)]
    reported = {m["name"] for m in bench["end_to_end"] if applies(m)}
    return [m for m in bench["per_layer"]
            if applies(m) and m["moves"] in reported]


_METRICS: Dict[str, Any] = {}


def metric_module(name: str):
    """The module ``metrics/<name>.py``: ``read(run)``, and a ``PROBE``
    where the metric needs a kernel's calls recorded."""
    if name not in _METRICS:
        path = HERE / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"mgitbench_metric_{name.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _METRICS[name] = module
    return _METRICS[name]


def read_metric(name: str, run: Run) -> Optional[float]:
    value = metric_module(name).read(run)
    return None if value is None else float(value)


def forbidden_modules() -> List[str]:
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


# -- a run -------------------------------------------------------------------

def execute(run: Run, t_start: float) -> None:
    """Drive the cell: the generator named by the mix's ``kind``."""
    generator = importlib.import_module(f"mgitbench.{run.traffic['kind']}")
    generator.drive(run, t_start)


def result(run: Run, bench: dict) -> dict:
    metrics = {}
    for m in metrics_for(bench, run.cell["name"], run.trace):
        value = read_metric(m["name"], run)
        if value is None:
            if not run.trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   f"nothing")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if run.device == "cuda" else run.device,
              "count": int(run.cell["chips"]),
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.device == "cuda":
        import torch
        device["kind"] = torch.cuda.get_device_name(0)
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    dt = run.device_trace
    if run.trace and dt is not None:
        from mgitbench import devtrace
        device["busy_s"] = dt.busy_s()
        device["window_s"] = dt.window_s
        spans = run.spans + [(s["name"], s["t0"], s["t1"])
                             for s in run.program_spans]
        out["breakdown"] = {
            "device_ops": [list(x) for x in devtrace.top_ops(dt)],
            "idle_gaps": [list(x) for x in devtrace.label_gaps(dt.gaps(),
                                                               spans)]}
    out["checks"] = run.checks
    return out


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="1: the control in the program's place, which "
                    "has to come out not correct (never in a benchmark "
                    "run)")
    return ap.parse_args(argv)


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    bench, cell, _, _ = find_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < int(cell["chips"])):
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"mgitbench: {cell['name']} needs {cell['chips']} CUDA "
              f"device(s); torch sees {seen}", file=sys.stderr)
        return 2
    scratch = Path(tempfile.mkdtemp(prefix="mgitbench-"))
    try:
        run = make_run(args.workload, seed=args.seed, seconds=args.seconds,
                       trace=bool(args.trace), scratch=scratch,
                       control=bool(args.control))
        execute(run, t_start)
        t_check = time.perf_counter() - t_start - run.setup_s - run.window_s
        t_result = time.perf_counter()
        out = result(run, bench)
        print(f"mgitbench: set-up {run.setup_s:.1f} s, window "
              f"{run.window_s:.1f} s, check {t_check:.1f} s, result "
              f"{time.perf_counter() - t_result:.1f} s", file=sys.stderr)
    finally:
        gc.collect()
        shutil.rmtree(scratch, ignore_errors=True)
    loaded = forbidden_modules()
    if loaded:
        print(f"mgitbench: the run loaded {', '.join(loaded)}; the benchmark "
              f"runs the port alone", file=sys.stderr)
        return 3
    for name, c in run.checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
