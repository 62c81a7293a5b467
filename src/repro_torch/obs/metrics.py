"""Process-wide metrics registry: counters and fixed-bucket histograms.

One :class:`Registry` per process (module-level :data:`REGISTRY`) holds
every metric family; subsystems that used to keep ad-hoc dicts
(``store.io_stats``, ``hub.app.stats``, ``serve.pool.stats_counters``)
now hold a :class:`MetricGroup` — a dict-compatible view whose entries
are registry counters.  Existing call sites (``stats[k] += n`` under the
owner's lock, ``dict(stats)``, ``**stats``) keep working unchanged while
the same numbers become scrapeable through the Prometheus text
exposition (:meth:`Registry.render_prometheus`).

Naming scheme (DESIGN.md §14): ``mgit_<subsystem>_<what>[_<unit>]``,
e.g. ``mgit_store_bytes_materialized``, ``mgit_hub_requests``,
``mgit_http_request_seconds``.  Families are multi-child: each child is
one label set (``instance="3"`` distinguishes the many ArtifactStore
objects a test spins up; daemons add ``route``/``method``).

Record paths are thread-safe and allocation-free in the steady state: a
counter increment is one lock + one int add; a histogram observation is
one lock + a ``bisect`` into pre-built bounds — no per-record dict or
list is created.  Atomic multi-key reads go through
:meth:`MetricGroup.snapshot` / :meth:`MetricGroup.reset`, which hold the
group lock across every key (this is what fixes the torn
``reset_io_stats`` reads the per-key dict mutation loop allowed).
"""

from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

__all__ = ["Registry", "MetricGroup", "Counter", "Histogram",
           "REGISTRY", "DEFAULT_BUCKETS", "render_prometheus"]

# Latency buckets in seconds: 100µs .. 10s, roughly log-spaced.  Fixed at
# family creation so the observe path never grows structures.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\"", "\\\"").replace("\n", "\\n")


def _fmt_labels(labels: Tuple[Tuple[str, str], ...],
                extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    items = labels + extra
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in items)
    return "{" + body + "}"


def _fmt_value(v: float) -> str:
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int) or (isinstance(v, float) and v == int(v)
                              and abs(v) < 1e15):
        return str(int(v))
    return repr(float(v))


def _fmt_le(bound: float) -> str:
    return _fmt_value(bound) if bound != float("inf") else "+Inf"


class Counter:
    """Monotonic-by-convention scalar.  ``set`` exists for the dict-compat
    view (``stats[k] = 0`` style resets route through it)."""

    kind = "counter"
    __slots__ = ("name", "labels", "_lock", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 lock: threading.Lock) -> None:
        self.name = name
        self.labels = labels
        self._lock = lock
        self.value: float = 0

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self.value += n

    def set(self, v: float) -> None:
        with self._lock:
            self.value = v

    def get(self) -> float:
        return self.value


class Histogram:
    """Fixed-bucket histogram with Prometheus cumulative exposition.

    ``observe`` is the hot path: one lock, one bisect, two adds.
    ``quantile`` applies the same linear-interpolation-within-bucket
    estimate ``histogram_quantile()`` uses server-side, so the p50/p99
    surfaced in ``/api/stats`` match what a Prometheus query would say.
    """

    kind = "histogram"
    __slots__ = ("name", "labels", "_lock", "bounds", "counts", "sum",
                 "count")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 lock: threading.Lock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        self.name = name
        self.labels = labels
        self._lock = lock
        self.bounds: List[float] = sorted(float(b) for b in buckets)
        self.counts: List[int] = [0] * (len(self.bounds) + 1)  # last: +Inf
        self.sum: float = 0.0
        self.count: int = 0

    def observe(self, v: float) -> None:
        with self._lock:
            self.counts[bisect.bisect_left(self.bounds, v)] += 1
            self.sum += v
            self.count += 1

    def snapshot(self) -> Tuple[List[int], float, int]:
        with self._lock:
            return list(self.counts), self.sum, self.count

    def quantile(self, q: float) -> Optional[float]:
        """Estimate the q-quantile (0..1) by linear interpolation inside
        the bucket the target rank falls in; observations beyond the last
        finite bound clamp to it (Prometheus semantics)."""
        counts, _, total = self.snapshot()
        if total == 0:
            return None
        target = q * total
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= target and c > 0:
                if i == len(self.bounds):        # +Inf bucket
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                return lo + (hi - lo) * ((target - (cum - c)) / c)
        return self.bounds[-1]


class Registry:
    """All metric families of one process, keyed by family name.

    A family is (kind, help, buckets) plus one child metric per distinct
    label set; re-requesting the same (name, labels) returns the same
    child, so instrumentation sites don't need to cache handles (though
    hot paths should)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: Dict[str, Dict[str, Any]] = {}
        self._instances: Dict[str, int] = {}

    # -- family / child construction -----------------------------------
    def _child(self, cls, name: str, help: str, labels: Dict[str, str],
               lock: Optional[threading.Lock] = None, **kw):
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = {"kind": cls.kind, "help": help, "children": {}}
                self._families[name] = fam
            elif fam["kind"] != cls.kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam['kind']}")
            child = fam["children"].get(key)
            if child is None:
                child = cls(name, key, lock or threading.Lock(), **kw)
                fam["children"][key] = child
            return child

    def counter(self, name: str, help: str = "",
                lock: Optional[threading.Lock] = None, **labels) -> Counter:
        return self._child(Counter, name, help, labels, lock=lock)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._child(Histogram, name, help, labels, buckets=buckets)

    def next_instance(self, namespace: str) -> str:
        """Monotonic per-namespace id so many live objects (stores in a
        test run) keep disjoint label sets in one shared registry."""
        with self._lock:
            n = self._instances.get(namespace, 0)
            self._instances[namespace] = n + 1
            return str(n)

    def group(self, namespace: str, keys: Sequence[str] = (),
              help: str = "", instance: Optional[str] = None) -> "MetricGroup":
        return MetricGroup(self, namespace, keys=keys, help=help,
                           instance=instance)

    # -- exposition ----------------------------------------------------
    def collect(self):
        with self._lock:
            return [(name, fam["kind"], fam["help"],
                     list(fam["children"].values()))
                    for name, fam in sorted(self._families.items())]

    def render_prometheus(self) -> str:
        out: List[str] = []
        for name, kind, help, children in self.collect():
            if help:
                out.append(f"# HELP {name} {help}")
            out.append(f"# TYPE {name} {kind}")
            for m in children:
                if kind == "histogram":
                    counts, total_sum, total = m.snapshot()
                    cum = 0
                    bounds = m.bounds + [float("inf")]
                    for b, c in zip(bounds, counts):
                        cum += c
                        lab = _fmt_labels(m.labels, (("le", _fmt_le(b)),))
                        out.append(f"{name}_bucket{lab} {cum}")
                    lab = _fmt_labels(m.labels)
                    out.append(f"{name}_sum{lab} {_fmt_value(total_sum)}")
                    out.append(f"{name}_count{lab} {total}")
                else:
                    lab = _fmt_labels(m.labels)
                    out.append(f"{name}{lab} {_fmt_value(m.get())}")
        return "\n".join(out) + "\n"


class MetricGroup:
    """Dict-compatible view over a namespace of registry counters.

    Supports every pattern the legacy stats dicts were used with —
    ``g[k] += n`` (owner-lock serialized), ``g.get(k, 0)``, ``dict(g)``,
    ``**g``, ``for k in g`` — plus :meth:`snapshot` and :meth:`reset`
    that hold ONE lock across all keys, which the per-key mutation loop
    they replace could not do.  Unknown keys materialize on first write
    (the hub counts dynamic keys like per-status rejections)."""

    def __init__(self, registry: Registry, namespace: str,
                 keys: Sequence[str] = (), help: str = "",
                 instance: Optional[str] = None) -> None:
        self._registry = registry
        self._namespace = namespace
        self._help = help
        self.instance = (registry.next_instance(namespace)
                         if instance is None else instance)
        self._lock = threading.Lock()
        self._metrics: Dict[str, Counter] = {}
        for k in keys:
            self._ensure(k)

    def _ensure(self, key: str) -> Counter:
        m = self._metrics.get(key)
        if m is None:
            # every child shares the group lock, so snapshot()/reset()
            # exclude concurrent increments on ANY key of the group
            m = self._registry.counter(f"{self._namespace}_{key}",
                                       help=self._help, lock=self._lock,
                                       instance=self.instance)
            with self._lock:  # keep snapshot() iteration safe
                self._metrics[key] = m
        return m

    # -- dict protocol -------------------------------------------------
    def __getitem__(self, key: str) -> float:
        return self._metrics[key].get()

    def __setitem__(self, key: str, value: float) -> None:
        self._ensure(key).set(value)

    def __contains__(self, key: str) -> bool:
        return key in self._metrics

    def __iter__(self) -> Iterator[str]:
        return iter(list(self._metrics))

    def __len__(self) -> int:
        return len(self._metrics)

    def keys(self):
        return list(self._metrics)

    def items(self):
        return [(k, m.get()) for k, m in self._metrics.items()]

    def values(self):
        return [m.get() for m in self._metrics.values()]

    def get(self, key: str, default: float = 0) -> float:
        m = self._metrics.get(key)
        return default if m is None else m.get()

    def __eq__(self, other: object) -> bool:
        if isinstance(other, MetricGroup):
            return self.snapshot() == other.snapshot()
        if isinstance(other, dict):
            return self.snapshot() == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"MetricGroup({self._namespace}, {self.snapshot()!r})"

    # -- atomic multi-key operations ----------------------------------
    def inc(self, key: str, n: float = 1) -> None:
        self._ensure(key).inc(n)

    def snapshot(self) -> Dict[str, float]:
        """All keys read under one lock — no torn multi-key view.
        Field access is direct: the metrics share this very lock."""
        with self._lock:
            return {k: m.value for k, m in self._metrics.items()}

    def reset(self) -> Dict[str, float]:
        """Zero every key under one lock; returns the pre-reset values."""
        with self._lock:
            before = {}
            for k, m in self._metrics.items():
                before[k] = m.value
                m.value = 0
            return before


#: The process-wide default registry every subsystem records into.
REGISTRY = Registry()


def render_prometheus() -> str:
    return REGISTRY.render_prometheus()
