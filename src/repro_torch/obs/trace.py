"""Trace spans with cross-thread propagation and Chrome-trace export.

A span is a timed region: ``with span("commit.encode", cat="store"):``.
The current span lives in a :mod:`contextvars` ``ContextVar``, so nested
``with`` blocks parent naturally — but ``ThreadPoolExecutor`` workers do
NOT inherit the submitter's context, which is exactly where MGit's hot
paths run (the PR-4 store pool, the PR-2 journal transfer threads, hub
and serve handler threads).  :func:`propagate` closes over the caller's
current span at wrap time and installs it around the callable in the
worker, so pool-side spans parent under the submitting commit/push span
and a traced run exports as ONE connected tree.

Overhead contract (DESIGN.md §14): tracing is off by default and the
disabled path through :func:`span` is a single branch returning a cached
null context manager — no ids, no clocks, no allocation beyond the call
itself; :func:`count` is the same one branch.  What tracing costs when
it is on is recorded in PERF.md (traced against untraced runs of each
benchmark cell).

Counts: ``count("ops.h2d_bytes", n)`` adds to the traced scope's totals,
which are zeroed when tracing switches on and stay readable through
:func:`counts` after :func:`disable` and :func:`reset_trace`, until tracing
is next switched on, so a reader after the traced window sees that
window's work and none of the set-up before it.

Clock: :func:`reset_trace` reads ``perf_counter_ns`` and ``time_ns`` back
to back (the pair with the smallest read gap of a few tries); span
``ts`` values stay relative to that origin, and the export writes the
pair under ``metadata.clock``.  ``unix_ns + ts * 1000`` puts a span on
Unix nanoseconds, the clock of ``torch.profiler``'s kineto events, so a
span lines up with a device trace of the same process without a marker.

Export is the Chrome trace-event JSON Perfetto loads directly
(``ph:"X"`` complete events, µs timestamps, per-thread ``thread_name``
metadata).  ``span_id``/``parent_id`` ride in each event's ``args`` so
tests can reconstruct the parent tree without a Perfetto parser.
"""

from __future__ import annotations

import contextvars
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["span", "count", "counts", "propagate", "enable", "disable",
           "is_enabled", "tracing", "reset_trace", "export_chrome_trace",
           "save_trace", "MAX_EVENTS"]

#: Bounded event buffer: a runaway traced loop degrades to dropped events
#: (counted in ``dropped``), never to unbounded memory.
MAX_EVENTS = 200_000


def _clock_pair(tries: int = 5) -> Tuple[int, int, int]:
    """(perf_counter_ns, time_ns, read gap ns): the Unix time read between
    two reads of the performance counter, whose midpoint it is paired with;
    the tightest of ``tries`` reads."""
    best = None
    for _ in range(tries):
        a = time.perf_counter_ns()
        unix = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[2]:
            best = ((a + b) // 2, unix, b - a)
    return best


class _State:
    __slots__ = ("enabled", "lock", "events", "next_id", "t0_ns",
                 "unix_ns", "read_gap_ns", "thread_names", "dropped",
                 "counts")

    def __init__(self) -> None:
        self.enabled = False
        self.lock = threading.Lock()
        self.events: List[Dict[str, Any]] = []
        self.next_id = 1
        self.t0_ns, self.unix_ns, self.read_gap_ns = _clock_pair()
        self.thread_names: Dict[int, str] = {}
        self.dropped = 0
        self.counts: Dict[str, int] = {}


_state = _State()
_current: contextvars.ContextVar[Optional["_Span"]] = contextvars.ContextVar(
    "mgit_current_span", default=None)


class _NullSpan:
    """Cached no-op context manager handed out while tracing is off."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "cat", "args", "id", "parent_id", "t0", "_token")

    def __init__(self, name: str, cat: str, args: Dict[str, Any]) -> None:
        self.name = name
        self.cat = cat
        self.args = args
        self.id = 0
        self.parent_id: Optional[int] = None
        self.t0 = 0
        self._token: Optional[contextvars.Token] = None

    def __enter__(self) -> "_Span":
        parent = _current.get()
        self.parent_id = parent.id if parent is not None else None
        with _state.lock:
            self.id = _state.next_id
            _state.next_id += 1
        self._token = _current.set(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        dur_ns = time.perf_counter_ns() - self.t0
        if self._token is not None:
            _current.reset(self._token)
        t = threading.current_thread()
        ev = {"name": self.name, "cat": self.cat, "ph": "X",
              "ts": (self.t0 - _state.t0_ns) / 1000.0,
              "dur": dur_ns / 1000.0,
              "pid": os.getpid(), "tid": t.ident,
              "args": dict(self.args, span_id=self.id,
                           parent_id=self.parent_id)}
        if exc and exc[0] is not None:
            ev["args"]["error"] = getattr(exc[0], "__name__", str(exc[0]))
        with _state.lock:
            if len(_state.events) < MAX_EVENTS:
                _state.events.append(ev)
                _state.thread_names.setdefault(t.ident, t.name)
            else:
                _state.dropped += 1
        return False


def span(name: str, cat: str = "app", **args):
    """Open a timed span.  When tracing is disabled this is ONE branch
    and a cached null object — the instrumented hot paths stay hot."""
    if not _state.enabled:
        return _NULL_SPAN
    return _Span(name, cat, args)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the traced scope's total ``name``.  When tracing is
    off this is one branch, as :func:`span` is.  ``n`` may be a 0-dim
    integer tensor on the card: it is added there, so the caller does not
    wait on the card, and the total is read when :func:`counts` or the
    export reads it."""
    if not _state.enabled:
        return
    with _state.lock:
        _state.counts[name] = _state.counts.get(name, 0) + n


def counts() -> Dict[str, int]:
    """The totals of the last traced scope (a copy)."""
    with _state.lock:
        return {k: int(v) for k, v in _state.counts.items()}


def propagate(fn):
    """Wrap ``fn`` so it runs under the CALLER's current span even on a
    foreign thread (executors do not copy contextvars).  When tracing is
    off the original callable is returned untouched."""
    if not _state.enabled:
        return fn
    parent = _current.get()

    def _carry(*a, **kw):
        token = _current.set(parent)
        try:
            return fn(*a, **kw)
        finally:
            _current.reset(token)

    return _carry


def _switch(on: bool) -> None:
    """Set tracing on or off; switching it on zeroes the counts."""
    with _state.lock:
        if on and not _state.enabled:
            _state.counts = {}
        _state.enabled = on


def enable(on: bool = True) -> None:
    _switch(bool(on))


def disable() -> None:
    _state.enabled = False


def is_enabled() -> bool:
    return _state.enabled


class tracing:
    """``with tracing():`` — enable for a scope, restore on exit."""

    def __init__(self, on: bool = True) -> None:
        self.on = on
        self._prev = False

    def __enter__(self) -> None:
        self._prev = _state.enabled
        _switch(bool(self.on))

    def __exit__(self, *exc) -> bool:
        _state.enabled = self._prev
        return False


def reset_trace() -> None:
    with _state.lock:
        _state.events = []
        _state.thread_names = {}
        _state.dropped = 0
        _state.next_id = 1
        _state.t0_ns, _state.unix_ns, _state.read_gap_ns = _clock_pair()


def export_chrome_trace() -> Dict[str, Any]:
    """Snapshot the buffer as a Perfetto/chrome://tracing document, with
    the clock origin and the counts under ``metadata``."""
    with _state.lock:
        events = list(_state.events)
        names = dict(_state.thread_names)
        dropped = _state.dropped
        metadata: Dict[str, Any] = {
            "clock": {"perf_counter_ns": _state.t0_ns,
                      "unix_ns": _state.unix_ns,
                      "read_gap_ns": _state.read_gap_ns},
            "counts": {k: int(v) for k, v in _state.counts.items()}}
    pid = os.getpid()
    meta: List[Dict[str, Any]] = [
        {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": "mgit"}}]
    for tid, tname in sorted(names.items()):
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": tname}})
    if dropped:
        metadata["dropped_events"] = dropped
    return {"traceEvents": meta + events, "displayTimeUnit": "ms",
            "metadata": metadata}


def save_trace(path: str) -> int:
    """Write the Chrome-trace JSON; returns the number of span events."""
    doc = export_chrome_trace()
    with open(path, "w") as f:
        json.dump(doc, f)
    return sum(1 for e in doc["traceEvents"] if e.get("ph") == "X")
