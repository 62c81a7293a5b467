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
itself.  ``bench_obs`` measures (never asserts) that this keeps commit
throughput within noise of an uninstrumented build.

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
from typing import Any, Dict, List, Optional

__all__ = ["span", "propagate", "enable", "disable", "is_enabled",
           "tracing", "current_span", "reset_trace", "export_chrome_trace",
           "save_trace", "MAX_EVENTS"]

#: Bounded event buffer: a runaway traced loop degrades to dropped events
#: (counted in ``dropped``), never to unbounded memory.
MAX_EVENTS = 200_000


class _State:
    __slots__ = ("enabled", "lock", "events", "next_id", "t0_ns",
                 "thread_names", "dropped")

    def __init__(self) -> None:
        self.enabled = False
        self.lock = threading.Lock()
        self.events: List[Dict[str, Any]] = []
        self.next_id = 1
        self.t0_ns = time.perf_counter_ns()
        self.thread_names: Dict[int, str] = {}
        self.dropped = 0


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


def enable(on: bool = True) -> None:
    _state.enabled = bool(on)


def disable() -> None:
    _state.enabled = False


def is_enabled() -> bool:
    return _state.enabled


def current_span() -> Optional[_Span]:
    return _current.get()


class tracing:
    """``with tracing():`` — enable for a scope, restore on exit."""

    def __init__(self, on: bool = True) -> None:
        self.on = on
        self._prev = False

    def __enter__(self) -> None:
        self._prev = _state.enabled
        _state.enabled = bool(self.on)

    def __exit__(self, *exc) -> bool:
        _state.enabled = self._prev
        return False


def reset_trace() -> None:
    with _state.lock:
        _state.events = []
        _state.thread_names = {}
        _state.dropped = 0
        _state.next_id = 1
        _state.t0_ns = time.perf_counter_ns()


def export_chrome_trace() -> Dict[str, Any]:
    """Snapshot the buffer as a Perfetto/chrome://tracing document."""
    with _state.lock:
        events = list(_state.events)
        names = dict(_state.thread_names)
        dropped = _state.dropped
    pid = os.getpid()
    meta: List[Dict[str, Any]] = [
        {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": "mgit"}}]
    for tid, tname in sorted(names.items()):
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": tname}})
    doc: Dict[str, Any] = {"traceEvents": meta + events,
                           "displayTimeUnit": "ms"}
    if dropped:
        doc["metadata"] = {"dropped_events": dropped}
    return doc


def save_trace(path: str) -> int:
    """Write the Chrome-trace JSON; returns the number of span events."""
    doc = export_chrome_trace()
    with open(path, "w") as f:
        json.dump(doc, f)
    return sum(1 for e in doc["traceEvents"] if e.get("ph") == "X")
