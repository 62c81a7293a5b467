"""Deterministic kill-points for fault-injection tests (DESIGN.md §16.5).

A kill-point is a named seam in production code — ``kill_point("hub.publish.pre_replace")``
— that is a no-op unless a test (or the ``MGIT_KILLPOINTS`` env var) arms it.
Armed points count down a hit budget and then *fire*: raise
:class:`KillPointError` (simulating a crash at exactly that seam), or invoke
a registered callback (letting a test interleave a competing operation at a
precise point instead of hand-rolling thread races).

Design constraints:

* **Near-zero overhead when disarmed.** The hot-path check is one read of a
  module-level flag; the registry lock is only taken once a point is armed.
* **Deterministic.** Points fire on the Nth hit (``after`` hits are skipped
  first), not on a timer or scheduler race.
* **Cross-process.** ``MGIT_KILLPOINTS=name[:after][,name2[:after2]]`` arms
  points in a subprocess (e.g. a hub spawned by a CLI test) without any
  in-process handle. Env-armed points always raise; callbacks are
  in-process only.

Seams currently instrumented (grep for ``kill_point(`` to audit):

* ``hub.publish.pre_replace`` / ``hub.publish.post_replace`` — either side
  of the lineage document's atomic ``os.replace`` commit point;
* ``hub.mget.record`` — between streamed mget pack records;
* ``cas.gc.pre_reclaim`` — after GC picks its dead set, before reclaim;
* ``hub.gc.pre_zero`` — after hub maintenance confirms orphans, before
  zeroing refcounts;
* ``replica.sync.pre_publish`` — between a replica's object fetch and its
  local lineage publish.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["KillPointError", "kill_point", "arm", "disarm", "disarm_all",
           "fired", "armed"]


class KillPointError(RuntimeError):
    """Raised when an armed kill-point fires in raise mode.

    Subclasses RuntimeError so production ``except Exception`` cleanup still
    runs, but tests can catch it precisely."""

    def __init__(self, name: str) -> None:
        super().__init__(f"kill-point fired: {name}")
        self.name = name


# any_armed is the only thing the hot path reads while disarmed; it is a
# plain bool write-protected by _lock (benign race: a point armed
# concurrently with a hit may miss that hit — tests arm before acting).
_any_armed = False
_lock = threading.Lock()
#: name -> [remaining_skips, budget, callback|None]
_points: Dict[str, List] = {}
_fired: Dict[str, int] = {}


def _load_env() -> None:
    spec = os.environ.get("MGIT_KILLPOINTS", "")
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        name, _, after = item.partition(":")
        arm(name, after=int(after) if after else 0)


def arm(name: str, after: int = 0, count: int = 1,
        callback: Optional[Callable[[], None]] = None) -> None:
    """Arm ``name``: skip ``after`` hits, then fire on the next ``count``
    hits. With no ``callback`` a hit raises :class:`KillPointError`;
    with one, the callback runs in the hitting thread instead."""
    global _any_armed
    with _lock:
        _points[name] = [int(after), int(count), callback]
        _any_armed = True


def disarm(name: str) -> None:
    global _any_armed
    with _lock:
        _points.pop(name, None)
        _any_armed = bool(_points)


def disarm_all() -> None:
    global _any_armed
    with _lock:
        _points.clear()
        _fired.clear()
        _any_armed = False


def fired(name: str) -> int:
    """How many times ``name`` has fired since the last :func:`disarm_all`."""
    with _lock:
        return _fired.get(name, 0)


def armed(name: str) -> bool:
    with _lock:
        return name in _points


def kill_point(name: str) -> None:
    """Production-code seam. No-op unless ``name`` is armed."""
    global _any_armed
    if not _any_armed:
        return
    with _lock:
        state = _points.get(name)
        if state is None:
            return
        if state[0] > 0:          # still skipping
            state[0] -= 1
            return
        state[1] -= 1
        if state[1] <= 0:
            _points.pop(name)
            _any_armed = bool(_points)
        _fired[name] = _fired.get(name, 0) + 1
        cb = state[2]
    if cb is None:
        raise KillPointError(name)
    cb()


_load_env()
