"""Straggler detection & mitigation hooks + heartbeat watchdog.

At 1000+ nodes, tail-latency hosts dominate step time (synchronous SPMD waits
for the slowest participant). The framework-side pieces we can build and test
without hardware:

* :class:`StepTimer` — per-step EWMA + variance; flags steps slower than
  ``threshold`` x the running mean (the standard detection signal).
* :class:`StragglerPolicy` — pluggable responses, in escalating order:
  log -> shrink the offender's data shard (rebalance callback) -> evict +
  elastic restart from the last MGit checkpoint (the CheckpointManager's
  ``restore_sharded`` lays the state out on the live state's device).
* :class:`Watchdog` — heartbeat file per host + stale-peer detection; drives
  the same policy on hang (vs slow) failures.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    mean: float
    ratio: float


class StepTimer:
    """EWMA step-time tracker; emits an event when a step is anomalously slow."""

    def __init__(self, threshold: float = 2.0, alpha: float = 0.1,
                 warmup: int = 5) -> None:
        self.threshold = threshold
        self.alpha = alpha
        self.warmup = warmup
        self.mean: Optional[float] = None
        self.n = 0
        self.events: List[StragglerEvent] = []

    def record(self, step: int, duration: float) -> Optional[StragglerEvent]:
        self.n += 1
        if self.mean is None:
            self.mean = duration
            return None
        event = None
        ratio = duration / max(self.mean, 1e-9)
        if self.n > self.warmup and ratio > self.threshold:
            event = StragglerEvent(step=step, duration=duration,
                                   mean=self.mean, ratio=ratio)
            self.events.append(event)
            # don't pollute the EWMA with the anomaly
            return event
        self.mean = (1 - self.alpha) * self.mean + self.alpha * duration
        return event


class StragglerPolicy:
    """Escalating mitigation: log -> rebalance -> evict/elastic-restart."""

    def __init__(self,
                 rebalance_fn: Optional[Callable[[StragglerEvent], None]] = None,
                 evict_fn: Optional[Callable[[StragglerEvent], None]] = None,
                 rebalance_after: int = 2, evict_after: int = 5) -> None:
        self.rebalance_fn = rebalance_fn
        self.evict_fn = evict_fn
        self.rebalance_after = rebalance_after
        self.evict_after = evict_after
        self.count = 0
        self.actions: List[str] = []

    def on_event(self, event: StragglerEvent) -> str:
        self.count += 1
        if self.count >= self.evict_after and self.evict_fn is not None:
            self.evict_fn(event)
            action = "evict"
        elif self.count >= self.rebalance_after and self.rebalance_fn is not None:
            self.rebalance_fn(event)
            action = "rebalance"
        else:
            action = "log"
        self.actions.append(action)
        return action


class ElasticRestart:
    """Evict-stage policy action: resume the trainer from its lineage.

    Wired as :class:`StragglerPolicy`'s ``evict_fn``, this closes the
    evict -> elastic-restart loop described in the module docstring: when a
    host is slow enough to evict, the trainer restores the last committed
    MGit checkpoint and continues from there. With continuous
    checkpointing (DESIGN.md §15) the rollback window is the commit
    cadence — steps, not epochs — and the exact tier makes the resumed
    state bit-identical to what was committed. The live state is the
    template, so every leaf comes back on the device it lives on.

    ``trainer`` is duck-typed: it needs ``.ckpt`` (a CheckpointManager or
    None), ``.state``, ``.pipeline`` and ``.start_step``."""

    def __init__(self, trainer) -> None:
        self.trainer = trainer
        self.restarts: List[Dict[str, int]] = []

    def __call__(self, event: StragglerEvent) -> None:
        tr = self.trainer
        ckpt = getattr(tr, "ckpt", None)
        if ckpt is None:
            return
        ckpt.wait()  # drain in-flight commits; surface async failures
        if ckpt.latest_step() is None:
            return  # nothing committed yet: keep the live state
        state, step = ckpt.restore_sharded(tr.state)
        tr.state = state
        tr.pipeline.step = step
        tr.start_step = step
        self.restarts.append({"event_step": event.step,
                              "restored_step": step})


class Watchdog:
    """File-based heartbeats: each host touches its file; stale peers flagged."""

    def __init__(self, directory: str, host_id: str, interval: float = 1.0,
                 stale_after: float = 5.0) -> None:
        self.directory = directory
        self.host_id = host_id
        self.interval = interval
        self.stale_after = stale_after
        os.makedirs(directory, exist_ok=True)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _path(self, host: str) -> str:
        return os.path.join(self.directory, f"hb_{host}")

    def beat(self) -> None:
        with open(self._path(self.host_id), "w") as f:
            f.write(str(time.time()))

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.interval):
                self.beat()
        self.beat()
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    def stale_peers(self) -> Dict[str, float]:
        """host -> seconds since last heartbeat, for peers past stale_after."""
        now = time.time()
        stale = {}
        for f in os.listdir(self.directory):
            if not f.startswith("hb_"):
                continue
            host = f[3:]
            if host == self.host_id:
                continue
            age = now - os.path.getmtime(os.path.join(self.directory, f))
            if age > self.stale_after:
                stale[host] = age
        return stale
