"""Lineage watch loop: hot-swap endpoints when a publish lands.

Two sources, one contract — ``fetch() -> (payload, etag)``:

* :class:`LocalLineageSource` reads ``lineage.json`` of a repo directory
  and derives the etag with the same canonical content hash the remote
  protocol uses (``lineage_etag``), so a local commit and a hub publish of
  the same document produce the same etag;
* :class:`HubLineageSource` polls the hub's ETag'd ``GET /api/lineage``
  through the existing :class:`HttpTransport` — no new wire protocol.

:class:`LineageWatcher` compares etags and only re-resolves the router on
an actual change; ``poll()`` is also callable directly (the serve HTTP
layer exposes it as ``POST /api/refresh`` so tests and CI don't have to
wait out the poll interval).

Copied from the reference package's ``repro/serve/watch.py``; only the
imports differ.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Any, Dict, Optional, Tuple

from repro_torch.obs import REGISTRY
from repro_torch.remote.transport import ETAG_ABSENT, lineage_etag
from repro_torch.serve.router import Router

logger = logging.getLogger("repro_torch.serve.watch")


class LocalLineageSource:
    def __init__(self, root: str) -> None:
        self.root = root

    def fetch(self) -> Tuple[Optional[Dict[str, Any]], str]:
        path = os.path.join(self.root, "lineage.json")
        if not os.path.exists(path):
            return None, ETAG_ABSENT
        with open(path) as f:
            payload = json.load(f)
        return payload, lineage_etag(payload)

    def describe(self) -> str:
        return f"local:{self.root}"


class HubLineageSource:
    def __init__(self, url: str, token: Optional[str] = None) -> None:
        from repro_torch.remote.http import HttpTransport
        self.url = url
        self.transport = HttpTransport(url, token=token)

    def fetch(self) -> Tuple[Optional[Dict[str, Any]], str]:
        return self.transport.fetch_lineage_versioned()

    def describe(self) -> str:
        return f"hub:{self.url}"


class LineageWatcher:
    """Etag-compare poll loop driving :meth:`Router.refresh`."""

    def __init__(self, source, router: Router,
                 interval_s: float = 1.0) -> None:
        self.source = source
        self.router = router
        self.interval_s = interval_s
        self.last_etag: Optional[str] = None
        self.polls = 0
        self.changes = 0
        # failure visibility: a flaky source must not end the
        # loop, but it must not be silent either — failures count into the
        # registry, the latest error is inspectable via stats(), and the
        # FIRST failure after a healthy poll logs at WARN (one line per
        # outage, not one per tick).
        self.last_error: Optional[str] = None
        self.consecutive_failures = 0
        self._failures = REGISTRY.counter(
            "mgit_watch_poll_failures",
            help="lineage watcher polls that raised",
            source=source.describe())
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def poll(self) -> Dict[str, Any]:
        """One fetch+compare; refreshes the router only on a new etag."""
        payload, etag = self.source.fetch()
        self.polls += 1
        self.last_error = None
        self.consecutive_failures = 0
        if etag == self.last_etag:
            return {"changed": False, "etag": etag}
        # a publish may have been committed by another process (CLI merge,
        # sync pull): re-index the store so the new refs are readable here
        reload_store = getattr(self.router.pool.store, "reload", None)
        if reload_store is not None:
            reload_store()
        report = self.router.refresh(payload, etag=etag)
        self.last_etag = etag
        self.changes += 1
        return {"changed": True, "etag": etag, "endpoints": report}

    def _record_failure(self, exc: Exception) -> None:
        first = self.consecutive_failures == 0
        self.consecutive_failures += 1
        self.last_error = f"{type(exc).__name__}: {exc}"
        self._failures.inc()
        if first:
            logger.warning("lineage watch poll of %s failed: %s "
                           "(retrying every %.1fs)",
                           self.source.describe(), self.last_error,
                           self.interval_s)

    def run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.poll()
            except Exception as exc:  # noqa: BLE001 — a flaky fetch must
                self._record_failure(exc)  # not end the loop; the next
                                           # tick retries

    def start(self) -> "LineageWatcher":
        self._thread = threading.Thread(target=self.run, name="mgit-watch",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def stats(self) -> Dict[str, Any]:
        return {"source": self.source.describe(), "polls": self.polls,
                "changes": self.changes, "etag": self.last_etag,
                "interval_s": self.interval_s,
                "poll_failures": int(self._failures.get()),
                "consecutive_failures": self.consecutive_failures,
                "last_error": self.last_error}
