"""Endpoint router: named endpoints -> branch heads, gated and hot-swapped.

The operational model is the pyxet/XetHub workflow: endpoints pin
*branches*, not node ids — "A/B testing between branches", and promoting a
model to production is a merge. Concretely (DESIGN.md §13):

* a **branch** is named by its root lineage node; the branch **head** is
  found by walking forward from that root — first along version edges
  (``version_children``), then into *join* nodes (provenance children with
  two or more parents, i.e. ``merge(x, y)``). Deriving a new model FROM a
  branch (one-parent provenance children) does not advance it; merging
  INTO it does, which is exactly what makes "promote = merge" work.
* every lineage publish re-resolves each endpoint; when a head moved, the
  new view is built **before** the pointer swap, so the swap itself is one
  pointer assignment under the endpoint lock — in-flight requests hold
  leases on the old view, which stays fully usable until drained.
* the diag quarantine flag (``core.quarantine``) is a serving gate:
  a head that resolves to a quarantined node gets NO traffic — the
  endpoint keeps serving its last healthy view (reported as gate-blocked)
  or, with no prior view, refuses requests outright.

Ported from the reference package's ``repro/serve/router.py``; ``predict``
is the same numpy probe of the view's parameters.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from repro_torch.core.quarantine import is_quarantined
from repro_torch.obs import REGISTRY, span
from repro_torch.serve.pool import ModelPool, ResidentView

# process-wide drain accounting: a view fully drained (last lease released
# after a swap displaced it) is the moment its memory is reclaimable
_DRAINED = REGISTRY.counter(
    "mgit_router_views_drained",
    help="displaced views whose last in-flight lease has released")


class EndpointUnavailable(Exception):
    """No healthy resident view for this endpoint (gate or empty lineage)."""


def parse_endpoint_spec(spec: str) -> Dict[str, str]:
    """``name=branch:X`` | ``name=node:X`` | ``name=ref:m_...`` -> parts.

    ``branch`` re-resolves to the branch head on every lineage change;
    ``node`` pins one lineage node (still gate-checked); ``ref`` pins a raw
    manifest ref (no lineage doc, so no gate or hot swap)."""
    if "=" not in spec:
        raise ValueError(f"endpoint spec {spec!r} is not name=mode:target")
    name, _, rest = spec.partition("=")
    mode, _, target = rest.partition(":")
    if not target:
        mode, target = "branch", rest  # bare `prod=main` means branch:main
    if mode not in ("branch", "node", "ref"):
        raise ValueError(f"endpoint mode {mode!r} not branch|node|ref")
    if not name or not target:
        raise ValueError(f"endpoint spec {spec!r} is missing a name/target")
    return {"name": name, "mode": mode, "target": target}


def resolve_branch_head(nodes: Dict[str, Dict[str, Any]], branch: str) -> str:
    """Walk from the branch root to its current head (see module doc).

    Deterministic (candidates are taken in sorted order) and cycle-guarded;
    raises ``KeyError`` when the branch root is not in the lineage."""
    if branch not in nodes:
        raise KeyError(f"branch root {branch!r} not in lineage")
    cur, seen = branch, {branch}
    while True:
        doc = nodes[cur]
        step = next((v for v in sorted(doc.get("version_children", []))
                     if v in nodes and v not in seen), None)
        if step is None:
            step = next(
                (c for c in sorted(doc.get("children", []))
                 if c in nodes and c not in seen
                 and len(nodes[c].get("parents", [])) >= 2), None)
        if step is None:
            return cur
        seen.add(step)
        cur = step


class Endpoint:
    """One named route: current view + lease/drain accounting."""

    def __init__(self, name: str, mode: str, target: str) -> None:
        self.name = name
        self.mode = mode
        self.target = target
        self._lock = threading.Lock()
        self._view: Optional[ResidentView] = None
        self.node: Optional[str] = None
        self.gate_reason: Optional[str] = None
        self.swaps = 0
        self.last_swap_s = 0.0
        self._draining: List[ResidentView] = []

    @contextmanager
    def lease(self):
        """Yield the current view, held alive for the whole request.

        The lease is what makes swaps zero-drop: ``swap`` only moves the
        endpoint's pointer, so a view leased here stays valid (arrays,
        aliases and all) until this context exits."""
        with self._lock:
            if self._view is None:
                raise EndpointUnavailable(
                    f"endpoint {self.name!r} has no healthy model"
                    + (f" (gate: {self.gate_reason})"
                       if self.gate_reason else ""))
            view = self._view
            view.acquire()
        try:
            yield view
        finally:
            view.release()
            self._reap()

    def swap(self, view: ResidentView, node: Optional[str],
             took_s: float) -> None:
        with self._lock:
            old, self._view = self._view, view
            self.node = node
            self.gate_reason = None
            self.swaps += 1
            self.last_swap_s = took_s
            if old is not None and old is not view:
                self._draining.append(old)
        self._reap()

    def block(self, reason: str) -> None:
        """Gate: stop advancing; last healthy view (if any) keeps serving."""
        with self._lock:
            self.gate_reason = reason

    def _reap(self) -> None:
        with self._lock:
            still = [v for v in self._draining if v.active_leases > 0]
            drained = len(self._draining) - len(still)
            self._draining = still
        if drained:
            _DRAINED.inc(drained)

    @property
    def current_ref(self) -> Optional[str]:
        with self._lock:
            return self._view.ref if self._view is not None else None

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "name": self.name,
                "spec": f"{self.mode}:{self.target}",
                "node": self.node,
                "ref": self._view.ref if self._view else None,
                "gate": self.gate_reason,
                "swaps": self.swaps,
                "last_swap_s": round(self.last_swap_s, 6),
                "draining": len(self._draining),
                "active_leases": (self._view.active_leases
                                  if self._view else 0),
            }


class Router:
    """Maps endpoint names to resident views; re-resolves on refresh."""

    def __init__(self, pool: ModelPool, specs: List[str]) -> None:
        self.pool = pool
        self.endpoints: Dict[str, Endpoint] = {}
        for spec in specs:
            p = parse_endpoint_spec(spec)
            if p["name"] in self.endpoints:
                raise ValueError(f"duplicate endpoint {p['name']!r}")
            self.endpoints[p["name"]] = Endpoint(p["name"], p["mode"],
                                                 p["target"])
        self.etag: Optional[str] = None
        self.refreshes = 0

    def refresh(self, payload: Optional[Dict[str, Any]],
                etag: Optional[str] = None) -> Dict[str, Any]:
        """Re-resolve every endpoint against a lineage document.

        Builds any new view BEFORE swapping the endpoint pointer; a failed
        build or a quarantined head leaves the endpoint on its previous
        healthy view. Returns a per-endpoint report."""
        nodes = {n["name"]: n
                 for n in (payload or {}).get("nodes", [])}
        report: Dict[str, Any] = {}
        for ep in self.endpoints.values():
            try:
                report[ep.name] = self._refresh_one(ep, nodes)
            except Exception as exc:  # noqa: BLE001 — one endpoint failing
                ep.block(str(exc))    # must not take the others down
                report[ep.name] = {"status": "error", "error": str(exc)}
        self.etag = etag
        self.refreshes += 1
        return report

    def _refresh_one(self, ep: Endpoint,
                     nodes: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
        if ep.mode == "ref":
            ref, node = ep.target, None
        else:
            node = (resolve_branch_head(nodes, ep.target)
                    if ep.mode == "branch" else ep.target)
            doc = nodes.get(node)
            if doc is None:
                raise KeyError(f"node {node!r} not in lineage")
            if is_quarantined(doc):
                ep.block(f"node {node!r} is quarantined")
                return {"status": "gate_blocked", "node": node}
            ref = doc.get("artifact_ref")
            if not ref:
                raise ValueError(f"node {node!r} has no stored artifact")
        if ref == ep.current_ref:
            with ep._lock:
                ep.gate_reason = None
                ep.node = node
            return {"status": "unchanged", "node": node, "ref": ref}
        t0 = time.perf_counter()
        with span("endpoint.swap", cat="serve", endpoint=ep.name, ref=ref):
            view = self.pool.get(ref)  # built before the pointer moves
            ep.swap(view, node, time.perf_counter() - t0)
        return {"status": "swapped", "node": node, "ref": ref}

    # -- request path --------------------------------------------------------
    def predict(self, endpoint: str, x=None) -> Dict[str, Any]:
        ep = self.endpoints.get(endpoint)
        if ep is None:
            raise KeyError(f"no endpoint {endpoint!r}")
        with ep.lease() as view:
            y = view.probe(x)
            return {"endpoint": endpoint, "node": ep.node, "ref": view.ref,
                    "y": [float(v) for v in y.ravel()[:16]],
                    "mean": float(y.mean())}

    def stats(self) -> Dict[str, Any]:
        return {"etag": self.etag, "refreshes": self.refreshes,
                "endpoints": [ep.stats()
                              for ep in self.endpoints.values()]}
