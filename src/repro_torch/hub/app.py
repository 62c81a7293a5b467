"""HubApp / HubService — the model-hub daemon's state machines (DESIGN.md §11, §16).

One :class:`HubApp` instance serves one repository through the same
:class:`ArtifactStore` a local client would open — the hub is "just another
peer" whose transport happens to be HTTP. The HTTP layer
(:mod:`repro_torch.hub.routes`) stays a thin codec: every semantic decision lives
here so it is unit-testable without sockets.

:class:`HubService` (§16.1) scales that to many repositories over ONE shared
CAS: tenants live at ``<root>/repos/<name>/`` (per-repo lineage document,
transfer journal and publish lock), while objects/packs/refcounts are
service-wide — a derived model pushed to repo B dedups byte-for-byte against
its base in repo A. The hub root itself doubles as the ``default`` tenant,
so a single-repo hub directory is a valid (one-tenant) service and the
unscoped ``/api/...`` surface keeps working unchanged.

Sharing the refcount table changes two derivations: ``finalize`` and
``fsck`` must take the *union* of all tenants' roots (one tenant's roots
would clobber counts on objects another tenant shares), and deleting a repo
cannot decrement anything synchronously — its objects become *orphans*
(positive refcount, unreachable from every tenant) that the maintenance
pass in :mod:`repro_torch.hub.gc` confirms across two cycles before reclaiming.
``HubService`` tracks recently-imported keys for the same reason: a push's
objects are refcounted but unreachable until its publish lands, and must
never be mistaken for garbage in between.

Concurrency model (§11.3): object ingestion and reads are fully parallel —
the CAS is internally locked, writes are content-addressed and idempotent,
and reads come off the pooled mmap views. Only the *lineage publish* takes
the per-repo write lock, and only for the duration of one compare-and-swap:
the client sends the etag of the document its merge was based on, and a
mismatch raises :class:`PublishConflict` (HTTP 409) instead of clobbering a
concurrent pusher's work. Refcount finalization re-derives its root set
from the *current* published document under the same lock, so interleaved
``publish``/``finalize`` pairs from racing clients always converge on exact
counts (fsck-clean).

Quarantine is honored server-side (§9.4 meets §11.3): a pushed document may
not introduce or modify nodes flagged quarantined — the hub keeps its own
copy (or drops a new quarantined node) and reports the rejected names,
unless the operator started it with ``allow_quarantined``. Client-side
filtering already does this by default; the server check makes the policy
hold against old or adversarial clients too.

As everywhere in the remote stack, the hub only ever handles *stored*
artifact bytes: manifests, tensors and delta blobs under their CAS keys.

Copied from the reference package's ``repro/hub/app.py``. The one
difference: :class:`HubApp` (standalone) and :class:`HubService` take the
``backend`` of the store they open (``None``, the default, means the card;
``"ref"`` the host's plain versions), as every port ``ArtifactStore`` does.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Iterable, Iterator, List, Mapping, Optional
from typing import Sequence, Tuple

from repro_torch.common.faults import kill_point
from repro_torch.hub.auth import TokenAuth
from repro_torch.obs import REGISTRY, Histogram, render_prometheus
from repro_torch.remote.journal import LocalJournalStore
from repro_torch.remote.transport import (ETAG_ABSENT, PublishConflict,
                                    lineage_etag)
from repro_torch.store.artifact_store import ArtifactStore

#: counters every HubApp/HubService exposes as ``mgit_hub_*`` (§14, §16)
HUB_STAT_KEYS = ("requests", "bytes_in", "bytes_out", "objects_served",
                 "objects_received", "publishes", "conflicts_409",
                 "quarantine_rejected", "auth_failures", "finalizes",
                 "sheds_503", "errors_500", "gc_runs", "gc_bytes_reclaimed",
                 "compactions", "replica_syncs", "replica_fallbacks")


class ReadOnlyRepo(RuntimeError):
    """Raised when a mutating operation hits a read-only (replica) hub."""


class HubApp:
    """Serves one repo directory; thread-safe for a ThreadingHTTPServer."""

    def __init__(self, root: str, token: Optional[str] = None,
                 allow_quarantined: bool = False,
                 store: Optional[ArtifactStore] = None,
                 service: Optional["HubService"] = None,
                 name: str = "default", read_only: bool = False,
                 backend: Optional[str] = None) -> None:
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        # shared-store mode (§16.1): the service owns ONE ArtifactStore for
        # every tenant; this repo dir then holds only lineage.json and its
        # transfer journal. Standalone mode keeps the single-repo shape.
        self.store = (store if store is not None
                      else ArtifactStore(root=self.root, backend=backend))
        self.service = service
        self.name = name
        self.read_only = read_only
        self.journal = LocalJournalStore(self.root)
        self.auth = TokenAuth(token)
        self.allow_quarantined = allow_quarantined
        self._publish_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.started_at = time.time()
        # registry-backed compat view: same count()/stats_json() surface,
        # scrapeable as mgit_hub_* through GET /api/metrics (§14)
        self.stats = REGISTRY.group(
            "mgit_hub", keys=HUB_STAT_KEYS,
            help="hub request/transfer counters")
        self._latency: Dict[Tuple[str, str], Histogram] = {}

    # -- stats ---------------------------------------------------------------
    def count(self, **deltas: int) -> None:
        with self._stats_lock:
            for key, d in deltas.items():
                self.stats[key] = self.stats.get(key, 0) + d

    def observe_request(self, method: str, route: str,
                        seconds: float) -> None:
        """Record one request into the per-route latency histogram."""
        h = self._latency.get((method, route))
        if h is None:
            h = REGISTRY.histogram(
                "mgit_http_request_seconds",
                help="request latency by service/method/route",
                service="hub", instance=self.stats.instance,
                method=method, route=route)
            self._latency[(method, route)] = h
        h.observe(seconds)

    def latency_json(self) -> Dict[str, Any]:
        """Per-route p50/p99 estimated from the histogram buckets —
        the same math a `histogram_quantile()` PromQL query would do."""
        out: Dict[str, Any] = {}
        for (method, route), h in sorted(self._latency.items()):
            out[f"{method} {route}"] = {
                "count": h.count,
                "p50_ms": round((h.quantile(0.5) or 0.0) * 1e3, 3),
                "p99_ms": round((h.quantile(0.99) or 0.0) * 1e3, 3)}
        return out

    def metrics_text(self) -> str:
        """Prometheus text exposition of the whole process registry."""
        return render_prometheus()

    def stats_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = self.stats.snapshot()
        out["uptime_seconds"] = round(time.time() - self.started_at, 3)
        out["objects"] = self.store.cas.object_count()
        out["physical_bytes"] = self.store.cas.physical_bytes()
        out["in_flight_transfers"] = list(self.journal.journal_list())
        out["request_latency"] = self.latency_json()
        return out

    # -- lineage document ----------------------------------------------------
    def _lineage_path(self) -> str:
        return os.path.join(self.root, "lineage.json")

    def lineage(self) -> Tuple[Optional[Dict], str]:
        """Current document + etag (``ETAG_ABSENT`` when none published)."""
        if not os.path.exists(self._lineage_path()):
            return None, ETAG_ABSENT
        with open(self._lineage_path()) as f:
            payload = json.load(f)
        return payload, lineage_etag(payload)

    def _filter_quarantined(self, payload: Dict, current: Optional[Dict]
                            ) -> Tuple[Dict, List[str]]:
        """Enforce the quarantine policy on an incoming document.

        A quarantined node identical to the hub's copy passes (it is not
        being *propagated*, just echoed back by the client's merge); one
        that is new or modified is replaced by the hub's copy or dropped.
        Adjacency lists are pruned to the surviving node set afterwards so
        a drop never leaves dangling edges."""
        from repro_torch.core.quarantine import is_quarantined
        cur = {n["name"]: n for n in (current or {}).get("nodes", [])}
        kept: List[Dict] = []
        rejected: List[str] = []
        for node in payload.get("nodes", []):
            if is_quarantined(node) and node != cur.get(node["name"]):
                rejected.append(node["name"])
                if node["name"] in cur:
                    kept.append(cur[node["name"]])
                continue
            kept.append(node)
        if not rejected:
            return payload, []
        names = {n["name"] for n in kept}
        for node in kept:
            for field in ("parents", "children", "version_parents",
                          "version_children"):
                node[field] = [x for x in node.get(field, []) if x in names]
        return {"nodes": kept}, sorted(rejected)

    def publish(self, payload: Dict, expected: Optional[str] = None,
                mirror: bool = False) -> Dict[str, Any]:
        """Compare-and-swap the lineage document (the push commit point).

        Raises :class:`PublishConflict` when ``expected`` no longer matches
        the current etag. Returns ``{"etag", "quarantined_rejected"}``.

        ``mirror=True`` is the replica-sync path (§16.5): an unconditional
        byte-faithful replace that bypasses the read-only guard and the
        quarantine filter — the primary already applied policy, and a
        replica re-filtering would drift its etag from the primary's,
        permanently failing the client's staleness check."""
        if self.read_only and not mirror:
            raise ReadOnlyRepo(f"repo {self.name!r} is a read-only replica")
        with self._publish_lock:
            current, current_etag = self.lineage()
            if expected is not None and expected != current_etag:
                self.count(conflicts_409=1)
                raise PublishConflict(current_etag)
            if not self.allow_quarantined and not mirror:
                payload, rejected = self._filter_quarantined(payload, current)
            else:
                rejected = []
            tmp = self._lineage_path() + ".tmp"
            kill_point("hub.publish.pre_replace")
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._lineage_path())
            kill_point("hub.publish.post_replace")
            self.count(publishes=1, quarantine_rejected=len(rejected))
            return {"etag": lineage_etag(payload),
                    "quarantined_rejected": rejected}

    def roots(self) -> List[str]:
        """``artifact_ref`` roots of this repo's current document."""
        payload, _ = self.lineage()
        return [n["artifact_ref"] for n in (payload or {}).get("nodes", [])
                if n.get("artifact_ref")]

    def finalize(self) -> int:
        """Rebuild exact refcounts from the *current* document's roots.

        Root derivation is server-side on purpose: a racing client's view
        of the merged roots may be stale by the time its finalize arrives;
        the published document is the single source of truth. Runs under
        the publish lock so a rebuild never interleaves with a swap.

        In shared-store mode the rebuild must span the union of every
        tenant's roots — rebuilding from one tenant's view would install
        that tenant's counts on objects other tenants also reference — so
        it delegates to :meth:`HubService.finalize`."""
        if self.service is not None:
            self.count(finalizes=1)
            return self.service.finalize()
        with self._publish_lock:
            counts = self.store.rebuild_refcounts(self.roots())
            self.count(finalizes=1)
            return len(counts)

    # -- objects -------------------------------------------------------------
    def have(self, keys: Sequence[str]) -> List[str]:
        cas = self.store.cas
        return [k for k in keys if cas.has(k)]

    def object_sizes(self, keys: Sequence[str]
                     ) -> Tuple[Dict[str, int], List[str]]:
        """(sizes of present keys, missing keys) — the mget preflight that
        lets routes send an exact Content-Length before streaming."""
        cas = self.store.cas
        sizes: Dict[str, int] = {}
        missing: List[str] = []
        for k in keys:
            if cas.has(k):
                sizes[k] = cas.size(k)
            else:
                missing.append(k)
        return sizes, missing

    def iter_object_views(self, keys: Sequence[str]
                          ) -> Iterator[Tuple[str, memoryview]]:
        """Zero-copy streaming multi-get straight off the CAS mmap pool."""
        return self.store.cas.iter_views(keys)

    def import_objects(self, objects: Mapping[str, bytes]) -> int:
        if self.read_only:
            raise ReadOnlyRepo(f"repo {self.name!r} is a read-only replica")
        written = self.store.import_objects(objects)
        if self.service is not None:
            # grace-list the keys so maintenance GC cannot mistake a push's
            # not-yet-published objects for orphans (§16.3)
            self.service.note_imports(objects.keys())
        self.count(objects_received=len(objects))
        return written

    def fsck(self) -> Dict[str, Any]:
        # shared-store mode: integrity is a service-wide question (the
        # refcount table spans tenants), answered against the union roots
        if self.service is not None:
            report = self.service.fsck()
        else:
            report = self.store.fsck(self.roots())
        report["in_flight_transfers"] = list(self.journal.journal_list())
        return report


class HubService:
    """Many repos, one CAS (§16.1): the multi-tenant hub state machine.

    The service root holds the shared ``ArtifactStore``; the root directory
    itself is the ``default`` tenant (backward compatible with a single-repo
    hub dir) and named tenants live under ``repos/<name>/``. Tenant apps share
    the service's token, quarantine policy and read-only flag; each keeps
    its own publish lock, lineage etag and transfer journal.
    """

    def __init__(self, root: str, token: Optional[str] = None,
                 allow_quarantined: bool = False,
                 read_only: bool = False,
                 backend: Optional[str] = None) -> None:
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.store = ArtifactStore(root=self.root, backend=backend)
        self.token = token
        self.auth = TokenAuth(token)
        self.allow_quarantined = allow_quarantined
        self.read_only = read_only
        self.started_at = time.time()
        self._repos: Dict[str, HubApp] = {}
        self._repos_lock = threading.RLock()
        # one finalize at a time service-wide: rebuilds write the SHARED
        # refcount table, and interleaved rebuilds from different root
        # snapshots could leave a mix of both (§16.1)
        self._finalize_lock = threading.RLock()
        # maintenance state (§16.3) — owned by repro.hub.gc
        self.gc_lock = threading.Lock()
        self.gc_cycle = 0
        self.prev_orphans: set = set()
        self._imports_lock = threading.Lock()
        #: key -> (gc_cycle at import, monotonic time at import)
        self._recent_imports: Dict[str, Tuple[int, float]] = {}
        #: wall-clock backstop for the import grace list — an abandoned
        #: transfer's debris lingers at most this long past its last chunk
        self.import_grace_s = 900.0
        self.default = self._make_app("default", self.root)
        for name in self._scan_repos():
            self.repo(name)

    # -- tenants -------------------------------------------------------------
    def _repo_dir(self, name: str) -> str:
        return os.path.join(self.root, "repos", name)

    def _make_app(self, name: str, root: str) -> HubApp:
        app = HubApp(root, token=self.token,
                     allow_quarantined=self.allow_quarantined,
                     store=self.store, service=self, name=name,
                     read_only=self.read_only)
        self._repos[name] = app
        return app

    def _scan_repos(self) -> List[str]:
        repos_dir = os.path.join(self.root, "repos")
        if not os.path.isdir(repos_dir):
            return []
        return sorted(d for d in os.listdir(repos_dir)
                      if os.path.isdir(os.path.join(repos_dir, d)))

    def repo(self, name: str, create: bool = True) -> Optional[HubApp]:
        """Tenant app for ``name``, created on first touch when allowed.

        Callers (the HTTP layer) validate the name shape before this point;
        creation is an authorized-request-only path there."""
        with self._repos_lock:
            app = self._repos.get(name)
            if app is None and create:
                app = self._make_app(name, self._repo_dir(name))
            return app

    def repo_names(self) -> List[str]:
        with self._repos_lock:
            return sorted(self._repos)

    def delete_repo(self, name: str) -> bool:
        """Drop a tenant: its lineage document and journal are removed;
        its *private* objects stay in the shared CAS as orphans until the
        two-cycle maintenance GC (§16.3) confirms and reclaims them. Keys
        it shared with surviving tenants lose its contribution immediately:
        the closing finalize rebuilds every still-reachable count from the
        surviving union roots (orphans are untouched — rebuilds only write
        reachable keys). The ``default`` tenant is the service root and
        cannot be deleted."""
        if name == "default":
            return False
        with self._repos_lock:
            app = self._repos.pop(name, None)
        if app is None:
            return False
        with app._publish_lock:
            import shutil
            shutil.rmtree(app.root, ignore_errors=True)
        self.finalize()
        return True

    # -- service-wide derivations --------------------------------------------
    def all_roots(self) -> List[str]:
        """Union of every tenant's lineage roots (deterministic order)."""
        roots: set = set()
        with self._repos_lock:
            apps = list(self._repos.values())
        for app in apps:
            roots.update(app.roots())
        return sorted(roots)

    def finalize(self) -> int:
        with self._finalize_lock:
            counts = self.store.rebuild_refcounts(self.all_roots())
            # published keys graduate out of the import grace list: they are
            # reachability-protected now, and must not enjoy time-based
            # grace later should they become orphans (e.g. repo deletion)
            with self._imports_lock:
                for k in counts:
                    self._recent_imports.pop(k, None)
            return len(counts)

    def fsck(self) -> Dict[str, Any]:
        report = self.store.fsck(self.all_roots())
        report["repos"] = {}
        with self._repos_lock:
            apps = list(self._repos.items())
        for name, app in apps:
            _, etag = app.lineage()
            report["repos"][name] = {
                "etag": etag,
                "in_flight_transfers": list(app.journal.journal_list())}
        return report

    # -- import grace list (§16.3) -------------------------------------------
    def note_imports(self, keys: Iterable[str]) -> None:
        with self._imports_lock:
            cycle = self.gc_cycle
            now = time.monotonic()
            for k in keys:
                self._recent_imports[k] = (cycle, now)

    def recent_import_keys(self, grace: int = 2) -> set:
        """Keys imported within ``grace`` maintenance cycles *or* the last
        ``import_grace_s`` seconds — never GC candidates: they may belong
        to a transfer whose publish is still in flight. Cycle count alone
        is not a safe clock: an aggressive maintenance loop can burn
        through ``grace`` cycles in milliseconds while a large push is
        still streaming chunks, so wall time backstops it. Publishing
        graduates keys out of this list (see :meth:`finalize`), so the
        time window only ever delays reclaim of *abandoned* transfers.
        ``grace=0`` disables both protections (offline CLI use)."""
        with self._imports_lock:
            floor = self.gc_cycle - grace
            now = time.monotonic()
            stale = [k for k, (c, t) in self._recent_imports.items()
                     if c < floor and (grace <= 0
                                       or now - t >= self.import_grace_s)]
            for k in stale:
                del self._recent_imports[k]
            if grace <= 0:
                return set()
            return set(self._recent_imports)

    # -- maintenance (delegates to repro.hub.gc) ------------------------------
    def run_gc(self, confirm_cycles: int = 2,
               grace: int = 1) -> Dict[str, Any]:
        from repro_torch.hub import gc as hubgc
        return hubgc.run_gc(self, confirm_cycles=confirm_cycles, grace=grace)

    def compact(self) -> Dict[str, Any]:
        from repro_torch.hub import gc as hubgc
        return hubgc.run_compaction(self)

    def stats_json(self) -> Dict[str, Any]:
        out = self.default.stats_json()
        out["repos"] = self.repo_names()
        out["read_only"] = self.read_only
        out["gc_cycle"] = self.gc_cycle
        out["deferred_dead_bytes"] = self.store.cas.deferred_dead_bytes()
        return out
