"""Read replicas: horizontally fanned-out hub reads (DESIGN.md §16.5).

Two halves, both built on the existing transport stack rather than a new
protocol:

* :class:`ReplicaHub` — the server side. A read-only :class:`HubService`
  that periodically mirrors a primary hub over plain
  :class:`~repro_torch.remote.http.HttpTransport` calls: list the primary's
  repos, compare lineage etags, fetch the missing object closure in
  journalled-size batches, then *mirror-publish* the primary's document
  byte-faithfully (same etag — that is what the client's staleness check
  keys on). All client-facing mutations are rejected with 403; the only
  write path is the sync itself.

* :class:`ReplicaSetTransport` — the client side. Wraps a primary
  transport plus N replica transports behind the ordinary
  :class:`~repro_torch.remote.transport.Transport` interface so ``pull``/
  ``clone`` work unchanged: every write, journal and publish goes to the
  primary; ``have``/object reads fan out over the replicas round-robin.
  Before trusting a replica for a read batch, its lineage etag is compared
  against the last etag seen from the primary — a stale or unreachable
  replica falls back to the primary for that batch (counted, §14). Object
  payloads are content-addressed, so a *fresh-etag* replica can still miss
  an object only in pathological windows; those surface as KeyError and
  fall back the same way.

Sync is pull-based and periodic (or on-demand via ``POST
/api/replica/sync``): replicas are eventually consistent by design, and
the staleness fallback is what makes that safe for clients.

Copied from the reference package's ``repro/hub/replica.py``. The one
difference: :class:`ReplicaHub` takes the ``backend`` of its service's
store (``None`` means the card, ``"ref"`` the host's plain versions).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Mapping, Optional, Sequence, Set, Tuple

from repro_torch.common.faults import kill_point
from repro_torch.hub.app import HubService
from repro_torch.hub.routes import HubServer, start_in_thread
from repro_torch.obs import span
from repro_torch.remote.http import HttpTransport
from repro_torch.remote.negotiate import chunked
from repro_torch.remote.transport import Transport, lineage_etag
from repro_torch.store.manifest_walk import walk_manifests

#: objects fetched per mget batch during replica sync
SYNC_CHUNK_OBJECTS = 64


class ReplicaHub:
    """Mirrors a primary hub into a local read-only :class:`HubService`."""

    def __init__(self, root: str, primary_url: str,
                 token: Optional[str] = None,
                 backend: Optional[str] = None) -> None:
        self.primary_url = primary_url.rstrip("/")
        self.token = token
        self.service = HubService(root, token=token, read_only=True,
                                  allow_quarantined=True, backend=backend)
        self._sync_lock = threading.Lock()

    def _transport(self, repo: Optional[str] = None) -> HttpTransport:
        url = self.primary_url
        if repo and repo != "default":
            url = f"{url}/r/{repo}"
        return HttpTransport(url, token=self.token)

    def _sync_repo(self, name: str) -> Dict[str, Any]:
        """Mirror one repo; returns a per-repo report."""
        tr = self._transport(name)
        payload, etag = tr.fetch_lineage_versioned()
        app = self.service.repo(name)  # internal create; clients cannot
        _, local_etag = app.lineage()
        if etag == local_etag:
            return {"repo": name, "synced": False, "etag": etag}
        store = self.service.store
        roots = [n["artifact_ref"] for n in (payload or {}).get("nodes", [])
                 if n.get("artifact_ref")]

        def fetch(keys: Sequence[str]) -> Dict[str, bytes]:
            # serve manifests we already hold locally; fetch + import the
            # rest so the walk doubles as the manifest transfer
            out: Dict[str, bytes] = {}
            miss: List[str] = []
            for k in keys:
                if store.cas.has(k):
                    try:
                        out[k] = store.cas.get_bytes(k)
                        continue
                    except KeyError:
                        pass
                miss.append(k)
            if miss:
                got = tr.read_objects(miss)
                store.import_objects(got)
                out.update(got)
            return out

        missing_refs: List[str] = []
        closure = walk_manifests(fetch, roots, missing=missing_refs)
        want: List[str] = []
        seen: Set[str] = set()
        for info in closure.values():
            for k in info.objects:
                if k not in seen and not store.cas.has(k):
                    seen.add(k)
                    want.append(k)
        fetched_bytes = 0
        for batch in chunked(want, SYNC_CHUNK_OBJECTS):
            got = tr.read_objects(batch)
            fetched_bytes += store.import_objects(got)
        kill_point("replica.sync.pre_publish")
        if payload is not None:
            app.publish(payload, mirror=True)
        self.service.finalize()
        self.service.default.count(replica_syncs=1)
        return {"repo": name, "synced": True, "etag": etag,
                "objects_fetched": len(want) + len(closure),
                "bytes_fetched": fetched_bytes,
                "missing_refs": missing_refs}

    def sync_once(self) -> Dict[str, Any]:
        """One full mirror pass over every repo the primary lists."""
        with self._sync_lock, span("replica.sync", cat="hub"):
            repos = self._transport().list_repos()
            reports = [self._sync_repo(r["name"]) for r in repos]
            return {"repos": reports,
                    "synced": sum(1 for r in reports if r["synced"])}

    def sync_forever(self, interval_s: float = 5.0,
                     stop: Optional[threading.Event] = None) -> None:
        """Periodic sync loop (daemon-thread body for ``hub replica``)."""
        stop = stop or threading.Event()
        while not stop.is_set():
            try:
                self.sync_once()
            except Exception:  # noqa: BLE001 — a flaky primary must not kill the loop
                pass
            stop.wait(interval_s)


def serve_replica(root: str, primary_url: str, token: Optional[str] = None,
                  host: str = "127.0.0.1", port: int = 0,
                  sync_interval_s: float = 5.0,
                  backend: Optional[str] = None,
                  ) -> Tuple[ReplicaHub, HubServer, threading.Thread]:
    """Start a read-replica hub: HTTP server + periodic sync thread.

    Returns ``(replica, server, sync_thread)``; the server runs on its own
    daemon thread (``server.url``), the sync thread mirrors every
    ``sync_interval_s`` (0 disables the loop — call ``sync_once`` or POST
    ``/api/replica/sync`` to sync on demand)."""
    replica = ReplicaHub(root, primary_url, token=token, backend=backend)
    server, _ = start_in_thread(replica.service, host=host, port=port)
    server.replica = replica
    if sync_interval_s > 0:
        sync_thread = threading.Thread(
            target=replica.sync_forever, args=(sync_interval_s,),
            name="mgit-replica-sync", daemon=True)
        sync_thread.start()
    else:
        sync_thread = threading.Thread(target=lambda: None)
    return replica, server, sync_thread


class ReplicaSetTransport(Transport):
    """Primary + N read replicas behind the standard Transport interface.

    Reads rotate over the replicas; each batch first validates the chosen
    replica's lineage etag against the last etag observed from the primary
    (refreshed by ``fetch_lineage_versioned``, which every pull/clone calls
    before reading objects). Stale or failing replicas fall back to the
    primary — correctness never depends on replica freshness, only read
    *capacity* does."""

    def __init__(self, primary: Transport,
                 replicas: Sequence[Transport]) -> None:
        self.primary = primary
        self.replicas = list(replicas)
        self.url = primary.url
        self._rr = 0
        self._rr_lock = threading.Lock()
        self._primary_etag: Optional[str] = None
        self.fallbacks = 0
        self.replica_reads = 0

    # -- replica selection ----------------------------------------------------
    def _next_replica(self) -> Optional[Transport]:
        if not self.replicas:
            return None
        with self._rr_lock:
            tr = self.replicas[self._rr % len(self.replicas)]
            self._rr += 1
            return tr

    def _fresh_replica(self) -> Optional[Transport]:
        """A replica whose document matches the primary's last-seen etag."""
        tr = self._next_replica()
        if tr is None:
            return None
        try:
            if self._primary_etag is None:
                # no primary fetch yet by this transport: establish the baseline
                self._primary_etag = self.primary.fetch_lineage_versioned()[1]
            _, replica_etag = tr.fetch_lineage_versioned()
            if replica_etag == self._primary_etag:
                return tr
        except Exception:  # noqa: BLE001 — unreachable replica == stale replica
            pass
        self.fallbacks += 1
        return None

    def _read_via(self, op, *args, **kwargs):
        tr = self._fresh_replica()
        if tr is not None:
            try:
                result = op(tr)(*args, **kwargs)
                self.replica_reads += 1
                return result
            except Exception:  # noqa: BLE001 — any replica failure -> primary
                self.fallbacks += 1
        return op(self.primary)(*args, **kwargs)

    # -- reads (fanned) -------------------------------------------------------
    def have(self, keys: Sequence[str]) -> Set[str]:
        return self._read_via(lambda t: t.have, keys)

    def read_objects(self, keys: Sequence[str]) -> Dict[str, bytes]:
        return self._read_via(lambda t: t.read_objects, keys)

    def object_sizes(self, keys: Sequence[str]) -> Optional[Dict[str, int]]:
        return self._read_via(lambda t: t.object_sizes, keys)

    def read_object_range(self, key: str, start: int,
                          length: Optional[int] = None) -> bytes:
        return self._read_via(lambda t: t.read_object_range,
                              key, start, length)

    def read_object_parallel(self, key: str, size: int, **kwargs) -> bytes:
        return self._read_via(lambda t: t.read_object_parallel,
                              key, size, **kwargs)

    # -- lineage (primary-authoritative) --------------------------------------
    def fetch_lineage(self) -> Optional[Dict]:
        return self.fetch_lineage_versioned()[0]

    def fetch_lineage_versioned(self) -> Tuple[Optional[Dict], str]:
        payload, etag = self.primary.fetch_lineage_versioned()
        self._primary_etag = etag
        return payload, etag

    # -- writes (primary only) ------------------------------------------------
    def ensure_repo(self) -> None:
        self.primary.ensure_repo()

    def publish_lineage(self, payload: Dict,
                        expected: Optional[str] = None) -> Optional[Dict]:
        result = self.primary.publish_lineage(payload, expected=expected)
        self._primary_etag = lineage_etag(payload)
        return result

    def write_objects(self, objects: Mapping[str, bytes]) -> None:
        self.primary.write_objects(objects)

    def finalize(self, roots: Sequence[str]) -> None:
        self.primary.finalize(roots)

    # -- journal (primary only) -----------------------------------------------
    def journal_load(self, transfer_id: str) -> Optional[Dict]:
        return self.primary.journal_load(transfer_id)

    def journal_write(self, transfer_id: str, payload: Dict) -> None:
        self.primary.journal_write(transfer_id, payload)

    def journal_clear(self, transfer_id: str) -> None:
        self.primary.journal_clear(transfer_id)

    def journal_list(self) -> Sequence[str]:
        return self.primary.journal_list()
