"""Transport — the wire interface between a local repo and a remote peer.

Every method is one protocol round-trip and moves only bytes and keys, never
live *objects*: ``have`` answers the negotiation (DESIGN.md §8.2),
``read_objects``/``write_objects`` move CAS payloads in batches,
``fetch_lineage``/``publish_lineage`` exchange the graph metadata document,
and the ``journal_*`` trio persists transfer progress on the receiving side
so an interrupted push resumes instead of restarting (§8.4). Only *stored*
artifacts ever cross a transport — commit-time delta quantization means an
in-memory model and its stored form differ by eps, so bit-identity across
peers is always judged on store-loaded params, never ``node.artifact``.
The interface maps 1:1 onto HTTP endpoints (see the protocol table in
DESIGN.md §11.2); :class:`~repro_torch.remote.http.HttpTransport` is the network
implementation against a hub daemon (:mod:`repro_torch.hub`).

Concurrent writers are serialized by *optimistic lineage swap* (§11.3):
``fetch_lineage_versioned`` returns the document together with an etag
(:func:`lineage_etag`, a content hash of the canonical JSON), and
``publish_lineage(payload, expected=etag)`` replaces the document only if
it still carries that etag — otherwise :class:`PublishConflict` is raised
and the sync engine re-fetches, re-merges and retries. Object uploads need
no such guard: they are content-addressed and idempotent.

:class:`LocalTransport` is the filesystem implementation: the remote is just
another repo directory, opened through its own :class:`ArtifactStore` — which
is also what the hub daemon does on its side of an HTTP transport.

Copied from the reference package's ``repro/remote/transport.py``. The one
difference: :class:`LocalTransport` takes the ``backend`` of the store it
opens over the peer directory (``None``, the default, means the card;
``"ref"`` the host's plain versions), as every port ``ArtifactStore`` does.
"""

from __future__ import annotations

import json
import os
import threading
from abc import ABC, abstractmethod
from typing import Dict, Mapping, Optional, Sequence, Set, Tuple

from repro_torch.common.hashing import bytes_hash
from repro_torch.store.artifact_store import ArtifactStore

#: etag of an absent lineage document (fresh remote, nothing published yet)
ETAG_ABSENT = "absent"


def lineage_etag(payload: Optional[Dict]) -> str:
    """Version tag of a lineage document: content hash of canonical JSON.

    A pure function of the payload, so every implementation (local file,
    hub server, client cache) derives the same tag for the same document —
    the compare-and-swap in :meth:`Transport.publish_lineage` never depends
    on clocks or counters."""
    if payload is None:
        return ETAG_ABSENT
    return bytes_hash(json.dumps(payload, sort_keys=True).encode())[:32]


class PublishConflict(Exception):
    """Optimistic lineage swap failed: the document moved under us.

    Carries the remote's *current* etag; the caller re-fetches, re-merges
    against the new document and retries (HTTP surfaces this as 409)."""

    def __init__(self, current_etag: str,
                 message: str = "lineage moved under publish") -> None:
        super().__init__(f"{message} (current etag {current_etag})")
        self.current_etag = current_etag


class Transport(ABC):
    """Abstract peer repository endpoint."""

    url: str

    @abstractmethod
    def ensure_repo(self) -> None:
        """Create the remote repository layout if it does not exist yet."""

    @abstractmethod
    def fetch_lineage(self) -> Optional[Dict]:
        """The remote's lineage payload (``{"nodes": [...]}``), or None."""

    def fetch_lineage_versioned(self) -> Tuple[Optional[Dict], str]:
        """The lineage payload together with its etag (for optimistic swap).

        The default derives the etag locally; transports whose server
        computes it (HTTP ``ETag`` header) override to save the re-hash."""
        payload = self.fetch_lineage()
        return payload, lineage_etag(payload)

    @abstractmethod
    def publish_lineage(self, payload: Dict,
                        expected: Optional[str] = None) -> Optional[Dict]:
        """Atomically replace the remote lineage document (the commit point).

        With ``expected`` set, the replace is conditional: it succeeds only
        while the remote document's etag still equals ``expected`` (compare-
        and-swap), raising :class:`PublishConflict` otherwise. ``None``
        publishes unconditionally (last writer wins — single-writer use).

        Returns the receiver's acknowledgement when it has one — e.g. the
        hub's ``{"etag", "quarantined_rejected"}`` — or ``None``. Callers
        MUST honor ``quarantined_rejected``: those nodes were NOT accepted
        and may not be recorded as common in the merge base."""

    @abstractmethod
    def have(self, keys: Sequence[str]) -> Set[str]:
        """Negotiation: the subset of ``keys`` the remote already stores."""

    @abstractmethod
    def read_objects(self, keys: Sequence[str]) -> Dict[str, bytes]:
        """Fetch a batch of CAS objects by key."""

    def object_sizes(self, keys: Sequence[str]
                     ) -> Optional[Dict[str, int]]:
        """Stored byte size per key, for the keys the remote has.

        Optional capability (default: unknown → None). The pull planner
        uses it to route large objects — chunked tensors' ``c_`` payloads
        above all — through parallel ranged reads instead of one mget
        stream (DESIGN.md §12)."""
        return None

    @abstractmethod
    def write_objects(self, objects: Mapping[str, bytes]) -> None:
        """Store a batch of CAS objects (idempotent per key)."""

    @abstractmethod
    def finalize(self, roots: Sequence[str]) -> None:
        """Post-transfer: rebuild remote refcounts from the given lineage roots."""

    # -- transfer journal (receiver side) -----------------------------------
    @abstractmethod
    def journal_load(self, transfer_id: str) -> Optional[Dict]: ...

    @abstractmethod
    def journal_write(self, transfer_id: str, payload: Dict) -> None: ...

    @abstractmethod
    def journal_clear(self, transfer_id: str) -> None: ...

    @abstractmethod
    def journal_list(self) -> Sequence[str]:
        """Ids of in-flight (or crashed) transfers — fsck surfaces these."""


class LocalTransport(Transport):
    """Filesystem peer: ``url`` is another repo directory on this machine."""

    # Serializes the check-and-replace of publish_lineage per target path so
    # two same-process pushers (threads, tests) get real compare-and-swap
    # semantics; cross-process writers on one directory are out of scope for
    # LocalTransport (that is exactly what the hub daemon is for).
    _publish_locks: Dict[str, threading.Lock] = {}
    _publish_locks_guard = threading.Lock()

    def __init__(self, url: str, backend: Optional[str] = None) -> None:
        self.url = os.path.abspath(url)
        self.backend = backend
        self._store: Optional[ArtifactStore] = None

    # The store opens lazily so constructing a transport (e.g. ``remote add``)
    # has no filesystem side effects on the remote.
    def _open(self) -> ArtifactStore:
        if self._store is None:
            self._store = ArtifactStore(root=self.url, backend=self.backend)
        return self._store

    def _lineage_path(self) -> str:
        return os.path.join(self.url, "lineage.json")

    def _journal_dir(self) -> str:
        return os.path.join(self.url, "transfers")

    # -- Transport ----------------------------------------------------------
    def ensure_repo(self) -> None:
        os.makedirs(self.url, exist_ok=True)
        self._open()

    def fetch_lineage(self) -> Optional[Dict]:
        if not os.path.exists(self._lineage_path()):
            return None
        with open(self._lineage_path()) as f:
            return json.load(f)

    def _publish_lock(self) -> threading.Lock:
        with self._publish_locks_guard:
            return self._publish_locks.setdefault(self.url, threading.Lock())

    def publish_lineage(self, payload: Dict,
                        expected: Optional[str] = None) -> Optional[Dict]:
        with self._publish_lock():
            if expected is not None:
                current = lineage_etag(self.fetch_lineage())
                if current != expected:
                    raise PublishConflict(current)
            tmp = self._lineage_path() + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._lineage_path())
        # no server-side policy on a filesystem peer: accepted verbatim
        return {"etag": lineage_etag(payload), "quarantined_rejected": []}

    def have(self, keys: Sequence[str]) -> Set[str]:
        cas = self._open().cas
        return {k for k in keys if cas.has(k)}

    def read_objects(self, keys: Sequence[str]) -> Dict[str, bytes]:
        cas = self._open().cas
        return {k: cas.get_bytes(k) for k in keys}

    def object_sizes(self, keys: Sequence[str]) -> Dict[str, int]:
        cas = self._open().cas
        return {k: cas.size(k) for k in keys if cas.has(k)}

    def write_objects(self, objects: Mapping[str, bytes]) -> None:
        store = self._open()
        store.import_objects(objects)

    def finalize(self, roots: Sequence[str]) -> None:
        self._open().rebuild_refcounts(roots)

    # -- journal ------------------------------------------------------------
    def _journal_path(self, transfer_id: str) -> str:
        return os.path.join(self._journal_dir(), f"{transfer_id}.json")

    def journal_load(self, transfer_id: str) -> Optional[Dict]:
        path = self._journal_path(transfer_id)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def journal_write(self, transfer_id: str, payload: Dict) -> None:
        os.makedirs(self._journal_dir(), exist_ok=True)
        tmp = self._journal_path(transfer_id) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self._journal_path(transfer_id))

    def journal_clear(self, transfer_id: str) -> None:
        path = self._journal_path(transfer_id)
        if os.path.exists(path):
            os.remove(path)

    def journal_list(self) -> Sequence[str]:
        if not os.path.isdir(self._journal_dir()):
            return []
        return sorted(f[:-5] for f in os.listdir(self._journal_dir())
                      if f.endswith(".json"))
