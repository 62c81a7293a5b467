"""HttpTransport — the network implementation of :class:`Transport`.

Speaks the hub daemon's REST surface (:mod:`repro_torch.hub`; protocol table in
DESIGN.md §11.2) over stdlib ``http.client`` — no third-party deps. Every
:class:`~repro_torch.remote.transport.Transport` method maps onto one endpoint,
so ``push``/``pull``/``clone`` and the §8.4 resumable journal run unchanged
over the network: the push journal lives server-side (the receiver), object
uploads from the journalled thread pool land as parallel ``POST`` requests,
and an interrupted transfer resumes through the same closure-keyed journal
id on the next attempt.

Wire format for multi-object moves is the *pack record stream* — the same
self-describing ``[keylen u16][key][datalen u32][data]`` framing the CAS
packfiles use (:data:`WIRE_REC_HEAD` == ``cas._REC_HEAD``), streamed with an
exact ``Content-Length`` so neither side ever buffers more than one object.
Tensor/delta payloads are already LZMA/npy bytes and do not recompress;
JSON bodies and responses ride gzip content-encoding above a size floor.

Reliability:

* **retry-with-backoff** — connection errors and 5xx responses retry with
  exponential backoff; every endpoint is idempotent (content-addressed
  writes, conditional publish), so replaying a request that half-completed
  is always safe;
* **optimistic lineage swap** — ``publish_lineage(payload, expected=etag)``
  sends ``If-Match``; the hub answers ``409 Conflict`` when the document
  moved, surfaced as :class:`PublishConflict` for the sync engine's
  re-fetch/re-merge/retry loop (§11.3).

Only *stored* artifact bytes cross this transport (manifests, tensors,
delta blobs by CAS key) — never in-memory models, whose params differ from
their stored form by commit-time quantization eps.

Copied from the reference package's ``repro/remote/http.py``; only the imports
differ.
"""

from __future__ import annotations

import gzip
import http.client
import json
import os
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, Iterator, List, Mapping, Optional
from typing import Sequence, Set, Tuple
from urllib.parse import urlsplit

from repro_torch.obs import REGISTRY, propagate, span
from repro_torch.remote.transport import (ETAG_ABSENT, PublishConflict, Transport,
                                    lineage_etag)

#: record framing for multi-object streams: (keylen u16, datalen u32) —
#: identical to the CAS packfile record head, so a hub could in principle
#: splice a received stream straight into a pack
WIRE_REC_HEAD = struct.Struct("<HI")

#: JSON bodies/responses below this size skip gzip (header overhead wins)
GZIP_FLOOR = 256

#: env var consulted for a bearer token when none is passed explicitly
TOKEN_ENV = "MGIT_HUB_TOKEN"


class HubUnavailable(ConnectionError):
    """The hub could not be reached after all retries."""


def endpoint_family(path: str) -> str:
    """Bounded label for per-endpoint-family retry accounting."""
    p = path.split("?", 1)[0]
    for prefix, family in (("/api/objects", "objects"),
                           ("/api/journal", "journal"),
                           ("/api/lineage", "lineage"),
                           ("/api/have", "negotiate"),
                           ("/api/finalize", "finalize"),
                           ("/api/ping", "ping")):
        if p.startswith(prefix):
            return family
    return "other"


def encode_records(objects: Mapping[str, bytes]) -> bytes:
    """Serialize a key->bytes mapping as one pack record stream."""
    parts: List[bytes] = []
    for key, data in objects.items():
        kb = key.encode()
        parts.append(WIRE_REC_HEAD.pack(len(kb), len(data)))
        parts.append(kb)
        parts.append(data)
    return b"".join(parts)


def iter_records(buf: bytes) -> Iterator[Tuple[str, bytes]]:
    """Parse a pack record stream; a torn tail raises (wire corruption —
    unlike pack-file tail scans there is no crash to forgive here)."""
    pos, end = 0, len(buf)
    while pos < end:
        if pos + WIRE_REC_HEAD.size > end:
            raise ValueError("torn record head in object stream")
        klen, dlen = WIRE_REC_HEAD.unpack_from(buf, pos)
        pos += WIRE_REC_HEAD.size
        if pos + klen + dlen > end:
            raise ValueError("torn record body in object stream")
        key = buf[pos:pos + klen].decode()
        pos += klen
        yield key, buf[pos:pos + dlen]
        pos += dlen


class HttpTransport(Transport):
    """Peer repository served by an MGit hub daemon at ``http://host:port``.

    ``token`` (or ``$MGIT_HUB_TOKEN``) is sent as a bearer token; the hub's
    auth stub rejects mismatches with 401 (raised as ``PermissionError``).
    """

    def __init__(self, url: str, token: Optional[str] = None,
                 timeout: float = 30.0, retries: int = 4,
                 backoff: float = 0.25) -> None:
        self.url = url.rstrip("/")
        parts = urlsplit(self.url)
        if parts.scheme not in ("http", "https"):
            raise ValueError(f"not an http(s) url: {url!r}")
        self._host = parts.hostname or "127.0.0.1"
        self._port = parts.port or (443 if parts.scheme == "https" else 80)
        self._https = parts.scheme == "https"
        self._prefix = parts.path.rstrip("/")
        self.token = token if token is not None else os.environ.get(TOKEN_ENV)
        self.timeout = timeout
        self.retries = retries
        self.backoff = backoff
        # retry observability: per-endpoint-family counts of
        # retried attempts, seconds slept in backoff, and requests that
        # exhausted every retry. Instance-local (surfaced per-sync through
        # SyncReport via retry_stats()); mirrored into process-wide
        # mgit_http_retry* registry counters for /api/metrics.
        self._retry_lock = threading.Lock()
        self._retries: Dict[str, int] = {}
        self._backoff_s: Dict[str, float] = {}
        self._terminal: Dict[str, int] = {}

    def _record_retry(self, family: str, sleep_s: float) -> None:
        with self._retry_lock:
            self._retries[family] = self._retries.get(family, 0) + 1
            self._backoff_s[family] = (self._backoff_s.get(family, 0.0)
                                       + sleep_s)
        REGISTRY.counter("mgit_http_retries",
                         help="retried hub requests", family=family).inc()
        REGISTRY.counter("mgit_http_backoff_seconds",
                         help="seconds slept in retry backoff",
                         family=family).inc(sleep_s)

    def _record_terminal(self, family: str) -> None:
        with self._retry_lock:
            self._terminal[family] = self._terminal.get(family, 0) + 1
        REGISTRY.counter("mgit_http_terminal_failures",
                         help="hub requests that exhausted all retries",
                         family=family).inc()

    def retry_stats(self) -> Dict[str, Any]:
        """Per-family retry/backoff/terminal-failure counts so far."""
        with self._retry_lock:
            return {"retries": dict(self._retries),
                    "backoff_s": {k: round(v, 3)
                                  for k, v in self._backoff_s.items()},
                    "terminal_failures": dict(self._terminal)}

    # -- one HTTP round-trip with retry/backoff -----------------------------
    def _connect(self) -> http.client.HTTPConnection:
        cls = (http.client.HTTPSConnection if self._https
               else http.client.HTTPConnection)
        return cls(self._host, self._port, timeout=self.timeout)

    def _request(self, method: str, path: str, body: Optional[bytes] = None,
                 headers: Optional[Dict[str, str]] = None,
                 json_body: Optional[Dict] = None,
                 ) -> Tuple[int, Dict[str, str], bytes]:
        """Returns ``(status, lowered-headers, decoded body)``.

        Retries (connection refused/reset, timeouts, 5xx) with exponential
        backoff; 4xx statuses return to the caller for semantic mapping.
        A fresh connection per request keeps the transport trivially
        thread-safe for the journalled transfer's parallel chunk workers."""
        hdrs = {"Accept-Encoding": "gzip", "Connection": "close"}
        if self.token:
            hdrs["Authorization"] = f"Bearer {self.token}"
        if json_body is not None:
            body = json.dumps(json_body).encode()
            hdrs["Content-Type"] = "application/json"
            if len(body) > GZIP_FLOOR:
                body = gzip.compress(body, 5)
                hdrs["Content-Encoding"] = "gzip"
        if headers:
            hdrs.update(headers)
        family = endpoint_family(path)
        last_exc: Optional[BaseException] = None
        for attempt in range(self.retries + 1):
            try:
                conn = self._connect()
                try:
                    conn.request(method, self._prefix + path, body=body,
                                 headers=hdrs)
                    resp = conn.getresponse()
                    data = resp.read()
                    status = resp.status
                    resp_headers = {k.lower(): v
                                    for k, v in resp.getheaders()}
                finally:
                    conn.close()
                if resp_headers.get("content-encoding") == "gzip":
                    data = gzip.decompress(data)
                if status >= 500:
                    raise HubUnavailable(
                        f"{method} {path} -> {status}: {data[:200]!r}")
                return status, resp_headers, data
            except (OSError, http.client.HTTPException) as exc:
                last_exc = exc
                if attempt < self.retries:
                    sleep_s = self.backoff * (2 ** attempt)
                    self._record_retry(family, sleep_s)
                    time.sleep(sleep_s)
        self._record_terminal(family)
        raise HubUnavailable(
            f"hub at {self.url} unreachable after "
            f"{self.retries + 1} attempts: {last_exc}") from last_exc

    def _json(self, data: bytes) -> Dict:
        return json.loads(data) if data else {}

    @staticmethod
    def _check_auth(status: int, path: str) -> None:
        if status == 401:
            raise PermissionError(f"hub rejected token for {path}")

    # -- Transport ----------------------------------------------------------
    def ensure_repo(self) -> None:
        """The hub owns its repo directory; just verify it is serving."""
        status, _, data = self._request("GET", "/api/ping")
        self._check_auth(status, "/api/ping")
        if status != 200 or not self._json(data).get("ok"):
            raise HubUnavailable(f"{self.url} is not an mgit hub "
                                 f"(status {status})")

    def fetch_lineage(self) -> Optional[Dict]:
        return self.fetch_lineage_versioned()[0]

    def fetch_lineage_versioned(self) -> Tuple[Optional[Dict], str]:
        status, headers, data = self._request("GET", "/api/lineage")
        self._check_auth(status, "/api/lineage")
        if status == 404:
            return None, headers.get("etag", ETAG_ABSENT)
        payload = self._json(data)
        return payload, headers.get("etag") or lineage_etag(payload)

    def publish_lineage(self, payload: Dict,
                        expected: Optional[str] = None) -> Optional[Dict]:
        headers = {"If-Match": expected} if expected is not None else {}
        status, _, data = self._request("PUT", "/api/lineage",
                                        json_body=payload, headers=headers)
        self._check_auth(status, "/api/lineage")
        if status == 409:
            raise PublishConflict(self._json(data).get("etag", "?"))
        if status not in (200, 204):
            raise HubUnavailable(f"publish failed: {status} {data[:200]!r}")
        # the hub's acknowledgement: its etag of what it ACTUALLY published
        # plus any nodes its quarantine policy rejected (§11.3)
        return self._json(data)

    def have(self, keys: Sequence[str]) -> Set[str]:
        status, _, data = self._request("POST", "/api/have",
                                        json_body={"keys": list(keys)})
        self._check_auth(status, "/api/have")
        return set(self._json(data).get("have", []))

    def read_objects(self, keys: Sequence[str]) -> Dict[str, bytes]:
        if not keys:
            return {}
        status, _, data = self._request("POST", "/api/objects/mget",
                                        json_body={"keys": list(keys)})
        self._check_auth(status, "/api/objects/mget")
        if status == 404:
            missing = self._json(data).get("missing", list(keys))
            raise KeyError(f"hub is missing objects: {missing[:5]}")
        out = dict(iter_records(data))
        if len(out) != len(set(keys)):
            raise KeyError(f"hub returned {len(out)}/{len(set(keys))} objects")
        return out

    def object_sizes(self, keys: Sequence[str]) -> Dict[str, int]:
        if not keys:
            return {}
        status, _, data = self._request("POST", "/api/objects/sizes",
                                        json_body={"keys": list(keys)})
        self._check_auth(status, "/api/objects/sizes")
        if status == 404:
            # pre-chunk-layer hub without the endpoint: sizes unknown —
            # the pull planner falls back to single-stream mget
            return {}
        return {k: int(v)
                for k, v in self._json(data).get("sizes", {}).items()}

    def read_object_parallel(self, key: str, size: int,
                             part_bytes: int = 1 * 2 ** 20,
                             workers: int = 4) -> bytes:
        """Fetch one large object as concurrent ranged GETs, in-order join.

        Each part is an independent ``Range`` request on its own connection
        (``_request`` opens a fresh one per call, so the fan-out is safe);
        on loopback this mostly overlaps server-side pread with client-side
        socket drain, over real links it fills the bandwidth-delay product
        the way aria2-style segmented downloads do. ``size`` must be the
        object's stored length (from :meth:`object_sizes`) — the reassembled
        buffer is length-checked against it, and content addressing verifies
        the payload end-to-end when it lands in the local CAS."""
        if size <= part_bytes:
            return self.read_object_range(key, 0, size)
        spans = [(off, min(part_bytes, size - off))
                 for off in range(0, size, part_bytes)]
        with span("http.ranged_pull", cat="remote", key=key,
                  parts=len(spans)):
            one = propagate(
                lambda s: self.read_object_range(key, s[0], s[1]))
            with ThreadPoolExecutor(max_workers=max(1, workers),
                                    thread_name_prefix="range-get") as pool:
                parts = list(pool.map(one, spans))
        data = b"".join(parts)
        if len(data) != size:
            raise HubUnavailable(
                f"ranged fetch of {key!r} reassembled {len(data)} bytes, "
                f"expected {size}")
        return data

    def read_object_range(self, key: str, start: int,
                          length: Optional[int] = None) -> bytes:
        """Ranged single-object read (zero-copy server-side off the mmap
        pool) — the building block for byte-level resume of huge tensors."""
        end = "" if length is None else str(start + length - 1)
        status, _, data = self._request(
            "GET", f"/api/objects/{key}",
            headers={"Range": f"bytes={start}-{end}"})
        self._check_auth(status, "/api/objects")
        if status == 404:
            raise KeyError(f"no object {key!r} on hub")
        if status == 416:
            return b""  # resume positioned at EOF: nothing left to fetch
        if status not in (200, 206):
            raise HubUnavailable(f"ranged read failed: {status}")
        return data

    def write_objects(self, objects: Mapping[str, bytes]) -> None:
        if not objects:
            return
        body = encode_records(objects)
        status, _, data = self._request(
            "POST", "/api/objects", body=body,
            headers={"Content-Type": "application/x-mgit-pack"})
        self._check_auth(status, "/api/objects")
        if status != 200:
            raise HubUnavailable(f"object upload failed: {status} "
                                 f"{data[:200]!r}")

    def finalize(self, roots: Sequence[str]) -> None:
        # The hub derives the authoritative root set from its *current*
        # lineage document (§11.3): with concurrent pushers, a client's view
        # of the roots may already be stale by the time its finalize lands.
        status, _, data = self._request("POST", "/api/finalize",
                                        json_body={"roots": list(roots)})
        self._check_auth(status, "/api/finalize")
        if status != 200:
            raise HubUnavailable(f"finalize failed: {status} {data[:200]!r}")

    # -- journal (server-side: the hub is the receiver of a push) -----------
    def journal_load(self, transfer_id: str) -> Optional[Dict]:
        status, _, data = self._request("GET", f"/api/journal/{transfer_id}")
        self._check_auth(status, "/api/journal")
        return None if status == 404 else self._json(data)

    def journal_write(self, transfer_id: str, payload: Dict) -> None:
        status, _, _ = self._request("PUT", f"/api/journal/{transfer_id}",
                                     json_body=payload)
        self._check_auth(status, "/api/journal")

    def journal_clear(self, transfer_id: str) -> None:
        status, _, _ = self._request("DELETE",
                                     f"/api/journal/{transfer_id}")
        self._check_auth(status, "/api/journal")

    def journal_list(self) -> Sequence[str]:
        status, _, data = self._request("GET", "/api/journal")
        self._check_auth(status, "/api/journal")
        return self._json(data).get("transfers", [])

    # -- extras --------------------------------------------------------------
    def server_stats(self) -> Dict:
        """The hub's live request/byte counters (``mgit hub stats``)."""
        status, _, data = self._request("GET", "/api/stats")
        self._check_auth(status, "/api/stats")
        return self._json(data)

    def list_repos(self) -> List[Dict]:
        """Tenants of a multi-tenant hub: ``[{"name", "etag"}, ...]``.

        A single-repo hub answers with its sole ``default`` entry, so
        replica sync (§16.5) iterates the same way against either."""
        status, _, data = self._request("GET", "/api/repos")
        self._check_auth(status, "/api/repos")
        if status != 200:
            raise HubUnavailable(f"repo list failed: {status}")
        return self._json(data).get("repos", [])

    def run_gc(self, confirm_cycles: int = 2, grace: int = 1) -> Dict:
        """Trigger one maintenance GC cycle on a live hub (§16.3)."""
        status, _, data = self._request(
            "POST", "/api/gc", json_body={"confirm_cycles": confirm_cycles,
                                          "grace": grace})
        self._check_auth(status, "/api/gc")
        if status != 200:
            raise HubUnavailable(f"gc failed: {status} {data[:200]!r}")
        return self._json(data)

    def run_compact(self) -> Dict:
        """Trigger aggressive pack compaction on a live hub (§16.3)."""
        status, _, data = self._request("POST", "/api/compact", json_body={})
        self._check_auth(status, "/api/compact")
        if status != 200:
            raise HubUnavailable(f"compact failed: {status} {data[:200]!r}")
        return self._json(data)

    def replica_sync(self) -> Dict:
        """Trigger an on-demand mirror pass on a replica hub (§16.5)."""
        status, _, data = self._request("POST", "/api/replica/sync",
                                        json_body={})
        self._check_auth(status, "/api/replica/sync")
        if status != 200:
            raise HubUnavailable(f"replica sync failed: {status}")
        return self._json(data)
