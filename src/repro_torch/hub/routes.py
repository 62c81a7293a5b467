"""HTTP surface of the hub daemon (DESIGN.md §11.2, §16).

A thin, dependency-free codec over :class:`~repro_torch.hub.app.HubApp` /
:class:`~repro_torch.hub.app.HubService`, built on a bounded worker-pool
subclass of stdlib ``http.server.ThreadingHTTPServer``: up to
``max_workers`` connections are serviced concurrently, ``queue_depth``
more may wait, and anything beyond is shed with ``503 Retry-After``
(§16.4) — saturation is explicit backpressure, never unbounded threads.

Every endpoint also exists repo-scoped as ``/r/<repo>/api/...`` (the
remote-URL form — point a client at ``http://hub/r/<repo>``) or
``/api/r/<repo>/...``; unscoped paths serve the ``default`` repo.

Endpoints (all JSON unless noted; see the §11.2/§16.1 protocol tables):

    GET    /api/ping                 liveness (unauthenticated)
    GET    /api/lineage              document + ``ETag`` header; 404 if none
    PUT    /api/lineage              conditional on ``If-Match`` -> 200/409
    POST   /api/have                 {"keys": [...]} -> {"have": [...]}
    GET    /api/objects/<key>        raw object; honors ``Range`` (206)
    POST   /api/objects/mget         {"keys": [...]} -> pack record stream
    POST   /api/objects/sizes        {"keys": [...]} -> {"sizes", "missing"}
    POST   /api/objects              pack record stream -> {"imported", ...}
    POST   /api/finalize             refcount rebuild (union roots, §16.1)
    GET    /api/journal[/<tid>]      transfer journal list / entry
    PUT    /api/journal/<tid>        persist a journal entry
    DELETE /api/journal/<tid>        retire a journal entry
    GET    /api/stats                live counters + per-route p50/p99
    GET    /api/metrics              Prometheus text exposition (DESIGN §14)
    GET    /api/fsck                 integrity report (service-wide, §16.1)
    GET    /api/repos                tenant list with lineage etags
    DELETE /r/<repo>/api/repo        drop a tenant (objects become orphans)
    POST   /api/gc                   one maintenance GC cycle (§16.3)
    POST   /api/compact              aggressive pack compaction
    POST   /api/replica/sync         pull-from-primary sync (replicas only)

Object payloads stream zero-copy: single-object GETs and mget streams write
``memoryview`` slices of the CAS's pooled mmaps straight to the socket,
with an exact ``Content-Length`` precomputed from O(1) size lookups — the
hub never holds a full transfer in memory. JSON bodies accept and JSON
responses offer gzip content-encoding above a small floor; object bytes are
LZMA/npy payloads already and are never recompressed.

Copied from the reference package's ``repro/hub/routes.py``; only the imports
differ.
"""

from __future__ import annotations

import concurrent.futures as cf
import gzip
import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple, Union
from urllib.parse import unquote, urlsplit

from repro_torch.common.faults import kill_point
from repro_torch.hub.app import HubApp, HubService, ReadOnlyRepo
from repro_torch.obs import span
from repro_torch.remote.http import GZIP_FLOOR, WIRE_REC_HEAD, iter_records
from repro_torch.remote.transport import ETAG_ABSENT, PublishConflict

_RANGE_RE = re.compile(r"bytes=(\d+)-(\d*)$")

# Fixed-path routes the latency histogram may label with — dynamic path
# tails collapse to :key/:tid and anything else to "other", so a scanner
# walking random URLs cannot grow unbounded label cardinality.
_FIXED_ROUTES = frozenset({
    "/api/ping", "/api/lineage", "/api/have", "/api/objects/mget",
    "/api/objects/sizes", "/api/objects", "/api/finalize", "/api/journal",
    "/api/stats", "/api/metrics", "/api/fsck", "/api/repos", "/api/repo",
    "/api/gc", "/api/compact", "/api/replica/sync"})

# (method, route_family) pairs that change hub state — rejected with 403 on
# a read-only replica, and the set the saturation counters key off.
_MUTATING = frozenset({
    ("PUT", "/api/lineage"), ("POST", "/api/objects"),
    ("POST", "/api/finalize"), ("PUT", "/api/journal/:tid"),
    ("DELETE", "/api/journal/:tid"), ("DELETE", "/api/repo"),
    ("POST", "/api/gc"), ("POST", "/api/compact")})


def split_repo(path: str) -> Tuple[str, Optional[str]]:
    """``(api_path, repo_name)`` for a possibly repo-scoped path (§16.1).

    Two equivalent spellings route to the same tenant:

    * ``/r/<repo>/api/...`` — the remote-URL form: a client configured
      with ``http://hub/r/<repo>`` needs zero transport changes, its URL
      prefix lands every request here;
    * ``/api/r/<repo>/...`` — the API-first form from the protocol table.

    Unscoped paths return ``(path, None)`` and route to the default repo."""
    if path.startswith("/api/r/"):
        name, _, tail = path[len("/api/r/"):].partition("/")
        return ("/api/" + tail if tail else "/api"), name
    if path.startswith("/r/"):
        name, _, tail = path[len("/r/"):].partition("/")
        return ("/" + tail if tail else "/"), name
    return path, None


def route_family(path: str) -> str:
    """Collapse a request path to its bounded-cardinality route label.

    Repo-scoped paths collapse to the same family as their unscoped form —
    the repo name is unbounded and must not become a label."""
    path, _ = split_repo(path)
    if (path.startswith("/api/objects/")
            and path not in ("/api/objects/mget", "/api/objects/sizes")):
        return "/api/objects/:key"
    if path.startswith("/api/journal/"):
        return "/api/journal/:tid"
    return path if path in _FIXED_ROUTES else "other"

# CAS keys and journal ids are hash-derived tokens; anything else in the
# path tail is hostile (os.path.join would resolve '../' segments OUTSIDE
# the served repository — remote file read/write). Dot-only names are
# excluded too ('.'/'..' are directories even without a separator).
_SAFE_ID_RE = re.compile(r"^[A-Za-z0-9._-]+$")


def _safe_id(s: str) -> bool:
    return bool(_SAFE_ID_RE.match(s)) and set(s) != {"."}


class _RangeNotSatisfiable(Exception):
    """Range start at/after EOF — HTTP 416, not a malformed request."""


class HubRequestHandler(BaseHTTPRequestHandler):
    server_version = "mgit-hub/1.0"
    protocol_version = "HTTP/1.1"

    # -- plumbing ------------------------------------------------------------
    @property
    def app(self) -> HubApp:
        # set per-request by _route once the repo scope is resolved; error
        # paths that fire earlier (auth, bad repo name) count against the
        # default repo's stats
        resolved = getattr(self, "_app", None)
        return resolved or self.server.app  # type: ignore[attr-defined]

    def log_message(self, format: str, *args: Any) -> None:
        pass  # request metrics live in app.stats, not stderr

    def _gzip_ok(self) -> bool:
        return "gzip" in (self.headers.get("Accept-Encoding") or "")

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        data = self.rfile.read(length) if length else b""
        self.app.count(bytes_in=len(data))
        if self.headers.get("Content-Encoding") == "gzip":
            data = gzip.decompress(data)
        return data

    def _read_json(self) -> Dict:
        body = self._read_body()
        return json.loads(body) if body else {}

    def _send_json(self, obj: Any, status: int = 200,
                   headers: Optional[Dict[str, str]] = None) -> None:
        body = json.dumps(obj).encode()
        hdrs = dict(headers or {})
        if self._gzip_ok() and len(body) > GZIP_FLOOR:
            body = gzip.compress(body, 5)
            hdrs["Content-Encoding"] = "gzip"
        if status >= 400:
            # error paths may not have drained the request body (401 fires
            # before _read_body); leftover bytes on a keep-alive socket
            # would be parsed as the next request line — close instead
            self.close_connection = True
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        for k, v in hdrs.items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        self.app.count(bytes_out=len(body))

    # -- auth ----------------------------------------------------------------
    def _authorized(self, path: str) -> bool:
        if path == "/api/ping":
            return True  # health probes run without credentials
        if self.app.auth.check(self.headers.get("Authorization")):
            return True
        self.app.count(auth_failures=1)
        self._send_json({"error": "unauthorized"}, status=401,
                        headers={"WWW-Authenticate": "Bearer"})
        return False

    # -- dispatch ------------------------------------------------------------
    def _write_body(self, view) -> None:
        """Body write with an optional per-connection bandwidth cap.

        ``HubServer.throttle_bps`` (benchmarks/tests only) emulates the
        per-TCP-stream throughput limit of a real network path — the
        property that makes parallel ranged connections aggregate
        bandwidth. Zero (the default) writes straight through.
        """
        bps = self.server.throttle_bps  # type: ignore[attr-defined]
        if not bps:
            self.wfile.write(view)
            return
        step = 256 * 1024
        mv = memoryview(view)
        for i in range(0, len(mv), step):
            piece = mv[i:i + step]
            self.wfile.write(piece)
            time.sleep(len(piece) / bps)

    def _route(self, method: str) -> None:
        raw = unquote(urlsplit(self.path).path).rstrip("/") or "/"
        path, repo = split_repo(raw)
        self._app = None  # default repo until the scope resolves
        self.app.count(requests=1)
        if self.server.delay_s:  # type: ignore[attr-defined]
            # simulated per-request RTT (benchmarks/tests only): loopback
            # has none, so this is how WAN behavior is exercised locally
            time.sleep(self.server.delay_s)  # type: ignore[attr-defined]
        if not self._authorized(path):
            return
        if repo is not None:
            # resolution AFTER auth: tenant dirs are only ever created by
            # authorized requests, never by an unauthenticated scanner
            service = self.server.service  # type: ignore[attr-defined]
            if service is None:
                self._send_json({"error": "not a multi-tenant hub"},
                                status=404)
                return
            if not _safe_id(repo):
                self._send_json({"error": "bad repo name"}, status=404)
                return
            app = service.repo(repo, create=not service.read_only)
            if app is None:
                self._send_json({"error": f"no repo {repo!r}"}, status=404)
                return
            self._app = app
        route = route_family(path)
        if self.app.read_only and (method, route) in _MUTATING:
            self._send_json({"error": "read-only replica"}, status=403)
            return
        t0 = time.perf_counter()
        try:
            with span("hub.request", cat="hub", method=method, route=route):
                handler = self._resolve(method, path)
                if handler is None:
                    self._send_json({"error": f"no route {method} {path}"},
                                    status=404)
                    return
                handler()
        except PublishConflict as exc:
            self._send_json({"error": "lineage moved",
                             "etag": exc.current_etag}, status=409)
        except ReadOnlyRepo as exc:
            self._send_json({"error": str(exc)}, status=403)
        except (ValueError, KeyError, json.JSONDecodeError) as exc:
            self._send_json({"error": str(exc)}, status=400)
        except ConnectionError:
            raise  # client went away mid-response; nothing to send
        except Exception as exc:  # noqa: BLE001 — daemon must not die
            self.app.count(errors_500=1)
            self._send_json({"error": f"internal: {exc}"}, status=500)
        finally:
            self.app.observe_request(method, route,
                                     time.perf_counter() - t0)

    def _resolve(self, method: str, path: str):
        if (path.startswith("/api/objects/")
                and path not in ("/api/objects/mget", "/api/objects/sizes")):
            key = path[len("/api/objects/"):]
            if not _safe_id(key):
                return None  # 404s — never reaches a filesystem join
            if method == "GET":
                return lambda: self._get_object(key)
            return None
        if path.startswith("/api/journal/"):
            tid = path[len("/api/journal/"):]
            if not _safe_id(tid):
                return None
            return {"GET": lambda: self._journal_get(tid),
                    "PUT": lambda: self._journal_put(tid),
                    "DELETE": lambda: self._journal_delete(tid),
                    }.get(method)
        table = {
            ("GET", "/api/ping"): self._ping,
            ("GET", "/api/lineage"): self._get_lineage,
            ("PUT", "/api/lineage"): self._put_lineage,
            ("POST", "/api/have"): self._have,
            ("POST", "/api/objects/mget"): self._mget,
            ("POST", "/api/objects/sizes"): self._sizes,
            ("POST", "/api/objects"): self._put_objects,
            ("POST", "/api/finalize"): self._finalize,
            ("GET", "/api/journal"): self._journal_list,
            ("GET", "/api/stats"): self._stats,
            ("GET", "/api/metrics"): self._metrics,
            ("GET", "/api/fsck"): self._fsck,
            ("GET", "/api/repos"): self._list_repos,
            ("DELETE", "/api/repo"): self._delete_repo,
            ("POST", "/api/gc"): self._run_gc,
            ("POST", "/api/compact"): self._run_compact,
            ("POST", "/api/replica/sync"): self._replica_sync,
        }
        return table.get((method, path))

    def do_GET(self) -> None:
        self._route("GET")

    def do_POST(self) -> None:
        self._route("POST")

    def do_PUT(self) -> None:
        self._route("PUT")

    def do_DELETE(self) -> None:
        self._route("DELETE")

    # -- routes --------------------------------------------------------------
    def _ping(self) -> None:
        self._send_json({"ok": True, "service": "mgit-hub",
                         "auth": self.app.auth.enabled})

    def _get_lineage(self) -> None:
        payload, etag = self.app.lineage()
        if payload is None:
            self._send_json({"error": "no lineage published"}, status=404,
                            headers={"ETag": etag})
            return
        self._send_json(payload, headers={"ETag": etag})

    def _put_lineage(self) -> None:
        expected = self.headers.get("If-Match")
        payload = self._read_json()
        result = self.app.publish(payload, expected=expected)
        self._send_json(result, headers={"ETag": result["etag"]})

    def _have(self) -> None:
        keys = self._read_json().get("keys", [])
        self._send_json({"have": self.app.have(keys)})

    def _parse_range(self, size: int) -> Optional[Tuple[int, int]]:
        """``(start, length)`` from a single-range header, or None."""
        header = self.headers.get("Range")
        if not header:
            return None
        m = _RANGE_RE.match(header.strip())
        if not m:
            raise ValueError(f"unsupported Range {header!r}")
        start = int(m.group(1))
        end = int(m.group(2)) if m.group(2) else size - 1
        if start >= size or end < start:
            # 416, not 400: a resume positioned exactly at EOF is a healthy
            # "nothing left to fetch", not a malformed request
            raise _RangeNotSatisfiable(size)
        return start, min(end, size - 1) - start + 1

    def _get_object(self, key: str) -> None:
        # reader lease (§16.2): a concurrent gc defers physical reclaim
        # until this response is fully written, so the view below can never
        # dangle even if the key dies mid-transfer
        with self.app.store.cas.pin():
            try:
                view = self.app.store.cas.get_view(key)
            except KeyError:
                self._send_json({"error": f"no object {key!r}"}, status=404)
                return
            size = len(view)
            try:
                rng = self._parse_range(size)
            except _RangeNotSatisfiable:
                self._send_json({"error": "range not satisfiable",
                                 "size": size}, status=416,
                                headers={"Content-Range": f"bytes */{size}"})
                return
            if rng is None:
                start, length, status = 0, size, 200
            else:
                (start, length), status = rng, 206
            self.send_response(status)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Accept-Ranges", "bytes")
            if status == 206:
                self.send_header("Content-Range",
                                 f"bytes {start}-{start + length - 1}/{size}")
            self.send_header("Content-Length", str(length))
            self.end_headers()
            self._write_body(view[start:start + length])  # zero-copy off mmap
        self.app.count(bytes_out=length, objects_served=1)

    def _mget(self) -> None:
        keys = self._read_json().get("keys", [])
        # the lease covers preflight THROUGH stream end: sizes resolved here
        # stay valid against concurrent gc/compaction for the whole response
        with self.app.store.cas.pin():
            sizes, missing = self.app.object_sizes(keys)
            if missing:
                self._send_json({"error": "missing objects",
                                 "missing": missing[:32]}, status=404)
                return
            total = sum(WIRE_REC_HEAD.size + len(k.encode()) + n
                        for k, n in sizes.items())
            self.send_response(200)
            self.send_header("Content-Type", "application/x-mgit-pack")
            self.send_header("Content-Length", str(total))
            self.end_headers()
            try:
                for key, view in self.app.iter_object_views(list(sizes)):
                    kill_point("hub.mget.record")
                    if len(view) != sizes[key]:
                        raise ValueError(f"object {key!r} changed size "
                                         "mid-stream")
                    kb = key.encode()
                    self.wfile.write(WIRE_REC_HEAD.pack(len(kb), len(view)))
                    self.wfile.write(kb)
                    self._write_body(view)  # zero-copy off the pooled mmap
            except ConnectionError:
                raise
            except Exception:
                # Headers + a Content-Length already went out: a concurrent
                # ledger overwrite (or an injected fault) invalidated the
                # preflight. Splicing a JSON error into the declared body
                # would corrupt the stream — abort the connection instead;
                # the client sees a short read and retries through its
                # backoff path.
                self.close_connection = True
                return
        self.app.count(bytes_out=total, objects_served=len(sizes))

    def _sizes(self) -> None:
        # Size preflight for the pull planner: objects above the ranged-read
        # floor (chunked tensors' ``c_`` payloads) get segmented parallel
        # GETs instead of riding the single mget stream. Missing keys are
        # reported, not an error — the planner mgets whatever remains.
        keys = self._read_json().get("keys", [])
        sizes, missing = self.app.object_sizes(keys)
        self._send_json({"sizes": sizes, "missing": missing})

    def _put_objects(self) -> None:
        body = self._read_body()
        objects = dict(iter_records(body))
        written = self.app.import_objects(objects)
        self._send_json({"imported": len(objects), "bytes_written": written})

    def _finalize(self) -> None:
        self._read_body()  # client-side roots are advisory; drain + ignore
        self._send_json({"refcounts": self.app.finalize()})

    def _journal_get(self, tid: str) -> None:
        payload = self.app.journal.journal_load(tid)
        if payload is None:
            self._send_json({"error": f"no journal {tid}"}, status=404)
        else:
            self._send_json(payload)

    def _journal_put(self, tid: str) -> None:
        self.app.journal.journal_write(tid, self._read_json())
        self._send_json({"ok": True})

    def _journal_delete(self, tid: str) -> None:
        self.app.journal.journal_clear(tid)
        self._send_json({"ok": True})

    def _journal_list(self) -> None:
        self._send_json({"transfers": list(self.app.journal.journal_list())})

    def _stats(self) -> None:
        self._send_json(self.app.stats_json())

    def _metrics(self) -> None:
        # Prometheus text, NOT json — scrapers parse the exposition format
        body = self.app.metrics_text().encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        self.app.count(bytes_out=len(body))

    def _fsck(self) -> None:
        self._send_json(self.app.fsck())

    # -- multi-tenant / maintenance routes (§16) ------------------------------
    def _service(self) -> Optional[HubService]:
        return self.server.service  # type: ignore[attr-defined]

    def _list_repos(self) -> None:
        service = self._service()
        if service is None:
            _, etag = self.app.lineage()
            self._send_json({"repos": [{"name": "default", "etag": etag}]})
            return
        out = []
        for name in service.repo_names():
            app = service.repo(name, create=False)
            if app is None:
                continue
            _, etag = app.lineage()
            out.append({"name": name, "etag": etag})
        self._send_json({"repos": out})

    def _delete_repo(self) -> None:
        service = self._service()
        if service is None:
            self._send_json({"error": "not a multi-tenant hub"}, status=404)
            return
        name = self.app.name
        if not service.delete_repo(name):
            self._send_json({"error": f"cannot delete repo {name!r}"},
                            status=400)
            return
        self._send_json({"deleted": name})

    def _run_gc(self) -> None:
        service = self._service()
        if service is None:
            self._send_json({"error": "not a multi-tenant hub"}, status=404)
            return
        body = self._read_json()
        confirm = int(body.get("confirm_cycles", 2))
        grace = int(body.get("grace", 1))
        self._send_json(service.run_gc(confirm_cycles=confirm, grace=grace))

    def _run_compact(self) -> None:
        service = self._service()
        if service is None:
            self._send_json({"error": "not a multi-tenant hub"}, status=404)
            return
        self._read_body()
        self._send_json(service.compact())

    def _replica_sync(self) -> None:
        replica = getattr(self.server, "replica", None)
        if replica is None:
            self._send_json({"error": "not a replica"}, status=404)
            return
        self._send_json(replica.sync_once())


#: default bounded-pool size; 0 restores the unbounded thread-per-request
#: behavior of a single-repo server
DEFAULT_MAX_WORKERS = 32
#: connections allowed to queue for a worker beyond the pool size before
#: the acceptor sheds with 503
DEFAULT_QUEUE_DEPTH = 64
_SHED_BODY = b'{"error": "saturated", "retry": true}'
_SHED_RESPONSE = (b"HTTP/1.1 503 Service Unavailable\r\n"
                  b"Content-Type: application/json\r\n"
                  b"Retry-After: 1\r\n"
                  b"Connection: close\r\n"
                  b"Content-Length: " + str(len(_SHED_BODY)).encode()
                  + b"\r\n\r\n" + _SHED_BODY)


class HubServer(ThreadingHTTPServer):
    """Bounded worker-pool HTTP server for one :class:`HubApp` or a whole
    :class:`HubService` (§16.4).

    Connections are handled on a fixed-size pool instead of one OS thread
    each; up to ``queue_depth`` connections may wait for a worker, and
    beyond that the acceptor writes a minimal ``503 Retry-After: 1``
    straight to the socket and closes — saturation degrades into explicit,
    retryable backpressure instead of unbounded thread growth. The
    transport's existing retry/backoff path treats the 503 like any other
    server-side retryable failure."""

    daemon_threads = True
    allow_reuse_address = True
    delay_s = 0.0        # per-request simulated RTT; see _route
    throttle_bps = 0     # per-connection bandwidth cap; see _write_body

    def __init__(self, app: Union[HubApp, HubService],
                 host: str = "127.0.0.1", port: int = 0,
                 max_workers: int = DEFAULT_MAX_WORKERS,
                 queue_depth: int = DEFAULT_QUEUE_DEPTH) -> None:
        if isinstance(app, HubService):
            self.service: Optional[HubService] = app
            self.app = app.default
        else:
            self.service = None
            self.app = app
        self.replica = None  # set by repro.hub.replica.serve_replica
        self.max_workers = int(max_workers)
        self.queue_depth = int(queue_depth)
        self._pool: Optional[cf.ThreadPoolExecutor] = None
        self._slots: Optional[threading.Semaphore] = None
        if self.max_workers > 0:
            self._pool = cf.ThreadPoolExecutor(
                max_workers=self.max_workers,
                thread_name_prefix="mgit-hub-worker")
            self._slots = threading.Semaphore(
                self.max_workers + self.queue_depth)
        super().__init__((host, port), HubRequestHandler)

    # -- bounded-pool connection handling ------------------------------------
    def process_request(self, request, client_address) -> None:
        if self._pool is None:  # unbounded compat mode
            super().process_request(request, client_address)
            return
        if not self._slots.acquire(blocking=False):
            self._shed(request)
            return
        try:
            self._pool.submit(self._work, request, client_address)
        except RuntimeError:  # pool shut down while accepting
            self._slots.release()
            self.shutdown_request(request)

    def _work(self, request, client_address) -> None:
        try:
            self.finish_request(request, client_address)
        except Exception:  # noqa: BLE001 — worker must return to the pool
            self.handle_error(request, client_address)
        finally:
            self.shutdown_request(request)
            self._slots.release()

    def _shed(self, request) -> None:
        """Overload response written by the acceptor thread: cheap enough
        that a saturated hub still answers every connection, with close
        semantics so no shed socket lingers in keep-alive."""
        try:
            request.sendall(_SHED_RESPONSE)
        except OSError:
            pass
        finally:
            self.shutdown_request(request)
        self.app.count(sheds_503=1)

    def server_close(self) -> None:
        super().server_close()
        if self._pool is not None:
            self._pool.shutdown(wait=False)

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}"


def make_server(app: Union[HubApp, HubService], host: str = "127.0.0.1",
                port: int = 0, max_workers: int = DEFAULT_MAX_WORKERS,
                queue_depth: int = DEFAULT_QUEUE_DEPTH) -> HubServer:
    """Bind (port 0 picks an ephemeral one) without starting the loop —
    tests and the CLI both drive ``serve_forever`` themselves."""
    return HubServer(app, host=host, port=port, max_workers=max_workers,
                     queue_depth=queue_depth)


def start_in_thread(app: Union[HubApp, HubService], host: str = "127.0.0.1",
                    port: int = 0, max_workers: int = DEFAULT_MAX_WORKERS,
                    queue_depth: int = DEFAULT_QUEUE_DEPTH
                    ) -> Tuple[HubServer, threading.Thread]:
    """Serve on a daemon thread; returns the bound server (``server.url``)."""
    server = make_server(app, host=host, port=port, max_workers=max_workers,
                         queue_depth=queue_depth)
    thread = threading.Thread(target=server.serve_forever,
                              name="mgit-hub", daemon=True)
    thread.start()
    return server, thread
