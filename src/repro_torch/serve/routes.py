"""HTTP surface of the serving daemon (DESIGN.md §13.4).

Same shape as the hub's route layer (``repro_torch.hub.routes``): a dependency-
free stdlib ``ThreadingHTTPServer`` codec — one OS thread per in-flight
request, which is exactly what the endpoint lease/drain accounting was
designed for (requests hold leases concurrently; swaps move a pointer).

Endpoints (all JSON):

    GET  /api/ping                liveness
    GET  /api/endpoints           endpoint table: node, ref, gate, swaps
    GET  /api/stats               router + pool + watcher counters,
                                  per-route p50/p99
    GET  /api/metrics             Prometheus text exposition (DESIGN §14)
    POST /api/predict/<endpoint>  {"x": [[...]]}? -> {"node","ref","y",...}
    POST /api/refresh             force one watcher poll (CI/tests: no
                                  need to wait out the poll interval)

Copied from the reference package's ``repro/serve/routes.py``; only the
imports differ.
"""

from __future__ import annotations

import gzip
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import unquote, urlsplit

import numpy as np

from repro_torch.hub.routes import _safe_id
from repro_torch.obs import REGISTRY, Histogram, render_prometheus, span
from repro_torch.remote.http import GZIP_FLOOR
from repro_torch.serve.pool import BitIdentityError, ModelPool
from repro_torch.serve.router import EndpointUnavailable, Router
from repro_torch.serve.watch import LineageWatcher

_FIXED_ROUTES = frozenset({"/api/ping", "/api/endpoints", "/api/stats",
                           "/api/metrics", "/api/refresh"})


def route_family(path: str) -> str:
    """Bounded-cardinality route label (mirrors hub.routes.route_family)."""
    if path.startswith("/api/predict/"):
        return "/api/predict/:endpoint"
    return path if path in _FIXED_ROUTES else "other"


class ServeApp:
    """One router + pool + watcher behind the HTTP codec."""

    def __init__(self, router: Router, pool: ModelPool,
                 watcher: Optional[LineageWatcher] = None) -> None:
        self.router = router
        self.pool = pool
        self.watcher = watcher
        self._lock = threading.Lock()
        # registry-backed compat view (mgit_serve_* in /api/metrics)
        self.counters = REGISTRY.group(
            "mgit_serve",
            keys=("requests", "predictions", "gate_refusals"),
            help="serve daemon request counters")
        self._latency: Dict[Tuple[str, str], Histogram] = {}

    def count(self, **deltas: int) -> None:
        with self._lock:
            for k, v in deltas.items():
                self.counters[k] += v

    def observe_request(self, method: str, route: str,
                        seconds: float) -> None:
        h = self._latency.get((method, route))
        if h is None:
            h = REGISTRY.histogram(
                "mgit_http_request_seconds",
                help="request latency by service/method/route",
                service="serve", instance=self.counters.instance,
                method=method, route=route)
            self._latency[(method, route)] = h
        h.observe(seconds)

    def latency_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for (method, route), h in sorted(self._latency.items()):
            out[f"{method} {route}"] = {
                "count": h.count,
                "p50_ms": round((h.quantile(0.5) or 0.0) * 1e3, 3),
                "p99_ms": round((h.quantile(0.99) or 0.0) * 1e3, 3)}
        return out

    def metrics_text(self) -> str:
        return render_prometheus()

    def stats_json(self) -> Dict[str, Any]:
        out = {"service": "mgit-serve", **self.counters.snapshot(),
               "router": self.router.stats(), "pool": self.pool.stats(),
               "request_latency": self.latency_json()}
        if self.watcher is not None:
            out["watch"] = self.watcher.stats()
        return out


class ServeRequestHandler(BaseHTTPRequestHandler):
    server_version = "mgit-serve/1.0"
    protocol_version = "HTTP/1.1"

    @property
    def app(self) -> ServeApp:
        return self.server.app  # type: ignore[attr-defined]

    def log_message(self, format: str, *args: Any) -> None:
        pass  # request metrics live in app.counters, not stderr

    def _read_json(self) -> Dict:
        length = int(self.headers.get("Content-Length") or 0)
        data = self.rfile.read(length) if length else b""
        if self.headers.get("Content-Encoding") == "gzip":
            data = gzip.decompress(data)
        return json.loads(data) if data else {}

    def _send_json(self, obj: Any, status: int = 200) -> None:
        body = json.dumps(obj).encode()
        hdrs = {}
        if ("gzip" in (self.headers.get("Accept-Encoding") or "")
                and len(body) > GZIP_FLOOR):
            body = gzip.compress(body, 5)
            hdrs["Content-Encoding"] = "gzip"
        if status >= 400:
            self.close_connection = True
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        for k, v in hdrs.items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _route(self, method: str) -> None:
        path = unquote(urlsplit(self.path).path).rstrip("/") or "/"
        self.app.count(requests=1)
        route = route_family(path)
        t0 = time.perf_counter()
        try:
            with span("serve.request", cat="serve", method=method,
                      route=route):
                handler = self._resolve(method, path)
                if handler is None:
                    self._send_json({"error": f"no route {method} {path}"},
                                    status=404)
                    return
                handler()
        except EndpointUnavailable as exc:
            # the serving gate: quarantined/empty endpoints refuse traffic
            self.app.count(gate_refusals=1)
            self._send_json({"error": str(exc)}, status=503)
        except BitIdentityError as exc:
            self._send_json({"error": f"bit-identity: {exc}"}, status=500)
        except (ValueError, KeyError, json.JSONDecodeError) as exc:
            self._send_json({"error": str(exc)}, status=400)
        except ConnectionError:
            raise  # client went away mid-response; nothing to send
        except Exception as exc:  # noqa: BLE001 — daemon must not die
            self._send_json({"error": f"internal: {exc}"}, status=500)
        finally:
            self.app.observe_request(method, route,
                                     time.perf_counter() - t0)

    def _resolve(self, method: str, path: str):
        if path.startswith("/api/predict/"):
            name = path[len("/api/predict/"):]
            if not _safe_id(name) or method != "POST":
                return None
            return lambda: self._predict(name)
        table = {
            ("GET", "/api/ping"): self._ping,
            ("GET", "/api/endpoints"): self._endpoints,
            ("GET", "/api/stats"): self._stats,
            ("GET", "/api/metrics"): self._metrics,
            ("POST", "/api/refresh"): self._refresh,
        }
        return table.get((method, path))

    def do_GET(self) -> None:
        self._route("GET")

    def do_POST(self) -> None:
        self._route("POST")

    # -- routes --------------------------------------------------------------
    def _ping(self) -> None:
        self._send_json({"ok": True, "service": "mgit-serve",
                         "endpoints": sorted(self.app.router.endpoints)})

    def _endpoints(self) -> None:
        self._send_json(self.app.router.stats())

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

    def _predict(self, name: str) -> None:
        body = self._read_json()
        x = body.get("x")
        if x is not None:
            x = np.asarray(x, np.float32)
        result = self.app.router.predict(name, x)
        self.app.count(predictions=1)
        self._send_json(result)

    def _refresh(self) -> None:
        if self.app.watcher is None:
            self._send_json({"error": "no watcher configured"}, status=400)
            return
        self._send_json(self.app.watcher.poll())


class ServeServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, app: ServeApp, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        self.app = app
        super().__init__((host, port), ServeRequestHandler)

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}"


def make_server(app: ServeApp, host: str = "127.0.0.1",
                port: int = 0) -> ServeServer:
    """Bind (port 0 picks an ephemeral one) without starting the loop."""
    return ServeServer(app, host=host, port=port)


def start_in_thread(app: ServeApp, host: str = "127.0.0.1", port: int = 0
                    ) -> Tuple[ServeServer, threading.Thread]:
    """Serve on a daemon thread; returns the bound server (``server.url``)."""
    server = make_server(app, host=host, port=port)
    thread = threading.Thread(target=server.serve_forever,
                              name="mgit-serve", daemon=True)
    thread.start()
    return server, thread
