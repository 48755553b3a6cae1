"""Port of api_ratelimit_tpu/server/http_server.py: the HTTP listeners.

Main port: POST /json is the HTTP/JSON mirror of the v3 ShouldRateLimit RPC
(server_impl.go:62-104): 200 for OK, 429 for OVER_LIMIT, 500 for UNKNOWN or
a backend/service error, 400 for a malformed request. POST /release takes the
same request body and releases each matched concurrency descriptor
(RateLimitService.release), answering {"released": n}. GET /healthcheck
answers from the server's HealthChecker (server/health.py): 200 "OK" (with
any degraded reasons in the body) while healthy, 500 once fail() ran. The
body codec is server/proto_adapter.py (standard-library JSON in place of
protobuf's json_format).

Debug port (new_debug_server, server_impl.go:217-250): GET / (endpoint
index), GET /stats (Store.debug_snapshot), and whatever the caller mounts
with add_debug_endpoint, as the runner mounts /rlconfig and /debug/hotkeys.
/metrics, /debug/pprof, /debug/profile, /debug/journeys and /debug/traces,
/json deadlines and tracing are ROADMAP item 4b.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from ..limiter.cache import CacheError
from ..models.response import Code
from ..service.ratelimit import RateLimitService, ServiceError
from . import proto_adapter
from .health import HealthChecker

logger = logging.getLogger("ratelimit.server.http")


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # set on the per-server subclass; service is None until registered
    service: RateLimitService | None
    health: HealthChecker

    def log_message(self, format, *args):  # noqa: A002 (stdlib signature)
        logger.debug("http: " + format, *args)

    def _write(self, status: int, body: bytes, content_type: str = "text/plain"):
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        if self.path.split("?", 1)[0] == "/healthcheck":
            status, body = self.health.http_response()
            self._write(status, body.encode())
        else:
            self._write(404, b"404 page not found\n")

    def _read_request(self):
        """The POST body decoded as a RateLimitRequest, or None after
        answering 400 (malformed) or 500."""
        # a malformed Content-Length is a 400, and a negative one must not
        # turn into an unbounded read
        try:
            length = int(self.headers.get("Content-Length", 0))
        except (TypeError, ValueError):
            self._write(400, b"Bad Request: invalid Content-Length\n")
            return None
        body = self.rfile.read(length) if length > 0 else b""
        if not body:
            self._write(400, b"Bad Request: empty body\n")
            return None
        try:
            return proto_adapter.decode_request(body)
        except proto_adapter.RequestDecodeError as e:
            self._write(400, f"Bad Request: {e}\n".encode())
        except ServiceError as e:
            self._write(500, f"Internal Server Error: {e}\n".encode())
        return None

    def do_POST(self):  # noqa: N802
        path = self.path.split("?", 1)[0]
        if self.service is None:
            self._write(404, b"404 page not found\n")
            return
        if path == "/release":
            self._release()
            return
        if path != "/json":
            self._write(404, b"404 page not found\n")
            return
        request = self._read_request()
        if request is None:
            return
        try:
            overall, statuses, headers = self.service.should_rate_limit(request)
        except (CacheError, ServiceError) as e:
            self._write(500, f"Internal Server Error: {e}\n".encode())
            return
        out = proto_adapter.encode_response(overall, statuses, headers)
        if overall == Code.OK:
            status = 200
        elif overall == Code.OVER_LIMIT:
            status = 429
        else:
            status = 500
        self._write(status, out, content_type="application/json")

    def _release(self) -> None:
        """POST /release: the concurrency Release surface. The body is a
        /json request; each matched concurrency descriptor's in-flight
        count is decremented. Answers {"released": n}."""
        request = self._read_request()
        if request is None:
            return
        try:
            released = self.service.release(request)
        except (CacheError, ServiceError) as e:
            self._write(500, f"Internal Server Error: {e}\n".encode())
            return
        self._write(200, json.dumps({"released": released}).encode(), content_type="application/json")


class _Listener:
    """One stdlib ThreadingHTTPServer; serve_background() runs it in a
    daemon thread, shutdown() stops it."""

    def __init__(self, handler: type, host: str, port: int, name: str):
        self._server = ThreadingHTTPServer((host, port), handler)
        self._server.daemon_threads = True
        self._thread: threading.Thread | None = None
        self._name = name

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def serve(self) -> None:
        """Serve in the calling thread until shutdown()."""
        self._server.serve_forever(poll_interval=0.1)

    def serve_background(self) -> None:
        self._thread = threading.Thread(
            target=self.serve, name=f"http-{self._name}", daemon=True
        )
        self._thread.start()

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


class HttpServer(_Listener):
    """The main listener: /json, /release and /healthcheck. The service may
    come later (register_service); until then /json and /release answer
    404. health is the HealthChecker /healthcheck answers from (a fresh,
    healthy one when None)."""

    def __init__(
        self,
        service: RateLimitService | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
        health: HealthChecker | None = None,
    ):
        self.health = health if health is not None else HealthChecker()
        self._handler = type(
            "JsonHandler", (_Handler,), {"service": service, "health": self.health}
        )
        super().__init__(self._handler, host, port, "json")

    def register_service(self, service: RateLimitService) -> None:
        """Route /json and /release to `service` (runner.go:115-121)."""
        self._handler.service = service


class _DebugHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    routes: dict[str, Callable[[], tuple[bytes, str]]]  # per-server subclass

    def log_message(self, format, *args):  # noqa: A002 (stdlib signature)
        logger.debug("http debug: " + format, *args)

    def do_GET(self):  # noqa: N802
        route = self.routes.get(self.path.split("?", 1)[0])
        if route is None:
            body, content_type, status = b"404 page not found\n", "text/plain", 404
        else:
            (body, content_type), status = route(), 200
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class DebugServer(_Listener):
    """The debug listener: GET routes, each a function returning its body."""

    def __init__(self, host: str, port: int):
        self._routes: dict[str, Callable[[], tuple[bytes, str]]] = {}
        handler = type("DebugHandler", (_DebugHandler,), {"routes": self._routes})
        super().__init__(handler, host, port, "debug")

    def add_debug_endpoint(self, path: str, fn: Callable[[], str]) -> None:
        """Serve GET `path` as text/plain from fn() (AddDebugHttpEndpoint,
        src/server/server.go:20-24; the reference's runner mounts
        /debug/hotkeys this way)."""
        self._routes[path] = lambda: (fn().encode(), "text/plain")

    def endpoints(self) -> list[str]:
        return sorted(self._routes)


def new_debug_server(stats_store, host: str = "127.0.0.1", port: int = 0) -> DebugServer:
    """The debug-port subset this port has: GET / lists the endpoints and
    GET /stats dumps stats_store.debug_snapshot() (which runs the stat
    generators first, as every export does)."""
    server = DebugServer(host, port)

    def stats():
        body = json.dumps(stats_store.debug_snapshot(), indent=2).encode()
        return body, "application/json"

    def index():
        lines = ["/debug endpoints:"] + [f"  {e}" for e in server.endpoints()]
        return ("\n".join(lines) + "\n").encode(), "text/plain"

    server._routes["/stats"] = stats
    server._routes["/"] = index
    return server
