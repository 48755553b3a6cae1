"""Port of api_ratelimit_tpu/server/http_server.py: the HTTP listeners.

Main port: POST /json is the HTTP/JSON mirror of the v3 ShouldRateLimit RPC
(server_impl.go:62-104): 200 for OK, 429 for OVER_LIMIT, 500 for UNKNOWN or
a backend/service error, 504 when the caller's deadline (Envoy's
x-envoy-expected-rq-timeout-ms header) expired, 503 when admission control
shed the request, 400 for a malformed request. Each /json call runs in a
server span that honours inbound B3 headers (tracing/middleware.py). POST
/release takes the same request body and releases each matched concurrency
descriptor (RateLimitService.release), answering {"released": n}. GET
/healthcheck answers from the server's HealthChecker (server/health.py): 200
"OK" (with any degraded reasons in the body) while healthy, 500 once fail()
ran. The body codec is server/proto_adapter.py (standard-library JSON in
place of protobuf's json_format).

Debug port (new_debug_server, server_impl.go:217-250):
  - GET /            endpoint index
  - GET /stats       Store.debug_snapshot
  - GET /metrics     Prometheus text exposition (DEBUG_METRICS_ENABLED)
  - GET /debug/pprof/         every thread's stack
  - GET /debug/pprof/profile?seconds=N&hz=F  an all-thread statistical
    sampler in collapsed-stack format (flamegraph.pl, speedscope)
  - GET /debug/pprof/heap[?top=N]  tracemalloc snapshot; ?start=1 arms,
    ?stop=1 disarms, a bare GET never changes state
  - GET /debug/traces    the tracer's recorded spans
  - GET /debug/journeys  the journey recorder's retained and recent journeys
  - GET /debug/profile?ms=N  a torch.profiler trace (CPU and CUDA
    activities) of N ms into TPU_PROFILE_DIR
and whatever the runner mounts with add_debug_endpoint (/rlconfig,
/debug/hotkeys).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
import traceback
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from .. import tracing
from ..backends.overload import OverloadError
from ..limiter.cache import CacheError, DeadlineExceededError
from ..models.response import Code
from ..service.ratelimit import RateLimitService, ServiceError
from ..stats import prometheus
from ..tracing import journeys
from ..utils.deadline import deadline_scope
from . import proto_adapter
from .health import HealthChecker

logger = logging.getLogger("ratelimit.server.http")

# /debug/profile's longest capture
PROFILE_MAX_MS = 30_000.0


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # set on the per-server subclass; service is None until registered
    service: RateLimitService | None
    health: HealthChecker
    h_receive = None  # <scope>.transport.json_ms, once registered
    deadline_propagation = True

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

    def _remaining_seconds(self) -> float | None:
        """Envoy's x-envoy-expected-rq-timeout-ms, the HTTP twin of the gRPC
        deadline, in seconds; None without one (or with junk: no deadline,
        not a 400)."""
        if not self.deadline_propagation:
            return None
        raw = self.headers.get("x-envoy-expected-rq-timeout-ms")
        if not raw:
            return None
        try:
            return float(raw) / 1e3
        except ValueError:
            return None

    def do_POST(self):  # noqa: N802
        path = self.path.split("?", 1)[0]
        if self.service is None or path not in ("/json", "/release"):
            self._write(404, b"404 page not found\n")
            return
        # the HTTP middleware span, honouring inbound B3 headers
        # (src/tracing/lightstep.go:107-160); a no-op with tracing off
        with tracing.start_http_server_span(path, self.headers) as span:
            with tracing.activate(span):
                if path == "/release":
                    self._release()
                    return
                t0 = time.perf_counter()
                with deadline_scope(self._remaining_seconds()):
                    self._json()
                if self.h_receive is not None:
                    self.h_receive.record((time.perf_counter() - t0) * 1e3)

    def _json(self) -> None:
        request = self._read_request()
        if request is None:
            return
        try:
            overall, statuses, headers = self.service.should_rate_limit(request)
        except DeadlineExceededError as e:
            # the caller's deadline passed: a late 200 helps nobody (the
            # gRPC DEADLINE_EXCEEDED twin)
            self._write(504, f"Gateway Timeout: {e}\n".encode())
            return
        except OverloadError as e:
            # shed by admission control (the unavailable posture): retriable
            self._write(503, f"Service Unavailable: {e}\n".encode())
            return
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

    def register_service(
        self,
        service: RateLimitService,
        stats_scope=None,
        deadline_propagation: bool = True,
    ) -> None:
        """Route /json and /release to `service` (runner.go:115-121).
        stats_scope (optional) records <scope>.transport.json_ms, the /json
        handler's wall time. deadline_propagation binds Envoy's
        x-envoy-expected-rq-timeout-ms as the request's deadline
        (utils/deadline.py), so expired work answers 504 instead of late."""
        self._handler.service = service
        self._handler.deadline_propagation = bool(deadline_propagation)
        if stats_scope is not None:
            self._handler.h_receive = stats_scope.scope("transport").histogram("json_ms")


# a debug route: the raw request path (query included) -> (status, body,
# content type)
DebugRoute = Callable[[str], tuple[int, bytes, str]]


class _DebugHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    routes: dict[str, DebugRoute]  # per-server subclass

    def log_message(self, format, *args):  # noqa: A002 (stdlib signature)
        logger.debug("http debug: " + format, *args)

    def do_GET(self):  # noqa: N802
        path = self.path.split("?", 1)[0]
        route = self.routes.get(path)
        if route is None and path.startswith("/debug/pprof"):
            route = self.routes.get("/debug/pprof/")
        if route is None:
            status, body, content_type = 404, b"404 page not found\n", "text/plain"
        else:
            status, body, content_type = route(self.path)
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class DebugServer(_Listener):
    """The debug listener: GET routes, each a function of the request path
    returning (status, body, content type)."""

    def __init__(self, host: str, port: int):
        self._routes: dict[str, DebugRoute] = {}
        handler = type("DebugHandler", (_DebugHandler,), {"routes": self._routes})
        super().__init__(handler, host, port, "debug")

    def add_route(self, path: str, route: DebugRoute) -> None:
        self._routes[path] = route

    def add_debug_endpoint(self, path: str, fn: Callable[[], str]) -> None:
        """Serve GET `path` as text/plain from fn() (AddDebugHttpEndpoint,
        src/server/server.go:20-24; the reference's runner mounts
        /debug/hotkeys this way)."""
        self._routes[path] = lambda _path: (200, fn().encode(), "text/plain")

    def endpoints(self) -> list[str]:
        return sorted(self._routes)


def _query(path: str) -> dict:
    return urllib.parse.parse_qs(urllib.parse.urlparse(path).query)


def _json_body(doc, status: int = 200, indent=None) -> tuple[int, bytes, str]:
    return status, json.dumps(doc, indent=indent).encode(), "application/json"


def _text(status: int, text: str) -> tuple[int, bytes, str]:
    return status, text.encode(), "text/plain"


def new_debug_server(
    stats_store,
    host: str = "127.0.0.1",
    port: int = 0,
    enable_metrics: bool = True,
    profile_dir: str = "",
) -> DebugServer:
    """The debug-port suite (server_impl.go:217-250); the runner adds
    /rlconfig and /debug/hotkeys through add_debug_endpoint.

    enable_metrics (DEBUG_METRICS_ENABLED) mounts GET /metrics, rendered
    straight from the stats store (stats/prometheus.py).

    profile_dir (TPU_PROFILE_DIR): when set, GET /debug/profile?ms=N
    captures a torch.profiler trace for N ms (at most 30 s) into that
    directory as a Chrome trace. Empty leaves the endpoint mounted but
    answering 404: the profiler costs throughput and writes to disk, so it
    is an explicit operator opt-in."""
    server = DebugServer(host, port)

    def stats(_path):
        return _json_body(stats_store.debug_snapshot(), indent=2)

    def metrics(_path):
        return 200, prometheus.render(stats_store).encode(), prometheus.CONTENT_TYPE

    def index(_path):
        lines = ["/debug endpoints:"] + [f"  {e}" for e in server.endpoints()]
        return _text(200, "\n".join(lines) + "\n")

    def pprof(_path):
        frames = sys._current_frames()
        out = []
        for thread in threading.enumerate():
            frame = frames.get(thread.ident)
            out.append(f"--- thread {thread.name} (id {thread.ident}) ---")
            if frame is not None:
                out.extend(line.rstrip() for line in traceback.format_stack(frame))
        return _text(200, "\n".join(out) + "\n")

    def traces(_path):
        return 200, tracing.global_tracer().dump_json().encode(), "application/json"

    def journeys_doc(_path):
        """The journey recorder's export (tracing/journeys.py): retained
        slow/shed/deadline/fault/over-limit journeys with per-stage ns
        timestamps, and the per-thread recent rings."""
        recorder = journeys.global_recorder()
        if recorder is None:
            body = '{"enabled": false, "retained": [], "recent": {}}\n'
        else:
            body = recorder.dump_json()
        return 200, body.encode(), "application/json"

    # One sampler at a time (pprof semantics): N concurrent sampling loops
    # would each poll sys._current_frames() under the GIL.
    sampler_running = threading.Lock()

    def cpu_profile(path):
        """On-demand CPU profile (the pprof /debug/pprof/profile analog,
        server_impl.go:219-224): a statistical sampler over all threads for
        ?seconds=N at ?hz=F, one `frame;frame;frame count` line per
        distinct stack. A sampler because the hot path runs on worker
        threads, which deterministic profilers cannot attach to."""
        if not sampler_running.acquire(blocking=False):
            return _text(429, "a profile is already running; retry later\n")
        try:
            query = _query(path)
            try:
                seconds = min(float(query.get("seconds", ["5"])[0]), 60.0)
                hz = min(float(query.get("hz", ["100"])[0]), 1000.0)
            except ValueError as e:
                return _text(400, f"bad query parameter: {e}\n")
            interval = 1.0 / max(hz, 1.0)
            me = threading.get_ident()
            counts: dict[tuple, int] = {}
            deadline = time.monotonic() + seconds
            while time.monotonic() < deadline:
                for tid, frame in sys._current_frames().items():
                    if tid == me:
                        continue
                    stack = []
                    while frame is not None:
                        code = frame.f_code
                        stack.append(
                            f"{code.co_filename.rsplit('/', 1)[-1]}:"
                            f"{frame.f_lineno}:{code.co_name}"
                        )
                        frame = frame.f_back
                    key = tuple(reversed(stack))
                    counts[key] = counts.get(key, 0) + 1
                time.sleep(interval)
            return _text(200, "".join(
                ";".join(stack) + f" {n}\n"
                for stack, n in sorted(counts.items(), key=lambda kv: -kv[1])
            ))
        finally:
            sampler_running.release()

    def heap(path):
        """Heap snapshot (the pprof /debug/pprof/heap analog) through
        tracemalloc. Arming is an explicit opt-in: a bare GET never changes
        state, so a scraper cannot leave allocation tracking armed."""
        import tracemalloc

        query = _query(path)
        if query.get("stop", ["0"])[0] in ("1", "true"):
            if tracemalloc.is_tracing():
                tracemalloc.stop()
            return _json_body({"status": "tracemalloc stopped"})
        if query.get("start", ["0"])[0] in ("1", "true"):
            if not tracemalloc.is_tracing():
                tracemalloc.start(10)
            return _json_body(
                {"status": "tracemalloc armed; GET again for a snapshot, ?stop=1 to disarm"}
            )
        if not tracemalloc.is_tracing():
            return _json_body(
                {"status": "tracemalloc not armed; GET ?start=1 to begin tracing (read-only GETs never arm it)"}
            )
        try:
            top_n = min(int(query.get("top", ["50"])[0]), 500)
        except ValueError as e:
            return _text(400, f"bad query parameter: {e}\n")
        current, peak = tracemalloc.get_traced_memory()
        top = tracemalloc.take_snapshot().statistics("lineno")[:top_n]
        return _json_body(
            {
                "traced_current_bytes": current,
                "traced_peak_bytes": peak,
                "top": [
                    {
                        "file": s.traceback[0].filename,
                        "line": s.traceback[0].lineno,
                        "size_bytes": s.size,
                        "allocations": s.count,
                    }
                    for s in top
                ],
            },
            indent=2,
        )

    # one device trace at a time: two torch.profiler sessions cannot run
    # in one process
    device_profile_running = threading.Lock()

    def device_profile(path):
        """GET /debug/profile?ms=N: a torch.profiler trace of the process
        for N ms into TPU_PROFILE_DIR, with the CUDA activity where this
        torch build supports it, so the trace names every kernel the serving
        threads launch meanwhile (CUPTI records the whole process). 404
        until the knob is set, 429 while a capture runs, 400 on a bad
        query, 500 (and serving goes on) when the profiler fails."""
        if not profile_dir:
            return _text(404, "device profiling disabled: set TPU_PROFILE_DIR\n")
        if not device_profile_running.acquire(blocking=False):
            return _text(429, "a device profile is already running; retry later\n")
        try:
            try:
                ms = min(float(_query(path).get("ms", ["100"])[0]), PROFILE_MAX_MS)
            except ValueError as e:
                return _text(400, f"bad query parameter: {e}\n")
            import torch
            from torch.profiler import ProfilerActivity, profile

            supported = torch.profiler.supported_activities()
            activities = [
                a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA) if a in supported
            ]
            with profile(activities=activities) as prof:
                time.sleep(max(0.0, ms) / 1e3)
                if ProfilerActivity.CUDA in activities and torch.cuda.is_initialized():
                    torch.cuda.synchronize()
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(profile_dir, f"torch_trace_{os.getpid()}_{time.time_ns()}.json")
            )
            return _json_body({"profile_dir": profile_dir, "ms": ms})
        except Exception as e:  # noqa: BLE001 - profiling must not crash serving
            logger.warning("device profile failed: %s", e)
            return _text(500, f"device profile failed: {e}\n")
        finally:
            device_profile_running.release()

    server.add_route("/stats", stats)
    if enable_metrics:
        server.add_route("/metrics", metrics)
    server.add_route("/debug/pprof/", pprof)
    server.add_route("/debug/pprof/profile", cpu_profile)
    server.add_route("/debug/pprof/heap", heap)
    server.add_route("/debug/traces", traces)
    server.add_route("/debug/journeys", journeys_doc)
    server.add_route("/debug/profile", device_profile)
    server.add_route("/", index)
    return server
