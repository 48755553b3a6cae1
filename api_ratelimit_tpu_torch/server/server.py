"""Port of api_ratelimit_tpu/server/server.py: three listeners and a graceful
shutdown.

Python twin of src/server/server_impl.go: debug HTTP (:6070), gRPC (:8081,
SO_REUSEPORT) and main HTTP (:8080). The gRPC server carries the v3 and
legacy v2 RateLimitService and grpc.health.v1.Health. A signal flips health
to NOT_SERVING and then stops gRPC gracefully before the HTTP listeners go
away (server_impl.go:255-269, health.go:28-35). start() blocks serving the
main HTTP listener (server_impl.go:129-136); start_background() serves
everything on daemon threads, for in-process boots (the reference boots its
real runner in-process the same way, test/integration/integration_test.go:
251-274). Server spans enter through the gRPC tracing interceptor
(tracing/middleware.py, runner.go:95), which resolves the global tracer per
call, and through the /json middleware span.
"""

from __future__ import annotations

import logging
import signal
import threading
from concurrent import futures
from typing import Callable

import grpc

from ..pb import rls_grpc
from ..service.ratelimit import RateLimitService
from ..tracing.middleware import OpenTracingServerInterceptor
from .grpc_service import RateLimitServicerV2, RateLimitServicerV3
from .health import HealthChecker
from .http_server import HttpServer, new_debug_server

logger = logging.getLogger("ratelimit.server")

GRPC_MAX_WORKERS = 32


class Server:
    def __init__(
        self,
        host: str,
        port: int,
        grpc_port: int,
        debug_port: int,
        stats_store,
        deadline_propagation: bool = True,
        enable_metrics: bool = True,
        profile_dir: str = "",
    ):
        """enable_metrics (DEBUG_METRICS_ENABLED) mounts GET /metrics and
        profile_dir (TPU_PROFILE_DIR) enables GET /debug/profile on the
        debug port (http_server.py new_debug_server)."""
        self.health = HealthChecker()
        self.stats_store = stats_store
        # OVERLOAD_DEADLINE_PROPAGATION: capture the client deadline at the
        # gRPC edge and thread it down (utils/deadline.py)
        self._deadline_propagation = bool(deadline_propagation)
        self.grpc_server = grpc.server(
            futures.ThreadPoolExecutor(
                max_workers=GRPC_MAX_WORKERS, thread_name_prefix="grpc"
            ),
            options=[("grpc.so_reuseport", 1)],
            # a no-op until the runner registers an enabled tracer
            interceptors=[OpenTracingServerInterceptor()],
        )
        self._grpc_bound_port = self.grpc_server.add_insecure_port(
            f"{host or '[::]'}:{grpc_port}"
        )
        self.health.add_to_grpc_server(self.grpc_server)
        self.http = HttpServer(host=host, port=port, health=self.health)
        self.debug = new_debug_server(
            stats_store, host, debug_port, enable_metrics=enable_metrics, profile_dir=profile_dir
        )
        self._stopped = threading.Event()
        self._closed = threading.Event()

    # -- ports (bound values; 0 in the request means ephemeral) --

    @property
    def grpc_port(self) -> int:
        return self._grpc_bound_port

    @property
    def http_port(self) -> int:
        return self.http.port

    @property
    def debug_port(self) -> int:
        return self.debug.port

    def add_debug_endpoint(self, path: str, fn: Callable[[], str]) -> None:
        """AddDebugHttpEndpoint (src/server/server.go:20-24): the runner
        hangs /rlconfig and /debug/hotkeys here (runner.go:108-113)."""
        self.debug.add_debug_endpoint(path, fn)

    def register_service(self, service: RateLimitService, stats_scope) -> None:
        """Register v3 + legacy v2 RLS and the /json route
        (runner.go:115-121). The transport receive histograms
        (<scope>.transport.{grpc_ms,json_ms}) and the v2 error counters
        hang off stats_scope."""
        rls_grpc.add_v3_servicer(
            RateLimitServicerV3(
                service, stats_scope, deadline_propagation=self._deadline_propagation
            ),
            self.grpc_server,
        )
        rls_grpc.add_v2_servicer(
            RateLimitServicerV2(
                service, stats_scope, deadline_propagation=self._deadline_propagation
            ),
            self.grpc_server,
        )
        self.http.register_service(
            service, stats_scope, deadline_propagation=self._deadline_propagation
        )

    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT/SIGHUP -> drain + stop (server_impl.go:255-269).
        Main thread only; background starts skip this."""

        def on_signal(signum, frame):
            logger.warning("got signal %s, shutting down", signum)
            self.stop()

        for sig in (signal.SIGINT, signal.SIGTERM, signal.SIGHUP):
            signal.signal(sig, on_signal)

    def _start_side_listeners(self) -> None:
        self.debug.serve_background()
        self.grpc_server.start()

    def start_background(self) -> None:
        """Serve all listeners on daemon threads."""
        self._start_side_listeners()
        self.http.serve_background()
        logger.info(
            "listening: http=%d grpc=%d debug=%d",
            self.http_port, self.grpc_port, self.debug_port,
        )

    def start(self) -> None:
        """Serve; blocks until stop() (a signal or an explicit call) has
        closed the listeners."""
        self._start_side_listeners()
        logger.info(
            "listening: http=%d grpc=%d debug=%d",
            self.http_port, self.grpc_port, self.debug_port,
        )
        try:
            self.http.serve()  # blocking, like srv.ListenAndServe
        finally:
            self.stop()
            self._closed.wait(10.0)

    def stop(self) -> None:
        """Drain in the reference's order: NOT_SERVING first so load
        balancers stop sending, then a graceful gRPC stop, then the HTTP
        listeners. The listeners close on their own thread, because stop()
        may arrive through a signal handler running inside the main
        listener's serve loop, where a same-thread shutdown would
        deadlock."""
        if self._stopped.is_set():
            return
        self._stopped.set()
        self.health.fail()

        def teardown() -> None:
            # wait out the gRPC grace so in-flight calls finish before the
            # HTTP listeners go away
            self.grpc_server.stop(grace=5.0).wait()
            self.http.shutdown()
            self.debug.shutdown()
            self._closed.set()

        threading.Thread(target=teardown, name="server-stop", daemon=True).start()

    def wait_closed(self, timeout: float | None = None) -> bool:
        """Whether every listener has closed, waiting up to timeout."""
        return self._closed.wait(timeout)


def new_server(settings, stats_store) -> Server:
    return Server(
        host="",
        port=settings.port,
        grpc_port=settings.grpc_port,
        debug_port=settings.debug_port,
        stats_store=stats_store,
        deadline_propagation=settings.overload_deadline_propagation,
        enable_metrics=settings.debug_metrics_enabled,
        profile_dir=settings.tpu_profile_dir,
    )
