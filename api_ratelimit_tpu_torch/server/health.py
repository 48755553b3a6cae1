"""Port of api_ratelimit_tpu/server/health.py: dual HTTP + gRPC health
checking (src/server/health.go).

One ok flag backs both surfaces: HTTP /healthcheck answers 200 "OK" / 500
(health.go:40-47); the standard grpc.health.v1.Health service answers
SERVING / NOT_SERVING over both its RPCs, unary Check and streaming Watch
(the reference registers the stock grpc-health server, health.go:21-27).
fail() flips everything at once: the SIGTERM path calls it so load
balancers drain before shutdown (health.go:28-35), and Watch subscribers get
the NOT_SERVING push immediately. Degraded probes (the admission
controller's, the slab watermark's) stack into the /healthcheck body while
the status stays 200.
"""

from __future__ import annotations

import threading

import grpc

from ..pb import health_pb2

HEALTH_SERVICE_NAME = "grpc.health.v1.Health"


class HealthChecker:
    # Each sync-gRPC Watch stream holds one worker thread from the server's
    # shared pool for its whole life; uncapped, a fleet of watch-mode health
    # probes could pin every worker and starve the ratelimit RPCs the
    # health service exists to protect. Excess watchers get
    # RESOURCE_EXHAUSTED and should fall back to polling Check.
    MAX_WATCHERS = 8

    def __init__(self, name: str = "ratelimit"):
        self.name = name
        self._ok = True
        # guards _ok; notified on every transition so Watch streams can push
        # the new status to their subscribers without polling
        self._cond = threading.Condition()
        self._version = 0  # bumped per transition; lets Watch detect changes
        self._watchers = 0
        self._degraded_probes: list = []

    def set_degraded_probe(self, probe) -> None:
        """probe() -> None while healthy, or a short reason string while
        the service runs degraded — shedding under overload admission
        control (backends/overload.py) or past the slab watermark
        (backends/cuda.py). Multiple probes stack; every firing reason is
        reported. Degradation is reported in the /healthcheck BODY only —
        the status stays 200 and gRPC stays SERVING, because a degraded
        instance must keep taking traffic (draining it would turn an
        overload into a serving outage)."""
        self._degraded_probes.append(probe)

    # registration and stacking are the same operation; the alias keeps
    # call sites readable when adding the Nth probe
    add_degraded_probe = set_degraded_probe

    def ok(self) -> bool:
        with self._cond:
            return self._ok

    def fail(self) -> None:
        """Flip to unhealthy (health.go:49-52). One-way, used for LB drain;
        wakes every Watch subscriber so the NOT_SERVING status is pushed,
        not discovered at the next poll."""
        with self._cond:
            self._ok = False
            self._version += 1
            self._cond.notify_all()

    # -- gRPC surface --

    def _status(self, service: str) -> int:
        """Serving status for one service name. The stock health server
        tracks a per-service map; this server registers the overall ("")
        and its own name, like the reference's SetServingStatus calls
        (health.go:24, 33)."""
        if service not in ("", self.name):
            return health_pb2.HealthCheckResponse.SERVICE_UNKNOWN
        return (
            health_pb2.HealthCheckResponse.SERVING
            if self._ok
            else health_pb2.HealthCheckResponse.NOT_SERVING
        )

    def Check(self, request, context):  # noqa: N802 (proto casing)
        with self._cond:
            status = self._status(request.service)
        if status == health_pb2.HealthCheckResponse.SERVICE_UNKNOWN:
            # the stock health server answers unary Check for an unknown
            # service with NOT_FOUND (Watch instead streams SERVICE_UNKNOWN)
            context.abort(grpc.StatusCode.NOT_FOUND, "unknown service")
        return health_pb2.HealthCheckResponse(status=status)

    def Watch(self, request, context):  # noqa: N802 (proto casing)
        """Streaming watch: send the current status immediately, then one
        message per transition until the client disconnects — the standard
        grpc.health.v1 semantics the reference gets from the stock server."""
        service = request.service
        with self._cond:
            if self._watchers >= self.MAX_WATCHERS:
                context.abort(
                    grpc.StatusCode.RESOURCE_EXHAUSTED,
                    f"too many health watchers (max {self.MAX_WATCHERS}); "
                    "poll Check instead",
                )
            self._watchers += 1
            last = self._status(service)
            version = self._version
        try:
            yield health_pb2.HealthCheckResponse(status=last)
            while context.is_active():
                with self._cond:
                    # wake on transitions; time out periodically to notice a
                    # silently-departed client and release the stream
                    self._cond.wait_for(
                        lambda: self._version != version, timeout=1.0
                    )
                    version = self._version
                    status = self._status(service)
                if status != last and context.is_active():
                    last = status
                    yield health_pb2.HealthCheckResponse(status=status)
        finally:
            with self._cond:
                self._watchers -= 1

    def add_to_grpc_server(self, server: grpc.Server) -> None:
        handlers = {
            "Check": grpc.unary_unary_rpc_method_handler(
                self.Check,
                request_deserializer=health_pb2.HealthCheckRequest.FromString,
                response_serializer=health_pb2.HealthCheckResponse.SerializeToString,
            ),
            "Watch": grpc.unary_stream_rpc_method_handler(
                self.Watch,
                request_deserializer=health_pb2.HealthCheckRequest.FromString,
                response_serializer=health_pb2.HealthCheckResponse.SerializeToString,
            ),
        }
        server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(HEALTH_SERVICE_NAME, handlers),)
        )

    def degraded_reasons(self) -> list[str]:
        """Every currently-firing degraded reason, in registration order —
        the one place probe evaluation (and its must-not-crash guard)
        lives, shared by the /healthcheck body and anything else that
        wants the degradation picture."""
        reasons = []
        for probe in self._degraded_probes:
            try:
                reason = probe()
            except Exception:  # a probe bug must not fail the healthcheck
                continue
            if reason:
                reasons.append(reason)
        return reasons

    # -- HTTP surface (handler contract used by http_server) --

    def http_response(self) -> tuple[int, str]:
        if not self.ok():
            return (500, "")
        reasons = self.degraded_reasons()
        if reasons:
            # body keeps the "OK" prefix so checkers that string-match the
            # healthy body keep passing; orchestrators see the suffix
            return (200, f"OK (degraded: {'; '.join(reasons)})")
        return (200, "OK")
