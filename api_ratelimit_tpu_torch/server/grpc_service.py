"""Port of api_ratelimit_tpu/server/grpc_service.py: the gRPC servicers over
the transport-agnostic service.

v3 servicer: proto in -> service.should_rate_limit -> proto out. The client
deadline is captured at this edge (context.time_remaining()) and propagated
down the stack via utils/deadline.py, so the micro-batcher and the dispatch
loop can drop expired work before a device launch.

Typed exceptions map onto distinct gRPC codes so Envoy's retry/fail-open
policies can tell them apart (the reference collapsed everything to
codes.Unknown via its panic recovery, src/service/ratelimit.go:254-296):

    DeadlineExceededError -> DEADLINE_EXCEEDED  the caller already timed out
    OverloadError         -> UNAVAILABLE        shed by admission control
                                                (retriable; see
                                                backends/overload.py)
    CacheError            -> UNAVAILABLE        backend failure (retriable)
    ServiceError          -> INTERNAL           request/config/internal bug
                                                (retrying won't help)

v2 legacy servicer: delegates to the same brain through the legacy adapters,
with the reference's three conversion/dispatch error counters
(src/service/ratelimit_legacy.go:23-36) and the same code mapping.
"""

from __future__ import annotations

import logging
import time

import grpc

from ..backends.overload import OverloadError
from ..limiter.cache import CacheError, DeadlineExceededError
from ..pb import rls_grpc
from ..service.ratelimit import RateLimitService, ServiceError
from ..utils.deadline import deadline_scope
from . import proto_adapter

logger = logging.getLogger("ratelimit.server.grpc")


def _abort_for(context, error) -> None:
    """Map a typed service exception to its gRPC status (see module doc)."""
    if isinstance(error, DeadlineExceededError):
        context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(error))
    if isinstance(error, (OverloadError, CacheError)):
        context.abort(grpc.StatusCode.UNAVAILABLE, str(error))
    context.abort(grpc.StatusCode.INTERNAL, str(error))


class RateLimitServicerV3(rls_grpc.RateLimitServiceV3Servicer):
    def __init__(
        self,
        service: RateLimitService,
        stats_scope=None,
        deadline_propagation: bool = True,
    ):
        self._service = service
        self._deadline_propagation = bool(deadline_propagation)
        # transport.grpc_ms: handler wall time — proto conversion + the
        # service call. The gap against the service's own latency_ms is
        # the transport (receive-stage) overhead.
        self._h_receive = (
            stats_scope.scope("transport").histogram("grpc_ms")
            if stats_scope is not None
            else None
        )

    def ShouldRateLimit(self, request, context):  # noqa: N802
        logger.debug("handling v3 should_rate_limit for domain %s", request.domain)
        t0 = time.perf_counter() if self._h_receive is not None else 0.0
        remaining = (
            context.time_remaining() if self._deadline_propagation else None
        )
        try:
            with deadline_scope(remaining):
                internal = proto_adapter.request_from_v3(request)
                overall, statuses, headers = self._service.should_rate_limit(
                    internal
                )
                return proto_adapter.response_to_v3(overall, statuses, headers)
        except (CacheError, ServiceError) as e:
            _abort_for(context, e)
        finally:
            if self._h_receive is not None:
                self._h_receive.record((time.perf_counter() - t0) * 1e3)


class RateLimitServicerV2(rls_grpc.RateLimitServiceV2Servicer):
    """Legacy endpoint (ratelimit_legacy.go:39-60)."""

    def __init__(
        self,
        service: RateLimitService,
        stats_scope,
        deadline_propagation: bool = True,
    ):
        self._service = service
        self._deadline_propagation = bool(deadline_propagation)
        scope = stats_scope.scope("call.should_rate_limit_legacy")
        self._req_conversion_error = scope.counter("req_conversion_error")
        self._resp_conversion_error = scope.counter("resp_conversion_error")
        self._should_rate_limit_error = scope.counter("should_rate_limit_error")

    def ShouldRateLimit(self, request, context):  # noqa: N802
        try:
            internal = proto_adapter.request_from_v2(request)
        except Exception as e:
            self._req_conversion_error.add(1)
            context.abort(grpc.StatusCode.INTERNAL, str(e))
        remaining = (
            context.time_remaining() if self._deadline_propagation else None
        )
        try:
            with deadline_scope(remaining):
                overall, statuses, headers = self._service.should_rate_limit(
                    internal
                )
        except (CacheError, ServiceError) as e:
            self._should_rate_limit_error.add(1)
            _abort_for(context, e)
        try:
            return proto_adapter.response_to_v2(overall, statuses, headers)
        except Exception as e:
            self._resp_conversion_error.add(1)
            context.abort(grpc.StatusCode.INTERNAL, str(e))
