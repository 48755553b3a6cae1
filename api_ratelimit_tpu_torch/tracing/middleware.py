"""Port of api_ratelimit_tpu/tracing/middleware.py: transport-layer tracing
hooks.

The reference enters server spans through a gRPC unary interceptor
(grpc_opentracing.UnaryServerInterceptor, wired at runner.go:95) and offers
an HTTP middleware for the gateway path (lightstep.go:107-160). These are
their twins for grpc.ServerInterceptor and the /json handler.
"""

from __future__ import annotations

import grpc

from . import propagation
from .tracer import Span, Tracer, activate, global_tracer


class OpenTracingServerInterceptor(grpc.ServerInterceptor):
    """Per-RPC server span: extract B3 context from invocation metadata,
    activate the span for the handler's dynamic extent, mark errors."""

    def __init__(self, tracer: Tracer | None = None):
        # None -> resolve the global tracer at call time, so registration
        # order (runner builds tracer, then server) doesn't matter.
        self._tracer = tracer

    def _resolve(self) -> Tracer:
        return self._tracer if self._tracer is not None else global_tracer()

    def intercept_service(self, continuation, handler_call_details):
        handler = continuation(handler_call_details)
        tracer = self._resolve()
        if handler is None or handler.unary_unary is None or not tracer.enabled:
            return handler

        method = handler_call_details.method
        parent = propagation.extract(handler_call_details.invocation_metadata)
        inner = handler.unary_unary

        def traced(request, context):
            span = tracer.start_span(
                method,
                child_of=parent,
                tags={"span.kind": "server", "component": "gRPC"},
            )
            with span, activate(span):
                return inner(request, context)

        return grpc.unary_unary_rpc_method_handler(
            traced,
            request_deserializer=handler.request_deserializer,
            response_serializer=handler.response_serializer,
        )


def start_http_server_span(operation: str, headers) -> Span:
    """Server span for an HTTP request, honoring inbound B3 headers; the
    caller activates/finishes it (with-statement). No-op span when tracing
    is disabled."""
    tracer = global_tracer()
    parent = propagation.extract(headers)
    return tracer.start_span(
        operation,
        child_of=parent,
        tags={"span.kind": "server", "component": "http"},
    )
