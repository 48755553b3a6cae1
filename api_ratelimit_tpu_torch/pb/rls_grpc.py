"""Port of api_ratelimit_tpu/pb/rls_grpc.py: gRPC service glue for Envoy
RateLimitService v3 + legacy v2.

Hand-written equivalent of what grpcio-tools' protoc plugin would emit (the
plugin is not a dependency): servicer base classes, registration helpers, and
client stubs. Method paths match Envoy's public API exactly so Envoy's
rate_limit filter and the reference's clients interoperate:
  /envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit
  /envoy.service.ratelimit.v2.RateLimitService/ShouldRateLimit
(registered by the reference at src/service_cmd/runner/runner.go:119-121).
"""

from __future__ import annotations

import grpc

from . import rls_v2, rls_v3

V3_SERVICE_NAME = "envoy.service.ratelimit.v3.RateLimitService"
V2_SERVICE_NAME = "envoy.service.ratelimit.v2.RateLimitService"


class RateLimitServiceV3Servicer:
    """Override ShouldRateLimit; register with add_v3_servicer."""

    def ShouldRateLimit(self, request, context):  # noqa: N802 (proto casing)
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        context.set_details("Method not implemented!")
        raise NotImplementedError("Method not implemented!")


class RateLimitServiceV2Servicer:
    def ShouldRateLimit(self, request, context):  # noqa: N802
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        context.set_details("Method not implemented!")
        raise NotImplementedError("Method not implemented!")


def _handler(servicer, request_cls, response_cls):
    return grpc.unary_unary_rpc_method_handler(
        servicer.ShouldRateLimit,
        request_deserializer=request_cls.FromString,
        response_serializer=response_cls.SerializeToString,
    )


def add_v3_servicer(servicer: RateLimitServiceV3Servicer, server: grpc.Server) -> None:
    handlers = {
        "ShouldRateLimit": _handler(
            servicer, rls_v3.RateLimitRequest, rls_v3.RateLimitResponse
        )
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(V3_SERVICE_NAME, handlers),)
    )


def add_v2_servicer(servicer: RateLimitServiceV2Servicer, server: grpc.Server) -> None:
    handlers = {
        "ShouldRateLimit": _handler(
            servicer, rls_v2.RateLimitRequest, rls_v2.RateLimitResponse
        )
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(V2_SERVICE_NAME, handlers),)
    )


class RateLimitServiceV3Stub:
    """Client stub (used by client_cmd and the integration tests)."""

    def __init__(self, channel: grpc.Channel):
        self.ShouldRateLimit = channel.unary_unary(
            f"/{V3_SERVICE_NAME}/ShouldRateLimit",
            request_serializer=rls_v3.RateLimitRequest.SerializeToString,
            response_deserializer=rls_v3.RateLimitResponse.FromString,
        )


class RateLimitServiceV2Stub:
    def __init__(self, channel: grpc.Channel):
        self.ShouldRateLimit = channel.unary_unary(
            f"/{V2_SERVICE_NAME}/ShouldRateLimit",
            request_serializer=rls_v2.RateLimitRequest.SerializeToString,
            response_deserializer=rls_v2.RateLimitResponse.FromString,
        )
