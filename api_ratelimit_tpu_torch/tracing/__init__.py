"""Port of api_ratelimit_tpu/tracing/__init__.py: the distributed tracing
subsystem (reference: src/tracing/).

See tracer.py for the design. Public surface:

    tracer = tracer_from_env(version)      # Noop | Recording | Collector
    set_global_tracer(tracer)
    with tracer.start_span("op") as span, activate(span):
        ...
    span = active_span()                   # inside instrumented layers
"""

from .propagation import extract, inject
from .tracer import (
    CollectorTracer,
    NoopTracer,
    RecordingTracer,
    Span,
    SpanContext,
    Tracer,
    activate,
    active_span,
    global_tracer,
    is_global_tracer_registered,
    reset_global_tracer,
    set_global_tracer,
    tag_do_limit_start,
    tracer_from_env,
)
def __getattr__(name):
    # middleware pulls in grpc; load it lazily so backends that import
    # tracing for tag_do_limit_start don't transitively require grpcio.
    if name in ("OpenTracingServerInterceptor", "start_http_server_span"):
        from . import middleware

        return getattr(middleware, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "CollectorTracer",
    "NoopTracer",
    "OpenTracingServerInterceptor",
    "RecordingTracer",
    "Span",
    "SpanContext",
    "Tracer",
    "activate",
    "active_span",
    "extract",
    "global_tracer",
    "inject",
    "is_global_tracer_registered",
    "reset_global_tracer",
    "set_global_tracer",
    "start_http_server_span",
    "tag_do_limit_start",
    "tracer_from_env",
]
