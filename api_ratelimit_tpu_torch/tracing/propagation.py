"""Port of api_ratelimit_tpu/tracing/propagation.py: B3 trace-context
propagation.

The reference propagates span context with Lightstep's B3Propagator over
both HTTPHeaders and TextMap carriers (src/tracing/lightstep.go:74-77). B3
multi-header format (openzipkin/b3-propagation):

  x-b3-traceid       16 or 32 lowercase hex chars (64- or 128-bit)
  x-b3-spanid        16 lowercase hex chars
  x-b3-parentspanid  (optional, ignored on extract)
  x-b3-sampled       "0" | "1" (also accepts legacy "true"/"false")

Carriers are any str->str mapping: gRPC invocation metadata (lower-cased by
the gRPC runtime) or HTTP headers (case-insensitive — extract lower-cases
candidate keys).
"""

from __future__ import annotations

from .tracer import SpanContext

TRACE_ID_HEADER = "x-b3-traceid"
SPAN_ID_HEADER = "x-b3-spanid"
PARENT_SPAN_ID_HEADER = "x-b3-parentspanid"
SAMPLED_HEADER = "x-b3-sampled"


def inject(context: SpanContext, carrier: dict) -> None:
    """Write B3 headers for an outgoing request."""
    carrier[TRACE_ID_HEADER] = f"{context.trace_id:032x}"
    carrier[SPAN_ID_HEADER] = f"{context.span_id:016x}"
    carrier[SAMPLED_HEADER] = "1" if context.sampled else "0"


def extract(carrier) -> SpanContext | None:
    """Parse B3 headers from an incoming carrier (mapping or iterable of
    (key, value) pairs, e.g. gRPC invocation_metadata). Returns None when no
    valid context is present — a malformed header must not fail the request."""
    items = carrier.items() if hasattr(carrier, "items") else carrier
    found: dict[str, str] = {}
    for key, value in items:
        low = str(key).lower()
        if low in (TRACE_ID_HEADER, SPAN_ID_HEADER, SAMPLED_HEADER):
            found[low] = str(value)

    trace_hex = found.get(TRACE_ID_HEADER, "")
    span_hex = found.get(SPAN_ID_HEADER, "")
    if len(trace_hex) not in (16, 32) or len(span_hex) != 16:
        return None
    try:
        trace_id = int(trace_hex, 16)
        span_id = int(span_hex, 16)
    except ValueError:
        return None
    if trace_id == 0 or span_id == 0:
        return None
    sampled_raw = found.get(SAMPLED_HEADER, "1").lower()
    sampled = sampled_raw in ("1", "true")
    return SpanContext(trace_id=trace_id, span_id=span_id, sampled=sampled)



def encode_textmap(context: SpanContext) -> bytes:
    """Serialize a context as a newline-joined B3 TextMap carrier: the
    trace trailer of a sidecar SUBMIT frame (backends/sidecar.py), built by
    the same inject the HTTP and gRPC transports use."""
    carrier: dict[str, str] = {}
    inject(context, carrier)
    return "\n".join(f"{k}:{v}" for k, v in sorted(carrier.items())).encode()


def decode_textmap(raw: bytes) -> SpanContext | None:
    """Inverse of encode_textmap; malformed input returns None (a bad
    trace trailer must never fail the carrying request)."""
    try:
        items = [line.split(":", 1) for line in raw.decode().splitlines() if ":" in line]
    except UnicodeDecodeError:
        return None
    return extract(items)
