"""Port of api_ratelimit_tpu/tracing/tracer.py (unchanged semantics):
in-process distributed tracing, the OpenTracing/Lightstep analog
(reference: src/tracing/lightstep.go, src/tracing/utils.go).

The reference registers a Lightstep tracer as the opentracing global tracer
with B3 propagation (lightstep.go:58-95) and hand-instruments the service
worker, the cache DoLimit phases, and the sleep_on_throttle pacing
(ratelimit.go:129-133,181-204; fixed_cache_impl.go:44-48,88-102). This module
provides the same capability with zero hot-path cost when disabled:

  - `Span` / `SpanContext` — 128-bit trace ids, tags, timestamped key-value
    logs, error marking, child-of relationships.
  - `NoopTracer` — the disabled default (lightstep.go:59-62's empty struct);
    every operation is a no-op on shared singletons.
  - `RecordingTracer` — bounded in-process ring of finished spans, exported
    as JSON on the debug port (/debug/traces), the hermetic stand-in for a
    collector in tests and dev.
  - `CollectorTracer` — ships finished spans as JSON lines over TCP to a
    collector endpoint from a background flusher thread; `close()` honors the
    reference's 1s shutdown timeout (lightstep.go:97-105).

The active span travels via `contextvars` (the Python analog of the
opentracing context/ScopeManager), so instrumented layers read
`active_span()` instead of threading a ctx argument through every call.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import os
import queue
import random
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass, field

logger = logging.getLogger("ratelimit.tracing")

# Env vars: accept the framework's own names and fall back to the reference's
# Lightstep-specific ones (lightstep.go:22-29) so deploy configs carry over.
TRACING_ENABLED_ENV = "K_TRACING_ENABLED"
TRACING_HOST_ENV = "K_TRACING_HOST"
TRACING_PORT_ENV = "K_TRACING_PORT"
TRACING_TOKEN_ENV = "K_TRACING_TOKEN"
TRACING_ZIPKIN_URL_ENV = "K_TRACING_ZIPKIN_URL"
LIGHTSTEP_ENABLED_ENV = "K_TRACING_LIGHTSTEP_ENABLED"
LIGHTSTEP_HOST_ENV = "K_TRACING_LIGHTSTEP_HOST"
LIGHTSTEP_PORT_ENV = "K_TRACING_LIGHTSTEP_PORT"
LIGHTSTEP_TOKEN_ENV = "K_TRACING_LIGHTSTEP_TOKEN"

COMPONENT_NAME = "apigw-ratelimit"

# The one anchor pair of this process between time.monotonic_ns(), which
# every span stamped after the fact is taken on, and the epoch, which
# torch.profiler stamps its timeline in (kineto's trace_start_ns() plus
# each event's relative us): a span's epoch start from epoch_s() lies on
# the device trace.
EPOCH_ANCHOR_NS = time.time_ns() - time.monotonic_ns()


def epoch_s(mono_ns: int) -> float:
    """Epoch seconds of a time.monotonic_ns() stamp, through the anchor."""
    return (mono_ns + EPOCH_ANCHOR_NS) / 1e9


# Every span id comes from one generator, seeded from the OS and again in a
# forked child, whose draws hold the GIL. os.urandom releases it around its
# syscall, and a dispatch owner that lets go of the GIL just after resolving
# its tickets waits behind every frontend those tickets woke: the recording
# would move the owner's wait out of the span that records it.
_ids = random.Random()
os.register_at_fork(after_in_child=_ids.seed)


def _getenv_fallback(env, key: str, fallback_key: str) -> str:
    """tracing/utils.go:10-16. Go's os.Getenv cannot distinguish unset from
    empty, so the reference falls back on empty too — match that."""
    v = env.get(key, "")
    if v == "":
        return env.get(fallback_key, "")
    return v


def parse_bool_default(s: str, default: bool) -> bool:
    """tracing/utils.go:65-71 semantics: empty -> default, bad -> raise."""
    if s == "":
        return default
    low = s.strip().lower()
    if low in ("1", "t", "true"):
        return True
    if low in ("0", "f", "false"):
        return False
    raise ValueError(f"invalid boolean: {s!r}")


def parse_int_default(s: str, default: int) -> int:
    """tracing/utils.go:42-55 semantics."""
    if s == "":
        return default
    return int(s)


@dataclass(frozen=True)
class SpanContext:
    """Identity that crosses process boundaries (B3 headers)."""

    trace_id: int  # 128-bit
    span_id: int  # 64-bit
    sampled: bool = True


@dataclass
class Span:
    tracer: "Tracer"
    operation_name: str
    context: SpanContext
    parent_id: int = 0
    start_time: float = 0.0  # wall clock (epoch) for display
    finish_time: float = 0.0
    duration: float = 0.0  # monotonic-clock delta, immune to NTP steps
    tags: dict = field(default_factory=dict)
    logs: list = field(default_factory=list)  # [(timestamp, {k: v})]
    # followsFrom references (OpenTracing) / span links (OTel): contexts
    # this span is CAUSALLY related to without being their child — the
    # dispatch.batch span links every request span it coalesced
    links: list = field(default_factory=list)  # [SpanContext]
    # force_sample() sets this: a span the SERVICE decided must be kept
    # (slow-request tail capture) even when B3 said sampled=0
    forced_sample: bool = False
    _finished: bool = False
    _mono_start: float = 0.0

    def set_tag(self, key: str, value) -> "Span":
        self.tags[key] = value
        return self

    def add_link(self, context: SpanContext) -> "Span":
        """Attach a followsFrom reference to another span's context."""
        self.links.append(context)
        return self

    def set_error(self, err=None) -> "Span":
        """ext.Error.Set + err log field (ratelimit.go:266-272)."""
        self.tags["error"] = True
        if err is not None:
            self.log_kv(event="error", message=str(err))
        return self

    def log_kv(self, **fields) -> "Span":
        self.logs.append((time.time(), fields))
        return self

    def force_sample(self) -> "Span":
        """Override head-based sampling for this span: a request that
        landed in the top latency bucket must reach the trace buffer so
        its histogram exemplar has a span to click through to, even when
        the inbound B3 context said sampled=0."""
        self.forced_sample = True
        self.set_tag("sampling.forced", True)
        return self

    def finish(self, mono_ns: int | None = None) -> None:
        """Finish now, or at a time.monotonic_ns() stamp already taken."""
        if self._finished:
            return
        self._finished = True
        if mono_ns is None:
            self.finish_time = time.time()
            self.duration = time.monotonic() - self._mono_start
        else:
            self.finish_time = epoch_s(mono_ns)
            self.duration = max(0.0, mono_ns / 1e9 - self._mono_start)
        self.tracer._on_finish(self)

    # `with tracer.start_span(...) as span:` finishes the span and marks the
    # error tag on an escaping exception, like defer-finish + recover marking.
    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            self.set_error(exc)
        self.finish()

    def to_json(self) -> dict:
        out = {
            "operation_name": self.operation_name,
            "trace_id": f"{self.context.trace_id:032x}",
            "span_id": f"{self.context.span_id:016x}",
            "parent_id": f"{self.parent_id:016x}" if self.parent_id else "",
            "start_us": int(self.start_time * 1e6),
            "duration_us": int(self.duration * 1e6),
            "tags": self.tags,
            "logs": [
                {"ts_us": int(ts * 1e6), "fields": fields}
                for ts, fields in self.logs
            ],
        }
        if self.links:
            out["links"] = [
                {
                    "trace_id": f"{c.trace_id:032x}",
                    "span_id": f"{c.span_id:016x}",
                }
                for c in self.links
            ]
        return out


_active_span: contextvars.ContextVar[Span | None] = contextvars.ContextVar(
    "ratelimit_active_span", default=None
)


def active_span() -> "Span | None":
    """opentracing.SpanFromContext equivalent (ratelimit.go:129)."""
    return _active_span.get()


@contextlib.contextmanager
def activate(span: "Span"):
    """Make `span` the active span for the dynamic extent of the block.
    No-op spans are not activated, so `active_span() is not None` means
    tracing is genuinely on — consistent across all transports."""
    if span.tracer is None:  # the shared no-op span
        yield span
        return
    token = _active_span.set(span)
    try:
        yield span
    finally:
        _active_span.reset(token)


class Tracer:
    """Base tracer: id generation + span lifecycle; subclasses consume
    finished spans in `_on_finish`."""

    def __init__(self):
        self._component = COMPONENT_NAME

    def _new_ids(self) -> tuple[int, int]:
        return _ids.getrandbits(128) or 1, _ids.getrandbits(64) or 1

    def start_span(
        self,
        operation_name: str,
        child_of: "Span | SpanContext | None" = None,
        tags: dict | None = None,
        links=None,
        start_ns: int | None = None,
        sampled: bool = True,
    ) -> Span:
        """A span started now, or at a time.monotonic_ns() stamp already
        taken (`start_ns`, placed on the epoch through the process's
        anchor). `sampled` is a root span's flag; a child takes its
        parent's."""
        parent_ctx = (
            child_of.context if isinstance(child_of, Span) else child_of
        )
        trace_id, span_id = self._new_ids()
        if parent_ctx is not None:
            context = SpanContext(
                trace_id=parent_ctx.trace_id,
                span_id=span_id,
                sampled=parent_ctx.sampled,
            )
            parent_id = parent_ctx.span_id
        else:
            context = SpanContext(trace_id=trace_id, span_id=span_id, sampled=sampled)
            parent_id = 0
        if start_ns is None:
            start_time, mono_start = time.time(), time.monotonic()
        else:
            start_time, mono_start = epoch_s(start_ns), start_ns / 1e9
        return Span(
            tracer=self,
            operation_name=operation_name,
            context=context,
            parent_id=parent_id,
            start_time=start_time,
            tags=dict(tags) if tags else {},
            links=list(links) if links else [],
            _mono_start=mono_start,
        )

    def record_span(
        self,
        operation_name: str,
        child_of: "Span | SpanContext | None",
        start_ns: int,
        end_ns: int,
        tags: dict | None = None,
    ) -> Span:
        """Record an already-elapsed interval between two
        time.monotonic_ns() stamps as a finished span: the dispatch
        frontend's request stage spans (ring_wait/pack/launch/redeem) from
        the owner thread's stamps, and the owner's own cycle spans."""
        if not self.enabled:
            return _NOOP_SPAN
        span = self.start_span(operation_name, child_of=child_of, tags=tags, start_ns=start_ns)
        span.finish(end_ns)
        return span

    @property
    def enabled(self) -> bool:
        return True

    def _on_finish(self, span: Span) -> None:
        raise NotImplementedError

    def dump_json(self) -> str:
        """Span dump for /debug/traces; tracers without a local buffer
        report an empty set."""
        return '{"spans": []}\n'

    def close(self) -> None:
        """Flush and shut down (lightstep.go:97-105)."""


class _NoopSpan(Span):
    """Shared do-nothing span: all mutators return self without touching
    state, so a disabled tracer adds no allocation to the hot path."""

    def __init__(self):
        super().__init__(
            tracer=None,
            operation_name="",
            context=SpanContext(trace_id=0, span_id=0, sampled=False),
        )

    def set_tag(self, key, value):
        return self

    def set_error(self, err=None):
        return self

    def log_kv(self, **fields):
        return self

    def add_link(self, context):
        return self  # never mutate the shared singleton

    def force_sample(self):
        return self  # never mutate the shared singleton

    def finish(self, mono_ns=None):
        pass

    def __exit__(self, exc_type, exc, tb):
        pass


_NOOP_SPAN = _NoopSpan()


class NoopTracer(Tracer):
    """Disabled tracing: the reference's empty LightstepTracer
    (lightstep.go:59-62)."""

    @property
    def enabled(self) -> bool:
        return False

    def start_span(self, operation_name, child_of=None, tags=None, links=None,
                   start_ns=None, sampled=True) -> Span:
        return _NOOP_SPAN

    def _on_finish(self, span: Span) -> None:
        pass


class RecordingTracer(Tracer):
    """Keeps the most recent finished spans in memory for inspection —
    the test double and the /debug/traces source. `keep_unsampled` keeps
    the spans no sampled request asked for too, as a profiling session
    does: the dispatch owner's cycles that no request span is linked to
    (backends/dispatch.py) are recorded unsampled."""

    def __init__(self, max_spans: int = 2048, keep_unsampled: bool = False):
        super().__init__()
        self._max_spans = max_spans
        self.keep_unsampled = keep_unsampled
        self._lock = threading.Lock()
        self._spans: list[Span] = []

    def _on_finish(self, span: Span) -> None:
        # honor B3 sampled=0 unless the service force-sampled (slow tail)
        if not (span.context.sampled or span.forced_sample or self.keep_unsampled):
            return
        with self._lock:
            self._spans.append(span)
            if len(self._spans) > self._max_spans:
                del self._spans[: len(self._spans) - self._max_spans]

    def finished_spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()

    def to_json(self) -> str:
        return json.dumps(
            {"spans": [s.to_json() for s in self.finished_spans()]}, indent=2
        )

    def dump_json(self) -> str:
        return self.to_json()


class CollectorTracer(Tracer):
    """Ships finished spans as JSON lines over TCP to a collector — the
    satellite-export role Lightstep's tracer plays in the reference
    (lightstep.go:64-77). Export failures drop spans and log once; tracing
    must never take the service down."""

    def __init__(
        self,
        host: str,
        port: int,
        token: str = "",
        version: str = "dev",
        max_queue: int = 4096,
        flush_interval: float = 1.0,
    ):
        super().__init__()
        self._host = host
        self._port = port
        self._token = token
        self._version = version
        self._queue: queue.Queue = queue.Queue(maxsize=max_queue)
        self._flush_interval = flush_interval
        self._stop = threading.Event()
        self._warned = False
        self._conn: socket.socket | None = None  # persistent, flusher-owned
        self._thread = threading.Thread(
            target=self._flush_loop, name="tracing-flush", daemon=True
        )
        self._thread.start()

    def _on_finish(self, span: Span) -> None:
        # honor B3 sampled=0 unless the service force-sampled (slow tail)
        if not span.context.sampled and not span.forced_sample:
            return
        try:
            self._queue.put_nowait(span)
        except queue.Full:
            pass  # drop under pressure, never block the request path

    def _drain(self) -> list[Span]:
        spans: list[Span] = []
        while True:
            try:
                spans.append(self._queue.get_nowait())
            except queue.Empty:
                return spans

    def _flush_loop(self) -> None:
        while not self._stop.wait(self._flush_interval):
            self._flush_once()
        self._flush_once()  # final drain on shutdown
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None

    def _flush_once(self) -> None:
        spans = self._drain()
        if not spans:
            return
        try:
            self._export(spans)
            self._warned = False  # re-arm warning after a good flush
        except Exception as e:  # noqa: BLE001 - the flush thread must survive
            # any exporter failure (e.g. http.client.HTTPException from a
            # malformed collector response); tracing never takes the
            # process — or its own flusher — down
            if not self._warned:
                self._warned = True
                logger.warning(
                    "trace export to %s failed (%s); dropping spans",
                    self._destination(),
                    e,
                )

    def _destination(self) -> str:
        """Export target for operator-facing failure logs."""
        return f"{self._host}:{self._port}"

    def _export(self, spans: list[Span]) -> None:
        payload = b"".join(
            (
                json.dumps(
                    {
                        "component": self._component,
                        "service.version": self._version,
                        "access_token": self._token,
                        "span": s.to_json(),
                    }
                )
                + "\n"
            ).encode()
            for s in spans
        )
        try:
            if self._conn is None:
                self._conn = socket.create_connection(
                    (self._host, self._port), timeout=1.0
                )
            self._conn.sendall(payload)
        except OSError:
            if self._conn is not None:
                try:
                    self._conn.close()
                except OSError:
                    pass
                self._conn = None
            raise

    def close(self, timeout: float = 1.0) -> None:
        """Bounded shutdown flush (lightstep.go:97-105, runner.go:91)."""
        self._stop.set()
        self._thread.join(timeout)


def _zipkin_json(span: Span, service_name: str) -> dict:
    """Zipkin v2 span JSON — the lingua franca every mainstream collector
    ingests (zipkin, jaeger, otel-collector, tempo), standing in for the
    reference's Lightstep satellite protocol (lightstep.go:64-77)."""
    out = {
        "traceId": f"{span.context.trace_id:032x}",
        "id": f"{span.context.span_id:016x}",
        "name": span.operation_name,
        "timestamp": int(span.start_time * 1e6),
        "duration": max(1, int(span.duration * 1e6)),
        "localEndpoint": {"serviceName": service_name},
        "tags": {k: str(v) for k, v in span.tags.items()},
        "annotations": [
            {
                "timestamp": int(ts * 1e6),
                "value": ", ".join(f"{k}={v}" for k, v in fields.items()),
            }
            for ts, fields in span.logs
        ],
    }
    if span.parent_id:
        out["parentId"] = f"{span.parent_id:016x}"
    return out


class ZipkinTracer(CollectorTracer):
    """HTTP exporter: POSTs finished spans as Zipkin v2 JSON batches to a
    collector endpoint (default path /api/v2/spans). Same queue / bounded
    flush / drop-under-pressure behavior as CollectorTracer."""

    def __init__(
        self,
        url: str,
        token: str = "",
        version: str = "dev",
        max_queue: int = 4096,
        flush_interval: float = 1.0,
    ):
        if "://" not in url:
            url = "http://" + url
        if not urllib.parse.urlparse(url).path.strip("/"):
            url = url.rstrip("/") + "/api/v2/spans"
        self._url = url
        super().__init__(
            host="",
            port=0,
            token=token,
            version=version,
            max_queue=max_queue,
            flush_interval=flush_interval,
        )

    def _destination(self) -> str:
        return self._url

    def _export(self, spans: list[Span]) -> None:
        payload = json.dumps(
            [_zipkin_json(s, self._component) for s in spans]
        ).encode()
        headers = {"Content-Type": "application/json"}
        if self._token:
            headers["Authorization"] = f"Bearer {self._token}"
        request = urllib.request.Request(self._url, data=payload, headers=headers)
        with urllib.request.urlopen(request, timeout=2.0) as resp:
            resp.read()


_global_tracer: Tracer = NoopTracer()
_global_registered = False


def set_global_tracer(tracer: Tracer) -> None:
    """opentracing.SetGlobalTracer (lightstep.go:87)."""
    global _global_tracer, _global_registered
    _global_tracer = tracer
    _global_registered = True


def global_tracer() -> Tracer:
    return _global_tracer


def is_global_tracer_registered() -> bool:
    """opentracing.IsGlobalTracerRegistered (lightstep.go:108)."""
    return _global_registered


def reset_global_tracer() -> None:
    """Test hook: back to the unregistered no-op default."""
    global _global_tracer, _global_registered
    _global_tracer = NoopTracer()
    _global_registered = False


def tag_do_limit_start(
    backend: str, limits_count: int, cache_keys_count: int
) -> "Span | None":
    """Shared DoLimit entry instrumentation for every cache backend: the
    backend tag + DoLimit.start event (fixed_cache_impl.go:44-48). Returns
    the active span (None when tracing is off) for further phase events."""
    span = active_span()
    if span is not None:
        span.set_tag("backend", backend)
        span.log_kv(
            event="DoLimit.start",
            limits_count=limits_count,
            cache_keys_count=cache_keys_count,
        )
    return span


def tracer_from_env(version: str = "dev", environ=None) -> Tracer:
    """Build the tracer the env asks for (GetLightstepConfigFromEnv,
    lightstep.go:43-50): disabled -> NoopTracer; enabled with a collector
    host -> CollectorTracer; enabled without one -> RecordingTracer (spans
    stay inspectable on the debug port). environ: the mapping to read
    (os.environ when None), as new_settings takes one."""
    env = os.environ if environ is None else environ
    enabled = parse_bool_default(
        _getenv_fallback(env, TRACING_ENABLED_ENV, LIGHTSTEP_ENABLED_ENV), False
    )
    if not enabled:
        return NoopTracer()
    zipkin_url = env.get(TRACING_ZIPKIN_URL_ENV, "").strip()
    if zipkin_url:
        logger.info("tracing enabled, zipkin export to %s", zipkin_url)
        return ZipkinTracer(
            zipkin_url,
            token=_getenv_fallback(env, TRACING_TOKEN_ENV, LIGHTSTEP_TOKEN_ENV),
            version=version,
        )
    host = _getenv_fallback(env, TRACING_HOST_ENV, LIGHTSTEP_HOST_ENV)
    port = parse_int_default(
        _getenv_fallback(env, TRACING_PORT_ENV, LIGHTSTEP_PORT_ENV), 0
    )
    token = _getenv_fallback(env, TRACING_TOKEN_ENV, LIGHTSTEP_TOKEN_ENV)
    if host and port:
        logger.info("tracing enabled, exporting to %s:%d", host, port)
        return CollectorTracer(host, port, token=token, version=version)
    logger.info("tracing enabled (in-process recording, no collector)")
    return RecordingTracer()
