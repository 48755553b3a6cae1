"""The port's tracing (api_ratelimit_tpu_torch/tracing/) against the JAX
package's, on the CPU.

* tests/test_tracing.py's span lifecycle, B3 propagation, env-config,
  collector and Zipkin-export cases and the service instrumentation, run on
  both packages' tracers (`pkg` is "jax" or "port").
* The span documents both packages record for the same requests are equal
  with ids and times masked: the service over the memory backend, over the
  slab engine in direct mode (the JAX XLA twin against the port's CUDA
  engine on the CPU, the backend tag and lookup event named after each
  engine), over the dispatch loop (request span, dispatch.* stage spans,
  the linked dispatch.batch span), a failed launch, and the Zipkin v2
  documents of all of them. The port's owner-cycle spans and its batch
  span's launch tags, which the reference does not record, are filtered
  out of the port's documents first (reference_docs); every reference span
  is still compared whole.

The namespaces PKGS (each package's modules) and the helpers here are
shared by tests/test_torch_journeys.py and tests/test_torch_fallback.py.
"""

import json
import socket
import threading
import time
import types

import numpy as np
import pytest

pytest.importorskip("torch")

import api_ratelimit_tpu.backends.fallback as j_fallback  # noqa: E402
import api_ratelimit_tpu.backends.memory as j_memory  # noqa: E402
import api_ratelimit_tpu.backends.overload as j_overload  # noqa: E402
import api_ratelimit_tpu.backends.tpu as j_tpu  # noqa: E402
import api_ratelimit_tpu.limiter.base_limiter as j_base  # noqa: E402
import api_ratelimit_tpu.limiter.cache as j_cache  # noqa: E402
import api_ratelimit_tpu.models as j_models  # noqa: E402
import api_ratelimit_tpu.models.response as j_response  # noqa: E402
import api_ratelimit_tpu.server.health as j_health  # noqa: E402
import api_ratelimit_tpu.server.http_server as j_http  # noqa: E402
import api_ratelimit_tpu.service.ratelimit as j_service  # noqa: E402
import api_ratelimit_tpu.stats as j_stats  # noqa: E402
import api_ratelimit_tpu.tracing as j_tracing  # noqa: E402
import api_ratelimit_tpu.tracing.journeys as j_journeys  # noqa: E402
import api_ratelimit_tpu.tracing.tracer as j_tracer  # noqa: E402
import api_ratelimit_tpu.utils.deadline as j_deadline  # noqa: E402
import api_ratelimit_tpu.utils.timeutil as j_time  # noqa: E402
import api_ratelimit_tpu_torch.backends.cuda as p_cuda  # noqa: E402
import api_ratelimit_tpu_torch.backends.fallback as p_fallback  # noqa: E402
import api_ratelimit_tpu_torch.backends.memory as p_memory  # noqa: E402
import api_ratelimit_tpu_torch.backends.overload as p_overload  # noqa: E402
import api_ratelimit_tpu_torch.limiter.base_limiter as p_base  # noqa: E402
import api_ratelimit_tpu_torch.limiter.cache as p_cache  # noqa: E402
import api_ratelimit_tpu_torch.models as p_models  # noqa: E402
import api_ratelimit_tpu_torch.models.response as p_response  # noqa: E402
import api_ratelimit_tpu_torch.server.health as p_health  # noqa: E402
import api_ratelimit_tpu_torch.server.http_server as p_http  # noqa: E402
import api_ratelimit_tpu_torch.service.ratelimit as p_service  # noqa: E402
import api_ratelimit_tpu_torch.stats as p_stats  # noqa: E402
import api_ratelimit_tpu_torch.tracing as p_tracing  # noqa: E402
import api_ratelimit_tpu_torch.tracing.journeys as p_journeys  # noqa: E402
import api_ratelimit_tpu_torch.tracing.tracer as p_tracer  # noqa: E402
import api_ratelimit_tpu_torch.utils.deadline as p_deadline  # noqa: E402
import api_ratelimit_tpu_torch.utils.timeutil as p_time  # noqa: E402

N_SLOTS, WAYS, NOW0 = 1 << 10, 4, 1_700_000_000


def _jax_engine(ts, window=0.0, dispatch_loop=True, **kw):
    return j_tpu.SlabDeviceEngine(
        time_source=ts, n_slots=N_SLOTS, ways=WAYS, buckets=(8, 64), use_pallas=False,
        batch_window_seconds=window, dispatch_loop=dispatch_loop, max_batch=1024, **kw,
    )


def _port_engine(ts, window=0.0, dispatch_loop=True, **kw):
    return p_cuda.SlabDeviceEngine(
        time_source=ts, n_slots=N_SLOTS, ways=WAYS, buckets=(8, 64), device="cpu",
        batch_window_seconds=window, dispatch_loop=dispatch_loop, max_batch=1024, **kw,
    )


def _jax_slab_cache(base, **kw):
    return j_tpu.TpuRateLimitCache(base, n_slots=N_SLOTS, ways=WAYS, use_pallas=False, buckets=(128, 1024), **kw)


def _port_slab_cache(base, **kw):
    return p_cuda.CudaRateLimitCache(base, n_slots=N_SLOTS, ways=WAYS, device="cpu", buckets=(128, 1024), **kw)


def _ns(name, tracing, tracer, journeys, service, memory, base, cache, models, response, stats,
        time_mod, http, health, fallback, overload, deadline, engine, slab_cache, backend):
    return types.SimpleNamespace(
        name=name, tracing=tracing, tracer=tracer, journeys=journeys, service=service, memory=memory,
        base=base, cache=cache, models=models, response=response, stats=stats, time=time_mod, http=http,
        health=health, fallback=fallback, overload=overload, deadline=deadline, engine=engine,
        slab_cache=slab_cache, backend=backend,
    )


PKGS = {
    "jax": _ns("jax", j_tracing, j_tracer, j_journeys, j_service, j_memory, j_base, j_cache, j_models,
               j_response, j_stats, j_time, j_http, j_health, j_fallback, j_overload, j_deadline,
               _jax_engine, _jax_slab_cache, "tpu"),
    "port": _ns("port", p_tracing, p_tracer, p_journeys, p_service, p_memory, p_base, p_cache, p_models,
                p_response, p_stats, p_time, p_http, p_health, p_fallback, p_overload, p_deadline,
                _port_engine, _port_slab_cache, "cuda"),
}


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def _clean_globals():
    for ns in PKGS.values():
        ns.tracing.reset_global_tracer()
        ns.journeys.set_global_recorder(None)
    yield
    for ns in PKGS.values():
        ns.tracing.reset_global_tracer()
        ns.journeys.set_global_recorder(None)


class Runtime:
    """A goruntime loader over fixed files."""

    def __init__(self, files):
        self.files = files

    def snapshot(self):
        return self

    def keys(self):
        return list(self.files)

    def get(self, key):
        return self.files[key]

    def add_update_callback(self, cb):
        pass


BASIC_RULES = "domain: basic\ndescriptors:\n  - key: k1\n    rate_limit: {unit: minute, requests_per_unit: 2}\n"


def make_service(ns, store=None, cache=None, rules=BASIC_RULES, ts=None, **kw):
    """ns's RateLimitService over `rules` (the memory backend unless
    `cache`), on a fake clock, its stats under `store` (a fresh Store of
    ns's when None)."""
    store = store if store is not None else ns.stats.Store()
    ts = ts or ns.time.FakeTimeSource(NOW0)
    base = ns.base.BaseRateLimiter(time_source=ts, jitter_rand=None)
    return ns.service.RateLimitService(
        runtime=Runtime({"config.basic": rules}),
        cache=cache if cache is not None else ns.memory.MemoryRateLimitCache(base),
        stats_scope=store.scope("ratelimit").scope("service"),
        time_source=ts,
        **kw,
    )


def request(ns, *pairs, domain="basic", hits=0):
    return ns.models.RateLimitRequest(
        domain=domain, descriptors=tuple(ns.models.Descriptor.of(p) for p in pairs), hits_addend=hits
    )


def row_block(n=2, limit=100):
    out = np.zeros((6, n), dtype=np.uint32)
    out[0] = np.arange(1, n + 1)
    out[2] = 1
    out[3] = limit
    out[4] = 60
    return out


class _Relabel:
    """Masks ids and times: each distinct id becomes its order of first
    appearance, so the span graph (parents, links) survives the mask."""

    def __init__(self):
        self.ids = {}

    def __call__(self, value):
        if not value:
            return value
        return self.ids.setdefault(value, f"id{len(self.ids)}")


def masked_spans(docs, rename=None) -> list:
    """Span documents (Span.to_json) with ids relabelled, times zeroed and
    `rename` ({old: new}) applied to tag values and log fields."""
    rename = rename or {}
    relabel = _Relabel()
    out = []
    for d in docs:
        d = json.loads(json.dumps(d))
        for key in ("trace_id", "span_id", "parent_id"):
            d[key] = relabel(d[key])
        d["start_us"] = d["duration_us"] = 0
        for entry in d["logs"]:
            entry["ts_us"] = 0
            entry["fields"] = {k: rename.get(v, v) if isinstance(v, str) else v for k, v in entry["fields"].items()}
        d["tags"] = {k: rename.get(v, v) if isinstance(v, str) else v for k, v in d["tags"].items()}
        for link in d.get("links", []):
            link["trace_id"], link["span_id"] = relabel(link["trace_id"]), relabel(link["span_id"])
        out.append(d)
    return out


def masked_zipkin(ns, spans, rename=None) -> list:
    relabel = _Relabel()
    rename = rename or {}
    out = []
    for span in spans:
        z = ns.tracer._zipkin_json(span, "svc")
        for key in ("traceId", "id", "parentId"):
            if key in z:
                z[key] = relabel(z[key])
        z["timestamp"] = z["duration"] = 0
        z["tags"] = {k: rename.get(v, v) for k, v in z["tags"].items()}
        for a in z["annotations"]:
            a["timestamp"] = 0
            for old, new in rename.items():
                a["value"] = a["value"].replace(old, new)
        out.append(z)
    return out


# -- tests/test_tracing.py's cases on both tracers ----------------------------


def test_basic_span(pkg):
    tracer = pkg.tracing.RecordingTracer()
    span = tracer.start_span("op")
    span.set_tag("backend", pkg.backend)
    span.log_kv(event="DoLimit.start", limits_count=3)
    time.sleep(0.01)
    span.finish()
    (got,) = tracer.finished_spans()
    assert got.operation_name == "op"
    assert got.tags == {"backend": pkg.backend}
    assert got.logs[0][1] == {"event": "DoLimit.start", "limits_count": 3}
    assert got.finish_time >= got.start_time
    assert 0.005 < got.duration < 5.0


def test_child_span_shares_trace_id(pkg):
    tracer = pkg.tracing.RecordingTracer()
    parent = tracer.start_span("parent")
    child = tracer.start_span("child", child_of=parent)
    assert child.context.trace_id == parent.context.trace_id
    assert child.context.span_id != parent.context.span_id
    assert child.parent_id == parent.context.span_id


def test_with_statement_finishes_and_marks_error(pkg):
    tracer = pkg.tracing.RecordingTracer()
    with pytest.raises(ValueError):
        with tracer.start_span("boom"):
            raise ValueError("nope")
    (got,) = tracer.finished_spans()
    assert got.tags["error"] is True
    assert any(f.get("event") == "error" for _, f in got.logs)


def test_double_finish_records_once(pkg):
    tracer = pkg.tracing.RecordingTracer()
    span = tracer.start_span("op")
    span.finish()
    span.finish()
    assert len(tracer.finished_spans()) == 1


def test_ring_bound(pkg):
    tracer = pkg.tracing.RecordingTracer(max_spans=4)
    for i in range(10):
        tracer.start_span(f"op{i}").finish()
    assert [s.operation_name for s in tracer.finished_spans()] == ["op6", "op7", "op8", "op9"]


def test_active_span_contextvar(pkg):
    tracer = pkg.tracing.RecordingTracer()
    assert pkg.tracing.active_span() is None
    with tracer.start_span("op") as span, pkg.tracing.activate(span):
        assert pkg.tracing.active_span() is span
    assert pkg.tracing.active_span() is None


def test_active_spans_of_the_two_packages_are_separate():
    tracer = p_tracing.RecordingTracer()
    with tracer.start_span("op") as span, p_tracing.activate(span):
        assert p_tracing.active_span() is span
        assert j_tracing.active_span() is None


def test_unsampled_spans_not_recorded(pkg):
    tracer = pkg.tracing.RecordingTracer()
    with tracer.start_span("unsampled", child_of=pkg.tracing.SpanContext(trace_id=5, span_id=6, sampled=False)):
        pass
    assert tracer.finished_spans() == []


def test_noop_span_not_activated(pkg):
    span = pkg.tracing.NoopTracer().start_span("op")
    with pkg.tracing.activate(span):
        assert pkg.tracing.active_span() is None


def test_noop_tracer_is_free(pkg):
    tracer = pkg.tracing.NoopTracer()
    span = tracer.start_span("op")
    assert span is tracer.start_span("other")
    span.set_tag("k", "v").log_kv(event="e").set_error(ValueError())
    span.finish()
    assert span.tags == {} and span.logs == []


def test_b3_roundtrip(pkg):
    ctx = pkg.tracing.SpanContext(trace_id=0xABC123, span_id=0xDEF456, sampled=True)
    carrier: dict[str, str] = {}
    pkg.tracing.inject(ctx, carrier)
    assert pkg.tracing.extract(carrier) == ctx


def test_b3_extract_case_insensitive_and_64bit(pkg):
    got = pkg.tracing.extract({"X-B3-TraceId": "00000000000000ab", "X-B3-SpanId": "00000000000000cd"})
    assert (got.trace_id, got.span_id, got.sampled) == (0xAB, 0xCD, True)


def test_b3_extract_sampled_zero(pkg):
    carrier = {}
    pkg.tracing.inject(pkg.tracing.SpanContext(trace_id=1, span_id=2, sampled=False), carrier)
    assert pkg.tracing.extract(carrier).sampled is False


@pytest.mark.parametrize(
    "carrier",
    [
        {},
        {"x-b3-traceid": "zz", "x-b3-spanid": "0000000000000001"},
        {"x-b3-traceid": "abc", "x-b3-spanid": "0000000000000001"},
        {"x-b3-traceid": "0" * 32, "x-b3-spanid": "0" * 16},
        {"x-b3-traceid": "0" * 32},
    ],
)
def test_b3_extract_invalid_returns_none(pkg, carrier):
    assert pkg.tracing.extract(carrier) is None


def test_b3_extract_from_tuples(pkg):
    got = pkg.tracing.extract([("x-b3-traceid", "0" * 31 + "1"), ("x-b3-spanid", "0" * 15 + "2")])
    assert (got.trace_id, got.span_id) == (1, 2)


def test_env_disabled_by_default(pkg, monkeypatch):
    for var in (pkg.tracer.TRACING_ENABLED_ENV, pkg.tracer.LIGHTSTEP_ENABLED_ENV):
        monkeypatch.delenv(var, raising=False)
    assert isinstance(pkg.tracing.tracer_from_env(), pkg.tracing.NoopTracer)


def test_env_enabled_without_collector_records(pkg, monkeypatch):
    monkeypatch.setenv(pkg.tracer.TRACING_ENABLED_ENV, "true")
    for var in (pkg.tracer.TRACING_HOST_ENV, pkg.tracer.LIGHTSTEP_HOST_ENV, pkg.tracer.TRACING_ZIPKIN_URL_ENV):
        monkeypatch.delenv(var, raising=False)
    assert isinstance(pkg.tracing.tracer_from_env(), pkg.tracing.RecordingTracer)


def test_env_reference_lightstep_names_accepted(pkg, monkeypatch):
    monkeypatch.delenv(pkg.tracer.TRACING_ENABLED_ENV, raising=False)
    monkeypatch.delenv(pkg.tracer.TRACING_ZIPKIN_URL_ENV, raising=False)
    monkeypatch.setenv(pkg.tracer.LIGHTSTEP_ENABLED_ENV, "1")
    assert isinstance(pkg.tracing.tracer_from_env(), pkg.tracing.RecordingTracer)


def test_env_bad_bool_raises(pkg, monkeypatch):
    monkeypatch.setenv(pkg.tracer.TRACING_ENABLED_ENV, "banana")
    with pytest.raises(ValueError):
        pkg.tracing.tracer_from_env()


def test_env_enabled_with_collector(pkg, monkeypatch):
    monkeypatch.setenv(pkg.tracer.TRACING_ENABLED_ENV, "true")
    monkeypatch.delenv(pkg.tracer.TRACING_ZIPKIN_URL_ENV, raising=False)
    monkeypatch.setenv(pkg.tracer.TRACING_HOST_ENV, "localhost")
    monkeypatch.setenv(pkg.tracer.TRACING_PORT_ENV, "9999")
    tracer = pkg.tracing.tracer_from_env()
    try:
        assert isinstance(tracer, pkg.tracing.CollectorTracer)
    finally:
        tracer.close()


def test_env_selects_zipkin(pkg, monkeypatch):
    monkeypatch.setenv(pkg.tracer.TRACING_ENABLED_ENV, "true")
    monkeypatch.setenv(pkg.tracer.TRACING_ZIPKIN_URL_ENV, "http://localhost:9411")
    built = pkg.tracer.tracer_from_env()
    try:
        assert isinstance(built, pkg.tracer.ZipkinTracer)
        assert built._url == "http://localhost:9411/api/v2/spans"
    finally:
        built.close()


def test_collector_spans_ship_as_json_lines(pkg):
    received: list[bytes] = []
    done = threading.Event()
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    port = listener.getsockname()[1]

    def accept():
        conn, _ = listener.accept()
        with conn:
            while chunk := conn.recv(65536):
                received.append(chunk)
        done.set()

    threading.Thread(target=accept, daemon=True).start()
    tracer = pkg.tracing.CollectorTracer("127.0.0.1", port, token="tok", flush_interval=0.05)
    with tracer.start_span("exported") as span:
        span.set_tag("backend", pkg.backend)
    tracer.close(timeout=2.0)
    listener.close()
    assert done.wait(2.0)
    payload = json.loads(b"".join(received).decode().strip().splitlines()[0])
    assert payload["span"]["operation_name"] == "exported"
    assert payload["access_token"] == "tok"
    assert payload["component"] == "apigw-ratelimit"


def test_collector_unreachable_drops_without_error(pkg):
    tracer = pkg.tracing.CollectorTracer("127.0.0.1", 1, flush_interval=0.05)
    tracer.start_span("dropped").finish()
    time.sleep(0.2)
    tracer.close(timeout=2.0)


def zipkin_collector():
    """A local Zipkin-compatible collector: (server, [(path, headers,
    body)])."""
    import http.server

    received = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802
            body = self.rfile.read(int(self.headers["Content-Length"]))
            received.append((self.path, dict(self.headers), json.loads(body)))
            self.send_response(202)
            self.end_headers()

        def log_message(self, *a):
            pass

    server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, received


def test_zipkin_spans_posted_as_v2(pkg):
    server, received = zipkin_collector()
    try:
        tracer = pkg.tracer.ZipkinTracer(f"http://127.0.0.1:{server.server_port}", token="tok", flush_interval=0.05)
        parent = tracer.start_span("ShouldRateLimit", tags={"backend": pkg.backend})
        child = tracer.start_span("DoLimit", child_of=parent)
        child.log_kv(event="lookup.start", batch_items=3)
        child.finish()
        parent.finish()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and sum(len(b) for _, _, b in received) < 2:
            time.sleep(0.02)
        tracer.close()
    finally:
        server.shutdown()
    spans = [s for _, _, batch in received for s in batch]
    assert len(spans) == 2
    path, headers, _ = received[0]
    assert path == "/api/v2/spans" and headers.get("Authorization") == "Bearer tok"
    by_name = {s["name"]: s for s in spans}
    p, c = by_name["ShouldRateLimit"], by_name["DoLimit"]
    assert c["traceId"] == p["traceId"] and c["parentId"] == p["id"]
    assert p["tags"]["backend"] == pkg.backend
    assert c["annotations"] and "lookup.start" in c["annotations"][0]["value"]
    assert p["duration"] >= 1 and isinstance(p["timestamp"], int)


def test_zipkin_collector_down_never_blocks_requests(pkg):
    tracer = pkg.tracer.ZipkinTracer("http://127.0.0.1:1", flush_interval=0.05)
    for _ in range(100):
        tracer.start_span("op").finish()
    time.sleep(0.2)
    tracer.close()


def _traced(ns, fn):
    """Run fn() inside an "rpc" span of a fresh RecordingTracer registered
    globally; returns (tracer, the rpc span, fn's exception or None)."""
    tracer = ns.tracing.RecordingTracer()
    ns.tracing.set_global_tracer(tracer)
    err = None
    try:
        with tracer.start_span("rpc") as span, ns.tracing.activate(span):
            fn()
    except Exception as e:  # noqa: BLE001 (the caller checks it)
        err = e
    return tracer, span, err


def test_service_worker_logs_and_backend_tag(pkg):
    service = make_service(pkg)
    tracer, _span, err = _traced(pkg, lambda: service.should_rate_limit(request(pkg, ("k1", "v1"))))
    assert err is None
    (got,) = tracer.finished_spans()
    events = [f.get("event") for _, f in got.logs]
    assert "shouldRateLimitWorker.start" in events and "shouldRateLimitWorker.done" in events
    assert got.tags.get("backend") == "memory"
    done = [f for _, f in got.logs if f.get("event") == "shouldRateLimitWorker.done"]
    assert done[0]["response_code"] == 1


def test_service_error_marks_span(pkg):
    service = make_service(pkg)
    tracer, _span, err = _traced(pkg, lambda: service.should_rate_limit(pkg.models.RateLimitRequest(domain="", descriptors=[])))
    assert isinstance(err, pkg.service.ServiceError)
    (got,) = tracer.finished_spans()
    assert got.tags["error"] is True


def test_sleep_on_throttle_child_span(pkg):
    service = make_service(pkg, max_sleeping_routines=2)
    resp = pkg.response.DoLimitResponse()
    resp.throttle_millis = 250
    tracer, span, err = _traced(pkg, lambda: service._maybe_sleep(resp))
    assert err is None
    (throttle,) = [s for s in tracer.finished_spans() if s.operation_name == "sleep_on_throttle"]
    assert throttle.tags["throttling.sleep_ms"] == 250
    assert throttle.parent_id == span.context.span_id
    assert resp.throttle_millis == 0


def test_sleep_semaphore_exhausted_tags_error(pkg):
    service = make_service(pkg, max_sleeping_routines=1)
    assert service._sleeper_semaphore.acquire(blocking=False)
    resp = pkg.response.DoLimitResponse()
    resp.throttle_millis = 250
    tracer, _span, _err = _traced(pkg, lambda: service._maybe_sleep(resp))
    (throttle,) = [s for s in tracer.finished_spans() if s.operation_name == "sleep_on_throttle"]
    assert throttle.tags.get("error") is True
    assert "throttling.sem_exhausted" in [f.get("event") for _, f in throttle.logs]
    assert resp.throttle_millis == 250


@pytest.mark.parametrize("exc_name", ["QueueFullError", "DeadlineExceededError", "CacheError"])
def test_slab_do_limit_exception_tags_error(pkg, exc_name):
    """The slab cache's do_limit and do_limit_resolved spans carry the error
    tag on every failure of the submit."""
    exc_cls = getattr(pkg.overload, exc_name, None) or getattr(pkg.cache, exc_name)
    ts = pkg.time.FakeTimeSource(NOW0)
    cache = pkg.slab_cache(pkg.base.BaseRateLimiter(ts, jitter_rand=None), hotkey_lanes=0)

    def boom(*_a, **_k):
        raise exc_cls("boom")

    if pkg.name == "jax":
        cache._submit_rows = boom
        cache._engine_core.submit = boom
    else:
        cache.engine.submit_rows = boom
    service = make_service(pkg, cache=cache)
    tracer, _span, err = _traced(pkg, lambda: service.should_rate_limit(request(pkg, ("k1", "v"))))
    assert isinstance(err, exc_cls)
    (got,) = tracer.finished_spans()
    assert got.tags.get("error") is True and got.tags.get("backend") == pkg.backend
    assert any(f.get("event") == "error" for _, f in got.logs)


# -- the span documents of the two packages, masked ---------------------------

RENAME = {"tpu": "cuda", "tpu.lookup.done": "cuda.lookup.done"}

SLAB_RULES = (
    "domain: basic\ndescriptors:\n"
    "  - key: k1\n    rate_limit: {unit: minute, requests_per_unit: 2}\n"
    "  - key: s\n    rate_limit: {unit: minute, requests_per_unit: 3, algorithm: sliding_window}\n"
)


def _service_spans(ns, store, slab: bool, host_fast_path: bool):
    ts = ns.time.FakeTimeSource(NOW0)
    cache = ns.slab_cache(ns.base.BaseRateLimiter(ts, jitter_rand=None), hotkey_lanes=0) if slab else None
    service = make_service(ns, store, cache=cache, rules=SLAB_RULES, ts=ts, host_fast_path=host_fast_path)
    # warm both programs (the fixed-window step, then the multi-algorithm
    # one the sliding-window rule flips to) on keys the traced requests do
    # not use, untraced: the JAX package compiles each on first use, and a
    # first request slower than the latency ladder's top bucket (2.5 s,
    # under a loaded CPU) would be force-sampled in one package alone
    for pairs in ((("k1", "warm"),), (("s", "warm"),)):
        service.should_rate_limit(request(ns, *pairs))
    tracer = ns.tracing.RecordingTracer()
    ns.tracing.set_global_tracer(tracer)
    reqs = [
        request(ns, ("k1", "a")),
        request(ns, ("k1", "a"), ("k1", "b"), hits=2),
        request(ns, ("s", "x"), ("nomatch", "1")),
        request(ns, ("k1", "a")),
        ns.models.RateLimitRequest(domain="", descriptors=[]),
    ]
    for i, req in enumerate(reqs):
        carrier = {"x-b3-traceid": f"{i + 1:032x}", "x-b3-spanid": f"{i + 7:016x}", "x-b3-sampled": "1"}
        parent = ns.tracing.extract(carrier)
        try:
            with tracer.start_span("ShouldRateLimit", child_of=parent, tags={"span.kind": "server"}) as span:
                with ns.tracing.activate(span):
                    service.should_rate_limit(req)
        except ns.service.ServiceError:
            pass
    return tracer.finished_spans()


@pytest.mark.parametrize("host_fast_path", [True, False], ids=["fast_path", "trie"])
@pytest.mark.parametrize("slab", [False, True], ids=["memory", "slab"])
def test_service_span_documents_match(slab, host_fast_path):
    want = _service_spans(PKGS["jax"], j_stats.Store(), slab, host_fast_path)
    got = _service_spans(PKGS["port"], p_stats.Store(), slab, host_fast_path)
    assert masked_spans([s.to_json() for s in got]) == masked_spans([s.to_json() for s in want], RENAME)
    assert masked_zipkin(PKGS["port"], got) == masked_zipkin(PKGS["jax"], want, RENAME)
    assert len(got) == 5 and got[-1].tags["error"] is True


def _dispatch_spans(ns, fail: bool):
    """Three requests, one after another, through the dispatch loop, each
    in its own traced request span (the second unsampled), then a launch
    that fails when `fail`."""
    tracer = ns.tracing.RecordingTracer()
    ns.tracing.set_global_tracer(tracer)
    engine = ns.engine(ns.time.FakeTimeSource(NOW0), window=0.002, dispatch_loop=True)
    try:
        for i in range(3):
            parent = ns.tracing.SpanContext(trace_id=i + 1, span_id=i + 100, sampled=i != 1)
            with tracer.start_span(f"request-{i}", child_of=parent) as span, ns.tracing.activate(span):
                engine.submit_rows(row_block(n=i + 1))
        if fail:
            def boom(_blocks):
                raise ns.cache.CacheError("launch failed")

            engine.dispatch_loop._launch = boom
            with pytest.raises(ns.cache.CacheError):
                with tracer.start_span("request-fail") as span, ns.tracing.activate(span):
                    engine.submit_rows(row_block())
    finally:
        engine.close()
    # the owner finishes dispatch.batch after the ticket wakes its caller:
    # order the documents by the request each belongs to (a batch span by
    # the request it links), not by finish order
    order = {"dispatch.batch": 0, "dispatch.ring_wait": 1, "dispatch.pack": 2, "dispatch.launch": 3, "dispatch.redeem": 4}

    def key(span):
        trace = span.links[0].trace_id if span.links else span.context.trace_id
        return trace, order.get(span.operation_name, 9)

    return sorted(tracer.finished_spans(), key=key)


# the port's owner-cycle children of dispatch.batch and the launch tags it
# gives that span (backends/dispatch.py), which the reference does not record
PORT_OWNER_SPANS = frozenset({
    "dispatch.wait", "dispatch.linger", "dispatch.take", "dispatch.scatter", "dispatch.turn",
    "engine.operand_wait", "engine.pack", "engine.promote", "engine.step_enqueue",
    "engine.readback_enqueue", "engine.fence_wait", "engine.copy",
})
PORT_BATCH_TAGS = ("device_launches", "chunk_rows", "clock_now", "owner_cpu_us")


def reference_docs(spans) -> list:
    """The port's span documents as the reference records them: the
    owner-cycle spans and the batch span's launch tags filtered out."""
    docs = []
    for s in spans:
        if s.operation_name in PORT_OWNER_SPANS:
            continue
        d = s.to_json()
        if s.operation_name == "dispatch.batch":
            d["tags"] = {k: v for k, v in d["tags"].items() if k not in PORT_BATCH_TAGS}
        docs.append(d)
    return docs


@pytest.mark.parametrize("fail", [False, True], ids=["served", "failed_launch"])
def test_dispatch_span_documents_match(fail):
    want = _dispatch_spans(PKGS["jax"], fail)
    got = _dispatch_spans(PKGS["port"], fail)
    docs = reference_docs(got)
    assert [d["operation_name"] for d in docs] == [s.operation_name for s in want]
    assert masked_spans(docs) == masked_spans([s.to_json() for s in want])
    names = [s.operation_name for s in got]
    # every launch records a batch span linked to its request; an unsampled
    # request records neither itself nor its stage spans
    assert names.count("dispatch.batch") == 3 + fail and "request-1" not in names
    assert names.count("dispatch.redeem") == 2


def test_owner_spans_lie_on_the_profilers_clock():
    """The owner's cycle spans take their epoch start through the process's
    one anchor (tracing/tracer.py epoch_s), the clock torch.profiler stamps
    its timeline in (trace_start_ns() plus each event's relative us). Under
    the profiler (every thread's CPU ops), at least 95% of the owner
    thread's top-level aten ops in the window lie inside one of its cycle
    spans, within 100 us."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import test_torch_dispatch as D

    tracer = p_tracing.RecordingTracer(1 << 16, keep_unsampled=True)
    p_tracing.set_global_tracer(tracer)
    eng = D._owner_engine()
    hold = threading.Event()
    frontends = D._frontends(eng, threads=3, blocks=4, hold=hold)
    try:
        assert D._wait_for(lambda: eng.dispatch_loop.launches >= 5, timeout=30)
        prof = profile(activities=[ProfilerActivity.CPU],
                       experimental_config=torch._C._profiler._ExperimentalConfig(profile_all_threads=True))
        prof.start()
        launches = eng.dispatch_loop.launches
        assert D._wait_for(lambda: eng.dispatch_loop.launches >= launches + 20, timeout=30)
        prof.stop()
    finally:
        hold.set()
        for t in frontends:
            t.join(30)
        eng.close()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    ops: dict = {}
    for e in prof.events():
        if e.cpu_parent is None and e.name.startswith("aten::"):
            ops.setdefault(e.thread, []).append((start_ns + e.time_range.start * 1e3, start_ns + e.time_range.end * 1e3))
    owner = max(ops.values(), key=len)  # the frontends and this thread run no aten op
    spans = sorted(
        (s.start_time * 1e9, (s.start_time + s.duration) * 1e9)
        for s in tracer.finished_spans()
        if s.operation_name in PORT_OWNER_SPANS
    )
    starts = np.array([a for a, _ in spans])
    slack = 100e3  # ns
    inside = 0
    for a, b in owner:
        i = int(np.searchsorted(starts, a + slack, side="right")) - 1
        inside += any(s - slack <= a and b <= e + slack for s, e in spans[max(0, i - 3) : i + 1])
    print(f"owner aten ops inside a cycle span: {inside} of {len(owner)}")
    assert len(owner) >= 100
    assert inside >= 0.95 * len(owner), (inside, len(owner))
