"""The port's journey recorder (tracing/journeys.py) and its stage marks in
the engine, the batcher and the dispatch loop, against the JAX package's on
the CPU (`pkg` is "jax" or "port"; helpers from tests/test_torch_tracing.py).

* tests/test_journeys.py's recorder, connected-trace, dispatch-telemetry,
  service-journey and debug-endpoint cases on both packages.
* The stage lists of one request through the direct, dispatch-loop and
  leader-collects arms, equal to the JAX package's.
* The service's journeys over the slab engine (stages, the per-algorithm
  stage of a denial, flags), masked, equal to the JAX package's.
* FLAG_HOTKEY on a request touching a key the last sketch drain ranked hot.
* /debug/profile capturing a torch.profiler trace on the CPU.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import pytest

pytest.importorskip("torch")

from test_torch_tracing import (  # noqa: E402
    NOW0,
    PKGS,
    _clean_globals,  # noqa: F401 (autouse fixture)
    make_service,
    pkg,  # noqa: F401 (fixture)
    request,
    row_block,
)

from api_ratelimit_tpu_torch.testing.faults import FaultInjector  # noqa: E402


def _new_debug_server(ns, store, **kw):
    """Each package's new_debug_server (the JAX one takes host and port
    first)."""
    if ns.name == "jax":
        return ns.http.new_debug_server("127.0.0.1", 0, store, **kw)
    return ns.http.new_debug_server(store, **kw)


def _get(port, path, timeout=10):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as resp:
        return resp.status, resp.read()


# -- the recorder --------------------------------------------------------------


def test_begin_mark_finish_and_stage_order(pkg):
    rec = pkg.journeys.JourneyRecorder(slow_ms=1e9)
    j = rec.begin("request", trace_id=0xAB, span_id=0xCD)
    assert rec.current() is j
    for stage in pkg.journeys.STAGES:
        j.mark(stage)
    assert rec.finish(j, 1.5) is False
    assert rec.current() is None
    assert set(j.stages) == set(pkg.journeys.STAGES)
    assert j.duration_ms == 1.5


@pytest.mark.parametrize("flag", ["shed", "deadline", "fault", "over_limit", "hotkey"])
def test_outcome_flags_promote(pkg, flag):
    rec = pkg.journeys.JourneyRecorder(slow_ms=1e9)
    assert rec.finish(rec.begin("request"), 0.1, flags=(flag,)) is True
    (got,) = rec.retained()
    assert flag in got.flags


def test_slow_threshold_promotes(pkg):
    rec = pkg.journeys.JourneyRecorder(slow_ms=10.0)
    assert rec.finish(rec.begin("request"), 5.0) is False
    assert rec.finish(rec.begin("request"), 50.0) is True
    (got,) = rec.retained()
    assert "slow" in got.flags


def test_live_p99_promotion_when_knob_zero(pkg):
    rec = pkg.journeys.JourneyRecorder(slow_ms=0.0)
    for _ in range(256):
        rec.finish(rec.begin("request"), 1.0)
    assert rec.finish(rec.begin("request"), 500.0) is True
    assert any("slow" in j.flags for j in rec.retained())
    assert rec.live_p99_ms == 1.0


def test_note_flag_merges_at_finish(pkg):
    rec = pkg.journeys.JourneyRecorder(slow_ms=1e9)
    pkg.journeys.set_global_recorder(rec)
    j = rec.begin("request")
    pkg.journeys.note_flag(pkg.journeys.FLAG_SHED)
    rec.finish(j, 0.1)
    (got,) = rec.retained()
    assert "shed" in got.flags


def test_retained_buffer_bounded(pkg):
    rec = pkg.journeys.JourneyRecorder(slow_ms=1e9, retain=4)
    for _ in range(10):
        rec.finish(rec.begin("request"), 0.1, flags=("fault",))
    assert len(rec.retained()) == 4


def test_snapshot_and_json_shape(pkg):
    rec = pkg.journeys.JourneyRecorder(slow_ms=1e9)
    j = rec.begin("request", trace_id=7)
    j.mark("publish", 100)
    rec.finish(j, 0.2, flags=("fault",))
    snap = json.loads(rec.dump_json())
    assert snap["enabled"] is True
    (retained,) = snap["retained"]
    assert retained["trace_id"].endswith("7")
    assert retained["stages"]["publish"] == 100
    assert retained["flags"] == ["fault"]
    assert snap["recent"]


def test_module_hooks_noop_when_unregistered(pkg):
    assert pkg.journeys.begin_request() is None
    pkg.journeys.mark("publish")
    pkg.journeys.merge_owner_stages((1, 2, 3, 4, 5))
    pkg.journeys.note_flag("fault")
    assert pkg.journeys.recording() is False


def test_junk_config_rejected(pkg):
    for kw in ({"retain": 0}, {"ring": -1}, {"slow_ms": -1.0}):
        with pytest.raises(ValueError):
            pkg.journeys.JourneyRecorder(**kw)


def test_journey_constants_are_the_reference():
    j, p = PKGS["jax"].journeys, PKGS["port"].journeys
    assert (p.STAGES, p.OWNER_STAGES, p.ALGO_STAGES) == (j.STAGES, j.OWNER_STAGES, j.ALGO_STAGES)
    for flag in ("SLOW", "SHED", "DEADLINE", "FAULT", "OVER_LIMIT", "HOTKEY"):
        assert getattr(p, "FLAG_" + flag) == getattr(j, "FLAG_" + flag)


# -- stage lists through each arm ------------------------------------------------

ARMS = {
    "direct": {"window": 0.0},
    "dispatch_loop": {"window": 0.002, "dispatch_loop": True},
    "leader_collects": {"window": 0.002, "dispatch_loop": False},
}


def _arm_stages(ns, arm):
    rec = ns.journeys.JourneyRecorder(slow_ms=1e9)
    ns.journeys.set_global_recorder(rec)
    engine = ns.engine(ns.time.FakeTimeSource(NOW0), **ARMS[arm])
    try:
        j = rec.begin("request")
        engine.submit_rows(row_block())
        rec.finish(j, 1.0)
    finally:
        engine.close()
        ns.journeys.set_global_recorder(None)
    return j


@pytest.mark.parametrize("arm", list(ARMS))
def test_stage_lists_equal_the_reference(arm):
    want = _arm_stages(PKGS["jax"], arm)
    got = _arm_stages(PKGS["port"], arm)
    assert list(got.stages) == list(want.stages) == list(PKGS["port"].journeys.STAGES)
    times = [got.stages[s] for s in PKGS["port"].journeys.STAGES]
    assert times == sorted(times)


# -- connected trace and dispatch telemetry ----------------------------------------


def test_dispatch_loop_yields_one_connected_trace(pkg):
    tracer = pkg.tracing.RecordingTracer()
    pkg.tracing.set_global_tracer(tracer)
    engine = pkg.engine(pkg.time.FakeTimeSource(NOW0), window=0.002)
    try:
        request_span = tracer.start_span("request")
        with request_span, pkg.tracing.activate(request_span):
            assert engine.submit_rows(row_block()).shape == (2,)
    finally:
        engine.close()
    spans = {s.operation_name: s for s in tracer.finished_spans()}
    for stage in ("ring_wait", "pack", "launch", "redeem"):
        child = spans[f"dispatch.{stage}"]
        assert child.context.trace_id == request_span.context.trace_id
        assert child.parent_id == request_span.context.span_id
    batch = spans["dispatch.batch"]
    assert [c.span_id for c in batch.links] == [request_span.context.span_id]
    assert batch.tags["batch_items"] == 2


def test_batch_span_links_every_coalesced_request(pkg):
    tracer = pkg.tracing.RecordingTracer()
    pkg.tracing.set_global_tracer(tracer)
    engine = pkg.engine(pkg.time.FakeTimeSource(NOW0), window=0.01)
    barrier = threading.Barrier(3)
    span_ids, lock = [], threading.Lock()

    def caller(i):
        span = tracer.start_span(f"request-{i}")
        with lock:
            span_ids.append(span.context.span_id)
        with span, pkg.tracing.activate(span):
            barrier.wait()
            engine.submit_rows(row_block(n=1))

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(3)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
    finally:
        engine.close()
    assert not any(t.is_alive() for t in threads)
    batches = [s for s in tracer.finished_spans() if s.operation_name == "dispatch.batch"]
    assert batches
    assert {c.span_id for b in batches for c in b.links} == set(span_ids)


def test_untraced_requests_build_no_spans(pkg):
    tracer = pkg.tracing.RecordingTracer()
    pkg.tracing.set_global_tracer(tracer)
    engine = pkg.engine(pkg.time.FakeTimeSource(NOW0), window=0.002)
    try:
        engine.submit_rows(row_block())
    finally:
        engine.close()
    assert tracer.finished_spans() == []


def test_ring_wait_exemplar_attached_for_traced_slow_frame(pkg):
    # a one-boundary ladder: every value lands in the overflow bucket
    store = pkg.stats.Store(pkg.stats.TestSink(), latency_buckets=(1e-9,))
    tracer = pkg.tracing.RecordingTracer()
    pkg.tracing.set_global_tracer(tracer)
    engine = pkg.engine(pkg.time.FakeTimeSource(NOW0), window=0.002, scope=store.scope("ratelimit"))
    try:
        span = tracer.start_span("request")
        with span, pkg.tracing.activate(span):
            engine.submit_rows(row_block())
    finally:
        engine.close()
    hists = store.metrics_snapshot()["histograms"]
    want = f"{span.context.trace_id:032x}"
    for name in ("ratelimit.dispatch.ring_wait_ms", "ratelimit.dispatch.launch_ms", "ratelimit.dispatch.redeem_ms"):
        assert hists[name]["count"] >= 1
        assert hists[name]["exemplar"]["trace_id"] == want, name


def test_dispatch_launch_fault_logs_kind_on_batch_span(pkg):
    tracer = pkg.tracing.RecordingTracer()
    pkg.tracing.set_global_tracer(tracer)
    injector = FaultInjector()
    engine = pkg.engine(pkg.time.FakeTimeSource(NOW0), window=0.002, fault_injector=injector)
    injector.configure("dispatch.launch:error:1.0")
    try:
        span = tracer.start_span("request")
        with pytest.raises(pkg.cache.CacheError):
            with span, pkg.tracing.activate(span):
                engine.submit_rows(row_block())
    finally:
        injector.clear()
        engine.close()
    batches = [s for s in tracer.finished_spans() if s.operation_name == "dispatch.batch"]
    faults = [f for _, f in batches[0].logs if f.get("event") == "fault"]
    assert faults and faults[0]["kind"] == "error" and faults[0]["site"] == "dispatch.launch"
    assert batches[0].tags.get("error") is True


# -- the service's journeys --------------------------------------------------------


def test_over_limit_journey_promoted(pkg):
    rec = pkg.journeys.JourneyRecorder(slow_ms=1e9)
    pkg.journeys.set_global_recorder(rec)
    service = make_service(pkg)
    for _ in range(3):
        service.should_rate_limit(request(pkg, ("k1", "v1")))
    retained = rec.retained()
    assert retained and "over_limit" in retained[-1].flags
    assert retained[-1].kind == "request"


def test_fault_journey_promoted(pkg):
    class BoomCache:
        def do_limit(self, request, limits):
            raise pkg.cache.CacheError("backend down")

        def flush(self):
            pass

    rec = pkg.journeys.JourneyRecorder(slow_ms=1e9)
    pkg.journeys.set_global_recorder(rec)
    service = make_service(pkg, cache=BoomCache())
    with pytest.raises(pkg.cache.CacheError):
        service.should_rate_limit(request(pkg, ("k1", "v1")))
    (got,) = rec.retained()
    assert "fault" in got.flags


def test_journey_carries_trace_id_of_active_span(pkg):
    rec = pkg.journeys.JourneyRecorder(slow_ms=1e9)
    pkg.journeys.set_global_recorder(rec)
    tracer = pkg.tracing.RecordingTracer()
    pkg.tracing.set_global_tracer(tracer)
    service = make_service(pkg)
    with tracer.start_span("rpc") as span, pkg.tracing.activate(span):
        service.should_rate_limit(request(pkg, ("k1", "v1")))
    recorded = [j for ring in rec.snapshot()["recent"].values() for j in ring]
    assert recorded[-1]["trace_id"] == f"{span.context.trace_id:032x}"


def test_slow_request_exemplar_and_forced_sample(pkg):
    """A request in the latency histogram's overflow bucket attaches its
    trace id as the exemplar and force-samples an unsampled span."""
    store = pkg.stats.Store(pkg.stats.TestSink(), latency_buckets=(1e-9,))
    tracer = pkg.tracing.RecordingTracer()
    pkg.tracing.set_global_tracer(tracer)
    service = make_service(pkg, store=store)
    parent = pkg.tracing.SpanContext(trace_id=42, span_id=43, sampled=False)
    with tracer.start_span("rpc", child_of=parent) as span, pkg.tracing.activate(span):
        service.should_rate_limit(request(pkg, ("k1", "v1")))
    (got,) = tracer.finished_spans()
    assert got.forced_sample and got.tags["sampling.forced"] is True
    hist = store.metrics_snapshot()["histograms"]["ratelimit.service.call.should_rate_limit.latency_ms"]
    assert hist["exemplar"]["trace_id"] == f"{42:032x}"


SLAB_RULES = (
    "domain: basic\ndescriptors:\n"
    "  - key: k1\n    rate_limit: {unit: minute, requests_per_unit: 2}\n"
    "  - key: s\n    rate_limit: {unit: minute, requests_per_unit: 1, algorithm: sliding_window}\n"
    "  - key: g\n    rate_limit: {unit: minute, requests_per_unit: 1, algorithm: gcra}\n"
)


def _masked_journeys(ns, arm, hotkey_lanes=0):
    """The journeys of a short stream through ns's service over the slab
    engine in `arm`, with ids, times and thread names masked."""
    rec = ns.journeys.JourneyRecorder(slow_ms=1e9)
    ns.journeys.set_global_recorder(rec)
    ts = ns.time.FakeTimeSource(NOW0)
    kw = ARMS[arm]
    cache = ns.slab_cache(
        ns.base.BaseRateLimiter(ts, jitter_rand=None),
        hotkey_lanes=hotkey_lanes,
        batch_window_seconds=kw["window"],
        dispatch_loop=kw.get("dispatch_loop", True),
        # the per-algorithm counters: the algo_* stage rides beside them
        stats_scope=ns.stats.Store().scope("ratelimit"),
    )
    service = make_service(ns, cache=cache, rules=SLAB_RULES, ts=ts)
    try:
        for pairs in ([("k1", "a")], [("k1", "a")], [("k1", "a")], [("s", "x"), ("g", "y")], [("s", "x")], [("g", "y")], [("nope", "1")]):
            service.should_rate_limit(request(ns, *pairs))
    finally:
        cache.close()
    out = []
    for j in rec.snapshot()["recent"].popitem()[1]:
        out.append({"kind": j["kind"], "stages": sorted(j["stages"]), "flags": j["flags"]})
    return out


@pytest.mark.parametrize("arm", list(ARMS))
def test_service_journeys_equal_the_reference(arm):
    want = _masked_journeys(PKGS["jax"], arm)
    got = _masked_journeys(PKGS["port"], arm)
    assert got == want
    stages = set(PKGS["port"].journeys.STAGES)
    assert all(stages <= set(j["stages"]) for j in got[:-1])
    assert [("over_limit" in j["flags"]) for j in got] == [False, False, True, False, True, True, False]
    assert "algo_sliding_window" in got[4]["stages"] and "algo_gcra" in got[5]["stages"]
    assert "algo_fixed_window" in got[2]["stages"]


def _hot_flags(ns):
    """A stream where one key dominates; then a sketch drain; then one
    request on the hot key and one on a fresh key. Returns (hot_fps before
    the drain, after it, the flags of each journey in order)."""
    rec = ns.journeys.JourneyRecorder(slow_ms=1e9)
    ns.journeys.set_global_recorder(rec)
    ts = ns.time.FakeTimeSource(NOW0)
    cache = ns.slab_cache(ns.base.BaseRateLimiter(ts, jitter_rand=None), hotkey_lanes=128, hotkey_k=4)
    engine = cache.engine
    service = make_service(ns, cache=cache, ts=ts)
    try:
        for i in range(40):
            service.should_rate_limit(request(ns, ("k1", "hot" if i % 2 == 0 else f"cold{i}")))
        before = engine.hot_fps
        engine.drain_hotkeys()
        service.should_rate_limit(request(ns, ("k1", "hot")))
        service.should_rate_limit(request(ns, ("k1", "fresh")))
    finally:
        cache.close()
    (ring,) = rec.snapshot()["recent"].values()
    return before, engine.hot_fps, [j["flags"] for j in ring]


def test_hotkey_flag_after_a_drain_and_the_listener():
    """The drain listeners (which on a mesh also feed the hot tier,
    tests/test_torch_hot_tier.py); the drain's hot set is held against the
    sketch's top-K."""
    want = _hot_flags(PKGS["jax"])
    got = _hot_flags(PKGS["port"])
    assert got[0] == want[0] == frozenset()  # no drain yet: no hot key
    assert got[1] == want[1] and len(got[1]) >= 1
    assert got[2] == want[2]
    flags = got[2]
    assert not any("hotkey" in f for f in flags[:-2])
    assert "hotkey" in flags[-2] and "hotkey" not in flags[-1]


# -- the debug endpoints -----------------------------------------------------------


def test_debug_journeys_endpoint(pkg):
    store = pkg.stats.Store()
    rec = pkg.journeys.JourneyRecorder(slow_ms=1e9)
    pkg.journeys.set_global_recorder(rec)
    rec.finish(rec.begin("request", trace_id=9), 0.5, flags=("fault",))
    server = _new_debug_server(pkg, store)
    server.serve_background()
    try:
        status, body = _get(server.port, "/debug/journeys")
    finally:
        server.shutdown()
    doc = json.loads(body)
    assert status == 200 and doc["enabled"] is True
    assert doc["retained"][0]["flags"] == ["fault"]


def test_debug_journeys_disabled_shape(pkg):
    server = _new_debug_server(pkg, pkg.stats.Store())
    server.serve_background()
    try:
        status, body = _get(server.port, "/debug/journeys")
    finally:
        server.shutdown()
    assert status == 200
    assert json.loads(body) == {"enabled": False, "retained": [], "recent": {}}


def test_debug_profile_disabled_without_dir(pkg):
    server = _new_debug_server(pkg, pkg.stats.Store())
    server.serve_background()
    try:
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            _get(server.port, "/debug/profile?ms=1")
    finally:
        server.shutdown()
    assert exc_info.value.code == 404


def test_debug_profile_captures_a_torch_trace(tmp_path):
    """On the CPU the capture records the CPU activity; the contract is the
    reference's: a JSON body {profile_dir, ms}, 400 on a bad query, 429
    while a capture runs, and the trace file in the directory."""
    import time

    profile_dir = str(tmp_path / "profiles")
    server = PKGS["port"].http.new_debug_server(PKGS["port"].stats.Store(), profile_dir=profile_dir)
    server.serve_background()
    results = {}

    def capture():
        results["first"] = _get(server.port, "/debug/profile?ms=1500", timeout=60)

    first = threading.Thread(target=capture)
    try:
        with pytest.raises(urllib.error.HTTPError) as bad:
            _get(server.port, "/debug/profile?ms=soon")
        first.start()
        time.sleep(0.5)
        with pytest.raises(urllib.error.HTTPError) as busy:
            _get(server.port, "/debug/profile?ms=1")
        first.join(60)
    finally:
        server.shutdown()
    assert not first.is_alive()
    assert bad.value.code == 400 and busy.value.code == 429
    status, body = results["first"]
    assert status == 200 and json.loads(body) == {"profile_dir": profile_dir, "ms": 1500.0}
    (trace,) = os.listdir(profile_dir)
    with open(os.path.join(profile_dir, trace)) as f:
        assert "traceEvents" in json.load(f)
