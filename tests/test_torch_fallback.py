"""The port's failure-mode ladder (backends/fallback.py) and shed postures
(service/ratelimit.py _shed_answer) against the JAX package's, on the CPU
(`pkg` is "jax" or "port"; helpers from tests/test_torch_tracing.py).

* tests/test_chaos.py's TestFailureModeLadder and tests/test_overload.py's
  shed-posture cases (the browned-out service, the backend's OverloadError,
  the sticky shed state, the stacked health probes) on both packages. The
  port's ladder has the deny and allow rungs; the reference's degraded rung
  (a decision on the CPU) is refused.
* One stream through each package's service over its slab cache while the
  engine fails every third submit: the answers, the counters and the
  /healthcheck body are equal for each of the port's rungs, and a queue-full shed never
  reaches the ladder.
* The deadline abort before dispatch.
"""

import pytest

pytest.importorskip("torch")

from test_torch_tracing import (  # noqa: E402
    NOW0,
    PKGS,
    _clean_globals,  # noqa: F401 (autouse fixture)
    make_service,
    pkg,  # noqa: F401 (fixture)
    request,
)

LADDER_RULES = "domain: chaos\ndescriptors:\n  - key: k\n    value: v\n    rate_limit: {unit: minute, requests_per_unit: 2}\n"
OVERLOAD_RULES = "domain: overload\ndescriptors:\n  - key: k\n    value: v\n    rate_limit: {unit: minute, requests_per_unit: 10}\n"


class FlakyCache:
    """Raises `error` while .down is True, else answers OK."""

    def __init__(self, ns, error=None):
        self.ns = ns
        self.down = True
        self.calls = 0
        self.error = error or ns.cache.CacheError("backend dark")

    def do_limit(self, request, limits):
        self.calls += 1
        if self.down:
            raise self.error
        r = self.ns.response
        return r.DoLimitResponse(descriptor_statuses=[r.DescriptorStatus(code=self.ns.models.Code.OK) for _ in request.descriptors])

    def flush(self):
        pass


def _ladder_service(ns, mode):
    store, sink = _store(ns)
    ts = ns.time.FakeTimeSource(1_000_000)
    cache = FlakyCache(ns)
    fallback = ns.fallback.FallbackLimiter(mode, scope=store.scope("ratelimit"))
    svc = make_service(ns, store=store, cache=cache, rules=LADDER_RULES, ts=ts, fallback=fallback)
    return svc, cache, fallback, store, sink


def _store(ns):
    sink = ns.stats.TestSink()
    return ns.stats.Store(sink), sink


def _req(ns, domain="chaos"):
    return request(ns, ("k", "v"), domain=domain, hits=1)


# -- tests/test_chaos.py TestFailureModeLadder --------------------------------------


def test_fail_open_returns_ok_and_counts_redis_error(pkg):
    svc, cache, fallback, store, sink = _ladder_service(pkg, pkg.fallback.FAILURE_MODE_ALLOW)
    Code = pkg.models.Code
    overall, statuses, _ = svc.should_rate_limit(_req(pkg))
    assert overall == Code.OK and statuses[0].code == Code.OK
    assert fallback.degraded and "mode=allow" in fallback.degraded_reason()
    store.flush()
    assert sink.counters["ratelimit.service.call.should_rate_limit.redis_error"] == 1
    assert sink.counters["ratelimit.fallback.allow"] == 1
    assert sink.gauges["ratelimit.fallback.degraded"] == 1
    cache.down = False
    assert svc.should_rate_limit(_req(pkg))[0] == Code.OK
    assert not fallback.degraded and fallback.degraded_reason() is None
    store.flush()
    assert sink.gauges["ratelimit.fallback.degraded"] == 0


def test_deny_mode_denies_all(pkg):
    svc, _, _, store, sink = _ladder_service(pkg, pkg.fallback.FAILURE_MODE_DENY)
    overall, statuses, _ = svc.should_rate_limit(_req(pkg))
    assert overall == statuses[0].code == pkg.models.Code.OVER_LIMIT
    assert statuses[0].current_limit.requests_per_unit == 2
    store.flush()
    assert sink.counters["ratelimit.fallback.deny"] == 1


def test_degraded_mode_keeps_local_enforcement(pkg):
    """The reference's degraded rung decides on the CPU; the port has no
    such rung (it moves no decision off the card) and refuses the mode."""
    if pkg.name == "port":
        assert pkg.fallback.FAILURE_MODES == ("deny", "allow")
        with pytest.raises(ValueError, match="failure mode must be one of"):
            pkg.fallback.FallbackLimiter("degraded")
        return
    store, sink = _store(pkg)
    ts = pkg.time.FakeTimeSource(1_000_000)
    fallback = pkg.fallback.FallbackLimiter(
        pkg.fallback.FAILURE_MODE_DEGRADED,
        base_limiter=pkg.base.BaseRateLimiter(ts, near_limit_ratio=0.8),
        scope=store.scope("ratelimit"),
    )
    svc = make_service(pkg, store=store, cache=FlakyCache(pkg), rules=LADDER_RULES, ts=ts, fallback=fallback)
    Code = pkg.models.Code
    assert [svc.should_rate_limit(_req(pkg))[0] for _ in range(3)] == [Code.OK, Code.OK, Code.OVER_LIMIT]
    assert fallback.degraded
    store.flush()
    assert sink.counters["ratelimit.fallback.local"] == 3
    assert sink.counters["ratelimit.service.call.should_rate_limit.redis_error"] == 3


def test_healthcheck_reports_degraded_body(pkg):
    svc, cache, fallback, _, _ = _ladder_service(pkg, pkg.fallback.FAILURE_MODE_ALLOW)
    health = pkg.health.HealthChecker()
    health.set_degraded_probe(fallback.degraded_reason)
    assert health.http_response() == (200, "OK")
    svc.should_rate_limit(_req(pkg))
    status, body = health.http_response()
    assert status == 200 and body.startswith("OK") and "degraded" in body
    cache.down = False
    svc.should_rate_limit(_req(pkg))
    assert health.http_response() == (200, "OK")


def test_no_fallback_keeps_legacy_raise(pkg):
    svc = make_service(pkg, cache=FlakyCache(pkg), rules=LADDER_RULES)
    with pytest.raises(pkg.cache.CacheError):
        svc.should_rate_limit(_req(pkg))


def test_junk_failure_mode_refused(pkg):
    with pytest.raises(ValueError, match="failure mode must be one of"):
        pkg.fallback.FallbackLimiter("sometimes")
    if pkg.name == "jax":
        with pytest.raises(ValueError, match="needs a BaseRateLimiter"):
            pkg.fallback.FallbackLimiter(pkg.fallback.FAILURE_MODE_DEGRADED)


# -- tests/test_overload.py's shed postures ---------------------------------------


def _controller(ns, store, **kw):
    kw.setdefault("shed_mode", ns.overload.SHED_MODE_UNAVAILABLE)
    return ns.overload.AdmissionController(scope=store.scope("ratelimit"), **kw)


def _browned_service(ns, mode):
    store, sink = _store(ns)
    controller = _controller(ns, store, shed_mode=mode, brownout_target_ms=1.0, ewma_alpha=1.0)
    for _ in range(8):
        controller.observe_queue_wait(1e6)
    assert controller.brownout
    cache = FlakyCache(ns)
    cache.down = False
    svc = make_service(ns, store=store, cache=cache, rules=OVERLOAD_RULES, overload=controller)
    return svc, cache, controller, store, sink


def test_allow_posture_fails_open_with_shed_header(pkg):
    svc, cache, controller, store, sink = _browned_service(pkg, pkg.overload.SHED_MODE_ALLOW)
    overall, statuses, headers = svc.should_rate_limit(_req(pkg, "overload"))
    assert overall == statuses[0].code == pkg.models.Code.OK
    assert any(h.key == "x-ratelimit-shed" and h.value == "brownout" for h in headers)
    assert cache.calls == 0  # shed before dispatch
    store.flush()
    assert sink.counters["ratelimit.overload.shed"] == 1
    assert sink.counters["ratelimit.overload.brownout_shed"] == 1
    assert sink.gauges["ratelimit.overload.shedding"] == 1
    assert "overload" in controller.degraded_reason()


def test_deny_posture_answers_over_limit(pkg):
    svc, _, _, store, sink = _browned_service(pkg, pkg.overload.SHED_MODE_DENY)
    overall, statuses, _ = svc.should_rate_limit(_req(pkg, "overload"))
    assert overall == statuses[0].code == pkg.models.Code.OVER_LIMIT
    store.flush()
    assert sink.counters["ratelimit.overload.shed"] == 1


def test_unavailable_posture_raises(pkg):
    svc, _, _, store, sink = _browned_service(pkg, pkg.overload.SHED_MODE_UNAVAILABLE)
    with pytest.raises(pkg.overload.BrownoutError):
        svc.should_rate_limit(_req(pkg, "overload"))
    store.flush()
    assert sink.counters["ratelimit.overload.shed"] == 1
    assert sink.counters.get("ratelimit.service.call.should_rate_limit.redis_error", 0) == 0


def test_backend_overload_error_answers_by_posture(pkg):
    store, sink = _store(pkg)
    cache = FlakyCache(pkg, error=pkg.overload.QueueFullError("ring full"))
    svc = make_service(pkg, store=store, cache=cache, rules=OVERLOAD_RULES,
                       overload=_controller(pkg, store, shed_mode=pkg.overload.SHED_MODE_ALLOW))
    overall, _, headers = svc.should_rate_limit(_req(pkg, "overload"))
    assert overall == pkg.models.Code.OK
    assert any(h.key == "x-ratelimit-shed" and h.value == "queue_full" for h in headers)
    store.flush()
    assert sink.counters["ratelimit.overload.queue_full"] == 1


def test_no_controller_reraises_overload(pkg):
    cache = FlakyCache(pkg, error=pkg.overload.QueueFullError("full"))
    svc = make_service(pkg, cache=cache, rules=OVERLOAD_RULES)
    with pytest.raises(pkg.overload.OverloadError):
        svc.should_rate_limit(_req(pkg, "overload"))


def test_shed_state_clears_on_next_admitted_request(pkg):
    store, sink = _store(pkg)
    controller = _controller(pkg, store, shed_mode=pkg.overload.SHED_MODE_ALLOW)
    cache = FlakyCache(pkg, error=pkg.overload.QueueFullError("full"))
    svc = make_service(pkg, store=store, cache=cache, rules=OVERLOAD_RULES, overload=controller)
    svc.should_rate_limit(_req(pkg, "overload"))
    assert controller.degraded_reason() is not None
    cache.down = False
    svc.should_rate_limit(_req(pkg, "overload"))
    assert controller.degraded_reason() is None
    store.flush()
    assert sink.gauges["ratelimit.overload.shedding"] == 0


def test_healthcheck_stacks_overload_and_fallback_probes(pkg):
    store, _ = _store(pkg)
    controller = _controller(pkg, store, shed_mode=pkg.overload.SHED_MODE_ALLOW)
    health = pkg.health.HealthChecker()
    health.add_degraded_probe(controller.degraded_reason)
    assert health.http_response() == (200, "OK")
    controller.note_shed(pkg.overload.QueueFullError("full"))
    status, body = health.http_response()
    assert status == 200 and body.startswith("OK") and "overload" in body
    controller.note_ok()
    assert health.http_response() == (200, "OK")


def test_shed_journey_and_span_event(pkg):
    """An allow-posture shed answers without raising: its journey still
    carries the shed flag, and the span logs the overload_shed event."""
    rec = pkg.journeys.JourneyRecorder(slow_ms=1e9)
    pkg.journeys.set_global_recorder(rec)
    tracer = pkg.tracing.RecordingTracer()
    pkg.tracing.set_global_tracer(tracer)
    svc, _, _, _, _ = _browned_service(pkg, pkg.overload.SHED_MODE_ALLOW)
    with tracer.start_span("rpc") as span, pkg.tracing.activate(span):
        svc.should_rate_limit(_req(pkg, "overload"))
    (journey,) = rec.retained()
    assert journey.flags == ("shed",)
    (event,) = [f for _, f in span.logs if f.get("event") == "overload_shed"]
    assert event == {"event": "overload_shed", "shed_mode": "allow", "cause": "brownout"}


def test_expired_deadline_aborts_before_dispatch(pkg):
    store, sink = _store(pkg)
    cache = FlakyCache(pkg)
    cache.down = False
    svc = make_service(pkg, store=store, cache=cache, rules=OVERLOAD_RULES, overload=_controller(pkg, store))
    with pkg.deadline.deadline_scope(-1.0):
        with pytest.raises(pkg.cache.DeadlineExceededError):
            svc.should_rate_limit(_req(pkg, "overload"))
    assert cache.calls == 0
    store.flush()
    assert sink.counters["ratelimit.overload.deadline_expired"] == 1
    assert sink.counters.get("ratelimit.service.call.should_rate_limit.redis_error", 0) == 0


# -- one stream through both packages' slab caches --------------------------------

STREAM_RULES = (
    "domain: chaos\ndescriptors:\n"
    "  - key: k\n    rate_limit: {unit: minute, requests_per_unit: 3}\n"
    "  - key: s\n    rate_limit: {unit: minute, requests_per_unit: 2, algorithm: sliding_window}\n"
)


def _failing_stream(ns, mode):
    """20 requests through ns's service over its slab cache (on the CPU),
    the engine failing every third submit. Returns the answers, the
    counters and gauges, and the /healthcheck answers after each request."""
    store, sink = _store(ns)
    ts = ns.time.FakeTimeSource(NOW0)
    base = ns.base.BaseRateLimiter(ts, jitter_rand=None, near_limit_ratio=0.8)
    cache = ns.slab_cache(base, hotkey_lanes=0)
    submits = [0]
    if ns.name == "jax":
        engine_submit = cache._submit_rows
    else:
        engine_submit = cache.engine.submit_rows

    def flaky(*a, **k):
        submits[0] += 1
        if submits[0] % 3 == 0:
            raise ns.cache.CacheError(f"{ns.backend} launch failed")
        return engine_submit(*a, **k)

    if ns.name == "jax":
        cache._submit_rows = flaky
    else:
        cache.engine.submit_rows = flaky
    fallback = ns.fallback.FallbackLimiter(mode, scope=store.scope("ratelimit")) if mode else None
    health = ns.health.HealthChecker()
    if fallback is not None:
        health.set_degraded_probe(fallback.degraded_reason)
    svc = make_service(ns, store=store, cache=cache, rules=STREAM_RULES, ts=ts, fallback=fallback)
    answers, bodies = [], []
    try:
        for i in range(20):
            pairs = [("k", f"u{i % 4}")] + ([("s", "x")] if i % 5 == 0 else [])
            try:
                overall, statuses, _ = svc.should_rate_limit(request(ns, *pairs, domain="chaos"))
                answers.append((int(overall), [(int(st.code), st.limit_remaining) for st in statuses]))
            except ns.cache.CacheError as e:
                answers.append(("error", str(e).replace(ns.backend, "ENGINE")))
            status, body = health.http_response()
            bodies.append((status, body.replace(ns.backend, "ENGINE")))
            if i == 9:
                ts.advance(60)
    finally:
        cache.close()
    store.flush()
    counters = {k: v for k, v in sink.counters.items() if ".fallback." in k or k.endswith("redis_error")}
    gauges = {k: v for k, v in sink.gauges.items() if ".fallback." in k}
    return answers, counters, gauges, bodies


@pytest.mark.parametrize("mode", [None, "deny", "allow"])
def test_failing_engine_stream_answers_like_the_reference(mode):
    want = _failing_stream(PKGS["jax"], mode)
    got = _failing_stream(PKGS["port"], mode)
    assert got == want
    answers, counters, gauges, bodies = got
    n_failed = sum(1 for a in answers if a[0] == "error") if mode is None else counters.get(f"ratelimit.fallback.{mode}", 0)
    assert n_failed == 6
    assert counters["ratelimit.service.call.should_rate_limit.redis_error"] == 6
    if mode is not None:
        assert any("degraded" in b for _s, b in bodies) and all(s == 200 for s, _b in bodies)


def test_queue_full_from_the_engine_never_reaches_the_ladder():
    """A QueueFullError out of the slab engine is a shed (the posture
    answers it), not a failure: the ladder neither answers nor degrades."""
    out = {}
    for name, ns in PKGS.items():
        store, sink = _store(ns)
        ts = ns.time.FakeTimeSource(NOW0)
        base = ns.base.BaseRateLimiter(ts, jitter_rand=None)
        controller = _controller(ns, store, shed_mode=ns.overload.SHED_MODE_DENY)
        cache = ns.slab_cache(base, hotkey_lanes=0, overload=controller, max_queue=1)

        def full(*_a, **_k):
            raise ns.overload.QueueFullError("ring full")

        if name == "jax":
            cache._submit_rows = full
        else:
            cache.engine.submit_rows = full
        fallback = ns.fallback.FallbackLimiter("allow", scope=store.scope("ratelimit"))
        svc = make_service(ns, store=store, cache=cache, rules=STREAM_RULES, ts=ts, fallback=fallback, overload=controller)
        try:
            overall, statuses, headers = svc.should_rate_limit(request(ns, ("k", "a"), domain="chaos"))
        finally:
            cache.close()
        store.flush()
        out[name] = (int(overall), [h.value for h in headers], {k: v for k, v in sink.counters.items() if "fallback" in k or "overload" in k})
        assert not fallback.degraded
    assert out["port"] == out["jax"]
    overall, headers, counters = out["port"]
    assert overall == 2 and headers == ["queue_full"]
    assert not any(".fallback." in k and v for k, v in counters.items())
