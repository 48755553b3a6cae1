"""The port's process on the CPU: Runner, gRPC v3/v2, /json, gRPC health
and hot reload.

* The JAX package's integration tests (tests/test_server_integration.py,
  from the v3 over-limit sequence through the kept-old-config reload) run
  unchanged against the port's Runner, with the memory backend and with the
  CUDA engine on the CPU (BACKEND_TYPE=cuda, device="cpu"): this module
  imports them and overrides their `running_server` fixture; their debug
  endpoints test (/debug/pprof, the CPU sampler, the heap snapshot) runs as
  test_reference_debug_endpoints. The port's own debug test adds /metrics,
  /debug/journeys, /debug/traces, /debug/profile and /debug/hotkeys.
* The JAX Runner (BACKEND_TYPE=tpu on the CPU: the XLA twin) and the port's
  Runner (cuda on the CPU) take the same v3/v2//json stream under one fake
  process clock: the serialized responses and /json bodies are identical
  byte for byte, the slab tables equal, and an empty domain, an unknown
  domain and a backend failure give the same gRPC codes. /json answers 504
  on an expired Envoy deadline and 503 on an unavailable-posture shed as
  the JAX Runner does, and with FAILURE_MODE_DENY set a failing engine gets
  the JAX Runner's answers, counters and /healthcheck body.
"""

import dataclasses
import http.client
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
grpc = pytest.importorskip("grpc")

import test_server_integration as ref_it  # noqa: E402
from test_server_integration import (  # noqa: E402,F401 (collected here)
    test_config_error_keeps_old_config,
    test_debug_endpoints as test_reference_debug_endpoints,
    test_duration_until_reset_decays,
    test_grpc_health_watch_cap,
    test_grpc_health_watch_streams_transition,
    test_grpc_v2_legacy,
    test_grpc_v3_error_on_empty_domain,
    test_grpc_v3_over_limit_sequence,
    test_grpc_v3_stats_counters,
    test_healthcheck_and_grpc_health,
    test_hot_reload,
    test_http_json_malformed_content_length,
    test_http_json_status_mapping,
)

from api_ratelimit_tpu import runner as jax_runner  # noqa: E402
from api_ratelimit_tpu import settings as jax_settings  # noqa: E402
from api_ratelimit_tpu.limiter.cache import CacheError as JaxCacheError  # noqa: E402
from api_ratelimit_tpu.utils import timeutil as jax_time  # noqa: E402
from api_ratelimit_tpu_torch import runner as port_runner  # noqa: E402
from api_ratelimit_tpu_torch import settings as port_settings  # noqa: E402
from api_ratelimit_tpu_torch.limiter.cache import CacheError  # noqa: E402
from api_ratelimit_tpu_torch.pb import health_pb2, rls_grpc, rls_v2, rls_v3  # noqa: E402
from api_ratelimit_tpu_torch.stats.sinks import TestSink  # noqa: E402
from api_ratelimit_tpu_torch.utils import FakeTimeSource, RealTimeSource  # noqa: E402
from api_ratelimit_tpu_torch.utils import timeutil as port_time  # noqa: E402

NOW = 1_722_300_000
# a small CUDA engine for the CPU: 4096 slots of 4 ways, one bucket
SMALL_ENGINE = dict(tpu_slab_slots=4096, slab_ways=4, tpu_buckets="128", tpu_precompile=False)


@pytest.fixture(params=["memory", "cuda"])
def running_server(request, tmp_path):
    """The JAX integration tests' fixture, on the port's Runner: the same
    runtime layout and settings, the backend memory or the CUDA engine on
    the CPU."""
    runtime_path, subdir, config_dir = ref_it.make_runtime(tmp_path)
    settings = port_settings.Settings(
        port=0,
        grpc_port=0,
        debug_port=0,
        use_statsd=False,
        runtime_path=runtime_path,
        runtime_subdirectory=subdir,
        backend_type=request.param,
        local_cache_size_in_bytes=0,
        expiration_jitter_max_seconds=0,
        log_level="ERROR",
        **SMALL_ENGINE,
    )
    runner = port_runner.Runner(settings, sink=TestSink(), device="cpu")
    runner.run_background()
    assert runner.wait_ready(10.0)
    yield runner, config_dir
    runner.stop()


def http_call(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, body=body, headers={"Content-Type": "application/json"} if body else {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_debug_endpoints(running_server):
    """The port's debug port: the index, /stats, /rlconfig, /metrics (the
    service's counters and the build gauges), /debug/journeys (the default
    recorder, holding the over-limit journey of a served call),
    /debug/traces (tracing off: no spans), /debug/profile (404 with
    TPU_PROFILE_DIR empty), /debug/hotkeys with the CUDA engine's sketch,
    and 404 elsewhere."""
    runner, _ = running_server
    port = runner.server.debug_port
    status, text = http_call(port, "GET", "/")
    assert status == 200 and b"/stats" in text and b"/rlconfig" in text
    for path in (b"/metrics", b"/debug/journeys", b"/debug/traces", b"/debug/profile", b"/debug/pprof/"):
        assert path in text
    status, text = http_call(port, "GET", "/stats")
    assert status == 200 and b"config_load_success" in text
    status, text = http_call(port, "GET", "/rlconfig")
    assert status == 200 and b"basic" in text and b"one_per_minute" in text
    with grpc.insecure_channel(f"localhost:{runner.server.grpc_port}") as ch:
        stub = rls_grpc.RateLimitServiceV3Stub(ch)
        for _ in range(2):
            stub.ShouldRateLimit(ref_it.v3_request("basic", [[("one_per_minute", "dbg")]]))
    status, text = http_call(port, "GET", "/metrics")
    assert status == 200
    assert b"# TYPE ratelimit_service_config_load_success counter" in text
    assert b"ratelimit_build_platform_id 0\n" in text and b"ratelimit_build_device_count 0\n" in text
    assert b"ratelimit_service_call_should_rate_limit_latency_ms_count 2\n" in text
    status, text = http_call(port, "GET", "/debug/journeys")
    doc = json.loads(text)
    assert status == 200 and doc["enabled"] is True
    assert [j["flags"] for j in doc["retained"]] == [["over_limit"]]
    assert http_call(port, "GET", "/debug/traces") == (200, b'{"spans": []}\n')
    assert http_call(port, "GET", "/debug/profile?ms=10")[0] == 404
    status, text = http_call(port, "GET", "/debug/hotkeys")
    if runner.settings.backend_type == "cuda":
        assert status == 200 and json.loads(text)["lanes"] == 128
    else:
        assert status == 404
    assert http_call(port, "GET", "/nope")[0] == 404


def test_health_fails_before_the_listeners_close(running_server):
    """stop(): health answers NOT_SERVING on an open Watch stream and
    /healthcheck answers 500 while the gRPC grace holds the listeners
    open; then every port closes."""
    runner, _ = running_server
    with grpc.insecure_channel(f"localhost:{runner.server.grpc_port}") as ch:
        watch = ch.unary_stream(
            "/grpc.health.v1.Health/Watch",
            request_serializer=health_pb2.HealthCheckRequest.SerializeToString,
            response_deserializer=health_pb2.HealthCheckResponse.FromString,
        )
        stream = watch(health_pb2.HealthCheckRequest())
        assert next(stream).status == health_pb2.HealthCheckResponse.SERVING
        runner.stop()
        assert next(stream).status == health_pb2.HealthCheckResponse.NOT_SERVING
        assert http_call(runner.server.http_port, "GET", "/healthcheck")[0] == 500
        stream.cancel()
    assert runner.server.wait_closed(10.0)
    with pytest.raises(OSError):
        http_call(runner.server.http_port, "GET", "/healthcheck")


def test_watermark_probe_and_gauge(tmp_path):
    """SLAB_WATERMARK_HIGH on the CUDA engine: past it the stats flush sets
    ratelimit.slab.watermark and /healthcheck reports the slab pressure in
    its 200 body."""
    runtime_path, subdir, _ = ref_it.make_runtime(tmp_path)
    settings = port_settings.Settings(
        port=0, grpc_port=0, debug_port=0, use_statsd=False, runtime_path=runtime_path,
        runtime_subdirectory=subdir, log_level="ERROR", slab_watermark_high=0.0005, **SMALL_ENGINE,
    )
    runner = port_runner.Runner(settings, device="cpu")
    runner.run_background()
    try:
        status, body = http_call(runner.server.http_port, "GET", "/healthcheck")
        assert (status, body) == (200, b"OK")
        with grpc.insecure_channel(f"localhost:{runner.server.grpc_port}") as ch:
            stub = rls_grpc.RateLimitServiceV3Stub(ch)
            for i in range(4):
                stub.ShouldRateLimit(ref_it.v3_request("basic", [[("key1", f"k{i}")]]))
        runner.stats_store.flush()
        assert runner.stats_store.debug_snapshot()["ratelimit.slab.watermark"] == 1
        status, body = http_call(runner.server.http_port, "GET", "/healthcheck")
        assert status == 200 and body.startswith(b"OK (degraded: slab pressure")
    finally:
        runner.stop()


def test_runner_defaults_to_the_card(tmp_path, monkeypatch):
    """Runner's device is "cuda" unless the caller passes another: without
    a card the boot raises the engine's error; nothing serves from the
    CPU."""
    runtime_path, subdir, _ = ref_it.make_runtime(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    settings = port_settings.Settings(
        port=0, grpc_port=0, debug_port=0, use_statsd=False, runtime_path=runtime_path,
        runtime_subdirectory=subdir, log_level="ERROR", **SMALL_ENGINE,
    )
    runner = port_runner.Runner(settings)
    assert runner.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        runner.run_background()
    runner.server.stop()


@pytest.mark.parametrize(
    "override, item",
    [
        ({"tpu_mesh_devices": 4}, "10"),
        # item 8's in-process half is ported: LEASE_ENABLED boots (the
        # case keeps its id)
        pytest.param({"lease_enabled": True}, None, id="override1-8"),
        # item 4c is ported: BACKEND_TYPE=redis boots (the case keeps its id)
        pytest.param({"backend_type": "redis"}, None, id="override2-4c"),
        # item 6 is ported: VICTIM_TIER_ENABLED boots (the case keeps its id)
        pytest.param({"victim_tier_enabled": True}, None, id="override3-6"),
    ],
)
def test_runner_refuses_unported_settings(tmp_path, override, item):
    """A knob of an unported item stops the boot naming its item; a knob
    whose item is ported boots and serves."""
    from api_ratelimit_tpu_torch.testing.fake_redis import FakeRedisServer

    runtime_path, subdir, _ = ref_it.make_runtime(tmp_path)
    fake = FakeRedisServer()
    settings = port_settings.Settings(
        port=0, grpc_port=0, debug_port=0, use_statsd=False, runtime_path=runtime_path,
        runtime_subdirectory=subdir, log_level="ERROR", redis_socket_type="tcp", redis_url=fake.addr,
        **SMALL_ENGINE, **override,
    )
    try:
        if item is None:
            runner = port_runner.Runner(settings, device="cpu")
            runner.run_background()
            try:
                assert runner.wait_ready(10.0)
                req = ref_it.v3_request("basic", [[("key1", "x")]])
                assert _grpc_call(runner.server.grpc_port, "v3", req)[0] == "ok"
                if settings.backend_type == "redis":
                    assert any(c[0] == b"INCRBY" for c in fake.commands_seen)
                else:
                    engine = runner.cache.engine
                    assert (runner.lease_table is not None) == settings.lease_enabled
                    assert engine.victim_enabled == settings.victim_tier_enabled
                    assert engine.victim_debug()["enabled"] == settings.victim_tier_enabled
            finally:
                runner.stop()
            return
        with pytest.raises(ValueError, match=f"ROADMAP item {item}"):
            port_runner.Runner(settings, device="cpu").run_background()
    finally:
        fake.close()


# -- the JAX Runner against the port's, on one stream ------------------------

PARITY_RULES = """\
domain: par
descriptors:
  - key: user
    rate_limit: {unit: minute, requests_per_unit: 4}
  - key: path
    descriptors:
      - key: method
        value: GET
        rate_limit: {unit: hour, requests_per_unit: 9}
  - key: tier
    value: free
    rate_limit: {unit: second, requests_per_unit: 2}
  - key: slide
    rate_limit: {unit: minute, requests_per_unit: 3, algorithm: sliding_window}
  - key: gcra
    rate_limit: {unit: minute, requests_per_unit: 5, algorithm: gcra}
  - key: shadow
    shadow_mode: true
    rate_limit: {unit: minute, requests_per_unit: 1}
"""

PARITY_ENV = {
    "PORT": "0",
    "GRPC_PORT": "0",
    "DEBUG_PORT": "0",
    "USE_STATSD": "false",
    "LOG_LEVEL": "ERROR",
    "TPU_SLAB_SLOTS": "4096",
    "SLAB_WAYS": "4",
    "TPU_BUCKETS": "128",
    "TPU_PRECOMPILE": "false",
    "EXPIRATION_JITTER_MAX_SECONDS": "0",
    "RUNTIME_SUBDIRECTORY": "ratelimit",
}


def _parity_stream(rng, n):
    """(kind, request, clock step) triples: v3 with 1-3 descriptors (some
    with a limit override, some with hits_addend), v2 and /json."""
    keys = ["user", "path", "tier", "slide", "gcra", "shadow", "unknown"]
    out = []
    for _ in range(n):
        descs = []
        for _d in range(int(rng.integers(1, 4))):
            k = keys[int(rng.integers(0, len(keys)))]
            v = f"v{int(min(rng.zipf(1.5), 6))}"
            pairs = [("path", f"/{v}"), ("method", "GET")] if k == "path" else [(k, "free" if k == "tier" else v)]
            descs.append(pairs)
        kind = ["v3", "v3", "v2", "json"][int(rng.integers(0, 4))]
        hits = int(rng.choice([0, 0, 1, 2]))
        override = kind == "v3" and rng.random() < 0.1
        out.append((kind, descs, hits, override, int(rng.choice([0, 0, 0, 1, 7, 30]))))
    return out


def _v3(descs, hits, override):
    req = rls_v3.RateLimitRequest(domain="par", hits_addend=hits)
    for pairs in descs:
        d = req.descriptors.add()
        for k, v in pairs:
            d.entries.add(key=k, value=v)
    if override:
        req.descriptors[0].limit.requests_per_unit = 2
        req.descriptors[0].limit.unit = rls_v3.RateLimitResponse.RateLimit.MINUTE
    return req


def _v2(descs, hits):
    req = rls_v2.RateLimitRequest(domain="par", hits_addend=hits)
    for pairs in descs:
        d = req.descriptors.add()
        for k, v in pairs:
            d.entries.add(key=k, value=v)
    return req


def _json(descs, hits):
    body = {"domain": "par", "descriptors": [{"entries": [{"key": k, "value": v} for k, v in p]} for p in descs]}
    if hits:
        body["hitsAddend"] = hits
    return json.dumps(body).encode()


def _grpc_call(port, service, req):
    stub_cls = rls_grpc.RateLimitServiceV3Stub if service == "v3" else rls_grpc.RateLimitServiceV2Stub
    with grpc.insecure_channel(f"localhost:{port}") as ch:
        try:
            return ("ok", stub_cls(ch).ShouldRateLimit(req, timeout=30).SerializeToString())
        except grpc.RpcError as e:
            return ("error", e.code())


def _twin_runners(tmp_path, **extra_env):
    """The JAX Runner (tpu, the XLA twin) and the port's (cuda on the CPU)
    over one runtime directory and one fake process clock."""
    config_dir = tmp_path / "ratelimit" / "config"
    config_dir.mkdir(parents=True)
    (config_dir / "par.yaml").write_text(PARITY_RULES)
    env = dict(PARITY_ENV, RUNTIME_ROOT=str(tmp_path), **extra_env)
    clock = FakeTimeSource(NOW)
    jax_time.install_process_time_source(clock)
    port_time.install_process_time_source(clock)
    jr = jax_runner.Runner(jax_settings.new_settings(dict(env, BACKEND_TYPE="tpu")))
    pr = port_runner.Runner(port_settings.new_settings(dict(env, BACKEND_TYPE="cuda")), device="cpu")
    try:
        jr.run_background()
        pr.run_background()
        yield jr, pr, clock
    finally:
        for r in (jr, pr):
            if r.server is not None:
                r.stop()
        jax_time.install_process_time_source(jax_time.RealTimeSource())
        port_time.install_process_time_source(RealTimeSource())


@pytest.fixture
def twin_runners(tmp_path):
    yield from _twin_runners(tmp_path)


def test_jax_runner_and_port_runner_answer_alike(twin_runners):
    """The same 160-request stream through the JAX Runner (tpu, the XLA
    twin) and the port's Runner (cuda on the CPU), under one fake clock:
    serialized v3/v2 responses and /json statuses and bodies identical,
    and equal slab tables at the end."""
    jr, pr, clock = twin_runners
    rng = np.random.default_rng(9)
    seen = set()
    for kind, descs, hits, override, step in _parity_stream(rng, 160):
        clock.advance(step)
        if kind == "json":
            body = _json(descs, hits)
            got = http_call(pr.server.http_port, "POST", "/json", body)
            want = http_call(jr.server.http_port, "POST", "/json", body)
            seen.add(got[0])
        else:
            req = _v3(descs, hits, override) if kind == "v3" else _v2(descs, hits)
            got = _grpc_call(pr.server.grpc_port, kind, req)
            want = _grpc_call(jr.server.grpc_port, kind, req)
            if got[0] == "ok":
                resp = (rls_v3 if kind == "v3" else rls_v2).RateLimitResponse.FromString(got[1])
                seen.add(int(resp.overall_code))
        assert got == want, (kind, descs, hits, override)
    assert {200, 429, 1, 2} <= seen  # OK and OVER_LIMIT on both wires
    want_tables = jr.service._cache.engine.export_tables()
    got_tables = pr.cache.engine.export_tables()
    assert len(got_tables) == len(want_tables)
    for g, w in zip(got_tables, want_tables):
        assert np.array_equal(g, w)
    assert pr.cache.engine.algos_seen  # the sliding and GCRA rules flipped it


def test_jax_runner_and_port_runner_fail_alike(twin_runners):
    """An empty domain (INTERNAL), an unknown domain (OK) and a backend
    failure (CacheError -> UNAVAILABLE, and the v2 error counter) give the
    same gRPC codes from both runners."""
    jr, pr, _clock = twin_runners
    cases = [
        ("v3", _v3([[("user", "a")]], 0, False)),
        ("v2", _v2([[("user", "a")]], 0)),
    ]
    empty = rls_v3.RateLimitRequest(domain="")
    empty.descriptors.add().entries.add(key="user", value="a")
    unknown = rls_v3.RateLimitRequest(domain="nope")
    unknown.descriptors.add().entries.add(key="user", value="a")
    for req in (empty, unknown):
        got, want = _grpc_call(pr.server.grpc_port, "v3", req), _grpc_call(jr.server.grpc_port, "v3", req)
        assert got == want
    assert _grpc_call(pr.server.grpc_port, "v3", empty) == ("error", grpc.StatusCode.INTERNAL)

    def port_fail(_block):
        raise CacheError("cuda backend failure: injected")

    def jax_fail(*_a, **_k):
        raise JaxCacheError("tpu backend failure: injected")

    pr.cache.engine.submit_rows = port_fail
    jr.service._cache._submit_rows = jax_fail
    for kind, req in cases:
        got, want = _grpc_call(pr.server.grpc_port, kind, req), _grpc_call(jr.server.grpc_port, kind, req)
        assert got == want == ("error", grpc.StatusCode.UNAVAILABLE), kind
    key = "ratelimit.service.call.should_rate_limit_legacy.should_rate_limit_error"
    assert pr.stats_store.debug_snapshot()[key] == jr.stats_store.debug_snapshot()[key] == 1
    key = "ratelimit.service.call.should_rate_limit.redis_error"
    assert pr.stats_store.debug_snapshot()[key] == jr.stats_store.debug_snapshot()[key] == 2


def test_process_clock_is_shared_and_skewable():
    """install_process_time_source: the runner's clock is a
    SkewableTimeSource over the installed base, in both packages."""
    clock = FakeTimeSource(NOW)
    try:
        p = port_time.install_process_time_source(clock)
        j = jax_time.install_process_time_source(clock)
        assert port_time.process_time_source() is p
        assert p.unix_now() == j.unix_now() == NOW
        clock.advance(5)
        p.set_skew(offset_s=3)
        assert (p.unix_now(), j.unix_now()) == (NOW + 8, NOW + 5)
        assert p.monotonic() == float(NOW + 5)
    finally:
        jax_time.install_process_time_source(jax_time.RealTimeSource())
        port_time.install_process_time_source(RealTimeSource())


def test_settings_dataclass_mirrors_the_reference():
    """Every field of the JAX Settings exists with its default, but
    BACKEND_TYPE's."""
    ref = dataclasses.asdict(jax_settings.Settings())
    port = dataclasses.asdict(port_settings.Settings())
    assert set(ref) == set(port)
    assert {k for k in ref if ref[k] != port[k]} == {"backend_type"}
    assert (ref["backend_type"], port["backend_type"]) == ("tpu", "cuda")


def test_grpc_edge_records_receive_time(running_server):
    """transport.grpc_ms records each v3 call's handler time."""
    runner, _ = running_server
    with grpc.insecure_channel(f"localhost:{runner.server.grpc_port}") as ch:
        stub = rls_grpc.RateLimitServiceV3Stub(ch)
        for _ in range(3):
            stub.ShouldRateLimit(ref_it.v3_request("basic", [[("key1", "t")]]))
    snap = runner.stats_store.debug_snapshot()
    assert snap["ratelimit.service.transport.grpc_ms.count"] == 3


def test_chip_smoke_process_phase_on_the_cpu(tmp_path):
    """chip_smoke.py's process phase, rehearsed on the CPU at a small size:
    the CUDA engine's runner (on the CPU) and the memory backend's answer a
    v3/v2//json stream alike, the slab decides every descriptor, the hot
    reload and the malformed file behave, config_check_cmd agrees, and
    stop() fails health before the ports close."""
    import chip_smoke as CS

    root = str(tmp_path / "runtime")
    config_dir = CS.process_runtime(root)
    clock = FakeTimeSource(NOW)
    port_time.install_process_time_source(clock)
    small = {"TPU_SLAB_SLOTS": 1 << 14, "SLAB_WAYS": 4, "TPU_BUCKETS": "128"}
    try:
        card, _boot_s = CS.process_boot(CS.process_env(root, **small), device="cpu")
        host, _ = CS.process_boot(CS.process_env(root, backend="memory"), device="cpu")
        assert card.cache.engine.precompiled
        stream = CS.process_stream(card, host, clock, n_v3=300, n_v2=16, n_json=16, n_keys=512)
        slab = card.stats_store.debug_snapshot()
        assert slab["ratelimit.slab.decisions"] == stream["descriptors"]
        assert slab["ratelimit.slab.evictions.live"] == slab["ratelimit.slab.drops"] == 0
        CS.process_reload(card, config_dir)
        assert card.cache.engine.algos_seen
        (tmp_path / "runtime" / "ratelimit" / "config" / "broken.yaml").unlink()
        assert CS.process_config_check(config_dir) == {"good": 0, "malformed": 1}
        assert CS.process_stop(card) == {"health_failed_before_close": True}
        host.stop()
    finally:
        port_time.install_process_time_source(RealTimeSource())


def _json_with_headers(port, body, headers):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", "/json", body=body, headers={"Content-Type": "application/json", **headers})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _fail_engines(jr, pr, port_error, jax_error):
    """Make the port runner's engine submit raise port_error and the JAX
    runner's raise jax_error."""

    def raiser(error):
        def fail(*_a, **_k):
            raise error

        return fail

    pr.cache.engine.submit_rows = raiser(port_error)
    jr.service._cache._submit_rows = raiser(jax_error)


@pytest.mark.parametrize(
    "case, headers",
    [("expired_deadline", {"x-envoy-expected-rq-timeout-ms": "0"}), ("negative_deadline", {"x-envoy-expected-rq-timeout-ms": "-5"}),
     ("junk_deadline", {"x-envoy-expected-rq-timeout-ms": "soon"}), ("queue_full", {})],
)
def test_json_deadline_and_shed_answers_match_the_jax_runner(twin_runners, case, headers):
    """/json: an expired x-envoy-expected-rq-timeout-ms answers 504 before
    dispatch, a junk one is no deadline (200), and an unavailable-posture
    shed (the engine's queue is full) answers 503, each with the JAX
    Runner's status and body."""
    from api_ratelimit_tpu.backends.overload import QueueFullError as JaxQueueFull
    from api_ratelimit_tpu_torch.backends.overload import QueueFullError

    jr, pr, _clock = twin_runners
    body = _json([[("user", "deadline")]], 0)
    if case == "queue_full":
        _fail_engines(jr, pr, QueueFullError("ring full"), JaxQueueFull("ring full"))
    got = _json_with_headers(pr.server.http_port, body, headers)
    want = _json_with_headers(jr.server.http_port, body, headers)
    assert got == want
    assert got[0] == {"expired_deadline": 504, "negative_deadline": 504, "junk_deadline": 200, "queue_full": 503}[case]
    snap = pr.stats_store.debug_snapshot()
    assert snap.get("ratelimit.service.call.should_rate_limit.redis_error", 0) == 0
    if case == "queue_full":
        assert snap["ratelimit.overload.shed"] == jr.stats_store.debug_snapshot()["ratelimit.overload.shed"] == 1


@pytest.fixture(params=["deny", "allow"])
def ladder_runners(request, tmp_path):
    yield from _twin_runners(tmp_path, FAILURE_MODE_DENY=request.param, OVERLOAD_SHED_MODE="allow")


def test_failure_ladder_answers_like_the_jax_runner(ladder_runners):
    """FAILURE_MODE_DENY set and the engine failing: the same v3 and /json
    answers from both runners, the same ratelimit.fallback.* counters and
    gauge, and the degraded /healthcheck body (200); after the engine
    recovers, /healthcheck is plain OK again."""
    jr, pr, _clock = ladder_runners
    bodies = [_json([[("user", f"u{i % 2}")], [("tier", "free")]], 0) for i in range(4)]
    reqs = [_v3([[("user", f"v{i % 2}")]], 0, False) for i in range(4)]
    for r in (jr, pr):
        assert http_call(r.server.http_port, "GET", "/healthcheck") == (200, b"OK")
    saved = (pr.cache.engine.submit_rows, jr.service._cache._submit_rows)
    _fail_engines(jr, pr, CacheError("engine launch failed"), JaxCacheError("engine launch failed"))
    for body in bodies:
        assert http_call(pr.server.http_port, "POST", "/json", body) == http_call(jr.server.http_port, "POST", "/json", body)
    for req in reqs:
        assert _grpc_call(pr.server.grpc_port, "v3", req) == _grpc_call(jr.server.grpc_port, "v3", req)
    health = [http_call(r.server.http_port, "GET", "/healthcheck") for r in (pr, jr)]
    assert health[0] == health[1]
    assert health[0][0] == 200 and b"degraded: mode=" in health[0][1]

    def ladder_stats(r):
        snap = r.stats_store.debug_snapshot()
        return {k: v for k, v in snap.items() if ".fallback." in k or k.endswith(".redis_error")}

    # the reference's degraded rung counts into fallback.local; the port
    # has no such rung and no such counter
    want = ladder_stats(jr)
    assert want.pop("ratelimit.fallback.local") == 0
    assert ladder_stats(pr) == want
    mode = pr.settings.failure_mode()
    assert ladder_stats(pr)[f"ratelimit.fallback.{mode}"] == 8
    assert ladder_stats(pr)["ratelimit.fallback.degraded"] == 1
    pr.cache.engine.submit_rows, jr.service._cache._submit_rows = saved
    for r in (pr, jr):
        assert _grpc_call(r.server.grpc_port, "v3", reqs[0])[0] == "ok"
        assert http_call(r.server.http_port, "GET", "/healthcheck") == (200, b"OK")


def test_chip_smoke_observability_phase_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's observability phase, rehearsed on the CPU at a small
    size: the stream against the memory backend, /metrics (platform cpu, no
    device), the journeys' stage order, the Zipkin collector's server
    spans, the hot-key flag after a drain, /debug/profile's 200 and 429
    (no kernel names on the CPU), the windowed runner's linked batch spans
    and journeys, and the block-interleaved cost runs; the ladder and the shed never
    answer, and the exporter thread ends with the runners."""
    import threading

    import chip_smoke as CS

    monkeypatch.setattr(CS, "OBS_TIMED_CALLS", 16)
    monkeypatch.setattr(CS, "OBS_COST_BLOCK", 4)
    monkeypatch.setattr(CS, "OBS_WINDOW_CALLS", 48)
    root = str(tmp_path / "runtime")
    CS.process_runtime(root)
    profile_dir = str(tmp_path / "profiles")
    clock = FakeTimeSource(NOW)
    port_time.install_process_time_source(clock)
    small = {"TPU_SLAB_SLOTS": 1 << 14, "SLAB_WAYS": 4, "TPU_BUCKETS": "128,1024"}
    env = CS.process_env(root, FAILURE_MODE_DENY="allow", OVERLOAD_SHED_MODE="allow", TPU_PROFILE_DIR=profile_dir, **small)
    collector = CS.ZipkinCollector()
    runners = []
    try:
        host, _ = CS.process_boot(CS.process_env(root, backend="memory", JOURNEY_RECORDER_ENABLED="false"), device="cpu")
        runners.append(host)
        card, _ = CS.process_boot(dict(env, **CS.obs_tracing(collector)), device="cpu")
        runners.append(card)
        stream = CS.obs_stream(card, host, clock, 96, 512)
        metrics = CS.obs_metrics(card, stream["hits"], 0, 0)
        assert metrics["total_hits"] == stream["hits"] > stream["calls"]
        assert CS.obs_journeys(card)["flags"]["over_limit"] > 0
        assert CS.obs_collector_spans(collector, 96)["server_spans"] == 96
        assert "hotkey" in CS.obs_hotkey(card, stream["hottest"])["flags"]
        trace = CS.obs_device_trace(card, profile_dir, 512, kernels=())
        # one trace file a capture, each capture with calls in flight
        assert trace["second_capture"] == 429 and trace["files"] == CS.OBS_CAPTURES
        assert len(trace["captures"]) == CS.OBS_CAPTURES and all(c["calls_during"] > 0 for c in trace["captures"])
        assert not any(CS.obs_counters(card).values())
        windowed = CS.obs_windowed(env, 512, device="cpu")
        assert windowed["calls"] == 48 + CS.OBS_WINDOW_THREADS and windowed["batches"] >= 1
        on, _ = CS.process_boot(dict(env, **CS.obs_tracing(collector)), device="cpu")
        runners.append(on)
        off, _ = CS.process_boot(dict(env, JOURNEY_RECORDER_ENABLED="false"), device="cpu")
        runners.append(off)
        # the tracer comes from each runner's settings mapping
        assert (type(on.tracer).__name__, type(off.tracer).__name__) == ("ZipkinTracer", "NoopTracer")
        cost = CS.obs_cost(on, off, 512, profiled=False)
        assert [r["calls"] for r in cost["arms"].values()] == [16, 16] and "busy" not in cost
        assert cost["gap_ms"]["p10"] <= cost["gap_ms"]["p50"] <= cost["gap_ms"]["p90"]
    finally:
        CS.obs_register(None)
        for r in runners:
            r.stop()
        collector.stop()
        port_time.install_process_time_source(RealTimeSource())
    assert not any(t.name == "tracing-flush" and t.is_alive() for t in threading.enumerate())


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_two_listeners_share_one_port(pkg):
    """The fleet's workers bind one PORT (C6): a second HTTP listener binds
    a port the first holds, through SO_REUSEPORT, as the JAX package's
    _ReusePortHTTPServer does (api_ratelimit_tpu/server/http_server.py:53-60),
    and the kernel spreads connections over both."""
    if pkg == "jax":
        from api_ratelimit_tpu.server.http_server import HttpServer as JaxHttp

        first = JaxHttp("127.0.0.1", 0, "a")
        servers = [first, JaxHttp("127.0.0.1", first.port, "b")]
    else:
        from api_ratelimit_tpu_torch.server.http_server import DebugServer, HttpServer

        first = HttpServer(host="127.0.0.1", port=0)
        servers = [first, HttpServer(host="127.0.0.1", port=first.port), DebugServer("127.0.0.1", first.port)]
    for server in servers:
        server.serve_background()
    try:
        assert {server.port for server in servers} == {first.port}
        if pkg == "port":
            for _ in range(4):
                status, _body = http_call(first.port, "GET", "/healthcheck")
                assert status in (200, 404)  # the main listeners or the debug one
    finally:
        for server in servers:
            server.shutdown()
