"""The port's in-process quota leasing (api_ratelimit_tpu_torch/backends/
lease.py, the grant rider of backends/cuda.py, the service's host-local
answer, the fallback's lease consultation, leases.snap) on the CPU, against
the JAX package's.

* The JAX package's tests/test_lease.py runs on the port class by class
  (reference_tests_on_the_port): the wire codec, the lease table, the
  service's local answers, the registry snapshots and the inspect tool on a
  port-written file, the overshoot bound across a restart, the Runner, the
  dispatch loop, and the lease trailer on the sidecar wire
  (TestSidecarLeaseWire: grants and settles ride a port client's frames
  into a port owner's registry, and a sidecar-backed service answers from
  its leases). TestLeaseAcrossFailover waits for replication (item 9).
* One request stream through the JAX stack and the port's (direct engine,
  leases on, one fake clock each): the decisions, the ratelimit.lease.*
  counters and LeaseRegistry.export_rows equal; with leases off the port's
  decisions are the same, byte for byte.
* A failing engine behind FAILURE_MODE_DENY: outstanding leases answer
  before the rung, as in the JAX package.
* leases.snap written by either package restores into the other, floors
  included.
* The JAX Runner and the port's with VICTIM_TIER_ENABLED and LEASE_ENABLED
  on one v3/v2//json stream under one fake clock: the same answers, the
  same ratelimit.victim.* and ratelimit.lease.* families on /metrics and
  the same /debug/victim document.
"""

import http.client
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
grpc = pytest.importorskip("grpc")

import test_lease as jax_lease_tests  # noqa: E402
from test_torch_server import (  # noqa: E402
    _grpc_call,
    _json,
    _parity_stream,
    _twin_runners,
    _v2,
    _v3,
    http_call,
)
from test_torch_victim import reference_tests_on_the_port  # noqa: E402

from api_ratelimit_tpu.backends import fallback as jax_fallback  # noqa: E402
from api_ratelimit_tpu.limiter.cache import CacheError as JaxCacheError  # noqa: E402
from api_ratelimit_tpu.persist import snapshotter as jax_snapshotter  # noqa: E402
from api_ratelimit_tpu.utils import FakeTimeSource as JaxClock  # noqa: E402
from api_ratelimit_tpu_torch.backends import fallback as port_fallback  # noqa: E402
from api_ratelimit_tpu_torch.limiter.cache import CacheError  # noqa: E402
from api_ratelimit_tpu_torch.persist import snapshotter as port_snapshotter  # noqa: E402
from api_ratelimit_tpu_torch.stats import Store, TestSink  # noqa: E402
from api_ratelimit_tpu_torch.utils import FakeTimeSource  # noqa: E402

_REF = reference_tests_on_the_port(
    "test_lease",
    (
        ("api_ratelimit_tpu_torch.backends.tpu", "api_ratelimit_tpu_torch.backends.cuda"),
        ("TpuRateLimitCache", "CudaRateLimitCache"),
        ('backend_type="tpu"', 'backend_type="cuda"'),
        ("tpu_use_pallas=False,", ""),
        ("use_pallas=False", 'device="cpu"'),
        # the port's Runner runs its engine on the card unless asked
        ("sink=TestSink()", 'sink=TestSink(), device="cpu"'),
    ),
)

TestWireCodec = _REF.TestWireCodec
TestLeaseTableUnit = _REF.TestLeaseTableUnit
TestServiceLeaseLocal = _REF.TestServiceLeaseLocal
TestRegistrySnapshot = _REF.TestRegistrySnapshot
TestOvershootBound = _REF.TestOvershootBound
TestRunnerIntegration = _REF.TestRunnerIntegration
TestDispatchLoopArm = _REF.TestDispatchLoopArm
TestSidecarLeaseWire = _REF.TestSidecarLeaseWire

NOW = 1_000_000


def _stacks(lease=True, **kw):
    """(JAX stack, port stack), each (service, cache, lease table, store)
    on its own fake clock at NOW: the test modules' own _stack."""
    jax_ts, port_ts = JaxClock(NOW), FakeTimeSource(NOW)
    return (
        jax_ts,
        jax_lease_tests._stack(jax_ts, lease=lease, **kw),
        port_ts,
        _REF._stack(port_ts, lease=lease, **kw),
    )


def _stream(rng, n):
    """(descriptor key, value, hits, clock step) requests over a few hot
    keys of both rules, crossing the 100/minute limit, with TTL and window
    boundaries crossed by the clock."""
    out = []
    for _ in range(n):
        key = "api_key" if rng.random() < 0.7 else "open"
        value = f"k{int(min(rng.zipf(1.6), 4))}"
        out.append((key, value, int(rng.choice([1, 1, 1, 2])), int(rng.choice([0, 0, 0, 0, 1, 3, 20]))))
    return out


def _answer(service, request):
    """The overall code and each status as plain values (the two packages'
    enums and RateLimitValue are distinct classes)."""
    code, statuses, _headers = service.should_rate_limit(request)
    return int(code), [
        (
            int(s.code),
            s.limit_remaining,
            s.duration_until_reset,
            None if s.current_limit is None
            else (s.current_limit.requests_per_unit, int(s.current_limit.unit), s.current_limit.name),
        )
        for s in statuses
    ]


def _lease_counters(store):
    """ratelimit.lease.* without the host-time histogram (local_ms)."""
    return {k: v for k, v in store.debug_snapshot().items() if ".lease." in k and "_ms" not in k}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stream_matches_the_jax_stack(seed):
    """600 requests through both stacks, across lease TTLs and windows: the
    same decision per request, the same lease counters, the same
    outstanding liabilities and registry rows."""
    jax_ts, (jsvc, jcache, jtable, jstore), port_ts, (psvc, pcache, ptable, pstore) = _stacks()
    osvc, ocache, _otable, _ostore = _REF._stack(FakeTimeSource(NOW), lease=False)
    local = 0
    try:
        for key, value, hits, step in _stream(np.random.default_rng(seed), 600):
            for clock in (jax_ts, port_ts, ocache.engine._time_source):
                clock.advance(step)
            got = _answer(psvc, _REF._req(value, key, hits))
            assert got == _answer(jsvc, jax_lease_tests._req(value, key, hits))
            osvc.should_rate_limit(_REF._req(value, key, hits))
        counters = _lease_counters(pstore)
        assert counters == _lease_counters(jstore)
        local = counters["ratelimit.lease.local_hits"]
        assert ptable.outstanding() == jtable.outstanding()
        assert pcache.engine.lease_registry.outstanding() == jcache.engine.lease_registry.outstanding()
        now = port_ts.unix_now()
        assert np.array_equal(pcache.engine.lease_registry.export_rows(now), jcache.engine.lease_registry.export_rows(now))
        assert pcache.engine._decisions_total == jcache.engine._decisions_total < ocache.engine._decisions_total
    finally:
        for cache in (jcache, pcache, ocache):
            cache.close()
    assert local > 100


@pytest.mark.parametrize("seed", [3, 4])
def test_sequential_stream_is_byte_identical_leases_on_and_off(seed):
    """The reference's claim for one frontend (backends/lease.py): a
    sequential stream of single hits within one lease TTL makes the same
    decisions with leasing on and off, limits crossed, on fewer launches.
    (With hits_addend 2 the reference's own two arms differ too: a lease
    with one token left cannot cover two.)"""
    _jax_ts, _jax_stack, _port_ts, (psvc, pcache, _pt, _ps) = _stacks()
    osvc, ocache, _ot, _os = _REF._stack(FakeTimeSource(NOW), lease=False)
    codes = set()
    try:
        for key, value, _hits, _step in _stream(np.random.default_rng(seed), 400):
            got = _answer(psvc, _REF._req(value, key))
            assert got == _answer(osvc, _REF._req(value, key))
            codes.add(got[0])
        assert codes == {1, 2}
        assert pcache.engine._decisions_total < ocache.engine._decisions_total
    finally:
        pcache.close()
        ocache.close()


def test_failing_engine_answers_from_leases_like_the_jax_stack():
    """FAILURE_MODE_DENY=deny behind a failing engine: descriptors with a
    live lease are answered from it, the rest denied; the service's
    lease.degraded probe flips. Both packages give the same answers."""
    answers = []
    for pkg in ("jax", "port"):
        ts = JaxClock(NOW) if pkg == "jax" else FakeTimeSource(NOW)
        tests = jax_lease_tests if pkg == "jax" else _REF
        fb_mod = jax_fallback if pkg == "jax" else port_fallback
        err = JaxCacheError if pkg == "jax" else CacheError
        svc, cache, table, store = tests._stack(ts)
        svc.should_rate_limit(tests._req("a", "open"))  # grant a's lease
        svc._fallback = fb_mod.FallbackLimiter("deny", lease_table=table)

        def boom(*_a, **_k):
            raise err("card lost")

        # the JAX cache binds the engine's submit_rows at construction
        if pkg == "jax":
            cache._submit_rows = boom
        else:
            cache.engine.submit_rows = boom
        seen = [_answer(svc, tests._req(value, "open")) for value in ("a", "b", "a", "a")]
        answers.append((seen, table.degraded))
        cache.close()
    assert answers[0] == answers[1]
    seen, degraded = answers[1]
    assert [code for code, _ in seen] == [1, 2, 1, 1]  # a from its lease, b denied
    assert degraded  # b's miss reached the failing card


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_leases_snap_restores_across_the_packages(tmp_path, direction):
    """The same grants on both stacks write byte-identical slab.snap and
    leases.snap; either package's files restore into the other's engine
    with the same restore_stats, the same floored table and registry, and
    the restart admits no more than the limit."""
    jax_ts, (jsvc, jcache, _jt, _js), port_ts, (psvc, pcache, _pt, _ps) = _stacks()
    for _ in range(30):
        jsvc.should_rate_limit(jax_lease_tests._req())
        psvc.should_rate_limit(_REF._req())
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jax_snapshotter.SlabSnapshotter(jcache.engine, str(jdir), interval_ms=60_000, time_source=jax_ts).snapshot_once()
    port_snapshotter.SlabSnapshotter(pcache.engine, str(pdir), interval_ms=60_000, time_source=port_ts).snapshot_once()
    for name in ("slab.snap", "leases.snap"):
        assert (jdir / name).read_bytes() == (pdir / name).read_bytes()
    jcache.close()
    pcache.close()
    src = jdir if direction == "jax_to_port" else pdir
    jeng, peng = jax_lease_tests._engine(JaxClock(NOW)), _REF._engine(FakeTimeSource(NOW))
    jstats = jax_snapshotter.SlabSnapshotter(jeng, str(src), interval_ms=60_000, time_source=JaxClock(NOW)).restore()
    pstats = port_snapshotter.SlabSnapshotter(peng, str(src), interval_ms=60_000, time_source=FakeTimeSource(NOW)).restore()
    assert pstats == jstats and pstats["restored_leases"] == 1
    assert np.array_equal(peng.export_tables()[0], jeng.export_tables()[0])
    assert np.array_equal(peng.lease_registry.export_rows(NOW), jeng.lease_registry.export_rows(NOW))
    # the restored counter sits at the grant's floor: the fresh frontend
    # (no lease held) is admitted only up to the limit in the window
    base = _REF.BaseRateLimiter(FakeTimeSource(NOW), jitter_rand=random.Random(0), expiration_jitter_max_seconds=0)
    cache = _REF.CudaRateLimitCache(base, engine=peng)
    svc = _REF.RateLimitService(
        runtime=_REF._StaticRuntime(_REF.LEASE_YAML), cache=cache,
        stats_scope=Store(TestSink()).scope("ratelimit").scope("service"), time_source=base.time_source,
    )
    admitted = 30 + sum(svc.should_rate_limit(_REF._req())[0] == 1 for _ in range(120))
    cache.close()
    assert admitted <= 100


def _families(port, prefixes=("ratelimit_victim", "ratelimit_lease")):
    conn = http.client.HTTPConnection("localhost", port, timeout=30)
    conn.request("GET", "/metrics")
    text = conn.getresponse().read().decode()
    conn.close()
    # host-time histograms (lease.local_ms) differ run to run
    return sorted(
        line for line in text.splitlines() if any(p in line for p in prefixes) and "_ms" not in line
    )


@pytest.fixture
def tiered_runners(tmp_path):
    """The JAX and port Runners with the victim tier and leases on, over a
    16-slot slab (4 sets of 4 ways), so the stream's keys overflow it."""
    yield from _twin_runners(
        tmp_path,
        TPU_SLAB_SLOTS="16",
        VICTIM_TIER_ENABLED="true",
        VICTIM_MAX_ROWS="64",
        LEASE_ENABLED="true",
        LEASE_MIN="2",
        LEASE_MAX="8",
    )


def test_tiered_runners_answer_and_export_alike(tiered_runners):
    """The 300-request parity stream through both Runners: every serialized
    response and /json body equal, the slab tables and tier exports equal,
    and after a stats flush the ratelimit.victim.* and ratelimit.lease.*
    lines of /metrics and the /debug/victim documents equal."""
    jr, pr, clock = tiered_runners
    assert jr.lease_table is not None and pr.lease_table is not None
    # one flush each, at the end: a periodic flush runs the tier's reclaim
    # (VictimStats) at whatever clock its thread finds, in each runner apart
    for r in (jr, pr):
        r.stats_store.stop_flushing()
    rng = np.random.default_rng(5)
    for kind, descs, hits, override, step in _parity_stream(rng, 300):
        clock.advance(step)
        if kind == "json":
            body = _json(descs, hits)
            got = http_call(pr.server.http_port, "POST", "/json", body)
            want = http_call(jr.server.http_port, "POST", "/json", body)
        else:
            req = _v3(descs, hits, override) if kind == "v3" else _v2(descs, hits)
            got = _grpc_call(pr.server.grpc_port, kind, req)
            want = _grpc_call(jr.server.grpc_port, kind, req)
        assert got == want, (kind, descs, hits, override)
    jeng, peng = jr.service._cache.engine, pr.cache.engine
    assert np.array_equal(peng.export_tables()[0], jeng.export_tables()[0])
    assert np.array_equal(peng.victim_tier.export_rows(), jeng.victim_tier.export_rows())
    assert peng.victim_tier.demotes_total > 0 and peng.victim_tier.promotes_total > 0
    for r in (jr, pr):
        r.stats_store.flush()
    got, want = _families(pr.server.debug_port), _families(jr.server.debug_port)
    assert got == want
    assert any("ratelimit_victim_demotes" in line for line in got)
    assert any("ratelimit_lease_local_hits" in line for line in got)
    assert http_call(pr.server.debug_port, "GET", "/debug/victim") == http_call(jr.server.debug_port, "GET", "/debug/victim")
