"""The port's multi-device engine (api_ratelimit_tpu_torch/parallel/
sharded_slab.py and its wiring in backends/cuda.py) on CPU shards, against
the JAX package's ShardedSlabEngine on the 8 forced CPU devices of
tests/conftest.py.

* The JAX package's tests/test_sharded_slab.py runs on the port
  (reference_tests_on_the_port): TestShardedEngine (the cache over a mesh
  against the memory oracle; the two guard cases and the state layout are
  rewritten here, since they read JAX's use_pallas and sharding) and
  TestCompactedMode (compact against replicated, on the port alone: the JAX
  compact arm fails under the installed JAX). TestPerDeviceCostScaling reads
  XLA's cost analysis, which has no torch counterpart; in its place the
  compact arm's lanes per shard are held to b / N under balanced routing.
* The routed arm against the JAX routed arm: afters, per-shard tables,
  health and the routing snapshot's counts; 3 shards route by mod.
* The replicated arm's step_packed and step_after against the JAX
  replicated arm on fixed-window traffic.
* The compact arm against the port's routed arm and against one
  SetSlabOracle a shard.
* Tables exported from a JAX engine continue in the port byte for byte, and
  the other way round.
* Placement: make_mesh, mesh_devices, a mixed CPU/CUDA mesh refused.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from api_ratelimit_tpu.parallel import ShardedSlabEngine as JaxEngine  # noqa: E402
from api_ratelimit_tpu.parallel import make_mesh as jax_mesh  # noqa: E402
from api_ratelimit_tpu_torch.ops import slab as port_slab  # noqa: E402
from api_ratelimit_tpu_torch.parallel import ShardedSlabEngine, make_mesh, mesh_devices  # noqa: E402
from api_ratelimit_tpu_torch.parallel import sharded_slab as port_sharded  # noqa: E402
from api_ratelimit_tpu_torch.testing.oracle import SetSlabOracle  # noqa: E402
from test_torch_victim import reference_tests_on_the_port  # noqa: E402

_REF = reference_tests_on_the_port(
    "test_sharded_slab",
    (
        (
            "from api_ratelimit_tpu_torch.backends import MemoryRateLimitCache",
            "from api_ratelimit_tpu_torch.backends.memory import MemoryRateLimitCache",
        ),
        (
            "from api_ratelimit_tpu_torch.backends.tpu import TpuRateLimitCache",
            "from api_ratelimit_tpu_torch.backends.cuda import CudaRateLimitCache as TpuRateLimitCache",
        ),
        (
            "pytestmark = pytest.mark.skipif(\n"
            "    _sharded_slab.shard_map is None,\n"
            '    reason="this jax has neither jax.shard_map nor "\n'
            '    "jax.experimental.shard_map",\n'
            ")\n",
            "",
        ),
        ("        use_pallas=False,\n        mesh=mesh,", '        device="cpu",\n        mesh=mesh,'),
        (
            '    assert len(jax.devices()) == 8, "conftest must force the 8-device CPU mesh"\n'
            "    return make_mesh()",
            '    return make_mesh(["cpu"] * 8)',
        ),
    ),
)

N_DEV = 8
_fmix32 = _REF._fmix32


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(["cpu"] * N_DEV)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == N_DEV, "conftest must force the 8-device CPU mesh"
    return jax_mesh()


class TestShardedEngine(_REF.TestShardedEngine):
    def test_state_spans_mesh(self, mesh):
        """One slab a shard, each on its shard's device, the rows split
        evenly."""
        eng = ShardedSlabEngine(mesh=mesh, n_slots_global=8 * 256)
        assert len(eng._states) == 8
        assert all(s.table.shape == (256, 8) for s in eng._states)
        assert [s.device for s in eng._states] == list(mesh.devices)
        assert eng.shard_count == 8 and eng.shard_slots == 256 and eng.ways == 4

    def test_non_fixed_launch_flips_pallas_guard(self, mesh):
        """The sticky guard, mesh edition: a launch carrying a non-fixed
        algorithm flips algos_seen before it runs, and it and every later
        launch run the multi-algorithm body. Sliding-window and concurrency
        rows (a release decrements) give SetSlabOracle's counters."""
        from api_ratelimit_tpu_torch.ops.slab import (
            ALGO_CONC_RELEASE,
            ALGO_CONCURRENCY,
            ALGO_SHIFT,
            ALGO_SLIDING_WINDOW,
        )

        eng = ShardedSlabEngine(mesh=mesh, n_slots_global=8 * 256)
        assert eng.algos_seen is False
        oracles = [SetSlabOracle(256, eng.ways) for _ in range(8)]
        now = 1_000_000

        def launch(lo, hi, algo, limit):
            p = np.zeros((7, 128), dtype=np.uint32)
            p[0, 0], p[1, 0] = lo, hi
            p[2, 0], p[3, 0], p[4, 0] = 1, limit, 60 | (algo << ALGO_SHIFT)
            p[6, 0] = now
            p[6, 1] = np.float32(0.8).view(np.uint32)
            p[6, 2] = np.float32(1.0).view(np.uint32)
            got = int(eng.step_after_compact(p, 0xFFFF)[0])
            shard = (lo ^ hi) % 8
            want = oracles[shard].step_batch([(lo, hi, 1, limit, int(p[4, 0]), 0)], now)[1][0]
            assert got == want
            return got

        assert launch(1234, 0xABCD0001, ALGO_SLIDING_WINDOW, 10) == 1
        assert eng.algos_seen is True
        assert launch(1234, 0xABCD0001, ALGO_SLIDING_WINDOW, 10) == 2
        assert launch(5678, 0xBEEF0001, ALGO_CONCURRENCY, 3) == 1
        launch(5678, 0xBEEF0001, ALGO_CONC_RELEASE, 3)
        assert launch(5678, 0xBEEF0001, ALGO_CONCURRENCY, 3) == 1
        for table, oracle in zip(eng.export_tables(), oracles):
            assert np.array_equal(table.astype(np.uint64), oracle.table)

    def test_restored_algorithm_rows_flip_pallas_guard(self, mesh):
        eng = ShardedSlabEngine(mesh=mesh, n_slots_global=8 * 256)
        tables = [np.zeros((256, 8), dtype=np.uint32) for _ in range(8)]
        tables[3][0] = (1, 2, 3, 999_970, 1_000_050, 60 | (2 << 28), 1_000_030, 0)
        eng.import_tables(tables)
        assert eng.algos_seen is True


TestCompactedMode = _REF.TestCompactedMode


class TestPerShardLanes:
    """In place of TestPerDeviceCostScaling (XLA's compiled cost, which has
    no torch counterpart): under balanced routing each shard of the compact
    arm launches about b / N lanes, not b."""

    @pytest.mark.parametrize("n_dev", [2, 4, 8])
    def test_compact_lanes_per_shard_scale_inverse_n(self, n_dev):
        batch = 4096
        eng = ShardedSlabEngine(mesh=make_mesh(["cpu"] * n_dev), n_slots_global=n_dev * 4096)
        p = _REF.TestCompactedMode._packed(np.random.default_rng(9), batch, 1_000_000)
        ids = np.arange(batch, dtype=np.uint32)
        p[0], p[1], p[2] = _fmix32(ids), _fmix32(ids ^ np.uint32(0x9E3779B9)), 1
        eng.step_after_compact(p, 0xFFFF)
        snap = eng.shard_routing_snapshot()
        per_shard = snap["padded_lanes"] / n_dev
        # the bucket is the power of two over the fullest shard's rows
        assert per_shard == 1 << int(np.ceil(np.log2(max(snap["shard_rows"]))))
        assert per_shard <= 2 * batch / n_dev
        assert eng.shard_launches == [1] * n_dev


# -- the routed arm against the JAX routed arm ---------------------------


def _packed(ids, now, limit=40, div=50, hits=1):
    ids = np.asarray(ids, dtype=np.uint32)
    p = np.zeros((7, ids.size), dtype=np.uint32)
    p[0] = _fmix32(ids)
    p[1] = _fmix32(ids ^ np.uint32(0xA5A5A5A5))
    p[2] = hits
    p[3] = limit
    p[4] = div
    p[6, 0] = now
    p[6, 1] = np.float32(0.8).view(np.uint32)
    p[6, 2] = np.float32(1.0).view(np.uint32)
    return p


def _zipf(rng, b, n_keys):
    return (rng.zipf(1.1, size=b) % n_keys).astype(np.uint32)


def assert_same_engines(jeng, peng, now):
    """Per-shard tables, health and the routing snapshot (stage times
    aside) of a JAX and a port engine."""
    jt, pt = jeng.export_tables(), peng.export_tables()
    assert len(jt) == len(pt)
    for a, b in zip(jt, pt):
        assert np.array_equal(np.asarray(a), b)
    assert jeng.health_snapshot(now=now) == peng.health_snapshot(now=now)
    js, ps = jeng.shard_routing_snapshot(), peng.shard_routing_snapshot()
    js.pop("stage_ns")
    ps.pop("stage_ns")
    assert js == ps


class TestRoutedAgainstJax:
    @pytest.mark.parametrize("n_dev", [8, 3])
    def test_routed_stream_bit_exact(self, n_dev):
        """A seeded Zipf stream with window rollovers and a padding lane:
        afters, tables, health and routing counts equal. 3 shards route by
        (fp_lo ^ fp_hi) mod 3."""
        jeng = JaxEngine(mesh=jax_mesh(jax.devices()[:n_dev]), n_slots_global=n_dev * 1024, routed=True)
        peng = ShardedSlabEngine(mesh=make_mesh(["cpu"] * n_dev), n_slots_global=n_dev * 1024, routed=True)
        rng = np.random.default_rng(21 + n_dev)
        now = 1_000_000
        for _ in range(6):
            p = _packed(_zipf(rng, 512, 3000), now)
            p[2, -1] = 0
            assert np.array_equal(jeng.step_after_compact(p.copy(), 0xFFFF), peng.step_after_compact(p.copy(), 0xFFFF))
            now += 17
        assert_same_engines(jeng, peng, now)
        counts = peng.shard_routing_snapshot()["shard_rows"]
        assert len(counts) == n_dev and min(counts) > 0

    def test_launch_collect_split_and_narrow_caps(self, mesh):
        """Two launches in flight before a collect, caps 0xFF, 0xFFFF and
        0xFF again: the same afters as the JAX routed arm."""
        jeng = JaxEngine(mesh=jax_mesh(), n_slots_global=8 * 1024, routed=True)
        peng = ShardedSlabEngine(mesh=mesh, n_slots_global=8 * 1024, routed=True)
        rng = np.random.default_rng(5)
        blocks = [_packed(_zipf(rng, 300, 500), 1_000_000 + 7 * i, limit=900, hits=3) for i in range(3)]
        caps = (0xFF, 0xFFFF, 0xFF)
        want = [jeng.step_after_compact(p.copy(), c) for p, c in zip(blocks, caps)]
        tokens = [peng.launch_after_compact(p.copy(), c) for p, c in zip(blocks[:2], caps)]
        got = [peng.collect_after_compact(tokens[0])]
        tokens.append(peng.launch_after_compact(blocks[2].copy(), caps[2]))
        got += [peng.collect_after_compact(t) for t in tokens[1:]]
        assert int(want[2].max()) == 0xFF  # the u8 cap saturates
        for w, g in zip(want, got):
            assert np.array_equal(w, g)
        assert_same_engines(jeng, peng, 1_000_014)


class TestReplicatedAgainstJax:
    def test_step_packed_and_step_after_bit_exact(self, mesh, jmesh):
        """The replicated arm on fixed-window traffic: every decided row
        (code, remaining, duration, throttle, near, over, before, after) of
        step_packed and the saturated counters of step_after equal the JAX
        replicated arm's, and so do the tables and health."""
        jeng = JaxEngine(mesh=jmesh, n_slots_global=8 * 1024)
        peng = ShardedSlabEngine(mesh=mesh, n_slots_global=8 * 1024)
        rng = np.random.default_rng(8)
        now = 1_000_000
        for i in range(6):
            p = _packed(_zipf(rng, 512, 300), now, limit=5)
            p[2, -1] = 0
            if i % 2:
                want, got = np.asarray(jeng.step_packed(p.copy())), peng.step_packed(p.copy())
                assert got.shape == (8, 512)
            else:
                want, got = np.asarray(jeng.step_after(p.copy(), cap=0xFFFF)), peng.step_after(p.copy(), cap=0xFFFF)
            assert got.dtype == want.dtype
            assert np.array_equal(got, want), i
            now += 17
        assert_same_engines(jeng, peng, now)

    def test_replicated_launches_every_shard_and_refuses_on_routed(self, mesh):
        eng = ShardedSlabEngine(mesh=mesh, n_slots_global=8 * 256)
        eng.step_after(_packed(np.arange(4), 1_000_000))
        assert eng.shard_launches == [1] * 8
        routed = ShardedSlabEngine(mesh=mesh, n_slots_global=8 * 256, routed=True)
        for verb in (routed.step_packed, routed.step_after):
            with pytest.raises(RuntimeError, match="replicated-arm"):
                verb(_packed(np.arange(4), 1_000_000))


# -- the compact arm: the port's routed arm and SetSlabOracle --------------


def _oracle_items(n, rng):
    """Fingerprints with distinct top-16 fp_hi bits (SetSlabOracle's modelled
    restriction on colliding distinct keys)."""
    lo = _fmix32(np.arange(n, dtype=np.uint32) + np.uint32(77))
    hi = (np.arange(n, dtype=np.uint32) << np.uint32(16)) | rng.integers(0, 1 << 16, n).astype(np.uint32)
    return lo, hi


class TestCompactArm:
    def test_compact_equals_routed_and_the_oracle(self, mesh):
        """Over a stream past the shards' capacity (evictions and drops), the
        compact arm's afters and tables equal the routed arm's and one
        SetSlabOracle a shard; only the padding differs."""
        n_keys = 3000
        rng = np.random.default_rng(13)
        lo, hi = _oracle_items(n_keys, rng)
        compact = ShardedSlabEngine(mesh=mesh, n_slots_global=8 * 256)
        routed = ShardedSlabEngine(mesh=mesh, n_slots_global=8 * 256, routed=True)
        oracles = [SetSlabOracle(256, compact.ways) for _ in range(8)]
        now = 1_000_000
        for _ in range(8):
            ids = (rng.zipf(1.2, size=400) % n_keys).astype(np.int64)
            p = np.zeros((7, 512), dtype=np.uint32)
            p[0, :400], p[1, :400] = lo[ids], hi[ids]
            p[2, :400], p[3, :400], p[4, :400] = 1, 20, 30
            p[6, 0] = now
            a_c = compact.step_after_compact(p.copy(), 0xFFFF)
            a_r = routed.step_after_compact(p.copy(), 0xFFFF)
            assert np.array_equal(a_c, a_r)
            owner = (p[0, :400] ^ p[1, :400]) % 8
            want = np.zeros(400, dtype=np.uint32)
            for d in range(8):
                idx = np.flatnonzero(owner == d)
                items = [(int(p[0, i]), int(p[1, i]), 1, 20, 30, 0) for i in idx]
                want[idx] = oracles[d].step_batch(items, now)[1]
            assert np.array_equal(a_c[:400], want)
            now += 11
        health = [0] * 5
        for tc, tr, o in zip(compact.export_tables(), routed.export_tables(), oracles):
            assert np.array_equal(tc, tr)
            assert np.array_equal(tc.astype(np.uint64), o.table)
            health = [a + b for a, b in zip(health, o.health)]
        snap = compact.health_snapshot(now=now)
        assert [snap[k] for k in ("evictions_expired", "evictions_window", "evictions_live", "drops", "algo_resets")] == health
        assert snap["evictions_live"] + snap["drops"] > 0  # the stream went past capacity
        c, r = compact.shard_routing_snapshot(), routed.shard_routing_snapshot()
        assert c["rows"] == r["rows"] and c["padded_lanes"] >= r["padded_lanes"]


# -- state across the packages ------------------------------------------------


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_tables_continue_across_packages(mesh, jmesh, direction):
    """A stream's first half on one package's engine, export_tables into the
    other's import_tables, the second half there: afters and tables equal an
    uninterrupted engine of the first package."""
    rng = np.random.default_rng(17)
    blocks = [_packed(_zipf(rng, 256, 2000), 1_000_000 + 9 * i) for i in range(4)]

    def make(pkg):
        if pkg == "jax":
            return JaxEngine(mesh=jmesh, n_slots_global=8 * 1024, routed=True)
        return ShardedSlabEngine(mesh=mesh, n_slots_global=8 * 1024, routed=True)

    first, second = direction.split("_to_")
    whole, a = make(first), make(first)
    want = [whole.step_after_compact(p.copy(), 0xFFFF) for p in blocks]
    got = [a.step_after_compact(p.copy(), 0xFFFF) for p in blocks[:2]]
    b = make(second)
    b.import_tables([np.asarray(t) for t in a.export_tables()])
    got += [b.step_after_compact(p.copy(), 0xFFFF) for p in blocks[2:]]
    for w, g in zip(want, got):
        assert np.array_equal(w, g)
    for tw, tb in zip(whole.export_tables(), b.export_tables()):
        assert np.array_equal(np.asarray(tw), np.asarray(tb))


# -- the cache over a mesh, against the JAX cache over its mesh ----------------


def test_cache_over_mesh_matches_jax_cache(jmesh):
    """CudaRateLimitCache(mesh=) on 8 CPU shards and the JAX
    TpuRateLimitCache(mesh=) on its 8 CPU devices answer one request stream
    alike (code, remaining, reset), and their shard tables are equal."""
    from api_ratelimit_tpu.backends.tpu import TpuRateLimitCache
    from api_ratelimit_tpu.limiter import BaseRateLimiter as JaxBase
    from api_ratelimit_tpu.models.config import RateLimit as JaxLimit
    from api_ratelimit_tpu.models.config import new_rate_limit_stats as jax_stats
    from api_ratelimit_tpu.models.response import RateLimitValue as JaxValue
    from api_ratelimit_tpu.stats import Store as JaxStore
    from api_ratelimit_tpu.stats import TestSink as JaxSink
    from api_ratelimit_tpu.utils import FakeTimeSource as JaxClock
    from api_ratelimit_tpu_torch.backends.cuda import CudaRateLimitCache
    from api_ratelimit_tpu_torch.limiter import BaseRateLimiter
    from api_ratelimit_tpu_torch.models.config import RateLimit, new_rate_limit_stats
    from api_ratelimit_tpu_torch.models.response import RateLimitValue
    from api_ratelimit_tpu_torch.stats import Store, TestSink
    from api_ratelimit_tpu_torch.utils import FakeTimeSource

    jclock, pclock = JaxClock(1_700_000_000), FakeTimeSource(1_700_000_000)
    jcache = TpuRateLimitCache(
        JaxBase(jclock, local_cache=None, near_limit_ratio=0.8), n_slots=8 * 512,
        buckets=(128, 1024), max_batch=1024, use_pallas=False, mesh=jmesh, hotkey_lanes=32,
    )
    pcache = CudaRateLimitCache(
        BaseRateLimiter(pclock, local_cache=None, near_limit_ratio=0.8), n_slots=8 * 512,
        buckets=(128, 1024), max_batch=1024, device="cpu", mesh=["cpu"] * 8, hotkey_lanes=32,
    )
    jstore, pstore = JaxStore(JaxSink()), Store(TestSink())
    jl = [JaxLimit(full_key=f"u_{i}", stats=jax_stats(jstore, f"u_{i}"), limit=JaxValue(requests_per_unit=6, unit=_REF.Unit.MINUTE)) for i in range(40)]
    pl = [RateLimit(full_key=f"u_{i}", stats=new_rate_limit_stats(pstore, f"u_{i}"), limit=RateLimitValue(requests_per_unit=6, unit=_REF.Unit.MINUTE)) for i in range(40)]
    from api_ratelimit_tpu.models import Descriptor as JD
    from api_ratelimit_tpu.models import RateLimitRequest as JR

    rng = np.random.default_rng(4)
    for step in range(60):
        idx = rng.choice(40, size=int(rng.integers(1, 5)), replace=False).tolist()
        pairs = [("user", str(i)) for i in idx]
        jr = jcache.do_limit(JR(domain="d", descriptors=tuple(JD.of(p) for p in pairs), hits_addend=1), [jl[i] for i in idx])
        pr = pcache.do_limit(_REF.req(*pairs, domain="d"), [pl[i] for i in idx])
        for a, b in zip(jr.descriptor_statuses, pr.descriptor_statuses):
            assert (int(a.code), a.limit_remaining, a.duration_until_reset) == (int(b.code), b.limit_remaining, b.duration_until_reset), step
        if step % 10 == 9:
            jclock.advance(13)
            pclock.advance(13)
    for a, b in zip(jcache.engine.export_tables(), pcache.engine.export_tables()):
        assert np.array_equal(np.asarray(a), b)
    assert jcache.engine.drain_hotkeys() == pcache.engine.drain_hotkeys()
    assert jcache.engine.shard_routing_snapshot()["shard_rows"] == pcache.engine.shard_routing_snapshot()["shard_rows"]
    with pytest.raises(_cache_error()):
        pcache.engine.merge_rows(np.zeros((0, 8), np.uint32))
    jcache.close()
    pcache.close()


def _cache_error():
    from api_ratelimit_tpu_torch.limiter.cache import CacheError

    return CacheError


# -- placement -------------------------------------------------------------------


def test_make_mesh_and_placement(monkeypatch, caplog):
    m = make_mesh(["cpu", "cpu", "cpu"])
    assert m.size == 3 and m.axis == "shard" and all(d.type == "cpu" for d in m.devices)
    assert mesh_devices(4, "cpu") == ["cpu"] * 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            mesh_devices(4, "cuda")
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            make_mesh()
    # shard i on cuda:(i mod the cards present), logged
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with caplog.at_level(logging.INFO, logger=port_sharded.__name__):
        assert mesh_devices(4, "cuda") == ["cuda:0", "cuda:1", "cuda:2", "cuda:0"]
    assert any("mesh of 4 shards" in r.message for r in caplog.records)
    with pytest.raises(ValueError, match="all be on cuda or all on the cpu"):
        make_mesh(["cpu", "cuda:0"])


def test_bad_geometry_and_cpu_default_ways(mesh):
    with pytest.raises(ValueError, match="power of two"):
        ShardedSlabEngine(mesh=mesh, n_slots_global=8 * 300)
    eng = ShardedSlabEngine(mesh=mesh, n_slots_global=8 * 256, ways=8)
    assert eng.ways == 8
    assert ShardedSlabEngine(mesh=mesh, n_slots_global=8 * 256).ways == port_slab.DEFAULT_WAYS_HOST
