"""The port's victim tier (api_ratelimit_tpu_torch/backends/victim.py, the
demote readback and slab_promote_rows of ops/slab.py, the engine's promote
pass and demote drain in backends/cuda.py, victim.snap in
persist/snapshotter.py) on the CPU, against the JAX package's.

* The JAX package's tests/test_victim.py runs on the port class by class:
  TestVictimTierUnit, TestEngineHierarchy, TestDifferentialOracle (5x the
  slab, and the tier-off control), TestHotKeysNeverDemote, TestFaultSites
  (the port's FaultInjector, testing/faults.py), TestPersistRoundTrip and TestVictimStats, with every import
  of the JAX package pointed at the port (reference_tests_on_the_port).
  TestPromoteKernel and TestRollbackArm build JAX arrays, so they are
  rewritten here, each case run through both packages and held bit-exact.
* slab_promote_rows against the JAX one (XLA, its default multi_algo scan):
  table bytes, landed and displaced bit-exact for an empty way, a swap with
  a displaced row, a stale match, a newer match, a same-slot collision,
  padding, an expired tier row, sliding and GCRA rows inside the grace, and
  seeded random tables.
* slab_step_after(victim=True) against the JAX twin, multi_algo and the
  sketch both ways, under eviction pressure: readback, afters, health,
  table and sketch bit-exact; victim=False gives the same bytes without the
  readback, and the launches of both arms are the same kernels.
* VictimTier against the JAX tier on the same operations; the engines of
  both packages on one stream (afters, tables, tier exports, describe,
  VictimStats and /debug/victim); victim.snap written by either package
  restores into the other.
"""

import os
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from api_ratelimit_tpu.backends import tpu as jax_tpu  # noqa: E402
from api_ratelimit_tpu.backends.victim import VictimTier as JaxTier  # noqa: E402
from api_ratelimit_tpu.ops import sketch as jax_sketch  # noqa: E402
from api_ratelimit_tpu.ops import slab as jax_slab  # noqa: E402
from api_ratelimit_tpu.persist import snapshotter as jax_snapshotter  # noqa: E402
from api_ratelimit_tpu.stats import Store as JaxStore  # noqa: E402
from api_ratelimit_tpu.stats import TestSink as JaxSink  # noqa: E402
from api_ratelimit_tpu.utils import FakeTimeSource as JaxClock  # noqa: E402
from api_ratelimit_tpu_torch.backends import cuda as port_cuda  # noqa: E402
from api_ratelimit_tpu_torch.backends.victim import VictimTier  # noqa: E402
from api_ratelimit_tpu_torch.ops import sketch as port_sketch  # noqa: E402
from api_ratelimit_tpu_torch.ops import slab as port_slab  # noqa: E402
from api_ratelimit_tpu_torch.persist import snapshotter as port_snapshotter  # noqa: E402
from api_ratelimit_tpu_torch.persist.snapshot import (  # noqa: E402
    COL_COUNT,
    COL_EXPIRE,
    COL_FP_HI,
    COL_FP_LO,
    ROW_WIDTH,
    reconcile_rows,
)
from api_ratelimit_tpu_torch.stats import Store, TestSink  # noqa: E402
from api_ratelimit_tpu_torch.testing.oracle import VictimOracle  # noqa: E402
from api_ratelimit_tpu_torch.utils import FakeTimeSource  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))


def reference_tests_on_the_port(name: str, replacements=()) -> types.ModuleType:
    """The JAX package's tests/<name>.py with every import of the JAX
    package pointed at the port's module of the same path, and each
    (old, new) text replacement applied where the two packages' names
    differ (each must be found: a reference edit that drops one fails
    here, not silently)."""
    path = os.path.join(TESTS, name + ".py")
    with open(path) as f:
        src = re.sub(r"\bapi_ratelimit_tpu\b", "api_ratelimit_tpu_torch", f.read())
    for old, new in replacements:
        assert old in src, f"{name}.py no longer holds {old!r}"
        src = src.replace(old, new)
    mod = types.ModuleType("port_" + name)
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


_REF = reference_tests_on_the_port(
    "test_victim",
    (
        ("api_ratelimit_tpu_torch.backends.tpu", "api_ratelimit_tpu_torch.backends.cuda"),
        ('kw.setdefault("use_pallas", False)', 'kw.setdefault("device", "cpu")'),
    ),
)

TestVictimTierUnit = _REF.TestVictimTierUnit
TestEngineHierarchy = _REF.TestEngineHierarchy
TestDifferentialOracle = _REF.TestDifferentialOracle
TestHotKeysNeverDemote = _REF.TestHotKeysNeverDemote
TestFaultSites = _REF.TestFaultSites
TestPersistRoundTrip = _REF.TestPersistRoundTrip
TestVictimStats = _REF.TestVictimStats

NOW = _REF.NOW
row, rows, fp_of, split = _REF.row, _REF.rows, _REF.fp_of, _REF.split


def _item(fp, hits=1, limit=100, divider=3600):
    return port_cuda._Item(fp=fp, hits=hits, limit=limit, divider=divider, jitter=0)


def _jax_item(fp, hits=1, limit=100, divider=3600):
    return jax_tpu._Item(fp=fp, hits=hits, limit=limit, divider=divider, jitter=0)


def _engines(victim_max_rows=64, n_slots=8, ways=2, **kw):
    """(JAX engine on the XLA twin, port engine on the CPU), one geometry,
    each on its own clock at NOW."""
    common = dict(n_slots=n_slots, ways=ways, buckets=(16,), victim_max_rows=victim_max_rows, **kw)
    return (
        jax_tpu.SlabDeviceEngine(JaxClock(NOW), use_pallas=False, **common),
        port_cuda.SlabDeviceEngine(FakeTimeSource(NOW), device="cpu", **common),
    )


# -- slab_promote_rows against the JAX one --------------------------------


def _promote_both(table, blk, now=NOW, ways=2):
    """Run one promote on both packages from the same table; assert table
    bytes, landed and displaced bit-exact; return the port's (table,
    landed, displaced) as numpy."""
    blk = np.asarray(blk, dtype=np.uint32)
    jstate, jlanded, jdisplaced = jax_slab.slab_promote_rows(
        jax_slab.SlabState(table=jnp.asarray(table)), jnp.asarray(blk), now, ways=ways
    )
    state = port_slab.slab_import_rows(table, "cpu")
    landed, displaced = port_slab.slab_promote_rows(state, blk, now, ways=ways)
    got = port_slab.slab_export_copy(state)
    assert np.array_equal(got, np.asarray(jstate.table))
    assert np.array_equal(landed.numpy(), np.asarray(jlanded))
    assert displaced.dtype == torch.uint32
    assert np.array_equal(displaced.numpy(), np.asarray(jdisplaced))
    return got, landed.numpy(), displaced.numpy()


def _occupied(set_rows, n=8, ways=2):
    """A table with the given {set: [(uid, count), ...]} rows in the set's
    first ways."""
    table = np.zeros((n, ROW_WIDTH), dtype=np.uint32)
    for set_idx, entries in set_rows.items():
        for w, (uid, count) in enumerate(entries):
            lo, hi = split(fp_of(set_idx, uid))
            table[set_idx * ways + w] = row(lo, hi, count)
    return table


def _random_multi_table(rng, n=64):
    """Random rows of every algorithm around NOW: live, expired, window
    ended, sliding rows in their grace."""
    t = np.zeros((n, ROW_WIDTH), np.uint32)
    occ = rng.random(n) < 0.8
    k = int(occ.sum())
    t[occ, 0] = rng.integers(0, 2**32, k, dtype=np.uint64)
    t[occ, 1] = rng.integers(0, 2**32, k, dtype=np.uint64)
    t[occ, 2] = rng.integers(0, 50, k)
    div = rng.choice([1, 60, 3600], k)
    t[occ, 3] = NOW - rng.integers(0, 7200, k)
    t[occ, 4] = NOW + rng.integers(-100, 4000, k)
    t[occ, 5] = div | (rng.integers(0, 3, k) << 28)
    t[occ, 6] = rng.integers(0, 50, k)
    return t


class TestPromoteKernel:
    """The reference's TestPromoteKernel cases on both packages, bit-exact,
    with its assertions on the port's results."""

    def test_promote_lands_in_empty_way(self):
        lo, hi = split(fp_of(1, 3))
        table, landed, _ = _promote_both(np.zeros((8, ROW_WIDTH), np.uint32), rows(row(lo, hi, count=9)))
        assert landed.tolist() == [True]
        hit = (table[:, COL_FP_LO] == lo) & (table[:, COL_FP_HI] == hi)
        assert int(table[hit][0, COL_COUNT]) == 9

    def test_promote_swaps_and_reports_displaced(self):
        lo, hi = split(fp_of(2, 7))
        table, landed, displaced = _promote_both(_occupied({2: [(1, 5), (2, 3)]}), rows(row(lo, hi, 40)))
        assert landed.tolist() == [True]
        live = displaced[displaced[:, COL_EXPIRE] != 0]
        assert live.shape[0] == 1 and int(live[0, COL_COUNT]) == 3
        assert int(table[table[:, COL_FP_LO] == lo][0, COL_COUNT]) == 40

    def test_stale_promote_is_noop_but_lands(self):
        lo, hi = split(fp_of(0, 4))
        stale = row(lo, hi, count=99, window=NOW - 3600)
        table, landed, displaced = _promote_both(_occupied({0: [(4, 8)]}), rows(stale))
        assert landed.tolist() == [True]
        assert int(table[table[:, COL_FP_LO] == lo][0, COL_COUNT]) == 8
        assert displaced[displaced[:, COL_EXPIRE] != 0].shape[0] == 0

    def test_newer_promote_overwrites_match(self):
        lo, hi = split(fp_of(0, 4))
        table, landed, _ = _promote_both(_occupied({0: [(4, 8)]}), rows(row(lo, hi, count=12)))
        assert landed.tolist() == [True]
        assert int(table[table[:, COL_FP_LO] == lo][0, COL_COUNT]) == 12

    def test_same_slot_collision_serializes(self):
        lo_a, hi_a = split(fp_of(3, 7))
        lo_b, hi_b = split(fp_of(3, 8))
        blk = rows(row(lo_a, hi_a, 5), row(lo_b, hi_b, 6))
        table, landed, _ = _promote_both(_occupied({3: [(1, 50), (2, 60)]}), blk)
        assert sorted(landed.tolist()) == [False, True]
        present = {(int(r[COL_FP_LO]), int(r[COL_FP_HI])) for r in table if r[COL_EXPIRE]}
        assert len({(lo_a, hi_a), (lo_b, hi_b)} & present) == 1

    def test_padding_rows_inert(self):
        blk = np.zeros((4, ROW_WIDTH), dtype=np.uint32)
        lo, hi = split(fp_of(1, 2))
        blk[1] = row(lo, hi, 3)
        table, landed, displaced = _promote_both(np.zeros((8, ROW_WIDTH), np.uint32), blk)
        assert landed.tolist() == [False, True, False, False]
        assert int((table[:, COL_EXPIRE] != 0).sum()) == 1
        assert displaced[displaced[:, COL_EXPIRE] != 0].shape[0] == 0

    def test_expired_tier_row_drops_unlanded(self):
        lo, hi = split(fp_of(1, 2))
        table, landed, _ = _promote_both(np.zeros((8, ROW_WIDTH), np.uint32), rows(row(lo, hi, 3, expire=NOW - 5)))
        assert landed.tolist() == [False]
        assert int((table[:, COL_EXPIRE] != 0).sum()) == 0

    def test_sliding_and_gcra_rows_inside_the_grace(self):
        """Set 1 holds a sliding row whose window ended 10 s ago (inside
        its one-window grace: live to the multi scan) and a fixed row whose
        window ended as long ago; set 2 a GCRA row and a fixed one. The
        promote's scan is the multi-algorithm form, as the reference's
        default: it takes the window-ended fixed way and leaves the sliding
        row, and nothing live is displaced."""
        ended = NOW - 3600 - 10
        table = np.zeros((8, ROW_WIDTH), np.uint32)
        for slot, (uid, count, algo) in ((2, (1, 1, 1)), (3, (2, 5, 0)), (4, (3, 2, 2)), (5, (4, 7, 0))):
            lo, hi = split(fp_of(slot // 2, uid))
            table[slot] = row(lo, hi, count, window=ended, expire=NOW + 3000, divider=3600 | (algo << 28), prev=3)
        sliding = table[2].copy()
        blk = np.zeros((4, ROW_WIDTH), np.uint32)
        for i, (set_idx, uid) in enumerate(((1, 9), (2, 9))):
            lo, hi = split(fp_of(set_idx, uid))
            blk[i] = row(lo, hi, 4)
        got, landed, displaced = _promote_both(table, blk)
        assert landed.tolist() == [True, True, False, False]
        assert np.array_equal(got[2], sliding)
        assert displaced[displaced[:, COL_EXPIRE] != 0].shape[0] == 0

    @pytest.mark.parametrize("seed", range(6))
    def test_random_tables_match_the_reference(self, seed):
        """Seeded multi-algorithm tables at W = 4 and 16-row promotes:
        matches (newer and stale), new keys into crowded sets, expired
        and padding lanes, in a shuffled order."""
        rng = np.random.default_rng(seed)
        t = _random_multi_table(rng)
        blk = np.zeros((16, ROW_WIDTH), np.uint32)
        occupied = np.flatnonzero(t[:, COL_EXPIRE])
        for i in range(12):
            r = t[occupied[int(rng.integers(0, occupied.size))]].copy()
            if i < 5:
                r[COL_COUNT] += int(rng.integers(0, 3))
                r[3] = int(r[3]) + int(rng.integers(-1, 2)) * 60
            else:
                r[0] = (r[0] & ~np.uint32(15)) | np.uint32(rng.integers(0, 16))
                r[1] = rng.integers(0, 2**32, dtype=np.uint64)
                r[4] = NOW + int(rng.integers(-10, 3000))
            blk[i] = r
        rng.shuffle(blk)
        _promote_both(t, blk, ways=4)


# -- slab_step_after(victim=True) against the JAX twin ---------------------


def _pressure_operand(rng, step, multi):
    b = 64
    packed = np.zeros((7, b), np.uint32)
    ids = rng.integers(0, 300, b)
    packed[0] = (ids * 2654435761) & 0xFFFFFFFF
    packed[1] = (ids * 40503 + 7) & 0xFFFFFFFF
    packed[2] = rng.integers(0, 3, b)
    packed[3] = 5
    packed[4] = 60 | ((rng.integers(0, 3, b) << 28) if multi else 0)
    packed[6, 0] = NOW + 10 * step
    return packed


@pytest.mark.parametrize("sketch", [False, True], ids=["sketch_off", "sketch_on"])
@pytest.mark.parametrize("multi", [False, True], ids=["fixed", "multi"])
def test_step_after_victim_readback_matches_the_reference(multi, sketch):
    """Eight launches of 64 items over 300 keys into 64 slots of 4 ways
    (live evictions from the fourth on): the readback, afters, health,
    table and sketch planes equal the JAX twin's every launch; a third
    state stepped with victim=False gives the same afters, health, table
    and planes, without the readback."""
    rng = np.random.default_rng(1)
    n, ways, lanes = 64, 4, 16
    sw = port_sketch.sketch_ways(ways, lanes) if sketch else 0
    jstate, pstate, ostate = jax_slab.make_slab(n), port_slab.make_slab(n, "cpu"), port_slab.make_slab(n, "cpu")
    jsk = jnp.asarray(jax_sketch.make_sketch(lanes)) if sketch else None
    psk = port_sketch.make_sketch(lanes, "cpu") if sketch else None
    osk = port_sketch.make_sketch(lanes, "cpu") if sketch else None
    demoted = 0
    for step in range(8):
        packed = _pressure_operand(rng, step, multi)
        jout = jax_slab.slab_step_after(
            jstate, jnp.asarray(packed), ways=ways, multi_algo=multi, sketch=jsk, sketch_ways=sw, victim=True
        )
        pout = port_slab.slab_step_after(pstate, packed, ways=ways, multi_algo=multi, sketch=psk, sketch_ways=sw, victim=True)
        oout = port_slab.slab_step_after(ostate, packed, ways=ways, multi_algo=multi, sketch=osk, sketch_ways=sw)
        jstate = jout[0]
        assert len(pout) == len(oout) + 1 == (4 if sketch else 3)
        assert pout[-1].dtype == torch.uint32 and tuple(pout[-1].shape) == (64, ROW_WIDTH)
        assert np.array_equal(pout[-1].numpy(), np.asarray(jout[-1]))
        assert np.array_equal(pout[0].numpy(), np.asarray(jout[1]))
        assert pout[1].tolist() == np.asarray(jout[2]).tolist()
        table = port_slab.slab_export_copy(pstate)
        assert np.array_equal(table, np.asarray(jstate.table))
        assert np.array_equal(port_slab.slab_export_copy(ostate), table)
        assert torch.equal(oout[0], pout[0]) and torch.equal(oout[1], pout[1])
        if sketch:
            jsk, psk, osk = jout[3], pout[2], oout[2]
            assert np.array_equal(port_sketch.sketch_export_copy(psk), np.asarray(jsk))
            assert torch.equal(osk, psk)
        demoted += int((pout[-1].numpy()[:, COL_EXPIRE] != 0).sum())
    assert demoted > 10  # the readback had rows to carry


class TestRollbackArm:
    """VICTIM_TIER_ENABLED=false is the tier-less engine byte for byte (the
    reference's TestRollbackArm on the port), and slab_step_after's
    victim=False is the default with the tier-less arity."""

    def _make_service(self, victim_max_rows):
        from test_algorithms import FakeRuntime

        from api_ratelimit_tpu_torch.limiter import BaseRateLimiter
        from api_ratelimit_tpu_torch.models import Descriptor, RateLimitRequest
        from api_ratelimit_tpu_torch.service.ratelimit import RateLimitService

        yaml_text = (
            "domain: vic\n"
            "descriptors:\n"
            "  - key: k\n"
            "    rate_limit: {unit: hour, requests_per_unit: 5}\n"
        )
        ts = FakeTimeSource(NOW)
        base = BaseRateLimiter(ts, near_limit_ratio=0.8)
        cache = port_cuda.CudaRateLimitCache(
            base, n_slots=1 << 12, buckets=(128,), max_batch=128, device="cpu",
            victim_max_rows=victim_max_rows,
        )
        svc = RateLimitService(
            runtime=FakeRuntime({"config.vic": yaml_text}),
            cache=cache,
            stats_scope=Store(TestSink()).scope("ratelimit.service"),
            time_source=ts,
        )

        def req(tenant):
            return RateLimitRequest(domain="vic", descriptors=(Descriptor.of(("k", tenant)),), hits_addend=1)

        return svc, cache, req

    def test_off_and_on_arms_agree_byte_for_byte(self):
        svc_off, cache_off, req = self._make_service(0)
        svc_on, cache_on, _ = self._make_service(1 << 10)
        assert not cache_off.engine.victim_enabled
        assert cache_on.engine.victim_enabled
        captured = {"off": [], "on": []}
        for label, cache in (("off", cache_off), ("on", cache_on)):
            batcher = cache.engine.batcher
            real = batcher._execute

            def spy(blocks, _real=real, _bucket=captured[label]):
                _bucket.append([np.array(b) for b in blocks])
                return _real(blocks)

            batcher._execute = spy
        verdicts = {"off": [], "on": []}
        for label, svc in (("off", svc_off), ("on", svc_on)):
            for _ in range(8):
                verdicts[label].append(svc.should_rate_limit(req("t"))[0])
            for i in range(4):
                verdicts[label].append(svc.should_rate_limit(req(f"cold{i}"))[0])
        assert verdicts["off"] == verdicts["on"]
        rows_off = np.concatenate([b for bs in captured["off"] for b in bs], axis=1)
        rows_on = np.concatenate([b for bs in captured["on"] for b in bs], axis=1)
        np.testing.assert_array_equal(rows_off, rows_on)
        np.testing.assert_array_equal(cache_off.engine.export_tables()[0], cache_on.engine.export_tables()[0])
        assert cache_on.engine.victim_tier.rows == 0
        assert cache_off.victim_debug() == {"enabled": False}

    def test_victim_false_compiles_pre_tier_arity(self):
        import inspect

        assert inspect.signature(port_slab.slab_step_after).parameters["victim"].default is False
        packed = np.zeros((7, 16), dtype=np.uint32)
        lo, hi = split(fp_of(0, 1))
        packed[0, 0], packed[1, 0] = lo, hi
        packed[2, 0], packed[3, 0] = 1, 10
        packed[4, 0] = 3600
        packed[6, 0] = NOW
        out_default = port_slab.slab_step_after(port_slab.make_slab(8, "cpu"), packed, ways=2)
        assert len(out_default) == 2
        out_on = port_slab.slab_step_after(port_slab.make_slab(8, "cpu"), packed, ways=2, victim=True)
        assert len(out_on) == 3
        assert tuple(out_on[-1].shape) == (16, ROW_WIDTH) and out_on[-1].dtype == torch.uint32
        assert torch.equal(out_default[0], out_on[0])

    def test_both_arms_run_the_same_kernels_until_a_promote(self, monkeypatch):
        """The launches of a submit, counted at the port's kernel wrappers:
        with no live eviction the tier-on engine runs exactly the tier-off
        engine's way scan and apply; a promote adds one way scan, in its
        multi-algorithm form (the reference's _choose_ways default)."""
        calls = []
        real_scan, real_apply = port_slab.way_scan, port_slab.slab_apply

        def scan(*a, **kw):
            calls.append(("way_scan", kw.get("multi_algo", False)))
            return real_scan(*a, **kw)

        def apply(*a, **kw):
            calls.append(("slab_apply", False))
            return real_apply(*a, **kw)

        monkeypatch.setattr(port_slab, "way_scan", scan)
        monkeypatch.setattr(port_slab, "slab_apply", apply)
        counts = {}
        for label, max_rows in (("off", 0), ("on", 64)):
            _jax, eng = _engines(victim_max_rows=max_rows)
            calls.clear()
            for uid in (1, 2, 1, 3):  # set 0 fills
                eng._launch([_item(fp_of(1, uid))])
            counts[label] = list(calls)
        assert counts["off"] == counts["on"] == [("way_scan", False), ("slab_apply", False)] * 4
        _jax, eng = _engines()
        for uid in (1, 1, 2, 2, 2, 3):  # the third key demotes uid 1
            eng._launch([_item(fp_of(0, uid))])
        assert eng.victim_tier.rows == 1
        calls.clear()
        assert eng._launch([_item(fp_of(0, 1))]) == [3]
        assert calls == [("way_scan", True), ("way_scan", False), ("slab_apply", False)]


# -- the tier and the engines against the JAX package's ---------------------


def _tier_ops(rng, n_ops=60):
    """A seeded sequence of tier operations over 48 keys: inserts (some
    expired, some window-ended, merges), lookups with retires, reclaims at
    advancing clocks."""
    keys = [(int(lo), int(hi)) for lo, hi in rng.integers(1, 2**32, (48, 2), dtype=np.uint64)]
    ops = []
    now = NOW
    for _ in range(n_ops):
        kind = rng.choice(["insert", "insert", "insert", "promote", "reclaim"])
        if kind == "insert":
            batch = []
            for _k in range(int(rng.integers(1, 8))):
                lo, hi = keys[int(rng.integers(0, len(keys)))]
                div = int(rng.choice([60, 3600]))
                window = now - now % div - int(rng.choice([0, 0, div]))
                batch.append(row(lo, hi, int(rng.integers(1, 40)), window=window,
                                 expire=now + int(rng.integers(-30, 4000)), divider=div))
            if rng.random() < 0.2:
                batch.append(np.zeros(ROW_WIDTH, np.uint32))  # a zero lane
            ops.append(("insert", np.stack(batch), now))
        elif kind == "promote":
            pick = [keys[int(i)] for i in rng.integers(0, len(keys), 6)]
            lo = np.array([p[0] for p in pick], np.uint32)
            hi = np.array([p[1] for p in pick], np.uint32)
            ops.append(("promote", (lo, hi, rng.random(6) < 0.7), now))
        else:
            now += int(rng.choice([1, 60, 700]))
            ops.append(("reclaim", None, now))
    return ops


def _apply_tier_op(tier, op):
    kind, arg, now = op
    if kind == "insert":
        return tier.insert(arg, now)
    if kind == "reclaim":
        return tier.reclaim(now)
    lo, hi, ok = arg
    found = tier.lookup_batch(lo, hi)
    if found is None:
        return None
    return found.tolist(), tier.retire(found, ok[: found.shape[0]])


@pytest.mark.parametrize("seed,max_rows", [(0, 16), (1, 16), (2, 40), (3, 200)])
def test_tier_matches_the_reference_tier(seed, max_rows):
    """The same operations on the port's VictimTier and the JAX package's:
    every return value, then export_rows, describe and the counters equal,
    through value-ranked overflow (max_rows 16), reclaims and rehashes."""
    rng = np.random.default_rng(seed)
    port, ref = VictimTier(max_rows, 0.5), JaxTier(max_rows, 0.5)
    for op in _tier_ops(rng):
        assert _apply_tier_op(port, op) == _apply_tier_op(ref, op), op[0]
        assert port.watermark_reason() == ref.watermark_reason()
    assert np.array_equal(port.export_rows(), ref.export_rows())
    assert port.describe(NOW + 1000) == ref.describe(NOW + 1000)
    if max_rows == 16:
        assert port.overflow_drops_total > 0 and port.overflow_lost_count_sum > 0


def _differential_stream(rounds=60, keys_per_set=10):
    for r in range(rounds):
        yield [fp_of(s, 1 + s * keys_per_set + (r % keys_per_set)) for s in range(4)]


@pytest.mark.parametrize("hot", [False, True], ids=["cold", "hot_key"])
def test_engines_match_the_reference_engine(hot):
    """The differential stream of TestDifferentialOracle (5x the slab)
    through the JAX engine and the port's: the afters of every launch, the
    slab tables, the tier exports, /debug/victim and health equal. With
    hot_key one key is pinned hot in both, so demotion refuses it."""
    jax_eng, eng = _engines()
    if hot:
        jax_eng._hot_fps = eng._hot_fps = frozenset({fp_of(0, 1), fp_of(2, 23)})
    for batch in _differential_stream():
        got = eng._launch([_item(fp, limit=3) for fp in batch])
        want = jax_eng._launch([_jax_item(fp, limit=3) for fp in batch])
        assert got == want
    assert np.array_equal(eng.export_tables()[0], jax_eng.export_tables()[0])
    assert np.array_equal(eng.victim_tier.export_rows(), jax_eng.victim_tier.export_rows())
    assert eng.victim_debug() == jax_eng.victim_debug()
    got_health, want_health = eng.health_snapshot(), jax_eng.health_snapshot()
    for key in ("evictions_expired", "evictions_window", "evictions_live", "drops", "decisions"):
        assert got_health[key] == want_health[key], key
    if hot:
        assert eng._victim_hot_refusals == jax_eng._victim_hot_refusals > 0


def test_differential_oracle_counts_match_the_reference_oracle():
    """The port's VictimOracle is the reference's: the same codes on the
    differential stream."""
    from api_ratelimit_tpu.testing.oracle import VictimOracle as JaxOracle

    port, ref = VictimOracle(), JaxOracle()
    for batch in _differential_stream():
        items = [(*split(fp), 1, 3, 3600, 0) for fp in batch]
        assert port.step_batch(items, NOW) == ref.step_batch(items, NOW)
    assert port.count(*split(fp_of(0, 1))) == ref.count(*split(fp_of(0, 1))) == 6


def test_victim_stats_match_the_reference():
    """VictimStats of both packages over the same tier state: the same
    ratelimit.victim.* gauges after a flush, reclaim included."""
    jax_eng, eng = _engines()
    for batch in _differential_stream(rounds=25):
        eng._launch([_item(fp) for fp in batch])
        jax_eng._launch([_jax_item(fp) for fp in batch])
    dead = rows(row(7, 8, 3, expire=NOW - 1))
    eng.victim_tier.insert(dead, NOW)
    jax_eng.victim_tier.insert(dead, NOW)
    gauges = []
    for pkg_store, sink, stats_cls, engine in (
        (Store, TestSink(), port_cuda.VictimStats, eng),
        (JaxStore, JaxSink(), jax_tpu.VictimStats, jax_eng),
    ):
        store = pkg_store(sink)
        stats_cls(engine, store.scope("ratelimit").scope("victim")).generate_stats()
        store.flush()
        gauges.append({k: v for k, v in sink.gauges.items() if ".victim." in k})
    assert gauges[0] == gauges[1]
    assert gauges[0]["ratelimit.victim.reclaimed"] >= 1 and gauges[0]["ratelimit.victim.promotes"] > 0


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_victim_snap_restores_across_the_packages(tmp_path, direction):
    """victim.snap written by one package's snapshotter (after the same
    demotes on both engines, byte-identical files) restores into the other
    package's engine: the restored tier holds the writer's rows after
    reconcile_rows, and the next launches answer alike."""
    jax_eng, eng = _engines()
    for batch in _differential_stream(rounds=25):
        eng._launch([_item(fp) for fp in batch])
        jax_eng._launch([_jax_item(fp) for fp in batch])
    pdir, jdir = tmp_path / "port", tmp_path / "jax"
    port_snapshotter.SlabSnapshotter(eng, str(pdir), interval_ms=1000, time_source=FakeTimeSource(NOW)).snapshot_once()
    jax_snapshotter.SlabSnapshotter(jax_eng, str(jdir), interval_ms=1000, time_source=JaxClock(NOW)).snapshot_once()
    for name in ("slab.snap", "victim.snap"):
        assert (pdir / name).read_bytes() == (jdir / name).read_bytes()
    later = NOW + 30
    jax_fresh, fresh = _engines()
    jax_fresh._time_source.now = fresh._time_source.now = later
    if direction == "jax_to_port":
        writer, reader = jax_eng, fresh
        stats = port_snapshotter.SlabSnapshotter(fresh, str(jdir), interval_ms=1000, time_source=FakeTimeSource(later)).restore()
        other = jax_snapshotter.SlabSnapshotter(jax_fresh, str(jdir), interval_ms=1000, time_source=JaxClock(later)).restore()
    else:
        writer, reader = eng, jax_fresh
        stats = jax_snapshotter.SlabSnapshotter(jax_fresh, str(pdir), interval_ms=1000, time_source=JaxClock(later)).restore()
        other = port_snapshotter.SlabSnapshotter(fresh, str(pdir), interval_ms=1000, time_source=FakeTimeSource(later)).restore()
    assert stats == other and stats["restored_victim_rows"] > 0
    want, _ = reconcile_rows(writer.victim_tier.export_rows(), later)
    want = want[want.any(axis=1)]
    key = lambda a: a[np.lexsort(a.T[::-1])]  # noqa: E731
    assert np.array_equal(key(reader.victim_tier.export_rows()), key(want))
    assert np.array_equal(fresh.victim_tier.export_rows(), jax_fresh.victim_tier.export_rows())
    for batch in _differential_stream(rounds=12):
        assert fresh._launch([_item(fp) for fp in batch]) == jax_fresh._launch([_jax_item(fp) for fp in batch])


def test_chip_smoke_tiers_phase_on_the_cpu(monkeypatch):
    """chip_smoke.py's tiers phase (12), rehearsed on the CPU at a small
    size: 32 touched sets of 128 ways at 5x (a 2^13-slot slab), 704
    launches so the plain twin's second window promotes, the cost step
    unprofiled, victim.snap, and the lease runners on a small slab."""
    import chip_smoke as CS
    from api_ratelimit_tpu_torch.ops import slab_kernels as K

    for name, value in (
        ("TIER_SETS", 32), ("TIER_COST_BLOCKS", 2), ("LEASE_CALLS", 256), ("LEASE_AFTER_CALLS", 64),
        ("LEASE_WINDOW_CALLS", 64),
    ):
        monkeypatch.setattr(CS, name, value)
    monkeypatch.setattr(CS, "BUCKETS", (128, 1024))
    M = types.SimpleNamespace(
        K=K, S=port_slab, SKK=__import__("api_ratelimit_tpu_torch.ops.sketch_kernels", fromlist=["x"]),
        SKT=port_sketch, cuda_mod=port_cuda,
    )
    small = {"TPU_SLAB_SLOTS": 1 << 14, "SLAB_WAYS": 4, "TPU_BUCKETS": "128,1024"}
    out, row = CS.phase_tiers(M, K, device="cpu", n_slots=1 << 13, rounds=704, profiled=False, **small)
    assert row is None
    overload, leases = out["overload"], out["leases"]
    assert overload["on"]["false_admits"] == 0 < overload["off"]["false_admits"]
    assert overload["on"]["tier_rows"] == 32 * (640 - 128)
    assert [w["from"] for w in overload["plain_twin"]] == [0, 640]
    assert out["snapshot"]["restored_victim_rows"] == out["snapshot"]["rows"] > 0
    assert leases["local_hits"] > 0 and leases["restore_stats"]["restored_leases"] > 0
