"""The port's routed per-shard batching and hot-key tier
(api_ratelimit_tpu_torch/parallel/sharded_slab.py, ops/hashing.py
hot_slice_fp, ops/sketch.py HostTopK, backends/dispatch.py
ShardRoutingStats) on 8 CPU shards, against the JAX package's.

* The JAX package's tests/test_hot_tier.py runs whole on the port
  (reference_tests_on_the_port): TestRoutedParity (the compact arm against
  the routed arm, the padding cut on skew), TestHotSliceFp, TestHotTierFuzz
  (>= 10k decisions against VictimOracle: false_over 0 under the split-quota
  bound, exact settlement), TestSketchFedPromotion and
  TestShardRoutingStats.
* The routed arm with the hot tier on against the JAX routed arm with it
  on: the same seeded Zipf stream with drains every other launch
  (promotions, demotions, settlements) gives the same afters, per-shard
  tables, health, top-K and routing counts.
* hot_slice_fp and HostTopK against the JAX package's on seeded inputs.
* A 3-shard mesh routes by mod and downgrades the hot tier with a warning,
  as the JAX engine does, and both serve the same bytes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from api_ratelimit_tpu.ops import hashing as jax_hashing  # noqa: E402
from api_ratelimit_tpu.ops.sketch import HostTopK as JaxTopK  # noqa: E402
from api_ratelimit_tpu.parallel import ShardedSlabEngine as JaxEngine  # noqa: E402
from api_ratelimit_tpu.parallel import make_mesh as jax_mesh  # noqa: E402
from api_ratelimit_tpu_torch.ops.hashing import HOT_SALT_GOLDEN, hot_slice_fp  # noqa: E402
from api_ratelimit_tpu_torch.ops.sketch import HostTopK  # noqa: E402
from api_ratelimit_tpu_torch.parallel import ShardedSlabEngine, make_mesh  # noqa: E402
from test_torch_sharded_slab import assert_same_engines  # noqa: E402
from test_torch_victim import reference_tests_on_the_port  # noqa: E402

_REF = reference_tests_on_the_port(
    "test_hot_tier",
    (
        (
            "pytestmark = pytest.mark.skipif(\n"
            "    _sharded_slab.shard_map is None,\n"
            '    reason="this jax has neither jax.shard_map nor "\n'
            '    "jax.experimental.shard_map",\n'
            ")\n",
            "",
        ),
        (
            '    assert len(jax.devices()) == 8, "conftest must force the 8-device CPU mesh"\n'
            "    return make_mesh()",
            '    return make_mesh(["cpu"] * 8)',
        ),
    ),
)

TestRoutedParity = _REF.TestRoutedParity
TestHotSliceFp = _REF.TestHotSliceFp
TestHotTierFuzz = _REF.TestHotTierFuzz
TestSketchFedPromotion = _REF.TestSketchFedPromotion
TestShardRoutingStats = _REF.TestShardRoutingStats

_packed = _REF._packed
SLOTS = _REF.SLOTS


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(["cpu"] * 8)


def test_hot_slice_fp_matches_the_reference():
    rng = np.random.default_rng(2)
    assert HOT_SALT_GOLDEN == jax_hashing.HOT_SALT_GOLDEN
    for lo, hi in rng.integers(0, 1 << 32, size=(64, 2), dtype=np.uint64).tolist():
        for n in (1, 2, 4, 8, 16):
            for slot in range(n + 2):
                assert hot_slice_fp(lo, hi, slot, n) == jax_hashing.hot_slice_fp(lo, hi, slot, n)
    for bad in (0, 3, 6):
        with pytest.raises(ValueError):
            hot_slice_fp(1, 2, 0, bad)


def test_host_topk_matches_the_reference():
    """Seeded batches past the lanes (space-saving evictions), drains with
    decay between: the same top-K at every drain."""
    rng = np.random.default_rng(4)
    port, ref = HostTopK(16), JaxTopK(16)
    for step in range(12):
        ids = (rng.zipf(1.2, size=500) % 300).astype(np.uint32)
        lo, hi = _REF._fmix32(ids), _REF._fmix32(ids ^ np.uint32(7))
        hits = rng.integers(1, 4, size=500).astype(np.uint32)
        port.update(lo, hi, hits)
        ref.update(lo, hi, hits)
        if step % 3 == 2:
            assert port.topk(8) == ref.topk(8)
            port.decay()
            ref.decay()
    assert port._counts == ref._counts
    with pytest.raises(ValueError):
        HostTopK(12)


@pytest.mark.parametrize("salt_ways", [0, 4])
def test_hot_tier_stream_matches_jax(salt_ways):
    """The routed arm with the hot tier and the host top-K on both
    packages: drains after every other launch promote the Zipf head
    (hot_min_count 60) and, once the stream moves to other keys, demote
    the old head as it decays, settling its slices into home rows; afters (slice counters remapped), tables, health, top-K and the
    routing snapshot's counts (hot tier included) stay equal."""
    kw = dict(
        n_slots_global=8 * 1024, routed=True, hot_tier=True, hot_salt_ways=salt_ways,
        hotkey_lanes=32, hotkey_k=8, hot_min_count=60,
    )
    jeng = JaxEngine(mesh=jax_mesh(), **kw)
    peng = ShardedSlabEngine(mesh=make_mesh(["cpu"] * 8), **kw)
    rng = np.random.default_rng(31 + salt_ways)
    now = 1_000_000
    for i in range(12):
        # from launch 2 on the stream moves to other keys: the first head
        # decays through the drains and demotes
        ids = (rng.zipf(1.3, size=512) % 4000 + (5000 if i >= 2 else 0)).astype(np.uint32)
        p = _packed(ids, now, limit=40, div=50)
        assert np.array_equal(jeng.step_after_compact(p.copy(), 0xFFFF), peng.step_after_compact(p.copy(), 0xFFFF)), i
        if i % 2:
            assert jeng.drain_hotkeys() == peng.drain_hotkeys()
            assert jeng.hot_fps == peng.hot_fps
        now += 13
    assert_same_engines(jeng, peng, now)
    hot = peng.shard_routing_snapshot()["hot_tier"]
    assert hot["promotions"] > 0 and hot["demotions"] > 0
    assert jeng.hotkeys_snapshot() == peng.hotkeys_snapshot()


def test_three_shards_route_by_mod_and_downgrade_the_tier(caplog):
    with caplog.at_level("WARNING"):
        peng = ShardedSlabEngine(mesh=make_mesh(["cpu"] * 3), n_slots_global=3 * 1024, routed=True, hot_tier=True)
    assert peng.hot_tier_enabled is False
    assert any("power-of-two shard count" in r.message for r in caplog.records)
    assert peng.promote_hot(1, 2) is False
    jeng = JaxEngine(mesh=jax_mesh(jax.devices()[:3]), n_slots_global=3 * 1024, routed=True, hot_tier=True)
    assert jeng.hot_tier_enabled is False
    rng = np.random.default_rng(6)
    p = _packed((rng.zipf(1.1, size=400) % 900).astype(np.uint32), 1_000_000)
    assert np.array_equal(jeng.step_after_compact(p.copy(), 0xFFFF), peng.step_after_compact(p.copy(), 0xFFFF))
    owner = (p[0].astype(np.int64) ^ p[1].astype(np.int64)) % 3
    assert peng.shard_routing_snapshot()["shard_rows"] == np.bincount(owner, minlength=3).tolist()
    assert_same_engines(jeng, peng, 1_000_000)


def test_chip_smoke_mesh_phase_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 17, rehearsed on CPU shards at a small size:
    every arm equal to its CPU replay and the routed, compact and
    replicated arms to each other, no key past its limit in a window with
    the hot tier on, step_packed and the guard launch, the mesh Runner's
    verdicts against a CPU mesh Runner's, the four shard files restored
    byte-identical, ratelimit.shard.* on /metrics, and hotpath_profile
    --shard-split's contract."""
    import chip_smoke as CS
    from api_ratelimit_tpu_torch.ops import slab_kernels as K

    for name, value in (
        ("MESH_SLOTS", 4 * (1 << 13)), ("MESH_BATCH", 4096), ("MESH_KEYS", 1 << 14), ("MESH_HOT_MIN", 300),
        ("MESH_CALLS", 192), ("MESH_THREAD_CALLS", 128), ("MESH_CPU_ARM_S", 0.5), ("MESH_LAUNCHES", 8),
    ):
        monkeypatch.setattr(CS, name, value)
    out = CS.phase_mesh(K, device="cpu", TPU_SLAB_SLOTS=4 * (1 << 13), TPU_BUCKETS="128,1024")
    arms = out["arms"]
    assert set(arms) == set(CS.MESH_ARMS)
    assert all(a["cpu_launches_compared"] >= CS.MESH_CPU_MIN for a in arms.values())
    hot = arms["routed_hot"]
    assert hot["cpu_launches_compared"] == arms["routed"]["cpu_launches_compared"] == 8
    assert hot["hot_tier"]["promotions"] == hot["hot_tier"]["demotions"] > 0 and hot["tail_drains"] > 0
    assert hot["hot_tier_before_tail"]["keys"] > 0 and hot["hot_tier"]["keys"] == 0
    assert hot["admits"]["hottest_key_admits"] == [CS.MESH_LIMIT] * 8
    assert arms["compact"]["padding_waste_pct"] > arms["routed"]["padding_waste_pct"]
    assert out["guard"]["sliding_items"] > 0
    proc = out["process"]
    assert proc["snapshot"]["files"] == [f"slab.{i:02d}-of-04.snap" for i in range(4)]
    assert proc["snapshot"]["restored_rows"] > 0
    assert proc["metrics"]["rows"] == sum(proc["metrics"]["rows_by_shard"]) > 0
    assert len(proc["captures"]) == CS.OBS_CAPTURES and all(c["calls_during"] > 0 for c in proc["captures"])
    assert out["tool"]["summary"].startswith("[shard_split] shards=4 launches=6 device=cpu")


def test_chip_smoke_mesh_launches_by_form_and_path():
    """The kernels line's mesh_launches: a way scan row takes its own
    instantiation's and form's count, the victim tier's promote row (off on
    a mesh) and any second row of one key take 0, every other row its
    kernel's."""
    import chip_smoke as CS

    rows = [
        {"name": "way_scan", "form": "per_item"},
        {"name": "way_scan", "form": "set_major"},
        {"name": "slab_apply"},
        {"name": "slab_apply_decide"},
        {"name": "decide"},
        {"name": "way_scan_multi", "form": "per_item", "path": "multi_algo"},
        {"name": "way_scan_multi", "form": "set_major", "path": "multi_algo"},
        {"name": "decide", "path": "multi_algo"},
        {"name": "way_scan_multi", "form": "per_item", "path": "victim_tier"},
        {"name": "way_scan", "form": "per_item"},
    ]
    counts = {"way_scan/per_item": 264, "way_scan/set_major": 0, "slab_apply": 256, "slab_apply_decide": 8,
              "way_scan_multi/per_item": 4, "way_scan_multi/set_major": 0}
    CS.mesh_row_launches(rows, counts)
    assert [r["mesh_launches"] for r in rows] == [264, 0, 256, 8, 0, 4, 0, 0, 0, 0]
