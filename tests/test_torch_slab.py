"""The port's slab step and its two kernels' plain versions
(api_ratelimit_tpu_torch/ops/slab.py, ops/slab_kernels.py), on the CPU,
against the JAX package: slab_step_after(use_pallas=False, multi_algo=False),
the Pallas kernels in interpret mode, and the SetSlabOracle host model.
Integers throughout, so every comparison is bit-exact (tolerance 0)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from api_ratelimit_tpu.ops import slab as J  # noqa: E402
from api_ratelimit_tpu.ops.pallas_slab import pallas_slab_apply, pallas_way_scan  # noqa: E402
from api_ratelimit_tpu.testing.oracle import SetSlabOracle  # noqa: E402
from api_ratelimit_tpu_torch.ops import slab as T  # noqa: E402
from api_ratelimit_tpu_torch.ops import sketch_kernels as SK  # noqa: E402
from api_ratelimit_tpu_torch.ops import slab_kernels as K  # noqa: E402

NOW0 = 1_000_000


def _fps(keys):
    fp = keys.astype(np.uint64) * np.uint64(0x9E3779B185EBCA87) + np.uint64(1)
    return (
        (fp & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        (fp >> np.uint64(32)).astype(np.uint32),
    )


def _packed(rng, b, n_keys, now, hits_hi=4):
    """A launch operand with Zipf-ish duplicates, mixed units and padding."""
    keys = np.minimum(rng.zipf(1.3, b), n_keys) + rng.integers(0, n_keys, b) * (rng.random(b) < 0.5)
    p = np.zeros((7, b), np.uint32)
    p[0], p[1] = _fps(keys % n_keys)
    p[2] = rng.integers(1, hits_hi, b)
    n_pad = int(rng.integers(0, b // 4))
    if n_pad:
        p[2, b - n_pad:] = 0
    p[3] = rng.choice([3, 10, 100, 70000], b)
    p[4] = rng.choice([1, 2, 60, 3600], b)
    p[5] = rng.integers(0, 30, b)
    p[6, 0] = now
    return p


def _adversarial_table(rng, n_slots, now, batch_fps=None, big_counts=True):
    """Random rows around `now`: dead, window-ended and live ways, counts
    past 2^31, and (optionally) rows holding the batch's own keys."""
    t = np.zeros((n_slots, 8), np.uint32)
    t[:, 0] = rng.integers(0, 1 << 32, n_slots, dtype=np.uint64)
    t[:, 1] = rng.integers(0, 1 << 32, n_slots, dtype=np.uint64)
    hi = 1 << 32 if big_counts else 1 << 31
    t[:, 2] = np.where(rng.random(n_slots) < 0.3, rng.integers(0, hi, n_slots, dtype=np.uint64), rng.integers(0, 50, n_slots))
    div = rng.choice([1, 60, 3600], n_slots)
    t[:, 5] = div
    t[:, 3] = (now // div) * div - div * rng.integers(0, 2, n_slots)
    t[:, 4] = now + rng.integers(-5, 100, n_slots)
    t[rng.random(n_slots) < 0.2, 4] = 0  # never written
    if batch_fps is not None:
        lo, hi_fp = batch_fps
        idx = rng.choice(n_slots, size=min(len(lo), n_slots // 2), replace=False)
        pick = rng.integers(0, len(lo), idx.size)
        t[idx, 0], t[idx, 1] = lo[pick], hi_fp[pick]
    return t


def _step_both(sj, st, p, ways, dtype):
    sj, aj, hj = J.slab_step_after(sj, jnp.asarray(p), ways=ways, out_dtype=dtype, use_pallas=False, multi_algo=False)
    at, ht = T.slab_step_after(st, p, ways=ways, out_dtype=dtype)
    got = at.numpy()
    assert got.dtype == np.dtype(dtype)
    assert np.array_equal(got, np.asarray(aj))
    assert np.array_equal(ht.numpy(), np.asarray(hj).astype(np.int64))
    assert np.array_equal(T.slab_export_copy(st), np.asarray(sj.table))
    return sj, np.asarray(hj)


@pytest.mark.parametrize("ways", [4, 128])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32])
def test_step_matches_jax_over_stream(ways, dtype):
    """Multi-launch streams under eviction pressure (more keys than slots),
    with the clock moving across window edges: table, after and health
    equal after every launch."""
    rng = np.random.default_rng(ways * 7 + np.dtype(dtype).itemsize)
    n_slots = 512
    sj, st = J.make_slab(n_slots), T.make_slab(n_slots, device="cpu")
    now, mix = NOW0, np.zeros(5, np.int64)
    for _step in range(10):
        now += int(rng.choice([0, 1, 2, 59]))
        sj, h = _step_both(sj, st, _packed(rng, 256, 900, now), ways, dtype)
        mix += h
    assert mix[J.HEALTH_EVICT_EXPIRED : J.HEALTH_EVICT_LIVE + 1].sum() > 0
    assert mix[J.HEALTH_DROPS] > 0


@pytest.mark.parametrize("ways", [4, 128])
def test_step_matches_jax_on_adversarial_table(ways):
    """All three eviction tiers, counts >= 2^31, huge hits and the batch's
    own keys already stored, from a table imported into both engines."""
    rng = np.random.default_rng(100 + ways)
    n_slots = 1024
    p = _packed(rng, 1024, 400, NOW0, hits_hi=1 << 31)
    table = _adversarial_table(rng, n_slots, NOW0, (p[0], p[1]))
    sj = J.SlabState(table=jnp.asarray(table))
    st = T.slab_import_rows(table, device="cpu")
    for k in range(3):
        p[6, 0] = NOW0 + k
        sj, _h = _step_both(sj, st, p, ways, np.uint32)


def test_jax_table_imported_steps_to_same_bytes():
    """A table built by the JAX engine, exported and imported into the port,
    steps to the same bytes as the JAX state it came from."""
    rng = np.random.default_rng(5)
    sj = J.make_slab(256)
    for k in range(4):
        sj, _, _ = J.slab_step_after(sj, jnp.asarray(_packed(rng, 128, 300, NOW0 + k)), ways=4, multi_algo=False)
    st = T.slab_import_rows(np.asarray(sj.table), device="cpu")
    assert np.array_equal(T.slab_export_copy(st), np.asarray(sj.table))
    for k in range(4, 8):
        sj, _h = _step_both(sj, st, _packed(rng, 128, 300, NOW0 + k), 4, np.uint32)
        sj, _, _ = J.slab_step_after(sj, jnp.asarray(_packed(np.random.default_rng(k), 128, 300, NOW0 + k)), ways=4, multi_algo=False)
        T.slab_step_after(st, _packed(np.random.default_rng(k), 128, 300, NOW0 + k), ways=4)
    assert np.array_equal(T.slab_export_copy(st), np.asarray(sj.table))
    assert T.live_slot_count(st.table, NOW0 + 8) == int(J.live_slot_count(sj.table, NOW0 + 8))
    lo, hi = int(sj.table[0, 0]), int(sj.table[0, 1])
    host = T.slab_export_copy(st)
    assert T.find_row_host(host, lo, hi, 4) == J.find_row_host(np.asarray(sj.table), lo, hi, 4)


def test_step_matches_set_slab_oracle():
    """One stream against the exact sequential host model."""
    n_slots, ways = 256, 4
    oracle = SetSlabOracle(n_slots, ways)
    st = T.make_slab(n_slots, device="cpu")
    rng = np.random.default_rng(9)
    now = NOW0
    for _step in range(8):
        now += int(rng.choice([0, 1, 60]))
        b = 128
        ids = rng.integers(0, 200, b)
        lo = ((ids * 0x9E3779B1 + 0x7F4A7C15) & 0xFFFFFFFF).astype(np.uint32)
        hi = ((((ids + 1) & 0xFFFF) << 16) | ((ids * 0x85EBCA6B) & 0xFFFF)).astype(np.uint32)
        items = [
            (int(lo[i]), int(hi[i]), int(rng.integers(0, 3)), 5, 1 if ids[i] % 3 else 60, 0)
            for i in range(b)
        ]
        p = np.zeros((7, b), np.uint32)
        p[:6] = np.array(items, dtype=np.uint64).T.astype(np.uint32)
        p[6, 0] = now
        after, health = T.slab_step_after(st, p, ways=ways)
        _before, w_after, _codes, w_delta = oracle.step_batch(items, now)
        after = after.numpy()
        for i, item in enumerate(items):
            if item[2] > 0:
                assert int(after[i]) == w_after[i], (i, item)
        assert health.tolist() == w_delta
    assert np.array_equal(T.slab_export_copy(st), oracle.table.astype(np.uint32))


def test_way_scan_plain_matches_pallas_interpret():
    """The plain way scan against pallas_way_scan in interpret mode over a
    batch of three grid steps (768 items, block rows 256)."""
    rng = np.random.default_rng(21)
    n_slots, ways, b = 1 << 12, 128, 768
    lo, hi = _fps(rng.integers(0, 5000, b))
    # the Mosaic kernel compares counts signed: keep them below 2^31
    table = _adversarial_table(rng, n_slots, NOW0, (lo, hi), big_counts=False)
    n_sets = n_slots // ways
    rows = table.reshape(n_sets, ways, 8)[lo & (n_sets - 1)]
    planes = [jnp.asarray(rows[:, :, c]) for c in range(6)]
    w_way, w_match = pallas_way_scan(*planes, jnp.asarray(lo), jnp.asarray(hi), jnp.int32(NOW0), interpret=True)
    tt = torch.from_numpy(table.view(np.int32))
    way, matched, picked = K.way_scan(tt, torch.from_numpy(lo.view(np.int32)), torch.from_numpy(hi.view(np.int32)), NOW0, ways)
    assert np.array_equal(way.numpy(), np.asarray(w_way))
    assert np.array_equal(matched.numpy(), np.asarray(w_match))
    assert matched.any() and not matched.all()
    assert np.array_equal(picked.numpy().view(np.uint32), rows[np.arange(b), way.numpy()])


def test_slab_apply_plain_matches_pallas_interpret():
    """The plain INCRBY apply against pallas_slab_apply(decide=False) in
    interpret mode over three grid steps, with duplicate segments, window
    rollovers, padding lanes and a stored-row mix."""
    rng = np.random.default_rng(33)
    b = 768
    keys = np.sort(rng.integers(0, 200, b))
    lo, hi = _fps(keys)
    hits = rng.integers(1, 1000, b).astype(np.uint32)
    hits[rng.random(b) < 0.1] = 0
    div = rng.choice([0, 1, 60, 3600], b).astype(np.int32)
    jit = rng.integers(0, 30, b).astype(np.int32)
    seg_start = np.concatenate([[True], (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])])
    st = _adversarial_table(rng, b, NOW0, big_counts=False)
    same = rng.random(b) < 0.7
    st[same, 0], st[same, 1] = lo[same], hi[same]
    want = pallas_slab_apply(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(hits), jnp.asarray(hits),
        jnp.asarray(div), jnp.asarray(jit), jnp.asarray(seg_start),
        jnp.asarray(st[:, :5].T), jnp.int32(NOW0), jnp.float32(0.8),
        decide=False, interpret=True,
    )
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))  # noqa: E731
    got = K.slab_apply(
        i32(lo), i32(hi), i32(hits), i32(div), i32(jit),
        torch.from_numpy(seg_start), i32(st), NOW0,
    )
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_wrappers_validate_and_count_no_cpu_launch():
    K.reset_launch_counts()
    table = torch.zeros((64, 8), dtype=torch.int32)
    q = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        K.way_scan(table, q.long(), q, 0, 4)
    with pytest.raises(ValueError):
        K.way_scan(table, q, q, 0, 3)
    with pytest.raises(ValueError):
        K.way_scan(table, q, q, 1 << 31, 4)
    K.way_scan(table, q, q, 0, 4)
    with pytest.raises(ValueError):
        K.slab_apply(q, q, q, q, q, q, table[:8], 0)  # seg_start must be bool
    planes = torch.zeros((3, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        SK.sketch_scan(planes, q, q, 32)  # ways > lanes
    with pytest.raises(ValueError):
        SK.sketch_scan(planes[:2].contiguous(), q, q, 4)
    SK.sketch_scan(planes, q, q, 4)
    cand = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError):
        SK.sketch_update_fused(planes, q, q, q, cand.int(), 4)  # cand must be bool
    with pytest.raises(ValueError):
        SK.sketch_update_fused(planes, q, q, q[:4], cand, 4)
    SK.sketch_update_fused(planes, q, q, q, cand, 4)
    from api_ratelimit_tpu_torch.ops import select_kernels as SEL

    SEL.sel(q)
    SEL.chain(q)
    assert K.LAUNCHES == {
        "way_scan": 0, "slab_apply": 0, "sketch_scan": 0, "sketch_update": 0,
        "slab_apply_decide": 0, "slab_apply_lean": 0, "decide": 0,
        "sel": 0, "chain": 0,
    }
