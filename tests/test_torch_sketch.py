"""The port's heavy-hitter sketch (api_ratelimit_tpu_torch/ops/sketch.py,
ops/sketch_kernels.py, the engine's drain) on the CPU, against the JAX
package: pallas_sketch_scan in interpret mode and its XLA twin
_sketch_scan, sketch_update, slab_step_after(sketch=..., use_pallas=False),
SlabDeviceEngine(hotkey_lanes=128, use_pallas=False) and the SketchOracle
host model. Integer state throughout, so every comparison is bit-exact
(tolerance 0)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from api_ratelimit_tpu.backends.tpu import SlabDeviceEngine as JEngine  # noqa: E402
from api_ratelimit_tpu.ops import sketch as JS  # noqa: E402
from api_ratelimit_tpu.ops import slab as J  # noqa: E402
from api_ratelimit_tpu.testing.oracle import SketchOracle  # noqa: E402
from api_ratelimit_tpu.utils import FakeTimeSource  # noqa: E402
from api_ratelimit_tpu_torch.backends.cuda import SlabDeviceEngine as TEngine  # noqa: E402
from api_ratelimit_tpu_torch.ops import sketch as TS  # noqa: E402
from api_ratelimit_tpu_torch.ops import sketch_kernels as SK  # noqa: E402
from api_ratelimit_tpu_torch.ops import slab as T  # noqa: E402
from api_ratelimit_tpu_torch.utils import FakeTimeSource as PFake  # noqa: E402

NOW0 = 1_000_000


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def _adversarial_planes(rng, lanes, ways):
    """Empty lanes (count 0, fp 0/0), stale tags under count 0, an occupied
    0/0 tag, count ties, counts >= 2^31 (unoccupied when read signed) and
    random occupied rows."""
    p = np.zeros((3, lanes), np.uint32)
    # each lane's fp_lo names its own set, so resident keys can match
    n_sets = lanes // ways
    own_set = (np.arange(lanes) // ways).astype(np.uint64)
    p[0] = (rng.integers(0, 1 << 32, lanes, dtype=np.uint64) & ~np.uint64(n_sets - 1)) | own_set
    p[1] = rng.integers(0, 1 << 32, lanes, dtype=np.uint64)
    kind = rng.integers(0, 5, lanes)
    p[2] = np.select(
        [kind == 0, kind == 1, kind == 2, kind == 3],
        [0, rng.integers(1, 4, lanes), rng.integers(1 << 31, 1 << 32, lanes, dtype=np.uint64), 7],
        rng.integers(1, 1000, lanes),
    )
    empty = (kind == 0) & (rng.random(lanes) < 0.5)
    p[0][empty] = 0
    p[1][empty] = 0
    p[:2, lanes // 3] = 0  # an occupied lane holding fp 0/0
    p[2, lanes // 3] = 5
    return p


def _queries(rng, planes, b):
    """Half resident fingerprints (some under count 0 or >= 2^31), half
    misses, and fp-0 padding at the tail."""
    lanes = planes.shape[1]
    pick = rng.integers(0, lanes, b)
    q_lo, q_hi = planes[0, pick].copy(), planes[1, pick].copy()
    miss = rng.random(b) < 0.5
    q_lo[miss] = rng.integers(0, 1 << 32, int(miss.sum()), dtype=np.uint64)
    q_lo[-b // 8:] = 0
    q_hi[-b // 8:] = 0
    return q_lo, q_hi


def _gathered(planes, q_lo, ways):
    n_sets = planes.shape[1] // ways
    sets = planes.reshape(3, n_sets, ways)
    idx = q_lo & np.uint32(n_sets - 1)
    return [sets[p][idx] for p in range(3)]


def _check_scan(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy()
        if w.dtype == np.uint32:
            g = g.view(np.uint32)
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("lanes", [128, 1024])
def test_sketch_scan_plain_matches_pallas_interpret(lanes):
    """W = 128, the Pallas geometry: one set (128 lanes) or eight (1024)."""
    rng = np.random.default_rng(lanes)
    b = 768
    planes = _adversarial_planes(rng, lanes, 128)
    q_lo, q_hi = _queries(rng, planes, b)
    rows = _gathered(planes, q_lo, 128)
    want = JS.pallas_sketch_scan(*(jnp.asarray(r) for r in rows), jnp.asarray(q_lo), jnp.asarray(q_hi), interpret=True)
    got = SK.sketch_scan(_i32(planes), _i32(q_lo), _i32(q_hi), 128)
    _check_scan(got, want)
    m_any = got[1].numpy()
    assert m_any.any() and not m_any.all()


@pytest.mark.parametrize("ways", [4, 128])
@pytest.mark.parametrize("lanes", [128, 1024])
def test_sketch_scan_plain_matches_xla_twin(ways, lanes):
    rng = np.random.default_rng(ways * 31 + lanes)
    b = 1024
    planes = _adversarial_planes(rng, lanes, ways)
    q_lo, q_hi = _queries(rng, planes, b)
    rows = _gathered(planes, q_lo, ways)
    want = JS._sketch_scan(*(jnp.asarray(r) for r in rows), jnp.asarray(q_lo), jnp.asarray(q_hi))
    got = SK.sketch_scan(_i32(planes), _i32(q_lo), _i32(q_hi), ways)
    _check_scan(got, want)
    m_any = got[1].numpy()
    assert m_any.any() and not m_any.all()


def test_scan_ties_resolve_to_the_first_way():
    """torch's argmin/argmax return the first index on ties: pinned here
    for the plain version (chip_smoke.py holds the kernel to it on the
    card)."""
    planes = np.zeros((3, 8), np.uint32)
    planes[0] = [5, 9, 5, 9, 5, 9, 5, 9]
    planes[1] = [1, 1, 1, 1, 1, 1, 1, 1]
    planes[2] = [4, 3, 4, 3, 0x80000000, 3, 4, 0x80000000]
    q_lo = np.array([9, 5, 7], np.uint32)
    q_hi = np.array([1, 1, 1], np.uint32)
    m_way, m_any, v_way, v_cnt = SK.sketch_scan(_i32(planes), _i32(q_lo), _i32(q_hi), 8)
    # lane 1 is the first occupied 9/1; lane 0 the first 5/1; no 7/1 -> 0
    assert m_way.tolist() == [1, 0, 0]
    assert m_any.tolist() == [True, True, False]
    # the two counts >= 2^31 are the signed minimum; the first wins
    assert v_way.tolist() == [4, 4, 4]
    assert v_cnt.numpy().view(np.uint32).tolist() == [0x80000000] * 3
    planes[2] = [2, 2, 2, 2, 2, 2, 2, 2]
    _, _, v_way, _ = SK.sketch_scan(_i32(planes), _i32(q_lo), _i32(q_hi), 4)
    assert v_way.tolist() == [0, 0, 0]


def _candidates(rng, b, n_keys, zipf=1.3):
    """A slot-sorted-like batch: keys grouped into runs, hits with zeros,
    the segment-total weights and the segment-end candidates."""
    keys = np.sort(np.minimum(rng.zipf(zipf, b), n_keys))
    lo = ((keys * 0x9E3779B1 + 0x7F4A7C15) & 0xFFFFFFFF).astype(np.uint32)
    hi = (((keys & 0xFFFF) << 16) | ((keys * 0x85EBCA6B) & 0xFFFF)).astype(np.uint32)
    hits = rng.integers(0, 6, b).astype(np.uint32)
    hits[rng.random(b) < 0.02] = rng.integers(1 << 30, 1 << 31)
    seg_start = np.r_[True, keys[1:] != keys[:-1]]
    seg_last = np.r_[keys[1:] != keys[:-1], True]
    incl = np.cumsum(hits, dtype=np.uint32)
    excl = incl - hits
    base = np.maximum.accumulate(np.where(seg_start, excl, 0).astype(np.uint32))
    weight = (incl - base).astype(np.uint32)
    return lo, hi, weight, seg_last & (hits > 0)


@pytest.mark.parametrize("ways", [4, 128])
@pytest.mark.parametrize("lanes", [128, 1024])
def test_sketch_update_matches_jax(lanes, ways):
    """Six launches threaded through both sketches, starting from planes
    with empty lanes, ties and counts >= 2^31 (carried across with
    sketch_import_planes)."""
    rng = np.random.default_rng(lanes + ways)
    start = _adversarial_planes(rng, lanes, ways)
    pj = jnp.asarray(start)
    pt = TS.sketch_import_planes(start, device="cpu")
    for step in range(6):
        lo, hi, w, cand = _candidates(rng, 512, 3 * lanes)
        pj = JS.sketch_update(pj, jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(w), jnp.asarray(cand), ways)
        pt = TS.sketch_update(pt, _i32(lo), _i32(hi), _i32(w), torch.from_numpy(cand), ways)
        assert pt.dtype == torch.int32
        assert np.array_equal(TS.sketch_export_copy(pt), np.asarray(pj)), step


def _packed(rng, b, n_keys, now):
    keys = np.minimum(rng.zipf(1.2, b), n_keys)
    p = np.zeros((7, b), np.uint32)
    p[0] = ((keys * 0x9E3779B1 + 1) & 0xFFFFFFFF).astype(np.uint32)
    p[1] = (((keys & 0xFFFF) << 16) | 0x55).astype(np.uint32)
    p[2] = rng.integers(1, 4, b)
    n_pad = int(rng.integers(0, b // 4))
    if n_pad:
        p[2, b - n_pad:] = 0
    p[3] = rng.choice([3, 100, 70000], b)
    p[4] = rng.choice([1, 60, 3600], b)
    p[5] = rng.integers(0, 30, b)
    p[6, 0] = now
    return p


@pytest.mark.parametrize("ways,lanes", [(4, 128), (128, 128), (4, 1024)])
def test_step_with_sketch_matches_jax(ways, lanes):
    """A multi-launch Zipf stream through slab_step_after with a live
    sketch: afters, slab bytes, health and planes equal after every
    launch; the sketch never perturbs the slab."""
    rng = np.random.default_rng(7 * ways + lanes)
    n_slots = 512
    skw = JS.sketch_ways(ways, lanes)
    assert TS.sketch_ways(ways, lanes) == skw
    sj, kj = J.make_slab(n_slots), JS.make_sketch(lanes)
    st, kt = T.make_slab(n_slots, device="cpu"), TS.make_sketch(lanes, device="cpu")
    s_off = T.make_slab(n_slots, device="cpu")
    now = NOW0
    for _step in range(8):
        now += int(rng.choice([0, 1, 59]))
        p = _packed(rng, 256, 700, now)
        sj, aj, hj, kj = J.slab_step_after(sj, jnp.asarray(p), ways=ways, use_pallas=False, multi_algo=False, sketch=kj, sketch_ways=skw)
        at, ht, kt = T.slab_step_after(st, p, ways=ways, sketch=kt, sketch_ways=skw)
        a_off, h_off = T.slab_step_after(s_off, p, ways=ways)
        assert np.array_equal(at.numpy(), np.asarray(aj))
        assert np.array_equal(ht.numpy(), np.asarray(hj).astype(np.int64))
        assert np.array_equal(T.slab_export_copy(st), np.asarray(sj.table))
        assert np.array_equal(TS.sketch_export_copy(kt), np.asarray(kj))
        assert torch.equal(a_off, at) and torch.equal(h_off, ht)
    assert np.array_equal(T.slab_export_copy(s_off), T.slab_export_copy(st))
    assert (TS.sketch_export_copy(kt)[2] > 0).any()


def _engine_pair(lanes=128, k=16, n_slots=1024, ways=4):
    tj, tt = FakeTimeSource(NOW0), PFake(NOW0)
    ej = JEngine(tj, n_slots=n_slots, ways=ways, buckets=(128, 1024), use_pallas=False, hotkey_lanes=lanes, hotkey_k=k)
    et = TEngine(tt, n_slots=n_slots, ways=ways, buckets=(128, 1024), device="cpu", hotkey_lanes=lanes, hotkey_k=k)
    return (tj, ej), (tt, et)


def _block(rng, n, n_keys):
    keys = np.minimum(rng.zipf(1.3, n), n_keys)
    blk = np.zeros((6, n), np.uint32)
    blk[0] = ((keys * 0x9E3779B1 + 3) & 0xFFFFFFFF).astype(np.uint32)
    blk[1] = (((keys & 0xFFFF) << 16) | 0x2A).astype(np.uint32)
    blk[2] = rng.integers(1, 5, n)
    blk[3] = 1000
    blk[4] = 60
    blk[5] = 0
    return blk


def test_engine_drain_matches_jax_engine_and_oracle():
    """Submits through both engines (sketch W = min(4, 128) = 4 on the CPU
    geometry), draining every third submit: afters, tables, the drained
    top-K and the post-decay planes equal the JAX engine's, and the planes
    and top-K equal the SketchOracle's."""
    rng = np.random.default_rng(11)
    (tj, ej), (tt, et) = _engine_pair()
    oracle = SketchOracle(128, 4)
    for i in range(9):
        tj.advance(1)
        tt.advance(1)
        blk = _block(rng, int(rng.integers(50, 1000)), 400)
        assert np.array_equal(et.submit_rows(blk), ej.submit_rows(blk))
        cands: dict = {}
        for lo, hi, h in zip(blk[0].tolist(), blk[1].tolist(), blk[2].tolist()):
            cands[(lo, hi)] = cands.get((lo, hi), 0) + h
        oracle.update([(lo, hi, w) for (lo, hi), w in cands.items()])
        assert np.array_equal(et.export_sketch(), np.asarray(ej._sketch))
        assert np.array_equal(et.export_sketch(), oracle.planes)
        if i % 3 == 2:
            top = et.drain_hotkeys()
            assert top == ej.drain_hotkeys() == oracle.topk(16)
            assert len(top) == 16 and top[0][2] >= top[-1][2]
            oracle.decay()
            assert np.array_equal(et.export_sketch(), np.asarray(ej._sketch))
            assert np.array_equal(et.export_sketch(), oracle.planes)
    assert np.array_equal(et.export_tables()[0], np.asarray(ej.export_tables()[0]))
    assert et.hotkeys_snapshot() == ej.hotkeys_snapshot()


def test_sketch_off_engine_is_the_sketch_free_step():
    """hotkey_lanes=0: no sketch, the launch is slab_step_after without
    one, and the afters and table bytes equal the sketch-on engine's."""
    rng = np.random.default_rng(12)
    off = TEngine(PFake(NOW0), n_slots=1024, ways=4, buckets=(128, 1024), device="cpu")
    on = TEngine(PFake(NOW0), n_slots=1024, ways=4, buckets=(128, 1024), device="cpu", hotkey_lanes=128)
    assert not off.hotkeys_enabled and on.hotkeys_enabled
    for _ in range(4):
        blk = _block(rng, 700, 300)
        assert np.array_equal(off.submit_rows(blk), on.submit_rows(blk))
    assert np.array_equal(off.export_tables()[0], on.export_tables()[0])
    assert off.health_snapshot() == on.health_snapshot()
    assert off.export_sketch() is None and off.drain_hotkeys() == []
    assert off.hotkeys_snapshot() == {"enabled": False, "k": 16, "lanes": 0, "drains": 0, "top": []}
    st = T.make_slab(64, device="cpu")
    assert len(T.slab_step_after(st, _packed(rng, 128, 50, NOW0), ways=4)) == 2


def test_sketch_entry_points_raise_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TS.make_sketch(128)
    with pytest.raises(RuntimeError, match="cuda"):
        TS.sketch_import_planes(np.zeros((3, 128), np.uint32))
    with pytest.raises(RuntimeError, match="cuda"):
        TEngine(PFake(NOW0), n_slots=1024, hotkey_lanes=128)


def test_drain_helpers_match_reference():
    rng = np.random.default_rng(13)
    planes = _adversarial_planes(rng, 256, 4)
    planes[2, :40] = 9  # equal counts: the fingerprints break the tie
    assert TS.sketch_topk(planes, 16) == JS.sketch_topk(planes, 16)
    a, b = planes.copy(), planes.copy()
    TS.sketch_decay(a)
    JS.sketch_decay(b)
    assert np.array_equal(a, b)
    back = TS.sketch_export_copy(TS.sketch_import_planes(a, device="cpu"))
    assert np.array_equal(back, a)
    with pytest.raises(ValueError):
        TS.sketch_import_planes(np.zeros((2, 8), np.uint32), device="cpu")
    with pytest.raises(ValueError):
        TS.make_sketch(96, device="cpu")
