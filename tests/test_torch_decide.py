"""The port's on-device decision path (api_ratelimit_tpu_torch/ops/decide.py,
slab_apply with decide=True, and ops/slab.py slab_step_packed /
slab_step_decided / slab_update_and_decide), on the CPU, against the JAX
package: decide(), pallas_decide and pallas_slab_apply(decide=True) in
interpret mode, the XLA twin's packed and decided steps, the Pallas-fused
_slab_step_sorted, SetSlabOracle and the oracle's parity report. Integers
throughout, so every comparison is bit-exact (tolerance 0) on uint32 views."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from api_ratelimit_tpu.ops import slab as J  # noqa: E402
from api_ratelimit_tpu.ops import sketch as JSK  # noqa: E402
from api_ratelimit_tpu.ops.decide import decide as jax_decide  # noqa: E402
from api_ratelimit_tpu.ops.pallas_decide import pallas_decide  # noqa: E402
from api_ratelimit_tpu.ops.pallas_slab import pallas_slab_apply  # noqa: E402
from api_ratelimit_tpu.testing import oracle as JO  # noqa: E402
from api_ratelimit_tpu_torch.ops import decide as D  # noqa: E402
from api_ratelimit_tpu_torch.ops import sketch as TSK  # noqa: E402
from api_ratelimit_tpu_torch.ops import slab as T  # noqa: E402
from api_ratelimit_tpu_torch.ops import slab_kernels as K  # noqa: E402
from api_ratelimit_tpu_torch.testing import oracle as TO  # noqa: E402

NOW0 = 1_722_300_000
UNITS = np.array([1, 60, 3600, 86400])


def i32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def u32(t) -> np.ndarray:
    """uint32 view of a port tensor or a JAX array."""
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return np.ascontiguousarray(a).view(np.uint32)


def decide_operands(rng, b, big: bool):
    """(before, after, hits, limit, divider) uint32/int32 with items on every
    branch: under the near threshold, between it and the limit, crossing
    the limit in this item, all over (before >= limit), and hits == 0
    padding. big: counts and limits drawn on both sides of 2^31 and up to
    2^32 (sums wrap, and a signed compare would flip); else every operand
    stays below 2^31 (the Pallas kernels' int32 range).
    Limits stay 1024 below 2^32, except a few in the big regime right at
    the edge, where f32(limit) rounds to 2^32 and the threshold convert
    saturates."""
    lo, hi = (1 << 30, (1 << 32) - 1024) if big else (1, 1 << 20)
    limit = rng.integers(lo, hi, b, dtype=np.uint64)
    hits = rng.integers(1, 1 << 12, b, dtype=np.uint64)
    branch = rng.integers(0, 4, b)
    frac = np.select(
        [branch == 0, branch == 1, branch == 2],
        [rng.uniform(0.0, 0.5, b), rng.uniform(0.8, 1.0, b), np.ones(b)],
        rng.uniform(1.0, 1.5, b),
    )
    before = (limit.astype(np.float64) * frac).astype(np.uint64)
    before[branch == 2] -= np.minimum(hits[branch == 2] // 2, before[branch == 2])  # crossing
    if big:
        limit[: b // 64] = (1 << 32) - rng.integers(1, 128, b // 64)
    else:
        before = np.minimum(before, (1 << 31) - (1 << 13))
    before &= 0xFFFFFFFF
    hits[-b // 8 :] = 0
    after = (before + hits) & 0xFFFFFFFF
    divider = rng.choice(UNITS, b).astype(np.int32)
    divider[-b // 8 :] = rng.choice([0, 1, 60], b // 8)
    u = lambda a: a.astype(np.uint32)  # noqa: E731
    return u(before), u(after), u(hits), u(limit), divider


def test_decide_operands_cover_every_branch():
    rng = np.random.default_rng(0)
    for big in (False, True):
        before, after, hits, limit, _div = decide_operands(rng, 4096, big)
        valid = hits > 0
        near = np.floor(limit.astype(np.float32) * np.float32(0.8))
        over = after > limit
        assert np.any(valid & ~over & (after <= near))
        assert np.any(valid & ~over & (after > near))
        assert np.any(valid & over & (before < limit))
        assert np.any(valid & over & (before >= limit))
        assert np.any(~valid)
        if big:
            assert np.any(after >= 1 << 31) and np.any(limit >= (1 << 32) - 128)
        else:
            assert after.max() < 1 << 31


@pytest.mark.parametrize("near_ratio", [0.0, 0.8, 1.0])
@pytest.mark.parametrize("big", [False, True], ids=["below_2_31", "at_or_above_2_31"])
def test_decide_plain_matches_jax_decide(big, near_ratio):
    rng = np.random.default_rng(10 + big)
    before, after, hits, limit, div = decide_operands(rng, 4096, big)
    want = jax_decide(
        jnp.asarray(before), jnp.asarray(after), jnp.asarray(hits), jnp.asarray(limit),
        jnp.asarray(div), jnp.int32(NOW0), jnp.float32(near_ratio),
    )
    got = D.decide_plain(i32(before), i32(after), i32(hits), i32(limit), i32(div), NOW0, near_ratio)
    for field in D.DecideResult._fields:
        assert np.array_equal(u32(getattr(got, field)), u32(getattr(want, field))), field
    assert np.any(u32(got.throttle_millis) > 0) or near_ratio == 1.0


@pytest.mark.parametrize("near_ratio", [0.0, 0.8, 1.0])
def test_decide_plain_matches_pallas_decide_interpret(near_ratio):
    rng = np.random.default_rng(20)
    before, after, hits, limit, div = decide_operands(rng, 2048, big=False)
    args = (before, after, hits, limit, div)
    want = pallas_decide(
        *(jnp.asarray(a) for a in args), jnp.int32(NOW0), jnp.float32(near_ratio), interpret=True
    )
    got = D.decide(*(i32(a) for a in args), NOW0, near_ratio)
    for field in D.DecideResult._fields:
        assert np.array_equal(u32(getattr(got, field)), u32(getattr(want, field))), field


def _fps(keys):
    fp = keys.astype(np.uint64) * np.uint64(0x9E3779B185EBCA87) + np.uint64(1)
    return (fp & np.uint64(0xFFFFFFFF)).astype(np.uint32), (fp >> np.uint64(32)).astype(np.uint32)


@pytest.mark.parametrize("lean", [False, True], ids=["full", "lean"])
def test_slab_apply_plain_decide_matches_pallas_interpret(lean):
    """The plain fused apply against pallas_slab_apply(decide=True[, lean])
    over three grid steps: duplicate segments, rollovers, padding, a
    stored-row mix, limits around the running counts."""
    rng = np.random.default_rng(33 + lean)
    b = 768
    keys = np.sort(rng.integers(0, 200, b))
    lo, hi = _fps(keys)
    hits = rng.integers(1, 5, b).astype(np.uint32)
    hits[rng.random(b) < 0.1] = 0
    limit = rng.choice([1, 3, 10, 40, 1000], b).astype(np.uint32)
    div = rng.choice([0, 1, 60, 3600], b).astype(np.int32)
    jit = rng.integers(0, 30, b).astype(np.int32)
    seg_start = np.concatenate([[True], (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])])
    st = np.zeros((b, 8), np.uint32)
    st[:, 0], st[:, 1] = lo, hi
    st[:, 2] = rng.integers(0, 50, b)
    st[:, 3] = (NOW0 // np.maximum(div, 1)) * np.maximum(div, 1) - np.maximum(div, 1) * rng.integers(0, 2, b)
    st[:, 4] = NOW0 + rng.integers(-5, 100, b)
    st[rng.random(b) < 0.3, 0] ^= 1
    want = pallas_slab_apply(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(hits), jnp.asarray(limit),
        jnp.asarray(div), jnp.asarray(jit), jnp.asarray(seg_start),
        jnp.asarray(st[:, :5].T), jnp.int32(NOW0), jnp.float32(0.8),
        decide=True, lean=lean, interpret=True,
    )
    got = K.slab_apply(
        i32(lo), i32(hi), i32(hits), i32(div), i32(jit), torch.from_numpy(seg_start), i32(st), NOW0,
        s_limit=i32(limit), near_ratio=0.8, decide=True, lean=lean,
    )
    assert len(got) == len(want) == (5 if lean else 10)
    for k, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(u32(g), u32(w)), k
    assert np.any(u32(got[4]) == D.CODE_OVER_LIMIT) and np.any(u32(got[4]) == D.CODE_OK)


def _packed(rng, b, n_keys, now, n_sets, near_ratio=0.8):
    """A launch operand with Zipf-ish duplicates, a quarter of the batch in
    one set, mixed units and limits, padding at the tail, near_ratio in
    the scalar row."""
    keys = np.minimum(rng.zipf(1.3, b), n_keys) + rng.integers(0, n_keys, b) * (rng.random(b) < 0.5)
    p = np.zeros((7, b), np.uint32)
    p[0], p[1] = _fps(keys % n_keys)
    crowd = rng.random(b) < 0.25
    p[0, crowd] = (p[0, crowd] & ~np.uint32(n_sets - 1)) | np.uint32(3 % n_sets)
    p[2] = rng.integers(1, 4, b)
    p[2, b - int(rng.integers(1, b // 4)) :] = 0
    p[3] = rng.choice([3, 10, 100, 70000], b)
    p[4] = rng.choice([1, 2, 60, 3600], b)
    p[5] = rng.integers(0, 30, b)
    p[6, 0] = now
    p[6, 1] = np.float32(near_ratio).view(np.uint32)
    return p


CASES = ["packed", "decided", "decided_no_health", "packed_sketch", "decided_sketch"]


@pytest.mark.parametrize("case", CASES)
def test_decided_steps_match_jax_over_stream(case):
    """Multi-launch streams under eviction pressure, the clock crossing
    window edges: the port's packed / decided steps against the JAX XLA
    twin's (use_pallas=False, multi_algo=False): all 9 rows or the codes,
    health, table bytes and, with a 128-lane sketch, its planes."""
    rng = np.random.default_rng(CASES.index(case))
    n_slots, ways, b = 512, 4, 256
    sj, st = J.make_slab(n_slots), T.make_slab(n_slots, device="cpu")
    sketch = "sketch" in case
    count_health = case != "decided_no_health"
    kj = JSK.make_sketch(128) if sketch else None
    kt = TSK.make_sketch(128, device="cpu") if sketch else None
    skw = JSK.sketch_ways(ways, 128) if sketch else 0
    kw = {"sketch_ways": skw} if sketch else {}
    now, seen_over = NOW0, 0
    for _step in range(6):
        now += int(rng.choice([0, 1, 2, 59]))
        p = _packed(rng, b, 700, now, n_slots // ways)
        if case.startswith("packed"):
            outs_j = J.slab_step_packed(sj, jnp.asarray(p), ways=ways, use_pallas=False, multi_algo=False, sketch=kj, **kw)
            outs_t = T.slab_step_packed(st, p, ways=ways, sketch=kt, **kw)
            sj, out_j, h_j = outs_j[:3]
            out_t, h_t = outs_t[:2]
            assert out_t.dtype == torch.uint32 and tuple(out_t.shape) == (9, b)
            assert np.array_equal(out_t.numpy(), np.asarray(out_j))
            seen_over += int(np.sum(np.asarray(out_j)[T.OUT_CODE] == 2))
        else:
            outs_j = J.slab_step_decided(
                sj, jnp.asarray(p), ways=ways, use_pallas=False, count_health=count_health, multi_algo=False, sketch=kj, **kw
            )
            outs_t = T.slab_step_decided(st, p, ways=ways, count_health=count_health, sketch=kt, **kw)
            sj, codes_j, h_j = outs_j[:3]
            codes_t, h_t = outs_t[:2]
            assert codes_t.dtype == torch.uint8
            assert np.array_equal(codes_t.numpy(), np.asarray(codes_j))
            seen_over += int(np.sum(np.asarray(codes_j) == 2))
        assert np.array_equal(h_t.numpy(), np.asarray(h_j).astype(np.int64))
        assert np.array_equal(T.slab_export_copy(st), np.asarray(sj.table))
        if sketch:
            kj, kt = outs_j[3], outs_t[2]
            assert np.array_equal(TSK.sketch_export_copy(kt), np.asarray(kj))
        if not count_health:
            assert not h_t.any()
    assert seen_over > 0


@pytest.mark.parametrize("lean", [False, True], ids=["full", "lean"])
def test_step_decision_matches_jax_pallas_fused_interpret(lean):
    """The port's _slab_step_sorted against the reference's with the
    Pallas way scan and fused apply in interpret mode (W = 128): order,
    before/after and the decision fields (the code alone when lean)."""
    rng = np.random.default_rng(40 + lean)
    n_slots, ways, b = 1024, 128, 128
    sj, st = J.make_slab(n_slots), T.make_slab(n_slots, device="cpu")
    now = NOW0
    for _step in range(2):
        now += int(rng.integers(0, 2))
        p = _packed(rng, b, 24, now, n_slots // ways)
        batch_j = J.SlabBatch(*(jnp.asarray(p[r]) for r in range(4)), jnp.asarray(p[4].view(np.int32)), jnp.asarray(p[5].view(np.int32)))
        sj, bj, aj, dj, oj, _hj = J._slab_step_sorted(
            sj, batch_j, jnp.int32(now), jnp.float32(0.8), ways=ways, use_pallas=True,
            lean_decide=lean, interpret=True, multi_algo=False,
        )
        batch_t, now_t, ratio = T._unpack(p, "cpu")
        bt, at, dt, ot, _ht = T._slab_step_sorted(st, batch_t, now_t, ratio, ways, lean=lean)
        assert np.array_equal(ot.numpy(), np.asarray(oj))
        assert np.array_equal(u32(bt), u32(bj)) and np.array_equal(u32(at), u32(aj))
        fields = ("code",) if lean else D.DecideResult._fields
        for field in fields:
            assert np.array_equal(u32(getattr(dt, field)), u32(getattr(dj, field))), field
        if lean:
            assert dt.limit_remaining is None
        assert np.array_equal(T.slab_export_copy(st), np.asarray(sj.table))


def test_update_and_decide_matches_jax():
    rng = np.random.default_rng(50)
    n_slots, ways, b = 256, 4, 256
    p = _packed(rng, b, 300, NOW0, n_slots // ways)
    sj = J.make_slab(n_slots)
    st = T.make_slab(n_slots, device="cpu")
    batch_j = J.SlabBatch(*(jnp.asarray(p[r]) for r in range(4)), jnp.asarray(p[4].view(np.int32)), jnp.asarray(p[5].view(np.int32)))
    for k in range(2):
        sj, want = J.slab_update_and_decide(sj, batch_j, jnp.int32(NOW0 + k), jnp.float32(0.8), ways=ways)
        p[6, 0] = NOW0 + k
        got = T.slab_update_and_decide(st, p, ways=ways)
        assert isinstance(got, T.SlabResult)
        assert np.array_equal(u32(got.before), u32(want.before))
        assert np.array_equal(u32(got.after), u32(want.after))
        for field in D.DecideResult._fields:
            assert np.array_equal(u32(getattr(got.decision, field)), u32(getattr(want.decision, field))), field
        assert np.array_equal(got.health.numpy(), np.asarray(want.health).astype(np.int64))
        assert np.array_equal(T.slab_export_copy(st), np.asarray(sj.table))
    assert np.any(u32(got.decision.code) == D.CODE_OVER_LIMIT)


KEY_A = 0xDEADBEEFCAFEF00D
KEY_B = 0x1234567890ABCDEF


def test_decided_mode_codes():
    """tests/test_slab.py TestCompactReadbackModes.test_decided_mode_codes
    on the port: limit 2/second, hits 1, 1, 1 in one batch -> OK, OK,
    OVER; the next batch in the window is still over."""

    def packed(items, now, near_ratio=0.8):
        p = np.zeros((7, max(len(items), 2)), dtype=np.uint32)
        for i, (fp, hits, limit, divider) in enumerate(items):
            p[:5, i] = fp & 0xFFFFFFFF, fp >> 32, hits, limit, divider
        p[6, 0] = now
        p[6, 1] = np.float32(near_ratio).view(np.uint32)
        return p

    state = T.make_slab(1 << 12, device="cpu")
    items = [(KEY_A, 1, 2, 1)] * 3 + [(KEY_B, 1, 100, 1)]
    codes, _health = T.slab_step_decided(state, packed(items, now=5_000))
    assert codes.dtype == torch.uint8
    assert codes.tolist()[:4] == [1, 1, 2, 1]
    codes, _health = T.slab_step_decided(state, packed(items[:1], now=5_000))
    assert codes.tolist()[:1] == [2]


def test_decided_codes_match_set_slab_oracle():
    """The decided step's codes against the exact sequential host model,
    over a stream with duplicates, padding and window rollovers."""
    n_slots, ways = 256, 4
    oracle = JO.SetSlabOracle(n_slots, ways)
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
            (int(lo[i]), int(hi[i]), int(rng.integers(0, 3)), 3, 1 if ids[i] % 3 else 60, 0)
            for i in range(b)
        ]
        p = np.zeros((7, b), np.uint32)
        p[:6] = np.array(items, dtype=np.uint64).T.astype(np.uint32)
        p[6, 0] = now
        codes, health = T.slab_step_decided(st, p, ways=ways)
        _before, _after, w_codes, w_delta = oracle.step_batch(items, now)
        valid = p[2] > 0
        assert np.array_equal(codes.numpy()[valid], np.asarray(w_codes)[valid])
        assert np.all(codes.numpy()[~valid] == D.CODE_OK)
        assert health.tolist() == w_delta
    assert np.array_equal(T.slab_export_copy(st), oracle.table.astype(np.uint32))


def test_packbits_matches_numpy():
    rng = np.random.default_rng(60)
    for b in (8, 128, 4096):
        mask = rng.random(b) < 0.3
        assert np.array_equal(D.packbits(torch.from_numpy(mask)).numpy(), np.packbits(mask))
        ints = rng.integers(-3, 3, b).astype(np.int32)
        assert np.array_equal(D.packbits(torch.from_numpy(ints)).numpy(), np.packbits(ints != 0))
    with pytest.raises(ValueError):
        D.packbits(torch.zeros(12, dtype=torch.bool))


def test_parity_report_matches_reference():
    rng = np.random.default_rng(70)
    ids = rng.zipf(1.3, 20000) % 3000
    codes = rng.integers(1, 3, ids.size)
    assert np.array_equal(TO.occurrence_rank(ids), JO.occurrence_rank(ids))
    for limit, code_over in ((5, 2), (100, 1)):
        assert TO.parity_report(ids, codes, limit, code_over) == JO.parity_report(ids, codes, limit, code_over)


@pytest.mark.parametrize("entry", ["slab_step_packed", "slab_step_decided", "slab_update_and_decide"])
def test_operand_with_algorithm_bits_raises(entry):
    rng = np.random.default_rng(80)
    st = T.make_slab(256, device="cpu")
    p = _packed(rng, 128, 50, NOW0, 64)
    p[4, 5] |= np.uint32(T.ALGO_GCRA << T.ALGO_SHIFT)
    before = T.slab_export_copy(st)
    with pytest.raises(ValueError, match="algorithm bits"):
        getattr(T, entry)(st, p, ways=4)
    assert np.array_equal(T.slab_export_copy(st), before)


def test_decide_wrappers_validate_and_launch_nothing_on_cpu():
    K.reset_launch_counts()
    q = torch.zeros(16, dtype=torch.int32)
    st_rows = torch.zeros((16, 8), dtype=torch.int32)
    seg = torch.ones(16, dtype=torch.bool)
    with pytest.raises(ValueError):
        D.decide(q.long(), q, q, q, q, 0, 0.8)  # int64 operand
    with pytest.raises(ValueError):
        D.decide(q, q, q, q[:8], q, 0, 0.8)  # length mismatch
    with pytest.raises(ValueError):
        D.decide(q, q, q, q, q, 1 << 31, 0.8)  # now out of int32
    with pytest.raises(ValueError):
        K.slab_apply(q, q, q, q, q, seg, st_rows, 0, decide=True)  # no limits
    with pytest.raises(ValueError):
        K.slab_apply(q, q, q, q, q, seg, st_rows, 0, s_limit=q, lean=True)  # lean without decide
    with pytest.raises(ValueError):
        K.slab_apply(q, q, q, q, q, seg, st_rows, 0, s_limit=q[:8], decide=True)
    assert len(D.decide(q, q, q, q, q, 0, 0.8)) == 6
    assert len(K.slab_apply(q, q, q, q, q, seg, st_rows, 0, s_limit=q, decide=True)) == 10
    assert len(K.slab_apply(q, q, q, q, q, seg, st_rows, 0, s_limit=q, decide=True, lean=True)) == 5
    assert set(K.LAUNCHES.values()) == {0}


def test_library_path_hashes_the_shared_header(tmp_path, monkeypatch):
    """An edit to csrc/decide.cuh alone (no .cu changes) names a new
    library, so a stale build is never reused."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(K.CSRC_DIR, csrc)
    monkeypatch.setattr(K, "CSRC_DIR", str(csrc))
    before = K.library_path()
    assert [p.rsplit("/", 1)[1] for p in K.sources()] == [
        "decide_kernels.cu", "select_kernels.cu", "sketch_kernels.cu", "slab_kernels.cu",
    ]
    with open(csrc / "decide.cuh", "a") as f:
        f.write("// edited\n")
    assert K.library_path() != before


def test_smoke_stream_is_the_engine_benchmarks():
    """chip_smoke.py's decided phase draws its stream with copies of
    bench.py's zipf_ids and fmix32_np (bench_engine_zipf's generator and
    fingerprint bijection); the copies must give the same bits."""
    import bench
    import chip_smoke

    assert np.array_equal(chip_smoke.zipf_ids(1000, 256, 3, seed=0), bench.zipf_ids(1000, 256, 3, seed=0))
    x = np.random.default_rng(90).integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(chip_smoke.fmix32(x), bench.fmix32_np(x))


def test_smoke_staged_step_is_the_host_operand_step():
    """chip_smoke.py's staged decided step (ids expanded by torch ops, as
    the reference's bench_step expands them on the device) gives
    decided_operand's fingerprints bit for bit, over the whole uint32
    range, and the same OVER bits and health as slab_step_decided on the
    host operand, launch after launch."""
    import types

    import chip_smoke

    rng = np.random.default_rng(91)
    ids = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    ids[:4] = [0, 1, 0x9E3779B9, 0xFFFFFFFF]
    batch = chip_smoke.expand_ids(T, torch.from_numpy(ids.view(np.int32)))
    want = chip_smoke.decided_operand(ids, NOW0)
    for row, got in zip(want[:6], batch):
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy().view(np.uint32), row)
    M = types.SimpleNamespace(S=T, D=D)
    staged, host = T.make_slab(1 << 12, device="cpu"), T.make_slab(1 << 12, device="cpu")
    for _ in range(3):
        block = np.minimum(rng.zipf(1.2, 1024), 300).astype(np.uint32)
        bits, health = chip_smoke.staged_step(M, staged, torch.from_numpy(block.view(np.int32)), NOW0)
        codes, want_health = T.slab_step_decided(host, chip_smoke.decided_operand(block, NOW0), ways=chip_smoke.DECIDED_WAYS)
        assert torch.equal(bits, D.packbits(codes == D.CODE_OVER_LIMIT))
        assert torch.equal(health, want_health)
    assert torch.equal(staged.table, host.table)
    assert bool((codes == D.CODE_OVER_LIMIT).any())
