"""The fused sketch update's design, on the CPU: a numpy model of the
decomposition that csrc/sketch_kernels.cu sketch_update_kernel runs (512-item
blocks; in each, the scan, phase A's adds into a delta plane and phase B's
per-set lexicographic maximum in three rounds; per-block per-set partials;
the last block's finalize over the partials, here in a shuffled block order,
the victims and the plane rewrite) against the port's plain version
(ops/sketch_kernels.py sketch_update_plain) and the JAX package's
sketch_update (its XLA twin, and the pallas_sketch_scan arm in interpret
mode at W = 128), threaded over 6 launches. Also each edge case the kernel
must get right, and the wrapper's routing. Integers throughout: every
comparison is bit-exact (tolerance 0)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from api_ratelimit_tpu.ops import sketch as JS  # noqa: E402
from api_ratelimit_tpu_torch.ops import sketch as TS  # noqa: E402
from api_ratelimit_tpu_torch.ops import sketch_kernels as SK  # noqa: E402
from api_ratelimit_tpu_torch.ops import slab_kernels as K  # noqa: E402

M32 = 0xFFFFFFFF
BLOCK = 512  # the kernel's items a block
LAUNCHES = 6
GEOMETRIES = ((128, 4), (128, 128), (1024, 4), (1024, 128))
SIZES = (1, 511, 512, 513, 4096)


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def block_model(planes, lo, hi, w, cand, ways, rng):
    """The kernel's decomposition in numpy over uint32 planes[3, lanes] and
    one launch's items; returns the new planes."""
    lanes = planes.shape[1]
    n_sets = lanes // ways
    b = lo.size
    n_blocks = -(-b // BLOCK)
    sets = planes.reshape(3, n_sets, ways)
    cnt_i32 = sets[2].view(np.int32)
    delta = np.zeros(lanes, np.uint64)
    part = np.zeros((n_blocks, n_sets, 3), np.uint64)
    for blk in range(n_blocks):
        idx = np.arange(blk * BLOCK, min(b, (blk + 1) * BLOCK))
        idx = idx[cand[idx]]
        s = (lo[idx] & np.uint32(n_sets - 1)).astype(np.int64)
        # the scan: the first way whose signed count is > 0 and whose
        # fingerprint is the candidate's
        match = (cnt_i32[s] > 0) & (sets[0][s] == lo[idx, None]) & (sets[1][s] == hi[idx, None])
        matched = match.any(axis=1)
        lane = s * ways + match.argmax(axis=1)
        np.add.at(delta, lane[matched], w[idx][matched].astype(np.uint64))  # phase A
        # phase B in the block: three rounds of a per-set maximum over {0}
        um = ~matched
        s_u, w_u = s[um], w[idx][um].astype(np.uint64)
        h_u, l_u = hi[idx][um].astype(np.uint64), lo[idx][um].astype(np.uint64)
        set_w = np.zeros(n_sets, np.uint64)
        np.maximum.at(set_w, s_u, w_u)
        ok = w_u == set_w[s_u]
        set_h = np.zeros(n_sets, np.uint64)
        np.maximum.at(set_h, s_u[ok], h_u[ok])
        ok &= h_u == set_h[s_u]
        set_l = np.zeros(n_sets, np.uint64)
        np.maximum.at(set_l, s_u[ok], l_u[ok])
        part[blk] = np.stack([set_w, set_h, set_l], axis=1)
    # the last block: the partials in whatever order the blocks arrived
    best = np.zeros((n_sets, 3), np.uint64)
    for blk in rng.permutation(n_blocks):
        for st in range(n_sets):
            if tuple(part[blk, st]) > tuple(best[st]):
                best[st] = part[blk, st]
    vic_way = cnt_i32.argmin(axis=1)  # the first way at the minimum
    vic_cnt = sets[2][np.arange(n_sets), vic_way].astype(np.uint64)
    out = planes.copy()
    out[2] = (planes[2].astype(np.uint64) + delta) & M32
    for st in np.flatnonzero(best[:, 0] > 0):
        lane = st * ways + vic_way[st]
        out[0, lane], out[1, lane] = best[st, 2], best[st, 1]
        out[2, lane] = (vic_cnt[st] + best[st, 0]) & M32
    return out


def plain_update(planes, lo, hi, w, cand, ways):
    got = SK.sketch_update_plain(_i32(planes), _i32(lo), _i32(hi), _i32(w), torch.from_numpy(cand), ways)
    assert got.dtype == torch.int32
    return TS.sketch_export_copy(got)


def jax_update(planes, lo, hi, w, cand, ways, use_pallas=False):
    return np.asarray(
        JS.sketch_update(
            jnp.asarray(planes), jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(w), jnp.asarray(cand), ways,
            use_pallas=use_pallas, interpret=use_pallas,
        )
    )


def check_all(planes, lo, hi, w, cand, ways, rng, pallas=False):
    """The model, the plain version and JAX (and its Pallas arm) agree;
    returns the model's planes."""
    got = block_model(planes, lo, hi, w, cand, ways, rng)
    assert np.array_equal(got, plain_update(planes, lo, hi, w, cand, ways))
    assert np.array_equal(got, jax_update(planes, lo, hi, w, cand, ways))
    if pallas:
        assert np.array_equal(got, jax_update(planes, lo, hi, w, cand, ways, use_pallas=True))
    return got


def adversarial_planes(rng, lanes, ways):
    """Empty lanes (count 0, fp 0/0), stale tags under count 0, an occupied
    0/0 tag, count ties, counts >= 2^31 (unoccupied when read signed) and
    random occupied rows; each lane's fp_lo names its own set."""
    p = np.zeros((3, lanes), np.uint32)
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
    p[:2, lanes // 3] = 0
    p[2, lanes // 3] = 5
    return p


def batch(rng, planes, b):
    """A slot-sorted-like batch of b items over distinct keys: resident
    fingerprints (occupied or not) and new ones, each key a run of items
    whose last item is the candidate (a tenth of the runs have none, as a
    padding run). Weights: small (ties), up to 2^32 - 1, and 0 (a wrapped
    segment sum); the non-candidate rows carry garbage."""
    lanes = planes.shape[1]
    n_keys = max(1, b // 3)
    pick = rng.integers(0, lanes, n_keys)
    lo, hi = planes[0, pick].copy(), planes[1, pick].copy()
    new = rng.random(n_keys) < 0.5
    lo[new] = rng.integers(0, 1 << 32, int(new.sum()), dtype=np.uint64)
    hi[new] = rng.integers(0, 1 << 32, int(new.sum()), dtype=np.uint64)
    key = (lo.astype(np.uint64) << np.uint64(32)) | hi
    _, first = np.unique(key, return_index=True)
    lo, hi = lo[np.sort(first)], hi[np.sort(first)]
    item_key = np.sort(rng.integers(0, lo.size, b))
    last = np.r_[item_key[1:] != item_key[:-1], True]
    cand = last & (rng.random(b) < 0.9)
    w = np.select(
        [rng.random(b) < 0.1, rng.random(b) < 0.2],
        [np.uint64(0), rng.integers(1 << 31, 1 << 32, b, dtype=np.uint64)],
        rng.integers(1, 4, b, dtype=np.uint64),
    ).astype(np.uint32)
    return lo[item_key], hi[item_key], w, cand


@pytest.mark.parametrize("b", SIZES)
@pytest.mark.parametrize("lanes,ways", GEOMETRIES)
def test_block_model_matches_plain_and_jax(lanes, ways, b):
    """Six launches threaded through the model, the plain version and JAX,
    from adversarial planes."""
    rng = np.random.default_rng(lanes * 7919 + ways * 31 + b)
    planes = adversarial_planes(rng, lanes, ways)
    matched = unmatched = 0
    for _ in range(LAUNCHES):
        lo, hi, w, cand = batch(rng, planes, b)
        m_any = SK.sketch_scan_plain(_i32(planes), _i32(lo), _i32(hi), ways)[1].numpy()
        matched += int((m_any & cand).sum())
        unmatched += int((~m_any & cand).sum())
        planes = check_all(planes, lo, hi, w, cand, ways, rng)
    assert (matched > 0 and unmatched > 0) if b > 1 else matched + unmatched > 0


@pytest.mark.parametrize("b", (512, 4096))
def test_block_model_matches_pallas_arm(b):
    """At the Pallas geometry (W = 128, one set of 128 lanes) the JAX
    update through pallas_sketch_scan in interpret mode agrees too."""
    rng = np.random.default_rng(b)
    planes = adversarial_planes(rng, 128, 128)
    for _ in range(3):
        lo, hi, w, cand = batch(rng, planes, b)
        planes = check_all(planes, lo, hi, w, cand, 128, rng, pallas=True)


def _occupied_set(rng, lanes, ways, lo_base=0x1000):
    """Planes whose every lane is occupied (counts 10-999) with distinct
    fingerprints in its own set."""
    n_sets = lanes // ways
    p = np.zeros((3, lanes), np.uint32)
    p[0] = ((np.arange(lanes, dtype=np.uint64) + lo_base) * np.uint64(n_sets)) | (
        np.arange(lanes, dtype=np.uint64) // np.uint64(ways)
    )
    p[1] = rng.integers(0, 1 << 32, lanes, dtype=np.uint64)
    p[2] = rng.integers(10, 1000, lanes)
    return p


def _new_keys(n, n_sets, s, seed):
    """n fingerprints in set s that no plane holds."""
    r = np.random.default_rng(seed)
    lo = (r.integers(1 << 24, 1 << 31, n, dtype=np.uint64) * np.uint64(n_sets) + np.uint64(s)) & np.uint64(M32)
    return lo.astype(np.uint32), r.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)


def case_matched_lane_is_victim(rng, lanes, ways):
    """The set's victim lane holds a key that matches this launch: phase A
    adds to it, then the winner overwrites it with victim count + weight."""
    p = _occupied_set(rng, lanes, ways)
    v = 5 % ways
    p[2, v] = 3  # the minimum of set 0: the victim
    new_lo, new_hi = _new_keys(2, lanes // ways, 0, 1)
    lo = np.array([p[0, v], new_lo[0], new_lo[1]], np.uint32)
    hi = np.array([p[1, v], new_hi[0], new_hi[1]], np.uint32)
    w = np.array([7, 5, 4], np.uint32)
    cand = np.ones(3, bool)

    def holds(out):
        assert (out[0, v], out[1, v], out[2, v]) == (lo[1], hi[1], 3 + 5)
        return True

    return p, lo, hi, w, cand, holds


def case_wrapped_zero_weight(rng, lanes, ways):
    """The only unmatched candidate of a set has weight 0 (its segment sum
    wrapped 2^32): it never wins, whatever its fingerprint."""
    p = _occupied_set(rng, lanes, ways)
    lo, hi = _new_keys(1, lanes // ways, 0, 2)
    hi[:] = M32
    w = np.zeros(1, np.uint32)
    cand = np.ones(1, bool)
    return p, lo, hi, w, cand, lambda out: np.array_equal(out, p)


def case_weight_ties(rng, lanes, ways):
    """Three unmatched candidates tie on the top weight: the largest fp_hi
    wins."""
    p = _occupied_set(rng, lanes, ways)
    lo, hi = _new_keys(4, lanes // ways, 0, 3)
    hi[:] = [10, 30, 20, 99]
    w = np.array([9, 9, 9, 8], np.uint32)
    cand = np.ones(4, bool)
    v = int(p[2, :ways].view(np.int32).argmin())
    return p, lo, hi, w, cand, lambda out: (out[0, v], out[1, v]) == (lo[1], 30)


def case_weight_and_hi_ties(rng, lanes, ways):
    """Candidates tie on (weight, fp_hi): the largest fp_lo wins."""
    p = _occupied_set(rng, lanes, ways)
    lo, hi = _new_keys(3, lanes // ways, 0, 4)
    hi[:] = 77
    w = np.full(3, 6, np.uint32)
    cand = np.ones(3, bool)
    top = int(np.argmax(lo))
    v = int(p[2, :ways].view(np.int32).argmin())
    return p, lo, hi, w, cand, lambda out: (out[0, v], out[1, v]) == (lo[top], 77)


def case_counts_ge_2_31(rng, lanes, ways):
    """Counts >= 2^31 are unoccupied when read signed: a candidate equal to
    such a lane's fingerprint does not match it, the first such lane is the
    victim, and the winner's count wraps 2^32."""
    p = _occupied_set(rng, lanes, ways)
    p[2, 2 % ways] = 0xFFFFFFF0
    p[2, 3 % ways] = 0xFFFFFFF0
    lo = np.array([p[0, 3 % ways]], np.uint32)
    hi = np.array([p[1, 3 % ways]], np.uint32)
    w = np.array([0x20], np.uint32)
    cand = np.ones(1, bool)
    v = 2 % ways
    return p, lo, hi, w, cand, lambda out: (out[0, v], out[1, v], out[2, v]) == (lo[0], hi[0], 0x10)


def case_set_without_candidates(rng, lanes, ways):
    """Only set 1 has candidates: every other set comes out as it went in."""
    n_sets = lanes // ways
    p = _occupied_set(rng, lanes, ways)
    lo, hi = _new_keys(5, n_sets, 1 % n_sets, 6)
    w = np.array([1, 2, 3, 4, 5], np.uint32)
    cand = np.ones(5, bool)

    def holds(out):
        other = np.ones(lanes, bool)
        other[(1 % n_sets) * ways : (1 % n_sets + 1) * ways] = False
        return n_sets == 1 or np.array_equal(out[:, other], p[:, other])

    return p, lo, hi, w, cand, holds


def case_b_1(rng, lanes, ways):
    """One item, one candidate, into an empty sketch."""
    p = np.zeros((3, lanes), np.uint32)
    lo, hi = _new_keys(1, lanes // ways, 0, 7)
    w = np.array([3], np.uint32)
    cand = np.ones(1, bool)
    return p, lo, hi, w, cand, lambda out: (out[0, 0], out[1, 0], out[2, 0]) == (lo[0], hi[0], 3)


def case_b_not_multiple_of_512(rng, lanes, ways):
    """1000 items in two blocks; the top weight ties across the blocks and
    the winner (largest fp_hi) sits in the second, ragged block."""
    p = _occupied_set(rng, lanes, ways)
    b = 1000
    lo, hi = _new_keys(b, lanes // ways, 0, 8)
    hi = (hi & np.uint32(0x7FFFFFFF)).astype(np.uint32)
    w = rng.integers(1, 50, b).astype(np.uint32)
    cand = rng.random(b) < 0.8
    cand[[3, 900]] = True
    w[[3, 900]] = 1000
    hi[3], hi[900] = 0x80000000, 0x80000001
    v = int(p[2, :ways].view(np.int32).argmin())
    return p, lo, hi, w, cand, lambda out: (out[0, v], out[1, v]) == (lo[900], hi[900])


EDGE_CASES = {
    "matched_lane_is_victim": case_matched_lane_is_victim,
    "wrapped_zero_weight": case_wrapped_zero_weight,
    "weight_ties": case_weight_ties,
    "weight_and_hi_ties": case_weight_and_hi_ties,
    "counts_ge_2_31": case_counts_ge_2_31,
    "set_without_candidates": case_set_without_candidates,
    "b_1": case_b_1,
    "b_not_multiple_of_512": case_b_not_multiple_of_512,
}


@pytest.mark.parametrize("lanes,ways", ((128, 128), (1024, 4)))
@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_edge_case(case, lanes, ways):
    """Each edge case, built on purpose, at one set of 128 and at 256 sets
    of 4: the model, the plain version and JAX agree, and the case's own
    expectation holds."""
    rng = np.random.default_rng(len(case) * 1009 + lanes + ways)
    planes, lo, hi, w, cand, holds = EDGE_CASES[case](rng, lanes, ways)
    out = check_all(planes, lo, hi, w, cand, ways, rng, pallas=ways == 128)
    assert holds(out)


def test_sketch_update_on_cpu_is_the_plain_version():
    """ops/sketch.py sketch_update on CPU tensors returns the plain
    version's planes, through the fused wrapper, and counts no launch."""
    rng = np.random.default_rng(21)
    planes = adversarial_planes(rng, 1024, 4)
    lo, hi, w, cand = batch(rng, planes, 700)
    K.reset_launch_counts()
    args = (_i32(lo), _i32(hi), _i32(w), torch.from_numpy(cand), 4)
    got = TS.sketch_update(_i32(planes), *args)
    assert torch.equal(got, SK.sketch_update_plain(_i32(planes), *args))
    assert torch.equal(got, SK.sketch_update_fused(_i32(planes), *args))
    assert not any(K.LAUNCHES.values())


def test_fused_wrapper_refuses_other_devices():
    """A tensor on neither the CPU nor a card: the wrapper raises, it does
    not fall back to the plain version."""
    meta = torch.device("meta")
    planes = torch.empty((3, 128), dtype=torch.int32, device=meta)
    q = torch.empty(16, dtype=torch.int32, device=meta)
    cand = torch.empty(16, dtype=torch.bool, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        SK.sketch_update_fused(planes, q, q, q, cand, 128)
