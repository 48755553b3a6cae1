"""The reference against the program's own step on the CPU (the kernels'
plain versions): the same counters, row for row, launch after launch,
whole-table and over a sample of the sets, at every algorithm, with sets
overfull and in-launch collisions."""

import numpy as np
import pytest

from rlbench.reference import SlabReference, saturate


def stream(rng, n_keys, n_sets, narrow_sets=0):
    fps = rng.integers(0, 2**64, size=n_keys, dtype=np.uint64)
    lo = (fps & np.uint64(0xFFFFFFFF)).astype(np.int64)
    hi = (fps >> np.uint64(32)).astype(np.int64)
    if narrow_sets:
        lo = (lo & ~np.int64(n_sets - 1)) | rng.integers(0, narrow_sets, n_keys)
    ids = np.arange(n_keys)
    algo = ids % 4
    limit = np.array([5, 100, 1000])[(ids // 4) % 3]
    div = np.where(algo == 3, 60, np.array([1, 60, 3600])[(ids // 12) % 3])
    return lo, hi, algo, limit, div


@pytest.mark.parametrize(
    "n_slots,ways,n_keys,batch,multi,share,narrow",
    [
        (256, 4, 400, 300, True, None, 0),  # overfull sets: live evictions
        (256, 4, 400, 300, False, None, 0),  # the fixed-window body
        (1024, 128, 3000, 500, True, None, 0),  # the card's width
        (1024, 4, 3000, 500, True, 0.25, 0),  # a sample of the sets
        (1 << 24, 128, 2000, 1500, True, 0.5, 8),  # 6 sort bits: collisions interleave
    ],
)
@pytest.mark.parametrize("seed", [0, 1])
def test_reference_matches_the_programs_step(n_slots, ways, n_keys, batch, multi, share, narrow, seed):
    from api_ratelimit_tpu_torch.ops.slab import make_slab, slab_step_after

    rng = np.random.default_rng(seed)
    n_sets = n_slots // ways
    lo, hi, algo, limit, div = stream(rng, n_keys, n_sets, narrow)
    if not multi:
        algo = np.zeros_like(algo)
        div = np.ones_like(div)
    sets = None
    if share:
        pool = np.arange(narrow) if narrow else np.arange(n_sets)
        sets = rng.choice(pool, max(1, int(pool.size * share)), replace=False)
    state = make_slab(n_slots, "cpu")
    ref = SlabReference(n_slots, ways, 1.5, sets=sets)
    now = 1_790_000_000
    checked = 0
    for _ in range(20):
        now += int(rng.integers(0, 3))
        k = rng.integers(0, n_keys, batch) if narrow else (rng.zipf(1.3, batch) - 1) % n_keys
        a = algo[k].copy()
        a[(a == 3) & (rng.random(batch) < 0.3)] = 4
        word = div[k] | (a << 28)
        jit = rng.integers(0, 300, batch)
        hits = rng.integers(1, 3, batch)
        packed = np.zeros((7, batch), np.uint32)
        for row, col in enumerate((lo[k], hi[k], hits, limit[k], word, jit)):
            packed[row] = col
        packed[6, 0] = now
        packed[6, 2] = np.float32(1.5).view(np.uint32)
        out, _health = slab_step_after(state, packed, ways=ways, out_dtype=np.uint32, multi_algo=multi)
        got = out.numpy().astype(np.int64)
        m = ref.holds(lo[k])
        want = ref.step(lo[k][m], hi[k][m], hits[m], limit[k][m], word[m], jit[m], now)
        np.testing.assert_array_equal(got[m], want)
        checked += int(m.sum())
    assert checked > batch


def test_saturation_keeps_every_decision():
    after = np.array([1, 254, 255, 300, 70000])
    assert list(saturate(after, np.array([100]), np.array([1]))) == [1, 254, 255, 255, 255]
    assert list(saturate(after, np.array([1000]), np.array([1]))) == [1, 254, 255, 300, 65535]
    assert list(saturate(after, np.array([70000]), np.array([1]))) == list(after)


def test_the_control_departs_on_repeated_keys():
    ref = SlabReference(1024, 4)
    ctl = SlabReference(1024, 4, serialize=False)
    row = [np.array([5, 5, 5]), np.array([9, 9, 9]), np.ones(3, int), np.full(3, 100), np.ones(3, int), np.zeros(3, int)]
    assert list(ref.step(*row, 100)) == [1, 2, 3]
    assert list(ctl.step(*row, 100)) == [1, 1, 1]
