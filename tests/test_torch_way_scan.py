"""The way scan's set-major design, on the CPU: a numpy model of what the
set-major form in csrc/slab_kernels.cu runs (a counting sort of the items by
set with block-aggregated ranks and block-claimed offsets, then warps of 32
grouped items, each run of one set read once, the set's minimal-key mask,
the first live tag match by ballot and the cyclic first bit of the mask at
or after pref) against the port's plain version (ops/slab_kernels.py
way_scan_plain), the Pallas kernel in interpret mode at W = 128 and the JAX
package's XLA twin (api_ratelimit_tpu/ops/slab.py _choose_ways) where
counts reach 2^31. Also the routing rule between the two forms. Integers
throughout: every comparison is bit-exact (tolerance 0)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from api_ratelimit_tpu.ops import slab as J  # noqa: E402
from api_ratelimit_tpu.ops.pallas_slab import pallas_way_scan  # noqa: E402
from api_ratelimit_tpu_torch.ops import slab_kernels as K  # noqa: E402

NOW = 1_000_000
WARP = 32
SET_WARPS = 4  # the scan kernel's warps a block: a tile is 128 grouped items
GROUP_THREADS = 256  # the grouping kernels' threads a block
COUNT_ITEMS = 1024  # the histogram's items a block
SCORE_TIER_SHIFT = 28
ALGO_DIV_MASK = (1 << 28) - 1
M32 = 0xFFFFFFFF


def ballot(pred) -> int:
    """The 32-bit word of a warp ballot over up to 32 lanes' predicates."""
    return sum(1 << lane for lane, p in enumerate(pred) if p)


def ffs(word: int) -> int:
    """__ffs: 1 + the lowest set bit's index, 0 for 0."""
    return (word & -word).bit_length()


def group_by_set(lo, n_sets: int, rng):
    """The kernel's counting sort, with the card's free orders drawn at
    random. The histogram's blocks of 1024 items (4 an item's thread, 256
    threads) count their sets in shared memory: round k takes items
    k * 256 + thread, the warps' leaders add in a shuffled order, and the
    lanes of a warp that share a set rank after their leader in lane order;
    then each block adds its per-set totals to the counters (blocks in a
    shuffled order) and its items rank after the base it got. The offset
    blocks of 256 counters claim their spans in a shuffled order. Returns
    the item indices in grouped order."""
    b = lo.size
    sets = lo.astype(np.int64) & (n_sets - 1)
    counts = np.zeros(n_sets, np.int64)
    rank = np.empty(b, np.int64)
    for blk in rng.permutation(-(-b // COUNT_ITEMS)):
        local = {}  # the block's shared-memory counts by set
        for k in range(COUNT_ITEMS // GROUP_THREADS):
            row = blk * COUNT_ITEMS + k * GROUP_THREADS
            for w in rng.permutation(GROUP_THREADS // WARP):
                lanes = np.arange(row + w * WARP, min(row + w * WARP + WARP, b))
                for s in np.unique(sets[lanes]):
                    peers = lanes[sets[lanes] == s]
                    rank[peers] = local.get(s, 0) + np.arange(peers.size)  # base + popc(lower peers)
                    local[s] = local.get(s, 0) + peers.size
        items = np.arange(blk * COUNT_ITEMS, min(blk * COUNT_ITEMS + COUNT_ITEMS, b))
        base = {}
        for s in rng.permutation(list(local)):
            base[s] = counts[s]
            counts[s] += local[s]
        rank[items] += np.array([base[s] for s in sets[items]], np.int64).reshape(-1)
    offsets = np.empty(n_sets, np.int64)
    total = 0
    for blk in rng.permutation(-(-n_sets // GROUP_THREADS)):
        c = counts[blk * GROUP_THREADS : (blk + 1) * GROUP_THREADS]
        offsets[blk * GROUP_THREADS : blk * GROUP_THREADS + c.size] = total + np.cumsum(c) - c
        total += int(c.sum())
    order = np.empty(b, np.int64)
    order[offsets[sets] + rank] = np.arange(b)
    return order


def set_keys(rows, now: int, way_bits: int):
    """The query-free part of one set, once: (tier << 28) | capped count <<
    way_bits for live ways, 0 for dead ones; and the live flags."""
    expire = rows[:, 4].view(np.int32).astype(np.int64)
    window = rows[:, 3].view(np.int32).astype(np.int64)
    div = (rows[:, 5].view(np.int32).astype(np.int64)) & ALGO_DIV_MASK
    live = expire > now
    ended_at = ((window + div + (1 << 31)) & M32) - (1 << 31)  # int32 wrap
    ended = live & (div > 0) & (ended_at <= now)
    cnt = np.minimum(rows[:, 2].astype(np.int64), (1 << (SCORE_TIER_SHIFT - way_bits)) - 1)
    tier = np.where(live, np.where(ended, 1, 2), 0)
    return (tier << SCORE_TIER_SHIFT) | np.where(live, cnt << way_bits, 0), live


def first_way_from(mask_words, pref: int) -> int:
    """The first way at or after pref, cyclically, whose bit is set: pref's
    word from pref on, the following words, pref's word below pref."""
    nw = len(mask_words)
    pw, pb = pref >> 5, pref & 31
    for c in range(nw + 1):
        q = (pw + c) & (nw - 1)
        word = mask_words[q]
        if c == 0:
            word &= (M32 << pb) & M32
        if c == nw:
            word &= (1 << pb) - 1
        if word:
            return q * 32 + ffs(word) - 1
    raise AssertionError("the minimal-key mask is never empty")


def set_major_model(table, lo, hi, now: int, ways: int, rng):
    """The set-major scan step by step. table uint32[n_slots, 8], lo/hi
    uint32[b]. Returns (int32[b] way, bool[b] matched, uint32[b, 8] picked,
    {"reads": sets read, "split": runs that start a warp's items inside a
    set's group})."""
    b = lo.size
    n_sets = table.shape[0] // ways
    sets_of = table.reshape(n_sets, ways, 8)
    way_bits = max(1, (ways - 1).bit_length())
    nw = max(1, ways // WARP)
    order = group_by_set(lo, n_sets, rng)
    way = np.empty(b, np.int32)
    matched = np.empty(b, bool)
    picked = np.empty((b, 8), np.uint32)
    stats = {"reads": 0, "split": 0}
    grouped_sets = lo[order].astype(np.int64) & (n_sets - 1)
    for tile0 in range(0, b, SET_WARPS * WARP):
        for warp0 in range(tile0, min(tile0 + SET_WARPS * WARP, b), WARP):
            chunk = order[warp0 : warp0 + WARP]
            sets = grouped_sets[warp0 : warp0 + WARP]
            starts = np.flatnonzero(np.r_[True, sets[1:] != sets[:-1]])
            ends = np.r_[starts[1:], chunk.size]
            if warp0 > 0 and grouped_sets[warp0 - 1] == sets[0]:
                stats["split"] += 1
            for a, e in zip(starts, ends):
                rows = sets_of[sets[a]]  # the set's one read for this run
                stats["reads"] += 1
                key, live = set_keys(rows, now, way_bits)
                lanes_of = lambda v, k: np.r_[v[32 * k : 32 * k + 32], np.zeros(max(0, 32 * k + 32 - ways), v.dtype)]  # noqa: E731
                is_min = key == key.min()
                mask_words = [ballot(lanes_of(is_min, k)) for k in range(nw)]
                for t in range(a, e):
                    item = chunk[t]
                    tag = live & (rows[:, 0] == lo[item]) & (rows[:, 1] == hi[item])
                    match = ways
                    for k in reversed(range(nw)):  # the lowest word's hit wins
                        hit = ballot(lanes_of(tag, k))
                        if hit:
                            match = 32 * k + ffs(hit) - 1
                    pref = (int(hi[item]) >> way_bits) & (ways - 1)
                    way[item] = match if match < ways else first_way_from(mask_words, pref)
                    matched[item] = match < ways
                    picked[item] = rows[way[item]]
    return way, matched, picked, stats


def fps(keys):
    fp = keys.astype(np.uint64) * np.uint64(0x9E3779B185EBCA87) + np.uint64(1)
    return (fp & np.uint64(M32)).astype(np.uint32), (fp >> np.uint64(32)).astype(np.uint32)


def random_rows(rng, n: int, big_counts: bool = True):
    """Dead, never-written, window-ended and live rows around NOW, 30% of
    counts drawn up to 2^32 (2^31 with big_counts=False)."""
    t = np.zeros((n, 8), np.uint32)
    t[:, 0] = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    t[:, 1] = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    top = 1 << 32 if big_counts else 1 << 31
    t[:, 2] = np.where(rng.random(n) < 0.3, rng.integers(0, top, n, dtype=np.uint64), rng.integers(0, 50, n))
    div = rng.choice([1, 60, 3600], n)
    t[:, 5] = div
    t[:, 3] = (NOW // div) * div - div * rng.integers(0, 2, n)
    t[:, 4] = NOW + rng.integers(-5, 100, n)
    t[rng.random(n) < 0.2, 4] = 0
    return t


def store_keys(rng, t, lo, hi, ways: int, share: float = 0.5):
    """Put a share of the batch's keys in a random way of their set."""
    n_sets = t.shape[0] // ways
    k = int(lo.size * share)
    idx = (lo[:k].astype(np.int64) & (n_sets - 1)) * ways + rng.integers(0, ways, k)
    t[idx, 0], t[idx, 1] = lo[:k], hi[:k]


def scenario(name: str, ways: int, rng, big_counts: bool = True):
    """(table uint32[n_slots, 8], lo, hi uint32[b]) for one named case."""
    n_slots = max(64 * ways, 1024)
    n_sets = n_slots // ways
    b = 600
    if name == "b_below_sets":
        n_slots, b = 64 * ways * 8, 100
        n_sets = n_slots // ways
    elif name == "b_far_above_sets":
        n_slots, b = 4 * ways, 3000
        n_sets = 4
    lo, hi = fps(rng.integers(0, 3 * b, b))
    t = random_rows(rng, n_slots, big_counts)
    if name == "all_dead":
        t[:, 4] = np.where(rng.random(n_slots) < 0.5, 0, NOW - rng.integers(0, 100, n_slots))
    elif name == "equal_counts":
        t[:, 4] = NOW + 50
        t[:, 2] = 7
        t[:, 3] = NOW - NOW % 60
        t[:, 5] = 60
    elif name == "window_ended":
        t[:, 4] = NOW + 50
        t[:, 5] = rng.choice([1, 60], n_slots)
        t[:, 3] = NOW - 3600 - rng.integers(0, 5, n_slots)
        t[:, 2] = rng.integers(0, 4, n_slots)
    elif name == "counts_at_cap":
        cap = (1 << (SCORE_TIER_SHIFT - max(1, (ways - 1).bit_length()))) - 1
        t[:, 4] = NOW + 50
        t[:, 2] = rng.choice(np.array([cap - 1, cap, cap + 1, cap + 1000, 1 << 31, M32], np.uint64), n_slots)
        t[:, 3] = NOW - NOW % 3600
        t[:, 5] = 3600
    elif name == "one_set_half":
        crowd = rng.random(b) < 0.6
        lo[crowd] = (lo[crowd] & ~np.uint32(n_sets - 1)) | np.uint32(5 % n_sets)
    elif name == "tile_split":
        # three sets, so each group of ~200 grouped items crosses warp and tile borders
        lo = (lo & ~np.uint32(n_sets - 1)) | (np.arange(b) % 3).astype(np.uint32)
    store_keys(rng, t, lo, hi, ways)
    if name == "dead_tag_first":
        # each stored key also tagged in a lower, dead way of its set, ahead of its live way
        for i in range(0, b // 2, 3):
            base = (int(lo[i]) & (n_sets - 1)) * ways
            ways_of = t[base : base + ways]
            hit = np.flatnonzero((ways_of[:, 0] == lo[i]) & (ways_of[:, 1] == hi[i]))
            if hit.size and hit[0] > 0 and ways > 1:
                ways_of[hit[0], 4] = NOW + 10
                dead = int(rng.integers(0, hit[0]))
                ways_of[dead, 0], ways_of[dead, 1], ways_of[dead, 4] = lo[i], hi[i], NOW - 1
    return t, lo, hi


SCENARIOS = (
    "mixed", "all_dead", "equal_counts", "window_ended", "counts_at_cap", "dead_tag_first",
    "b_below_sets", "b_far_above_sets", "one_set_half", "tile_split",
)


def as_t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def plain(t, lo, hi, ways: int):
    way, matched, picked = K.way_scan_plain(as_t(t), as_t(lo), as_t(hi), NOW, ways)
    return way.numpy(), matched.numpy(), picked.numpy().view(np.uint32)


def assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("ways", [4, 32, 128, 256])
@pytest.mark.parametrize("name", SCENARIOS)
def test_set_major_model_matches_plain(name, ways):
    rng = np.random.default_rng(SCENARIOS.index(name) * 1000 + ways)
    t, lo, hi = scenario(name, ways, rng)
    way, matched, picked, stats = set_major_model(t, lo, hi, NOW, ways, rng)
    assert_same((way, matched, picked), plain(t, lo, hi, ways))
    n_sets = t.shape[0] // ways
    distinct = np.unique(lo & np.uint32(n_sets - 1)).size
    # each set is read once for each group of its items: once, plus once
    # more for every warp border inside its group
    assert stats["reads"] == distinct + stats["split"]
    if name == "all_dead":
        assert not matched.any()
    if name == "equal_counts":
        # a pure rotation tie: the first way at or after pref
        way_bits = max(1, (ways - 1).bit_length())
        pref = (hi.astype(np.int64) >> way_bits) & (ways - 1)
        assert np.array_equal(way[~matched], pref[~matched])
    if name == "tile_split":
        assert stats["split"] >= 3 and stats["reads"] > distinct
    if name == "dead_tag_first" and ways > 1:
        assert matched.any()


@pytest.mark.parametrize("ways", [1, 4, 32, 128, 256])
@pytest.mark.parametrize("b", [0, 1])
def test_set_major_model_tiny_batches(b, ways):
    rng = np.random.default_rng(b * 1000 + ways)
    t = random_rows(rng, 64 * ways)
    lo, hi = fps(rng.integers(0, 10, b))
    store_keys(rng, t, lo, hi, ways, share=1.0)
    got = set_major_model(t, lo, hi, NOW, ways, rng)
    assert_same(got[:3], plain(t, lo, hi, ways))
    assert got[3]["reads"] == b


def test_grouping_order_does_not_change_answers():
    """Two draws of the card's free orders group the items differently and
    give the same answers."""
    rng = np.random.default_rng(3)
    t, lo, hi = scenario("one_set_half", 128, rng)
    n_sets = t.shape[0] // 128
    o1 = group_by_set(lo, n_sets, np.random.default_rng(1))
    o2 = group_by_set(lo, n_sets, np.random.default_rng(2))
    assert not np.array_equal(o1, o2)
    for o in (o1, o2):
        s = lo[o] & np.uint32(n_sets - 1)
        assert np.count_nonzero(s[1:] != s[:-1]) + 1 == np.unique(s).size  # each set one group
        assert np.array_equal(np.sort(o), np.arange(lo.size))
    a = set_major_model(t, lo, hi, NOW, 128, np.random.default_rng(1))
    c = set_major_model(t, lo, hi, NOW, 128, np.random.default_rng(2))
    assert_same(a[:3], c[:3])


@pytest.mark.parametrize("name", ["mixed", "equal_counts", "window_ended", "dead_tag_first", "one_set_half", "tile_split"])
def test_set_major_model_matches_pallas_interpret(name):
    """At W = 128 against pallas_way_scan in interpret mode (768 items,
    three grid steps), counts below 2^31 where the Mosaic kernel compares
    them signed."""
    rng = np.random.default_rng(77 + SCENARIOS.index(name))
    ways = 128
    t, lo, hi = scenario(name, ways, rng, big_counts=False)
    lo, hi = np.resize(lo, 768), np.resize(hi, 768)
    n_sets = t.shape[0] // ways
    rows = t.reshape(n_sets, ways, 8)[lo & np.uint32(n_sets - 1)]
    planes = [jnp.asarray(rows[:, :, c]) for c in range(6)]
    w_way, w_match = pallas_way_scan(*planes, jnp.asarray(lo), jnp.asarray(hi), jnp.int32(NOW), interpret=True)
    way, matched, picked, _ = set_major_model(t, lo, hi, NOW, ways, rng)
    assert np.array_equal(way, np.asarray(w_way))
    assert np.array_equal(matched, np.asarray(w_match))
    assert np.array_equal(picked, rows[np.arange(lo.size), way])


@pytest.mark.parametrize("ways", [4, 32, 128, 256])
def test_set_major_model_matches_xla_twin_over_2_31(ways):
    """Where counts reach 2^31 the XLA twin (_choose_ways, counts compared
    unsigned) and not the Mosaic kernel is the reference."""
    rng = np.random.default_rng(500 + ways)
    t, lo, hi = scenario("counts_at_cap", ways, rng)
    t[:: 3, 2] = rng.integers(1 << 31, 1 << 32, t[:: 3].shape[0], dtype=np.uint64)
    assert (t[:, 2] >= 1 << 31).any()
    b = lo.size
    batch = J.SlabBatch(
        fp_lo=jnp.asarray(lo), fp_hi=jnp.asarray(hi), hits=jnp.ones(b, jnp.uint32),
        limit=jnp.ones(b, jnp.uint32), divider=jnp.ones(b, jnp.int32), jitter=jnp.zeros(b, jnp.int32),
    )
    chosen, _evict, j_match, j_picked = J._choose_ways(
        J.SlabState(table=jnp.asarray(t)), batch, jnp.int32(NOW), ways, use_pallas=False, multi_algo=False,
    )
    way, matched, picked, _ = set_major_model(t, lo, hi, NOW, ways, rng)
    assert np.array_equal(way, np.asarray(chosen) & (ways - 1))
    assert np.array_equal(matched, np.asarray(j_match))
    assert np.array_equal(picked, np.asarray(j_picked))
    assert_same((way, matched, picked), plain(t, lo, hi, ways))


@pytest.mark.parametrize(
    "b, n_sets, ways, form",
    [
        (1 << 20, 1 << 16, 128, "set_major"),  # the decided stream
        (1 << 16, 1 << 15, 128, "per_item"),  # the served bucket
        (1 << 18, 1 << 16, 128, "set_major"),  # 4 items a set
        (1 << 18, 1 << 17, 32, "per_item"),  # 2 items a set
        (1 << 20, 1 << 20, 4, "set_major"),  # a batch past 2^20, whatever its sets
        (1 << 16, 1 << 14, 256, "per_item"),  # 4 items a set, but a small batch
        (1 << 20, 1 << 14, 512, "per_item"),  # a set over the shared memory the kernel stages
        (0, 1, 1, "per_item"),
    ],
)
def test_way_scan_form_rule(b, n_sets, ways, form):
    assert K.way_scan_form(b, n_sets, ways) == form


@pytest.mark.parametrize("form", [None, "set_major", "per_item"])
def test_way_scan_forms_run_plain_on_cpu(form):
    """On CPU tensors every form is the plain version, and nothing counts
    as a launch."""
    rng = np.random.default_rng(9)
    t, lo, hi = scenario("mixed", 32, rng)
    K.reset_launch_counts()
    got = K.way_scan(as_t(t), as_t(lo), as_t(hi), NOW, 32, form=form)
    assert_same(tuple(x.numpy() for x in got[:2]) + (got[2].numpy().view(np.uint32),), plain(t, lo, hi, 32))
    assert K.LAUNCHES["way_scan"] == 0 and K.WAY_SCAN_FORMS == {"set_major": 0, "per_item": 0}
