"""The apply kernel's scan design, on the CPU: a numpy model of the chained
tile decomposition that csrc/slab_kernels.cu slab_apply_kernel runs (per
tile sums, a decoupled look-back for the sum prefix, the realized masked
max, a second look-back for the max prefix) against the port's plain
version (ops/slab_kernels.py slab_apply_plain) and the JAX package's XLA
twin (api_ratelimit_tpu/ops/slab.py _slab_update_sorted, whose
excl - seg_base is the in-batch prior). Also: why the two scans are
chained and not fused, and the sketch's segment weight. Integers
throughout: every comparison is bit-exact (tolerance 0)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from api_ratelimit_tpu.ops import slab as J  # noqa: E402
from api_ratelimit_tpu_torch.ops import slab as T  # noqa: E402
from api_ratelimit_tpu_torch.ops import slab_kernels as K  # noqa: E402

M32 = 0xFFFFFFFF
NOW = 1_000_000
WARP = 32  # the look-back reads 32 predecessors at a time
TILES = (1, 32, 1024, 4096)
SIZES = (1, 127, 4097, 65536 - 37)
PATTERNS = ("mixed", "one_segment", "zero_hits")


def look_back(aggregates, op, rng):
    """Exclusive tile prefixes as the kernel's look-back finds them: tile j
    reads its predecessors 32 at a time, nearest first, combining
    aggregates until it meets a tile that has published its inclusive
    prefix. Which predecessors have published one (and not only their
    aggregate) is drawn at random, often none of 32; tile 0 always has,
    and tiles before 0 read as an inclusive prefix of 0."""
    n = len(aggregates)
    published = (rng.random(n) < 0.03).tolist()
    inclusive = [0] * n
    exclusive = [0] * n
    for j in range(n):
        acc, window, done = 0, j - 1, False
        while not done:
            for lane in range(WARP):
                k = window - lane
                if k < 0 or k == 0 or published[k]:
                    acc = op(acc, inclusive[k] if k >= 0 else 0)
                    done = True
                    break
                acc = op(acc, aggregates[k])
            window -= WARP
        exclusive[j] = acc
        inclusive[j] = op(acc, aggregates[j])
    return np.array(exclusive, np.uint64)


def chained_tile_model(hits, seg_start, tile, rng):
    """(prior, weight) as uint32 by the kernel's decomposition: the sum
    scan first, then the max over each tile's realized excl, then the max
    look-back."""
    b = hits.size
    n = -(-b // tile)
    pad = n * tile - b
    h = np.concatenate([hits.astype(np.uint64), np.zeros(pad, np.uint64)]).reshape(n, tile)
    seg = np.concatenate([seg_start, np.zeros(pad, bool)]).reshape(n, tile)
    local_incl = np.cumsum(h, axis=1) & M32
    sum_prefix = look_back([int(x) for x in local_incl[:, -1]], lambda a, c: (a + c) & M32, rng)
    excl = (sum_prefix[:, None] + local_incl - h) & M32
    local_max = np.maximum.accumulate(np.where(seg, excl, 0), axis=1)
    max_prefix = look_back([int(x) for x in local_max[:, -1]], max, rng)
    prior = (excl - np.maximum(max_prefix[:, None], local_max)) & M32
    weight = (prior + h) & M32
    return prior.reshape(-1)[:b].astype(np.uint32), weight.reshape(-1)[:b].astype(np.uint32)


def fused_pair_scan(hits, seg_start, tile):
    """The design the kernel does not use: one (sum, max) pair per tile over
    the tile's local excl, combined as (S, M) + (s, m) = (S + s, max(M,
    S + m)). It assumes max(S + x) == S + max(x), which the uint32 wrap
    breaks. Returns the prior as uint32."""
    b = hits.size
    prior = np.empty(b, np.uint64)
    carry_sum, carry_max = 0, 0
    for t0 in range(0, b, tile):
        h = hits[t0 : t0 + tile].astype(np.uint64)
        incl = np.cumsum(h) & M32
        excl = (incl - h) & M32
        local_max = np.maximum.accumulate(np.where(seg_start[t0 : t0 + tile], excl, 0))
        seg_base = np.maximum(carry_max, (carry_sum + local_max) & M32)
        prior[t0 : t0 + tile] = (carry_sum + excl - seg_base) & M32
        carry_max = max(carry_max, (carry_sum + int(local_max[-1])) & M32)
        carry_sum = (carry_sum + int(incl[-1])) & M32
    return prior.astype(np.uint32)


def scan_batch(pattern, b, tile, rng):
    """(hits uint32, seg_start bool) of a slot-sorted batch. "mixed": hits
    from 1 up to 2^32 - 1, so the running sum wraps inside tiles, and on
    the first item of a few tiles, sized to wrap it there, across the edge;
    segments start on some tiles' first items, on others' last items,
    right after each wrap and at random. "one_segment": those hits, one
    segment spanning every tile. "zero_hits": no hits, random segments.
    Only zero_hits has padding (hits == 0), so the JAX twin keeps every
    batch in its order."""
    hits = rng.integers(1, 4, b, dtype=np.uint64)
    big = rng.random(b) < 0.05
    hits[big] = rng.integers(1 << 30, 1 << 32, int(big.sum()), dtype=np.uint64)
    edges = np.arange(tile, b, tile)
    for e in edges[::2][:4]:
        # the first item of this tile carries the running sum past 2^32
        s = int(hits[:e].sum()) & M32
        if s:
            hits[e] = (1 << 32) - s + int(rng.integers(0, min(s, 1000)))
    seg_start = rng.random(b) < 1 / 50
    seg_start[0] = True
    if pattern == "one_segment":
        seg_start[1:] = False
    elif pattern == "mixed":
        seg_start[edges[::3]] = True
        seg_start[edges[1::3] - 1] = True
        incl = np.cumsum(hits)
        wraps = np.flatnonzero((incl >> np.uint64(32)) != ((incl - hits) >> np.uint64(32)))
        seg_start[wraps[wraps + 1 < b] + 1] = True
    elif pattern == "zero_hits":
        hits[:] = 0
    else:
        raise ValueError(pattern)
    return hits.astype(np.uint32), seg_start


def plain_prior_weight(hits, seg_start):
    """slab_apply_plain's (before, weight) over dead stored rows, where
    base is 0 and before is the prior."""
    b = hits.size
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))  # noqa: E731
    keys = np.cumsum(seg_start).astype(np.uint32)
    out = K.slab_apply_plain(
        i32(keys), i32(np.full(b, 7, np.uint32)), i32(hits), i32(np.ones(b, np.uint32)),
        i32(np.zeros(b, np.uint32)), torch.from_numpy(seg_start), torch.zeros((b, 8), dtype=torch.int32),
        NOW, weight=True,
    )
    return out[0].numpy().view(np.uint32), out[-1].numpy().view(np.uint32)


@functools.cache
def _jax_update():
    return jax.jit(functools.partial(J._slab_update_sorted, ways=1, multi_algo=False))


def jax_prior_weight(hits, seg_start):
    """The JAX twin's (excl - seg_base, incl - seg_base): its
    _slab_update_sorted on a one-slot empty table, where base is 0, so
    s_before is the prior and s_after the weight. A key per segment and one
    fp_hi keep the twin's stable sort in batch order (checked)."""
    b = hits.size
    keys = np.cumsum(seg_start).astype(np.uint32)
    batch = J.SlabBatch(
        jnp.asarray(keys), jnp.full(b, 7, jnp.uint32), jnp.asarray(hits),
        jnp.zeros(b, jnp.uint32), jnp.ones(b, jnp.int32), jnp.zeros(b, jnp.int32),
    )
    out = _jax_update()(J.make_slab(1), batch, jnp.int32(NOW))
    assert np.array_equal(np.asarray(out[4]), np.arange(b))
    return np.asarray(out[1]), np.asarray(out[2])


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("b", SIZES)
@pytest.mark.parametrize("tile", TILES)
def test_chained_tile_model_matches_plain_and_jax(tile, b, pattern):
    """The kernel's decomposition at tile sizes 1 ... 4096 gives the plain
    version's prior and weight and the JAX twin's, bit for bit."""
    rng = np.random.default_rng(tile * 1_000_003 + b * 7 + PATTERNS.index(pattern))
    hits, seg_start = scan_batch(pattern, b, tile, rng)
    if pattern != "zero_hits" and b > tile:
        incl = np.cumsum(hits.astype(np.uint64)) >> np.uint64(32)
        assert incl[-1] >= 1, "the batch's sum does not wrap"
        edge = np.arange(tile, b, tile)
        assert (incl[edge] != incl[edge - 1]).any(), "no wrap across a tile edge"
    prior, weight = chained_tile_model(hits, seg_start, tile, rng)
    plain = plain_prior_weight(hits, seg_start)
    assert np.array_equal(prior, plain[0])
    assert np.array_equal(weight, plain[1])
    j_prior, j_weight = jax_prior_weight(hits, seg_start)
    assert np.array_equal(prior, j_prior)
    assert np.array_equal(weight, j_weight)


def test_fused_pair_operator_breaks_on_wrap():
    """Why the kernel chains its two scans: a fused (sum, max) operator
    agrees while the running sum stays below 2^32 and gives a different
    prior once it wraps. Tile 0's hits bring the sum to 2^32 - 10; tile 1
    starts segments at local excl 0 and 15, realized as 2^32 - 10 and 5,
    so the unsigned max keeps 2^32 - 10 where the fused form takes 5."""
    tile = 4
    hits = np.array([1 << 31, (1 << 31) - 10, 0, 0, 15, 1, 1, 1], np.uint32)
    seg_start = np.array([1, 0, 0, 0, 1, 1, 0, 0], bool)
    plain_prior = plain_prior_weight(hits, seg_start)[0]
    assert np.array_equal(chained_tile_model(hits, seg_start, tile, np.random.default_rng(0))[0], plain_prior)
    fused = fused_pair_scan(hits, seg_start, tile)
    assert not np.array_equal(fused, plain_prior)
    assert int(plain_prior[5]) == 15 and int(fused[5]) == 0
    small = np.array([3, 4, 0, 0, 15, 1, 1, 1], np.uint32)
    assert np.array_equal(fused_pair_scan(small, seg_start, tile), plain_prior_weight(small, seg_start)[0])


@pytest.mark.parametrize("pattern", PATTERNS)
def test_apply_weight_is_segment_weight(pattern):
    """slab_apply's weight plane (the plain version here, the kernel on the
    card) is the sketch's segment weight: _segment_weights, and the JAX
    twin's incl - seg_base."""
    rng = np.random.default_rng(77 + PATTERNS.index(pattern))
    hits, seg_start = scan_batch(pattern, 4097, 512, rng)
    _, weight = plain_prior_weight(hits, seg_start)
    seg_w = T._segment_weights(torch.from_numpy(hits.view(np.int32)), torch.from_numpy(seg_start))
    assert np.array_equal(weight, seg_w.numpy().view(np.uint32))
    assert np.array_equal(weight, jax_prior_weight(hits, seg_start)[1])


def test_apply_weight_on_cpu_runs_the_plain_version():
    """On CPU tensors slab_apply(weight=True) returns the plain version's
    planes, the weight last, in every form, and counts no launch."""
    rng = np.random.default_rng(5)
    b = 300
    hits, seg_start = scan_batch("mixed", b, 32, rng)
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))  # noqa: E731
    keys = i32(np.cumsum(seg_start).astype(np.uint32))
    ops = (keys, keys, i32(hits), i32(np.full(b, 60, np.uint32)), i32(np.zeros(b, np.uint32)),
           torch.from_numpy(seg_start), torch.zeros((b, 8), dtype=torch.int32))
    limit = i32(rng.integers(0, 1 << 32, b, dtype=np.uint64).astype(np.uint32))
    K.reset_launch_counts()
    for kw, n in (({}, 5), ({"decide": True, "s_limit": limit}, 11), ({"decide": True, "lean": True, "s_limit": limit}, 6)):
        got = K.slab_apply(*ops, NOW, weight=True, **kw)
        want = K.slab_apply_plain(*ops, NOW, weight=True, **kw)
        assert len(got) == n
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert torch.equal(got[-1], T._segment_weights(ops[2], ops[5]))
    assert not any(K.LAUNCHES.values())
