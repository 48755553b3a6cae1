"""The port's sibling algorithms (sliding window, GCRA, concurrency and its
Release) on the CPU, against the JAX package: the multi-algorithm way scan
(_scan_ways, the sliding grace), the multi-algorithm step (slab_step_packed,
slab_step_after, slab_step_decided with use_pallas=False, multi_algo=True:
the XLA twin) and SetSlabOracle, the engine's sticky guard, the cache's
Release and per-algorithm counters, the service stories of
tests/test_algorithms.py and POST /release, and Release through both
windowed arms. Integers throughout, so every comparison is bit-exact
(tolerance 0).

Waiting on later slices of the port: the journey tag algo_gcra of
test_algorithms.py's test_algo_stats_and_journey_tag (tracing, ROADMAP A item
4b; its counters are checked here), the lease stories (item 8), the snapshot
round trips (item 7; the guard's flip on an imported table is checked here
through the engine's import_tables) and the settings env vars (item 4a; the
same validation is held on the loader's TTL and the cache's burst ratio)."""

import http.client
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from api_ratelimit_tpu.backends.tpu import TpuRateLimitCache  # noqa: E402
from api_ratelimit_tpu.limiter import BaseRateLimiter as JBase  # noqa: E402
from api_ratelimit_tpu.models import Descriptor as JDescriptor  # noqa: E402
from api_ratelimit_tpu.models import RateLimitRequest as JRequest  # noqa: E402
from api_ratelimit_tpu.ops import slab as J  # noqa: E402
from api_ratelimit_tpu.testing import oracle as JO  # noqa: E402
from api_ratelimit_tpu.utils import FakeTimeSource as JFake  # noqa: E402
from api_ratelimit_tpu_torch.backends.cuda import (  # noqa: E402
    CudaRateLimitCache,
    SlabDeviceEngine,
    validate_gcra_burst_ratio,
)
from api_ratelimit_tpu_torch.config import ConfigFile, load_config  # noqa: E402
from api_ratelimit_tpu_torch.config.loader import validate_concurrency_ttl  # noqa: E402
from api_ratelimit_tpu_torch.limiter import BaseRateLimiter, LocalCache  # noqa: E402
from api_ratelimit_tpu_torch.models import Code, Descriptor, RateLimitRequest  # noqa: E402
from api_ratelimit_tpu_torch.models.config import (  # noqa: E402
    ALGO_ID_CONCURRENCY,
    ALGO_ID_GCRA,
    ALGO_ID_SLIDING_WINDOW,
    ALGORITHM_IDS,
    ConfigError,
)
from api_ratelimit_tpu_torch.ops import slab as T  # noqa: E402
from api_ratelimit_tpu_torch.ops import slab_kernels as K  # noqa: E402
from api_ratelimit_tpu_torch.server.http_server import HttpServer  # noqa: E402
from api_ratelimit_tpu_torch.service import RateLimitService  # noqa: E402
from api_ratelimit_tpu_torch.stats import Store  # noqa: E402
from api_ratelimit_tpu_torch.testing import oracle as TO  # noqa: E402
from api_ratelimit_tpu_torch.utils import FakeTimeSource  # noqa: E402

M32 = 0xFFFFFFFF
SLIDE, GCRA, CONC, REL = (
    T.ALGO_SLIDING_WINDOW, T.ALGO_GCRA, T.ALGO_CONCURRENCY, T.ALGO_CONC_RELEASE,
)
BURST = 1.5

_j_scan = jax.jit(J._choose_ways, static_argnames=("ways", "use_pallas", "interpret", "multi_algo"))


def u32(t) -> np.ndarray:
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return np.ascontiguousarray(a).view(np.uint32)


def i32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def fmix32(x: int) -> int:
    x &= M32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


def fp(key_id: int) -> tuple[int, int]:
    """tests/test_slab_fuzz.py's fingerprints: fp_lo mixed, fp_hi's top 16
    bits the unique key id (the oracle's winner rule is then exact), its
    low bits mixed (the way rotation)."""
    return fmix32(key_id), (((key_id + 1) & 0xFFFF) << 16) | (fmix32(key_id ^ 0xA5A5) & 0xFFFF)


def rule(key_id: int):
    """One stable rule a key: the algorithm by id mod 4, as the reference's
    mixed-algorithm fuzz draws them."""
    algo = (T.ALGO_FIXED_WINDOW, SLIDE, GCRA, CONC)[key_id % 4]
    return algo, 2 + key_id % 7, (5, 30, 60)[key_id % 3], key_id % 5


def item(key_id: int, hits: int, release: bool = False):
    algo, limit, div, jit = rule(key_id)
    if release and algo == CONC:
        algo = REL
    return (*fp(key_id), hits, limit, div | (algo << T.ALGO_SHIFT), jit)


def pack(items, now: int, pad_to: int, burst: float = BURST) -> np.ndarray:
    p = np.zeros((7, pad_to), np.uint32)
    for i, it in enumerate(items):
        p[:6, i] = [v & M32 for v in it]
    scalars = (now & M32, np.float32(0.8).view(np.uint32), np.float32(burst).view(np.uint32))
    p[6, :3] = scalars[: min(3, pad_to)]
    return p


def algo_table(rng, n_slots: int, ways: int, now: int, keys) -> np.ndarray:
    """A full table of every algorithm's rows (half of `keys` stored in their
    own set), live and dead, in and out of window, sliding rows inside their
    grace window, GCRA rows with TATs ahead and drained, concurrency rows."""
    t = np.zeros((n_slots, 8), np.uint32)
    algo = rng.integers(0, 4, n_slots)
    div = rng.choice(np.array([5, 30, 60], np.int64), n_slots)
    t[:, 0] = rng.integers(0, 1 << 32, n_slots, dtype=np.uint64)
    t[:, 1] = rng.integers(0, 1 << 16, n_slots, dtype=np.uint64) | (0xFFFF << 16)
    t[:, 2] = rng.integers(0, 9, n_slots)
    t[:, 3] = (now // div) * div - div * rng.integers(0, 3, n_slots)
    t[:, 4] = now + rng.integers(-20, 120, n_slots)
    t[:, 5] = div | (algo << T.ALGO_SHIFT)
    t[:, 6] = np.where(algo == SLIDE, rng.integers(0, 9, n_slots), 0)
    gcra = algo == GCRA
    tat = now + rng.integers(-30, 90, n_slots)
    t[gcra, 6] = tat[gcra]
    t[gcra, 7] = rng.integers(0, 1000, n_slots)[gcra]
    t[gcra, 3] = (tat - div)[gcra]
    t[rng.random(n_slots) < 0.1, 4] = 0
    n_sets = n_slots // ways
    for k in keys[: len(keys) // 2]:
        lo, hi = fp(int(k))
        a, limit, d, _jit = rule(int(k))
        slot = (lo & (n_sets - 1)) * ways + int(rng.integers(0, ways))
        t[slot, 0], t[slot, 1] = lo, hi
        t[slot, 5] = d | (a << T.ALGO_SHIFT)
    return t


class Harness:
    """The JAX XLA twin, the port and the port's oracle (with the
    reference's oracle beside it) in lockstep from one table; every step
    compares the packed block's nine rows and the health vector with the
    JAX step and the per-item before/after/code and health with both
    oracles. tables() compares the three tables, columns 6-7 included."""

    def __init__(self, table: np.ndarray, ways: int, pad_to: int, burst: float = BURST):
        self.j = J.slab_import_rows(table)
        self.t = T.slab_import_rows(table, device="cpu")
        self.o = TO.SetSlabOracle(table.shape[0], ways, burst_ratio=burst)
        self.jo = JO.SetSlabOracle(table.shape[0], ways, burst_ratio=burst)
        self.o.table = table.astype(np.uint64)
        self.jo.table = table.astype(np.uint64)
        self.ways = J.validate_ways(table.shape[0], ways)
        self.pad_to = pad_to
        self.burst = burst
        self.per_algo = [0] * 4

    def step(self, items, now: int, label=""):
        p = pack(items, now, self.pad_to, self.burst)
        self.j, j_out, j_health = J.slab_step_packed(
            self.j, jnp.asarray(p), ways=self.ways, use_pallas=False, multi_algo=True
        )
        t_out, t_health = T.slab_step_packed(self.t, p, ways=self.ways, multi_algo=True)
        t_out = u32(t_out.view(torch.int32))
        assert np.array_equal(t_out, np.asarray(j_out)), label
        assert np.array_equal(t_health.numpy(), np.asarray(j_health).astype(np.int64)), label
        order = t_out[T.OUT_ORDER].astype(np.int64)
        got = {}
        for name, row in (("before", T.OUT_BEFORE), ("after", T.OUT_AFTER), ("code", T.OUT_CODE)):
            arr = np.empty(self.pad_to, np.uint32)
            arr[order] = t_out[row]
            got[name] = arr[: len(items)].tolist()
        want = self.o.step_batch(items, now)
        assert want == self.jo.step_batch(items, now), label
        w_before, w_after, w_codes, w_delta = want
        live = [i for i, it in enumerate(items) if it[2] > 0]
        assert [got["before"][i] for i in live] == [w_before[i] for i in live], label
        assert [got["after"][i] for i in live] == [w_after[i] for i in live], label
        assert [got["code"][i] for i in live] == [w_codes[i] for i in live], label
        assert t_health.tolist() == w_delta, label
        for it in items:  # a release counts as a concurrency decision
            self.per_algo[min((it[4] >> T.ALGO_SHIFT) & 7, CONC)] += 1
        return got

    def tables(self, label=""):
        port = T.slab_export_copy(self.t)
        assert np.array_equal(port, np.asarray(self.j.table)), label
        assert np.array_equal(port.astype(np.uint64), self.o.table), label


# --- the scan: the sliding grace -------------------------------------------


def grace_table(rng, n_slots: int, ways: int, now: int):
    """Sets that hold both sliding and fixed rows: in every set one sliding
    row with window + div <= now < window + 2 div (its grace window) and a
    live fixed row of lower count in its current window, the rest live,
    in window and fuller, so the fixed scan evicts the sliding row (window
    ended) and the multi-algorithm scan the fixed one (the lowest live
    count). Returns (table, fp_lo, fp_hi) with misses into every set and
    some hits."""
    keys = np.arange(200_000, 200_000 + n_slots)
    t = algo_table(rng, n_slots, ways, now, keys)
    n_sets = n_slots // ways
    div = 60
    for s in range(n_sets):
        a, b = s * ways + int(rng.integers(0, ways)), None
        while b is None or b == a:
            b = s * ways + int(rng.integers(0, ways))
        win = (now // div) * div - div  # ended one window ago
        t[a] = (*fp(int(rng.integers(1 << 20, 1 << 21))), 9, win, now + 50, div | (SLIDE << T.ALGO_SHIFT), 4, 0)
        t[b] = (*fp(int(rng.integers(1 << 21, 1 << 22))), 3, win + div, now + 50, div, 0, 0)
        for w in range(ways):  # every other way live, in window and fuller
            r = s * ways + w
            if r not in (a, b):
                t[r] = (*fp(int(rng.integers(1 << 22, 1 << 23))), 50, (now // div) * div, now + 50, div, 0, 0)
    lo = np.array([s for s in range(n_sets)] * 3, np.int64)
    q = [fp(int(k)) for k in rng.integers(1 << 23, 1 << 24, lo.size)]
    q_lo = np.array([(x[0] & ~(n_sets - 1)) | int(s) for x, s in zip(q, lo)], np.uint32)
    q_hi = np.array([x[1] for x in q], np.uint32)
    hit = rng.choice(n_slots, 32, replace=False)
    q_lo = np.concatenate([q_lo, t[hit, 0]])
    q_hi = np.concatenate([q_hi, t[hit, 1]])
    return t, q_lo, q_hi


@pytest.mark.parametrize("ways", [4, 128])
@pytest.mark.parametrize("multi", [False, True])
def test_scan_sliding_grace_matches_xla_twin(ways, multi):
    """The port's way scan (plain version) and eviction class against the
    reference's _choose_ways in both instantiations, on sets that mix a
    sliding row in its grace window with a fixed row of lower count whose
    window ended: the tier is each stored row's own."""
    rng = np.random.default_rng(ways + 7 * multi)
    now = 1_000_020
    t, lo, hi = grace_table(rng, 64 * ways, ways, now)
    b = lo.size
    hits = np.ones(b, np.uint32)
    st = T.slab_import_rows(t, device="cpu")
    chosen, evict, matched, picked = T._choose_ways(st, i32(lo), i32(hi), i32(hits), now, ways, multi_algo=multi)
    batch = J.SlabBatch(
        fp_lo=jnp.asarray(lo), fp_hi=jnp.asarray(hi), hits=jnp.asarray(hits),
        limit=jnp.ones(b, jnp.uint32), divider=jnp.ones(b, jnp.int32), jitter=jnp.zeros(b, jnp.int32),
    )
    j_chosen, j_evict, j_matched, j_picked = _j_scan(J.SlabState(jnp.asarray(t)), batch, jnp.int32(now), ways=ways, multi_algo=multi)
    assert np.array_equal(chosen.numpy(), np.asarray(j_chosen))
    assert np.array_equal(evict.numpy(), np.asarray(j_evict))
    assert np.array_equal(matched.numpy(), np.asarray(j_matched))
    assert np.array_equal(u32(picked), np.asarray(j_picked))
    # the grace decides: misses evict the sliding row under the fixed scan
    # and the fixed row under the multi-algorithm scan
    miss = ~matched.numpy()
    algo_of = (u32(picked)[:, T.COL_DIVIDER] >> T.ALGO_SHIFT) & 7
    assert miss.sum() >= 64 * 3
    assert (algo_of[miss] == (0 if multi else SLIDE)).all()
    assert (u32(picked)[miss, T.COL_COUNT] == (3 if multi else 9)).all()
    assert (evict.numpy()[miss] == (T.EVICT_LIVE if multi else T.EVICT_WINDOW)).all()


def test_scan_multi_plain_matches_oracle_and_routing_counts():
    """way_scan(multi_algo=True) on CPU tensors is the plain version (no
    launch counted in either dict), and agrees with the port's oracle's
    vectorized scan on the chosen slot and the eviction class."""
    rng = np.random.default_rng(3)
    now = 1_000_020
    t, lo, hi = grace_table(rng, 256, 4, now)
    K.reset_launch_counts()
    for form in (None, *K.WAY_SCAN_FORM_NAMES):
        way, matched, picked = K.way_scan(i32(t), i32(lo), i32(hi), now, 4, form=form, multi_algo=True)
        want = K.way_scan_plain(i32(t), i32(lo), i32(hi), now, 4, multi_algo=True)
        assert all(torch.equal(a, b) for a, b in zip((way, matched, picked), want))
    assert K.LAUNCHES["way_scan"] == 0
    assert K.WAY_SCAN_FORMS == K.WAY_SCAN_MULTI_FORMS == {"set_major": 0, "per_item": 0}
    o = TO.SetSlabOracle(256, 4)
    o.table = t.astype(np.uint64)
    st = T.slab_import_rows(t, device="cpu")
    chosen, evict, matched, _picked = T._choose_ways(
        st, i32(lo), i32(hi), i32(np.ones(lo.size, np.uint32)), now, 4, multi_algo=True
    )
    got = list(zip(chosen.tolist(), matched.tolist(), evict.tolist()))
    assert got == o._choose_many(lo.tolist(), hi.tolist(), now)
    jo = JO.SetSlabOracle(256, 4)
    jo.table = o.table
    assert got == [jo._choose(int(a), int(b), now) for a, b in zip(lo, hi)]


# --- the step: a differential fuzz of all four algorithms and Release -------


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_mixed_algorithms_past_capacity(seed):
    """All four algorithms and release rows interleaved in every launch, 40
    keys over a 32-row table (past 100% occupancy), from one table of every
    algorithm's rows imported on all sides: per item, health and the final
    table (columns 6-7 included) against the XLA twin and both oracles."""
    rng = np.random.default_rng(40_000 + seed)
    now = 700_000
    h = Harness(algo_table(rng, 32, 4, now, np.arange(40)), 4, 32)
    for batch_no in range(40):
        now += int(rng.integers(0, 40))
        items = [
            item(int(rng.integers(0, 40)), int(rng.integers(1, 4)), bool(rng.integers(0, 3) == 0))
            for _ in range(int(rng.integers(1, 33)))
        ]
        h.step(items, now, label=(seed, batch_no))
        if batch_no % 10 == 9:
            h.tables(label=(seed, batch_no))
    assert all(n >= 100 for n in h.per_algo)


@pytest.mark.parametrize("algo", [T.ALGO_FIXED_WINDOW, SLIDE, GCRA, CONC])
def test_fuzz_per_algorithm_depth(algo):
    """>= 10k decisions of each algorithm, duplicate-heavy (12 keys of the
    algorithm and 4 of each other over a 16-row table, so every launch
    serializes segments and contends for ways): the GCRA admit prefix,
    concurrency's acquire/release order and the sliding carry."""
    rng = np.random.default_rng(50_000 + algo)
    now = 800_000
    pool = [algo + 4 * k for k in range(12)] + [a + 4 * (100 + k) for a in range(4) if a != algo for k in range(4)]
    h = Harness(algo_table(rng, 16, 4, now, np.array(pool)), 4, 128)
    done = 0
    batch_no = 0
    while done < 10_000:
        now += int(rng.integers(0, 25))
        keys = rng.choice(pool[:12], int(rng.integers(64, 113)))
        keys = np.concatenate([keys, rng.choice(pool[12:], 16)])
        items = [item(int(k), int(rng.integers(1, 4)), bool(rng.integers(0, 3) == 0)) for k in keys]
        h.step(items, now, label=(algo, batch_no))
        done += int(sum(1 for k in keys if k % 4 == algo))
        batch_no += 1
    h.tables(label=algo)
    assert done >= 10_000


def test_fuzz_at_w128_with_gcra_burst_and_releases_only():
    """W = 128 (the card's ways) at 1.5x occupancy, and launches made of
    release rows alone: a release of a key with no row inserts its
    zero-count row, classified and counted as the reference does."""
    rng = np.random.default_rng(77)
    now = 900_000
    h = Harness(algo_table(rng, 256, 128, now, np.arange(384)), 128, 256)
    for batch_no in range(12):
        now += int(rng.integers(0, 30))
        if batch_no % 4 == 3:
            keys = [3 + 4 * int(k) for k in rng.integers(0, 96, 64)]
            items = [item(k, int(rng.integers(1, 3)), True) for k in keys]
        else:
            items = [item(int(rng.integers(0, 384)), int(rng.integers(1, 4)), bool(rng.integers(0, 3) == 0)) for _ in range(256)]
        h.step(items, now, label=batch_no)
    h.tables()


def test_algorithm_change_resets_and_counts():
    """A rule's algorithm changed between launches (a hot reload): the
    fingerprint matches, the state resets and the reset is counted, both
    ways, on both sides."""
    h = Harness(np.zeros((8, 8), np.uint32), 4, 8)
    now = 700_000
    lo, hi = fp(7)
    fixed = (lo, hi, 1, 10, 60, 0)
    gcra = (lo, hi, 1, 10, 60 | (GCRA << T.ALGO_SHIFT), 0)
    for _ in range(5):
        h.step([fixed], now)
    assert h.step([gcra], now)["after"] == [1]
    assert h.o.health[T.HEALTH_ALGO_RESETS] == 1
    got = h.step([fixed], now)
    assert got["before"] == [0] and got["after"] == [1]
    assert h.o.health[T.HEALTH_ALGO_RESETS] == 2
    h.tables()


@pytest.mark.parametrize("windows_left", [1, 2, 3])
def test_now_within_three_windows_of_2_31(windows_left):
    """`now` a few windows short of 2^31: expire_at, the sliding expiry and
    GCRA's TAT pass 2^31 and wrap in int32, as the reference's do; the port
    must wrap them the same way (against the XLA twin; the host oracle
    computes with unbounded integers there)."""
    rng = np.random.default_rng(windows_left)
    now = (1 << 31) - 60 * windows_left + int(rng.integers(0, 30))
    table = np.zeros((64, 8), np.uint32)
    j, t = J.slab_import_rows(table), T.slab_import_rows(table, device="cpu")
    for step in range(8):
        items = [item(int(k), int(rng.integers(1, 4)), bool(rng.integers(0, 3) == 0)) for k in rng.integers(0, 24, 48)]
        p = pack(items, now, 64)
        j, j_out, j_h = J.slab_step_packed(j, jnp.asarray(p), ways=4, use_pallas=False, multi_algo=True)
        t_out, t_h = T.slab_step_packed(t, p, ways=4, multi_algo=True)
        assert np.array_equal(u32(t_out.view(torch.int32)), np.asarray(j_out)), step
        assert np.array_equal(t_h.numpy(), np.asarray(j_h)), step
        now += int(rng.integers(0, 40))
    port = T.slab_export_copy(t)
    assert np.array_equal(port, np.asarray(j.table))
    assert (port[:, T.COL_EXPIRE] >= (1 << 31)).any()  # some expiry wrapped


@pytest.mark.parametrize("algo", [SLIDE, GCRA, CONC])
def test_segment_prefix_wraps(algo):
    """Hits up to 2^31 in long segments of one algorithm, so the batch's
    uint32 prefix sums (and the acquire and release sums) wrap inside a
    segment: the running maxima run over the wrapped values, as the
    reference's do."""
    rng = np.random.default_rng(algo)
    now = 1_000_000
    keys = np.repeat(rng.choice(np.arange(algo, 400, 4), 6, replace=False), 40)
    rng.shuffle(keys)
    items = []
    for k in keys:
        lo, hi, _h, limit, div, jit = item(int(k), 1, bool(rng.integers(0, 3) == 0))
        hits = int(rng.integers(1 << 30, 1 << 31)) if rng.random() < 0.5 else int(rng.integers(1, 4))
        items.append((lo, hi, hits, int(rng.choice([limit, 1 << 31, M32 - 5])), div, jit))
    p = pack(items, now, 256)
    assert p[T.ROW_HITS].astype(np.uint64).sum() > (1 << 33)
    table = algo_table(rng, 64, 4, now, keys)
    j, t = J.slab_import_rows(table), T.slab_import_rows(table, device="cpu")
    for step in range(3):
        j, j_out, j_h = J.slab_step_packed(j, jnp.asarray(p), ways=4, use_pallas=False, multi_algo=True)
        t_out, t_h = T.slab_step_packed(t, p, ways=4, multi_algo=True)
        assert np.array_equal(u32(t_out.view(torch.int32)), np.asarray(j_out)), step
        assert np.array_equal(t_h.numpy(), np.asarray(j_h)), step
        p[6, 0] += 7
    assert np.array_equal(T.slab_export_copy(t), np.asarray(j.table))


def test_gcra_tau_saturates_as_xla_converts():
    """div x burst ratio past 2^31 ms (a 10^6 s window at ratio 16): tau's
    float-to-int32 convert saturates in XLA, and in the port."""
    table = np.zeros((16, 8), np.uint32)
    j, t = J.slab_import_rows(table), T.slab_import_rows(table, device="cpu")
    div = 1_000_000 | (GCRA << T.ALGO_SHIFT)
    items = [(*fp(k), 1 + k % 3, 1 + k, div, 0) for k in range(12)] * 3
    for burst in (16.0, 15.999, 2.25):
        p = pack(items, 1_500_000_000, 64, burst)
        j, j_out, _ = J.slab_step_packed(j, jnp.asarray(p), ways=4, use_pallas=False, multi_algo=True)
        t_out, _ = T.slab_step_packed(t, p, ways=4, multi_algo=True)
        assert np.array_equal(u32(t_out.view(torch.int32)), np.asarray(j_out)), burst
    assert np.array_equal(T.slab_export_copy(t), np.asarray(j.table))


@pytest.mark.parametrize("b", [1, 2, 3])
def test_burst_slot_clamps_like_the_reference(b):
    """The burst ratio's scalar slot [6, 2] at batches of 1-3 items: the
    reference's static index clamps to the last column."""
    p = pack([item(2, 1)] * b, 1_000_000, b)
    assert T._unpack(p, "cpu")[3] == float(np.asarray(J._unpack(jnp.asarray(p))[3]))


def test_after_and_decided_steps_match_xla_twin():
    """slab_step_after and slab_step_decided with multi_algo=True against
    the reference's, over a mixed stream; slab_update_and_decide's decision
    equals the packed step's rows."""
    rng = np.random.default_rng(11)
    now = 2_000_000
    table = algo_table(rng, 64, 4, now, np.arange(80))
    ja, jd = J.slab_import_rows(table), J.slab_import_rows(table)
    ta, td, tu = (T.slab_import_rows(table, device="cpu") for _ in range(3))
    for step in range(10):
        now += int(rng.integers(0, 30))
        items = [item(int(k), int(rng.integers(1, 4)), bool(rng.integers(0, 3) == 0)) for k in rng.integers(0, 80, 100)]
        p = pack(items, now, 128)
        ja, j_after, j_h = J.slab_step_after(ja, jnp.asarray(p), ways=4, use_pallas=False, multi_algo=True)
        t_after, t_h = T.slab_step_after(ta, p, ways=4, multi_algo=True)
        assert np.array_equal(u32(t_after.view(torch.int32)), np.asarray(j_after)) and t_h.tolist() == np.asarray(j_h).tolist()
        jd, j_codes, j_hd = J.slab_step_decided(jd, jnp.asarray(p), ways=4, use_pallas=False, multi_algo=True)
        t_codes, t_hd = T.slab_step_decided(td, p, ways=4, multi_algo=True)
        assert np.array_equal(t_codes.numpy(), np.asarray(j_codes)) and t_hd.tolist() == np.asarray(j_hd).tolist()
        res = T.slab_update_and_decide(tu, p, ways=4, multi_algo=True)
        assert np.array_equal(res.after.numpy(), t_after.view(torch.int32).numpy())
        assert np.array_equal(res.decision.code.numpy().astype(np.uint8), t_codes.numpy())
    for st in (ta, td, tu):
        assert np.array_equal(T.slab_export_copy(st), np.asarray(ja.table))
    assert np.array_equal(np.asarray(jd.table), np.asarray(ja.table))


@pytest.mark.parametrize("entry", ["slab_step_after", "slab_step_packed", "slab_step_decided", "slab_update_and_decide"])
def test_all_fixed_stream_same_bytes_either_body(entry):
    """The rollback invariant: an all-fixed stream leaves the same outputs,
    health and slab bytes with multi_algo on and off (columns 6-7 stay 0)."""
    rng = np.random.default_rng(21)
    now = 3_000_000
    keys = np.arange(0, 200, 4)  # key id mod 4 == 0: fixed window
    table = algo_table(rng, 64, 4, now, keys)
    table[:, 5] &= T.ALGO_DIV_MASK
    table[:, 6:] = 0
    off, on = (T.slab_import_rows(table, device="cpu") for _ in range(2))
    for step in range(8):
        now += int(rng.integers(0, 40))
        items = [item(int(k), int(rng.integers(1, 4))) for k in rng.choice(keys, 96)]
        p = pack(items, now, 128)
        a = getattr(T, entry)(off, p, ways=4)
        b = getattr(T, entry)(on, p, ways=4, multi_algo=True)
        flat = lambda r: [x.view(torch.int32) if x.dtype == torch.uint32 else x for x in ((r.before, r.after, *r.decision, r.health) if isinstance(r, T.SlabResult) else r)]  # noqa: E731
        assert all(torch.equal(x, y) for x, y in zip(flat(a), flat(b))), (entry, step)
    assert np.array_equal(T.slab_export_copy(off), T.slab_export_copy(on))
    assert not T.slab_export_copy(on)[:, 6:].any()


def test_fixed_body_refuses_algorithm_bits_and_multi_takes_them():
    rng = np.random.default_rng(8)
    st = T.make_slab(64, device="cpu")
    p = pack([item(int(k), 1) for k in rng.integers(0, 40, 32)], 1_000_000, 32)
    for entry in ("slab_step_packed", "slab_step_decided", "slab_update_and_decide"):
        with pytest.raises(ValueError, match="algorithm bits"):
            getattr(T, entry)(st, p, ways=4)
        getattr(T, entry)(st, p, ways=4, multi_algo=True)


# --- the engine: the sticky guard, the burst ratio, import ------------------


def _engine(ts, **kw):
    return SlabDeviceEngine(ts, n_slots=256, ways=4, buckets=(64, 128), device="cpu", **kw)


def _rows(items) -> np.ndarray:
    return np.array(items, np.uint32).T.copy()


def test_guard_flips_on_first_non_fixed_row_and_stays():
    ts = FakeTimeSource(1_000_000)
    eng = _engine(ts, precompile=True)  # warmers never flip it
    assert eng.precompiled and not eng.algos_seen
    fixed = [item(4 * k, 1) for k in range(10)]
    for _ in range(3):
        eng.submit_rows(_rows(fixed))
    assert not eng.algos_seen
    table = eng.export_tables()[0]
    assert not table[:, 6:].any() and not (table[:, 5] >> T.ALGO_SHIFT).any()
    eng.submit_rows(_rows(fixed + [item(2, 1)]))
    assert eng.algos_seen
    eng.submit_rows(_rows(fixed))  # sticky: the multi body from here on
    assert eng.algos_seen


def test_guard_flips_on_imported_algorithm_rows():
    ts = FakeTimeSource(1_000_000)
    eng = _engine(ts)
    table = np.zeros((256, 8), np.uint32)
    table[0] = (1, 2, 3, 999_970, 1_000_050, 60, 0, 0)
    eng.import_tables([table])
    assert not eng.algos_seen
    table[1] = (1, 2, 3, 999_970, 1_000_050, 60 | (GCRA << T.ALGO_SHIFT), 1_000_030, 0)
    eng.import_tables([table])
    assert eng.algos_seen
    assert np.array_equal(eng.export_tables()[0], table)
    with pytest.raises(ValueError):
        eng.import_tables([table[:128]])


def test_engine_matches_reference_engine_over_a_mixed_stream():
    """The port's engine (guard, burst slot, multi body) against the
    reference's TpuRateLimitCache engine (use_pallas=False) over one clock:
    afters, health and tables."""
    from api_ratelimit_tpu.backends.tpu import SlabDeviceEngine as JEngine

    jts, ts = JFake(1_000_000), FakeTimeSource(1_000_000)
    jeng = JEngine(jts, n_slots=256, ways=4, buckets=(64, 128), use_pallas=False, gcra_burst_ratio=BURST)
    eng = _engine(ts, gcra_burst_ratio=BURST)
    rng = np.random.default_rng(13)
    for step in range(30):
        adv = int(rng.integers(0, 20))
        jts.advance(adv)
        ts.advance(adv)
        keys = rng.integers(0, 120, int(rng.integers(1, 100)))
        if step < 5:
            keys = keys[keys % 4 == 0]  # fixed only: the guard holds
        if not keys.size:
            continue
        block = _rows([item(int(k), int(rng.integers(1, 4)), bool(rng.integers(0, 3) == 0)) for k in keys])
        assert np.array_equal(eng.submit_rows(block), jeng.submit_rows(block)), step
        assert eng.algos_seen == jeng._algos_seen, step
    assert np.array_equal(eng.export_tables()[0], jeng.export_tables()[0])
    h, jh = eng.health_snapshot(), jeng.health_snapshot()
    assert all(h[k] == jh[k] for k in h)
    jeng.close()


def test_burst_ratio_and_ttl_validation():
    assert validate_gcra_burst_ratio(1) == 1.0 and validate_gcra_burst_ratio(16) == 16.0
    for junk in (0.0, -1.0, 17.0):
        with pytest.raises(ValueError, match="GCRA_BURST_RATIO"):
            validate_gcra_burst_ratio(junk)
        with pytest.raises(ValueError, match="GCRA_BURST_RATIO"):
            _engine(FakeTimeSource(0), gcra_burst_ratio=junk)
    assert validate_concurrency_ttl(60) == 60
    for junk in (0, -5, 1 << 28):
        with pytest.raises(ValueError, match="CONCURRENCY_TTL_S"):
            validate_concurrency_ttl(junk)
        with pytest.raises(ValueError, match="CONCURRENCY_TTL_S"):
            load(ALGO_YAML, concurrency_ttl_s=junk)


# --- config, cache and service: tests/test_algorithms.py's stories ---------

ALGO_YAML = """
domain: algo
descriptors:
  - key: fixed
    rate_limit: {unit: minute, requests_per_unit: 5}
  - key: slide
    rate_limit: {unit: minute, requests_per_unit: 6, algorithm: sliding_window}
  - key: bucket
    rate_limit: {unit: minute, requests_per_unit: 4, algorithm: gcra}
  - key: bucket2
    rate_limit: {unit: minute, requests_per_unit: 2, algorithm: gcra}
  - key: conns
    rate_limit: {requests_per_unit: 3, algorithm: concurrency}
"""


def req(*pairs, domain="algo", hits=1):
    return RateLimitRequest(domain=domain, descriptors=tuple(Descriptor.of(p) for p in pairs), hits_addend=hits)


def load(yaml_text, name="config.algo", **kw):
    pytest.importorskip("yaml")
    return load_config([ConfigFile(name=name, contents=yaml_text)], Store().scope("rate_limit"), **kw)


class FakeRuntime:
    def __init__(self, files: dict):
        self.files = dict(files)
        self._callbacks = []

    def snapshot(self):
        outer = self

        class Snap:
            def keys(self):
                return list(outer.files)

            def get(self, key):
                return outer.files[key]

        return Snap()

    def add_update_callback(self, cb):
        self._callbacks.append(cb)

    def touch(self):
        for cb in self._callbacks:
            cb()


def make_cache(ts, local_cache_size=0, stats_scope=None, **kw):
    local = LocalCache(local_cache_size, ts) if local_cache_size else None
    base = BaseRateLimiter(ts, local_cache=local, near_limit_ratio=0.8)
    return CudaRateLimitCache(
        base, n_slots=1 << 12, buckets=(128,), max_batch=128, device="cpu", stats_scope=stats_scope, **kw
    )


def make_service(yaml_text=ALGO_YAML, ts=None, local_cache_size=0, host_fast_path=True, **kw):
    pytest.importorskip("yaml")
    ts = ts or FakeTimeSource(1_000_000)
    store = Store()
    scope = store.scope("ratelimit")
    cache = make_cache(ts, local_cache_size=local_cache_size, stats_scope=scope, **kw)
    runtime = FakeRuntime({"config.algo": yaml_text})
    svc = RateLimitService(runtime, cache, scope, ts, host_fast_path=host_fast_path)
    return svc, runtime, cache, scope, ts


class TestLoaderValidation:
    def test_algorithms_parse_and_default(self):
        c = load(ALGO_YAML).compiled
        assert c.resolve("algo", Descriptor.of(("fixed", ""))).algorithm == 0
        assert c.resolve("algo", Descriptor.of(("slide", ""))).algorithm == ALGO_ID_SLIDING_WINDOW
        assert c.resolve("algo", Descriptor.of(("bucket", ""))).algorithm == ALGO_ID_GCRA
        assert c.resolve("algo", Descriptor.of(("conns", ""))).algorithm == ALGO_ID_CONCURRENCY

    def test_wire_divider_composition(self):
        c = load(ALGO_YAML, concurrency_ttl_s=45).compiled
        fixed = c.resolve("algo", Descriptor.of(("fixed", "")))
        assert fixed.wire_divider == fixed.divider == 60
        slide = c.resolve("algo", Descriptor.of(("slide", "")))
        assert slide.wire_divider == 60 | (ALGO_ID_SLIDING_WINDOW << 28)
        conns = c.resolve("algo", Descriptor.of(("conns", "")))
        assert conns.divider == 45
        assert conns.wire_divider == 45 | (ALGO_ID_CONCURRENCY << 28)

    @pytest.mark.parametrize(
        "rule,match",
        [
            ("{unit: minute, requests_per_unit: 1, algorithm: leaky_bucket}", "invalid rate limit algorithm"),
            ("{unit: minute, requests_per_unit: 1, algorithm: concurrency}", "takes no 'unit'"),
            ("{requests_per_unit: 1, algorithm: gcra}", "invalid rate limit unit"),
        ],
    )
    def test_invalid_rules_rejected(self, rule, match):
        with pytest.raises(ConfigError, match=match):
            load(f"domain: d\ndescriptors:\n  - key: k\n    rate_limit: {rule}\n")

    def test_algorithm_key_position_enforced(self):
        with pytest.raises(ConfigError, match="not valid in a descriptor"):
            load("domain: d\ndescriptors:\n  - key: k\n    algorithm: gcra\n    rate_limit: {unit: minute, requests_per_unit: 1}\n")

    def test_hot_reload_keeps_serving_previous_config(self):
        svc, runtime, _cache, _scope, _ts = make_service()
        assert svc.should_rate_limit(req(("fixed", "")))[0] == Code.OK
        runtime.files["config.algo"] = ALGO_YAML.replace("{unit: minute, requests_per_unit: 5}", "{unit: minute, requests_per_unit: 5, algorithm: nonsense}")
        runtime.touch()
        assert svc.should_rate_limit(req(("fixed", "")))[0] == Code.OK
        rec = svc.get_current_config().compiled.resolve("algo", Descriptor.of(("fixed", "")))
        assert rec is not None and rec.algorithm == 0

    def test_ids_pinned_to_the_reference_and_the_kernels(self):
        from api_ratelimit_tpu.models.config import ALGORITHM_IDS as J_IDS

        assert ALGORITHM_IDS == J_IDS == {
            "fixed_window": T.ALGO_FIXED_WINDOW,
            "sliding_window": T.ALGO_SLIDING_WINDOW,
            "gcra": T.ALGO_GCRA,
            "concurrency": T.ALGO_CONCURRENCY,
        }
        for name in ("ALGO_SHIFT", "ALGO_DIV_MASK", "ALGO_CONC_RELEASE", "GCRA_TAT_CAP_MS", "GCRA_DIV_CAP_S", "HEALTH_WIDTH"):
            assert getattr(T, name) == getattr(J, name) == getattr(TO, name), name
        assert K.ALGO_SLIDING_WINDOW == T.ALGO_SLIDING_WINDOW
        assert T.ALGO_NAMES == J.ALGO_NAMES


class TestRollbackArm:
    def test_default_config_wire_and_slab_bytes(self):
        svc, _r, cache, _scope, _ts = make_service(
            yaml_text="domain: algo\ndescriptors:\n  - key: fixed\n    rate_limit: {unit: minute, requests_per_unit: 5}\n"
        )
        captured = []
        engine = cache.engine
        real = engine.submit_rows

        def spy(block):
            captured.append(np.array(block))
            return real(block)

        engine.submit_rows = spy
        for _ in range(3):
            assert svc.should_rate_limit(req(("fixed", "")))[0] == Code.OK
        rows = np.concatenate(captured, axis=1)
        assert (rows[4] == 60).all()
        assert engine.algos_seen is False
        table = engine.export_tables()[0]
        occupied = table.any(axis=1)
        assert occupied.any() and (table[occupied, 5] == 60).all()
        assert not table[:, 6:].any()

    def test_non_fixed_traffic_flips_the_guard(self):
        svc, _r, cache, _scope, _ts = make_service()
        assert cache.engine.algos_seen is False
        svc.should_rate_limit(req(("bucket", "")))
        assert cache.engine.algos_seen is True


class TestAlgorithmsThroughService:
    @pytest.mark.parametrize("fast", [True, False])
    def test_sliding_window_carries_across_edge(self, fast):
        ts = FakeTimeSource(999_960 + 50)
        svc, *_ = make_service(ts=ts, host_fast_path=fast)
        for _ in range(6):
            assert svc.should_rate_limit(req(("slide", "")))[0] == Code.OK
        assert svc.should_rate_limit(req(("slide", "")))[0] == Code.OVER_LIMIT
        # 15 s into the next window: carry floor(7 * 45 / 60) = 5, one admit
        ts.now = 1_000_020 + 15
        codes = [svc.should_rate_limit(req(("slide", "")))[0] for _ in range(4)]
        assert codes == [Code.OK, Code.OVER_LIMIT, Code.OVER_LIMIT, Code.OVER_LIMIT]
        ts.now = 1_000_020 + 55
        assert svc.should_rate_limit(req(("slide", "")))[0] == Code.OK

    @pytest.mark.parametrize("fast", [True, False])
    def test_gcra_burst_then_rate(self, fast):
        svc, _r, _c, _s, ts = make_service(host_fast_path=fast)
        codes = [svc.should_rate_limit(req(("bucket", "")))[0] for _ in range(6)]
        assert codes[:4] == [Code.OK] * 4 and codes[4] == Code.OVER_LIMIT
        ts.advance(15)  # T = 60 s / 4
        assert svc.should_rate_limit(req(("bucket", "")))[0] == Code.OK
        assert svc.should_rate_limit(req(("bucket", "")))[0] == Code.OVER_LIMIT

    def test_gcra_burst_ratio_widens_the_burst(self):
        svc, *_ = make_service(gcra_burst_ratio=2.0)
        codes = [svc.should_rate_limit(req(("bucket", "")))[0] for _ in range(9)]
        assert codes[:8] == [Code.OK] * 8 and codes[8] == Code.OVER_LIMIT

    @pytest.mark.parametrize("fast", [True, False])
    def test_concurrency_cap_and_release(self, fast):
        svc, *_ = make_service(host_fast_path=fast)
        for _ in range(3):
            assert svc.should_rate_limit(req(("conns", "")))[0] == Code.OK
        assert svc.should_rate_limit(req(("conns", "")))[0] == Code.OVER_LIMIT
        assert svc.release(req(("conns", ""))) == 1
        assert svc.should_rate_limit(req(("conns", "")))[0] == Code.OK
        assert svc.should_rate_limit(req(("conns", "")))[0] == Code.OVER_LIMIT
        assert svc.release(req(("fixed", ""))) == 0

    def test_concurrency_ttl_reclaims_leaked_slots(self):
        svc, _r, _c, _s, ts = make_service()
        for _ in range(3):
            assert svc.should_rate_limit(req(("conns", "")))[0] == Code.OK
        assert svc.should_rate_limit(req(("conns", "")))[0] == Code.OVER_LIMIT
        ts.advance(120)  # past the default 60 s idle TTL
        assert svc.should_rate_limit(req(("conns", "")))[0] == Code.OK

    def test_concurrency_skips_over_limit_local_cache(self):
        svc, *_ = make_service(local_cache_size=1 << 16)
        for _ in range(3):
            svc.should_rate_limit(req(("conns", "")))
        assert svc.should_rate_limit(req(("conns", "")))[0] == Code.OVER_LIMIT
        svc.release(req(("conns", "")))
        assert svc.should_rate_limit(req(("conns", "")))[0] == Code.OK

    def test_gcra_skips_over_limit_local_cache(self):
        svc, _r, _c, _s, ts = make_service(local_cache_size=1 << 16)
        for _ in range(4):
            assert svc.should_rate_limit(req(("bucket", "")))[0] == Code.OK
        assert svc.should_rate_limit(req(("bucket", "")))[0] == Code.OVER_LIMIT
        ts.advance(15)
        assert svc.should_rate_limit(req(("bucket", "")))[0] == Code.OK

    def test_sliding_skips_over_limit_local_cache(self):
        ts = FakeTimeSource(999_960 + 50)
        svc, *_ = make_service(ts=ts, local_cache_size=1 << 16)
        for _ in range(6):
            assert svc.should_rate_limit(req(("slide", "")))[0] == Code.OK
        assert svc.should_rate_limit(req(("slide", "")))[0] == Code.OVER_LIMIT
        ts.now = 1_000_020 + 15
        assert svc.should_rate_limit(req(("slide", "")))[0] == Code.OK
        assert svc.should_rate_limit(req(("slide", "")))[0] == Code.OVER_LIMIT
        ts.now = 1_000_020 + 55
        assert svc.should_rate_limit(req(("slide", "")))[0] == Code.OK

    def test_algo_stats(self):
        svc, _r, _c, scope, _ts = make_service()
        for _ in range(5):
            svc.should_rate_limit(req(("bucket", "")))
        svc.should_rate_limit(req(("fixed", "")))
        algo = scope.scope("algo")
        assert algo.counter("gcra.decisions").value() == 5
        assert algo.counter("gcra.over_limit").value() == 1
        assert algo.counter("fixed_window.decisions").value() == 1
        assert algo.counter("fixed_window.over_limit").value() == 0
        assert algo.counter("concurrency.decisions").value() == 0

    def test_service_stories_match_the_reference_cache(self):
        """The same request stream through the reference's cache
        (use_pallas=False, do_limit_resolved over its compiled records) and
        the port's: every status and counter, and the tables."""
        from api_ratelimit_tpu.config.loader import ConfigFile as JFile
        from api_ratelimit_tpu.config.loader import load_config as j_load
        from api_ratelimit_tpu.stats import Store as JStore
        from api_ratelimit_tpu.stats import TestSink

        jts, ts = JFake(1_000_000), FakeTimeSource(1_000_000)
        jcache = TpuRateLimitCache(JBase(jts, near_limit_ratio=0.8), n_slots=1 << 12, buckets=(128,), max_batch=128, use_pallas=False, gcra_burst_ratio=BURST)
        cache = make_cache(ts, gcra_burst_ratio=BURST)
        jc = j_load([JFile(name="config.algo", contents=ALGO_YAML)], JStore(TestSink()).scope("r")).compiled
        pc = load(ALGO_YAML).compiled
        rng = np.random.default_rng(17)
        names = ["fixed", "slide", "bucket", "bucket2", "conns"]
        for step in range(200):
            adv = int(rng.choice([0, 0, 0, 1, 5, 20]))
            jts.advance(adv)
            ts.advance(adv)
            picked = [str(n) for n in rng.choice(names, int(rng.integers(1, 4)))]
            hits = int(rng.integers(1, 3))
            jreq = JRequest(domain="algo", descriptors=tuple(JDescriptor.of((n, "")) for n in picked), hits_addend=hits)
            preq = req(*[(n, "") for n in picked], hits=hits)
            jres = [jc.resolve("algo", d) for d in jreq.descriptors]
            pres = [pc.resolve("algo", d) for d in preq.descriptors]
            if rng.random() < 0.2:
                assert cache.do_release(preq, pres) == jcache.do_release(jreq, jres)
                continue
            got = cache.do_limit_resolved(preq, pres).descriptor_statuses
            want = jcache.do_limit_resolved(jreq, jres).descriptor_statuses
            assert [(int(s.code), s.limit_remaining) for s in got] == [(int(s.code), s.limit_remaining) for s in want], step
        assert np.array_equal(cache.engine.export_tables()[0], jcache.engine.export_tables()[0])
        jcache.close()


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", path, body=body, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def test_post_release_decrements():
    svc, *_ = make_service()
    server = HttpServer(svc)
    server.serve_background()
    try:
        body = json.dumps({"domain": "algo", "descriptors": [{"entries": [{"key": "conns"}]}]})
        for _ in range(3):
            assert _post(server.port, "/json", body)[0] == 200
        assert _post(server.port, "/json", body)[0] == 429
        status, text = _post(server.port, "/release", body)
        assert status == 200 and json.loads(text) == {"released": 1}
        assert _post(server.port, "/json", body)[0] == 200
        assert _post(server.port, "/release", "")[0] == 400
        assert _post(server.port, "/release", '{"domain": "algo"')[0] == 400
        fixed = json.dumps({"domain": "algo", "descriptors": [{"entries": [{"key": "fixed"}]}]})
        assert json.loads(_post(server.port, "/release", fixed)[1]) == {"released": 0}
        empty_domain = json.dumps({"domain": "", "descriptors": [{"entries": [{"key": "conns"}]}]})
        assert _post(server.port, "/release", empty_domain)[0] == 500
    finally:
        server.shutdown()


@pytest.mark.parametrize("dispatch_loop", [True, False])
def test_windowed_release_in_both_arms(dispatch_loop):
    """Acquires and Releases through a windowed cache (the dispatch loop or
    leader-collects): the same statuses and table as direct mode, with
    release rows and algorithm bits riding submit_rows unchanged."""
    pytest.importorskip("yaml")
    pc = load(ALGO_YAML).compiled
    caches = []
    for window in (0.0, 0.0005):
        ts = FakeTimeSource(1_000_000)
        base = BaseRateLimiter(ts, near_limit_ratio=0.8)
        caches.append((ts, CudaRateLimitCache(
            base, n_slots=1 << 10, buckets=(128,), max_batch=128, device="cpu",
            batch_window_seconds=window, dispatch_loop=dispatch_loop,
        )))
    rng = np.random.default_rng(23)
    try:
        for step in range(60):
            adv = int(rng.choice([0, 0, 3]))
            names = [str(n) for n in rng.choice(["conns", "slide", "bucket", "fixed"], int(rng.integers(1, 3)))]
            r = req(*[(n, "") for n in names])
            res = [pc.resolve("algo", d) for d in r.descriptors]
            out = []
            for ts, cache in caches:
                ts.advance(adv)
                if step % 5 == 4:
                    out.append(cache.do_release(r, res))
                else:
                    out.append([int(s.code) for s in cache.do_limit_resolved(r, res).descriptor_statuses])
            assert out[0] == out[1], step
        direct, windowed = (c.engine.export_tables()[0] for _ts, c in caches)
        assert np.array_equal(direct, windowed)
        assert caches[1][1].engine.algos_seen
        if dispatch_loop:
            assert caches[1][1].engine.dispatch_loop is not None
    finally:
        for _ts, cache in caches:
            cache.close()


def test_oracle_scan_matches_reference_on_high_fingerprints():
    """The port oracle's vectorized scan against the reference oracle's
    per-item scan with fingerprints across the whole uint32 range
    (fp_hi >= 2^31 included), duplicates, hits and misses."""
    rng = np.random.default_rng(31)
    now = 1_000_000
    t = algo_table(rng, 256, 4, now, np.arange(300))
    t[:, 1] = rng.integers(0, 1 << 32, 256, dtype=np.uint64)
    lo = np.concatenate([t[::3, 0], rng.integers(0, 1 << 32, 200, dtype=np.uint64)]).astype(np.uint32)
    hi = np.concatenate([t[::3, 1], rng.integers(0, 1 << 32, 200, dtype=np.uint64)]).astype(np.uint32)
    lo, hi = np.concatenate([lo, lo[:50]]), np.concatenate([hi, hi[:50]])
    o, jo = TO.SetSlabOracle(256, 4), JO.SetSlabOracle(256, 4)
    o.table = jo.table = t.astype(np.uint64)
    want = [jo._choose(int(a), int(b), now) for a, b in zip(lo, hi)]
    assert o._choose_many(lo.tolist(), hi.tolist(), now, chunk=64) == want
    assert sum(m for _s, m, _c in want) >= 30


def test_near_threshold_is_one_ieee_f32_multiply_then_floor():
    """The decision's f32 spot (ops/decide.py _near_threshold, reference
    ops/decide.py:144-146) is one IEEE float32 multiply, rounded to nearest,
    then a floor: numpy's float32 arithmetic, with ratios whose products
    land next to an integer, where a fused or wider multiply would round
    differently. GCRA's tau is held to the XLA twin by
    test_gcra_tau_saturates_as_xla_converts."""
    from api_ratelimit_tpu_torch.ops import decide as D

    rng = np.random.default_rng(41)
    limit = rng.integers(1, 1 << 32, 4096, dtype=np.uint64)
    limit[:64] = (1 << 32) - rng.integers(1, 200, 64)
    for ratio in (0.8, 0.1, 0.3, 0.7, 0.9999999, 1.0, np.float32(1 / 3)):
        f = np.float32(limit.astype(np.float32)) * np.float32(ratio)
        want = np.minimum(np.floor(f.astype(np.float64)), M32).astype(np.int64)
        got = D._near_threshold(torch.from_numpy(limit.astype(np.int64)), float(np.float32(ratio)))
        assert np.array_equal(got.numpy(), want), ratio
