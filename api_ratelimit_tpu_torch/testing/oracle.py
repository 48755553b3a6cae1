"""Host oracles of the slab step, numpy only: copies of
api_ratelimit_tpu/testing/oracle.py SetSlabOracle, occurrence_rank,
parity_report and VictimOracle.

SetSlabOracle is the exact sequential model of the W-way slab step for every
algorithm (fixed window, sliding window, GCRA, concurrency and its release
rows), adapted in one place: its first pass scans every item's set with
numpy, a chunk of items at a time (_choose_many), where the reference loops
over ways in Python, so it keeps up with a 65536-item launch at W = 128. The
comparisons and the second pass are the reference's.

parity_report's oracle is a single-window, uniform-limit stream: the k-th
occurrence of a key (k from 1) is over the limit exactly when k > limit.
The slab's losses (live evictions, in-batch contention drops) all fail open,
so an engine may answer OK where the oracle says OVER, never the reverse.
"""

from __future__ import annotations

import numpy as np

# mirrors of the ops/slab.py layout/constants (redeclared so the oracle
# stays importable without jax; tests pin the equivalence)
ROW_WIDTH = 8
COL_FP_LO, COL_FP_HI, COL_COUNT, COL_WINDOW, COL_EXPIRE, COL_DIVIDER = range(6)
COL_PREV, COL_AUX = 6, 7
SCORE_TIER_SHIFT = 28
EVICT_NONE, EVICT_EXPIRED, EVICT_WINDOW, EVICT_LIVE = range(4)

# algorithm ids in bits 28-30 of the divider word (ops/slab.py ALGO_*)
ALGO_SHIFT = 28
ALGO_DIV_MASK = (1 << ALGO_SHIFT) - 1
(
    ALGO_FIXED_WINDOW,
    ALGO_SLIDING_WINDOW,
    ALGO_GCRA,
    ALGO_CONCURRENCY,
    ALGO_CONC_RELEASE,
) = range(5)
GCRA_TAT_CAP_MS = 1 << 30
GCRA_DIV_CAP_S = 1_000_000
HEALTH_WIDTH = 5  # evictions expired/window/live + drops + algo resets


class SetSlabOracle:
    """Exact sequential host model of the W-way set-associative slab step
    (ops/slab.py): set selection, fingerprint match, eviction valuation
    (dead, then window-ended, then lowest-count live — rotation tiebreak),
    within-batch duplicate serialization, the winner-per-way contention
    rule (a same-batch fingerprint match always outlives a colliding
    evictor; among colliding inserts the higher top-16 fp_hi bits win),
    and the health counters. The differential fuzz campaign
    (tests/test_slab_fuzz.py) holds the device step to this model
    bit-for-bit — results, final table, AND eviction mix — at arbitrary
    occupancy, which is what makes >100% load a testable regime instead
    of an untestable one.

    One modeled restriction: when two DISTINCT colliding keys share their
    top-16 fp_hi bits, the device sort interleaves their segments and
    both undercount (probability 2^-16 per colliding pair in production,
    documented in ops/slab.py); the oracle raises instead of guessing, and
    the fuzz generators construct fingerprints with unique top bits."""

    def __init__(self, n_slots: int, ways: int, burst_ratio: float = 1.0):
        ways = min(int(ways), int(n_slots))
        self.burst_ratio = float(burst_ratio)
        if ways <= 0 or ways & (ways - 1):
            raise ValueError(f"ways must be a positive power of two: {ways}")
        if n_slots % ways:
            raise ValueError(f"{n_slots} rows don't split into {ways}-way sets")
        self.n_slots = int(n_slots)
        self.ways = ways
        self.n_sets = self.n_slots // ways
        self.way_bits = max(1, (ways - 1).bit_length())
        slot_bits = self.n_slots.bit_length()
        self.fp_bits = max(0, min(16, 32 - slot_bits - 1))
        self.table = np.zeros((self.n_slots, ROW_WIDTH), dtype=np.uint64)
        # cumulative uint32[HEALTH_WIDTH]: evictions expired/window/live +
        # drops + algorithm-change resets — the ops/slab.py HEALTH_* layout
        self.health = [0] * HEALTH_WIDTH

    def _choose_many(self, fp_lo, fp_hi, now: int, chunk: int = 8192) -> list:
        """(slot, matched, evict_class) of each item against the CURRENT
        table (the kernel scans every item against the pre-batch state):
        the reference's _choose, its comparisons in numpy over int64
        (every stored word and query as its unsigned value), a chunk of
        distinct keys at a time. Sliding rows stay tier-LIVE one window
        past their own end (span = 2 x divider), as _scan_ways tiers
        them."""
        # one scan a distinct key: its items all scan the same table
        pairs = (np.asarray(fp_hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(fp_lo, dtype=np.uint64)
        keys, inverse = np.unique(pairs, return_inverse=True)
        lo_all = (keys & np.uint64(0xFFFFFFFF)).astype(np.int64)
        hi_all = (keys >> np.uint64(32)).astype(np.int64)
        count_cap = (1 << (SCORE_TIER_SHIFT - self.way_bits)) - 1
        way_iota = np.arange(self.ways, dtype=np.int64)
        out = []
        for c0 in range(0, lo_all.size, chunk):
            lo, hi = lo_all[c0 : c0 + chunk], hi_all[c0 : c0 + chunk]
            base = (lo & (self.n_sets - 1)) * self.ways
            rows = self.table[base[:, None] + way_iota[None, :]].astype(np.int64)
            live = rows[:, :, COL_EXPIRE] > now
            match = (
                live
                & (rows[:, :, COL_FP_LO] == lo[:, None])
                & (rows[:, :, COL_FP_HI] == hi[:, None])
            )
            raw_div = rows[:, :, COL_DIVIDER]
            rdiv = raw_div & ALGO_DIV_MASK
            sliding = ((raw_div >> ALGO_SHIFT) & 7) == ALGO_SLIDING_WINDOW
            span = np.where(sliding, rdiv * 2, rdiv)
            ended = live & (rdiv > 0) & (rows[:, :, COL_WINDOW] + span <= now)
            tier = np.where(live, np.where(ended, 1, 2), 0)
            pref = (hi >> self.way_bits) & (self.ways - 1)
            rot = (way_iota[None, :] - pref[:, None]) & (self.ways - 1)
            cnt = np.minimum(rows[:, :, COL_COUNT], count_cap)
            sub = np.where(live, (cnt << self.way_bits) | rot, rot)
            score = (tier << SCORE_TIER_SHIFT) | sub
            matched = match.any(axis=1)
            way = np.where(matched, match.argmax(axis=1), score.argmin(axis=1))
            k = np.arange(lo.size)
            v_live = live[k, way]
            v_exp = rows[k, way, COL_EXPIRE]
            cls = np.where(
                matched,
                EVICT_NONE,
                np.where(
                    v_live,
                    np.where(ended[k, way], EVICT_WINDOW, EVICT_LIVE),
                    np.where(v_exp > 0, EVICT_EXPIRED, EVICT_NONE),
                ),
            )
            out.extend(zip((base + way).tolist(), matched.tolist(), cls.tolist()))
        return [out[k] for k in inverse.reshape(-1).tolist()]

    def step_batch(self, items, now: int):
        """items: list of (fp_lo, fp_hi, hits, limit, divider, jitter);
        hits == 0 marks padding. Returns (before, after, codes,
        health_delta) in arrival order — codes by the decide rule
        (2 = OVER when after > limit, else 1)."""
        now = int(now)
        n = len(items)
        before, after, codes = [0] * n, [0] * n, [0] * n
        # pass 1: scan every item against the pre-batch table
        segs: dict = {}  # (slot, fp_lo, fp_hi) -> [matched, cls, [idx...]]
        order = []  # first-arrival order of segment keys, for stable wins
        live_items = [i for i, it in enumerate(items) if it[2] > 0]
        chosen = self._choose_many(
            [items[i][0] for i in live_items], [items[i][1] for i in live_items], now
        )
        for i, (slot, matched, cls) in zip(live_items, chosen):
            fp_lo, fp_hi = items[i][0], items[i][1]
            key = (slot, fp_lo, fp_hi)
            if key not in segs:
                segs[key] = [matched, cls, []]
                order.append(key)
            segs[key][2].append(i)
        # pass 2: serialize duplicates + pick each way's winning segment.
        # Each segment runs its rule's decision algorithm — the sequential
        # executable spec the vectorized kernels must match bit-for-bit.
        by_slot: dict = {}
        delta = [0] * HEALTH_WIDTH
        for key in order:
            slot, fp_lo, fp_hi = key
            matched, cls, idxs = segs[key]
            row = self.table[slot]
            raw_div0 = int(items[idxs[0]][4])
            algo0 = (raw_div0 >> ALGO_SHIFT) & 7
            store_algo = (
                ALGO_CONCURRENCY if algo0 == ALGO_CONC_RELEASE else algo0
            )
            for i in idxs[1:]:
                a = (int(items[i][4]) >> ALGO_SHIFT) & 7
                sa = ALGO_CONCURRENCY if a == ALGO_CONC_RELEASE else a
                if sa != store_algo:
                    raise AssertionError(
                        "one key carries two algorithms in one batch: the "
                        "kernel's per-segment serialization assumes one "
                        "rule per key per launch (reloads land between "
                        "batches; construct fuzz batches accordingly)"
                    )
            div = max(raw_div0 & ALGO_DIV_MASK, 1)
            st_algo = (int(row[COL_DIVIDER]) >> ALGO_SHIFT) & 7
            match_ok = matched and st_algo == store_algo
            algo_reset = matched and st_algo != store_algo
            cur_window = (now // div) * div
            last_i = idxs[-1]
            jit = int(items[last_i][5])
            out_row = None

            if store_algo in (ALGO_FIXED_WINDOW, ALGO_SLIDING_WINDOW):
                same_window = int(row[COL_WINDOW]) == cur_window
                base = int(row[COL_COUNT]) if match_ok and same_window else 0
                carried = 0
                prev_raw = 0
                if store_algo == ALGO_SLIDING_WINDOW:
                    if match_ok and same_window:
                        prev_raw = int(row[COL_PREV])
                    elif match_ok and int(row[COL_WINDOW]) == (
                        cur_window - div
                    ) % (1 << 32):
                        prev_raw = int(row[COL_COUNT])
                    prev_c = min(prev_raw, (2**31 - 1) // div)
                    carried = prev_c * (div - (now - cur_window)) // div
                running = base
                for i in idxs:
                    hits, limit = int(items[i][2]), int(items[i][3])
                    before[i] = running + carried
                    running += hits
                    after[i] = running + carried
                    codes[i] = 2 if after[i] > limit else 1
                if store_algo == ALGO_FIXED_WINDOW:
                    out_row = [
                        fp_lo, fp_hi, running, cur_window,
                        now + div + jit, raw_div0 & ALGO_DIV_MASK, 0, 0,
                    ]
                else:
                    out_row = [
                        fp_lo, fp_hi, running, cur_window,
                        now + 2 * div + jit,
                        (raw_div0 & ALGO_DIV_MASK)
                        | (ALGO_SLIDING_WINDOW << ALGO_SHIFT),
                        prev_raw, 0,
                    ]

            elif store_algo == ALGO_GCRA:
                limit0 = max(int(items[idxs[0]][3]), 1)
                div_ms = min(div, GCRA_DIV_CAP_S) * 1000
                t_ms = max(div_ms // limit0, 1)
                tau = max(
                    int(
                        np.floor(
                            np.float32(div_ms)
                            * np.float32(self.burst_ratio)
                        )
                    )
                    - t_ms,
                    0,
                )
                tat0 = 0
                if match_ok:
                    dsec = int(row[COL_PREV]) - now
                    dsec = max(-(1 << 20), min(dsec, 1 << 20))
                    tat0 = max(dsec * 1000 + int(row[COL_AUX]), 0)
                used0 = (tat0 + t_ms - 1) // t_ms
                prior = 0
                admitted = 0
                q = (tau - tat0) // t_ms if tat0 <= tau else -1
                for i in idxs:
                    hits, limit = int(items[i][2]), int(items[i][3])
                    admit = tat0 <= tau and prior <= q
                    if admit:
                        after[i] = min(used0 + prior + hits, limit)
                        admitted += hits
                    else:
                        after[i] = limit + hits
                    before[i] = max(after[i] - hits, 0)
                    codes[i] = 2 if after[i] > limit else 1
                    prior += hits
                a_eff = min(admitted, GCRA_TAT_CAP_MS // t_ms)
                tat_new = min(tat0 + a_eff * t_ms, GCRA_TAT_CAP_MS)
                tat_sec_new = now + tat_new // 1000
                out_row = [
                    fp_lo, fp_hi,
                    min(tat_new // t_ms, ALGO_DIV_MASK),
                    (tat_sec_new - div) % (1 << 32),
                    # alive until the TAT drains + one window (the kernel's
                    # burst-debt rule: expiry must not forgive the TAT)
                    now + div + (tat_new + 999) // 1000 + jit,
                    (raw_div0 & ALGO_DIV_MASK) | (ALGO_GCRA << ALGO_SHIFT),
                    tat_sec_new % (1 << 32),
                    tat_new % 1000,
                ]

            else:  # concurrency: acquire/release against the in-flight count
                count0 = int(row[COL_COUNT]) if match_ok else 0
                prior_a = 0
                adm_total = 0
                rel_total = 0
                for i in idxs:
                    hits, limit = int(items[i][2]), int(items[i][3])
                    a = (int(items[i][4]) >> ALGO_SHIFT) & 7
                    if a == ALGO_CONC_RELEASE:
                        after[i] = 0
                        before[i] = 0
                        codes[i] = 1
                        rel_total += hits
                        continue
                    admit = count0 + prior_a + hits <= limit
                    if admit:
                        after[i] = count0 + prior_a + hits
                        adm_total += hits
                    else:
                        after[i] = limit + hits
                    before[i] = max(after[i] - hits, 0)
                    codes[i] = 2 if after[i] > limit else 1
                    prior_a += hits
                count_new = max(count0 + adm_total - rel_total, 0)
                out_row = [
                    fp_lo, fp_hi, count_new, now,
                    now + div + jit,
                    (raw_div0 & ALGO_DIV_MASK)
                    | (ALGO_CONCURRENCY << ALGO_SHIFT),
                    0, 0,
                ]

            by_slot.setdefault(slot, []).append(
                (key, matched, cls, algo_reset, out_row)
            )
        writes = []
        for slot, contenders in by_slot.items():
            winner = None
            for c in contenders:
                if c[1]:  # a fingerprint match always wins the way
                    winner = c
            if winner is None:
                tops = [c[0][2] >> (32 - self.fp_bits) for c in contenders]
                if len(set(tops)) != len(tops):
                    raise AssertionError(
                        "distinct colliding keys share top fp_hi bits: the "
                        "device sort would interleave their segments "
                        "(2^-16 per pair; construct fuzz fps uniquely)"
                    )
                winner = max(contenders, key=lambda c: c[0][2] >> (32 - self.fp_bits))
            delta[3] += len(contenders) - 1  # losing segments drop, counted
            _key, _m, cls, algo_reset, out_row = winner
            if cls != EVICT_NONE:
                delta[cls - 1] += 1
            if algo_reset:
                delta[4] += 1
            writes.append((slot, out_row))
        # pass 3: ONE write per way, after every scan (the kernel scatter)
        for slot, row in writes:
            self.table[slot] = np.array(row, dtype=np.uint64)
        for k in range(HEALTH_WIDTH):
            self.health[k] += delta[k]
        return before, after, codes, delta


def occurrence_rank(ids: np.ndarray) -> np.ndarray:
    """rank[i] = how many earlier stream positions hold the same id.
    Vectorized (argsort + run detection); O(n log n)."""
    n = ids.shape[0]
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]
    starts = np.r_[0, np.flatnonzero(sorted_ids[1:] != sorted_ids[:-1]) + 1]
    run_marker = np.zeros(n, dtype=np.int64)
    run_marker[starts] = 1
    run_id = np.cumsum(run_marker) - 1
    rank_sorted = np.arange(n, dtype=np.int64) - starts[run_id]
    rank = np.empty(n, dtype=np.int64)
    rank[order] = rank_sorted
    return rank


def parity_report(
    ids: np.ndarray, got_codes: np.ndarray, limit: int, code_over: int = 2
) -> dict:
    """Compare engine codes against the exact oracle for a single-window
    uniform-limit stream. Returns the agreement rate and the one-sided
    error split: false_over (engine OVER where the oracle says OK) must be
    0; false_ok is the cost of the slab's fail-open losses."""
    want_over = occurrence_rank(ids) + 1 > limit
    got_over = np.asarray(got_codes) == code_over
    agree = got_over == want_over
    n = ids.shape[0]
    return {
        "decisions": int(n),
        "agreement": float(np.mean(agree)),
        "false_over": int(np.sum(got_over & ~want_over)),
        "false_ok": int(np.sum(~got_over & want_over)),
        "oracle_over_frac": float(np.mean(want_over)),
    }


class VictimOracle:
    """Exact UNBOUNDED per-key fixed-window reference for the tiered-slab
    differential bound (tests/test_torch_victim.py, chip_smoke.py's tiers
    phase). Unlike SetSlabOracle this
    model has no sets, no ways, and no capacity — it never evicts, so it
    never loses a live counter. That makes it the reference the victim
    tier is measured against: with the tier ON, the engine's false admits
    (engine says OK where this oracle says OVER) are bounded by exactly
    the losses the hierarchy still takes —

        false_admits <= slab in-batch contention drops (HEALTH drops)
                        + tier overflow_lost_count_sum
                        + tier TTL/window reclamation of still-live rows

    and a structured stream (one key per slab set per batch, keyspace
    within VICTIM_MAX_ROWS, fixed clock) drives every term to zero, so
    the test asserts false_admits == 0 outright. The tier-OFF control
    under the identical stream pins a NON-zero false-admit count — the
    measured silent loss the tier ends."""

    def __init__(self):
        # (fp_lo, fp_hi) -> [window_start, count]
        self._rows: dict = {}

    def step_batch(self, items, now: int):
        """items: (fp_lo, fp_hi, hits, limit, divider, jitter) — the
        SetSlabOracle item tuple, fixed-window rows only. Duplicates in a
        batch serialize in arrival order (the slab's own discipline).
        Returns codes (1 = OK, 2 = OVER when after > limit, 0 = padding)
        in arrival order."""
        now = int(now)
        codes = []
        for fp_lo, fp_hi, hits, limit, raw_div, _jit in items:
            hits = int(hits)
            if hits <= 0:
                codes.append(0)
                continue
            algo = (int(raw_div) >> ALGO_SHIFT) & 7
            if algo != ALGO_FIXED_WINDOW:
                raise AssertionError(
                    "VictimOracle models fixed_window only: the victim "
                    "differential test constructs fixed-window streams"
                )
            div = max(int(raw_div) & ALGO_DIV_MASK, 1)
            window = (now // div) * div
            key = (int(fp_lo), int(fp_hi))
            row = self._rows.get(key)
            if row is None or row[0] != window:
                row = [window, 0]
                self._rows[key] = row
            row[1] += hits
            codes.append(2 if row[1] > int(limit) else 1)
        return codes

    def count(self, fp_lo: int, fp_hi: int) -> int:
        """The key's exact current-window count (0 when never seen)."""
        row = self._rows.get((int(fp_lo), int(fp_hi)))
        return int(row[1]) if row else 0
