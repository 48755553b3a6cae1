"""The plain reference of the served counters: NumPy only.

It works out again, from the rows the benchmark made and the order and clock
in which the run launched them, the post-increment counter every row should
get back from the device owner. It imports nothing of the program and takes
nothing the program made: the table it keeps is its own.

The semantics are the documented ones of the W-way set-associative counter
slab (the port's README, "Rate-limit algorithms", and the sequential
specification the port's own oracle states), written here from that
specification rather than from the device code:

- A key (its 64-bit fingerprint, lo and hi words) lives only in set
  `fp_lo & (n_sets - 1)`. Each row of a launch scans its set as the table
  stood before the launch: a live way holding its fingerprint matches;
  otherwise it takes the least valuable way (dead, then window-ended, then
  the live way of lowest count; ties by a rotation that starts at way
  `(fp_hi >> way_bits) & (W - 1)`).
- A launch's rows are ordered by (slot, matched, the top bits of fp_hi),
  stably, so the rows of one key keep their arrival order. A run of equal
  (slot, fingerprint) in that order is served as one serialized segment:
  each row sees every earlier row of its run (the duplicate-serialized
  INCRBY). The last run of a slot writes the slot; the others are the
  counted contention drops, which fail open.
- Per run, the rule's algorithm: fixed window (count per window), sliding
  window (count plus the previous window's count weighted by the part of it
  still in the sliding span), GCRA (theoretical arrival time in integer
  milliseconds; denials never advance it) and concurrency (acquires admitted
  while count + hits <= limit, then the launch's releases, floored at 0).

Sets are independent of one another, so a reference built over a sample of
the sets (`sets=`) gives exactly the answers of the whole table for every
row that falls in them.

serialize=False is the control: each row of a run sees only what the table
held before the launch, as an INCRBY without serialization would. It breaks
the guarantee the configurations state, and the comparison has to fail it.
"""

from __future__ import annotations

import numpy as np

ROW_WIDTH = 8
COL_FP_LO, COL_FP_HI, COL_COUNT, COL_WINDOW, COL_EXPIRE, COL_DIVIDER, COL_PREV, COL_AUX = range(8)
ALGO_SHIFT = 28
ALGO_DIV_MASK = (1 << ALGO_SHIFT) - 1
FIXED, SLIDING, GCRA, CONCURRENCY, RELEASE = range(5)
ALGORITHMS = {
    "fixed_window": FIXED,
    "sliding_window": SLIDING,
    "gcra": GCRA,
    "concurrency": CONCURRENCY,
}
SCORE_TIER_SHIFT = 28
GCRA_TAT_CAP_MS = 1 << 30
GCRA_DIV_CAP_S = 1_000_000
M32 = (1 << 32) - 1


def saturate(after: np.ndarray, limit: np.ndarray, hits: np.ndarray) -> np.ndarray:
    """The wire's readback: each launch returns its counters saturated at the
    narrowest of 2^8 - 1, 2^16 - 1 and 2^32 - 1 that stays above
    max(limit) + max(hits) of that launch, so every decision survives."""
    top = int(limit.max()) + int(hits.max()) if limit.size else 0
    cap = 0xFF if top < 0xFF else 0xFFFF if top < 0xFFFF else M32
    return np.minimum(after, cap)


def _segment_sum(values: np.ndarray, run: np.ndarray, n_runs: int) -> np.ndarray:
    return np.bincount(run, weights=values, minlength=n_runs).astype(np.int64)


def _exclusive_in_run(values: np.ndarray, start_of: np.ndarray, run: np.ndarray) -> np.ndarray:
    """Sum of `values` over the earlier rows of each row's run."""
    incl = np.cumsum(values)
    excl = incl - values
    return excl - excl[start_of[run]]


class SlabReference:
    """The counter slab of `n_slots` rows in sets of `ways`, held for the sets
    in `sets` (all when None). step() serves one launch."""

    def __init__(self, n_slots: int, ways: int, burst_ratio: float = 1.0, sets=None,
                 serialize: bool = True):
        if n_slots <= 0 or n_slots & (n_slots - 1) or ways <= 0 or ways & (ways - 1):
            raise ValueError("n_slots and ways must be powers of two")
        ways = min(ways, n_slots)
        self.ways = ways
        self.n_slots = n_slots
        self.n_sets = n_slots // ways
        self.way_bits = max(1, (ways - 1).bit_length())
        self.fp_bits = max(0, min(16, 32 - n_slots.bit_length() - 1))
        self.count_cap = (1 << (SCORE_TIER_SHIFT - self.way_bits)) - 1
        self.burst = np.float32(burst_ratio)
        self.serialize = serialize
        self.sets = (
            np.arange(self.n_sets, dtype=np.int64) if sets is None
            else np.unique(np.asarray(sets, dtype=np.int64))
        )
        # the held sets' rows, column-major within a set: [set, column, way]
        self.table = np.zeros((self.sets.size, ROW_WIDTH, ways), dtype=np.uint32)

    def holds(self, fp_lo: np.ndarray) -> np.ndarray:
        """bool[...]: which rows fall in the sets this reference holds."""
        member = np.zeros(self.n_sets, dtype=bool)
        member[self.sets] = True
        return member[np.asarray(fp_lo, dtype=np.int64) & (self.n_sets - 1)]

    def step(self, fp_lo, fp_hi, hits, limit, divider, jitter, now: int) -> np.ndarray:
        """One launch of rows in arrival order (every row in a held set and
        hits > 0); returns int64[n] post-increment counters, unsaturated."""
        lo = np.asarray(fp_lo, dtype=np.int64)
        hi = np.asarray(fp_hi, dtype=np.int64)
        hits = np.asarray(hits, dtype=np.int64)
        limit = np.asarray(limit, dtype=np.int64)
        word = np.asarray(divider, dtype=np.int64)
        jit = np.asarray(jitter, dtype=np.int64)
        now = int(now)
        n = lo.size
        if n == 0:
            return np.zeros(0, dtype=np.int64)
        W = self.ways
        ci = np.searchsorted(self.sets, lo & (self.n_sets - 1))
        way, matched = self._scan(lo, hi, ci, now)
        slot = (lo & (self.n_sets - 1)) * W + way
        key = ((slot << 1) | matched) & M32
        if self.fp_bits:
            key = ((key << self.fp_bits) & M32) | (hi >> (32 - self.fp_bits))
        order = np.argsort(key, kind="stable")
        s_slot, s_lo, s_hi = slot[order], lo[order], hi[order]
        s_ci, s_way, s_matched = ci[order], way[order], matched[order]
        s_hits, s_limit, s_word, s_jit = hits[order], limit[order], word[order], jit[order]
        start = np.ones(n, dtype=bool)
        start[1:] = (s_slot[1:] != s_slot[:-1]) | (s_lo[1:] != s_lo[:-1]) | (s_hi[1:] != s_hi[:-1])
        first = np.flatnonzero(start)
        last = np.r_[first[1:] - 1, n - 1]
        run = np.cumsum(start) - 1
        n_runs = first.size
        st = self.table[s_ci[first], :, s_way[first]].astype(np.int64)  # each run's way before the launch

        algo_row = (s_word >> ALGO_SHIFT) & 7
        algo = algo_row[first]
        store = np.where(algo == RELEASE, CONCURRENCY, algo)
        div = np.maximum(s_word[first] & ALGO_DIV_MASK, 1)
        st_algo = (st[:, COL_DIVIDER] >> ALGO_SHIFT) & 7
        match_ok = s_matched[first].astype(bool) & (st_algo == store)
        cur_window = (now // div) * div
        same_window = st[:, COL_WINDOW] == cur_window
        jit_last = s_jit[last]

        # rows before each row in its run: the serialization (the control
        # drops it)
        prior = _exclusive_in_run(s_hits, first, run) if self.serialize else np.zeros(n, np.int64)
        total = _segment_sum(s_hits, run, n_runs)
        after = np.zeros(n, dtype=np.int64)
        out = np.zeros((n_runs, ROW_WIDTH), dtype=np.int64)
        out[:, COL_FP_LO] = s_lo[first]
        out[:, COL_FP_HI] = s_hi[first]
        out[:, COL_DIVIDER] = div | (store << ALGO_SHIFT)

        # fixed and sliding windows: the windowed counter
        windowed = (store == FIXED) | (store == SLIDING)
        base = np.where(match_ok & same_window, st[:, COL_COUNT], 0)
        prev_raw = np.where(
            match_ok & same_window,
            st[:, COL_PREV],
            np.where(match_ok & (st[:, COL_WINDOW] == (cur_window - div) % (1 << 32)), st[:, COL_COUNT], 0),
        )
        prev_c = np.minimum(prev_raw, (2**31 - 1) // div)
        carried = np.where(store == SLIDING, prev_c * (div - (now - cur_window)) // div, 0)
        rows_w = windowed[run]
        after[rows_w] = (base + carried)[run][rows_w] + prior[rows_w] + s_hits[rows_w]
        sliding = store == SLIDING
        out[windowed, COL_COUNT] = (base + total)[windowed]
        out[windowed, COL_WINDOW] = cur_window[windowed]
        out[windowed, COL_EXPIRE] = (now + np.where(sliding, 2 * div, div) + jit_last)[windowed]
        out[sliding, COL_PREV] = prev_raw[sliding]

        # GCRA: the admitted rows are a prefix of the run
        g = store == GCRA
        if g.any():
            limit0 = np.maximum(s_limit[first], 1)
            div_ms = np.minimum(div, GCRA_DIV_CAP_S) * 1000
            t_ms = np.maximum(div_ms // limit0, 1)
            tau_f = np.floor(div_ms.astype(np.float32) * self.burst).astype(np.int64)
            tau = np.maximum(tau_f - t_ms, 0)
            dsec = np.clip(st[:, COL_PREV] - now, -(1 << 20), 1 << 20)
            tat0 = np.where(match_ok, np.maximum(dsec * 1000 + st[:, COL_AUX], 0), 0)
            used0 = (tat0 + t_ms - 1) // t_ms
            q = np.where(tat0 <= tau, (tau - tat0) // t_ms, -1)
            rows_g = g[run]
            admit = rows_g & (tat0 <= tau)[run] & (prior <= q[run])
            after[rows_g] = np.where(
                admit, np.minimum(used0[run] + prior + s_hits, s_limit), s_limit + s_hits
            )[rows_g]
            admitted = _segment_sum(np.where(admit, s_hits, 0), run, n_runs)
            a_eff = np.minimum(admitted, GCRA_TAT_CAP_MS // t_ms)
            tat_new = np.minimum(tat0 + a_eff * t_ms, GCRA_TAT_CAP_MS)
            tat_sec = now + tat_new // 1000
            out[g, COL_COUNT] = np.minimum(tat_new // t_ms, ALGO_DIV_MASK)[g]
            out[g, COL_WINDOW] = ((tat_sec - div) % (1 << 32))[g]
            out[g, COL_EXPIRE] = (now + div + (tat_new + 999) // 1000 + jit_last)[g]
            out[g, COL_PREV] = (tat_sec % (1 << 32))[g]
            out[g, COL_AUX] = (tat_new % 1000)[g]

        # concurrency: acquires against the in-flight count, then releases
        c = store == CONCURRENCY
        if c.any():
            rows_c = c[run]
            release = rows_c & (algo_row == RELEASE)
            acquire = rows_c & ~release
            count0 = np.where(match_ok, st[:, COL_COUNT], 0)
            acq_hits = np.where(acquire, s_hits, 0)
            prior_a = (
                _exclusive_in_run(acq_hits, first, run) if self.serialize else np.zeros(n, np.int64)
            )
            pos = count0[run] + prior_a + s_hits
            admit = acquire & (pos <= s_limit)
            after[acquire] = np.where(admit, pos, s_limit + s_hits)[acquire]
            after[release] = 0
            adm_total = _segment_sum(np.where(admit, s_hits, 0), run, n_runs)
            rel_total = _segment_sum(np.where(release, s_hits, 0), run, n_runs)
            out[c, COL_COUNT] = np.maximum(count0 + adm_total - rel_total, 0)[c]
            out[c, COL_WINDOW] = now
            out[c, COL_EXPIRE] = (now + div + jit_last)[c]

        # one write per slot: its last run in the launch order
        wins = np.ones(n_runs, dtype=bool)
        wins[:-1] = s_slot[first][1:] != s_slot[first][:-1]
        self.table[s_ci[first][wins], :, s_way[first][wins]] = out[wins]
        result = np.empty(n, dtype=np.int64)
        result[order] = after
        return result

    def _scan(self, lo, hi, ci, now: int):
        """(way, matched) of every row against the table before the launch,
        one scan a distinct key."""
        pairs = (hi << 32) | lo
        keys, first, inverse = np.unique(pairs, return_index=True, return_inverse=True)
        k_lo, k_hi = lo[first].astype(np.uint32), hi[first].astype(np.uint32)
        rows = self.table[ci[first]]  # [key, column, way]
        live = rows[:, COL_EXPIRE] > now
        match = live & (rows[:, COL_FP_LO] == k_lo[:, None]) & (rows[:, COL_FP_HI] == k_hi[:, None])
        matched = match.any(axis=1)
        way = match.argmax(axis=1)
        miss = np.flatnonzero(~matched)
        if miss.size:
            W = self.ways
            r, lv = rows[miss], live[miss]
            raw_div = r[:, COL_DIVIDER]
            rdiv = raw_div & ALGO_DIV_MASK
            span = np.where((raw_div >> ALGO_SHIFT) == SLIDING, 2 * rdiv, rdiv)
            ended = lv & (rdiv > 0) & (r[:, COL_WINDOW] + span <= now)
            tier = np.where(lv, np.where(ended, 1, 2), 0).astype(np.uint32)
            pref = (k_hi[miss] >> self.way_bits) & (W - 1)
            rot = (np.arange(W, dtype=np.uint32)[None, :] - pref[:, None]) & (W - 1)
            cnt = np.minimum(r[:, COL_COUNT], self.count_cap)
            score = (tier << SCORE_TIER_SHIFT) | np.where(lv, (cnt << self.way_bits) | rot, rot)
            way[miss] = score.argmin(axis=1)
        inverse = inverse.reshape(-1)
        return way[inverse].astype(np.int64), matched[inverse].astype(np.int64)
