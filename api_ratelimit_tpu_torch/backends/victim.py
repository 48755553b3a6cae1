"""Port of api_ratelimit_tpu/backends/victim.py: the host-RAM victim tier,
the second level of the device-memory<->host slab hierarchy.

The slab is fixed-capacity; once the live working set exceeds it, the
in-kernel eviction scan displaces live in-window rows and — before this
tier existed — their counters were simply gone (`slab.evictions.live`,
`loss_ppm`): a window of free traffic per lost key. The VictimTier is
where those rows go instead. The engine (backends/cuda.py) drains every
launch's demote readback (ops/slab.py slab_step_after victim=True) into
this table, and re-promotes a row the moment its key reappears in a
batch (ops/slab.py slab_promote_rows), counter/divider/algorithm bits
intact — a demoted key resumes mid-window instead of resetting. The
design is the classic bounded-associativity fast tier backed by a
second-chance victim tier (PAPERS: "Limited Associativity Caching in
the Data Plane"; the KV-cache tensor-buffer-to-memory-hierarchy
survey), with demote/promote as the degradation mechanism instead of
loss.

The table itself is open-addressed over the FULL 64-bit fingerprint
(linear probing + tombstones), rows stored verbatim in the slab's
(ROW_WIDTH,) uint32 wire format — so persistence is free: export_rows()
feeds persist/snapshot.py pack_table_bytes unchanged (the victim.snap
section, FLAG_VICTIM), and restore reuses the SAME reconcile_rows
clock discipline the slab shards get.

Graceful degradation is the point, so the tier bounds itself:

  * max_rows caps occupancy; past it an insert first runs the
    TTL/window-aware reclamation (reconcile_rows over the live table —
    dead and window-ended rows carry no decision state), and if the
    table is STILL full, value-ranked overflow applies: the
    lowest-count row in the tier loses (the slab's own eviction
    valuation, one level down). Every overflow drop is counted AND its
    lost counter value accumulates in overflow_lost_count_sum — the
    term the differential oracle's false-admit bound is stated against
    (tests/test_victim.py).
  * a watermark raises a sticky degraded health probe
    (watermark_reason) so operators see the tier filling BEFORE it
    overflows — the never-OOM-the-owner contract; serving is never
    touched.

numpy + stdlib only (no torch import): the snapshotter, the offline
inspector, and light test harnesses all construct it directly.
"""

from __future__ import annotations

import logging
import threading

import numpy as np

from ..persist.snapshot import (
    COL_COUNT,
    COL_EXPIRE,
    COL_FP_HI,
    COL_FP_LO,
    COL_WINDOW,
    ROW_WIDTH,
    reconcile_rows,
)

_log = logging.getLogger(__name__)

# slot states for the open-addressed probe chain. A tombstone keeps the
# chain walkable after a promote removes a row mid-chain; rebuilds
# (_rehash) retire them once they pass a quarter of capacity.
_EMPTY, _OCCUPIED, _TOMBSTONE = 0, 1, 2


def _mix(fp_lo: int, fp_hi: int) -> int:
    """64-bit fingerprint -> probe home. The slab's set index consumes
    fp_lo's low bits, so fold the high half through a splitmix-style
    multiply to decorrelate the two placements."""
    x = ((fp_hi << 32) | fp_lo) & 0xFFFFFFFFFFFFFFFF
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
    return (x ^ (x >> 31)) & 0xFFFFFFFFFFFFFFFF


class VictimTier:
    """Bounded host-RAM table of demoted live slab rows.

    max_rows: occupancy bound (VICTIM_MAX_ROWS). Capacity is the next
    power of two holding max_rows at <= 2/3 load so probe chains stay
    short. watermark: fraction of max_rows past which the sticky
    degraded probe raises (VICTIM_WATERMARK).

    Thread safety: one lock around every mutation — the engine calls
    from its dispatch path, the snapshotter and stats from their own
    threads. All operations are host-side numpy; nothing here ever
    touches the device."""

    def __init__(
        self,
        max_rows: int,
        watermark: float = 0.85,
        time_source=None,
    ):
        max_rows = int(max_rows)
        if max_rows <= 0:
            raise ValueError(f"victim max_rows must be positive, got {max_rows}")
        if not 0.0 < float(watermark) <= 1.0:
            raise ValueError(
                f"victim watermark must be in (0, 1], got {watermark}"
            )
        self._max_rows = max_rows
        self._watermark = float(watermark)
        self._time_source = time_source
        cap = 64
        while cap * 2 < max_rows * 3:  # load factor <= 2/3
            cap <<= 1
        self._cap = cap
        self._mask = cap - 1
        self._table = np.zeros((cap, ROW_WIDTH), dtype=np.uint32)
        self._slot_state = np.zeros(cap, dtype=np.uint8)
        self._lock = threading.Lock()
        self.rows = 0
        self._tombstones = 0
        # counters (read by VictimStats / describe; never reset)
        self.demotes_total = 0  # rows inserted from the demote drain
        self.promotes_total = 0  # rows retired by a landed promote
        self.merges_total = 0  # demotes that merged into an existing row
        self.reclaimed_total = 0  # rows dropped by TTL/window reclamation
        self.overflow_drops_total = 0  # value-ranked overflow losses
        # the false-admit bound's loss term: sum of COL_COUNT over every
        # overflow-dropped row — with the tier on, a key can only forget
        # counts that crossed this ledger (or the in-batch contention
        # drops the slab already counts)
        self.overflow_lost_count_sum = 0
        self._watermark_state = 0  # sticky until occupancy falls below

    # -- probing --

    def _find(self, fp_lo: int, fp_hi: int) -> tuple[int, int]:
        """(occupied slot of fp | -1, first free slot on the chain | -1).
        Callers hold the lock."""
        i = _mix(fp_lo, fp_hi) & self._mask
        free = -1
        for _ in range(self._cap):
            st = self._slot_state[i]
            if st == _EMPTY:
                return -1, (free if free >= 0 else i)
            if st == _TOMBSTONE:
                if free < 0:
                    free = i
            elif (
                self._table[i, COL_FP_LO] == fp_lo
                and self._table[i, COL_FP_HI] == fp_hi
            ):
                return i, free
            i = (i + 1) & self._mask
        return -1, free

    def _rehash(self) -> None:
        """Rebuild in place once tombstones pass cap/4 — keeps probe
        chains short without ever growing the allocation."""
        live = self._table[self._slot_state == _OCCUPIED].copy()
        self._table[:] = 0
        self._slot_state[:] = _EMPTY
        self._tombstones = 0
        self.rows = 0
        for row in live:
            _, free = self._find(int(row[COL_FP_LO]), int(row[COL_FP_HI]))
            self._table[free] = row
            self._slot_state[free] = _OCCUPIED
            self.rows += 1

    def _remove_at(self, i: int) -> None:
        self._table[i] = 0
        self._slot_state[i] = _TOMBSTONE
        self._tombstones += 1
        self.rows -= 1
        if self._tombstones * 4 > self._cap:
            self._rehash()

    # -- demote path --

    def insert(self, rows: np.ndarray, now: int) -> int:
        """Drain one launch's demoted rows in; returns rows absorbed
        (inserted or merged — overflow drops are counted, not returned).
        All-zero lanes are skipped (the readback's filter contract).
        Same-fp collisions merge keep-the-newest (greater window wins,
        equal windows keep the greater count — persist/snapshot.py
        merge_rows_into_table), so a demote racing a stale copy can only
        converge upward."""
        rows = np.asarray(rows, dtype=np.uint32)
        if rows.ndim != 2 or rows.shape[1] != ROW_WIDTH:
            raise ValueError(
                f"victim rows must be (n, {ROW_WIDTH}), got {rows.shape}"
            )
        absorbed = 0
        with self._lock:
            for row in rows:
                if not row[COL_EXPIRE]:
                    continue
                fp_lo, fp_hi = int(row[COL_FP_LO]), int(row[COL_FP_HI])
                found, free = self._find(fp_lo, fp_hi)
                if found >= 0:
                    old = self._table[found]
                    if (row[COL_WINDOW], row[COL_COUNT]) > (
                        old[COL_WINDOW],
                        old[COL_COUNT],
                    ):
                        self._table[found] = row
                    self.merges_total += 1
                    self.demotes_total += 1
                    absorbed += 1
                    continue
                if self.rows >= self._max_rows:
                    self._reclaim_locked(int(now))
                    if (
                        self.rows >= self._max_rows
                        and not self._overflow_locked(row)
                    ):
                        continue  # incoming row was the least valuable
                    # reclaim/overflow mutated slots (maybe rehashed):
                    # the free slot must be re-probed
                    _, free = self._find(fp_lo, fp_hi)
                if self._slot_state[free] == _TOMBSTONE:
                    self._tombstones -= 1
                self._table[free] = row
                self._slot_state[free] = _OCCUPIED
                self.rows += 1
                self.demotes_total += 1
                absorbed += 1
            self._update_watermark_locked()
        return absorbed

    def _overflow_locked(self, row: np.ndarray) -> bool:
        """Value-ranked overflow at max_rows: the lowest-count row loses
        — the incoming one (return False: caller drops it) or the
        table's minimum (evicted to make room; return True). Either
        way the loss is counted and its counter value lands in
        overflow_lost_count_sum, the oracle bound's ledger."""
        occ = self._slot_state == _OCCUPIED
        counts = np.where(
            occ, self._table[:, COL_COUNT], np.uint32(0xFFFFFFFF)
        )
        i = int(np.argmin(counts))
        if int(self._table[i, COL_COUNT]) >= int(row[COL_COUNT]):
            self.overflow_drops_total += 1
            self.overflow_lost_count_sum += int(row[COL_COUNT])
            return False
        self.overflow_drops_total += 1
        self.overflow_lost_count_sum += int(self._table[i, COL_COUNT])
        self._remove_at(i)
        return True

    # -- promote path --

    def lookup_batch(
        self, fp_lo: np.ndarray, fp_hi: np.ndarray
    ) -> np.ndarray | None:
        """Rows for every distinct (fp_lo, fp_hi) pair present in the
        tier, or None when none hit — the engine's pre-launch promote
        probe. Rows are COPIES; the originals stay in the table until
        retire() confirms the promote landed (a crashed launch must not
        lose the counter)."""
        if not self.rows:
            return None
        hits = []
        seen = set()
        with self._lock:
            for lo, hi in zip(
                np.asarray(fp_lo).tolist(), np.asarray(fp_hi).tolist()
            ):
                key = (lo, hi)
                if key in seen:
                    continue
                seen.add(key)
                found, _ = self._find(lo, hi)
                if found >= 0:
                    hits.append(self._table[found].copy())
        if not hits:
            return None
        return np.stack(hits)

    def retire(self, rows: np.ndarray, landed: np.ndarray) -> int:
        """Drop the rows whose promote landed (or proved stale) from the
        table; un-landed rows stay for the next attempt. Returns rows
        retired."""
        rows = np.asarray(rows, dtype=np.uint32)
        retired = 0
        with self._lock:
            for row, ok in zip(rows, np.asarray(landed).tolist()):
                if not ok or not row[COL_EXPIRE]:
                    continue
                found, _ = self._find(
                    int(row[COL_FP_LO]), int(row[COL_FP_HI])
                )
                if found >= 0:
                    self._remove_at(found)
                    self.promotes_total += 1
                    retired += 1
            self._update_watermark_locked()
        return retired

    # -- reclamation / bounds --

    def reclaim(self, now: int) -> int:
        """TTL/window-aware reclamation: drop rows whose jittered TTL
        passed or whose window ended with no decision state left —
        EXACTLY the restore-time reconcile rules (snapshot.py
        reconcile_rows: sliding keeps one grace window, GCRA's window
        means TAT drained). Called on the stats cadence and before any
        overflow decision; returns rows dropped."""
        with self._lock:
            dropped = self._reclaim_locked(int(now))
            self._update_watermark_locked()
        return dropped

    def _reclaim_locked(self, now: int) -> int:
        if not self.rows:
            return 0
        occ = self._slot_state == _OCCUPIED
        kept, _stats = reconcile_rows(self._table, now)
        dead = occ & ~kept.any(axis=1)
        n_dead = int(dead.sum())
        if n_dead:
            self._table[dead] = 0
            self._slot_state[dead] = _TOMBSTONE
            self._tombstones += n_dead
            self.rows -= n_dead
            self.reclaimed_total += n_dead
            if self._tombstones * 4 > self._cap:
                self._rehash()
        return n_dead

    def _update_watermark_locked(self) -> None:
        high = self.rows >= self._watermark * self._max_rows
        if high and not self._watermark_state:
            _log.warning(
                "victim tier past watermark: %d rows >= %.0f%% of %d",
                self.rows,
                self._watermark * 100,
                self._max_rows,
            )
        self._watermark_state = 1 if high else 0

    def watermark_reason(self) -> str | None:
        """HealthChecker degraded-probe contract: a reason string while
        the tier sits past its occupancy watermark (it clears only when
        reclamation or promotes bring occupancy back under), else None.
        Degraded-only: a full victim tier degrades to counted overflow
        drops, never to refusing traffic or unbounded memory."""
        if self._watermark_state:
            return (
                f"victim tier pressure: {self.rows} rows >= watermark "
                f"{self._watermark:g} of max {self._max_rows}; overflow "
                f"drops value-ranked"
            )
        return None

    # -- persistence (victim.snap rides the snapshot set) --

    def export_rows(self) -> np.ndarray:
        """Compact (rows, ROW_WIDTH) copy of every live row — the
        victim.snap section payload (persist/snapshotter.py), already in
        pack_table_bytes wire format because rows are stored verbatim."""
        with self._lock:
            return self._table[self._slot_state == _OCCUPIED].copy()

    def import_rows(self, rows: np.ndarray, now: int) -> int:
        """Boot-restore re-seed: insert reconciled snapshot rows (the
        snapshotter already ran reconcile_rows; insert re-applies the
        bounds, so a snapshot from a larger config can never overflow
        this one). Returns rows absorbed."""
        return self.insert(rows, now)

    # -- debug / stats --

    def describe(self, now: int) -> dict:
        """The GET /debug/victim document body (the engine wraps it with
        fault/journey context): occupancy, bounds, counters, and the
        row-age histogram the inspector also renders."""
        with self._lock:
            occ = self._slot_state == _OCCUPIED
            live = self._table[occ]
            ages = []
            if live.shape[0]:
                # age since the row's window position — how long rows
                # wait in the tier before promotion or reclamation
                ages = np.maximum(
                    0, int(now) - live[:, COL_WINDOW].astype(np.int64)
                )
            hist = {}
            for bound, label in (
                (10, "<10s"),
                (60, "<60s"),
                (600, "<600s"),
                (1 << 62, ">=600s"),
            ):
                n = int(np.sum(np.asarray(ages) < bound)) - sum(
                    hist.values()
                )
                hist[label] = n
            return {
                "rows": int(self.rows),
                "max_rows": self._max_rows,
                "capacity": self._cap,
                "watermark": self._watermark,
                "watermark_state": self._watermark_state,
                "demotes": self.demotes_total,
                "promotes": self.promotes_total,
                "merges": self.merges_total,
                "reclaimed": self.reclaimed_total,
                "overflow_drops": self.overflow_drops_total,
                "overflow_lost_count_sum": self.overflow_lost_count_sum,
                "age_histogram": hist,
            }
