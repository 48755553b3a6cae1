"""Port of api_ratelimit_tpu/backends/tpu.py: the device engine and the cache.

BACKEND_TYPE=tpu becomes a CUDA engine. Descriptors are fingerprinted on the
host (ops/hashing.py), and one launch of the slab step (ops/slab.py
slab_step_after) runs the set scan, the duplicate-serialized INCRBY and the
row scatter against the device table. The device returns each item's
post-increment counter, saturating-cast to the narrowest dtype the batch's
limits allow, and the host derives code, remaining, throttle and the stats
split with the same BaseRateLimiter oracle every backend shares.

The port runs the reference's direct mode (TPU_BATCH_WINDOW=0): every
submit is one serialized launch under the state lock. With hotkey_lanes > 0
(HOTKEYS_ENABLED, the production default) every launch also updates the
heavy-hitter sketch (ops/sketch.py), which the stats cadence drains
(HotkeyStats); the cache's compiled-matcher path (do_limit_resolved)
records the witness keys that /debug/hotkeys resolves fingerprints to. The
micro-batcher, dispatch loop, victim tier, leases, mesh engine and
persistence wait for later slices. The kernels cover fixed-window rules
only: a launch carrying any other algorithm id raises CacheError instead of
being served with the wrong semantics.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Sequence

import numpy as np
import torch

from ..assertx import assert_
from ..limiter.base_limiter import BaseRateLimiter, LimitInfo
from ..limiter.cache import CacheError
from ..limiter.cache_key import generate_cache_key
from ..models.config import ALGO_ID_FIXED_WINDOW, ALGORITHM_IDS, RateLimit
from ..models.descriptors import RateLimitRequest
from ..models.response import DoLimitResponse
from ..models.units import unit_to_divider
from ..ops.hashing import fingerprint_many, split_fingerprints
from ..ops.sketch import (
    make_sketch,
    sketch_decay,
    sketch_export_copy,
    sketch_import_planes,
    sketch_topk,
    sketch_ways,
)
from ..ops.slab import (
    ALGO_SHIFT,
    HEALTH_ALGO_RESETS,
    HEALTH_DROPS,
    HEALTH_EVICT_EXPIRED,
    HEALTH_EVICT_LIVE,
    HEALTH_EVICT_WINDOW,
    HEALTH_WIDTH,
    default_ways,
    live_slot_count,
    make_slab,
    resolve_device,
    slab_export_copy,
    slab_step_after,
    validate_ways,
)


def _loss_ppm(snap: dict) -> int:
    """Lossy events (live-row evictions + in-batch contention drops) per
    million decisions — the alarmable rate behind the fail-open contract."""
    decisions = snap.get("decisions", 0)
    if not decisions:
        return 0
    return round(
        (snap["evictions_live"] + snap["drops"]) / decisions * 1_000_000
    )


@dataclasses.dataclass(slots=True)
class _Item:
    fp: int
    hits: int
    limit: int
    divider: int  # window seconds, algorithm id in bits 28-30
    jitter: int


def _items_to_block(items: list[_Item]) -> np.ndarray:
    """uint32[6, n] row block (fp_lo, fp_hi, hits, limit, divider, jitter)."""
    n = len(items)
    block = np.empty((6, n), dtype=np.uint32)
    fp = np.fromiter((it.fp for it in items), dtype=np.uint64, count=n)
    block[0], block[1] = split_fingerprints(fp)
    block[2] = np.fromiter((it.hits for it in items), np.uint32, n)
    block[3] = np.fromiter((it.limit for it in items), np.uint32, n)
    block[4] = np.fromiter((it.divider for it in items), np.uint32, n)
    block[5] = np.fromiter((it.jitter for it in items), np.uint32, n)
    return block


class SlabDeviceEngine:
    """The device driver in direct mode: owns the slab and turns row blocks
    into post-increment counters, one launch per bucket-sized chunk, each
    serialized under the state lock."""

    def __init__(
        self,
        time_source,
        n_slots: int = 1 << 22,
        ways: int = 0,
        buckets: Sequence[int] = (128, 1024, 8192, 65536),
        device="cuda",
        hotkey_lanes: int = 0,
        hotkey_k: int = 16,
    ):
        """ways: set associativity (SLAB_WAYS); 0 picks the platform's
        (128 on the card, 4 on the CPU). device: "cuda" (the default)
        raises without a card; "cpu" runs the kernels' plain versions.

        hotkey_lanes: lanes of the heavy-hitter sketch (HOTKEY_LANES). 0
        disables it (the HOTKEYS_ENABLED=false arm): no sketch enters the
        launch, which is then exactly the sketch-free step. hotkey_k is the
        top-K size each drain reports (HOTKEY_K)."""
        self._time_source = time_source
        self._device = resolve_device(device)
        if not ways:
            ways = default_ways(self._device.type)
        self._ways = validate_ways(n_slots, ways)
        self._n_slots = n_slots
        self._state = make_slab(n_slots, self._device)
        self._buckets = tuple(sorted(buckets))
        self._max_bucket = self._buckets[-1]
        self._health_totals = [0] * HEALTH_WIDTH
        self._decisions_total = 0
        self._pending_health: list = []
        self._state_lock = threading.Lock()
        # heavy-hitter sketch: planes beside the slab, updated by every
        # launch, drained and halved on the stats cadence (drain_hotkeys)
        self._hotkey_k = max(1, int(hotkey_k))
        self._sketch: torch.Tensor | None = None
        self._sketch_ways = 0
        self._last_topk: list[tuple[int, int, int]] = []
        self._hotkey_drains = 0
        if int(hotkey_lanes) > 0:
            self._sketch_ways = sketch_ways(self._ways, hotkey_lanes)
            self._sketch = make_sketch(hotkey_lanes, self._device)

    @property
    def ways(self) -> int:
        return self._ways

    # -- heavy-hitter sketch drain (stats cadence; ops/sketch.py) --

    @property
    def hotkeys_enabled(self) -> bool:
        return self._sketch is not None

    def drain_hotkeys(self) -> list[tuple[int, int, int]]:
        """Pull the sketch planes to the host, rank the top-K, halve the
        counts and upload them again, under the state lock. Called on the
        stats cadence by HotkeyStats, never per launch. The reference's
        hot_fps set and drain listeners feed its mesh hot tier and journey
        flags; they come with those consumers."""
        if self._sketch is None:
            return []
        with self._state_lock:
            planes = sketch_export_copy(self._sketch)
            top = sketch_topk(planes, self._hotkey_k)
            self._sketch = sketch_import_planes(sketch_decay(planes), self._device)
        self._last_topk = top
        self._hotkey_drains += 1
        return top

    def hotkeys_snapshot(self) -> dict:
        """The last drained top-K as a debug document (/debug/hotkeys
        without key resolution; the cache layer adds witness keys)."""
        return {
            "enabled": self._sketch is not None,
            "k": self._hotkey_k,
            "lanes": 0 if self._sketch is None else int(self._sketch.shape[1]),
            "drains": self._hotkey_drains,
            "top": [
                {"fp": f"{(hi << 32) | lo:016x}", "count": cnt}
                for lo, hi, cnt in self._last_topk
            ],
        }

    def export_sketch(self) -> np.ndarray | None:
        """Host copy of the sketch planes, uint32[3, lanes], under the
        state lock (None with the sketch off)."""
        with self._state_lock:
            return None if self._sketch is None else sketch_export_copy(self._sketch)

    def _drain_health_locked(self) -> None:
        pending, self._pending_health = self._pending_health, []
        if pending:
            totals = torch.stack(pending).sum(dim=0).cpu().tolist()
            for i, v in enumerate(totals):
                self._health_totals[i] += int(v)

    def health_snapshot(self) -> dict:
        """Slab health for the stats tree: the eviction mix, drops, the
        decisions denominator, occupancy and loss_ppm. live_slots is an
        O(n_slots) device reduction — call it on the stats cadence."""
        now = int(self._time_source.unix_now())
        with self._state_lock:
            self._drain_health_locked()
            live = live_slot_count(self._state.table, now)
            snap = {
                "evictions_expired": self._health_totals[HEALTH_EVICT_EXPIRED],
                "evictions_window": self._health_totals[HEALTH_EVICT_WINDOW],
                "evictions_live": self._health_totals[HEALTH_EVICT_LIVE],
                "drops": self._health_totals[HEALTH_DROPS],
                "algo_resets": self._health_totals[HEALTH_ALGO_RESETS],
                "decisions": self._decisions_total,
                "live_slots": live,
                "occupancy": live / self._n_slots,
            }
        snap["loss_ppm"] = _loss_ppm(snap)
        return snap

    def submit(self, items: list[_Item]) -> list[int]:
        """Batched fixed-window increment; returns each item's
        post-increment counter."""
        if not items:
            return []
        return self.submit_rows(_items_to_block(items)).tolist()

    def submit_rows(self, block: np.ndarray) -> np.ndarray:
        """One uint32[6, n] row block -> uint32[n] post-increment counters."""
        if block.shape[1] == 0:
            return np.empty(0, dtype=np.uint32)
        outs = [
            self._launch_locked(packed, n, cap)
            for packed, n, cap in self._iter_block_chunks(block)
        ]
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    def export_tables(self) -> list[np.ndarray]:
        """Host copy of the slab, uint32[n_slots, 8], under the state lock."""
        with self._state_lock:
            return [slab_export_copy(self._state)]

    def flush(self) -> None:
        pass  # direct mode: every submit has finished when it returns

    def close(self) -> None:
        pass

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self._max_bucket

    def _iter_block_chunks(self, block: np.ndarray):
        """Yield (packed uint32[7, bucket], n, cap) per max-bucket chunk.
        Padding lanes carry hits == 0, the only gate the device reads. The
        cap uses max(limit) + max(hits) over the chunk, so the saturating
        readback stays exact."""
        total = block.shape[1]
        now = np.uint32(self._time_source.unix_now())
        for off in range(0, total, self._max_bucket):
            chunk = block[:, off : off + self._max_bucket]
            n = chunk.shape[1]
            packed = np.zeros((7, self._bucket_for(n)), dtype=np.uint32)
            packed[:6, :n] = chunk
            maxv = int(packed[2, :n].max()) + int(packed[3, :n].max())
            cap = 0xFF if maxv < 255 else 0xFFFF if maxv < 65535 else 0xFFFFFFFF
            packed[6, 0] = now
            yield packed, n, cap

    def _launch_locked(self, packed: np.ndarray, n: int, cap: int) -> np.ndarray:
        algo = int(packed[4, :n].max()) >> ALGO_SHIFT
        if algo:
            raise CacheError(
                f"rate-limit algorithm id {algo} on the wire: the CUDA port "
                "serves fixed_window only; sliding window, GCRA and "
                "concurrency come with a later slice of the port"
            )
        dtype = np.uint8 if cap == 0xFF else np.uint16 if cap == 0xFFFF else np.uint32
        try:
            with self._state_lock:
                outs = slab_step_after(
                    self._state, packed, ways=self._ways, out_dtype=dtype,
                    sketch=self._sketch, sketch_ways=self._sketch_ways,
                )
                if self._sketch is not None:
                    after_dev, health, self._sketch = outs
                else:
                    after_dev, health = outs
                self._pending_health.append(health)
                self._decisions_total += n
                if len(self._pending_health) > 4096:
                    self._drain_health_locked()
            return after_dev[:n].cpu().numpy().astype(np.uint32)
        except (RuntimeError, ValueError) as e:
            raise CacheError(f"cuda backend failure: {e}") from e


class SlabHealthStats:
    """StatGenerator exporting the slab's health on every stats flush:

        ratelimit.slab.evictions.expired  reclaims of expired (TTL-dead) ways
        ratelimit.slab.evictions.window   evictions of live ways whose fixed
                                          window had ended
        ratelimit.slab.evictions.live     evictions of live in-window ways,
                                          the only lossy tier
        ratelimit.slab.drops       cumulative in-batch contention drops
        ratelimit.slab.algo_resets rows reset because their rule's algorithm
                                   changed (0 while the port serves
                                   fixed_window only)
        ratelimit.slab.decisions   cumulative decisions submitted on-device
        ratelimit.slab.loss_ppm    (evictions.live + drops) per million
                                   decisions since the last flush
        ratelimit.slab.live_slots  currently live (unexpired) slots
        ratelimit.slab.occupancy   live fraction x 1e6

    The reference's `watermark` gauge waits for SLAB_WATERMARK_HIGH, which
    the port has no setting for yet."""

    def __init__(self, engine, scope):
        self._engine = engine
        self._last = {"evictions_live": 0, "drops": 0, "decisions": 0}
        # dotted literals, as in the reference (its metrics lint treats
        # each literal as one family name)
        self._gauges = {
            "evictions_expired": scope.gauge("evictions.expired"),
            "evictions_window": scope.gauge("evictions.window"),
            "evictions_live": scope.gauge("evictions.live"),
            "drops": scope.gauge("drops"),
            "algo_resets": scope.gauge("algo_resets"),
            "decisions": scope.gauge("decisions"),
            "loss_ppm": scope.gauge("loss_ppm"),
            "live_slots": scope.gauge("live_slots"),
            "occupancy": scope.gauge("occupancy"),
        }

    def generate_stats(self) -> None:
        snap = self._engine.health_snapshot()
        for k in (
            "evictions_expired",
            "evictions_window",
            "evictions_live",
            "drops",
            "algo_resets",
            "decisions",
        ):
            self._gauges[k].set(snap[k])
        delta = {k: snap[k] - v for k, v in self._last.items()}
        self._last = {k: snap[k] for k in self._last}
        self._gauges["loss_ppm"].set(_loss_ppm(delta))
        self._gauges["live_slots"].set(snap["live_slots"])
        self._gauges["occupancy"].set(int(snap["occupancy"] * 1_000_000))


class HotkeyStats:
    """StatGenerator draining the heavy-hitter sketch on every stats flush
    (SlabDeviceEngine.drain_hotkeys: this generator is the drain cadence):

        ratelimit.hotkeys.tracked    occupied top-K entries the last drain
                                     reported (<= HOTKEY_K)
        ratelimit.hotkeys.top_count  the hottest key's estimate at drain time
        ratelimit.hotkeys.drains     cumulative drains

    The ranked entries ship via GET /debug/hotkeys."""

    def __init__(self, engine, scope):
        self._engine = engine
        self._g_tracked = scope.gauge("tracked")
        self._g_top = scope.gauge("top_count")
        self._c_drains = scope.counter("drains")
        self._drains_seen = 0

    def generate_stats(self) -> None:
        top = self._engine.drain_hotkeys()
        self._g_tracked.set(len(top))
        self._g_top.set(top[0][2] if top else 0)
        drains = self._engine._hotkey_drains
        self._c_drains.add(drains - self._drains_seen)
        self._drains_seen = drains


class CudaRateLimitCache:
    """limiter.RateLimitCache implementation backed by the CUDA slab."""

    def __init__(
        self,
        base_limiter: BaseRateLimiter,
        n_slots: int = 1 << 22,
        ways: int = 0,
        buckets: Sequence[int] = (128, 1024, 8192, 65536),
        device="cuda",
        hotkey_lanes: int = 0,
        hotkey_k: int = 16,
    ):
        self._base = base_limiter
        self._engine_core = SlabDeviceEngine(
            time_source=base_limiter.time_source,
            n_slots=n_slots,
            ways=ways,
            buckets=buckets,
            device=device,
            hotkey_lanes=hotkey_lanes,
            hotkey_k=hotkey_k,
        )
        # (domain, entries, divider) -> fingerprint, clear-on-full (the
        # do_limit path only; resolved records carry their fingerprint)
        self._fp_cache: dict = {}
        self._fp_cache_max = 1 << 17
        # per-thread reusable uint32[6, n] staging block of do_limit_resolved
        self._scratch = threading.local()
        # hotkeys witness: combined fp -> descriptor key prefix, recorded by
        # do_limit_resolved so /debug/hotkeys can name a drained
        # fingerprint; clear-on-full, None with the sketch off
        self._witness: dict | None = {} if self._engine_core.hotkeys_enabled else None
        self._witness_max = 1 << 15

    @property
    def engine(self):
        return self._engine_core

    def hotkeys_debug(self) -> dict:
        """The /debug/hotkeys document: the engine's last drained top-K,
        each fingerprint resolved to its descriptor key where the witness
        saw one composed (None otherwise)."""
        doc = self._engine_core.hotkeys_snapshot()
        witness = self._witness
        if witness is not None:
            for entry in doc["top"]:
                entry["key"] = witness.get(int(entry["fp"], 16))
        return doc

    def do_limit(
        self,
        request: RateLimitRequest,
        limits: Sequence[RateLimit | None],
    ) -> DoLimitResponse:
        hits_addend = max(1, request.hits_addend)
        cache_keys = self._base.generate_cache_keys(request, limits, hits_addend)

        n = len(request.descriptors)
        over_local = [False] * n
        results = [0] * n

        pending: list[tuple[int, int, int]] = []  # (desc idx, divider, jitter)
        for i, cache_key in enumerate(cache_keys):
            if cache_key.key == "":
                continue
            if self._base.is_over_limit_with_local_cache(cache_key.key, limits[i]):
                over_local[i] = True
                continue
            divider = unit_to_divider(limits[i].unit)
            jitter = self._base.expiration_seconds(divider) - divider
            pending.append((i, divider, jitter))

        fp_cache = self._fp_cache
        fps: list[int] = [0] * len(pending)
        miss_pos: list[int] = []
        miss_keys: list[tuple] = []
        miss_records = []
        miss_seeds: list[int] = []
        for pos, (i, divider, _jitter) in enumerate(pending):
            entries = request.descriptors[i].entries
            cache_key = (request.domain, entries, divider)
            fp = fp_cache.get(cache_key)
            if fp is None:
                miss_pos.append(pos)
                miss_keys.append(cache_key)
                miss_records.append((request.domain, entries))
                miss_seeds.append(divider)
            else:
                fps[pos] = fp
        if miss_records:
            if len(fp_cache) + len(miss_records) > self._fp_cache_max:
                fp_cache.clear()
            for pos, key, fp in zip(
                miss_pos, miss_keys, fingerprint_many(miss_records, miss_seeds)
            ):
                fps[pos] = fp_cache[key] = int(fp)

        # the wire divider carries the rule's algorithm id in bits 28-30 (0
        # for fixed_window), so the engine can refuse what it cannot serve
        items = [
            _Item(
                fp=fp,
                hits=hits_addend,
                limit=limits[i].requests_per_unit,
                divider=divider | (ALGORITHM_IDS[limits[i].algorithm] << ALGO_SHIFT),
                jitter=jitter,
            )
            for fp, (i, divider, jitter) in zip(fps, pending)
        ]
        afters = self._engine_core.submit(items)
        for after, (i, _d, _j) in zip(afters, pending):
            results[i] = after

        response = DoLimitResponse()
        for i, cache_key in enumerate(cache_keys):
            limit = limits[i]
            info = (
                LimitInfo(limit, results[i] - hits_addend, results[i])
                if limit is not None
                else None
            )
            key = cache_key.key
            if (
                key != ""
                and not over_local[i]
                and self._base.local_cache is not None
                and limit is not None
                and not limit.shadow_mode
                and results[i] > limit.requests_per_unit
            ):
                # the decision may have landed in a later window than `key`
                # was stamped with: re-stamp at the current clock
                key = generate_cache_key(
                    request.domain,
                    request.descriptors[i],
                    limit,
                    self._base.time_source.unix_now(),
                ).key
            response.descriptor_statuses.append(
                self._base.get_response_descriptor_status(
                    key, info, over_local[i], hits_addend, response
                )
            )
        assert_(len(response.descriptor_statuses) == n)
        return response

    def _scratch_block(self, n: int) -> np.ndarray:
        """This thread's reusable uint32[6, >=n] staging block."""
        block = getattr(self._scratch, "block", None)
        if block is None or block.shape[1] < n:
            block = self._scratch.block = np.empty((6, max(64, n)), dtype=np.uint32)
        return block

    def do_limit_resolved(self, request, resolved) -> DoLimitResponse:
        """The compiled-matcher path: one ResolvedLimit record per
        descriptor (config/compiled.py) instead of (limits, string keys,
        _Item objects). Per descriptor: the hit counter, the witness entry,
        the optional over-limit local-cache probe (key = precomputed prefix
        + window) and six uint32 column writes into this thread's scratch
        block; the request then submits as one row block. The same
        BaseRateLimiter oracle builds every status, so the decisions equal
        do_limit's."""
        base = self._base
        hits_addend = max(1, request.hits_addend)
        time_source = base.time_source
        now = time_source.unix_now()
        local_cache = base.local_cache
        n = len(resolved)
        block = self._scratch_block(n)
        pending_count = 0
        keys = [None] * n if local_cache is not None else None
        over_local: list[bool] | None = None
        witness = self._witness
        for i in range(n):
            rec = resolved[i]
            if rec is None:
                continue
            rec.stats.total_hits.add(hits_addend)
            if witness is not None:
                wfp = (rec.fp_hi << 32) | rec.fp_lo
                if wfp not in witness:
                    if len(witness) >= self._witness_max:
                        witness.clear()
                    witness[wfp] = rec.key_prefix
            divider = rec.divider
            if local_cache is not None:
                key = rec.key_prefix + str((now // divider) * divider)
                keys[i] = key
                # shadow rules and non-fixed algorithms never consult the
                # over-limit cache (base_limiter.is_over_limit_with_local_cache)
                if (
                    not rec.shadow_mode
                    and rec.algorithm == ALGO_ID_FIXED_WINDOW
                    and local_cache.contains(key)
                ):
                    if over_local is None:
                        over_local = [False] * n
                    over_local[i] = True
                    continue
            block[:, pending_count] = (
                rec.fp_lo,
                rec.fp_hi,
                hits_addend,
                rec.requests_per_unit,
                # window length + algorithm id in one word (== divider for
                # fixed_window); the engine refuses other algorithms
                rec.wire_divider,
                base.expiration_seconds(divider) - divider,
            )
            pending_count += 1

        afters = (
            self._engine_core.submit_rows(block[:, :pending_count]).tolist()
            if pending_count
            else ()
        )

        response = DoLimitResponse()
        statuses = response.descriptor_statuses
        get_status = base.get_response_descriptor_status
        pos = 0
        for i in range(n):
            rec = resolved[i]
            if rec is None:
                statuses.append(get_status("", None, False, hits_addend, response))
                continue
            limit = rec.limit
            if over_local is not None and over_local[i]:
                statuses.append(
                    get_status(
                        keys[i], LimitInfo(limit, -hits_addend, 0), True,
                        hits_addend, response,
                    )
                )
                continue
            after = afters[pos]
            pos += 1
            info = LimitInfo(limit, after - hits_addend, after)
            if local_cache is not None:
                key = keys[i]
                if not rec.shadow_mode and after > rec.requests_per_unit:
                    # the decision may have landed in a later window than
                    # the key was stamped with: re-stamp at the current clock
                    now2 = time_source.unix_now()
                    key = rec.key_prefix + str((now2 // rec.divider) * rec.divider)
            else:
                # without a local cache the key only marks "checked"
                key = rec.key_prefix
            statuses.append(get_status(key, info, False, hits_addend, response))
        assert_(len(statuses) == n)
        return response

    def flush(self) -> None:
        self._engine_core.flush()

    def close(self) -> None:
        self._engine_core.close()
