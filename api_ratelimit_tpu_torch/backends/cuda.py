"""Port of api_ratelimit_tpu/backends/tpu.py: the device engine and the cache.

BACKEND_TYPE=tpu becomes a CUDA engine. Descriptors are fingerprinted on the
host (ops/hashing.py), and one launch of the slab step (ops/slab.py
slab_step_after) runs the set scan, the duplicate-serialized INCRBY and the
row scatter against the device table. The device returns each item's
post-increment counter, saturating-cast to the narrowest dtype the batch's
limits allow, and the host derives code, remaining, throttle and the stats
split with the same BaseRateLimiter oracle every backend shares.

This slice runs the reference's direct mode (TPU_BATCH_WINDOW=0) with
HOTKEYS_ENABLED=false: every submit is one serialized launch under the
state lock. The micro-batcher, dispatch loop, sketch, victim tier, leases,
mesh engine and persistence wait for later slices. The kernels cover
fixed-window rules only: a launch carrying any other algorithm id raises
CacheError instead of being served with the wrong semantics.
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
from ..models.config import ALGORITHM_IDS, RateLimit
from ..models.descriptors import RateLimitRequest
from ..models.response import DoLimitResponse
from ..models.units import unit_to_divider
from ..ops.hashing import fingerprint_many, split_fingerprints
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
    ):
        """ways: set associativity (SLAB_WAYS); 0 picks the platform's
        (128 on the card, 4 on the CPU). device: "cuda" (the default)
        raises without a card; "cpu" runs the kernels' plain versions."""
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

    @property
    def ways(self) -> int:
        return self._ways

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
                after_dev, health = slab_step_after(
                    self._state, packed, ways=self._ways, out_dtype=dtype
                )
                self._pending_health.append(health)
                self._decisions_total += n
                if len(self._pending_health) > 4096:
                    self._drain_health_locked()
            return after_dev[:n].cpu().numpy().astype(np.uint32)
        except (RuntimeError, ValueError) as e:
            raise CacheError(f"cuda backend failure: {e}") from e


class CudaRateLimitCache:
    """limiter.RateLimitCache implementation backed by the CUDA slab."""

    def __init__(
        self,
        base_limiter: BaseRateLimiter,
        n_slots: int = 1 << 22,
        ways: int = 0,
        buckets: Sequence[int] = (128, 1024, 8192, 65536),
        device="cuda",
    ):
        self._base = base_limiter
        self._engine_core = SlabDeviceEngine(
            time_source=base_limiter.time_source,
            n_slots=n_slots,
            ways=ways,
            buckets=buckets,
            device=device,
        )
        # (domain, entries, divider) -> fingerprint, clear-on-full
        self._fp_cache: dict = {}
        self._fp_cache_max = 1 << 17

    @property
    def engine(self):
        return self._engine_core

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

    def flush(self) -> None:
        self._engine_core.flush()

    def close(self) -> None:
        self._engine_core.close()
