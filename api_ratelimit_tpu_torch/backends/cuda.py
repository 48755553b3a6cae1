"""Port of api_ratelimit_tpu/backends/tpu.py: the device engine and the cache.

BACKEND_TYPE=tpu becomes a CUDA engine. Descriptors are fingerprinted on the
host (ops/hashing.py), and one launch of the slab step (ops/slab.py
slab_step_after) runs the set scan, the duplicate-serialized INCRBY and the
row scatter against the device table. The device returns each item's
post-increment counter, saturating-cast to the narrowest dtype the batch's
limits allow, and the host derives code, remaining, throttle and the stats
split with the same BaseRateLimiter oracle every backend shares.

Every launch is split in two, as in the reference: the LAUNCH packs the
submitted row blocks into a pinned host operand, uploads it without blocking,
enqueues the step and a non-blocking readback into pinned memory, and records
a CUDA event after that readback; the COLLECT waits on that event and slices.
Three arms drive the split (TPU_BATCH_WINDOW, DISPATCH_LOOP):

    direct         window 0: each submit launches and collects under the
                   batcher's direct lock
    dispatch loop  window > 0, the default: one device-owner thread
                   (backends/dispatch.py) keeps two batches in flight, fed
                   by per-thread submit rings
    leader-collects window > 0, dispatch_loop=False: the micro-batcher
                   (backends/batcher.py) launches, the callers collect

With hotkey_lanes > 0 (HOTKEYS_ENABLED, the production default) every launch
also updates the heavy-hitter sketch (ops/sketch.py), which the stats
cadence drains (HotkeyStats); the cache's compiled-matcher path
(do_limit_resolved) records the witness keys that /debug/hotkeys resolves
fingerprints to, and after each drain the hot fingerprints (hot_fps) flag
the journeys of requests that touch a hot key (FLAG_HOTKEY). The cache's
lookups carry the active span's backend tag and events, and an over-limit
decision marks its algorithm's journey stage (ALGO_JOURNEY_STAGES). The
victim tier, leases, mesh engine and persistence wait for later slices.

Every algorithm is served (fixed window, sliding window, GCRA, concurrency
and its Release, do_release). The algorithm id rides bits 28-30 of the wire
divider. As in the reference, a sticky guard (algos_seen) keeps an all-fixed
deployment on the fixed-window program forever; the first launch carrying
another algorithm id, or a table imported with one, flips every later launch
to the multi-algorithm body (ops/slab.py multi_algo=True). A failed kernel
launch raises CacheError: the reference's fallback from Pallas to its XLA
twin has no counterpart here.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..assertx import assert_
from ..limiter.base_limiter import BaseRateLimiter, LimitInfo
from ..limiter.cache import CacheError
from ..limiter.cache_key import generate_cache_key
from ..models.config import (
    ALGO_ID_CONCURRENCY,
    ALGO_ID_FIXED_WINDOW,
    ALGORITHM_IDS,
    RateLimit,
)
from ..models.descriptors import RateLimitRequest
from ..models.response import DoLimitResponse
from ..models.units import unit_to_divider
from ..ops.hashing import fingerprint_many, split_fingerprints
from ..tracing import journeys, tag_do_limit_start
from ..ops.sketch import (
    make_sketch,
    sketch_decay,
    sketch_export_copy,
    sketch_import_planes,
    sketch_topk,
    sketch_ways,
)
from ..ops.slab import (
    ALGO_CONC_RELEASE,
    ALGO_SHIFT,
    HEALTH_ALGO_RESETS,
    HEALTH_DROPS,
    HEALTH_EVICT_EXPIRED,
    HEALTH_EVICT_LIVE,
    HEALTH_EVICT_WINDOW,
    HEALTH_WIDTH,
    PACKED_IN_ROWS,
    ROW_HITS,
    ROW_LIMIT,
    ROW_WIDTH,
    default_ways,
    live_slot_count,
    make_slab,
    resolve_device,
    slab_export_copy,
    slab_import_rows,
    slab_step_after,
    validate_ways,
)
from .batcher import MicroBatcher
from .dispatch import DispatchLoop

_log = logging.getLogger("ratelimit.backends.cuda")

# journey stage tags: which decision algorithm denied a request; the flight
# recorder shows them so a slow or shed journey names the algorithm it hit
# (tracing/journeys.py)
ALGO_JOURNEY_STAGES = {
    0: "algo_fixed_window",
    1: "algo_sliding_window",
    2: "algo_gcra",
    3: "algo_concurrency",
}


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


def validate_gcra_burst_ratio(ratio) -> float:
    """The GCRA burst ratio (GCRA_BURST_RATIO), validated as the
    reference's settings validate it: in (0, 16]. A zero ratio would deny
    everything and a huge one would never deny."""
    ratio = float(ratio)
    if not 0.0 < ratio <= 16.0:
        raise ValueError(f"GCRA_BURST_RATIO must be in (0, 16], got {ratio}")
    return ratio


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


class _HostFence:
    """A CPU engine's stand-in for a CUDA event: its launches run
    synchronously, so every fence has passed by the time it is recorded."""

    __slots__ = ()

    def record(self) -> None:
        pass

    def query(self) -> bool:
        return True

    def synchronize(self) -> None:
        pass


class _Operand:
    """One launch operand: a host int32[7, size] tensor (pinned on the
    card), its uint32 numpy view the pack writes, and the fence of the last
    launch that read it."""

    __slots__ = ("host", "array", "fence")

    def __init__(self, size: int, pin: bool):
        self.host = torch.zeros((PACKED_IN_ROWS, size), dtype=torch.int32, pin_memory=pin)
        self.array = self.host.numpy().view(np.uint32)
        self.fence = None


class _Launch(NamedTuple):
    """One launch in flight: the device result, the pinned host buffer its
    non-blocking readback fills, the fence recorded after that readback,
    and the count of live items."""

    device_out: torch.Tensor
    host_out: torch.Tensor
    fence: object
    n: int


class SlabDeviceEngine:
    """The device driver: owns the slab and the micro-batcher (and, in
    windowed mode, the dispatch loop), and turns row blocks into
    post-increment counters, one launch per bucket-sized chunk."""

    def __init__(
        self,
        time_source,
        n_slots: int = 1 << 22,
        ways: int = 0,
        buckets: Sequence[int] = (128, 1024, 8192, 65536),
        device="cuda",
        hotkey_lanes: int = 0,
        hotkey_k: int = 16,
        batch_window_seconds: float = 0.0,
        max_batch: int = 65536,
        dispatch_loop: bool = True,
        max_queue: int = 0,
        overload=None,
        fault_injector=None,
        scope=None,
        precompile: bool = False,
        gcra_burst_ratio: float = 1.0,
        watermark_high: float = 0.0,
    ):
        """ways: set associativity (SLAB_WAYS); 0 picks the platform's
        (128 on the card, 4 on the CPU). device: "cuda" (the default)
        raises without a card; "cpu" runs the kernels' plain versions.

        gcra_burst_ratio: GCRA's burst tolerance (GCRA_BURST_RATIO, in
        (0, 16]): tau = ratio x window - T, T = window / limit. Every
        launch carries it in scalar slot [6, 2] of its operand.

        hotkey_lanes: lanes of the heavy-hitter sketch (HOTKEY_LANES). 0
        disables it (the HOTKEYS_ENABLED=false arm): no sketch enters the
        launch, which is then exactly the sketch-free step. hotkey_k is the
        top-K size each drain reports (HOTKEY_K).

        batch_window_seconds: TPU_BATCH_WINDOW. 0 is direct mode; > 0
        coalesces concurrent submits into shared launches of at most
        max_batch items (TPU_BATCH_LIMIT). dispatch_loop (DISPATCH_LOOP,
        windowed mode only): True runs the device-owner dispatch loop,
        False the leader-collects micro-batcher.

        max_queue / overload / fault_injector: admission control for
        either arm (backends/batcher.py, backends/dispatch.py).

        scope: optional stats Scope rooted at the service prefix. When set
        the engine records <scope>.device.{pack_ms,launch_ms,readback_ms},
        hands <scope>.batcher to the micro-batcher and <scope> to the
        dispatch loop (<scope>.dispatch.*).

        precompile: warm every bucket and readback width at construction
        (see precompile()).

        watermark_high: slab-occupancy fraction in (0, 1]; 0 disables
        (SLAB_WATERMARK_HIGH). health_snapshot() compares the occupancy
        with it on the stats cadence; past it the degraded health probe
        raises (watermark_reason). Observability only: admission and the
        launch path are untouched, full sets evict by value."""
        self._time_source = time_source
        self._watermark_high = float(watermark_high)
        self._watermark_state = 0  # 0 normal / 1 high
        self._gcra_burst_ratio = validate_gcra_burst_ratio(gcra_burst_ratio)
        self._burst_bits = np.float32(self._gcra_burst_ratio).view(np.uint32)
        # the sticky algorithms guard: False keeps every launch on the
        # fixed-window program; the first launch (or imported table) with
        # another algorithm id flips it for good
        self._algos_seen = False
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
        # serializes every launch's state rebind (the sketch) and the
        # health list against the stats thread's drains; collects never
        # take it
        self._state_lock = threading.Lock()
        # heavy-hitter sketch: planes beside the slab, updated by every
        # launch, drained and halved on the stats cadence (drain_hotkeys)
        self._hotkey_k = max(1, int(hotkey_k))
        self._sketch: torch.Tensor | None = None
        self._sketch_ways = 0
        self._last_topk: list[tuple[int, int, int]] = []
        self._hotkey_drains = 0
        # combined fingerprints the last drain ranked hot (rebound whole by
        # each drain; the reference's drain listeners feed the mesh hot
        # tier and come with it, ROADMAP item 10)
        self._hot_fps: frozenset = frozenset()
        if int(hotkey_lanes) > 0:
            self._sketch_ways = sketch_ways(self._ways, hotkey_lanes)
            self._sketch = make_sketch(hotkey_lanes, self._device)
        # launch/collect plumbing: on the card the operand and the readback
        # live in pinned memory and every launch records a CUDA event after
        # its readback; the CPU runs synchronously behind host fences
        cuda = self._device.type == "cuda"
        self._pin = cuda
        self._new_fence = torch.cuda.Event if cuda else _HostFence
        self._cuda_index = (
            (self._device.index if self._device.index is not None else torch.cuda.current_device())
            if cuda
            else None
        )
        self._thread_bound = threading.local()
        # recent launch sizes (items per device launch): how much
        # coalescing the window buys
        self.launch_sizes: collections.deque = collections.deque(maxlen=4096)
        # per-bucket ping-pong pairs of operands (_packed_operand)
        self._operand_pool: dict = {}
        self._operand_lock = threading.Lock()
        self._h_pack = self._h_launch = self._h_readback = None
        batcher_scope = None
        if scope is not None:
            device_scope = scope.scope("device")
            self._h_pack = device_scope.histogram("pack_ms")
            self._h_launch = device_scope.histogram("launch_ms")
            self._h_readback = device_scope.histogram("readback_ms")
            batcher_scope = scope.scope("batcher")
        use_loop = bool(dispatch_loop) and batch_window_seconds > 0
        # the batcher's unit is a uint32[6, n] row block. With the dispatch
        # loop active no submit reaches it (its dispatcher thread never
        # starts); flush/drain/close still pass through. Its row ring copies
        # each windowed submit under the enqueue lock, so callers may reuse
        # a thread-local scratch block.
        self._batcher = MicroBatcher(
            self._execute_blocks,
            window_seconds=0.0 if use_loop else batch_window_seconds,
            max_batch=max_batch,
            execute_launch=self._execute_blocks_launch,
            execute_collect=self._execute_blocks_collect,
            block_mode=True,
            scope=batcher_scope,
            max_queue=max_queue,
            overload=overload,
            fault_injector=fault_injector,
            arena_rows=min(2 * int(max_batch), 1 << 17),
        )
        self._dispatch = None
        if use_loop:
            self._dispatch = DispatchLoop(
                self._execute_blocks_launch,
                self._execute_blocks_collect,
                ready=self._launch_ready,
                window_seconds=batch_window_seconds,
                max_batch=max_batch,
                scope=scope,
                overload=overload,
                fault_injector=fault_injector,
                max_queue=max_queue,
            )
        # (bucket, readback dtype name) -> True for every launch shape
        # warmed ahead of traffic
        self.precompiled: dict = {}
        if precompile:
            self.precompile()

    @property
    def device(self) -> torch.device:
        """Where the slab lives: a CUDA device, or the CPU (plain
        versions)."""
        return self._device

    @property
    def ways(self) -> int:
        return self._ways

    @property
    def algos_seen(self) -> bool:
        """The sticky algorithms guard: True once a launch or an imported
        table carried a non-fixed algorithm id; from then on every launch
        runs the multi-algorithm body."""
        return self._algos_seen

    @property
    def dispatch_loop(self):
        """The device-owner dispatch loop, or None (direct mode /
        dispatch_loop=False)."""
        return self._dispatch

    @property
    def batcher(self) -> MicroBatcher:
        return self._batcher

    # -- heavy-hitter sketch drain (stats cadence; ops/sketch.py) --

    @property
    def hotkeys_enabled(self) -> bool:
        return self._sketch is not None

    @property
    def hot_fps(self) -> frozenset:
        """Combined 64-bit fingerprints of the keys the last drain ranked
        hot: the request path's journey-flag probe (a frozenset read, no
        lock: drain_hotkeys rebinds it whole)."""
        return self._hot_fps

    def drain_hotkeys(self) -> list[tuple[int, int, int]]:
        """Pull the sketch planes to the host, rank the top-K, halve the
        counts and upload them again, under the state lock; then rebind
        hot_fps. Called on the stats cadence by
        HotkeyStats, never per launch."""
        if self._sketch is None:
            return []
        with self._state_lock:
            planes = sketch_export_copy(self._sketch)
            top = sketch_topk(planes, self._hotkey_k)
            self._sketch = sketch_import_planes(sketch_decay(planes), self._device)
        self._last_topk = top
        self._hot_fps = frozenset((hi << 32) | lo for lo, hi, _cnt in top)
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
        decisions denominator, occupancy, loss_ppm and the watermark
        state. live_slots is an O(n_slots) device reduction — call it on
        the stats cadence."""
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
        self._apply_watermark(snap)
        return snap

    def _apply_watermark(self, snap: dict) -> None:
        """Occupancy -> pressure flag (snap["watermark"]), logged on every
        transition, as the reference's _apply_watermarks."""
        high = self._watermark_high
        occ = snap["occupancy"]
        state = 1 if (high > 0 and occ >= high) else 0
        if state != self._watermark_state:
            _log.warning(
                "slab watermark state %d -> %d (occupancy %.3f)",
                self._watermark_state, state, occ,
            )
        self._watermark_state = state
        snap["watermark"] = state

    def watermark_reason(self) -> str | None:
        """HealthChecker degraded-probe contract: a reason string while the
        slab sits past the pressure watermark, else None."""
        if self._watermark_state:
            return (
                f"slab pressure: occupancy >= high watermark "
                f"{self._watermark_high:g}; sets evicting by value"
            )
        return None

    def precompile(self) -> dict:
        """Warm every launch shape before the first request: one
        all-padding launch (hits == 0) per bucket and readback width
        (u8/u16/u32) through the real path — operand pool, step, pinned
        readback of the whole padded bucket, collect. On the card this
        builds the kernel library, creates the CUDA context on this thread
        and allocates the pinned pools. Padding lanes write nothing
        (ops/slab.py: they go to the scratch row, and no sketch candidate
        has hits 0), so the slab and sketch bytes are unchanged. Returns
        the covered-shape map, also kept as `precompiled`."""
        # warm launches must not pollute the per-stage histograms
        saved = self._h_pack, self._h_launch, self._h_readback
        self._h_pack = self._h_launch = self._h_readback = None
        try:
            self._bind_thread()
            for bucket in self._buckets:
                for cap, name in ((0xFF, "uint8"), (0xFFFF, "uint16"), (0xFFFFFFFF, "uint32")):
                    op = self._packed_operand(bucket)
                    op.array[:] = 0
                    self._execute_blocks_collect([self._dispatch_packed(op, 0, cap)])
                    self.precompiled[(bucket, name)] = True
        finally:
            self._h_pack, self._h_launch, self._h_readback = saved
        return self.precompiled

    def submit_rows(self, block: np.ndarray) -> np.ndarray:
        """One uint32[6, n] row block (fp_lo, fp_hi, hits, limit, divider,
        jitter) -> uint32[n] post-increment counters. The caller may pass a
        reusable scratch block: the dispatch ring copies it, and when the
        batcher would keep it (no row ring), an owned copy decouples it
        here. Through the dispatch loop the result is a view of this
        thread's reusable ticket buffer, valid until its next submit."""
        if block.shape[1] == 0:
            return np.empty(0, dtype=np.uint32)
        if self._dispatch is not None:
            return self._dispatch.submit(block, reuse_out=True)
        wire = block
        if not self._batcher.consumes_submits:
            wire = np.array(block, dtype=np.uint32)
        return self._batcher.submit(wire)

    def export_tables(self) -> list[np.ndarray]:
        """Host copy of the slab, uint32[n_slots, 8], under the state lock;
        the copy orders after every launch already enqueued."""
        with self._state_lock:
            return [slab_export_copy(self._state)]

    def import_tables(self, tables: list[np.ndarray]) -> None:
        """Replace the slab with one host table, uint32[n_slots, 8] (the
        reference's restore upload, without the snapshot layer). Rows whose
        divider word carries a non-fixed algorithm id flip the guard before
        any launch sees them, as in the reference."""
        if len(tables) != 1:
            raise ValueError(f"single-device slab restores from 1 shard, got {len(tables)}")
        rows = np.asarray(tables[0], dtype=np.uint32)
        if rows.shape != (self._n_slots, ROW_WIDTH):
            raise ValueError(
                f"table shape {rows.shape} does not match the configured slab "
                f"({self._n_slots}, {ROW_WIDTH})"
            )
        if not self._algos_seen and int(rows[:, 5].max(initial=0)) >= (1 << ALGO_SHIFT):
            self._algos_seen = True
        with self._state_lock:
            self._state = slab_import_rows(rows, self._device)

    def flush(self) -> None:
        if self._dispatch is not None:
            self._dispatch.flush()
        self._batcher.flush()

    def drain(self) -> None:
        """Graceful-drain quiesce: refuse new submits, finish everything
        already queued (dispatch rings and/or batcher)."""
        if self._dispatch is not None:
            self._dispatch.drain()
        self._batcher.drain()

    def close(self) -> None:
        if self._dispatch is not None:
            self._dispatch.close()
        self._batcher.close()

    # -- device execution (the launching thread: owner, batcher, or the
    # direct-mode caller under the direct lock) --

    def _bind_thread(self) -> None:
        """Make the engine's card current on the launching thread (once
        per thread)."""
        if self._cuda_index is not None and not getattr(self._thread_bound, "done", False):
            torch.cuda.set_device(self._cuda_index)
            self._thread_bound.done = True

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self._max_bucket

    def _packed_operand(self, size: int) -> _Operand:
        """A (7, size) launch operand from the per-bucket ping-pong pair.
        The upload out of it is non-blocking, so before it is handed out
        for repacking this waits on the fence of the last launch that read
        it (two launches back on this bucket). Callers must zero the hits
        row's padding after filling."""
        with self._operand_lock:
            pair = self._operand_pool.get(size)
            if pair is None:
                pair = self._operand_pool[size] = [
                    _Operand(size, self._pin), _Operand(size, self._pin), 0,
                ]
            op = pair[pair[2]]
            pair[2] ^= 1
        if op.fence is not None:
            op.fence.synchronize()
        return op

    def _iter_block_chunks(self, blocks: list[np.ndarray]):
        """Yield (operand, n, cap) per max-bucket chunk of the submitted
        blocks. The common case (the total fits one launch) copies each
        block's columns straight into a pooled operand; an oversized
        aggregate is concatenated and cut into fresh operands. Padding
        lanes carry hits == 0, the only gate the device reads. The cap uses
        max(limit) + max(hits) over the chunk, so the saturating readback
        stays exact."""
        total = sum(b.shape[1] for b in blocks)
        if total <= self._max_bucket:
            op = self._packed_operand(self._bucket_for(total))
            packed = op.array
            off = 0
            for b in blocks:
                packed[:6, off : off + b.shape[1]] = b
                off += b.shape[1]
            packed[ROW_HITS, total:] = 0
            chunks = [(op, total)]
        else:
            cat = np.concatenate(blocks, axis=1)
            chunks = []
            for off in range(0, total, self._max_bucket):
                chunk = cat[:, off : off + self._max_bucket]
                n = chunk.shape[1]
                op = _Operand(self._bucket_for(n), self._pin)
                op.array[:6, :n] = chunk
                chunks.append((op, n))
        now = np.uint32(self._time_source.unix_now())
        for op, n in chunks:
            packed = op.array
            maxv = int(packed[ROW_HITS, :n].max()) + int(packed[ROW_LIMIT, :n].max())
            cap = 0xFF if maxv < 255 else 0xFFFF if maxv < 65535 else 0xFFFFFFFF
            packed[6, 0] = now
            packed[6, 2] = self._burst_bits  # GCRA's burst ratio (ops/slab.py)
            yield op, n, cap

    def _dispatch_packed(self, op: _Operand, n: int, cap: int) -> _Launch:
        """Enqueue one launch of the packed operand and its non-blocking
        readback; returns the _Launch the collect drains. launch_ms times
        this host-side phase, never the device execution (readback_ms
        carries the wait). n == 0 (precompile's warmers) reads back the
        whole padded bucket."""
        t_launch = time.perf_counter() if self._h_launch is not None else 0.0
        if n:  # precompile's warmers are not launches of traffic
            self.launch_sizes.append(n)
            if not self._algos_seen and int(op.array[4, :n].max()) >= (1 << ALGO_SHIFT):
                # the first non-fixed algorithm id: this launch and every
                # later one run the multi-algorithm body
                self._algos_seen = True
        dtype = np.uint8 if cap == 0xFF else np.uint16 if cap == 0xFFFF else np.uint32
        with self._state_lock:
            outs = slab_step_after(
                self._state, op.host, ways=self._ways, out_dtype=dtype,
                sketch=self._sketch, sketch_ways=self._sketch_ways,
                multi_algo=self._algos_seen,
            )
            if self._sketch is not None:
                after_dev, health, self._sketch = outs
            else:
                after_dev, health = outs
            wanted = after_dev[:n] if n else after_dev
            host_out = torch.empty(wanted.shape, dtype=wanted.dtype, pin_memory=self._pin)
            host_out.copy_(wanted, non_blocking=True)
            fence = self._new_fence()
            fence.record()
            op.fence = fence
            self._pending_health.append(health)
            self._decisions_total += n
            if len(self._pending_health) > 4096:
                self._drain_health_locked()
        if self._h_launch is not None:
            self._h_launch.record((time.perf_counter() - t_launch) * 1e3)
        return _Launch(after_dev, host_out, fence, n)

    def _launch_ready(self, tokens) -> bool:
        """Non-blocking readiness probe for a launch token (the dispatch
        loop's overlap decision): True once every chunk's readback has
        landed."""
        return all(t.fence.query() for t in tokens)

    def _collect_array(self, launch: _Launch) -> np.ndarray:
        """Blocking readback of one launch: wait on its fence, then an
        owned uint32 copy of its live items. readback_ms covers the wait
        for device completion plus the copy."""
        t0 = time.perf_counter() if self._h_readback is not None else 0.0
        launch.fence.synchronize()
        out = launch.host_out[: launch.n].numpy().astype(np.uint32)
        if self._h_readback is not None:
            self._h_readback.record((time.perf_counter() - t0) * 1e3)
        return out

    def _execute_blocks(self, blocks: list[np.ndarray]) -> np.ndarray:
        return self._execute_blocks_collect(self._execute_blocks_launch(blocks))

    def _execute_blocks_launch(self, blocks: list[np.ndarray]) -> list[_Launch]:
        self._bind_thread()
        try:
            if self._h_pack is None:
                return [
                    self._dispatch_packed(op, n, cap)
                    for op, n, cap in self._iter_block_chunks(blocks)
                ]
            t0 = time.perf_counter()
            chunks = list(self._iter_block_chunks(blocks))
            self._h_pack.record((time.perf_counter() - t0) * 1e3)
            return [self._dispatch_packed(op, n, cap) for op, n, cap in chunks]
        except (RuntimeError, ValueError) as e:
            raise CacheError(f"cuda backend failure: {e}") from e

    def _execute_blocks_collect(self, tokens: list[_Launch]) -> np.ndarray:
        try:
            outs = [self._collect_array(t) for t in tokens]
        except (RuntimeError, ValueError) as e:
            raise CacheError(f"cuda backend failure: {e}") from e
        return outs[0] if len(outs) == 1 else np.concatenate(outs)


class SlabHealthStats:
    """StatGenerator exporting the slab's health on every stats flush:

        ratelimit.slab.evictions.expired  reclaims of expired (TTL-dead) ways
        ratelimit.slab.evictions.window   evictions of live ways whose fixed
                                          window had ended
        ratelimit.slab.evictions.live     evictions of live in-window ways,
                                          the only lossy tier
        ratelimit.slab.drops       cumulative in-batch contention drops
        ratelimit.slab.algo_resets rows reset because their rule's algorithm
                                   changed (a matched row stored under
                                   another algorithm)
        ratelimit.slab.decisions   cumulative decisions submitted on-device
        ratelimit.slab.loss_ppm    (evictions.live + drops) per million
                                   decisions since the last flush
        ratelimit.slab.live_slots  currently live (unexpired) slots
        ratelimit.slab.occupancy   live fraction x 1e6
        ratelimit.slab.watermark   0 normal / 1 past SLAB_WATERMARK_HIGH
                                   (observability only)"""

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
            "watermark": scope.gauge("watermark"),
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
        self._gauges["watermark"].set(snap.get("watermark", 0))


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
        batch_window_seconds: float = 0.0,
        max_batch: int = 65536,
        dispatch_loop: bool = True,
        max_queue: int = 0,
        overload=None,
        fault_injector=None,
        stats_scope=None,
        precompile: bool = False,
        gcra_burst_ratio: float = 1.0,
        watermark_high: float = 0.0,
    ):
        """The engine's arguments pass through (SlabDeviceEngine);
        stats_scope becomes its `scope` and roots the per-algorithm decision
        counters <stats_scope>.algo.<name>.{decisions,over_limit}. A
        concurrency rule's idle TTL is the config loader's
        concurrency_ttl_s (config/loader.py), carried in its divider."""
        self._base = base_limiter
        self._engine_core = SlabDeviceEngine(
            time_source=base_limiter.time_source,
            n_slots=n_slots,
            ways=ways,
            buckets=buckets,
            device=device,
            hotkey_lanes=hotkey_lanes,
            hotkey_k=hotkey_k,
            batch_window_seconds=batch_window_seconds,
            max_batch=max_batch,
            dispatch_loop=dispatch_loop,
            max_queue=max_queue,
            overload=overload,
            fault_injector=fault_injector,
            scope=stats_scope,
            precompile=precompile,
            gcra_burst_ratio=gcra_burst_ratio,
            watermark_high=watermark_high,
        )
        # per-algorithm decision counters (do_limit_resolved): which
        # algorithm carries the traffic and which one denies it
        self._algo_stats = None
        if stats_scope is not None:
            algo_scope = stats_scope.scope("algo")
            self._algo_stats = {
                0: (
                    algo_scope.counter("fixed_window.decisions"),
                    algo_scope.counter("fixed_window.over_limit"),
                ),
                1: (
                    algo_scope.counter("sliding_window.decisions"),
                    algo_scope.counter("sliding_window.over_limit"),
                ),
                2: (
                    algo_scope.counter("gcra.decisions"),
                    algo_scope.counter("gcra.over_limit"),
                ),
                3: (
                    algo_scope.counter("concurrency.decisions"),
                    algo_scope.counter("concurrency.over_limit"),
                ),
            }
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
            # a concurrency rule has no unit: its idle TTL is its window
            # (config/compiled.py _make_record derives the same divider)
            divider = limits[i].window_override_s or unit_to_divider(limits[i].unit)
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

        span = tag_do_limit_start("cuda", len(limits), len(cache_keys))
        # the wire divider carries the rule's algorithm id in bits 28-30 (0
        # for fixed_window), as do_limit_resolved's records do
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
        if span is not None:
            span.log_kv(event="lookup.start", batch_items=len(items))
        try:
            afters = (
                self._engine_core.submit_rows(_items_to_block(items)).tolist() if items else ()
            )
        except Exception as e:
            # error-tag the span where the failure happened: a do_limit
            # driven without the service must not leave a clean-looking
            # span for a failed lookup
            if span is not None:
                span.set_error(e)
            raise
        for after, (i, _d, _j) in zip(afters, pending):
            results[i] = after
        if span is not None:
            span.log_kv(event="cuda.lookup.done", client="slab")

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
        """This thread's reusable uint32[6, >=n] staging block. Reusing it
        is safe only because the engine's submit_rows never keeps it: the
        dispatch ring and the batcher's row ring copy it, and without a
        ring submit_rows hands the batcher an owned copy."""
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
        span = tag_do_limit_start("cuda", n, n)
        block = self._scratch_block(n)
        pending_count = 0
        keys = [None] * n if local_cache is not None else None
        over_local: list[bool] | None = None
        # the witness and the hot-key journey probe (None and empty with
        # the sketch off)
        witness = self._witness
        hot_fps = self._engine_core.hot_fps if witness is not None else None
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
                if hot_fps and wfp in hot_fps:
                    # this request touched a key the sketch ranks hot
                    journeys.note_flag(journeys.FLAG_HOTKEY)
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
                # fixed_window)
                rec.wire_divider,
                base.expiration_seconds(divider) - divider,
            )
            pending_count += 1

        if span is not None:
            span.log_kv(event="lookup.start", batch_items=pending_count)
        try:
            afters = (
                self._engine_core.submit_rows(block[:, :pending_count]).tolist()
                if pending_count
                else ()
            )
        except Exception as e:
            # see do_limit: the exception path must error-tag the span
            if span is not None:
                span.set_error(e)
            raise
        if span is not None:
            span.log_kv(event="cuda.lookup.done", client="slab")

        response = DoLimitResponse()
        statuses = response.descriptor_statuses
        get_status = base.get_response_descriptor_status
        algo_stats = self._algo_stats
        pos = 0
        for i in range(n):
            rec = resolved[i]
            if rec is None:
                statuses.append(get_status("", None, False, hits_addend, response))
                continue
            limit = rec.limit
            if over_local is not None and over_local[i]:
                if algo_stats is not None:
                    dec_c, over_c = algo_stats[rec.algorithm]
                    dec_c.add(1)
                    over_c.add(1)
                statuses.append(
                    get_status(
                        keys[i], LimitInfo(limit, -hits_addend, 0), True,
                        hits_addend, response,
                    )
                )
                continue
            after = afters[pos]
            pos += 1
            if algo_stats is not None:
                dec_c, over_c = algo_stats[rec.algorithm]
                dec_c.add(1)
                if after > rec.requests_per_unit:
                    over_c.add(1)
                    # the algorithm that decided this denial, on the journey
                    journeys.mark(ALGO_JOURNEY_STAGES[rec.algorithm])
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

    def do_release(self, request, resolved) -> int:
        """Concurrency Release: one release row per resolved concurrency
        descriptor, on the same row-block wire as an acquire, with
        ALGO_CONC_RELEASE in its divider word; the device decrements the
        key's in-flight count, flooring at 0. Returns the number of release
        rows submitted; descriptors whose rule is not a concurrency cap are
        ignored. Holders that never release are covered by the row's idle
        TTL (the rule's divider): an untouched key's row is reclaimed and
        its count restarts at zero."""
        hits_addend = max(1, request.hits_addend)
        base = self._base
        block = self._scratch_block(len(resolved))
        count = 0
        for rec in resolved:
            if rec is None or rec.algorithm != ALGO_ID_CONCURRENCY:
                continue
            block[:, count] = (
                rec.fp_lo,
                rec.fp_hi,
                hits_addend,
                rec.requests_per_unit,
                rec.divider | (ALGO_CONC_RELEASE << ALGO_SHIFT),
                base.expiration_seconds(rec.divider) - rec.divider,
            )
            count += 1
        if count:
            self._engine_core.submit_rows(block[:, :count])
        return count

    def flush(self) -> None:
        self._engine_core.flush()

    def close(self) -> None:
        self._engine_core.close()
