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
Under the dispatch loop's `dispatch.batch` span (active while the owner
thread calls in, the tracer on) both record their phases as its children:
engine.operand_wait, engine.pack, engine.promote (victim tier on),
engine.step_enqueue and engine.readback_enqueue a device launch,
engine.fence_wait and engine.copy; the span gets the launch's
`device_launches`, `chunk_rows` and `clock_now`. device.step_enqueue_ms
times the slab step's enqueue alone, always.
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
warm-restart snapshotter (persist/) reads and restores the slab through
export_tables/import_tables.

With mesh= (TPU_MESH_DEVICES > 1) the engine delegates the slab to the
multi-device engine (parallel/sharded_slab.py ShardedSlabEngine): each launch
routes its rows to their owner shards on the host and launches every
shard's step, in the routed arm (SHARD_ROUTED_BATCHING, the default) or the
compact arm, with the hot-key tier (HOT_TIER_ENABLED) and the host top-K
(HostTopK) in place of the device sketch. As in the reference, the victim
tier is single-device (it is disabled on a mesh, with a warning), and a mesh
owner refuses the reshard merge (merge_rows).

With victim_max_rows > 0 (VICTIM_TIER_ENABLED) every launch reads back the
live in-window rows its way scan evicted (ops/slab.py slab_step_after
victim=True) into a host-RAM tier (backends/victim.py), and a key that
returns is promoted onto the slab ahead of its launch (slab_promote_rows),
counter intact. As in the reference the promote pass runs under the state
lock before the step, and the demote drain right after the launch, outside
the lock, so the next launch's promote pass finds this launch's demotes:
the tier-on arm waits on each launch's readback in the launch itself, and
only the tier-off arm overlaps a launch with the previous collect.

block_mode=True is the device-owner process's engine (cmd/sidecar_cmd.py,
backends/sidecar.py): its public verb is submit_block, which hands a wire
frame to the dispatch loop without an arena copy (or to the batcher, which
then keeps no row ring of its own), and submit_rows raises. The same
dispatch loop drains the shared-memory rings of other frontend processes
(backends/shm_ring.py).

Replication and the partitioned cluster (persist/replication.py, cluster/):
export_for_replication and apply_replicated are the warm standby's ship
export and promotion upload; export_route_range and merge_rows are the live
reshard's pull and push (the merge's export, host merge and upload all run
under the state lock, so no launch falls between the copy and the upload).
The uploads copy to the card or raise: there is no host fallback.
partition labels the dispatch loop's arena telemetry (partition_<k>).

Quota leasing (LEASE_ENABLED, backends/lease.py): the cache's lease table
plans a grant for a descriptor that missed the host-local answer, its row
carries hits + lease_n through the same launch, and the engine's
lease_registry records the liability the snapshotter persists (leases.snap).

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
import contextlib
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
    ALGO_ID_GCRA,
    ALGORITHM_IDS,
    RateLimit,
)
from ..models.descriptors import RateLimitRequest
from ..models.response import DoLimitResponse
from ..models.units import unit_to_divider
from ..ops.hashing import fingerprint_many, set_index, split_fingerprints
from ..tracing import active_span, journeys, tag_do_limit_start
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
    COL_EXPIRE,
    COL_FP_HI,
    COL_FP_LO,
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
    slab_export_device,
    slab_export_host,
    slab_import_rows,
    slab_promote_rows,
    slab_step_after,
    validate_ways,
)
from .batcher import MicroBatcher
from .dispatch import DispatchLoop
from .lease import LeaseOps, LeaseRegistry, apply_lease_ops
from .victim import VictimTier

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


def _owner_batch_span():
    """The dispatch loop's `dispatch.batch` span when the owner thread
    activated one around this call (the tracer on), else None: a request
    span active on a direct-mode caller's thread gets no engine children."""
    span = active_span()
    return span if span is not None and span.operation_name == "dispatch.batch" else None


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


class _MeshLaunch(NamedTuple):
    """One mesh launch: the mesh engine's token and the count of live
    items. Its shards' uploads are synchronous, so the operand is free when
    the launch returns, and the collect's readbacks wait for the shards."""

    token: dict
    n: int
    fence: object = _HostFence()


class _Launch(NamedTuple):
    """One launch in flight: the device result, the pinned host buffer its
    non-blocking readback fills, the fence recorded after that readback,
    and the count of live items. With the victim tier on the launch has
    already waited on its fence and drained its demotes."""

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
        victim_max_rows: int = 0,
        victim_watermark: float = 0.85,
        block_mode: bool = False,
        partition: int = -1,
        mesh=None,
        shard_routed_batching: bool = True,
        hot_tier_enabled: bool = True,
        hot_tier_salt_ways: int = 0,
    ):
        """ways: set associativity (SLAB_WAYS); 0 picks the platform's
        (128 on the card, 4 on the CPU). device: "cuda" (the default)
        raises without a card; "cpu" runs the kernels' plain versions.

        mesh: a parallel/sharded_slab.py Mesh, or a list of shard devices
        (TPU_MESH_DEVICES > 1: mesh_devices). The slab is then split over
        the shards (n_slots in all) and `device` is unused: the shards'
        devices are the mesh's. shard_routed_batching
        (SHARD_ROUTED_BATCHING) picks the routed arm (True) or the compact
        arm; hot_tier_enabled and hot_tier_salt_ways (HOT_TIER_ENABLED,
        HOT_TIER_SALT_WAYS) arm the hot-key tier; hotkey_lanes sizes the
        mesh engine's host top-K instead of a device sketch.

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
        either arm (backends/batcher.py, backends/dispatch.py). The
        injector (any object with fire(site) -> action) also serves the
        victim tier's victim.demote and victim.promote sites.

        victim_max_rows: row bound of the host-RAM victim tier
        (backends/victim.py; VICTIM_MAX_ROWS). 0 disables it (the
        VICTIM_TIER_ENABLED=false arm): every launch runs slab_step_after
        with victim=False, exactly the tier-less step. victim_watermark
        (VICTIM_WATERMARK) is the tier occupancy past which the sticky
        degraded probe raises (victim_watermark_reason).

        scope: optional stats Scope rooted at the service prefix. When set
        the engine records <scope>.device.{pack_ms,launch_ms,readback_ms},
        hands <scope>.batcher to the micro-batcher and <scope> to the
        dispatch loop (<scope>.dispatch.*).

        precompile: warm every bucket and readback width at construction
        (see precompile()).

        block_mode: the sidecar server's engine (the device-owner process):
        submit_block is the public verb, and submit_rows raises.

        partition: which cluster partition this owner serves (cluster/; -1
        unpartitioned). Labeling only: the dispatch loop exports its arena
        pressure under partition_<k> names too (backends/dispatch.py).

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
        # the multi-device engine (parallel/sharded_slab.py), or None
        self._engine = None
        if mesh is not None:
            from ..parallel.sharded_slab import ShardedSlabEngine

            self._engine = ShardedSlabEngine(
                mesh=mesh,
                n_slots_global=n_slots,
                ways=ways,
                routed=bool(shard_routed_batching),
                hot_tier=bool(hot_tier_enabled),
                hot_salt_ways=int(hot_tier_salt_ways),
                hotkey_lanes=int(hotkey_lanes),
                hotkey_k=int(hotkey_k),
            )
            self._device = self._engine.devices[0]
            self._ways = self._engine.ways
            self._state = None
        else:
            self._device = resolve_device(device)
            if not ways:
                ways = default_ways(self._device.type)
            self._ways = validate_ways(n_slots, ways)
            self._state = make_slab(n_slots, self._device)
        self._n_slots = n_slots
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
        # each drain): the journeys' hot-key flag, the victim tier's
        # demotion refusal and, through add_hotkey_listener, the lease
        # table's sizing
        self._hot_fps: frozenset = frozenset()
        # fn(top, fps) after every drain (add_hotkey_listener)
        self._hotkey_listeners: list = []
        if int(hotkey_lanes) > 0 and self._engine is None:
            # on a mesh the engine's host top-K takes the sketch's place
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
        # recent exports' (state lock held, host drain) in ms (export_tables)
        self.export_times: collections.deque = collections.deque(maxlen=64)
        # recent reshard merges' state-lock holds in ms (merge_rows)
        self.merge_times: collections.deque = collections.deque(maxlen=64)
        # per-bucket ping-pong pairs of operands (_packed_operand)
        self._operand_pool: dict = {}
        self._operand_lock = threading.Lock()
        self._h_pack = self._h_launch = self._h_readback = self._h_step = None
        batcher_scope = None
        if scope is not None:
            device_scope = scope.scope("device")
            self._h_pack = device_scope.histogram("pack_ms")
            self._h_launch = device_scope.histogram("launch_ms")
            self._h_readback = device_scope.histogram("readback_ms")
            self._h_step = device_scope.histogram("step_enqueue_ms")
            batcher_scope = scope.scope("batcher")
        self._block_batcher = bool(block_mode)
        # the native row-block gather (rl_pack_rows) for the pack stage;
        # None keeps the numpy per-block copies
        try:
            from ..ops import native

            self._pack_rows = native.pack_rows if native.available() else None
        except Exception:  # noqa: BLE001 - the codec is optional
            self._pack_rows = None
        use_loop = bool(dispatch_loop) and batch_window_seconds > 0
        # the batcher's unit is a uint32[6, n] row block. With the dispatch
        # loop active no submit reaches it (its dispatcher thread never
        # starts); flush/drain/close still pass through. Its row ring copies
        # each windowed submit under the enqueue lock, so callers may reuse
        # a thread-local scratch block; in block mode the sidecar's wire
        # frames are one-shot buffers and the batcher keeps them as they are.
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
            arena_rows=0 if block_mode else min(2 * int(max_batch), 1 << 17),
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
                partition=partition,
            )
        # host-RAM victim tier (backends/victim.py): where the launches'
        # live evictions drain and where the promote pass finds them. The
        # fault injector serves its victim.demote / victim.promote sites.
        self._fault = fault_injector
        self._victim = None
        self._victim_lock = threading.Lock()
        # sketch-hot rows never demote: a hot row caught in a live
        # eviction parks here and re-enters on the very next launch
        self._promote_pending: dict = {}
        self._victim_hot_refusals = 0
        self._victim_demote_errors = 0
        self._victim_promote_skips = 0
        # recent demote drains' host ms (wait on the readback, absorb)
        self.victim_drain_times: collections.deque = collections.deque(maxlen=4096)
        if int(victim_max_rows) > 0:
            if self._engine is not None:
                _log.warning("victim tier is single-device only; disabled on the mesh-sharded engine")
            else:
                self._victim = VictimTier(int(victim_max_rows), float(victim_watermark), time_source)
        # the lease liability registry (backends/lease.py): always built,
        # inert until lease traffic arrives; the snapshotter persists it
        # as leases.snap so a warm restart never grants twice
        self.lease_registry = LeaseRegistry(time_source)
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
    def mesh_engine(self):
        """The multi-device engine (parallel/sharded_slab.py), or None."""
        return self._engine

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
        if self._engine is not None:
            return self._engine.hotkeys_enabled
        return self._sketch is not None

    @property
    def hot_fps(self) -> frozenset:
        """Combined 64-bit fingerprints of the keys the last drain ranked
        hot: the request path's journey-flag probe (a frozenset read, no
        lock: drain_hotkeys rebinds it whole)."""
        if self._engine is not None:
            return self._engine.hot_fps
        return self._hot_fps

    def add_hotkey_listener(self, fn) -> None:
        """fn(top, fps) called after every drain with the fresh top-K
        [(fp_lo, fp_hi, count)] and its combined-fp frozenset: the lease
        table's sizing hook (backends/lease.py note_hot_fps)."""
        if self._engine is not None:
            self._engine.add_hotkey_listener(fn)
            return
        self._hotkey_listeners.append(fn)

    def drain_hotkeys(self) -> list[tuple[int, int, int]]:
        """Pull the sketch planes to the host, rank the top-K, halve the
        counts and upload them again, under the state lock; then rebind
        hot_fps and call the listeners. Called on the stats cadence by
        HotkeyStats, never per launch. On a mesh the engine's host top-K
        drains (it also feeds the hot tier), and the drain count follows
        the engine's."""
        if self._engine is not None:
            top = self._engine.drain_hotkeys()
            self._hotkey_drains = self._engine._hotkey_drains
            return top
        if self._sketch is None:
            return []
        with self._state_lock:
            planes = sketch_export_copy(self._sketch)
            top = sketch_topk(planes, self._hotkey_k)
            self._sketch = sketch_import_planes(sketch_decay(planes), self._device)
        self._last_topk = top
        self._hot_fps = frozenset((hi << 32) | lo for lo, hi, _cnt in top)
        self._hotkey_drains += 1
        for fn in self._hotkey_listeners:
            try:
                fn(top, self._hot_fps)
            except Exception:  # noqa: BLE001 - a listener must not break stats
                _log.exception("hotkey listener failed")
        return top

    def hotkeys_snapshot(self) -> dict:
        """The last drained top-K as a debug document (/debug/hotkeys
        without key resolution; the cache layer adds witness keys)."""
        if self._engine is not None:
            return self._engine.hotkeys_snapshot()
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
        if self._engine is not None:
            snap = self._engine.health_snapshot(now)
            with self._state_lock:
                snap["decisions"] = self._decisions_total
            snap["loss_ppm"] = _loss_ppm(snap)
            self._apply_watermark(snap)
            return snap
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
        the covered-shape map, also kept as `precompiled`. A mesh engine is
        skipped, as in the reference: its shards' blocks take the routing's
        own rungs."""
        if self._engine is not None:
            _log.info("precompile: the mesh engine's shards take their own rungs")
            return self.precompiled
        # warm launches must not pollute the per-stage histograms
        saved = self._h_pack, self._h_launch, self._h_readback, self._h_step
        self._h_pack = self._h_launch = self._h_readback = self._h_step = None
        try:
            self._bind_thread()
            for bucket in self._buckets:
                for cap, name in ((0xFF, "uint8"), (0xFFFF, "uint16"), (0xFFFFFFFF, "uint32")):
                    op = self._packed_operand(bucket)
                    op.array[:] = 0
                    self._execute_blocks_collect([self._dispatch_packed(op, 0, cap)])
                    self.precompiled[(bucket, name)] = True
        finally:
            self._h_pack, self._h_launch, self._h_readback, self._h_step = saved
        return self.precompiled

    @contextlib.contextmanager
    def launches_quiesced(self):
        """A context in which no launch is in flight or enqueued: the state
        lock, under which every launch, promote pass and export enqueues,
        held, and the card synchronized. The debug server starts and stops
        its profiler inside it (server/http_server.py capture_device_trace:
        a session started while a launch races it records no kernel). On
        a mesh the shards launch under the mesh engine's own state lock
        (_dispatch_packed), so its quiesced() is held as well."""
        with self._state_lock:
            if self._engine is not None:
                with self._engine.quiesced():
                    yield
                return
            if self._device.type == "cuda":
                torch.cuda.synchronize(self._device)
            yield

    def profile_slab_split(self, scope=None, batch: int | None = None, iters: int = 30) -> dict:
        """The `slab_split` stage baseline: times the slab step's three
        stages — the W-way set GATHER, the SCAN (the way scan kernel on the
        card), the one-row-per-way SCATTER — as the standalone callables of
        ops/slab.py make_split_programs over this engine's geometry, at
        `batch` items (default min(largest bucket, 8192), the reference's).
        Runs against a detached device copy of the table (taken under the
        state lock), so the live slab and counters are untouched. On the
        card each sample is timed with CUDA events around the call, on the
        CPU with the host clock. When `scope` is given every sample also
        lands in <scope>.split.{gather,scan,scatter}_ms histograms, which
        tools/hotpath_profile.py reports from, so the printed baseline and
        /metrics cannot disagree. Returns {batch, gather_ns, scan_ns,
        scatter_ns} (per-launch medians); {} on a mesh engine, as in the
        reference."""
        if self._engine is not None:
            return {}
        from ..ops.slab import make_split_programs

        b = int(batch or min(self._max_bucket, 8192))
        gather, scan, scatter = make_split_programs(self._ways)
        with self._state_lock:
            rows = self._state.rows.clone()
        table = rows[: self._n_slots]
        dev = self._device
        rng = np.random.default_rng(7)

        def i32(size):
            host = rng.integers(0, 1 << 32, size=size, dtype=np.uint64).astype(np.uint32)
            return torch.from_numpy(host.view(np.int32)).to(dev)

        fp_lo, fp_hi = i32(b), i32(b)
        now = int(self._time_source.unix_now())
        hists = {}
        if scope is not None:
            split_scope = scope.scope("split")
            hists = {
                "gather": split_scope.histogram("gather_ms"),
                "scan": split_scope.histogram("scan_ms"),
                "scatter": split_scope.histogram("scatter_ms"),
            }
        cuda = dev.type == "cuda"

        def timed(name, fn) -> int:
            fn()  # build + warm
            if cuda:
                torch.cuda.synchronize(dev)
            samples = []
            for _ in range(iters):
                if cuda:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    fn()
                    end.record()
                    end.synchronize()
                    ms = start.elapsed_time(end)
                else:
                    t0 = time.perf_counter()
                    fn()
                    ms = (time.perf_counter() - t0) * 1e3
                samples.append(ms)
                if name in hists:
                    hists[name].record(ms)
            return round(float(np.median(samples)) * 1e6)

        result = {"batch": b}
        result["gather_ns"] = timed("gather", lambda: gather(table, fp_lo))
        result["scan_ns"] = timed("scan", lambda: scan(table, fp_lo, fp_hi, now))
        # unique write targets (the step has one winning writer per slot);
        # lanes past the table go to the scratch row, as padding lanes do
        idx = np.full(b, self._n_slots, dtype=np.int64)
        k = min(b, self._n_slots)
        idx[:k] = rng.permutation(self._n_slots)[:k]
        write_idx = torch.from_numpy(idx).to(dev)
        new_rows = i32((b, ROW_WIDTH))
        result["scatter_ns"] = timed("scatter", lambda: scatter(rows, write_idx, new_rows))
        return result

    @property
    def block_mode(self) -> bool:
        """The sidecar server routes wire payloads through submit_block
        when this is True."""
        return self._block_batcher

    def submit_block(self, block: np.ndarray) -> np.ndarray:
        """uint32[n] post-increment counters of one uint32[6, n] wire block
        (fp_lo, fp_hi, hits, limit, divider, jitter): the sidecar server's
        verb. The block is a one-shot buffer, so the dispatch loop takes it
        without an arena copy, and the result is an array the caller owns.
        Requires block_mode=True."""
        if not self._block_batcher:
            raise RuntimeError("engine not in block_mode")
        if self._dispatch is not None:
            return self._dispatch.submit(block, owned=True)
        return self._batcher.submit(block)

    def submit_rows(self, block: np.ndarray, lease_ops=None) -> np.ndarray:
        """One uint32[6, n] row block (fp_lo, fp_hi, hits, limit, divider,
        jitter) -> uint32[n] post-increment counters. The caller may pass a
        reusable scratch block: the dispatch ring copies it, and when the
        batcher would keep it (no row ring), an owned copy decouples it
        here. Through the dispatch loop the result is a view of this
        thread's reusable ticket buffer, valid until its next submit.

        lease_ops: optional backends.lease.LeaseOps riding this submit:
        grants registered against the liability registry with the rows'
        post-increment counters as floors, settles applied. The grants'
        INCRBY is already in the hits column; this is the host-side
        bookkeeping."""
        if self._block_batcher:
            raise RuntimeError("engine is in block_mode; use submit_block")
        if block.shape[1] == 0:
            return np.empty(0, dtype=np.uint32)
        if self._dispatch is not None:
            afters = self._dispatch.submit(block, reuse_out=True)
        else:
            wire = block
            if not self._batcher.consumes_submits:
                wire = np.array(block, dtype=np.uint32)
            afters = self._batcher.submit(wire)
        if lease_ops is not None:
            self.apply_lease_ops(block, afters, lease_ops)
        return afters

    def apply_lease_ops(self, block, afters, ops) -> None:
        """Register riding lease grants and settles (backends/lease.py)
        against this engine's liability registry."""
        apply_lease_ops(
            self.lease_registry, block, afters, ops, int(self._time_source.unix_now())
        )

    def _launch(self, items: list[_Item]) -> list[int]:
        """One synchronous launch of an _Item list (tests and tools), through
        the block executors like everything else."""
        return self._execute_blocks([_items_to_block(items)]).tolist()

    # -- victim tier: demote drain and promote pass (backends/victim.py) --

    @property
    def victim_enabled(self) -> bool:
        return self._victim is not None

    @property
    def victim_tier(self):
        """The VictimTier, or None: the snapshotter's victim.snap hook."""
        return self._victim

    def _drain_victim(self, rows: np.ndarray) -> None:
        """Absorb one launch's demote readback (host uint32[b, ROW_WIDTH],
        sorted order, non-demoted lanes zero) into the tier, outside the
        state lock (the tier has its own). A live row always carries a TTL,
        so the filter is COL_EXPIRE != 0."""
        rows = rows[rows[:, COL_EXPIRE] != 0]
        if not rows.shape[0]:
            return
        if self._fault is not None:
            action = self._fault.fire("victim.demote")
            if action == "drop":
                return  # the rows vanish: the chaos arm's loss
            if action == "error":
                # fail open as a live eviction without the tier does: the
                # counters are lost, but counted; serving goes on
                self._victim_demote_errors += 1
                return
        self._absorb_demoted(rows)

    def _absorb_demoted(self, rows: np.ndarray) -> None:
        """Route demoted rows: sketch-hot keys to the re-inject queue (a
        hot key's next launch is now), the rest into the bounded tier."""
        hot = self._hot_fps
        if hot:
            combined = (rows[:, COL_FP_HI].astype(np.uint64) << np.uint64(32)) | rows[
                :, COL_FP_LO
            ].astype(np.uint64)
            mask = np.fromiter((int(fp) in hot for fp in combined), bool, rows.shape[0])
            hot_rows = rows[mask]
            if hot_rows.shape[0]:
                self._victim_hot_refusals += int(hot_rows.shape[0])
                with self._victim_lock:
                    for r in hot_rows:
                        self._promote_pending[(int(r[COL_FP_LO]), int(r[COL_FP_HI]))] = r.copy()
            rows = rows[~mask]
        if rows.shape[0]:
            self._victim.insert(rows, int(self._time_source.unix_now()))

    def _inject_promotes_locked(self, packed: np.ndarray, n: int) -> None:
        """The promote pass before a step, under the state lock: any of
        this launch's fingerprints found in the tier (and every parked hot
        row) re-enters the slab through slab_promote_rows, so the step that
        follows sees the resumed row. A row the promote displaces comes
        back in `displaced` and demotes again: nothing is lost either way.
        The rows are padded to the bucket ladder, as in the reference."""
        tier = self._victim
        if tier is None or n == 0:
            return
        with self._victim_lock:
            pending = list(self._promote_pending.values())
        if not tier.rows and not pending:
            return
        if self._fault is not None:
            action = self._fault.fire("victim.promote")
            if action in ("drop", "error"):
                # skip the pass: the rows stay in the tier (promotion
                # retries forever; the key misses until the site heals)
                self._victim_promote_skips += 1
                return
        hits = tier.lookup_batch(packed[0, :n], packed[1, :n])
        n_hits = 0 if hits is None else hits.shape[0]
        if not n_hits and not pending:
            return
        parts = ([hits] if n_hits else []) + ([np.stack(pending)] if pending else [])
        rows = parts[0] if len(parts) == 1 else np.concatenate(parts)
        k = rows.shape[0]
        size = max(self._bucket_for(k), k)
        padded = np.zeros((size, ROW_WIDTH), dtype=np.uint32)
        padded[:k] = rows
        landed_dev, displaced_dev = slab_promote_rows(
            self._state, padded, int(packed[6, 0]), ways=self._ways
        )
        landed = landed_dev[:k].cpu().numpy()
        if n_hits:
            tier.retire(rows[:n_hits], landed[:n_hits])
        if pending:
            with self._victim_lock:
                for row, ok in zip(pending, landed[n_hits:].tolist()):
                    if ok:
                        self._promote_pending.pop((int(row[COL_FP_LO]), int(row[COL_FP_HI])), None)
        displaced = displaced_dev.cpu().numpy()
        displaced = displaced[displaced[:, COL_EXPIRE] != 0]
        if displaced.shape[0]:
            self._absorb_demoted(displaced)

    def _victim_doc(self, reclaim: bool) -> dict:
        tier = self._victim
        if tier is None:
            return {"enabled": False}
        now = int(self._time_source.unix_now())
        if reclaim:
            tier.reclaim(now)
        snap = tier.describe(now)
        snap["enabled"] = True
        snap["hot_refusals"] = self._victim_hot_refusals
        snap["demote_errors"] = self._victim_demote_errors
        snap["promote_skips"] = self._victim_promote_skips
        with self._victim_lock:
            snap["pending_hot"] = len(self._promote_pending)
        return snap

    def victim_snapshot(self) -> dict:
        """Tier health for the stats tree (VictimStats, which is the
        tier's reclamation cadence): the TTL/window reclaim, then occupancy
        and counters."""
        return self._victim_doc(reclaim=True)

    def victim_debug(self) -> dict:
        """The GET /debug/victim document: victim_snapshot without the
        reclaim (a debug poll must not advance the tier)."""
        return self._victim_doc(reclaim=False)

    def victim_watermark_reason(self) -> str | None:
        """HealthChecker degraded-probe contract for the tier watermark."""
        if self._victim is None:
            return None
        return self._victim.watermark_reason()

    # -- warm restart (persist/): the snapshotter's export/import --

    @property
    def shard_count(self) -> int:
        """Snapshot shard layout: one file a shard (one for the
        single-device slab)."""
        if self._engine is not None:
            return self._engine.shard_count
        return 1

    @property
    def shard_slots(self) -> int:
        """Rows per snapshot shard (the restore-time topology check)."""
        if self._engine is not None:
            return self._engine.shard_slots
        return self._n_slots

    def shard_routing_snapshot(self) -> dict:
        """The mesh engine's routing mix (parallel/sharded_slab.py
        shard_routing_snapshot); {"enabled": False} on one device, so the
        runner registers no ratelimit.shard.* gauges."""
        if self._engine is None:
            return {"enabled": False}
        return self._engine.shard_routing_snapshot()

    def export_tables(self) -> list[np.ndarray]:
        """Quiesce-and-copy for the snapshotter: host copy of the slab,
        uint32[n_slots, 8]. Under the state lock only a device-side clone
        is enqueued; every launching thread (caller, batcher, dispatch
        owner) launches on its device's default stream, so the clone
        orders after every launch already enqueued. The drain to the host
        runs against the clone after the lock is released, so launches
        never wait on it. Each export's lock hold and drain (ms) go to
        export_times. On a mesh, one table a shard (the mesh engine's
        export, which holds its own state lock for the clones only)."""
        if self._engine is not None:
            return self._engine.export_tables()
        with self._state_lock:
            t1 = time.perf_counter()
            copy, ready = slab_export_device(self._state)
        t2 = time.perf_counter()
        table = slab_export_host(copy, ready)
        self.export_times.append(((t2 - t1) * 1e3, (time.perf_counter() - t2) * 1e3))
        return [table]

    def import_tables(self, tables: list[np.ndarray]) -> None:
        """Boot-time restore upload: replace the slab with one host table,
        uint32[n_slots, 8] (persist/snapshotter.py validated the layout and
        reconciled the rows). Rows whose divider word carries a non-fixed
        algorithm id flip the guard before any launch sees them, as in the
        reference. Every launch reads self._state under the state lock and
        nothing else holds the table, so the first launch after this reads
        the restored rows. On a mesh, one table a shard."""
        if self._engine is not None:
            self._engine.import_tables(tables)
            if self._engine.algos_seen:
                self._algos_seen = True
            return
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

    # -- the partitioned cluster (cluster/): reshard streaming --

    def export_route_range(self, lo: int, hi: int, route_sets: int) -> np.ndarray:
        """Occupied rows whose ROUTE INDEX, set_index(fp_lo, route_sets) at
        the cluster map's resolution (ops/hashing.py, the split the router
        buckets by), falls in [lo, hi): the reshard PULL. Rides the same
        export the snapshotter and the replication ship loop use, so
        launches never wait on the drain. Returns a flat (n, ROW_WIDTH) row
        array (placement-free: the receiving owner re-places the rows by
        its own geometry)."""
        if route_sets <= 0 or route_sets & (route_sets - 1):
            raise ValueError(f"route_sets must be a power of two, got {route_sets}")
        if not 0 <= lo < hi <= route_sets:
            raise ValueError(f"route range [{lo}, {hi}) outside [0, {route_sets})")
        tables = self.export_tables()
        flat = tables[0] if len(tables) == 1 else np.concatenate(tables)
        route = set_index(flat[:, 0], route_sets)
        mask = flat.any(axis=1) & (route >= lo) & (route < hi)
        return np.ascontiguousarray(flat[mask])

    def merge_rows(self, rows: np.ndarray) -> dict:
        """The reshard PUSH: merge streamed rows into the live slab by
        fingerprint, keep-the-newest (persist/snapshot.py
        merge_rows_into_table: the greater window wins, equal windows keep
        the greater count), so a stage-then-drain double delivery converges
        upward instead of rolling an admission back. The export, the host
        merge and the upload all run UNDER the state lock: launches queue
        behind it for the merge's duration, and in exchange no increment
        can fall between the copy and the upload. Rows carrying a non-fixed
        algorithm flip the sticky guard. Each merge's lock hold (ms) goes to
        merge_times. Returns the merge stats dict."""
        from ..persist.snapshot import merge_rows_into_table

        rows = np.asarray(rows, dtype=np.uint32)
        if rows.size and rows.shape[1] != ROW_WIDTH:
            raise ValueError(f"merge rows must be (n, {ROW_WIDTH}), got {rows.shape}")
        if self._engine is not None:
            raise CacheError(
                "mesh-sharded owners do not support in-place reshard merge; "
                "reshard a mesh partition via snapshot/restore"
            )
        with self._state_lock:
            t0 = time.perf_counter()
            table = slab_export_copy(self._state)
            merged, stats = merge_rows_into_table(table, rows, self._ways)
            if not self._algos_seen and int(merged[:, 5].max(initial=0)) >= (1 << ALGO_SHIFT):
                # streamed rows may carry non-fixed algorithms: flip the
                # guard before they reach the fixed-window program
                self._algos_seen = True
            self._state = slab_import_rows(merged, self._device)
            self.merge_times.append((time.perf_counter() - t0) * 1e3)
        return stats

    # -- warm-standby replication (persist/replication.py) --

    def export_for_replication(self) -> tuple[list[np.ndarray], np.ndarray, int]:
        """One export for the replication ship loop: the slab table (the
        snapshotter's export: a device clone under the state lock, drained
        after it) plus the live lease-liability rows, stamped with one
        clock read so the standby reconciles slab and liabilities against
        the same instant."""
        tables = self.export_tables()
        now = int(self._time_source.unix_now())
        return tables, self.lease_registry.export_rows(now), now

    def apply_replicated(self, tables: list[np.ndarray], lease_rows: np.ndarray) -> None:
        """Promotion upload: replace the slab with the reconciled replica
        tables (the coordinator already ran reconcile_rows and the lease
        floors) and re-seed the liability registry: the same two moves as
        the warm-restart boot restore."""
        self.import_tables(tables)
        self.lease_registry.import_rows(lease_rows)

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

    def _iter_block_chunks(self, blocks: list[np.ndarray], span=None):
        """Yield (operand, n, cap) per max-bucket chunk of the submitted
        blocks. The common case (the total fits one launch) copies each
        block's columns straight into a pooled operand; an oversized
        aggregate is concatenated and cut into fresh operands. Padding
        lanes carry hits == 0, the only gate the device reads. The cap uses
        max(limit) + max(hits) over the chunk, so the saturating readback
        stays exact. Several blocks gather through the native codec's
        rl_pack_rows when it is built. With the owner's batch `span` it
        records engine.operand_wait (the pooled operand's fence) and, once
        exhausted, engine.pack (`fresh_operands`: chunks allocated outside
        the pool), and tags the span's `clock_now`."""
        t0 = time.monotonic_ns() if span is not None else 0
        fresh = 0
        total = sum(b.shape[1] for b in blocks)
        if total <= self._max_bucket:
            op = self._packed_operand(self._bucket_for(total))
            if span is not None:
                t1 = time.monotonic_ns()
                span.tracer.record_span("engine.operand_wait", span, t0, t1)
                t0 = t1
            packed = op.array
            if self._pack_rows is not None and len(blocks) > 1:
                self._pack_rows(blocks, packed, total)
            else:
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
            fresh = len(chunks)
        now = np.uint32(self._time_source.unix_now())
        if span is not None:
            span.set_tag("clock_now", int(now))
        for op, n in chunks:
            packed = op.array
            maxv = int(packed[ROW_HITS, :n].max()) + int(packed[ROW_LIMIT, :n].max())
            cap = 0xFF if maxv < 255 else 0xFFFF if maxv < 65535 else 0xFFFFFFFF
            packed[6, 0] = now
            packed[6, 2] = self._burst_bits  # GCRA's burst ratio (ops/slab.py)
            yield op, n, cap
        if span is not None:
            span.tracer.record_span("engine.pack", span, t0, time.monotonic_ns(),
                                     {"fresh_operands": fresh})

    def _dispatch_packed(self, op: _Operand, n: int, cap: int, span=None) -> _Launch:
        """Enqueue one launch of the packed operand and its non-blocking
        readback; returns the _Launch the collect drains. launch_ms times
        this host-side phase, never the device execution (readback_ms
        carries the wait), step_enqueue_ms the slab step's enqueue in it.
        n == 0 (precompile's warmers) reads back the whole padded bucket.
        With the owner's batch `span` it records engine.promote (victim
        tier on), engine.step_enqueue, engine.readback_enqueue and the
        victim drain's engine.fence_wait."""
        t_launch = time.perf_counter() if self._h_launch is not None else 0.0
        if n:  # precompile's warmers are not launches of traffic
            self.launch_sizes.append(n)
            if not self._algos_seen and int(op.array[4, :n].max()) >= (1 << ALGO_SHIFT):
                # the first non-fixed algorithm id: this launch and every
                # later one run the multi-algorithm body
                self._algos_seen = True
                if self._engine is not None:
                    self._engine.note_algos_seen()
        if self._engine is not None:
            # owner routing and the shards' launches; counted after the
            # launch returns, so a failed launch adds no decision
            token = self._engine.launch_after_compact(op.array, cap)
            op.fence = None
            with self._state_lock:
                self._decisions_total += n
            if self._h_launch is not None:
                self._h_launch.record((time.perf_counter() - t_launch) * 1e3)
            return _MeshLaunch(token, n)
        dtype = np.uint8 if cap == 0xFF else np.uint16 if cap == 0xFFFF else np.uint32
        victim = self._victim is not None
        timed = span is not None or self._h_step is not None
        with self._state_lock:
            # the promote pass rides before the step, so a demoted key's
            # launch already sees its restored counter
            t_promote = time.monotonic_ns() if span is not None else 0
            self._inject_promotes_locked(op.array, n)
            t_step = time.monotonic_ns() if timed else 0
            outs = slab_step_after(
                self._state, op.host, ways=self._ways, out_dtype=dtype,
                sketch=self._sketch, sketch_ways=self._sketch_ways,
                multi_algo=self._algos_seen, victim=victim,
            )
            t_read = time.monotonic_ns() if timed else 0
            if victim:
                # the demote readback rides last (after the sketch); its
                # padding lanes sort last, so the first n lanes hold every
                # demote in the same sorted order
                *outs, victim_dev = outs
                victim_dev = victim_dev[:n] if n else victim_dev
                victim_host = torch.empty(victim_dev.shape, dtype=victim_dev.dtype, pin_memory=self._pin)
                victim_host.copy_(victim_dev, non_blocking=True)
            if self._sketch is not None:
                after_dev, health, self._sketch = outs
            else:
                after_dev, health = outs
            wanted = after_dev[:n] if n else after_dev
            host_out = torch.empty(wanted.shape, dtype=wanted.dtype, pin_memory=self._pin)
            host_out.copy_(wanted, non_blocking=True)
            fence = self._new_fence()
            fence.record()
            t_end = time.monotonic_ns() if span is not None else 0
            op.fence = fence
            self._pending_health.append(health)
            self._decisions_total += n
            if len(self._pending_health) > 4096:
                self._drain_health_locked()
        if self._h_step is not None:
            self._h_step.record((t_read - t_step) / 1e6)
        if span is not None:
            if victim:
                span.tracer.record_span("engine.promote", span, t_promote, t_step)
            span.tracer.record_span("engine.step_enqueue", span, t_step, t_read)
            span.tracer.record_span("engine.readback_enqueue", span, t_read, t_end)
        if victim:
            # the demote drain, outside the state lock and before the next
            # launch can start its promote pass (the reference's order)
            t0 = time.perf_counter()
            self._wait_fence(fence, span)
            t1 = time.perf_counter()
            self._drain_victim(victim_host.numpy())
            self.victim_drain_times.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
        if self._h_launch is not None:
            self._h_launch.record((time.perf_counter() - t_launch) * 1e3)
        return _Launch(after_dev, host_out, fence, n)

    def _launch_ready(self, tokens) -> bool:
        """Non-blocking readiness probe for a launch token (the dispatch
        loop's overlap decision): True once every chunk's readback has
        landed."""
        return all(t.fence.query() for t in tokens)

    def _wait_fence(self, fence, span) -> int:
        """fence.synchronize(), engine.fence_wait under the owner's batch
        `span`. Returns its end, time.monotonic_ns()."""
        w0 = time.monotonic_ns()
        fence.synchronize()
        w1 = time.monotonic_ns()
        if span is not None:
            span.tracer.record_span("engine.fence_wait", span, w0, w1)
        return w1

    def _collect_array(self, launch: _Launch, span=None) -> np.ndarray:
        """Blocking readback of one launch: wait on its fence, then an
        owned uint32 copy of its live items. readback_ms covers the wait
        for device completion plus the copy. With the owner's batch `span`
        it records engine.fence_wait and engine.copy (a mesh launch's
        collect records neither)."""
        t0 = time.perf_counter() if self._h_readback is not None else 0.0
        if isinstance(launch, _MeshLaunch):
            out = self._engine.collect_after_compact(launch.token)[: launch.n]
        else:
            w1 = self._wait_fence(launch.fence, span)
            out = launch.host_out[: launch.n].numpy().astype(np.uint32)
            if span is not None:
                span.tracer.record_span("engine.copy", span, w1, time.monotonic_ns())
        if self._h_readback is not None:
            self._h_readback.record((time.perf_counter() - t0) * 1e3)
        return out

    def _execute_blocks(self, blocks: list[np.ndarray]) -> np.ndarray:
        return self._execute_blocks_collect(self._execute_blocks_launch(blocks))

    def _execute_blocks_launch(self, blocks: list[np.ndarray]) -> list[_Launch]:
        self._bind_thread()
        span = _owner_batch_span()
        try:
            if self._h_pack is None and span is None:
                return [
                    self._dispatch_packed(op, n, cap)
                    for op, n, cap in self._iter_block_chunks(blocks)
                ]
            t0 = time.perf_counter()
            chunks = list(self._iter_block_chunks(blocks, span))
            if self._h_pack is not None:
                self._h_pack.record((time.perf_counter() - t0) * 1e3)
            if span is not None:
                span.set_tag("device_launches", len(chunks))
                span.set_tag("chunk_rows", [n for _, n, _ in chunks])
            return [self._dispatch_packed(op, n, cap, span) for op, n, cap in chunks]
        except (RuntimeError, ValueError) as e:
            raise CacheError(f"cuda backend failure: {e}") from e

    def _execute_blocks_collect(self, tokens: list[_Launch]) -> np.ndarray:
        span = _owner_batch_span()
        try:
            outs = [self._collect_array(t, span) for t in tokens]
        except (RuntimeError, ValueError) as e:
            raise CacheError(f"cuda backend failure: {e}") from e
        if len(outs) == 1:
            return outs[0]
        t0 = time.monotonic_ns() if span is not None else 0
        out = np.concatenate(outs)
        if span is not None:
            span.tracer.record_span("engine.copy", span, t0, time.monotonic_ns())
        return out


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


class VictimStats:
    """StatGenerator exporting the victim tier on every stats flush
    (SlabDeviceEngine.victim_snapshot — this generator IS the tier's
    TTL/window reclamation cadence, like HotkeyStats is the sketch
    drain):

        ratelimit.victim.rows            rows currently parked in the tier
        ratelimit.victim.demotes         cumulative demoted live rows
                                         absorbed from eviction readbacks
        ratelimit.victim.promotes        cumulative rows promoted back
                                         onto the slab (retired landed)
        ratelimit.victim.hot_refusals    sketch-hot rows that refused
                                         demotion (parked for next-launch
                                         re-inject instead)
        ratelimit.victim.reclaimed       rows dropped by TTL/window-aware
                                         reclamation (dead state, not loss)
        ratelimit.victim.overflow_drops  value-ranked losses past
                                         VICTIM_MAX_ROWS — the tier's ONLY
                                         lossy behavior
        ratelimit.victim.overflow_lost_count_sum
                                         sum of the counter values those
                                         drops forgot — the ledger the
                                         differential false-admit bound
                                         is stated against
                                         (tests/test_torch_victim.py)
        ratelimit.victim.watermark       0 normal / 1 past VICTIM_WATERMARK
                                         (sticky degraded probe mirror)

    The full document (age histogram, capacity, fault-site counters)
    ships via GET /debug/victim; this exports the alarmable envelope."""

    def __init__(self, engine, scope):
        self._engine = engine
        self._gauges = {
            "rows": scope.gauge("rows"),
            "demotes": scope.gauge("demotes"),
            "promotes": scope.gauge("promotes"),
            "hot_refusals": scope.gauge("hot_refusals"),
            "reclaimed": scope.gauge("reclaimed"),
            "overflow_drops": scope.gauge("overflow_drops"),
            "overflow_lost_count_sum": scope.gauge("overflow_lost_count_sum"),
            "watermark": scope.gauge("watermark"),
        }

    def generate_stats(self) -> None:
        snap = self._engine.victim_snapshot()
        if not snap.get("enabled"):
            return
        for k, g in self._gauges.items():
            if k == "watermark":
                g.set(snap.get("watermark_state", 0))
            else:
                g.set(snap.get(k, 0))


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
        victim_max_rows: int = 0,
        victim_watermark: float = 0.85,
        lease_table=None,
        engine=None,
        mesh=None,
        shard_routed_batching: bool = True,
        hot_tier_enabled: bool = True,
        hot_tier_salt_ways: int = 0,
    ):
        """The engine's arguments pass through (SlabDeviceEngine; mesh= and
        the shard knobs build the multi-device engine);
        stats_scope becomes its `scope` and roots the per-algorithm decision
        counters <stats_scope>.algo.<name>.{decisions,over_limit}. A
        concurrency rule's idle TTL is the config loader's
        concurrency_ttl_s (config/loader.py), carried in its divider.

        engine: an engine built by the caller (a SlabDeviceEngine, or a
        device owner's backends/sidecar.py SidecarEngineClient: submit_rows,
        flush and close), in place of the one these arguments would build.

        lease_table: optional backends.lease.LeaseTable (LEASE_ENABLED).
        do_limit_resolved then plans a lease grant for each descriptor that
        missed the host-local answer: its row carries hits + lease_n
        through the same launch, the returned counter registers the lease,
        and the caller's own decision uses after - lease_n. Queued settles
        ride the same submits. Only an engine whose submit_rows takes
        lease_ops leases, as in the reference."""
        self._base = base_limiter
        if engine is not None:
            self._engine_core = engine
        else:
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
                victim_max_rows=victim_max_rows,
                victim_watermark=victim_watermark,
                mesh=mesh,
                shard_routed_batching=shard_routed_batching,
                hot_tier_enabled=hot_tier_enabled,
                hot_tier_salt_ways=hot_tier_salt_ways,
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
        engine = self._engine_core
        self._witness: dict | None = {} if getattr(engine, "hotkeys_enabled", False) else None
        self._witness_max = 1 << 15
        # quota leasing: only engines with the row verb carry grant riders
        self._lease = lease_table if hasattr(engine, "submit_rows") else None
        # each sketch drain pre-sizes the lease table for the ranked-hot
        # keys, so a hot key's first grant of a window is already large
        if self._witness is not None and self._lease is not None:
            engine.add_hotkey_listener(lambda _top, fps: self._lease.note_hot_fps(fps))

    @property
    def engine(self):
        return self._engine_core

    def victim_debug(self) -> dict:
        """The /debug/victim document: the engine's tier snapshot, or
        {"enabled": False} for an engine without a tier."""
        fn = getattr(self._engine_core, "victim_debug", None)
        if fn is None:
            return {"enabled": False}
        return fn()

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
        lease = self._lease
        grants: list | None = None
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
            if lease is not None:
                # the lease grant rider: this descriptor missed the
                # host-local answer, so its row carries the lease's INCRBY,
                # hits + lease_n through the same launch
                planned = lease.plan_grant(rec, hits_addend, now)
                if planned is not None:
                    block[2, pending_count] = hits_addend + planned.size
                    if grants is None:
                        grants = []
                    grants.append((pending_count, planned))
            pending_count += 1

        lease_ops = None
        settles = ()
        if lease is not None and pending_count:
            settles = lease.drain_settles()
            if grants or settles:
                lease_ops = LeaseOps(
                    grants=[(pos, p.size, p.window, p.ttl_s) for pos, p in grants or ()],
                    settles=settles,
                )

        if span is not None:
            span.log_kv(event="lookup.start", batch_items=pending_count)
        try:
            if not pending_count:
                afters = ()
            elif lease_ops is not None:
                afters = self._engine_core.submit_rows(
                    block[:, :pending_count], lease_ops=lease_ops
                ).tolist()
            else:
                afters = self._engine_core.submit_rows(block[:, :pending_count]).tolist()
        except Exception as e:
            if settles:
                # the settles never reached the card's owner: requeue them
                # for the next submit (advisory, TTL-bounded)
                lease.requeue_settles(settles)
            if grants:
                # riders whose answer was lost: release the in-flight marks
                # so the next miss can plan a fresh grant
                for _pos, planned in grants:
                    lease.abort_grant(planned)
            # see do_limit: the exception path must error-tag the span
            if span is not None:
                span.set_error(e)
            raise
        if grants:
            # install each granted lease and strip its rider from the
            # caller's own post-increment position (after - lease_n)
            for pos, planned in grants:
                after_total = afters[pos]
                if (int(block[4, pos]) >> ALGO_SHIFT) == ALGO_ID_GCRA and after_total > int(
                    block[3, pos]
                ):
                    # a denied GCRA rider reserved nothing (a denial never
                    # advances the TAT): abort, the next miss plans afresh
                    lease.abort_grant(planned)
                    afters[pos] = after_total - planned.size
                else:
                    afters[pos] = lease.register_grant(planned, after_total)
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
