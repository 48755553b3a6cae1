"""Port of api_ratelimit_tpu/backends/dispatch.py: the persistent
device-owner dispatch loop (DISPATCH_LOOP, default on in windowed mode).

  * ONE device-owner thread runs a continuous launch -> redeem cycle with
    two batches in flight: while batch k's readback drains, batch k+1 is
    already packed and submitted. Every device launch and readback lives on
    this thread, so frontend threads never contend for launch state.

  * Frontend threads feed it through SUBMIT RINGS: one single-producer /
    single-consumer ring per frontend thread, carrying the uint32[6, n] row
    block plus a ticket. Publishing is a row copy into the ring's
    preallocated arena and a seqno store: no queue lock and no condition
    variable on the hot path (a per-ring mutex exists solely for the close
    handshake and is never taken by the consumer).

  * The caller parks on its per-thread reusable ticket until the owner
    scatters the batch's verdicts back (the native codec's rl_scatter_rows
    when built, numpy slice copies otherwise) and sets the ticket event.

  * Frontend PROCESSES feed it too: a shared-memory ring
    (backends/shm_ring.py ShmRingConsumer) speaks the same slot protocol,
    is attached by the shm control server (attach_ring), drained by the
    same take, and detached when its producer process dies
    (detach_rings). The sidecar server hands its one-shot wire frames over
    without an arena copy (submit(owned=True)).

Admission parity with the leader-collects arm (backends/batcher.py): the
same 'batcher.submit' fault site and brownout shed run before any ring work,
OVERLOAD_MAX_QUEUE bounds the summed ring backlog with QueueFullError,
deadline-expired frames are dropped at ring take time (before packing), and
queue wait feeds the same AdmissionController EWMA. The owner thread also
consults the 'dispatch.launch' fault site before each launch ('error' fails
the batch; the injector stalls for delay actions). The injector is any
object with fire(site) -> action.

Telemetry (scope `dispatch`): ring_wait_ms (publish -> take), launch_ms
(pack + asynchronous dispatch), redeem_ms (blocking readback + verdict
scatter), batch_size, and queue_depth / inflight / arena gauges on the
stats-flush cadence.

Tracing: the request span's context rides the ring in a fixed-width
trace-context row beside the frame (trace id hi/lo, span id, flags: four
uint64 words, the same words a cross-process ring carries in its slot
record), since contextvars do not cross into the owner thread. While the
global tracer is enabled the owner opens one `dispatch.batch` span per
launch, linked (followsFrom) to every request span it coalesced (none when
no frame carried a context: the port departs from the reference there),
gives the ring-wait, launch and redeem histograms a trace-id exemplar in
their slow bucket, and hands the owner-side stage timestamps (take, pack,
launch, redeem, scatter) back on the ticket: the caller merges them into
its journey and closes its request span with
dispatch.{ring_wait,pack,launch,redeem} child spans.

The batch span is the public record of the owner's cycle: tags
`device_launches`, `chunk_rows`, `clock_now` (set by the engine) and
`owner_cpu_us` (the owner thread's CPU time over the span; on a host whose
thread CPU clock ticks coarsely, 10 ms in some sandboxes, it reads 0 or a
tick's multiple, and only sums over many spans mean something). A launch
that no request span is linked to opens its batch span unsampled, so the
owner's own record never crowds sampled requests out of a tracer's buffer;
a profiling session keeps it (RecordingTracer(keep_unsampled=True)). Its
children are recorded after the fact from time.monotonic_ns() stamps taken
where the work happens, in cycle order and never overlapping:
dispatch.wait (the idle wait before the take; with launches in flight, the
empty take and the wait on the oldest one's readiness), dispatch.linger,
dispatch.take, the engine's (engine.operand_wait, engine.pack,
engine.promote, engine.step_enqueue, engine.readback_enqueue,
engine.fence_wait, engine.copy: backends/cuda.py reads the batch span
through active_span(), which the owner activates around its calls into the
engine), dispatch.scatter, and dispatch.turn (from the scatter's end to
the owner's next stamp, where the span closes: the way back round the
loop, behind the frontends the scatter woke). Every span's epoch start
goes through the process's one anchor (tracing/tracer.py epoch_s), the
clock torch.profiler stamps its timeline in. With the tracer off a cycle
costs one `enabled` check: no span, stamp list or _PreStamps. Always on,
like the other histograms: dispatch.cycle_ms (the owner's wall time from
one take to the next), dispatch.offcpu_ms (that wall time less the owner
thread's CPU time and less its parking on the work event, _note_cycle) and
dispatch.wake_ms (an in-process frame's ticket resolve to its submitter
running again).

DISPATCH_PROFILE=1 (read once, when the loop is built) runs the owner
thread's loop under the standard library's profile module, whose
sys.setprofile hook records that thread alone, and keeps it on the
instance (`_profile`) for tools/hotpath_profile.py --dispatch to print
after close(). The reference enables cProfile in the thread, which on
Python 3.12 records every thread of the process (sys.monitoring), so its
"owner" table mixes in the request threads; ROADMAP "Deliberate
departures".

ShardRoutingStats exports the mesh engine's routing mix
(parallel/sharded_slab.py shard_routing_snapshot) as ratelimit.shard.*.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque

import numpy as np

from ..limiter.cache import CacheError, DeadlineExceededError
from ..tracing import SpanContext, activate, active_span, global_tracer, journeys
from ..utils.deadline import current_deadline
from .overload import BrownoutError, QueueFullError

logger = logging.getLogger("ratelimit.dispatch")

_MASK64 = 0xFFFFFFFFFFFFFFFF
# ctx row flags (uint64 word 3): bit 0 = context present, bit 1 = sampled
_CTX_PRESENT = 1
_CTX_SAMPLED = 2

# shared with MicroBatcher so one fault spec rehearses both arms
FAULT_SITE_SUBMIT = "batcher.submit"
# owner-thread site: fires before each device launch
FAULT_SITE_LAUNCH = "dispatch.launch"

MAX_INFLIGHT = 2  # launches in flight: the double buffer
RING_SLOTS = 128  # frames per submit ring
RING_ROWS = 4096  # arena rows per submit ring


class _Ticket:
    """One outstanding submit: the frontend thread parks here until the
    owner thread writes the frame's verdicts into `buf` and sets the event.
    One ticket per frontend thread, reused across submits (the thread blocks
    on the result, so it never has two outstanding)."""

    __slots__ = ("event", "buf", "n", "error", "fresh", "stage_ns", "resolved_ns")

    def __init__(self):
        self.event = threading.Event()
        self.buf = np.empty(64, dtype=np.uint32)
        self.n = 0
        self.error: BaseException | None = None
        # fresh=True scatters into a NEW array the caller owns; False
        # reuses this ticket's buffer (valid until the thread's next submit)
        self.fresh = True
        # owner-thread stage timestamps (take, pack, launch, redeem,
        # scatter) in monotonic ns, set before resolve() when journeys or
        # tracing are on
        self.stage_ns: tuple | None = None
        # the owner's time.monotonic_ns() at resolve(): the submitter's
        # wake latency (dispatch.wake_ms)
        self.resolved_ns = 0

    def reserve(self, n: int) -> np.ndarray:
        if self.fresh:
            self.buf = np.empty(n, dtype=np.uint32)
        elif self.buf.shape[0] < n:
            self.buf = np.empty(max(n, 2 * self.buf.shape[0]), dtype=np.uint32)
        self.n = n
        return self.buf

    def resolve(self) -> None:
        self.resolved_ns = time.monotonic_ns()
        self.event.set()

    def fail(self, error: BaseException) -> None:
        self.error = error
        self.event.set()

    def redeem(self) -> np.ndarray:
        self.event.wait()
        if self.error is not None:
            raise self.error
        return self.buf[: self.n]


class SubmitRing:
    """Single-producer (one frontend thread) / single-consumer (the owner
    thread) frame ring. The producer copies its row block into the ring's
    arena (an owned copy when the contiguous arena space is exhausted),
    stores the frame in its slot, and publishes by advancing `tail`. The
    consumer drains `head..tail` and frees arena space by advancing the
    cumulative `rows_out` AFTER the pack copied the rows into the launch
    operand. Every index is written by exactly one thread, so nothing more
    than CPython's sequentially consistent attribute stores is needed;
    `lock` guards only the close handshake and is never taken by the
    consumer. A slot holds (rows, count, deadline, enq, ticket,
    arena_used); the frame's span identity sits in `ctx[slot]`."""

    __slots__ = (
        "slots", "mask", "arena", "ctx", "cursor", "tail", "head", "rows_in",
        "rows_out", "items_in", "items_out", "lock", "closed", "ticket",
        "overflow_count", "arena_hwm", "dead",
    )

    def __init__(self, slots: int = RING_SLOTS, arena_rows: int = RING_ROWS):
        if slots & (slots - 1):
            raise ValueError(f"ring slots must be a power of two, got {slots}")
        self.slots: list = [None] * slots
        self.mask = slots - 1
        self.arena = np.empty((6, arena_rows), dtype=np.uint32)
        # arena pressure telemetry (producer-only writes), aggregated by
        # DispatchStats into dispatch.arena_overflow / ring.arena_hwm
        self.overflow_count = 0
        self.arena_hwm = 0
        # shm parity: the owner skips rings whose producer process died
        # (ShmRingConsumer flips this on control-socket EOF); in-process
        # rings never die apart from the loop
        self.dead = False
        # the trace-context row of each slot (trace_id hi/lo, span_id,
        # flags), written before the frame publishes; flags == 0 (the
        # untraced case) is one scalar store
        self.ctx = np.zeros((slots, 4), dtype=np.uint64)
        self.cursor = 0  # producer arena write position
        self.tail = 0  # producer-only: frames published
        self.head = 0  # consumer-only: frames consumed
        self.rows_in = 0  # producer-only: cumulative arena rows claimed
        self.rows_out = 0  # consumer-only: cumulative arena rows released
        self.items_in = 0  # producer-only: cumulative items published
        self.items_out = 0  # consumer-only: cumulative items consumed
        self.lock = threading.Lock()
        self.closed = False
        self.ticket = _Ticket()

    @property
    def depth(self) -> int:
        """Items published but not yet taken (racy read; admission/stats)."""
        return self.items_in - self.items_out

    def publish(self, block: np.ndarray, count: int, deadline, enq: float,
                ticket: _Ticket, owned: bool = False, ctx=None) -> None:
        """Copy `count` columns of `block` in and publish one frame.
        owned=True hands the block over without a copy (one-shot sidecar
        wire frames). ctx: optional (trace_hi, trace_lo, span_id, flags)
        span identity, written to the ctx row before the frame publishes.
        Raises QueueFullError when the slot ring is full: overflow must
        shed, never corrupt."""
        tail = self.tail
        if tail - self.head > self.mask:
            raise QueueFullError(
                f"dispatch ring full ({self.mask + 1} frames pending)"
            )
        arena_used = 0
        arena_rows = self.arena.shape[1]
        cursor = self.cursor
        waste = 0
        if cursor + count > arena_rows:
            waste = arena_rows - cursor  # skip the tail remainder
            cursor = 0
        free = arena_rows - (self.rows_in - self.rows_out)
        if owned:
            rows = block
        elif count <= arena_rows and waste + count <= free:
            rows = self.arena[:, cursor : cursor + count]
            rows[...] = block[:, :count]
            self.cursor = cursor + count
            arena_used = waste + count
            self.rows_in += arena_used
            used_rows = self.rows_in - self.rows_out
            if used_rows > self.arena_hwm:
                self.arena_hwm = used_rows
        else:
            # arena exhausted under sustained backlog: decouple from the
            # caller's scratch with an owned copy, counted
            self.overflow_count += 1
            rows = np.array(block[:, :count], dtype=np.uint32)
        idx = tail & self.mask
        if ctx is not None:
            self.ctx[idx] = ctx
        else:
            self.ctx[idx, 3] = 0
        with self.lock:
            if self.closed:
                raise CacheError("dispatch loop is closed")
            self.slots[idx] = (rows, count, deadline, enq, ticket, arena_used)
            self.items_in += count
            self.tail = tail + 1


class DispatchStats:
    """StatGenerator exporting the loop's instantaneous backlog at every
    stats flush / metrics scrape:

        <scope>.queue_depth     items published to rings awaiting a take
        <scope>.inflight        launches not yet redeemed
        <scope>.arena_overflow  frames that missed the ring arena (owned
                                copy)
        <scope>.ring.arena_hwm  high-water mark of arena rows in use across
                                every ring

    Partitioned owners (cluster/; DispatchLoop(partition=k)) also export the
    arena pair under a partition-labeled name, <scope>.partition_<k>.
    arena_overflow and <scope>.ring.partition_<k>.arena_hwm, so ring
    pressure is attributable to the partition whose keyspace makes it (the
    flat names keep aggregating)."""

    def __init__(self, loop: "DispatchLoop", scope):
        self._loop = loop
        self._queue_depth = scope.gauge("queue_depth")
        self._inflight = scope.gauge("inflight")
        self._arena_overflow = scope.counter("arena_overflow")
        self._arena_hwm = scope.gauge("ring.arena_hwm")
        self._overflow_seen = 0
        self._p_overflow = self._p_hwm = None
        part = getattr(loop, "partition", -1)
        if part >= 0:
            self._p_overflow = scope.counter(f"partition_{part}.arena_overflow")
            self._p_hwm = scope.gauge(f"ring.partition_{part}.arena_hwm")

    def generate_stats(self) -> None:
        self._queue_depth.set(self._loop.queue_depth)
        self._inflight.set(self._loop.inflight)
        overflow, hwm = self._loop.arena_pressure()
        if overflow > self._overflow_seen:
            if self._p_overflow is not None:
                self._p_overflow.add(overflow - self._overflow_seen)
            self._arena_overflow.add(overflow - self._overflow_seen)
            self._overflow_seen = overflow
        self._arena_hwm.set(hwm)
        if self._p_hwm is not None:
            self._p_hwm.set(hwm)


class ShardRoutingStats:
    """StatGenerator for the mesh engine's routed dispatch
    (parallel/sharded_slab.py; SHARD_ROUTED_BATCHING, HOT_TIER_ENABLED):

        <scope>.padding_waste_pct  integer percent of launched lanes that
                                   were padding since boot (flat under
                                   routing, high when one shard's bucket
                                   pads every other)
        <scope>.launches           mesh launches dispatched
        <scope>.rows               real (non-padding) rows routed
        <scope>.rows.shard_<d>     the same, per owner shard
        <scope>.hot_keys           keys currently salted across shards
        <scope>.hot_epoch          hot-set membership epoch (bumps on every
                                   promote and demote)

    Takes the engine's shard_routing_snapshot callable, so any object with
    that contract serves it."""

    def __init__(self, snapshot, scope, shards: int):
        self._snapshot = snapshot
        self._waste = scope.gauge("padding_waste_pct")
        self._launches = scope.gauge("launches")
        self._rows = scope.gauge("rows")
        self._hot_keys = scope.gauge("hot_keys")
        self._hot_epoch = scope.gauge("hot_epoch")
        self._shard_rows = [scope.gauge(f"rows.shard_{d}") for d in range(int(shards))]

    def generate_stats(self) -> None:
        snap = self._snapshot()
        self._waste.set(int(round(snap.get("padding_waste_pct", 0.0))))
        self._launches.set(int(snap.get("launches", 0)))
        self._rows.set(int(snap.get("rows", 0)))
        hot = snap.get("hot_tier") or {}
        self._hot_keys.set(int(hot.get("keys", 0)))
        self._hot_epoch.set(int(hot.get("epoch", 0)))
        for gauge, rows in zip(self._shard_rows, snap.get("shard_rows") or []):
            gauge.set(int(rows))


class DispatchLoop:
    """The device-owner thread plus its submit rings. `launch` and
    `collect` are the engine's block executors (_execute_blocks_launch /
    _execute_blocks_collect): launch packs a list of row blocks into the
    padded operand and dispatches asynchronously, collect blocks on the
    readback. The loop owns WHEN they run; the engine owns HOW."""

    def __init__(
        self,
        launch,
        collect,
        *,
        ready=None,
        window_seconds: float = 0.0,
        max_batch: int = 8192,
        scope=None,
        overload=None,
        fault_injector=None,
        max_queue: int = 0,
        ring_rows: int = RING_ROWS,
        partition: int = -1,
    ):
        # which cluster partition this owner serves (cluster/; -1
        # unpartitioned): labeling only, DispatchStats exports the arena
        # pair under a partition_<k> name beside the flat one
        self.partition = int(partition)
        self._launch = launch
        self._collect = collect
        # ready(token) -> bool: non-blocking "has this launch's readback
        # completed?". When provided, an owner with a free launch buffer
        # WAITS FOR WORK instead of committing to a blocking redeem while
        # the device is still executing: that wait costs no wall-clock time
        # (the redeem would block at least as long) and it is what lets
        # launch k+1 overlap readback k even when k+1's frames arrive after
        # k was launched. None redeems eagerly (fake executors).
        self._ready = ready
        self._window = float(window_seconds)
        self._max_batch = int(max_batch)
        self._overload = overload
        self._faults = fault_injector
        self._max_queue = int(max_queue)
        self._ring_rows = int(ring_rows)
        self._rings: list[SubmitRing] = []
        self._rings_lock = threading.Lock()  # ring registration only
        # cross-process rings (backends/shm_ring.py ShmRingConsumer):
        # attached by the control server, drained by the same _take as the
        # in-process rings; listed apart only for the doorbell protocol
        self._ext_rings: list = []
        self._detach_pending: list = []
        # dead shm rings whose mapping could not close yet (frames of
        # theirs still riding an in-flight batch); retried as batches
        # drain and once more at close
        self._ring_graveyard: list = []
        self._tls = threading.local()
        self._work = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._closed = False
        self._inflight_count = 0  # owner-only writes
        self._taken_items = 0  # owner-only writes: taken but unresolved
        # the linger's zero-latency break point: the number of ACTIVE
        # producer rings (published within the last few takes). Closed-loop
        # callers block on their ticket after publishing, so once that many
        # frames are pending nobody is left to wait for. Owner-only state.
        self._expect_frames = 1
        self._take_seq = 0
        self._ring_activity: dict = {}  # id(ring) -> [items_in, last_seq]
        self.deadline_drops = 0
        # launches made while another was still in flight: the double
        # buffer's overlap count (owner-only writes)
        self.overlapped_launches = 0
        self.launches = 0
        self._h_wait = self._h_batch = self._h_launch = self._h_redeem = None
        self._h_cycle = self._h_offcpu = self._h_wake = None
        # owner-only: time.monotonic_ns() at its last take that found
        # frames, the wall and thread CPU ns at its first, the off-CPU ns
        # recorded so far and the ns parked on the work event since the
        # first (dispatch.cycle_ms / offcpu_ms)
        self._cycle_ns = self._first_ns = self._first_cpu_ns = self._offcpu_ns = 0
        self._parked_ns = 0
        if scope is not None:
            from ..stats.store import DEFAULT_SIZE_BUCKETS

            ds = scope.scope("dispatch")
            self._h_wait = ds.histogram("ring_wait_ms")
            self._h_batch = ds.histogram(
                "batch_size", boundaries=DEFAULT_SIZE_BUCKETS
            )
            self._h_launch = ds.histogram("launch_ms")
            self._h_redeem = ds.histogram("redeem_ms")
            self._h_cycle = ds.histogram("cycle_ms")
            self._h_offcpu = ds.histogram("offcpu_ms")
            self._h_wake = ds.histogram("wake_ms")
            ds.add_stat_generator(DispatchStats(self, ds))
        # the native verdict scatter (rl_scatter_rows) for _redeem; None
        # keeps the numpy slice copies
        try:
            from ..ops import native

            self._scatter = native.scatter_rows if native.available() else None
        except Exception:  # noqa: BLE001 - the codec is optional
            self._scatter = None
        # owner-thread profiling hook (tools/hotpath_profile.py --dispatch):
        # the loop body runs under the profile module and the stats are kept
        # on the instance for the tool to print after close()
        self._profile = None
        self._want_profile = os.environ.get("DISPATCH_PROFILE", "") == "1"
        self._thread = threading.Thread(
            target=self._loop, name="cuda-dispatch-owner", daemon=True
        )
        self._thread.start()

    # -- frontend side --

    @property
    def queue_depth(self) -> int:
        """Items published to rings, not yet taken (racy read)."""
        return sum(r.depth for r in self._rings)

    @property
    def inflight(self) -> int:
        """Launches not yet redeemed (racy read; stats only)."""
        return self._inflight_count

    def _ring(self) -> SubmitRing:
        ring = getattr(self._tls, "ring", None)
        if ring is None:
            ring = SubmitRing(arena_rows=self._ring_rows)
            with self._rings_lock:
                if self._closed:
                    raise CacheError("dispatch loop is closed")
                self._rings.append(ring)
            self._tls.ring = ring
        return ring

    # -- cross-process rings (backends/shm_ring.py) --

    def kick(self) -> None:
        """Doorbell from the shm control server: a frontend process
        published into a ring while the owner was parked."""
        self._idle.clear()
        self._work.set()

    def attach_ring(self, ring) -> None:
        """Register an external (shm consumer) ring with the drain loop. The
        ring speaks the SubmitRing slot protocol; the owner thread starts
        taking its frames on its next cycle."""
        with self._rings_lock:
            if self._closed:
                with ring.lock:
                    ring.closed = True
                raise CacheError("dispatch loop is closed")
            self._rings.append(ring)
            self._ext_rings.append(ring)
        self._work.set()

    def detach_rings(self, rings) -> None:
        """Mark external rings dead (their producer process is gone) and
        hand them to the owner thread for removal: pending frames are
        dropped (nobody is parked on them), their segments unlinked, and
        every other ring's traffic goes on untouched."""
        for ring in rings:
            ring.dead = True
        with self._rings_lock:
            self._detach_pending.extend(rings)
        self._work.set()
        if not self._thread.is_alive():
            # the owner already exited: nobody else will remove them
            self._process_detach()

    def arena_pressure(self) -> tuple[int, int]:
        """(total overflow count, max arena rows high-water) across every
        ring: racy reads, stats cadence only."""
        overflow = 0
        hwm = 0
        for ring in self._rings:
            overflow += ring.overflow_count
            if ring.arena_hwm > hwm:
                hwm = ring.arena_hwm
        return overflow, hwm

    def submit(
        self,
        block: np.ndarray,
        owned: bool = False,
        reuse_out: bool = False,
    ) -> np.ndarray:
        """One uint32[6, n] row block -> uint32[n] post-increment counters.
        Blocks until the owner thread redeems the frame's launch. The rows
        are copied into this thread's ring, unless owned=True hands over a
        one-shot buffer (a sidecar wire frame). reuse_out=True returns a
        view of this thread's reusable ticket buffer, valid only until this
        thread's next submit; the default allocates a result the caller
        owns."""
        count = block.shape[1]
        if count == 0:
            return np.empty(0, dtype=np.uint32)
        if self._faults is not None:
            action = self._faults.fire(FAULT_SITE_SUBMIT)
            if action == "queue_full":
                raise QueueFullError("injected queue_full fault")
        if self._overload is not None and self._overload.should_shed():
            raise BrownoutError("dispatch brownout: ring wait ewma over target")
        if self._closed:
            raise CacheError("dispatch loop is closed")
        if self._max_queue > 0 and self.queue_depth + count > self._max_queue:
            raise QueueFullError(
                f"dispatch backlog full ({self.queue_depth} pending, "
                f"max {self._max_queue})"
            )
        deadline = current_deadline()
        ring = self._ring()
        ticket = ring.ticket
        ticket.error = None
        ticket.stage_ns = None
        ticket.resolved_ns = 0
        ticket.fresh = not reuse_out
        ticket.event.clear()
        # the trace context rides the frame: the owner links the batch span
        # to this request span and returns per-stage timestamps on the
        # ticket. Tracing off and no recorder cost one contextvar read.
        span = active_span()
        ctx = None
        publish_ns = 0
        if span is not None:
            c = span.context
            ctx = (
                c.trace_id >> 64,
                c.trace_id & _MASK64,
                c.span_id,
                _CTX_PRESENT | (_CTX_SAMPLED if c.sampled else 0),
            )
        if span is not None or journeys.recording():
            publish_ns = time.monotonic_ns()
            journeys.mark("publish", publish_ns)
        ring.publish(block, count, deadline, time.monotonic(), ticket, owned, ctx)
        self._idle.clear()
        self._work.set()
        out = ticket.redeem()
        if self._h_wake is not None and ticket.resolved_ns:
            self._h_wake.record((time.monotonic_ns() - ticket.resolved_ns) / 1e6)
        stages = ticket.stage_ns
        if stages is not None:
            journeys.merge_owner_stages(stages)
            if span is not None and publish_ns:
                self._record_stage_spans(span, publish_ns, stages)
        return out

    @staticmethod
    def _record_stage_spans(span, publish_ns: int, stages: tuple) -> None:
        """Close the request span's blind gap with child spans rebuilt
        from the owner thread's stage timestamps."""
        tracer = span.tracer
        if tracer is None or not tracer.enabled:
            return
        take, pack, launch, redeem, scatter = stages
        tracer.record_span("dispatch.ring_wait", span, publish_ns, take)
        tracer.record_span("dispatch.pack", span, take, pack)
        tracer.record_span("dispatch.launch", span, pack, launch)
        tracer.record_span("dispatch.redeem", span, launch, scatter)

    def flush(self) -> None:
        """Block until everything published so far has been redeemed."""
        while self._drainable() or not self._idle.is_set():
            if not self._thread.is_alive():
                return
            time.sleep(0.0005)

    def drain(self) -> None:
        """Graceful-drain quiesce: refuse new submits, then block until
        every frame already published (including both in-flight launch
        buffers) has been redeemed. The owner thread exits afterwards."""
        self._close_rings()
        self._work.set()
        while (
            self._drainable() or not self._idle.is_set()
        ) and self._thread.is_alive():
            time.sleep(0.0005)

    def close(self) -> None:
        self._close_rings()
        self._work.set()
        self._thread.join(timeout=5.0)
        if self._detach_pending:
            self._process_detach()
        # shm teardown: unlink every still-attached external segment (the
        # closed word in each header tells its producer to stop) and retry
        # the mappings in-flight batches pinned
        with self._rings_lock:
            ext, self._ext_rings = self._ext_rings, []
            self._rings = [r for r in self._rings if r not in ext]
        for ring in ext:
            ring.dead = True
            if not ring.release():
                self._ring_graveyard.append(ring)
        self._ring_graveyard = [r for r in self._ring_graveyard if not r.release()]

    def _close_rings(self) -> None:
        with self._rings_lock:
            self._closed = True
            rings = list(self._rings)
        for ring in rings:
            with ring.lock:
                ring.closed = True

    def _drainable(self) -> bool:
        return bool(self.queue_depth or self._taken_items)

    # -- owner thread --

    def _loop(self) -> None:
        try:
            if self._want_profile:
                import profile

                self._profile = profile.Profile()
                self._profile.runcall(self._run)
            else:
                self._run()
        except BaseException as e:  # noqa: BLE001 - last-ditch safety net
            # a bug in the owner loop must not strand callers on their
            # tickets forever: fail everything reachable and refuse new
            # submits, loudly
            logger.exception("dispatch owner thread died: %s", e)
            self._abort(CacheError(f"dispatch owner thread died: {e}"))

    def _abort(self, exc: BaseException) -> None:
        self._close_rings()
        for ring in self._rings:
            head, tail = ring.head, ring.tail
            while head != tail:
                slot = ring.slots[head & ring.mask]
                head += 1
                if slot is not None:
                    slot[4].fail(exc)
            ring.head = head
        self._idle.set()

    def _process_detach(self) -> None:
        """Owner thread: remove the rings whose producer process died (the
        control connection's EOF). Untaken frames are dropped with the ring
        (their producers are gone, and the seqno discipline already hid any
        torn frame) and the segment name is unlinked; a mapping that frames
        of an in-flight batch still read waits in the graveyard."""
        with self._rings_lock:
            pending, self._detach_pending = self._detach_pending, []
            # a ring close() already took from _ext_rings is close()'s to
            # release: releasing it here too would close its mapping twice
            attached = []
            for ring in pending:
                if ring in self._rings:
                    self._rings.remove(ring)
                if ring in self._ext_rings:
                    self._ext_rings.remove(ring)
                    attached.append(ring)
        for ring in attached:
            dropped = ring.tail - ring.head
            if dropped:
                logger.warning(
                    "dead shm ring %s: dropping %d untaken frame(s)",
                    getattr(ring, "name", "?"), dropped,
                )
            release = getattr(ring, "release", None)
            if release is not None and not release():
                self._ring_graveyard.append(ring)
        self._ring_graveyard = [r for r in self._ring_graveyard if not r.release()]

    def _wait_work(self, timeout: float) -> None:
        """Park on the work event with the shm doorbell raised: external
        producers see it and kick the control socket, whose reader sets
        the event. The depth re-check after raising closes the
        publish-before-doorbell race; the timeout backstops a missed
        doorbell (one tick of added latency, never a lost frame)."""
        ext = self._ext_rings
        if ext:
            for ring in tuple(ext):
                ring.set_doorbell(True)
            if self.queue_depth:
                for ring in tuple(ext):
                    ring.set_doorbell(False)
                return
        t0 = time.monotonic_ns()
        self._work.wait(timeout=timeout)
        self._parked_ns += time.monotonic_ns() - t0
        if ext:
            for ring in tuple(self._ext_rings):
                ring.set_doorbell(False)

    def _run(self) -> None:
        # (token, frames, n_items, stages, span, owner CPU ns at its start)
        inflight: deque = deque()
        pre = None  # the next batch's stamps before its span opens (tracer on)
        turning = None  # (batch span, its scatter's end ns): the loop's turn
        while True:
            if global_tracer().enabled:
                if pre is None:
                    pre = _PreStamps()
            else:
                pre = None
            if self._detach_pending:
                self._process_detach()
            if not inflight and not self._closed:
                # cold pipeline: wait out the straggler train before the
                # take so concurrent submitters share one launch. With a
                # batch in flight, its execute time IS the coalescing
                # window: take immediately.
                t0 = time.monotonic_ns() if pre is not None or turning is not None else 0
                turning = _end_turn(turning, t0)
                if self._linger() and pre is not None:
                    pre.add("dispatch.linger", t0, time.monotonic_ns())
            t0 = time.monotonic_ns() if pre is not None or turning is not None else 0
            turning = _end_turn(turning, t0)
            frames, pending_free, expired, t_take = self._take()
            if frames:
                self._note_cycle()
                if pre is not None:
                    pre.add("dispatch.take", t0, time.monotonic_ns())
            if expired:
                self.deadline_drops += len(expired)
                if self._overload is not None:
                    self._overload.note_deadline_expired(len(expired))
                exc = DeadlineExceededError("deadline expired in dispatch ring")
                n_exp = 0
                for ticket, count in expired:
                    n_exp += count
                    ticket.fail(exc)
                self._taken_items -= n_exp
            if frames:
                n_items = sum(count for _, count, _, _ in frames)
                if self._h_batch is not None:
                    self._h_batch.record(n_items)
                launched = self._launch_frames(frames, pending_free, t_take, bool(inflight), pre)
                pre = None
                if launched is not None:
                    inflight.append(launched)
            elif pending_free:
                self._free_arena(pending_free)
            if inflight and (
                not frames or len(inflight) >= MAX_INFLIGHT
            ):
                # the empty take, and any wait below, are the oldest
                # launch's dispatch.wait: the owner waits on its device work
                span = None if frames else inflight[0][4]
                ready = True
                if (
                    not frames
                    and len(inflight) < MAX_INFLIGHT
                    and not self._closed
                    and self._ready is not None
                    # saturated closed loop: every active producer is
                    # already parked in an in-flight batch, so no frame
                    # can arrive: block in the redeem directly
                    and sum(len(f[1]) for f in inflight) < self._expect_frames
                ):
                    ready = self._await_work_or_ready(inflight[0][0])
                if span is not None and t0:
                    span.tracer.record_span("dispatch.wait", span, t0, time.monotonic_ns())
                if not ready:
                    # work arrived while the device was still executing:
                    # launch it FIRST (the double-buffer overlap), redeem
                    # after
                    continue
                turning = self._redeem(*inflight.popleft())
                self._inflight_count = len(inflight)
                continue
            if frames:
                continue
            # nothing taken, nothing redeemable: idle (or closed). The empty
            # take and the parking below are the owner's wait for work
            # (dispatch.wait, from the take's start stamp t0): the idle and
            # work events' locks are the frontends' too, so the parking
            # itself can wait behind them
            if not self._drainable():
                self._idle.set()
            if self._closed:
                # rings are closed to producers; anything still visible was
                # published before the close handshake: sweep until truly
                # empty, then exit
                if not self._drainable():
                    break
                continue
            self._work.clear()
            # lost-wakeup guard: a publish may have landed between the last
            # take and the clear
            if not self.queue_depth:
                self._wait_work(0.05)
            if pre is not None:
                pre.add("dispatch.wait", t0, time.monotonic_ns())

    def _note_cycle(self) -> None:
        """dispatch.cycle_ms and dispatch.offcpu_ms at a take that found
        frames: the owner's wall time since the last such take, and what
        its off-CPU time gained over it: wall less thread CPU time since
        its first take, less the wall time it spent parked on the work
        event (its linger, idle and readiness waits, _wait_work), so that
        what counts is time it wanted the CPU and did not get (the GIL,
        the scheduler). Its fence waits spin on the CPU (CUDA's default
        schedule with fewer cards than cores) and count as CPU time. A
        thread CPU clock that advances in ticks (10 ms in some sandboxes)
        counts a cycle's CPU whole or not at all, so a cycle records the
        running total's gain, never below 0: the sum stays exact to a
        tick."""
        if self._h_cycle is None:
            return
        now, cpu = time.monotonic_ns(), time.thread_time_ns()
        if self._cycle_ns:
            self._h_cycle.record((now - self._cycle_ns) / 1e6)
            off = (now - self._first_ns) - (cpu - self._first_cpu_ns) - self._parked_ns
            gained = max(0, off - self._offcpu_ns)
            self._offcpu_ns += gained
            self._h_offcpu.record(gained / 1e6)
        else:
            self._first_ns, self._first_cpu_ns, self._parked_ns = now, cpu, 0
        self._cycle_ns = now

    def _pending_frames(self) -> int:
        return sum(r.tail - r.head for r in self._rings if not r.dead)

    def _await_work_or_ready(self, token) -> bool:
        """With one launch in flight, a free buffer, and empty rings: park
        until either its readback is READY (return True: the redeem costs
        nothing now) or new frames arrive (return False: launch them first
        so they overlap the in-flight execute). Escalating-backoff polls
        keep the readiness checks cheap for long device executions; the
        50 ms ceiling guarantees progress if a ready() probe misleads."""
        delay = 2e-5
        deadline = time.monotonic() + 0.05
        while not self._closed:
            try:
                if self._ready(token):
                    return True
            except Exception:  # noqa: BLE001 - probe must never wedge
                return True
            if self.queue_depth:
                return False
            if time.monotonic() >= deadline:
                return True
            self._work.clear()
            if self.queue_depth:
                return False
            self._wait_work(delay)
            delay = min(delay * 2, 1e-3)
        return True

    def _linger(self) -> bool:
        """Arrival-lull wait: once work is visible, keep collecting until
        the straggler train has visibly ended. Closed-loop producers block
        on their ticket after publishing, so once the pending frame count
        reaches the active-producer count there is nobody left to wait for:
        break with zero added latency (the common saturated case).
        Otherwise a quarter-window with no new publish, the full window, or
        a max_batch backlog ends the wait. False when there was nothing to
        linger for."""
        window = self._window
        if window <= 0 or not self.queue_depth:
            return False
        deadline = time.monotonic() + window
        lull = window * 0.25
        last = self.queue_depth
        last_change = time.monotonic()
        while not self._closed:
            if self._pending_frames() >= self._expect_frames:
                return True
            now = time.monotonic()
            if now >= deadline:
                return True
            depth = self.queue_depth
            if depth >= self._max_batch:
                return True
            if depth != last:
                last = depth
                last_change = now
            elif now - last_change >= lull:
                return True
            self._work.clear()
            # a publish may have landed before the clear: re-check via the
            # depth comparison at the top rather than trusting the event
            self._wait_work(min(deadline - now, lull))
        return True

    def _take(self):
        """Drain every live ring. Returns (frames, pending_free, expired,
        t_take): frames = [(rows, count, ticket, span_ctx)] in ring order
        (span_ctx is the frame's SpanContext from its ctx row, or None),
        pending_free =
        [(ring, arena_rows)] to release once the rows are packed, expired = [(ticket, count)] dropped at take time (their
        arena rows are freed through pending_free too: arena release is
        FIFO)."""
        frames = []
        expired = []
        pending_free = []
        t_take = 0.0
        head_wait_ms = 0.0
        # active-producer census: a ring that published since the last
        # take keeps its activity fresh; rings quiet for 8 takes age out.
        # The count feeds the linger's zero-latency break point.
        self._take_seq += 1
        seq = self._take_seq
        active = 0
        for ring in self._rings:
            if ring.dead:
                continue
            entry = self._ring_activity.get(id(ring))
            if entry is None:
                entry = self._ring_activity[id(ring)] = [ring.items_in, seq]
            elif ring.items_in != entry[0]:
                entry[0] = ring.items_in
                entry[1] = seq
            if seq - entry[1] < 8:
                active += 1
        self._expect_frames = max(1, active)
        for ring in self._rings:
            if ring.dead:
                # producer process gone (shm control EOF): its untaken
                # frames are dropped at detach; nobody would redeem them
                continue
            tail = ring.tail
            head = ring.head
            if head == tail:
                continue
            if not t_take:
                t_take = time.monotonic()
            freed = 0
            while head != tail:
                idx = head & ring.mask
                rows, count, deadline, enq, ticket, arena_used = ring.slots[idx]
                ring.slots[idx] = None
                sctx = None
                flags = int(ring.ctx[idx, 3])
                if flags & _CTX_PRESENT:
                    sctx = SpanContext(
                        trace_id=(int(ring.ctx[idx, 0]) << 64) | int(ring.ctx[idx, 1]),
                        span_id=int(ring.ctx[idx, 2]),
                        sampled=bool(flags & _CTX_SAMPLED),
                    )
                freed += arena_used
                # visible to flush() before the ring's head moves on
                self._taken_items += count
                head += 1
                ring.items_out += count
                if deadline is not None and t_take >= deadline:
                    expired.append((ticket, count))
                    continue
                wait_ms = (t_take - enq) * 1e3
                if self._h_wait is not None:
                    # trace-id exemplar: a frame that waited into the
                    # overflow bucket links to its span
                    if sctx is not None and self._h_wait.is_slow(wait_ms):
                        self._h_wait.record(wait_ms, exemplar=f"{sctx.trace_id:032x}")
                    else:
                        self._h_wait.record(wait_ms)
                if wait_ms > head_wait_ms:
                    head_wait_ms = wait_ms
                frames.append((rows, count, ticket, sctx))
            ring.head = head
            if freed:
                pending_free.append((ring, freed))
        if frames and self._overload is not None:
            self._overload.observe_queue_wait(head_wait_ms)
        return frames, pending_free, expired, t_take

    @staticmethod
    def _free_arena(pending_free) -> None:
        for ring, freed in pending_free:
            ring.rows_out += freed

    def _batch_span(self, frames, n_items: int, pre):
        """Open the per-launch `dispatch.batch` span, linked (followsFrom)
        to every request span this launch coalesced, backdated to the first
        of `pre`'s stamps, which become its first children. Returns (span,
        links): span None when `pre` is (the tracer was off at the cycle's
        check) or the tracer is off now, links None when no frame carried a
        context."""
        links = [sctx for _, _, _, sctx in frames if sctx is not None] or None
        tracer = global_tracer()
        if pre is None or not tracer.enabled:  # re-read: it may flip mid-cycle
            return None, links
        span = tracer.start_span(
            "dispatch.batch",
            links=links,
            start_ns=pre.spans[0][1],
            # a launch no request span is linked to is the owner's own
            # record: unsampled, so it never crowds sampled requests out of
            # a tracer's buffer; a profiling session keeps it
            # (RecordingTracer(keep_unsampled=True))
            sampled=links is not None,
            tags={
                "span.kind": "internal",
                "component": "dispatch",
                "batch_items": n_items,
                "batch_frames": len(frames),
            },
        )
        for name, start_ns, end_ns in pre.spans:
            span.tracer.record_span(name, span, start_ns, end_ns)
        return span, links

    def _launch_frames(self, frames, pending_free, t_take: float, overlapped: bool, pre=None):
        """Launch one batch (fault site first); on failure every ticket of
        the batch fails and None is returned. Arena rows are released as
        soon as the launch callable returns: the pack copied them into the
        padded operand. Returns the in-flight entry (token, frames,
        n_items, stages, batch_span, owner CPU ns at the span's start).
        `overlapped`: another launch is still in flight. `pre`: the
        cycle's stamps (_PreStamps) while the tracer is on."""
        n_items = sum(count for _, count, _, _ in frames)
        span, links = self._batch_span(frames, n_items, pre)
        want_stages = journeys.recording() or links is not None
        take_ns = int(t_take * 1e9) if want_stages else 0
        exemplar = f"{links[0].trace_id:032x}" if links else None
        if self._faults is not None:
            action = self._faults.fire(FAULT_SITE_LAUNCH)
            if action == "error":
                exc = CacheError("injected dispatch.launch fault")
                if span is not None:
                    span.log_kv(event="fault", site=FAULT_SITE_LAUNCH, kind=action)
                    span.set_error(exc)
                    span.finish()
                for _, count, ticket, _ in frames:
                    self._taken_items -= count
                    ticket.fail(exc)
                self._free_arena(pending_free)
                return None
        pack_ns = time.monotonic_ns() if want_stages else 0
        t0 = time.perf_counter() if self._h_launch is not None else 0.0
        blocks = [rows for rows, _, _, _ in frames]
        try:
            if span is not None:
                # the engine records its phases as children of the span
                with activate(span):
                    token = self._launch(blocks)
            else:
                token = self._launch(blocks)
        except BaseException as e:  # noqa: BLE001 - propagate to callers
            if span is not None:
                span.set_error(e)
                span.finish()
            for _, count, ticket, _ in frames:
                self._taken_items -= count
                ticket.fail(e)
            self._free_arena(pending_free)
            return None
        launch_ns = time.monotonic_ns() if want_stages else 0
        if self._h_launch is not None:
            launch_ms = (time.perf_counter() - t0) * 1e3
            if exemplar is not None and self._h_launch.is_slow(launch_ms):
                self._h_launch.record(launch_ms, exemplar=exemplar)
            else:
                self._h_launch.record(launch_ms)
        if span is not None:
            span.log_kv(event="launch.dispatched", batch_items=n_items)
        self._free_arena(pending_free)
        self._inflight_count += 1
        self.launches += 1
        self.overlapped_launches += overlapped
        stages = (take_ns, pack_ns, launch_ns) if want_stages else None
        return token, frames, n_items, stages, span, pre.cpu_ns if pre is not None else 0

    def _redeem(self, token, frames, n_items: int, stages, span, cpu_ns: int = 0):
        """Blocking readback of one launch, then verdict scatter: each
        parked ticket gets its slice copied into its own buffer (native
        rl_scatter_rows when built) and wakes with the owner's stage
        timestamps on its ticket. With a batch span the engine records the
        readback's children under it and this the dispatch.scatter child;
        returns (span, the scatter's end ns, `cpu_ns`) for _end_turn, which
        closes the span at the owner's next stamp, else None."""
        t0 = time.perf_counter() if self._h_redeem is not None else 0.0
        try:
            if span is not None:
                with activate(span):
                    out = self._collect(token)
                scatter_ns = time.monotonic_ns()
            else:
                out = self._collect(token)
            out = np.ascontiguousarray(out, dtype=np.uint32)
            redeem_ns = time.monotonic_ns() if stages is not None else 0
            bufs = [t.reserve(count) for _, count, t, _ in frames]
            if self._scatter is not None and len(frames) > 1:
                self._scatter(out, bufs, [count for _, count, _, _ in frames])
            else:
                off = 0
                for buf, (_, count, _, _) in zip(bufs, frames):
                    buf[:count] = out[off : off + count]
                    off += count
        except BaseException as e:  # noqa: BLE001 - propagate to callers
            # collect OR scatter failure: every parked ticket must learn
            # about it; a stranded ticket blocks its caller forever
            if span is not None:
                span.set_error(e)
                span.finish()
            for _, _count, ticket, _ in frames:
                ticket.fail(e)
            self._taken_items -= n_items
            return None
        if stages is not None:
            stage_ns = (*stages, redeem_ns, time.monotonic_ns())
            for _, _, ticket, _ in frames:
                ticket.stage_ns = stage_ns
        for _, _, ticket, _ in frames:
            ticket.resolve()
        self._taken_items -= n_items
        if span is not None:
            end_ns = time.monotonic_ns()
            span.tracer.record_span("dispatch.scatter", span, scatter_ns, end_ns)
        if self._h_redeem is not None:
            redeem_ms = (time.perf_counter() - t0) * 1e3
            sctx = next((c for _, _, _, c in frames if c is not None), None)
            if sctx is not None and self._h_redeem.is_slow(redeem_ms):
                self._h_redeem.record(redeem_ms, exemplar=f"{sctx.trace_id:032x}")
            else:
                self._h_redeem.record(redeem_ms)
        if span is None:
            return None
        span.log_kv(event="redeem.done", batch_items=n_items)
        return span, end_ns, cpu_ns


def _end_turn(turning, now_ns: int) -> None:
    """Close the batch span of the owner's last redeem (`turning`, from
    _redeem) at its next stamp: the dispatch.turn child from the scatter's
    end to `now_ns` (the owner's way back to its next linger or take,
    behind the frontends its scatter woke when they hold the GIL), and the
    span with its `owner_cpu_us`. Returns None, the loop's next
    `turning`."""
    if turning is not None:
        span, end_ns, cpu_ns = turning
        span.tracer.record_span("dispatch.turn", span, end_ns, now_ns)
        span.set_tag("owner_cpu_us", (time.thread_time_ns() - cpu_ns) // 1000)
        span.finish(now_ns)
    return None


class _PreStamps:
    """The owner's time.monotonic_ns() stamps of a cycle before its batch
    span opens ([name, start_ns, end_ns]: dispatch.wait, dispatch.linger,
    dispatch.take) and its CPU time at the first, kept only while the
    tracer is enabled. Idle rounds of the loop fold into one
    dispatch.wait."""

    __slots__ = ("spans", "cpu_ns")

    def __init__(self):
        self.spans: list = []
        self.cpu_ns = time.thread_time_ns()

    def add(self, name: str, start_ns: int, end_ns: int) -> None:
        spans = self.spans
        if spans and spans[-1][0] == name:
            spans[-1][2] = end_ns  # the same phase again: one span
        elif len(spans) >= 4:
            # idle rounds of linger and wait: fold into one wait
            spans[:] = [["dispatch.wait", spans[0][1], start_ns], [name, start_ns, end_ns]]
        else:
            spans.append([name, start_ns, end_ns])
