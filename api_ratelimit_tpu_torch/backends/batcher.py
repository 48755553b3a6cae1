"""Port of api_ratelimit_tpu/backends/batcher.py: the micro-batcher, which
coalesces concurrent submits into one device launch.

Requests enqueue their items and block on a future; a single dispatcher
thread drains the queue, waits up to `window` for stragglers (the batch limit
caps the wait), executes the batch callback once, and distributes results
(the descendant of the reference's REDIS_PIPELINE_WINDOW /
REDIS_PIPELINE_LIMIT implicit pipelining).

window=0 is direct mode: the caller executes its own items immediately under
the dispatch lock.

Double-buffered mode (execute_launch/execute_collect provided): the
dispatcher splits each batch into a fast LAUNCH (pack + asynchronous device
dispatch, returns a token) and a blocking COLLECT (device readback), so
launch k+1 overlaps batch k's readback. The collect runs in the CALLER
threads (leader-collects): the dispatcher hands every future of the batch a
collect ticket; the first waiter to wake redeems the whole batch's readback
and the rest read their slices. max_inflight bounds un-collected launches (a
semaphore held from launch to redemption).

With a journey recorder registered (tracing/journeys.py) every arm stamps
the request's stage set: direct mode stamps the whole set around its
execute; in windowed mode the caller stamps publish, the dispatcher the
take/pack/launch half, and the redeeming caller the redeem/scatter half,
which rides the collect ticket back and merges into the caller's journey.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Callable

import numpy as np

from ..limiter.cache import CacheError, DeadlineExceededError
from ..tracing import journeys
from ..utils.deadline import current_deadline
from .overload import BrownoutError, QueueFullError

_TICKET = object()  # marks a future result as a deferred-collect ticket

FAULT_SITE_SUBMIT = "batcher.submit"  # the reference's testing/faults.py site


class _CollectTicket:
    """Deferred readback hand-off (leader-collects): the first caller to
    redeem runs the batch's blocking collect; every other caller of the
    same batch reads the memoized result (or re-raises the memoized
    error). The ticket owns the inflight bookkeeping: _finish_one runs
    exactly once, whoever redeems first."""

    __slots__ = (
        "_batcher", "_token", "_lock", "_results", "_error", "_done",
        "stage_ns",
    )

    def __init__(self, batcher: "MicroBatcher", token, stage_partial=None):
        self._batcher = batcher
        self._token = token
        self._lock = threading.Lock()
        self._results = None
        self._error: BaseException | None = None
        self._done = False
        # (take, pack, launch) monotonic ns from the dispatcher thread;
        # redeem/scatter are appended by whoever redeems: the journey stage
        # tuple, the same shape as the dispatch loop's
        self.stage_ns: tuple | None = stage_partial

    def redeem(self):
        with self._lock:
            if not self._done:
                try:
                    self._results = self._batcher._execute_collect(self._token)
                except BaseException as e:  # noqa: BLE001 - memo + reraise
                    self._error = e
                if self.stage_ns is not None and len(self.stage_ns) == 3:
                    done_ns = time.monotonic_ns()
                    self.stage_ns = (*self.stage_ns, done_ns, done_ns)
                self._done = True
                self._token = None
                self._batcher._finish_one()
        if self._error is not None:
            raise self._error
        return self._results


class BatcherStats:
    """StatGenerator exporting the batcher's instantaneous backlog at every
    stats flush / metrics scrape:

        <scope>.queue_depth   items enqueued awaiting a dispatcher take
        <scope>.inflight      batches launched but not yet collected
    """

    def __init__(self, batcher: "MicroBatcher", scope):
        self._batcher = batcher
        self._queue_depth = scope.gauge("queue_depth")
        self._inflight = scope.gauge("inflight")

    def generate_stats(self) -> None:
        self._queue_depth.set(self._batcher.queue_depth)
        self._inflight.set(self._batcher.inflight)


class MicroBatcher:
    def __init__(
        self,
        execute: Callable[[list], list],
        window_seconds: float = 0.0,
        max_batch: int = 8192,
        execute_launch: Callable[[list], Any] | None = None,
        execute_collect: Callable[[Any], list] | None = None,
        max_inflight: int = 2,
        block_mode: bool = False,
        scope=None,
        max_queue: int = 0,
        overload=None,
        fault_injector=None,
        arena_rows: int = 0,
    ):
        """block_mode: each submit() argument is ONE uint32[6, n] column
        block instead of a sequence of per-item objects, and the executors
        receive a list of such blocks; counts are in items (block columns).

        scope: optional stats Scope. When set, the batcher records
        queue_wait_ms (submit enqueue -> batch take) and batch_size (items
        per launch) histograms and registers a StatGenerator exporting the
        queue_depth / inflight gauges.

        max_queue: hard bound on items awaiting a dispatcher take; a submit
        that would exceed it raises QueueFullError at once. 0 = unbounded.

        overload: optional AdmissionController (backends/overload.py): fed
        the queue-wait brownout signal (one observation per take), sheds
        new submits with BrownoutError while the brownout is active, and
        counts deadline-expired drops.

        fault_injector: optional object with fire(site) -> action,
        consulted at site 'batcher.submit' before each enqueue
        ('queue_full' raises QueueFullError; the injector itself stalls for
        delay actions).

        arena_rows: block mode only: size (in items) of the ping-pong pair
        of uint32[6, arena_rows] row rings submits write into. With a ring,
        submit() COPIES the caller's block under the lock and the queue
        holds views into the ring, so callers may reuse a thread-local
        scratch block. The dispatcher packs taken views before its next
        take (same thread), so the ring a batch was taken from is free
        again by the time the queue next drains and the write side swaps
        to it. A full ring falls back to an owned copy. 0 hands ownership
        of the submitted block to the batcher."""
        self._execute = execute
        self._window = float(window_seconds)
        self._max_batch = int(max_batch)
        self._max_queue = int(max_queue)
        self._overload = overload
        self._faults = fault_injector
        # deadline-expired items dropped before a launch (also mirrored
        # into the overload controller's counter when one is wired)
        self.deadline_drops = 0
        # batches launched, and those launched while another batch was
        # still in flight (the double buffer's overlap)
        self.launches = 0
        self.overlapped_launches = 0
        self._block_mode = bool(block_mode)
        self._lock = threading.Lock()
        self._items: list = []
        self._pending = 0  # item count across self._items
        # (future, start, count, enqueued_at, deadline)
        self._futures: list = []
        self._inflight = 0
        self._wakeup = threading.Condition(self._lock)
        self._direct_lock = threading.Lock()
        self._closed = False
        self._last_end = float("-inf")  # monotonic end of the last execute
        self._idle = threading.Condition(self._lock)
        self._thread: threading.Thread | None = None
        self._arenas = None
        self._arena_idx = 0
        self._arena_cursor = 0
        self._arena_rows = 0
        if self._block_mode and self._window > 0 and arena_rows > 0:
            self._arena_rows = int(arena_rows)
            self._arenas = [
                np.empty((6, self._arena_rows), dtype=np.uint32),
                np.empty((6, self._arena_rows), dtype=np.uint32),
            ]
        self._h_wait = self._h_batch = None
        if scope is not None:
            from ..stats.store import DEFAULT_SIZE_BUCKETS

            self._h_wait = scope.histogram("queue_wait_ms")
            self._h_batch = scope.histogram(
                "batch_size", boundaries=DEFAULT_SIZE_BUCKETS
            )
            scope.add_stat_generator(BatcherStats(self, scope))
        self._pipelined = execute_launch is not None and execute_collect is not None
        self._execute_launch = execute_launch
        self._execute_collect = execute_collect
        # bounds launches whose collects haven't been redeemed yet
        self._inflight_sem = threading.Semaphore(max(1, int(max_inflight)))
        if self._window > 0:
            self._thread = threading.Thread(
                target=self._loop, name="cuda-batcher", daemon=True
            )
            self._thread.start()

    @property
    def queue_depth(self) -> int:
        """Items awaiting a dispatcher take (racy read; stats only)."""
        return self._pending

    @property
    def inflight(self) -> int:
        """Batches launched but not yet finished (racy read; stats only)."""
        return self._inflight

    @property
    def consumes_submits(self) -> bool:
        """True when submit() fully consumes the caller's block before
        returning (direct mode executes it; a row ring copies it), so the
        caller may hand in a reusable scratch buffer. False means the
        batcher retains the block and the caller must hand over
        ownership."""
        return self._window <= 0 or self._arenas is not None

    # -- client side --

    def _admit(self) -> None:
        """Admission gate shared by both modes: chaos site, then the
        brownout shed, before any queue or lock work."""
        if self._faults is not None:
            action = self._faults.fire(FAULT_SITE_SUBMIT)
            if action == "queue_full":
                raise QueueFullError("injected queue_full fault")
        if self._overload is not None and self._overload.should_shed():
            raise BrownoutError("batcher brownout: queue wait ewma over target")

    def _expired(self, deadline: float | None) -> bool:
        return deadline is not None and time.monotonic() >= deadline

    def submit(self, items) -> list:
        """Run `items` through the batch executor; returns their results in
        order. Blocks until results are available. In block mode, `items`
        is one uint32[6, n] block and the return is its uint32[n] result.

        The caller's propagated deadline (utils/deadline.py) is captured at
        enqueue: work already expired, here or by the time the dispatcher
        takes it, resolves as DeadlineExceededError without ever occupying
        batch slots."""
        count = items.shape[1] if self._block_mode else len(items)
        if count == 0:
            return []
        self._admit()
        deadline = current_deadline()
        if self._window <= 0:
            # direct mode: the caller thread executes (single-flight via
            # the lock). queue_wait is the time blocked on the lock behind
            # another caller, the direct-mode analog of queue time.
            t_enq = time.monotonic()
            with self._direct_lock:
                if self._closed:
                    # CacheError: a submit racing shutdown surfaces as a
                    # counted backend failure, not an unhandled 500
                    raise CacheError("batcher is closed")
                if self._expired(deadline):
                    self._note_expired(1)
                    raise DeadlineExceededError(
                        "deadline expired before device dispatch"
                    )
                wait_ms = (time.monotonic() - t_enq) * 1e3
                if self._h_wait is not None:
                    self._h_wait.record(wait_ms)
                    self._h_batch.record(count)
                if self._overload is not None:
                    self._overload.observe_queue_wait(wait_ms)
                self.launches += 1
                # the caller is the owner here, and launch and readback are
                # one execute: stamp the whole stage set around it (pinned
                # by the arm parity test)
                if journeys.recording():
                    ns0 = time.monotonic_ns()
                    for stage in ("publish", "take", "pack"):
                        journeys.mark(stage, ns0)
                    try:
                        out = (
                            self._execute([items])
                            if self._block_mode
                            else self._execute(list(items))
                        )
                    finally:
                        ns1 = time.monotonic_ns()
                        for stage in ("launch", "redeem", "scatter"):
                            journeys.mark(stage, ns1)
                    return out
                if self._block_mode:
                    return self._execute([items])
                return self._execute(list(items))

        journeys.mark("publish")
        future: Future = Future()
        with self._lock:
            if self._closed:
                raise CacheError("batcher is closed")  # see direct-mode note
            if self._max_queue > 0 and self._pending + count > self._max_queue:
                raise QueueFullError(
                    f"batcher queue full ({self._pending} pending, "
                    f"max {self._max_queue})"
                )
            start = self._pending
            if self._block_mode:
                arenas = self._arenas
                if arenas is not None:
                    cursor = self._arena_cursor
                    if cursor + count <= self._arena_rows:
                        # row ring: written in place; the queue holds a
                        # view, the caller keeps its scratch
                        arena = arenas[self._arena_idx]
                        arena[:, cursor : cursor + count] = items
                        items = arena[:, cursor : cursor + count]
                        self._arena_cursor = cursor + count
                    else:
                        # ring full: decouple from the caller's scratch
                        # with an owned copy
                        items = np.array(items, dtype=np.uint32)
                self._items.append(items)
            else:
                self._items.extend(items)
            self._pending += count
            self._futures.append(
                (future, start, count, time.monotonic(), deadline)
            )
            self._wakeup.notify()
        out = future.result()
        if type(out) is tuple and len(out) == 4 and out[0] is _TICKET:
            # leader-collects: this caller (or a batch-mate that woke
            # first) runs the blocking readback right here
            _, ticket, start, count = out
            results = ticket.redeem()
            if ticket.stage_ns is not None:
                journeys.merge_owner_stages(ticket.stage_ns)
            return results[start : start + count]
        return out

    def _note_expired(self, n: int) -> None:
        self.deadline_drops += n
        if self._overload is not None:
            self._overload.note_deadline_expired(n)

    def flush(self) -> None:
        """Block until everything enqueued so far has executed (including a
        batch already taken by the dispatcher and mid-execution)."""
        if self._window <= 0:
            with self._direct_lock:
                return
        with self._lock:
            while self._items or self._futures or self._inflight:
                self._idle.wait(timeout=0.05)

    def drain(self) -> None:
        """Graceful-drain quiesce: refuse new submits from now on, then
        block until everything already enqueued (including a batch the
        dispatcher took and any launch in flight) has executed; close()
        still follows."""
        if self._window <= 0:
            with self._direct_lock:
                self._closed = True
            return
        with self._lock:
            self._closed = True
            self._wakeup.notify_all()
            while self._items or self._futures or self._inflight:
                self._idle.wait(timeout=0.05)

    def close(self) -> None:
        if self._window <= 0:
            with self._direct_lock:
                self._closed = True
            return
        with self._lock:
            self._closed = True
            self._wakeup.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=1.0)

    # -- dispatcher --

    def _loop(self) -> None:
        while True:
            with self._lock:
                while not self._items and not self._closed:
                    self._wakeup.wait()
                if self._closed and not self._items:
                    self._idle.notify_all()
                    break
                # linger up to `window` for stragglers unless already full.
                # Warm pipeline: items enqueued while the previous batch was
                # executing have already waited >= one launch, and a batch
                # still in flight is itself the coalescing delay: launch
                # them immediately instead of adding the window on top.
                warm = self._inflight > 0 or (
                    self._futures and self._futures[0][3] <= self._last_end
                )
                if self._pending < self._max_batch and not warm:
                    # Lull cutoff: once a quarter-window passes with NO new
                    # enqueue, the straggler train has ended, so launch
                    # instead of idling out the rest of the window. submit()
                    # notifies on every enqueue, so wait on a deadline loop
                    # or the first straggler would end the window early.
                    now = time.monotonic()
                    deadline = now + self._window
                    lull = self._window * 0.25
                    last_pending = self._pending
                    last_change = now
                    while self._pending < self._max_batch and not self._closed:
                        now = time.monotonic()
                        if now >= deadline:
                            break
                        if self._pending != last_pending:
                            last_pending = self._pending
                            last_change = now
                        elif now - last_change >= lull:
                            break
                        self._wakeup.wait(
                            timeout=min(
                                deadline - now,
                                lull - (now - last_change),
                            )
                        )
                # Take whole requests only: a request's items never split
                # across launches. A single oversized request is taken
                # alone; the executor loops over buckets internally.
                # Requests whose propagated deadline expired while queued
                # are dropped here, before packing: they resolve as
                # DeadlineExceededError and never consume batch slots.
                futures = []
                expired: list[Future] = []
                taken = 0  # live items in this batch
                dropped = 0  # expired items excised from the queue
                kept: list[tuple[int, int]] = []  # (unit offset, unit len)
                unit_cursor = 0
                consumed = 0
                head_wait_ms = 0.0
                t_take = time.monotonic()
                for future, _start, count, ts, dl in self._futures:
                    units = 1 if self._block_mode else count
                    if dl is not None and t_take >= dl:
                        expired.append(future)
                        dropped += count
                        unit_cursor += units
                        consumed += 1
                        continue
                    if futures and taken + count > self._max_batch:
                        break
                    if self._h_wait is not None:
                        self._h_wait.record((t_take - ts) * 1e3)
                    if not futures:
                        # oldest live request's wait: the brownout signal
                        head_wait_ms = (t_take - ts) * 1e3
                    futures.append((future, taken, count))
                    taken += count
                    kept.append((unit_cursor, units))
                    unit_cursor += units
                    consumed += 1
                if self._h_batch is not None and futures:
                    self._h_batch.record(taken)
                if dropped:
                    items = []
                    for off, units in kept:
                        items.extend(self._items[off : off + units])
                else:
                    items = self._items[:unit_cursor]
                self._items = self._items[unit_cursor:]
                if self._arenas is not None and not self._items:
                    # queue drained: new submits write the OTHER ring. The
                    # ring just taken is packed by this thread's launch
                    # BEFORE the next take, so by the time the write side
                    # swaps back to it, nothing references its rows.
                    self._arena_idx ^= 1
                    self._arena_cursor = 0
                self._pending -= taken + dropped
                removed = taken + dropped
                self._futures = [
                    (f, start - removed, count, ts, dl)
                    for f, start, count, ts, dl in self._futures[consumed:]
                ]
                if futures:
                    self._inflight += 1
                    self.launches += 1
                    self.overlapped_launches += self._inflight > 1

            if expired:
                self._note_expired(len(expired))
                exc = DeadlineExceededError("deadline expired in batcher queue")
                for future in expired:
                    if not future.done():
                        future.set_exception(exc)
            if not futures:
                # pure-expiry round: nothing to launch
                with self._lock:
                    if not self._items and not self._futures and not self._inflight:
                        self._idle.notify_all()
                continue
            if self._overload is not None:
                self._overload.observe_queue_wait(head_wait_ms)

            if self._pipelined:
                # double-buffered: launch now (fast), defer the blocking
                # readback to the callers via a collect ticket. The
                # semaphore (held launch -> redemption) caps un-collected
                # launches.
                self._inflight_sem.acquire()
                stage_partial = None
                if journeys.recording():
                    # take/pack here, launch after it returns; the
                    # redeeming caller appends redeem/scatter
                    stage_partial = (int(t_take * 1e9), time.monotonic_ns())
                try:
                    token = self._execute_launch(items)
                except BaseException as e:  # noqa: BLE001 - propagate
                    for future, _, _ in futures:
                        if not future.done():
                            future.set_exception(e)
                    self._finish_one()
                else:
                    if stage_partial is not None:
                        stage_partial = (*stage_partial, time.monotonic_ns())
                    ticket = _CollectTicket(self, token, stage_partial)
                    for future, start, count in futures:
                        future.set_result((_TICKET, ticket, start, count))
                continue

            try:
                results = self._execute(items)
                for future, start, count in futures:
                    future.set_result(results[start : start + count])
            except BaseException as e:  # noqa: BLE001 - propagate to callers
                for future, _, _ in futures:
                    if not future.done():
                        future.set_exception(e)
            self._finish_one()

    def _finish_one(self) -> None:
        with self._lock:
            self._last_end = time.monotonic()
            self._inflight -= 1
            if not self._items and not self._futures and not self._inflight:
                self._idle.notify_all()
        if self._pipelined:
            self._inflight_sem.release()
