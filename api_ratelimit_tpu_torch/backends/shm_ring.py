"""Port of api_ratelimit_tpu/backends/shm_ring.py: shared-memory submit
rings, cross-PROCESS frontends for the dispatch loop.

A single interpreter serves every frontend thread under one interpreter
lock. The dispatch loop (backends/dispatch.py) already keeps every device
launch on one owner thread; this module moves the FRONTENDS out of the
owner's process: each frontend is a process with its own GIL, and the submit
rings it feeds the owner through live off-heap in
`multiprocessing.shared_memory` segments. The frame is already a fixed-width
uint32[6, n] row block with four uint64 ctx words and a seqno-publish
discipline, i.e. a process-ready wire format. "Designing Scalable Rate
Limiting Systems" (PAPERS.md) calls this split many cheap stateless
frontends feeding a small stateful decision core.

One ring = one shm segment, single producer (a frontend thread in a worker
process) / single consumer (the owner thread). The layout is the JAX
package's byte for byte, so a producer of either package publishes into a
consumer of the other:

    bytes 0..767   header: magic/version/geometry words, then one
                   cache-line-padded u64 control word per line — tail,
                   head mirror, closed, doorbell, heartbeat_ns, items
                   in/out, rows in/out, arena_hwm, overflow
    then           slot table: `slots` records of 16 u64 words each
                   (seq, count, arena col, arena_used, deadline bits,
                   enq bits, result_seq, result_err, 4 ctx words, pad)
    then           row arena: uint32[7, arena_rows] C-order — rows 0..5
                   carry the request block, row 6 carries the VERDICTS
                   back (the owner's scatter target), so results ride the
                   same segment and no second channel exists

Publish discipline is the in-process ring's: arena row copy, then slot
fields, then the slot's seqno store — the seqno IS the publication point. A
producer SIGKILLed mid-publish leaves a slot whose seqno never advances; the
owner simply never sees the torn frame (the `dispatch.ring_publish` fault
site sits between the copy and the seqno store so chaos tests can land a
SIGKILL exactly there). Result delivery mirrors it: verdict row copy, then
result_err, then result_seq; the producer spins (escalating backoff) on
result_seq. Cross-process visibility relies on x86-TSO store ordering plus
Linux's process-wide CLOCK_MONOTONIC (deadline/enqueue stamps compare across
processes); the owner's bounded wait timeouts backstop the one
architecturally possible store-load reorder (a missed doorbell costs one
50 ms idle tick, never correctness).

Registration rides a tiny control socket (ShmControlServer, a unix listener
next to the owner's dispatch loop): a frontend process dials it once, sends
one attach line per ring (the shm segment name), and holds the connection
open — the connection IS the liveness contract. The kernel closes it on any
death including SIGKILL, the server's reader sees EOF and detaches that
frontend's rings: pending frames are dropped (their producers are gone), the
segment is unlinked, and every other frontend's traffic is untouched. The
producer also stamps a heartbeat word per publish for observability. The
same connection carries doorbell kicks: the owner sets each ring's doorbell
word before parking on its work event, and a producer that publishes into a
doorbell-raised ring sends one byte so the control server wakes the loop.

SHM_RINGS=false (settings) keeps every byte of this module out of the path:
the socket RPC of backends/sidecar.py is the rollback arm.

This module imports numpy and the standard library only, never torch:
frontend worker processes load it without touching the device stack.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
from multiprocessing import shared_memory

import numpy as np

from ..limiter.cache import CacheError, DeadlineExceededError
from ..tracing import active_span
from ..tracing import journeys
from ..utils.deadline import current_deadline
from .overload import BrownoutError, QueueFullError

logger = logging.getLogger("ratelimit.shm_ring")

MAGIC = 0x524C5352  # 'RLSR'
VERSION = 1

# owner-thread failure verdicts, shipped back in the slot's result_err
# word (messages don't cross the segment; the owner logs the specifics)
ERR_OK = 0
ERR_CACHE = 1
ERR_DEADLINE = 2
ERR_QUEUE_FULL = 3
ERR_BROWNOUT = 4

# chaos site (testing/faults.py): fires in the producer BETWEEN the arena
# copy and the seqno store — delay_ms holds the frame torn-in-flight so a
# chaos test can SIGKILL the frontend process mid-publish; error aborts
# the publish (the frame is never visible)
FAULT_SITE_PUBLISH = "dispatch.ring_publish"

_HDR_BYTES = 768
_SLOT_WORDS = 16  # 128 bytes per slot record
# header u64 word indices (control words sit on their own cache lines)
_W_MAGIC = 0  # magic | version << 32
_W_SLOTS = 1
_W_ARENA_ROWS = 2
_W_TAIL = 8
_W_HEAD = 16
_W_CLOSED = 24
_W_DOORBELL = 32
_W_HEARTBEAT = 40
_W_ITEMS_IN = 48
_W_ITEMS_OUT = 56
_W_ROWS_IN = 64
_W_ROWS_OUT = 72
_W_HWM = 80
_W_OVERFLOW = 88
# slot record u64 word offsets
_S_SEQ = 0
_S_COUNT = 1
_S_COL = 2
_S_USED = 3
_S_DEADLINE = 4  # float64 bits; 0.0 = no deadline
_S_ENQ = 5  # float64 bits (time.monotonic at publish)
_S_RESULT_SEQ = 6
_S_RESULT_ERR = 7
_S_CTX = 8  # 4 words: trace hi, trace lo, span id, flags


class ShmUnavailable(Exception):
    """TRANSPORT-level shm failure (dead owner, closed ring, timeout):
    the caller should fall back to its socket path. Deliberately NOT a
    CacheError — application verdicts from the owner (deadline, shed,
    launch failure) raise their own typed errors and must propagate."""


def ring_nbytes(slots: int, arena_rows: int) -> int:
    return _HDR_BYTES + slots * _SLOT_WORDS * 8 + 7 * arena_rows * 4


def _map_ring(buf, slots: int, arena_rows: int):
    """(header u64 view, slot u64[slots, 16] view, slot f64 view,
    arena uint32[7, arena_rows] view) over one segment buffer."""
    hdr = np.frombuffer(buf, dtype=np.uint64, count=_HDR_BYTES // 8, offset=0)
    slot_bytes = slots * _SLOT_WORDS * 8
    slot_u64 = np.frombuffer(
        buf, dtype=np.uint64, count=slots * _SLOT_WORDS, offset=_HDR_BYTES
    ).reshape(slots, _SLOT_WORDS)
    slot_f64 = np.frombuffer(
        buf, dtype=np.float64, count=slots * _SLOT_WORDS, offset=_HDR_BYTES
    ).reshape(slots, _SLOT_WORDS)
    arena = np.frombuffer(
        buf,
        dtype=np.uint32,
        count=7 * arena_rows,
        offset=_HDR_BYTES + slot_bytes,
    ).reshape(7, arena_rows)
    return hdr, slot_u64, slot_f64, arena


def _untrack_attached(shm) -> None:
    """3.12+ registers ATTACHED segments with the resource tracker too,
    and a tracker unlinking a segment the producer still serves would
    tear the ring down under live traffic — undo that. On 3.10/3.11
    attaching never registers, and unregistering an unknown name makes
    the tracker process traceback, so this is version-gated."""
    import sys

    if sys.version_info < (3, 12):
        return
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:  # noqa: BLE001 - best-effort, version-dependent
        pass


def _unlink_raw(name: str) -> None:
    """Unlink a segment WITHOUT touching this process's resource
    tracker: the owner never registered the segment (the producer did,
    in its own process), so SharedMemory.unlink()'s built-in unregister
    would make the tracker traceback on the unknown name."""
    try:
        from multiprocessing.shared_memory import _posixshmem

        _posixshmem.shm_unlink("/" + name if not name.startswith("/") else name)
    except FileNotFoundError:
        pass
    except Exception:  # noqa: BLE001 - cleanup must never raise
        pass


class ShmRingProducer:
    """Frontend-side half: creates the segment, publishes frames, spins
    for verdicts. One producer per frontend THREAD (SPSC), at most one
    outstanding frame (the caller blocks on the verdict), so arena
    reclamation needs no cross-frame accounting beyond the shared
    rows_in/rows_out words."""

    def __init__(self, name: str, slots: int = 16, arena_rows: int = 4096,
                 fault_injector=None):
        if slots & (slots - 1) or slots <= 0:
            raise ValueError(f"ring slots must be a power of two, got {slots}")
        self.name = name
        self.slots = slots
        self.arena_rows = int(arena_rows)
        self._faults = fault_injector
        self._shm = shared_memory.SharedMemory(
            create=True, name=name, size=ring_nbytes(slots, self.arena_rows)
        )
        buf = self._shm.buf
        buf[: ring_nbytes(slots, self.arena_rows)] = bytes(
            ring_nbytes(slots, self.arena_rows)
        )
        self._hdr, self._slot_u64, self._slot_f64, self._arena = _map_ring(
            buf, slots, self.arena_rows
        )
        self._hdr[_W_MAGIC] = MAGIC | (VERSION << 32)
        self._hdr[_W_SLOTS] = slots
        self._hdr[_W_ARENA_ROWS] = self.arena_rows
        self._tail = 0
        self._cursor = 0  # arena write position
        self._rows_in = 0
        self._closed_local = False

    # -- producer-side views of the shared words --

    @property
    def closed(self) -> bool:
        return self._closed_local or bool(self._hdr[_W_CLOSED])

    @property
    def doorbell(self) -> bool:
        return bool(self._hdr[_W_DOORBELL])

    def publish(self, block: np.ndarray, count: int, ctx=None) -> tuple[int, int]:
        """Copy `count` columns of `block` into the arena and publish one
        frame. Returns (slot index, expected result seq). Raises
        QueueFullError when the frame cannot fit (slot ring or arena
        exhausted — the shm arm has no owned-copy escape hatch: off-heap
        frames must live in the segment, so exhaustion sheds) and
        ShmUnavailable when the ring is closed."""
        if self.closed:
            raise ShmUnavailable("shm ring closed")
        tail = self._tail
        head = int(self._hdr[_W_HEAD])
        if tail - head >= self.slots:
            self._bump(_W_OVERFLOW)
            raise QueueFullError(
                f"shm ring full ({self.slots} frames pending)"
            )
        arena_rows = self.arena_rows
        cursor = self._cursor
        waste = 0
        if cursor + count > arena_rows:
            waste = arena_rows - cursor  # skip the tail remainder
            cursor = 0
        free = arena_rows - (self._rows_in - int(self._hdr[_W_ROWS_OUT]))
        if count > arena_rows or waste + count > free:
            self._bump(_W_OVERFLOW)
            raise QueueFullError(
                f"shm ring arena exhausted ({count} rows, {free} free)"
            )
        self._arena[0:6, cursor : cursor + count] = block[:, :count]
        self._cursor = cursor + count
        used = waste + count
        idx = tail & (self.slots - 1)
        su = self._slot_u64[idx]
        sf = self._slot_f64[idx]
        su[_S_COUNT] = count
        su[_S_COL] = cursor
        su[_S_USED] = used
        deadline = current_deadline()
        sf[_S_DEADLINE] = 0.0 if deadline is None else float(deadline)
        sf[_S_ENQ] = time.monotonic()
        su[_S_RESULT_SEQ] = 0
        su[_S_RESULT_ERR] = 0
        if ctx is not None:
            su[_S_CTX : _S_CTX + 4] = ctx
        else:
            su[_S_CTX + 3] = 0
        if self._faults is not None:
            # the torn-frame window: arena + slot written, seqno NOT yet
            # stored. delay_ms parks the frame here (SIGKILL target);
            # error abandons it — either way the owner never sees it.
            action = self._faults.fire(FAULT_SITE_PUBLISH)
            if action == "error":
                raise CacheError("injected dispatch.ring_publish fault")
        su[_S_SEQ] = tail + 1  # the publication point
        self._tail = tail + 1
        self._hdr[_W_TAIL] = tail + 1
        self._rows_in += used
        self._hdr[_W_ROWS_IN] = self._rows_in
        self._hdr[_W_ITEMS_IN] += count
        depth_rows = self._rows_in - int(self._hdr[_W_ROWS_OUT])
        if depth_rows > int(self._hdr[_W_HWM]):
            self._hdr[_W_HWM] = depth_rows
        self._hdr[_W_HEARTBEAT] = time.monotonic_ns()
        return idx, tail + 1

    def _bump(self, word: int) -> None:
        self._hdr[word] += 1

    def redeem(self, idx: int, seq: int, timeout: float,
               dead_probe=None) -> np.ndarray:
        """Spin (tight, then escalating sleeps) until the owner publishes
        the slot's verdict, then return the row-6 verdict view (valid
        until this producer's next publish). Raises the owner's typed
        verdict errors, or ShmUnavailable on close/death/timeout."""
        su = self._slot_u64[idx]
        t_end = time.monotonic() + timeout
        spins = 0
        checks = 0
        delay = 5e-5
        fail_reason = None
        # tight spin first (a busy multi-core owner answers in tens of
        # µs — the case this transport exists for), then an escalating
        # sleep ladder whose 1 ms ceiling tracks the batch-window scale.
        # On a CORE-STARVED host the polls compete with the owner for
        # the one cycle stream and the kernel-blocking socket RPC wins
        # instead — measured in bench service_mp (shm_overhead_pct) and
        # called out in the README: prefer SHM_RINGS=false there.
        while int(su[_S_RESULT_SEQ]) != seq:
            spins += 1
            if spins < 200:
                continue
            checks += 1
            if self.closed:
                fail_reason = "shm ring closed while awaiting verdict"
                break
            if checks % 16 == 0:
                if dead_probe is not None and dead_probe():
                    fail_reason = "device owner died (control socket EOF)"
                    break
                if time.monotonic() >= t_end:
                    fail_reason = f"shm verdict timeout after {timeout:.1f}s"
                    break
            time.sleep(delay)
            delay = min(delay * 2, 1e-3)
        if fail_reason is not None:
            del su  # see below: raising with a live slot view in frame
            raise ShmUnavailable(fail_reason)
        err = int(su[_S_RESULT_ERR])
        count = int(su[_S_COUNT])
        col = int(su[_S_COL])
        # drop the slot view before any raise: a caller that retains the
        # exception retains this frame's locals via the traceback, and a
        # lingering view would pin the segment mapping past close()
        del su
        if err == ERR_OK:
            return self._arena[6, col : col + count]
        if err == ERR_DEADLINE:
            raise DeadlineExceededError("deadline expired in dispatch ring")
        if err == ERR_QUEUE_FULL:
            raise QueueFullError("dispatch backlog full (owner shed)")
        if err == ERR_BROWNOUT:
            raise BrownoutError("dispatch brownout (owner shed)")
        raise CacheError(
            "device owner failed the batch (see owner logs)"
        )

    def close(self, unlink: bool = True) -> None:
        self._closed_local = True
        try:
            self._hdr[_W_CLOSED] = 1
        except (ValueError, TypeError):
            pass
        # drop the numpy views BEFORE closing the mapping (BufferError)
        self._hdr = self._slot_u64 = self._slot_f64 = self._arena = None
        try:
            self._shm.close()
        except (OSError, BufferError):
            pass
        if unlink:
            try:
                self._shm.unlink()
            except (OSError, FileNotFoundError):
                # the owner's detach may have unlinked first; unlink()
                # raises BEFORE its unregister, so balance the tracker
                # by hand or it warns about the "leaked" name at exit
                try:
                    from multiprocessing import resource_tracker

                    resource_tracker.unregister(
                        self._shm._name, "shared_memory"
                    )
                except Exception:  # noqa: BLE001 - best-effort cleanup
                    pass


class _ShmTicket:
    """Owner-side ticket proxy for one shm frame: the same resolve/fail/
    reserve surface as dispatch._Ticket, executed as stores into the
    segment. reserve() hands the owner's verdict scatter the frame's own
    row-6 arena columns, so `resolve` is just the result-word publish."""

    __slots__ = ("_ring", "_idx", "_seq", "stage_ns", "fresh", "error")

    def __init__(self, ring: "ShmRingConsumer", idx: int, seq: int):
        self._ring = ring
        self._idx = idx
        self._seq = seq
        self.stage_ns = None
        self.fresh = False
        self.error = None

    def reserve(self, n: int) -> np.ndarray:
        su = self._ring._slot_u64[self._idx]
        col = int(su[_S_COL])
        return self._ring._arena[6, col : col + n]

    def resolve(self) -> None:
        slot_u64 = self._ring._slot_u64
        if slot_u64 is None:
            return  # ring released mid-flight; nobody reads the verdict
        su = slot_u64[self._idx]
        su[_S_RESULT_ERR] = ERR_OK
        su[_S_RESULT_SEQ] = self._seq

    def fail(self, error: BaseException) -> None:
        # deliberately NOT kept on the ticket: only the error CODE
        # crosses the segment, and storing the exception here would
        # cycle ticket -> error -> traceback -> owner-loop frame ->
        # frames -> arena views, pinning the mmap past release()
        if isinstance(error, DeadlineExceededError):
            code = ERR_DEADLINE
        elif isinstance(error, QueueFullError):
            code = ERR_QUEUE_FULL
        elif isinstance(error, BrownoutError):
            code = ERR_BROWNOUT
        else:
            code = ERR_CACHE
        slot_u64 = self._ring._slot_u64
        if slot_u64 is None:
            return
        su = slot_u64[self._idx]
        su[_S_RESULT_ERR] = code
        su[_S_RESULT_SEQ] = self._seq


class _ShmSlots:
    """Owner-side slot-table proxy: DispatchLoop._take reads
    `ring.slots[idx]` as a (rows, count, deadline, enq, ticket,
    arena_used) tuple and writes None back after the take — the same
    protocol as the in-process SubmitRing's slot list, reconstructed
    from the shared slot record on demand."""

    __slots__ = ("_ring",)

    def __init__(self, ring: "ShmRingConsumer"):
        self._ring = ring

    def __getitem__(self, idx: int):
        r = self._ring
        su = r._slot_u64[idx]
        sf = r._slot_f64[idx]
        count = int(su[_S_COUNT])
        col = int(su[_S_COL])
        used = int(su[_S_USED])
        deadline_bits = float(sf[_S_DEADLINE])
        deadline = deadline_bits if deadline_bits > 0.0 else None
        enq = float(sf[_S_ENQ])
        rows = r._arena[0:6, col : col + count]
        ticket = _ShmTicket(r, idx, int(su[_S_SEQ]))
        return rows, count, deadline, enq, ticket, used

    def __setitem__(self, idx: int, value) -> None:
        pass  # the slot record is reused in place; nothing to clear


class ShmRingConsumer:
    """Owner-side half: duck-types the in-process SubmitRing closely
    enough that DispatchLoop's drain loop runs UNCHANGED over it — same
    head/tail/slots/ctx/items/rows protocol, same close handshake. The
    `tail` property trusts only the per-slot seqnos (a frame is consumable
    iff its slot's seqno matches), so a producer killed mid-publish can
    never expose a torn frame."""

    def __init__(self, name: str):
        self.name = name
        self._shm = shared_memory.SharedMemory(name=name)
        _untrack_attached(self._shm)
        hdr = np.frombuffer(
            self._shm.buf, dtype=np.uint64, count=_HDR_BYTES // 8
        )
        magic = int(hdr[_W_MAGIC])
        if (magic & 0xFFFFFFFF) != MAGIC or (magic >> 32) != VERSION:
            self._shm.close()
            raise ValueError(f"shm ring {name!r}: bad magic/version {magic:#x}")
        slots = int(hdr[_W_SLOTS])
        arena_rows = int(hdr[_W_ARENA_ROWS])
        if slots <= 0 or slots & (slots - 1) or arena_rows <= 0:
            self._shm.close()
            raise ValueError(
                f"shm ring {name!r}: bad geometry slots={slots} "
                f"arena_rows={arena_rows}"
            )
        if self._shm.size < ring_nbytes(slots, arena_rows):
            self._shm.close()
            raise ValueError(f"shm ring {name!r}: segment too small")
        self._hdr, self._slot_u64, self._slot_f64, self._arena = _map_ring(
            self._shm.buf, slots, arena_rows
        )
        self.mask = slots - 1
        self._head = int(self._hdr[_W_HEAD])
        self.slots = _ShmSlots(self)
        # ctx sidecar view with the in-process ring's [slots, 4] shape
        self.ctx = self._slot_u64[:, _S_CTX : _S_CTX + 4]
        self.lock = threading.Lock()
        self.dead = False  # control-connection EOF -> drop, detach, unlink

    # -- SubmitRing protocol --

    @property
    def tail(self) -> int:
        """Frames safely consumable: scan forward from head while each
        slot's seqno matches its frame index — the ONLY publication
        authority (the header tail word is advisory; a killed producer
        may never have advanced it, or advanced it ahead of a slot the
        fault site is still holding torn)."""
        t = self._head
        su = self._slot_u64
        mask = self.mask
        while int(su[t & mask][_S_SEQ]) == t + 1:
            t += 1
            if t - self._head > mask:
                break
        return t

    @property
    def head(self) -> int:
        return self._head

    @head.setter
    def head(self, value: int) -> None:
        self._head = value
        self._hdr[_W_HEAD] = value

    @property
    def closed(self) -> bool:
        return bool(self._hdr[_W_CLOSED])

    @closed.setter
    def closed(self, value: bool) -> None:
        self._hdr[_W_CLOSED] = 1 if value else 0

    @property
    def items_in(self) -> int:
        return int(self._hdr[_W_ITEMS_IN])

    @property
    def items_out(self) -> int:
        return int(self._hdr[_W_ITEMS_OUT])

    @items_out.setter
    def items_out(self, value: int) -> None:
        self._hdr[_W_ITEMS_OUT] = value

    @property
    def rows_out(self) -> int:
        return int(self._hdr[_W_ROWS_OUT])

    @rows_out.setter
    def rows_out(self, value: int) -> None:
        self._hdr[_W_ROWS_OUT] = value

    @property
    def depth(self) -> int:
        if self.dead:
            return 0
        return self.items_in - self.items_out

    @property
    def arena_hwm(self) -> int:
        return int(self._hdr[_W_HWM])

    @property
    def overflow_count(self) -> int:
        return int(self._hdr[_W_OVERFLOW])

    @property
    def heartbeat_ns(self) -> int:
        return int(self._hdr[_W_HEARTBEAT])

    def set_doorbell(self, on: bool) -> None:
        hdr = self._hdr
        if hdr is not None:
            hdr[_W_DOORBELL] = 1 if on else 0

    def release(self) -> bool:
        """Unlink the segment name (tracker-free — the owner never
        registered it) and try to drop the mapping. Returns False when
        frames already taken from this ring still hold arena views
        inside an in-flight batch — the mmap refuses to close under
        exported buffers, which is exactly the guard a live launch
        needs; the loop parks the ring in its graveyard and retries
        after the batch drains."""
        _unlink_raw(self._shm._name)
        self._hdr = self._slot_u64 = self._slot_f64 = None
        self.ctx = None
        self._arena = None
        try:
            self._shm.close()
        except BufferError:
            return False
        return True


class ShmControlServer:
    """The owner-side registration endpoint: a unix listener living next
    to one DispatchLoop. Line protocol, one JSON object per line:

        {"op": "attach", "name": "<shm segment name>"}  -> {"ok": true}
        k                                               (doorbell kick)

    The connection is the liveness contract: its EOF (any frontend
    death, including SIGKILL) detaches every ring it attached — the loop
    drops that ring's pending frames, the segment is unlinked, and the
    other frontends never notice."""

    def __init__(self, loop, path: str, socket_mode: int = 0o600):
        self._loop = loop
        self._path = path
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(path)
        os.chmod(path, socket_mode)
        self._sock.listen(64)
        self._stop = threading.Event()
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="shm-control-accept", daemon=True
        )
        self._accept_thread.start()
        logger.info("shm ring control socket listening on %s", path)

    @property
    def path(self) -> str:
        return self._path

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        rings: list[ShmRingConsumer] = []
        with self._conns_lock:
            self._conns.add(conn)
        try:
            with conn:
                buf = b""
                while not self._stop.is_set():
                    chunk = conn.recv(4096)
                    if not chunk:
                        return  # EOF: the frontend died or closed
                    buf += chunk
                    while b"\n" in buf:
                        line, buf = buf.split(b"\n", 1)
                        line = line.strip()
                        if not line:
                            continue
                        if line == b"k":
                            self._loop.kick()
                            continue
                        try:
                            msg = json.loads(line)
                            if msg.get("op") != "attach":
                                raise ValueError(f"bad op {msg.get('op')!r}")
                            ring = ShmRingConsumer(str(msg["name"]))
                            self._loop.attach_ring(ring)
                            rings.append(ring)
                            reply = {"ok": True}
                        except Exception as e:  # noqa: BLE001 - to client
                            logger.warning("shm attach failed: %s", e)
                            reply = {"ok": False, "error": str(e)[-200:]}
                        conn.sendall(json.dumps(reply).encode() + b"\n")
        except (ConnectionError, OSError):
            pass
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            if rings:
                logger.warning(
                    "shm control connection lost: detaching %d ring(s)",
                    len(rings),
                )
                self._loop.detach_rings(rings)

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        # drop live control connections so frontends learn the owner is
        # going away NOW (a dead owner's kernel does this for free; a
        # graceful close must match it)
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._accept_thread.join(5.0)
        try:
            os.unlink(self._path)
        except OSError:
            pass


class ShmRingClient:
    """Frontend-process-side client: one control connection per process,
    one producer ring per frontend THREAD (created and attached lazily on
    that thread's first submit). submit() publishes the uint32[6, n] row
    block and spins for the verdict — the per-request hot loop between
    transport decode and device verdict touches no sockets and no shared
    interpreter lock."""

    _MASK64 = 0xFFFFFFFFFFFFFFFF
    _CTX_PRESENT = 1
    _CTX_SAMPLED = 2

    def __init__(
        self,
        control_path: str,
        ring_slots: int = 16,
        arena_rows: int = 4096,
        connect_timeout: float = 5.0,
        submit_timeout: float = 30.0,
        fault_injector=None,
    ):
        self._control_path = control_path
        self._ring_slots = int(ring_slots)
        self._arena_rows = int(arena_rows)
        self._submit_timeout = float(submit_timeout)
        self._faults = fault_injector
        self._tls = threading.local()
        self._rings: list[ShmRingProducer] = []
        self._io_lock = threading.Lock()  # attach request/reply + probe
        self._send_lock = threading.Lock()  # all writes (attach + kicks)
        self._dead = False
        self._closed = False
        self._seq = 0
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.settimeout(connect_timeout)
        try:
            conn.connect(control_path)
        except OSError as e:
            conn.close()
            raise ShmUnavailable(
                f"cannot reach shm control socket {control_path}: {e}"
            ) from e
        conn.settimeout(connect_timeout)
        self._conn = conn

    @property
    def dead(self) -> bool:
        return self._dead or self._closed

    def _probe_dead(self) -> bool:
        """Non-consuming owner-death check: with no attach in flight the
        reply stream is silent, so any readable EOF means the owner's
        control server is gone."""
        if self._dead:
            return True
        if not self._io_lock.acquire(blocking=False):
            return False  # an attach holds the stream; owner clearly alive
        try:
            import select

            readable, _, _ = select.select([self._conn], [], [], 0)
            if readable:
                # the reply stream is silent outside attaches, so any
                # readable state here is EOF (or protocol junk — treated
                # the same: the transport is no longer trustworthy)
                try:
                    if self._conn.recv(64) == b"":
                        self._dead = True
                except OSError:
                    self._dead = True
        finally:
            self._io_lock.release()
        return self._dead

    def _attach_ring(self) -> ShmRingProducer:
        with self._io_lock:
            if self._dead or self._closed:
                raise ShmUnavailable("shm control connection is down")
            self._seq += 1
            name = f"rlring_{os.getpid()}_{self._seq}_{os.urandom(3).hex()}"
            ring = ShmRingProducer(
                name,
                slots=self._ring_slots,
                arena_rows=self._arena_rows,
                fault_injector=self._faults,
            )
            try:
                req = json.dumps({"op": "attach", "name": name}).encode()
                with self._send_lock:
                    self._conn.sendall(req + b"\n")
                reply = self._read_line()
                msg = json.loads(reply)
                if not msg.get("ok"):
                    raise ShmUnavailable(
                        f"owner refused shm ring: {msg.get('error')}"
                    )
            except (OSError, ValueError) as e:
                ring.close(unlink=True)
                self._dead = True
                raise ShmUnavailable(f"shm attach failed: {e}") from e
            except ShmUnavailable:
                ring.close(unlink=True)
                raise
            self._rings.append(ring)
            return ring

    def _read_line(self) -> bytes:
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = self._conn.recv(256)
            if not chunk:
                self._dead = True
                raise OSError("shm control connection EOF")
            buf += chunk
        return buf

    def _kick(self) -> None:
        try:
            with self._send_lock:
                self._conn.sendall(b"k\n")
        except OSError:
            self._dead = True

    def submit(self, block: np.ndarray) -> np.ndarray:
        """One uint32[6, n] row block -> a fresh uint32[n] post-increment
        counter array. Raises the owner's typed verdict errors
        (DeadlineExceeded / QueueFull / Brownout / CacheError), or
        ShmUnavailable when the transport itself is gone (fall back to
        the socket RPC path)."""
        if self.dead:
            raise ShmUnavailable("shm transport is down")
        count = block.shape[1]
        if count == 0:
            return np.empty(0, dtype=np.uint32)
        ring = getattr(self._tls, "ring", None)
        if ring is None:
            ring = self._attach_ring()
            self._tls.ring = ring
        ctx = None
        span = active_span()
        if span is not None:
            c = span.context
            ctx = (
                c.trace_id >> 64,
                c.trace_id & self._MASK64,
                c.span_id,
                self._CTX_PRESENT
                | (self._CTX_SAMPLED if c.sampled else 0),
            )
        if span is not None or journeys.recording():
            journeys.mark("publish")
        try:
            idx, seq = ring.publish(block, count, ctx)
            if ring.doorbell:
                self._kick()
            out = ring.redeem(
                idx, seq, self._submit_timeout, dead_probe=self._probe_dead
            )
        except ShmUnavailable:
            # a closed ring usually means the owner is going/gone — let
            # the probe settle `dead` so the caller stops retrying shm
            # per request
            self._probe_dead()
            raise
        return np.array(out, dtype=np.uint32)

    def close(self) -> None:
        self._closed = True
        # rings first, socket second: the producer's unlink runs before
        # the EOF-triggered owner detach can race it to the name
        for ring in self._rings:
            ring.close(unlink=True)
        self._rings.clear()
        try:
            self._conn.close()
        except OSError:
            pass
