"""Port of api_ratelimit_tpu/persist/replication.py: warm-standby
replication of the device owner, streaming slab deltas with epoch-fenced
promotion.

The reference's module, its frames byte for byte: a primary of either
package streams to a standby of either. A device owner on the H100 is
otherwise a single point of failure: a SIGKILLed owner serves from the
degradation ladder until a human restarts it. Here a warm STANDBY process
holds a near-live host copy of the slab and promotes itself the moment a
frontend's failover write reaches it, with overshoot bounded exactly the
way the snapshot and lease reconcile already bound it.

How state moves (primary -> standby, over the length-prefixed sidecar
wire):

  * the standby dials the primary's sidecar address and sends
    OP_REPL_SUBSCRIBE (backends/sidecar.py);
  * the primary answers with a full SNAPSHOT frame: the slab shard plus
    the lease-liability registry, each packed in the versioned+CRC
    persist/snapshot.py section format (pack_table_bytes), so the stream
    and the on-disk snapshot can never diverge in layout;
  * then sequence-numbered DELTA frames on a REPL_INTERVAL_MS cadence:
    only the rows that changed since the last ship (a numpy diff against
    the last-shipped copy, the dirty set), built from the same export the
    snapshotter uses (backends/cuda.py export_tables: a device clone under
    the state lock, drained to the host after it), so launches never wait
    on replication;
  * every frame carries (epoch, seq, CRC). A sequence gap, CRC failure,
    or torn frame on the standby triggers a full RESYNC (drop the
    connection, re-subscribe, receive a fresh snapshot): divergence is
    never silent.

Failover is client-driven and epoch-fenced (backends/sidecar.py): when the
frontend circuit breaker opens on the primary, SidecarEngineClient fails
over to the next SIDECAR_ADDRS entry. The standby's FIRST write promotes
it: epoch bump, boot-style reconcile (reconcile_rows drops dead and
window-ended rows; reconcile_leases + apply_lease_floors floor every live
liability at its grant watermark so a failover never double-grants), then
the replicated tables upload to its card (one host-to-device copy, which
raises rather than fall back) and it serves. A resurrected old primary
still answers with the OLD epoch; any write from a client that has seen
the new epoch is rejected with a stale-epoch error (counted in
ratelimit.repl.stale_epoch_rejected): the split-brain guard.

The overshoot contract mirrors the warm-restart one: a primary crash loses
at most one REPL_INTERVAL_MS of admitted traffic (the un-shipped dirty
set) plus the outstanding lease budgets, and the lease term is closed by
the replicated liability floors. Every loss fails OPEN (an undercounted
counter can only under-enforce).

numpy + stdlib only: the standby's receive path and all framing import
without torch (the engine owns every device move).
"""

from __future__ import annotations

import logging
import struct
import threading
import time
import zlib

import numpy as np

from .snapshot import (
    FLAG_LEASE_TABLE,
    LEASE_ROW_WIDTH,
    SnapshotError,
    apply_lease_floors,
    migrate_rows_to_sets,
    pack_table_bytes,
    reconcile_leases,
    reconcile_rows,
    unpack_table_bytes,
)

logger = logging.getLogger("ratelimit.repl")

# replication frame: u32 magic 'RLRF' | u8 kind | u8 pad | u16 reserved |
#                    u32 epoch | u64 seq | u32 payload_len
#                    payload | u32 payload_crc
REPL_MAGIC = 0x524C5246  # 'RLRF'
KIND_SNAPSHOT = 1
KIND_DELTA = 2
_FRAME_HDR = struct.Struct("<IBBHIQI")
_U32 = struct.Struct("<I")

# hard cap on a single frame payload: the largest legitimate frame is a
# full snapshot of the slab (n_slots * ROW_WIDTH * 4 bytes + headers); a
# corrupt length field must not make the standby buffer gigabytes
MAX_FRAME_PAYLOAD = 1 << 31

FAULT_SITE_SHIP = "repl.ship"  # primary: before each frame send
FAULT_SITE_APPLY = "repl.apply"  # standby: before each frame apply

ROLE_PRIMARY = "primary"
ROLE_STANDBY = "standby"
ROLE_AUTO = "auto"
ROLES = (ROLE_PRIMARY, ROLE_STANDBY, ROLE_AUTO)


class ReplProtocolError(Exception):
    """A replication frame failed validation (magic/CRC/sequence/shape).
    The standby answers every one the same way: drop the connection and
    resync from a fresh snapshot — never apply a suspect frame."""


# -- frame codec --


def encode_frame(kind: int, epoch: int, seq: int, payload: bytes) -> bytes:
    return (
        _FRAME_HDR.pack(
            REPL_MAGIC, kind, 0, 0, int(epoch), int(seq), len(payload)
        )
        + payload
        + _U32.pack(zlib.crc32(payload))
    )


def read_frame(
    recv_exact, kinds: tuple = (KIND_SNAPSHOT, KIND_DELTA)
) -> tuple[int, int, int, bytes]:
    """Read one frame via recv_exact(n) -> bytes; returns
    (kind, epoch, seq, payload). Raises ReplProtocolError on a malformed
    or corrupt frame (the resync trigger). ``kinds`` is the acceptable
    kind whitelist — replication's by default; the federation exchange
    (cluster/federation.py) reuses this codec verbatim with its own kind
    set."""
    raw = recv_exact(_FRAME_HDR.size)
    magic, kind, _pad, _res, epoch, seq, payload_len = _FRAME_HDR.unpack(raw)
    if magic != REPL_MAGIC:
        raise ReplProtocolError(f"bad replication frame magic {magic:#x}")
    if kind not in kinds:
        raise ReplProtocolError(f"bad replication frame kind {kind}")
    if payload_len > MAX_FRAME_PAYLOAD:
        raise ReplProtocolError(
            f"replication frame of {payload_len} bytes exceeds cap"
        )
    payload = recv_exact(payload_len)
    (crc,) = _U32.unpack(recv_exact(_U32.size))
    if zlib.crc32(payload) != crc:
        raise ReplProtocolError("replication frame CRC mismatch (corrupt)")
    return kind, epoch, seq, payload


def pack_snapshot_payload(
    tables: list[np.ndarray],
    lease_rows: np.ndarray,
    created_at: int,
    ways: int = 0,
) -> bytes:
    """Full-sync payload: every slab shard plus the lease-liability
    registry, each as a persist/snapshot.py versioned+CRC section — the
    stream reuses the snapshot file format byte for byte."""
    sections = [
        pack_table_bytes(
            table,
            created_at,
            shard_index=i,
            shard_count=len(tables),
            ways=ways,
        )
        for i, table in enumerate(tables)
    ]
    sections.append(
        pack_table_bytes(
            np.asarray(lease_rows, dtype=np.uint32).reshape(
                -1, LEASE_ROW_WIDTH
            ),
            created_at,
            flags=FLAG_LEASE_TABLE,
        )
    )
    return _U32.pack(len(sections)) + b"".join(sections)


def unpack_snapshot_payload(
    payload: bytes,
) -> tuple[list[np.ndarray], list, np.ndarray]:
    """Inverse of pack_snapshot_payload; returns
    (shard tables, shard headers, lease rows). Every section revalidates
    its own header + payload CRC (unpack_table_bytes)."""
    try:
        (n_sections,) = _U32.unpack_from(payload)
    except struct.error as e:
        raise ReplProtocolError(f"snapshot payload too short: {e}") from e
    offset = _U32.size
    tables: list[np.ndarray] = []
    headers: list = []
    lease_rows: np.ndarray | None = None
    try:
        for _ in range(n_sections):
            header, table, offset = unpack_table_bytes(
                payload, offset, what="<repl snapshot>"
            )
            if header.flags & FLAG_LEASE_TABLE:
                lease_rows = table
            else:
                tables.append(table)
                headers.append(header)
    except SnapshotError as e:
        raise ReplProtocolError(str(e)) from e
    if lease_rows is None:
        lease_rows = np.zeros((0, LEASE_ROW_WIDTH), dtype=np.uint32)
    if not tables:
        raise ReplProtocolError("snapshot payload holds no slab shards")
    return tables, headers, lease_rows


def pack_delta_payload(
    dirty: list[tuple[int, np.ndarray, np.ndarray]],
    lease_rows: np.ndarray,
) -> bytes:
    """Delta payload: per shard the (row index, row content) pairs that
    changed since the last ship, plus the FULL lease-liability registry
    (it is small and full-ship makes liability replication gap-proof
    within one frame). An empty delta is a valid heartbeat."""
    out = [_U32.pack(len(dirty))]
    for shard_idx, idxs, rows in dirty:
        idxs = np.ascontiguousarray(idxs, dtype="<u4")
        rows = np.ascontiguousarray(rows, dtype="<u4")
        out.append(_U32.pack(int(shard_idx)) + _U32.pack(idxs.shape[0]))
        out.append(idxs.tobytes())
        out.append(rows.tobytes())
    lease_rows = np.ascontiguousarray(
        np.asarray(lease_rows, dtype=np.uint32).reshape(-1, LEASE_ROW_WIDTH),
        dtype="<u4",
    )
    out.append(_U32.pack(lease_rows.shape[0]) + lease_rows.tobytes())
    return b"".join(out)


def unpack_delta_payload(
    payload: bytes, row_width: int
) -> tuple[list[tuple[int, np.ndarray, np.ndarray]], np.ndarray]:
    """Inverse of pack_delta_payload. Raises ReplProtocolError on any
    shape mismatch (the resync trigger)."""
    try:
        (n_shards,) = _U32.unpack_from(payload)
        offset = _U32.size
        dirty = []
        for _ in range(n_shards):
            shard_idx, n_rows = struct.unpack_from("<II", payload, offset)
            offset += 8
            idxs = np.frombuffer(
                payload, dtype="<u4", count=n_rows, offset=offset
            ).astype(np.int64)
            offset += n_rows * 4
            rows = (
                np.frombuffer(
                    payload,
                    dtype="<u4",
                    count=n_rows * row_width,
                    offset=offset,
                )
                .reshape(n_rows, row_width)
                .astype(np.uint32)
            )
            offset += n_rows * row_width * 4
            dirty.append((int(shard_idx), idxs, rows))
        (n_lease,) = _U32.unpack_from(payload, offset)
        offset += 4
        lease_rows = (
            np.frombuffer(
                payload,
                dtype="<u4",
                count=n_lease * LEASE_ROW_WIDTH,
                offset=offset,
            )
            .reshape(n_lease, LEASE_ROW_WIDTH)
            .astype(np.uint32)
        )
        offset += n_lease * LEASE_ROW_WIDTH * 4
    except (struct.error, ValueError) as e:
        raise ReplProtocolError(f"malformed delta payload: {e}") from e
    if offset != len(payload):
        raise ReplProtocolError(
            f"delta payload is {len(payload)} bytes, sections say {offset}"
        )
    return dirty, lease_rows


def diff_tables(
    prev: np.ndarray, cur: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """The dirty set: (row indices, row contents) of every row that
    changed between two exports of one shard. One vectorized compare —
    O(n_slots) numpy work per interval, zero launch-path cost."""
    changed = np.flatnonzero((prev != cur).any(axis=1))
    return changed, cur[changed]


class ReplicationCoordinator:
    """Both halves of device-owner redundancy, role-switched at runtime:

      primary  accepts OP_REPL_SUBSCRIBE connections (the sidecar server
               routes them here) and runs one ship loop per subscriber —
               snapshot first, then dirty-set deltas on the interval;
      standby  subscribes to the peer, applies frames into host-side
               shadow tables, and promotes itself (epoch bump + boot-style
               reconcile + device upload) on the first client write.

    role 'auto' resolves at start(): standby when the peer answers the
    subscribe, primary otherwise — so a crashed-and-restarted old primary
    pointed at the same SIDECAR_ADDRS naturally rejoins as the standby of
    whoever got promoted.

    engine contract (backends/cuda.py SlabDeviceEngine):
        export_for_replication() -> (tables, lease_rows, now)
        apply_replicated(tables, lease_rows)   promotion upload
        shard_count / shard_slots / ways       geometry validation

    Stats (scope mounted at ratelimit.repl): frames_shipped /
    frames_applied / resyncs / promotions / stale_epoch_rejected counters,
    lag_ms / epoch / standbys gauges. The port adds what the ship loop and
    the promotion cost, which the reference does not export:
    bytes_shipped (frame bytes sent), the ship_export_ms and ship_diff_ms
    histograms (each interval's export drain and diff_tables), and the
    promotion_ms gauge (the last promotion's reconcile and upload).

    Concurrent first writes at a standby all wait for the one promotion
    to finish (promote blocks while another call is promoting), so no write
    lands on the slab the promotion's upload then replaces. The
    reference's promote returns False at once to the writes that race the
    transition."""

    def __init__(
        self,
        engine,
        role: str,
        peer_address: str | None = None,
        interval_ms: float = 100.0,
        max_lag_ms: float = 0.0,
        scope=None,
        fault_injector=None,
        time_source=None,
        connect_timeout: float = 5.0,
        on_promote=None,
    ):
        if role not in ROLES:
            raise ValueError(f"REPL_ROLE must be one of {ROLES}, got {role!r}")
        if interval_ms <= 0:
            raise ValueError(
                f"REPL_INTERVAL_MS must be > 0, got {interval_ms}"
            )
        if role in (ROLE_STANDBY, ROLE_AUTO) and not peer_address:
            raise ValueError(f"role {role!r} needs a peer address to subscribe to")
        self._engine = engine
        self._configured_role = role
        self._role = ROLE_PRIMARY if role == ROLE_PRIMARY else ROLE_STANDBY
        self._peer = peer_address
        self._interval_s = float(interval_ms) / 1e3
        # default staleness: 5 missed intervals — one in-flight ship plus
        # real slack before the health surface flips (same posture as the
        # snapshotter's 3-interval default; replication runs much hotter)
        self._max_lag_s = (
            float(max_lag_ms) / 1e3
            if max_lag_ms > 0
            else 5.0 * self._interval_s
        )
        self._connect_timeout = float(connect_timeout)
        self._faults = fault_injector
        if time_source is None:
            from ..utils.timeutil import RealTimeSource

            time_source = RealTimeSource()
        self._time_source = time_source
        self._on_promote = on_promote

        self._lock = threading.Lock()
        self._stop = threading.Event()
        # a freshly-booted process always claims the FLOOR epoch: only a
        # promotion ever raises it, so a resurrected old primary can never
        # out-epoch the standby that took over from it
        self._epoch = 1
        self._peer_epoch = 0

        # primary side: subscriber id -> last successful ship (monotonic)
        self._subscribers: dict[int, float] = {}
        self._next_sub_id = 0
        self._ever_shipped = False
        self._started_monotonic: float | None = None

        # standby side: host-shadow state assembled from frames
        self._tables: list[np.ndarray] | None = None
        self._table_headers: list = []
        self._lease_rows = np.zeros((0, LEASE_ROW_WIDTH), dtype=np.uint32)
        self._last_seq = 0
        self._last_apply_monotonic: float | None = None
        self._apply_thread: threading.Thread | None = None
        self._sub_conn = None

        # held for the whole of a promotion: writes that race it wait
        self._transition = threading.Lock()
        self._promoting = False

        self._c_shipped = self._c_applied = self._c_resyncs = None
        self._c_promotions = self._c_stale = None
        self._g_lag = self._g_epoch = self._g_standbys = None
        self._c_bytes = self._h_export = self._h_diff = self._g_promotion = None
        if scope is not None:
            self._c_bytes = scope.counter("bytes_shipped")
            self._h_export = scope.histogram("ship_export_ms")
            self._h_diff = scope.histogram("ship_diff_ms")
            self._g_promotion = scope.gauge("promotion_ms")
            self._c_shipped = scope.counter("frames_shipped")
            self._c_applied = scope.counter("frames_applied")
            self._c_resyncs = scope.counter("resyncs")
            self._c_promotions = scope.counter("promotions")
            self._c_stale = scope.counter("stale_epoch_rejected")
            self._g_lag = scope.gauge("lag_ms")
            self._g_epoch = scope.gauge("epoch")
            self._g_standbys = scope.gauge("standbys")
            self._g_epoch.set(self._epoch)
            scope.add_stat_generator(self)
        # plain ints mirror the counters so tests and the promote path can
        # read them without a stats store
        self.frames_shipped_total = 0
        self.frames_applied_total = 0
        self.resyncs_total = 0
        self.promotions_total = 0
        self.stale_epoch_rejected_total = 0
        self.bytes_shipped_total = 0
        self.last_promotion_ms: float | None = None

    # -- introspection --

    @property
    def role(self) -> str:
        with self._lock:
            return self._role

    @property
    def is_standby(self) -> bool:
        return self.role == ROLE_STANDBY

    @property
    def promoting(self) -> bool:
        """True while a promotion runs (its reconcile and upload)."""
        return self._promoting

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def replica_state(self) -> tuple[list[np.ndarray] | None, np.ndarray, int]:
        """(shadow tables, lease rows, last applied seq) — test/debug view
        of what a promotion would reconcile from."""
        with self._lock:
            tables = (
                [np.array(t, copy=True) for t in self._tables]
                if self._tables is not None
                else None
            )
            return tables, np.array(self._lease_rows, copy=True), self._last_seq

    # -- health / stats --

    def lag_ms(self) -> float:
        """Replication staleness in ms: time since the last successful
        ship (primary) or apply (standby); inf when nothing ever moved."""
        now = self._time_source.monotonic()
        with self._lock:
            if self._role == ROLE_PRIMARY:
                if not self._subscribers:
                    return float("inf")
                basis = max(self._subscribers.values())
            else:
                basis = self._last_apply_monotonic
        if basis is None:
            return float("inf")
        return max(0.0, (now - basis) * 1e3)

    def degraded_reason(self) -> str | None:
        """HealthChecker degraded-probe contract: a reason string while
        replication cannot currently bound a failover's loss — no standby
        subscribed, or the stream is lagging past REPL_MAX_LAG_MS. The
        probe clears only on the next successful ship/apply (sticky by
        construction: lag resets exclusively on success). Degraded-only:
        the owner keeps serving — degraded durability must never become a
        serving outage."""
        grace = self._max_lag_s
        with self._lock:
            role = self._role
            if role == ROLE_PRIMARY and not self._subscribers:
                started = self._started_monotonic
                # boot grace: the standby needs a moment to dial in before
                # a fresh primary starts reporting degraded
                if (
                    started is not None
                    and self._time_source.monotonic() - started < grace
                ):
                    return None
                return (
                    "repl.degraded: no standby subscribed "
                    "(a crash now serves from the degradation ladder)"
                )
        lag = self.lag_ms()
        if lag > self._max_lag_s * 1e3:
            what = "standby stale" if role == ROLE_STANDBY else "ship lagging"
            shown = "inf" if lag == float("inf") else f"{lag:.0f}"
            return (
                f"repl.degraded: {what} — replication lag {shown}ms "
                f"exceeds {self._max_lag_s * 1e3:.0f}ms"
            )
        return None

    def generate_stats(self) -> None:
        """StatGenerator hook: refresh the gauges on the flush cadence."""
        if self._g_lag is not None:
            lag = self.lag_ms()
            self._g_lag.set(int(min(lag, 2**53)) if lag != float("inf") else -1)
            self._g_epoch.set(self.epoch)
            with self._lock:
                self._g_standbys.set(len(self._subscribers))

    def note_stale_write(self, frame_epoch: int) -> None:
        """A client that has seen epoch `frame_epoch` tried to write here
        while this process still serves an older epoch — this process is a
        resurrected stale primary and the write was rejected (the
        split-brain guard). Counted so the pinned chaos assertion and the
        dashboards both see it."""
        self.stale_epoch_rejected_total += 1
        if self._c_stale is not None:
            self._c_stale.inc()
        logger.warning(
            "stale-epoch write rejected: client at epoch %d, this owner "
            "at epoch %d — a newer primary has been promoted; this "
            "process must rejoin as a standby",
            frame_epoch,
            self.epoch,
        )

    # -- lifecycle --

    def start(self) -> None:
        """Resolve the auto role and start the standby apply loop (the
        primary side is driven by subscriber connections — the sidecar
        server routes OP_REPL_SUBSCRIBE here)."""
        self._started_monotonic = self._time_source.monotonic()
        if self._configured_role == ROLE_AUTO:
            try:
                conn = self._dial_and_subscribe()
            except (OSError, ConnectionError, ReplProtocolError) as e:
                logger.info(
                    "repl auto role: peer %s not answering (%s) — "
                    "taking the primary role",
                    self._peer,
                    e,
                )
                with self._lock:
                    self._role = ROLE_PRIMARY
                return
            logger.info(
                "repl auto role: subscribed to %s — standby", self._peer
            )
            self._start_apply_thread(conn)
            return
        if self._role == ROLE_STANDBY:
            self._start_apply_thread(None)

    def close(self) -> None:
        self._stop.set()
        self._close_sub_conn()
        thread = self._apply_thread
        if thread is not None:
            thread.join(timeout=5.0)
            self._apply_thread = None

    def _close_sub_conn(self) -> None:
        conn, self._sub_conn = self._sub_conn, None
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    # -- primary: the per-subscriber ship loop --

    def serve_subscriber(self, conn) -> None:
        """Run one subscriber's ship loop on the caller's (connection)
        thread: ack, full snapshot, then dirty-set deltas every interval
        until the connection dies or this process stops being primary.
        The sidecar server calls this after reading an OP_REPL_SUBSCRIBE
        header; a standby refuses (error reply) — chained replication is
        not a thing here."""
        from ..backends.sidecar import SlabSidecarServer

        with self._lock:
            if self._role != ROLE_PRIMARY:
                try:
                    conn.sendall(
                        SlabSidecarServer._error("not primary: standby")
                    )
                except OSError:
                    pass
                return
            sub_id = self._next_sub_id
            self._next_sub_id += 1
            self._subscribers[sub_id] = self._time_source.monotonic()
        seq = 0
        try:
            conn.sendall(b"\x00")  # subscribe ack
            tables, lease_rows, now = self._engine.export_for_replication()
            ways = int(getattr(self._engine, "ways", 0))
            seq += 1
            self._ship(
                conn,
                KIND_SNAPSHOT,
                seq,
                pack_snapshot_payload(tables, lease_rows, now, ways=ways),
                sub_id,
            )
            last = tables
            while not self._stop.wait(self._interval_s):
                if self.role != ROLE_PRIMARY:
                    return
                t0 = time.perf_counter()
                tables, lease_rows, now = self._engine.export_for_replication()
                t1 = time.perf_counter()
                dirty = []
                for i, (prev, cur) in enumerate(zip(last, tables)):
                    idxs, rows = diff_tables(prev, cur)
                    if idxs.size:
                        dirty.append((i, idxs, rows))
                if self._h_export is not None:
                    self._h_export.record((t1 - t0) * 1e3)
                    self._h_diff.record((time.perf_counter() - t1) * 1e3)
                seq += 1
                self._ship(
                    conn,
                    KIND_DELTA,
                    seq,
                    pack_delta_payload(dirty, lease_rows),
                    sub_id,
                )
                last = tables
        except (OSError, ConnectionError) as e:
            logger.info("repl subscriber %d went away: %s", sub_id, e)
        except Exception:
            logger.exception("repl ship loop failed")
        finally:
            with self._lock:
                self._subscribers.pop(sub_id, None)

    def _ship(self, conn, kind: int, seq: int, payload: bytes, sub_id: int):
        """Send one frame, consulting the repl.ship chaos site first:
        'drop' consumes the sequence number without sending (the standby
        sees a gap and resyncs), 'torn_write' sends half a frame and
        drops the connection, 'error' fails the ship loop outright,
        delay_ms models a slow/partitioned link."""
        frame = encode_frame(kind, self.epoch, seq, payload)
        if self._faults is not None:
            action = self._faults.fire(FAULT_SITE_SHIP)
            if action == "error":
                raise ConnectionError("injected repl.ship error")
            if action == "drop":
                return  # seq consumed, frame never sent -> standby gap
            if action == "torn_write":
                conn.sendall(frame[: max(1, len(frame) // 2)])
                raise ConnectionError("injected repl.ship torn_write")
        # counted before the send: the standby can apply the frame before
        # this thread runs again, and a frame it applied must read shipped
        self.frames_shipped_total += 1
        try:
            conn.sendall(frame)
        except BaseException:
            self.frames_shipped_total -= 1
            raise
        self.bytes_shipped_total += len(frame)
        if self._c_shipped is not None:
            self._c_shipped.inc()
            self._c_bytes.add(len(frame))
        with self._lock:
            if sub_id in self._subscribers:
                self._subscribers[sub_id] = self._time_source.monotonic()
            self._ever_shipped = True

    # -- standby: subscribe + apply loop --

    def _dial_and_subscribe(self):
        """Dial the peer's sidecar address and complete the subscribe
        handshake; returns the connected socket with the frame stream
        pending."""
        import socket as socket_mod

        from ..backends.sidecar import (
            _HDR,
            _recv_exact,
            MAGIC,
            OP_REPL_SUBSCRIBE,
            VERSION,
            parse_sidecar_address,
        )

        scheme, target = parse_sidecar_address(self._peer)
        if scheme == "unix":
            conn = socket_mod.socket(
                socket_mod.AF_UNIX, socket_mod.SOCK_STREAM
            )
            conn.settimeout(self._connect_timeout)
            try:
                conn.connect(target)
            except OSError:
                conn.close()
                raise
        else:
            conn = socket_mod.create_connection(
                target, timeout=self._connect_timeout
            )
            conn.setsockopt(
                socket_mod.IPPROTO_TCP, socket_mod.TCP_NODELAY, 1
            )
        try:
            # frame reads block until the next interval ship; only the
            # handshake runs under the connect timeout
            conn.sendall(
                _HDR.pack(MAGIC, VERSION, OP_REPL_SUBSCRIBE, 0)
                + struct.pack("<IQ", self.epoch, self._last_seq)
            )
            status = _recv_exact(conn, 1)
            if status != b"\x00":
                raise ReplProtocolError(
                    f"peer refused replication subscribe (status {status!r})"
                )
            conn.settimeout(None)
        except BaseException:
            conn.close()
            raise
        return conn

    def _start_apply_thread(self, conn) -> None:
        self._apply_thread = threading.Thread(
            target=self._apply_loop,
            args=(conn,),
            name="repl-standby",
            daemon=True,
        )
        self._apply_thread.start()

    def _apply_loop(self, conn) -> None:
        """The standby's life: keep a subscription to the peer alive and
        fold its frames into the host-shadow tables. Any protocol wound —
        gap, CRC, torn frame, dead connection — is answered by one move:
        resync (count it, re-subscribe, take a fresh snapshot)."""
        from ..backends.sidecar import _recv_exact

        synced_once = conn is not None
        while not self._stop.is_set() and self.role == ROLE_STANDBY:
            try:
                if conn is None:
                    conn = self._dial_and_subscribe()
                    if synced_once:
                        self.resyncs_total += 1
                        if self._c_resyncs is not None:
                            self._c_resyncs.inc()
                        logger.warning(
                            "repl standby resyncing from %s (full snapshot)",
                            self._peer,
                        )
                    synced_once = True
                self._sub_conn = conn
                while not self._stop.is_set() and self.role == ROLE_STANDBY:
                    kind, epoch, seq, payload = read_frame(
                        lambda n: _recv_exact(conn, n)
                    )
                    if self._faults is not None:
                        action = self._faults.fire(FAULT_SITE_APPLY)
                        if action == "drop":
                            continue  # lost pre-apply -> next frame gaps
                        if action in ("error", "torn_write", "corrupt"):
                            raise ReplProtocolError(
                                f"injected repl.apply {action}"
                            )
                    self._apply_frame(kind, epoch, seq, payload)
            except (OSError, ConnectionError, ReplProtocolError) as e:
                if self._stop.is_set() or self.role != ROLE_STANDBY:
                    return
                logger.info("repl apply stream broken: %s", e)
                if conn is not None:
                    try:
                        conn.close()
                    except OSError:
                        pass
                conn = None
                self._sub_conn = None
                # brief backoff so a dead peer doesn't spin the dial loop
                self._stop.wait(min(0.05, self._interval_s))
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def _apply_frame(
        self, kind: int, epoch: int, seq: int, payload: bytes
    ) -> None:
        if kind == KIND_SNAPSHOT:
            tables, headers, lease_rows = unpack_snapshot_payload(payload)
            shard_count = int(getattr(self._engine, "shard_count", 1))
            shard_slots = int(getattr(self._engine, "shard_slots", 0))
            if len(tables) != shard_count or any(
                h.n_slots != shard_slots for h in headers
            ):
                raise ReplProtocolError(
                    f"peer geometry {len(tables)}x"
                    f"{headers[0].n_slots if headers else 0} does not "
                    f"match this standby's {shard_count}x{shard_slots} "
                    f"slab — fix the config; resync cannot help"
                )
            with self._lock:
                self._tables = tables
                self._table_headers = headers
                self._lease_rows = lease_rows
                self._last_seq = seq
                self._peer_epoch = max(self._peer_epoch, epoch)
                self._last_apply_monotonic = self._time_source.monotonic()
        else:
            with self._lock:
                if self._tables is None:
                    raise ReplProtocolError("delta before any snapshot")
                if seq != self._last_seq + 1:
                    raise ReplProtocolError(
                        f"sequence gap: frame {seq} after {self._last_seq}"
                    )
                dirty, lease_rows = unpack_delta_payload(
                    payload, self._tables[0].shape[1]
                )
                for shard_idx, idxs, rows in dirty:
                    if not 0 <= shard_idx < len(self._tables):
                        raise ReplProtocolError(
                            f"delta names shard {shard_idx} of "
                            f"{len(self._tables)}"
                        )
                    table = self._tables[shard_idx]
                    if idxs.size and (
                        idxs.min() < 0 or idxs.max() >= table.shape[0]
                    ):
                        raise ReplProtocolError("delta row index out of range")
                    table[idxs] = rows
                self._lease_rows = lease_rows
                self._last_seq = seq
                self._peer_epoch = max(self._peer_epoch, epoch)
                self._last_apply_monotonic = self._time_source.monotonic()
        self.frames_applied_total += 1
        if self._c_applied is not None:
            self._c_applied.inc()

    # -- promotion (the failover moment) --

    def promote(self, reason: str = "client write") -> bool:
        """Standby -> primary: the first client write lands here. Stops
        the apply loop, runs the boot-style reconcile over the shadow
        tables (drop dead + window-ended rows, rehash across a ways
        mismatch, floor every live lease liability at its grant
        watermark), uploads to the device, and bumps the epoch PAST the
        old primary's — from this moment any write fenced on the new
        epoch is rejected by the resurrected old owner and vice versa.
        Idempotent; returns True only for the transition call. A call
        made while another promotes waits for it to finish."""
        with self._transition:
            with self._lock:
                if self._role != ROLE_STANDBY:
                    return False
                self._promoting = True
            try:
                return self._promote_locked(reason)
            finally:
                self._promoting = False

    def _promote_locked(self, reason: str) -> bool:
        t_start = time.perf_counter()
        with self._lock:
            # flip the role first: the apply loop and ship guards key off
            # it, and concurrent promote() callers return False above
            self._role = ROLE_PRIMARY
            tables = self._tables
            headers = self._table_headers
            lease_rows = self._lease_rows
            last_seq = self._last_seq
            new_epoch = max(self._epoch, self._peer_epoch, 1) + 1
            self._epoch = new_epoch
            # restart the no-standby boot grace: a fresh primary deserves
            # the same dial-in window the original one got
            self._started_monotonic = self._time_source.monotonic()
        self._close_sub_conn()
        now = int(self._time_source.unix_now())
        if tables is None:
            logger.error(
                "promoting with NO replicated state (%s): the standby "
                "never completed a sync — serving from a cold slab",
                reason,
            )
        else:
            engine_ways = int(getattr(self._engine, "ways", 0))
            reconciled = []
            restored = dropped = 0
            for header, table in zip(headers, tables):
                table, stats = reconcile_rows(table, now)
                if engine_ways and header.ways != engine_ways:
                    table, _mig = migrate_rows_to_sets(table, engine_ways)
                reconciled.append(table)
                restored += stats["restored"]
                dropped += stats["dropped_expired"] + stats["dropped_window"]
            kept_leases, lease_stats = reconcile_leases(lease_rows, now)
            floored, unmatched = apply_lease_floors(reconciled, kept_leases)
            self._engine.apply_replicated(reconciled, kept_leases)
            logger.warning(
                "PROMOTED to primary (%s): epoch %d, %d live rows "
                "(%d dropped), %d live lease liabilities (%d dropped, "
                "%d counters floored, %d unmatched), last replicated "
                "seq %d",
                reason,
                new_epoch,
                restored,
                dropped,
                lease_stats["restored"],
                lease_stats["dropped"],
                floored,
                unmatched,
                last_seq,
            )
        self.last_promotion_ms = (time.perf_counter() - t_start) * 1e3
        if self._g_promotion is not None:
            self._g_promotion.set(int(round(self.last_promotion_ms)))
        self.promotions_total += 1
        if self._c_promotions is not None:
            self._c_promotions.inc()
        if self._g_epoch is not None:
            self._g_epoch.set(new_epoch)
        # promotion is a tail-worthy event: flag the journey that caused
        # it and log onto whatever span is active so /debug/journeys and
        # the trace both retain the failover moment
        from ..tracing import active_span
        from ..tracing import journeys

        span = active_span()
        if span is not None:
            span.log_kv(
                event="repl.promoted", epoch=new_epoch, reason=reason
            )
        journeys.note_flag(journeys.FLAG_FAILOVER)
        thread = self._apply_thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=2.0)
        if self._on_promote is not None:
            try:
                self._on_promote()
            except Exception:
                logger.exception("on_promote hook failed")
        return True
