"""Port of api_ratelimit_tpu/backends/sidecar.py: one device-owner process,
many wire frontends.

A single Python process tops out at a few thousand gRPC calls a second (the
GIL and per-RPC overhead), while one launch of the slab engine decides tens
of thousands of items. The reference scales its wire layer by running 2-3
stateless replicas against one shared Redis (nomad/apigw-ratelimit/
common.hcl:2): the Redis process is the shared single-writer state. Here the
H100 plays Redis's role: ONE device-owner process (cmd/sidecar_cmd.py) owns
the slab (SlabDeviceEngine in block mode, backends/cuda.py) and N frontend
processes, each a full gRPC/HTTP server bound to the same ports through
SO_REUSEPORT, ship row blocks to it. The owner's dispatch loop coalesces
across all frontends, so more frontends make bigger launches, and limits
stay exact because every increment serializes through the one slab.

Two ways reach the owner:

  * the length-framed socket RPC below (unix, tcp:// or tls://), which
    every frontend has and which carries the lease and trace trailers;
  * shared-memory submit rings (backends/shm_ring.py), for same-host
    frontends: a plain row block is published straight into the owner's
    dispatch loop (SHM_RINGS, the default). The socket RPC is the rollback
    arm (SHM_RINGS=false, or a tcp:// / tls:// owner) and takes every frame
    that needs a trailer.

Wire protocol (the JAX package's, byte for byte; length-framed,
little-endian, one in-flight request per connection; frontends pool
connections for concurrency):

  request:  u32 magic 'RLSC' | u8 version=1 | u8 op | u16 flags
            op 1 SUBMIT: u32 n | uint32[6, n] C-order
                         rows: fp_lo, fp_hi, hits, limit, divider, jitter
                         (the divider word carries the rule's algorithm id
                         in bits 28-30, ops/slab.py ALGO_SHIFT, Release
                         riders included; fixed_window is id 0)
                         flags bit 1 (FLAG_LEASE): u32 len | the LeaseOps
                         body (backends/lease.py encode_lease_ops), the
                         liability bookkeeping the owner registers after
                         the launch
                         flags bit 2 (FLAG_EPOCH): u32 epoch, the
                         split-brain fence (persist/replication.py); only
                         multi-address clients (SIDECAR_ADDRS) set it, so
                         single-address frames stay the legacy bytes
                         flags bit 3 (FLAG_MAP): u32 partition-map epoch,
                         the cluster routing fence (cluster/node.py); only
                         the partition router's clients set it
                         flags bit 0 (FLAG_TRACE): u32 len | the B3
                         TextMap carrier (tracing/propagation.py
                         encode_textmap), last, so the frontend's span
                         parents the owner's spans across the RPC
            op 2 PING:   empty
            op 3 REPL_SUBSCRIBE: u32 epoch | u64 last_seq: a warm standby
                         subscribing (persist/replication.py). The owner
                         acks one status byte, then STREAMS replication
                         frames on this connection (a full snapshot, then
                         dirty-row deltas every REPL_INTERVAL_MS)
            ops 4-7 MAP_GET, MAP_SET, RESHARD_PULL, RESHARD_PUSH: the
                         cluster admin ops (cluster/), below
            op 8 HOTKEYS_GET: empty -> the owner's heavy-hitter snapshot
            op 9 FED_EXCHANGE: empty -> the connection becomes a quota
                         federation exchange loop (cluster/federation.py;
                         an owner without federation answers the error
                         frame "federation not configured")
            op 10 FAULTS_SET: u32 len | JSON {"spec", "seed"?}: replace
                         the owner's live fault rule set (testing/
                         faults.py); answers the injector's describe()
            op 11 CLOCK_SET: u32 len | JSON {"offset_s", "drift_ppm"}
  response: u8 status (0 ok / 1 error / 2 ok+epoch / 3 stale epoch /
            4 stale map)
            SUBMIT ok:   u32 n | uint32[n] post-increment counters
            ok+epoch:    u32 epoch | u32 n | uint32[n] counters: only
                         FLAG_EPOCH frames get it (how a failed-over client
                         learns the promoted epoch)
            stale epoch: u32 server_epoch: the frame carried a NEWER epoch
                         than this owner serves, so it is a resurrected
                         stale primary and the write was NOT applied
            stale map:   u32 len | the owner's PartitionMap JSON: the frame
                         was routed with an older map or holds rows this
                         partition does not own; NOT applied
            PING ok:     empty
            admin ok:    u32 len | blob
            error:       u32 len | utf-8 message

`now` is stamped by the owner at launch time: one clock authority, so
frontends never disagree about window boundaries.

Resilience (client side): every SUBMIT runs under a per-RPC deadline
(SIDECAR_RPC_DEADLINE, apart from SIDECAR_CONNECT_TIMEOUT), transport
failures get bounded retries with exponential backoff and full jitter
(SIDECAR_RETRIES / SIDECAR_RETRY_BACKOFF[_MAX]), a pooled connection dying
mid-RPC triggers ONE free redial after evicting the whole pool (an owner
restart stales every pooled socket at once), and a consecutive-failure
circuit breaker (backends/fallback.py CircuitBreaker) fails fast while the
owner is dark, so frontends degrade to the FAILURE_MODE_DENY ladder instead
of stacking up dial timeouts. With a failover list (SIDECAR_ADDRS: the
primary, then its warm standbys) an exhausted address, an open breaker or a
stale-epoch reply moves the client to the next address, whose first write
promotes it. Both ends consult an optional fault injector (any object with
fire(site) -> action).

This module imports no torch at module level: a frontend worker process
(CUDA_VISIBLE_DEVICES="") loads it and never touches the card.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import random
import socket
import ssl
import struct
import threading
import time

import numpy as np

from ..limiter.cache import CacheError
from ..tracing import activate, active_span, global_tracer
from ..tracing import journeys
from ..tracing.propagation import decode_textmap, encode_textmap
from ..utils.timeutil import process_time_source
from .fallback import CircuitBreaker

logger = logging.getLogger("ratelimit.sidecar")

MAGIC = 0x524C5343  # 'RLSC'
VERSION = 1
OP_SUBMIT = 1
OP_PING = 2
# warm-standby replication subscribe (persist/replication.py): payload is
# u32 epoch | u64 last_seq; the server acks with one status byte and then
# STREAMS replication frames on this connection until it dies — the one
# op that breaks the request/response rhythm, by design
OP_REPL_SUBSCRIBE = 3
# --- partitioned-cluster admin ops (cluster/) --------------------------
# small request/response RPCs used by the router and the reshard
# coordinator; every one replies u8 status | u32 len | blob (ok) or the
# standard error frame. Owners without a ClusterNode answer errors.
OP_MAP_GET = 4  # empty -> the owner's current PartitionMap JSON
OP_MAP_SET = 5  # u32 len | map JSON -> adopt iff newer epoch
OP_RESHARD_PULL = 6  # u32 lo | u32 hi | u32 route_sets -> rows section
OP_RESHARD_PUSH = 7  # u32 len | pack_table_bytes section -> merge stats
# empty -> the owner's heavy-hitter snapshot JSON (ops/sketch.py; the
# last drained top-K, fingerprints only — frontends hold the key
# witness). Served whether or not the owner is in a cluster, so the
# single-owner debug surface and the router's per-partition aggregation
# (cluster/router.py cluster_snapshot) ride the same verb.
OP_HOTKEYS_GET = 8
# global-quota-federation exchange (cluster/federation.py): payload is
# u32 fence-epoch | u16 name_len | borrower name; the connection then
# becomes a framed request/response exchange (replication frame codec,
# fed kinds) starting with the grantor's full-snapshot resync frame —
# the second op that leaves the request/response rhythm, same shape as
# OP_REPL_SUBSCRIBE. Owners without a FederationCoordinator answer the
# standard error frame.
OP_FED_EXCHANGE = 9
# --- chaos-campaign admin ops (testing/faults.py, utils/timeutil.py) ---
# runtime fault/clock reconfiguration on a LIVE owner: the wire twins of
# the debug port's POST /debug/faults and POST /debug/clock, so chaos
# campaigns can flip faults and skew clocks mid-run without a
# FAULT_INJECT reboot. Both reply u8 status | u32 len | blob like the
# cluster admin ops.
OP_FAULTS_SET = 10  # u32 len | JSON {"spec": str, "seed": int?}
#                     -> FaultInjector.describe() JSON; a junk spec
#                     answers the error frame and changes nothing
OP_CLOCK_SET = 11  # u32 len | JSON {"offset_s": float?, "drift_ppm":
#                     float?} -> {"unix_now", "skew"} JSON; {} resets
# header flags (the u16 after op): bit 0 = B3 trace trailer appended,
# bit 1 = lease-ops trailer appended (before the trace trailer),
# bit 2 = u32 epoch trailer appended (after the lease trailer, before the
#         trace trailer) — the split-brain fence: set only by multi-address
#         clients (SIDECAR_ADDRS), so single-address deployments ship
#         byte-identical frames to the pre-replication protocol
# bit 3 = u32 partition-map epoch trailer appended (after the epoch
#         trailer, before the trace trailer) — the cluster routing fence:
#         set only by the partition router (cluster/router.py), so
#         PARTITIONS=1 deployments ship byte-identical legacy frames
FLAG_TRACE = 1
FLAG_LEASE = 2
FLAG_EPOCH = 4
FLAG_MAP = 8

# response status bytes. 0/1 are the original protocol; 2/3 only ever
# answer FLAG_EPOCH frames, and 4 only ever answers FLAG_MAP frames, so
# legacy clients never see them.
STATUS_OK = 0
STATUS_ERROR = 1
STATUS_OK_EPOCH = 2  # u32 epoch | u32 n | counters
STATUS_STALE_EPOCH = 3  # u32 server_epoch — the write was NOT applied
# the frame was routed with a stale/mismatched PartitionMap: the write
# was NOT applied; the body is u32 len | the owner's current map JSON so
# the client re-buckets against it (the Redis Cluster MOVED analog)
STATUS_STALE_MAP = 4
# sanity cap on the trace trailer — B3 TextMap is ~90 bytes
MAX_TRACE_TRAILER = 1024
# sanity cap on the lease trailer (a request carries a handful of grant/
# settle records; 64 KiB is ~4k records)
MAX_LEASE_TRAILER = 1 << 16
# sanity cap on cluster admin bodies (a PartitionMap JSON is ~100 bytes
# per partition; a reshard section is a route range's live rows)
MAX_MAP_BYTES = 1 << 20
MAX_RESHARD_BYTES = 1 << 28


_HDR = struct.Struct("<IBBH")  # magic, version, op, reserved
_U32 = struct.Struct("<I")

ITEM_ROWS = 6  # fp_lo, fp_hi, hits, limit, divider, jitter

# Hard protocol cap on items per SUBMIT frame. The u32 count is
# client-supplied; without a bound a single bad frame (n=0xFFFFFFFF) would
# make the device-owner process try to buffer ~100 GB. Anything a frontend
# legitimately sends fits well under this (requests are a handful of items;
# the engine's own max_batch is 64k).
MAX_SUBMIT_ITEMS = 1 << 20


def parse_sidecar_address(address: str) -> tuple[str, object]:
    """("unix", path) | ("tcp"|"tls", (host, port)). Anything without a
    tcp:// or tls:// scheme is a unix socket path (backward compatible)."""
    for scheme in ("tcp", "tls"):
        prefix = scheme + "://"
        if address.startswith(prefix):
            hostport = address[len(prefix):]
            host, sep, port = hostport.rpartition(":")
            if not sep or not port.isdigit():
                raise ValueError(
                    f"sidecar address {address!r} must be {scheme}://host:port"
                )
            # [v6::literal]:port — strip the brackets for the socket APIs
            if host.startswith("[") and host.endswith("]"):
                host = host[1:-1]
            return scheme, (host or "127.0.0.1", int(port))
    return "unix", address


class StaleMapError(CacheError):
    """A SUBMIT was refused with STATUS_STALE_MAP: the owner holds a
    newer (or conflicting) PartitionMap than the one this frame was
    routed with, and the write was NOT applied. Carries the owner's map
    JSON so the router (cluster/router.py) adopts it, re-buckets, and
    resubmits; callers without a router see an ordinary CacheError and
    degrade through the FAILURE_MODE_DENY ladder."""

    def __init__(self, message: str, map_json: bytes):
        super().__init__(message)
        self.map_json = map_json


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("sidecar connection closed")
        buf.extend(chunk)
    return bytes(buf)


def encode_items(items) -> bytes:
    """uint32[6, n] block from a list of _Item (backends/cuda.py)."""
    n = len(items)
    block = np.empty((ITEM_ROWS, n), dtype=np.uint32)
    fp = np.fromiter((it.fp for it in items), dtype=np.uint64, count=n)
    block[0] = (fp & 0xFFFFFFFF).astype(np.uint32)
    block[1] = (fp >> np.uint64(32)).astype(np.uint32)
    block[2] = np.fromiter((it.hits for it in items), np.uint32, n)
    block[3] = np.fromiter((it.limit for it in items), np.uint32, n)
    block[4] = np.fromiter((it.divider for it in items), np.uint32, n)
    block[5] = np.fromiter((it.jitter for it in items), np.uint32, n)
    return _U32.pack(n) + block.tobytes()


def decode_block(payload: bytes) -> np.ndarray:
    """uint32[6, n] wire block view (read-only) from a SUBMIT payload."""
    (n,) = _U32.unpack_from(payload)
    return np.frombuffer(
        payload, dtype=np.uint32, count=ITEM_ROWS * n, offset=_U32.size
    ).reshape(ITEM_ROWS, n)


def decode_items(payload: bytes):
    """Inverse of encode_items; returns a list of _Item."""
    from .cuda import _Item

    block = decode_block(payload)
    n = block.shape[1]
    fp = block[0].astype(np.uint64) | (block[1].astype(np.uint64) << np.uint64(32))
    return [
        _Item(
            fp=int(fp[i]),
            hits=int(block[2, i]),
            limit=int(block[3, i]),
            divider=int(block[4, i]),
            jitter=int(block[5, i]),
        )
        for i in range(n)
    ]




class SlabSidecarServer:
    """The device-owner process's listener. Accepts frontend connections on
    a unix socket or a TCP(+TLS) listener; each SUBMIT goes to the engine
    (submit_block in block mode), whose dispatch loop coalesces the items of
    every connected frontend into shared launches. An engine without
    block_mode gets the reference's item-list verb, submit(items)."""

    def __init__(
        self,
        address: str,
        engine,
        socket_mode: int = 0o600,
        tls_cert: str = "",
        tls_key: str = "",
        tls_ca: str = "",
        fault_injector=None,
        shm_control_path: str = "",
        time_source=None,
        repl=None,
        cluster=None,
        fed=None,
    ):
        """address: unix path, tcp://host:port, or tls://host:port.

        repl: optional persist.replication.ReplicationCoordinator. When
        set, OP_REPL_SUBSCRIBE connections become its ship loops, a
        standby's first SUBMIT promotes it (epoch bump, reconcile and
        upload, then the write runs against the promoted slab), and
        FLAG_EPOCH frames are epoch-fenced: a frame carrying a NEWER epoch
        than this owner's proves a standby was promoted past it, so the
        write is rejected with STATUS_STALE_EPOCH and never runs (the
        split-brain guard). None keeps the pre-replication behaviour.

        cluster: optional cluster.node.ClusterNode, this owner's partition
        membership. When set, SUBMIT frames are fenced against the node's
        PartitionMap (a stale or misrouted frame gets STATUS_STALE_MAP and
        the current map, never applied) and OP_MAP_GET/SET are served.
        None keeps the pre-cluster behaviour. The reshard ops
        (OP_RESHARD_PULL/PUSH) are served from the engine either way.

        fed: optional cluster.federation.FederationCoordinator. When set,
        OP_FED_EXCHANGE connections (borrower clusters dialing this
        cluster's share ledger) become its exchange loops; None answers
        them "federation not configured".

        fault_injector: optional testing.faults.FaultInjector (any object
        with fire(site) -> action), consulted at site
        'sidecar.server.submit' before each SUBMIT reaches the engine
        (delay_ms = slow engine, error = error reply, drop = connection
        drop without a response, partial_write = truncated response).
        OP_FAULTS_SET reconfigures it (it needs configure() and
        describe()); None answers that op "fault injector not configured
        on this owner".

        shm_control_path: when set and the engine has a dispatch loop, the
        shm ring control socket (backends/shm_ring.py ShmControlServer)
        listens there, so same-host frontend processes publish into the
        loop directly. An engine in direct mode has no loop: the control
        socket is not started, and this owner serves the socket RPC only.

        time_source: the OP_CLOCK_SET target, the process clock authority
        when None.

        socket_mode (unix only): filesystem mode of the socket node.
        Default 0o600 restricts to same-UID frontends; any process that
        can connect can drive arbitrary counter increments, so never make
        it world-connectable. For tcp://, bind a private interface or use
        tls:// with tls_ca (mutual TLS: only cert-holding frontends
        connect).

        tls_cert/tls_key (tls only): server certificate + key, required.
        tls_ca (tls only): when set, frontends must present a client
        certificate signed by this CA."""
        self._engine = engine
        self._faults = fault_injector
        self._repl = repl
        self._cluster = cluster
        self._fed = fed
        self._time_source = (
            time_source if time_source is not None else process_time_source()
        )
        self._shm_control = None
        if shm_control_path:
            loop = getattr(engine, "dispatch_loop", None)
            if loop is None:
                logger.warning(
                    "SHM_RINGS requested but the engine has no dispatch "
                    "loop (direct mode / DISPATCH_LOOP=false): shm "
                    "control socket NOT started, socket RPC only"
                )
            else:
                from .shm_ring import ShmControlServer

                self._shm_control = ShmControlServer(
                    loop, shm_control_path, socket_mode=socket_mode
                )
        self._scheme, target = parse_sidecar_address(address)
        self._path = address
        self._tls_ctx = None
        if self._scheme == "unix":
            try:
                os.unlink(target)
            except FileNotFoundError:
                pass
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            # bind-then-chmod: Linux checks AF_UNIX connect permissions
            # against the node's mode at connect time, and the chmod lands
            # before listen() accepts anyone
            self._sock.bind(target)
            os.chmod(target, socket_mode)
        else:
            if self._scheme == "tls":
                if not tls_cert or not tls_key:
                    raise ValueError("tls:// sidecar requires tls_cert + tls_key")
                self._tls_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
                self._tls_ctx.load_cert_chain(tls_cert, tls_key)
                if tls_ca:
                    self._tls_ctx.load_verify_locations(tls_ca)
                    self._tls_ctx.verify_mode = ssl.CERT_REQUIRED
            # family from getaddrinfo so v6 literals/AAAA-only hosts bind
            info = socket.getaddrinfo(target[0], target[1], type=socket.SOCK_STREAM)[0]
            self._sock = socket.socket(info[0], socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind(info[4])
        self._sock.listen(128)
        self._stop = threading.Event()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="sidecar-accept", daemon=True
        )
        self._accept_thread.start()
        logger.info("slab sidecar listening on %s", address)

    @property
    def port(self) -> int:
        """Bound TCP port (tests bind port 0)."""
        return self._sock.getsockname()[1]

    @property
    def shm_control(self):
        """The shm ring control server, or None (SHM_RINGS off, a tcp://
        owner, or an engine without a dispatch loop)."""
        return self._shm_control

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,), daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            net = self._scheme in ("tcp", "tls")
            if net:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self._tls_ctx is not None:
                # handshake on the connection's own thread, bounded: an
                # unauthenticated peer must not pin this thread forever
                conn.settimeout(10.0)
                conn = self._tls_ctx.wrap_socket(conn, server_side=True)
                conn.settimeout(None)
            with conn:
                while not self._stop.is_set():
                    # idle waits are unbounded (frontends pool connections
                    # between requests) but once a frame starts it must
                    # finish promptly
                    if net:
                        conn.settimeout(None)
                    hdr = _recv_exact(conn, _HDR.size)
                    if net:
                        conn.settimeout(30.0)
                    magic, version, op, hdr_flags = _HDR.unpack(hdr)
                    if magic != MAGIC or version != VERSION:
                        conn.sendall(self._error(f"bad header {hdr!r}"))
                        return
                    if op == OP_PING:
                        conn.sendall(b"\x00")
                        continue
                    if op == OP_REPL_SUBSCRIBE:
                        # u32 epoch | u64 last_seq (diagnostic: the ship
                        # loop always starts with a full snapshot)
                        _recv_exact(conn, 12)
                        if self._repl is None:
                            conn.sendall(self._error("replication not configured"))
                            return
                        if net:
                            conn.settimeout(None)
                        # the connection becomes this subscriber's ship
                        # loop; it never returns to request/response
                        self._repl.serve_subscriber(conn)
                        return
                    if op == OP_FED_EXCHANGE:
                        if self._fed is None:
                            conn.sendall(self._error("federation not configured"))
                            return
                        if net:
                            conn.settimeout(None)
                        # the connection becomes this borrower's exchange
                        # loop; it never returns to request/response
                        self._fed.serve_exchange(conn)
                        return
                    if op in (
                        OP_MAP_GET,
                        OP_MAP_SET,
                        OP_RESHARD_PULL,
                        OP_RESHARD_PUSH,
                        OP_HOTKEYS_GET,
                        OP_FAULTS_SET,
                        OP_CLOCK_SET,
                    ):
                        if not self._serve_admin_op(conn, op):
                            return
                        continue
                    if op != OP_SUBMIT:
                        conn.sendall(self._error(f"bad op {op}"))
                        return
                    if not self._serve_submit(conn, hdr_flags):
                        return
        except (ConnectionError, OSError):
            return  # frontend went away

    def _serve_submit(self, conn: socket.socket, hdr_flags: int) -> bool:
        """One SUBMIT frame: read it whole (block and trailers) before any
        fault handling so the framing stays coherent, run it through the
        engine under a server span parented by the wire context, and
        answer. Returns False when the connection should close."""
        (n,) = _U32.unpack(n_raw := _recv_exact(conn, _U32.size))
        if n > MAX_SUBMIT_ITEMS:
            # reject BEFORE buffering the payload
            conn.sendall(self._error(f"submit count {n} exceeds cap {MAX_SUBMIT_ITEMS}"))
            return False
        payload = n_raw + _recv_exact(conn, ITEM_ROWS * n * 4)
        lease_blob = None
        if hdr_flags & FLAG_LEASE:
            (blob_len,) = _U32.unpack(_recv_exact(conn, _U32.size))
            if blob_len > MAX_LEASE_TRAILER:
                conn.sendall(
                    self._error(f"lease trailer {blob_len} exceeds cap {MAX_LEASE_TRAILER}")
                )
                return False
            lease_blob = _recv_exact(conn, blob_len)
        # the fence trailers (fixed u32 each), read before any fault
        # handling so the frame stays coherent on the wire
        frame_epoch = None
        if hdr_flags & FLAG_EPOCH:
            (frame_epoch,) = _U32.unpack(_recv_exact(conn, _U32.size))
        frame_map_epoch = None
        if hdr_flags & FLAG_MAP:
            (frame_map_epoch,) = _U32.unpack(_recv_exact(conn, _U32.size))
        wire_ctx = None
        if hdr_flags & FLAG_TRACE:
            # a malformed trailer decodes to None and the request goes on
            # untraced, never fails
            (blob_len,) = _U32.unpack(_recv_exact(conn, _U32.size))
            if blob_len > MAX_TRACE_TRAILER:
                conn.sendall(
                    self._error(f"trace trailer {blob_len} exceeds cap {MAX_TRACE_TRAILER}")
                )
                return False
            wire_ctx = decode_textmap(_recv_exact(conn, blob_len))
        if self._faults is not None:
            action = self._faults.fire("sidecar.server.submit")
            if action == "drop":
                return False  # the connection dies without a response
            if action == "error":
                conn.sendall(self._error("injected fault"))
                return True
            if action == "partial_write":
                # status byte without the counts, then close
                conn.sendall(b"\x00")
                return False
        if self._cluster is not None:
            # the routing fence: a frame routed with a stale map, or holding
            # rows this partition does not own, gets the CURRENT map and is
            # never applied; checked before the promote-on-write so a
            # misrouted frame cannot promote a standby not meant for it
            stale_map = self._cluster.check_block(frame_map_epoch, decode_block(payload))
            if stale_map is not None:
                conn.sendall(bytes([STATUS_STALE_MAP]) + _U32.pack(len(stale_map)) + stale_map)
                return True
        if self._repl is not None:
            # a write reaching a standby IS the failover signal: promote
            # (epoch bump, reconcile, upload) before running it. Idempotent
            # and thread-safe: concurrent first writes all wait on the one
            # transition
            if self._repl.is_standby or self._repl.promoting:
                self._repl.promote(reason="client write reached standby")
            if frame_epoch is not None and frame_epoch > self._repl.epoch:
                # the split-brain guard: the client has seen a newer epoch
                # than this owner serves, so this is a resurrected stale
                # primary and the write must not touch its slab
                self._repl.note_stale_write(frame_epoch)
                conn.sendall(bytes([STATUS_STALE_EPOCH]) + _U32.pack(self._repl.epoch))
                return True
        # the server span, parented by the frontend's wire context and
        # activated so the dispatch loop links its batch span to it; and
        # the owner-side journey
        tracer = global_tracer()
        server_span = None
        if wire_ctx is not None and tracer.enabled:
            server_span = tracer.start_span(
                "sidecar.submit_rows",
                child_of=wire_ctx,
                tags={"span.kind": "server", "component": "sidecar", "batch_items": n},
            )
        recorder = journeys.global_recorder()
        journey = None
        if recorder is not None:
            journey = recorder.begin(
                "sidecar.submit",
                trace_id=wire_ctx.trace_id if wire_ctx else 0,
                span_id=wire_ctx.span_id if wire_ctx else 0,
            )
        t_req_ns = time.monotonic_ns()
        try:
            scope_cm = activate(server_span) if server_span is not None else contextlib.nullcontext()
            with scope_cm:
                if getattr(self._engine, "block_mode", False):
                    # the wire block is the device input: no per-item
                    # Python objects on the aggregation path
                    afters = self._engine.submit_block(decode_block(payload))
                else:
                    # the reference's item-list engine protocol; no
                    # SlabDeviceEngine takes it (test doubles do)
                    afters = self._engine.submit(decode_items(payload))
            out = np.asarray(afters, dtype=np.uint32)
            if lease_blob is not None:
                # register the frame's lease liabilities with the launch's
                # counters as floors; a malformed trailer is an error reply
                # (the increments are already applied)
                self._apply_lease_blob(lease_blob, payload, out)
            # close the span and journey before the reply hits the wire
            if server_span is not None:
                server_span.finish()
            if journey is not None:
                recorder.finish(journey, (time.monotonic_ns() - t_req_ns) / 1e6)
            if frame_epoch is not None:
                # the epoch-carrying reply, so a failed-over client learns
                # the promoted epoch; an owner without replication answers
                # 0 (clients ignore it)
                my_epoch = self._repl.epoch if self._repl is not None else 0
                conn.sendall(
                    bytes([STATUS_OK_EPOCH]) + _U32.pack(my_epoch) + _U32.pack(len(out)) + out.tobytes()
                )
            else:
                conn.sendall(b"\x00" + _U32.pack(len(out)) + out.tobytes())
        except Exception as e:  # noqa: BLE001 - surface to the client
            if server_span is not None:
                server_span.set_error(e)
                server_span.finish()
            if journey is not None:
                recorder.finish(
                    journey,
                    (time.monotonic_ns() - t_req_ns) / 1e6,
                    flags=(journeys.FLAG_FAULT,),
                )
            if self._stop.is_set():
                # shutting down: let the connection die rather than answer
                # an error. A transport failure is retryable (the closed
                # engine never ran the batch); an error reply is not
                return False
            logger.exception("sidecar submit failed")
            conn.sendall(self._error(str(e)))
        return True

    def _apply_lease_blob(self, lease_blob: bytes, payload: bytes, out: np.ndarray) -> None:
        """Decode one frame's lease trailer and register it against the
        engine's liability registry (an engine without one ignores lease
        traffic)."""
        apply_ops = getattr(self._engine, "apply_lease_ops", None)
        if apply_ops is None:
            return
        from .lease import decode_lease_ops

        apply_ops(decode_block(payload), out, decode_lease_ops(lease_blob))

    def _serve_admin_op(self, conn: socket.socket, op: int) -> bool:
        """One admin RPC: u8 status | u32 len | blob, or the error frame.
        Returns False when the connection should close (a body past its
        cap)."""
        body = b""
        if op == OP_RESHARD_PULL:
            lo, hi, route_sets = struct.unpack("<III", _recv_exact(conn, 12))
        elif op in (OP_MAP_SET, OP_RESHARD_PUSH, OP_FAULTS_SET, OP_CLOCK_SET):
            (blob_len,) = _U32.unpack(_recv_exact(conn, _U32.size))
            cap = MAX_MAP_BYTES if op != OP_RESHARD_PUSH else MAX_RESHARD_BYTES
            if blob_len > cap:
                conn.sendall(self._error(f"cluster op body {blob_len} exceeds cap {cap}"))
                return False
            body = _recv_exact(conn, blob_len)
        if self._cluster is None and op in (OP_MAP_GET, OP_MAP_SET):
            conn.sendall(self._error("cluster not configured"))
            return True
        try:
            if op == OP_FAULTS_SET:
                out = self._serve_faults_set(body)
            elif op == OP_CLOCK_SET:
                out = self._serve_clock_set(body)
            elif op == OP_HOTKEYS_GET:
                snap_fn = getattr(self._engine, "hotkeys_snapshot", None)
                snap = (
                    snap_fn()
                    if snap_fn is not None
                    else {"enabled": False, "k": 0, "lanes": 0, "drains": 0, "top": []}
                )
                out = json.dumps(snap).encode()
            elif op == OP_MAP_GET:
                out = self._cluster.pmap.to_json_bytes()
            elif op == OP_MAP_SET:
                adopted = self._cluster.adopt_json(body)
                out = json.dumps({"adopted": adopted, "epoch": self._cluster.epoch}).encode()
            elif op == OP_RESHARD_PULL:
                from ..persist.snapshot import pack_table_bytes

                rows = self._engine.export_route_range(lo, hi, route_sets)
                engine_ts = getattr(self._engine, "_time_source", None)
                snap_now = (
                    engine_ts.unix_now() if engine_ts is not None else process_time_source().unix_now()
                )
                out = pack_table_bytes(rows, snap_now, ways=getattr(self._engine, "ways", 0))
            else:  # OP_RESHARD_PUSH
                from ..persist.snapshot import unpack_table_bytes

                _hdr, rows, _off = unpack_table_bytes(body, what="<reshard push>")
                out = json.dumps(self._engine.merge_rows(rows)).encode()
        except Exception as e:  # noqa: BLE001 - surface to the caller
            logger.exception("admin op %d failed", op)
            conn.sendall(self._error(str(e)))
            return True
        conn.sendall(b"\x00" + _U32.pack(len(out)) + out)
        return True

    def _serve_faults_set(self, body: bytes) -> bytes:
        """OP_FAULTS_SET: replace the owner's live fault rule set. The
        injector is the one the engine, snapshotter, replication and
        federation already hold (cmd/sidecar_cmd.py always builds it); a
        junk spec raises, which the admin-op wrapper answers with the
        error frame, nothing changed."""
        from ..testing.faults import parse_fault_spec

        if self._faults is None:
            raise ValueError("fault injector not configured on this owner")
        doc = json.loads(body.decode("utf-8")) if body else {}
        rules = parse_fault_spec(str(doc.get("spec", "")))
        seed = doc.get("seed")
        self._faults.configure(rules, seed=None if seed is None else int(seed))
        return json.dumps(self._faults.describe()).encode()

    def _serve_clock_set(self, body: bytes) -> bytes:
        """OP_CLOCK_SET: step/drift this owner's clock authority; an
        un-skewable source answers the error frame."""
        ts = self._time_source
        set_skew = getattr(ts, "set_skew", None)
        if set_skew is None:
            raise ValueError("owner time source is not skewable")
        doc = json.loads(body.decode("utf-8")) if body else {}
        set_skew(
            offset_s=float(doc.get("offset_s", 0.0)),
            drift_ppm=float(doc.get("drift_ppm", 0.0)),
        )
        return json.dumps({"unix_now": ts.unix_now(), "skew": ts.skew()}).encode()

    @staticmethod
    def _error(message: str) -> bytes:
        raw = message.encode()
        return b"\x01" + _U32.pack(len(raw)) + raw

    def close(self) -> None:
        self._stop.set()
        if self._shm_control is not None:
            self._shm_control.close()
        # shutdown BEFORE close: a thread blocked in accept() does not
        # reliably wake on close() alone, which would keep the port held
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._accept_thread.join(5.0)
        if self._scheme == "unix":
            try:
                os.unlink(self._path)
            except OSError:
                pass
        self._engine.close()


class SidecarEngineClient:
    """Frontend-side device driver: the engine verbs (submit_rows, submit,
    flush, close) executed by the device-owner process. Connections are
    pooled so frontend threads overlap their RPCs, which the owner's
    dispatch loop turns into bigger launches."""

    def __init__(
        self,
        address,
        pool_size: int = 8,
        timeout: float = 30.0,
        tls_ca: str = "",
        tls_cert: str = "",
        tls_key: str = "",
        tls_server_name: str = "",
        scope=None,
        connect_timeout: float | None = None,
        rpc_deadline: float | None = None,
        retries: int = 2,
        retry_backoff: float = 0.01,
        retry_backoff_max: float = 0.25,
        breaker_threshold: int = 5,
        breaker_reset: float = 5.0,
        fault_injector=None,
        sleep=time.sleep,
        shm_control_path: str = "",
        shm_ring_rows: int = 4096,
        map_epoch_fn=None,
    ):
        """address: unix path, tcp://host:port, or tls://host:port, or a
        LIST of them (equivalently one comma-separated string: the
        SIDECAR_ADDRS form). The first entry is the primary; the rest are
        warm standbys in failover order. With more than one address the
        client is epoch-aware: every SUBMIT carries a FLAG_EPOCH trailer
        with the highest epoch it has seen; the breaker opening, an
        address's retry budget running out, or a stale-epoch reply moves
        it to the next address, whose first write promotes it; and a
        resurrected stale primary answering STATUS_STALE_EPOCH is failed
        away from instead of trusted. A single address keeps the legacy
        frames byte for byte (the rollback arm).
        tls_ca: CA bundle the server cert must chain to (the system store
        when empty). tls_cert/tls_key: client certificate for mutual TLS.
        tls_server_name: SNI/hostname override when the cert CN does not
        match the dialed host.

        scope: optional stats Scope; records <scope>.sidecar.rpc_ms (the
        SUBMIT round trip: socket plus the owner's own stages) and shm_ms
        (the shm arm's), the <scope>.sidecar.{retry,redial,breaker_open,
        failover,shm_fallback} counters, and the breaker_state (0 closed /
        1 half-open / 2 open), active_backend (the index of the address
        in use) and shm_active gauges.

        connect_timeout / rpc_deadline: dial timeout vs per-RPC deadline
        (send + full response read); both default to `timeout`.

        retries / retry_backoff / retry_backoff_max: bounded retries for
        TRANSPORT failures (dial errors, resets, deadline expiry) with
        exponential backoff and full jitter. Error REPLIES from the owner
        are never retried (the engine may have applied the increment). A
        POOLED connection that dies mid-RPC gets one free redial after
        evicting the whole pool, outside the retry budget.

        breaker_threshold / breaker_reset: consecutive transport failures
        that open the circuit, and the open -> half-open probe delay; 0
        disables the breaker. While open, submits fail fast with
        CacheError.

        fault_injector: optional fire(site) -> action object, consulted at
        'sidecar.dial' per dial and 'sidecar.submit' per SUBMIT attempt.

        shm_control_path (SHM_RINGS; backends/shm_ring.py): when set and
        this is a SINGLE-address client, plain row-block submits publish
        through a shared-memory ring straight into the owner's dispatch
        loop. Frames with a lease trailer stay on the socket, multi-address
        clients never attach (shm frames carry no epoch fence), and a shm
        TRANSPORT failure falls back to the socket RPC per call
        (<scope>.sidecar.shm_fallback).

        map_epoch_fn: optional zero-argument callable returning the epoch
        of the PartitionMap this client's frames were routed with (the
        partition router sets it on each per-partition client). When set,
        every SUBMIT carries a FLAG_MAP trailer, and a STATUS_STALE_MAP
        reply raises StaleMapError (carrying the owner's map) instead of
        retrying: re-bucketing is the router's job. None ships the
        pre-cluster frames."""
        self._map_epoch_fn = map_epoch_fn
        self._h_rpc = None
        self._h_shm = None
        self._c_retry = self._c_redial = self._c_breaker_open = None
        self._c_failover = self._c_shm_fallback = None
        self._g_breaker_state = self._g_active_backend = None
        self._g_shm_active = None
        if scope is not None:
            sc = scope.scope("sidecar")
            self._h_rpc = sc.histogram("rpc_ms")
            self._h_shm = sc.histogram("shm_ms")
            self._c_retry = sc.counter("retry")
            self._c_redial = sc.counter("redial")
            self._c_breaker_open = sc.counter("breaker_open")
            self._c_failover = sc.counter("failover")
            self._c_shm_fallback = sc.counter("shm_fallback")
            self._g_breaker_state = sc.gauge("breaker_state")
            self._g_breaker_state.set(0)
            self._g_active_backend = sc.gauge("active_backend")
            self._g_active_backend.set(0)
            self._g_shm_active = sc.gauge("shm_active")
            self._g_shm_active.set(0)
        if isinstance(address, str):
            addrs = [a.strip() for a in address.split(",") if a.strip()]
        else:
            addrs = [str(a) for a in address]
        if not addrs:
            raise ValueError("sidecar address list is empty")
        self._addrs = addrs
        self._addr_lock = threading.Lock()
        self._active = 0
        # epoch awareness exists only with standbys to fail over to; a
        # single-address client ships the legacy frame (flags bit 2 clear,
        # no trailer), byte for byte
        self._epoch_aware = len(addrs) > 1
        self._epoch_known = 0
        self._path = addrs[0]
        self._scheme, self._target = parse_sidecar_address(self._path)
        self._connect_timeout = timeout if connect_timeout is None else float(connect_timeout)
        self._rpc_deadline = timeout if rpc_deadline is None else float(rpc_deadline)
        self._retries = max(0, int(retries))
        self._retry_backoff = max(0.0, float(retry_backoff))
        self._retry_backoff_max = max(self._retry_backoff, float(retry_backoff_max))
        self._breaker_reset = float(breaker_reset)
        self._breaker = CircuitBreaker(
            breaker_threshold, breaker_reset, on_transition=self._on_breaker_transition
        )
        self._faults = fault_injector
        self._sleep = sleep
        # full jitter: concurrent threads retrying a restarted owner must
        # not re-dial in lockstep
        self._jitter = random.Random()
        self._tls_ctx = None
        self._tls_server_name = tls_server_name
        if self._scheme == "tls":
            self._tls_ctx = ssl.create_default_context(cafile=tls_ca or None)
            if tls_cert and tls_key:
                self._tls_ctx.load_cert_chain(tls_cert, tls_key)
        self._pool: list[socket.socket] = []
        self._pool_lock = threading.Lock()
        self._pool_size = pool_size
        self._closed = False
        # fail fast like the reference's startup PING (driver_impl.go:
        # 124-128). The read is part of the check: under TLS 1.3 a rejected
        # client certificate only surfaces on the first read. Not retried
        # and not breaker-counted: a frontend booting against a dark owner
        # fails its boot loudly. With a failover list the ping walks it: a
        # dark primary with a live standby is the redundancy story, not a
        # boot failure.
        last_err: CacheError | None = None
        for _ in range(len(self._addrs)):
            try:
                self._ping()
                last_err = None
                break
            except CacheError as e:
                last_err = e
                if not self._epoch_aware:
                    raise
                self._failover(cause=f"boot ping failed: {e}")
        if last_err is not None:
            raise last_err
        # the shm rings, attached once the ping proved the owner up. An
        # owner that offers none (no SHM_RINGS, direct mode) leaves the
        # socket RPC as the only path; a multi-address client never
        # attaches (shm frames carry no epoch fence)
        self._shm = None
        if shm_control_path and not self._epoch_aware:
            from .shm_ring import ShmRingClient, ShmUnavailable

            try:
                self._shm = ShmRingClient(
                    shm_control_path,
                    arena_rows=int(shm_ring_rows),
                    submit_timeout=self._rpc_deadline,
                    fault_injector=fault_injector,
                )
                if self._g_shm_active is not None:
                    self._g_shm_active.set(1)
                logger.info("shm submit rings active via %s", shm_control_path)
            except ShmUnavailable as e:
                logger.info("shm submit rings not offered by the owner (%s): socket RPC only", e)
            except Exception as e:  # noqa: BLE001 - the rings are optional
                logger.warning("shm submit rings unavailable (%s): socket RPC only", e)

    def _on_breaker_transition(self, prev: str, state: str) -> None:
        if self._g_breaker_state is not None:
            self._g_breaker_state.set(CircuitBreaker.STATE_CODES[state])
        if state == CircuitBreaker.OPEN:
            if self._c_breaker_open is not None:
                self._c_breaker_open.inc()
            logger.warning(
                "sidecar circuit OPEN on %s: failing fast for %.3fs",
                self._path, self._breaker_reset,
            )
        elif state == CircuitBreaker.CLOSED and prev != CircuitBreaker.CLOSED:
            logger.info("sidecar circuit closed on %s", self._path)

    def _ping(self) -> None:
        conn = self._dial()
        try:
            conn.sendall(_HDR.pack(MAGIC, VERSION, OP_PING, 0))
            ok = _recv_exact(conn, 1) == b"\x00"
        except (OSError, ConnectionError) as e:
            conn.close()
            raise CacheError(f"sidecar ping failed on {self._path}: {e}") from e
        if not ok:
            conn.close()
            raise CacheError(f"sidecar ping failed on {self._path}")
        self._release(conn)

    @property
    def breaker(self) -> CircuitBreaker:
        """The transport circuit breaker."""
        return self._breaker

    @property
    def active_address(self) -> str:
        """The address currently written to."""
        with self._addr_lock:
            return self._addrs[self._active]

    def failover_reason(self) -> str | None:
        """HealthChecker degraded-probe contract: a reason while this
        frontend serves from a non-primary address (one more failure from
        the degradation ladder), shown on /healthcheck while it serves."""
        with self._addr_lock:
            if self._active == 0:
                return None
            return (
                f"sidecar.failover: serving from standby "
                f"{self._addrs[self._active]} (primary {self._addrs[0]} "
                f"unreachable or stale)"
            )

    def _active_index(self) -> int:
        with self._addr_lock:
            return self._active

    def _failover(self, cause: str, span=None, expect: int | None = None) -> str:
        """Rotate to the next address in SIDECAR_ADDRS order: evict every
        pooled connection (they point at the dead or stale owner), reset
        the breaker for the new target, and mark the moment on the active
        trace span and journey (FLAG_FAILOVER). Returns the new address.

        expect: the address index the caller's failed attempts used. When
        another thread has already moved the client on from it, nothing
        rotates (the caller retries at the address in use): threads that
        fail together at a dead primary move the client once, not once
        each. The reference rotates on every call, so two threads failing
        at once rotate back to the dead primary."""
        with self._addr_lock:
            if expect is not None and expect != self._active:
                return self._addrs[self._active]
            self._active = (self._active + 1) % len(self._addrs)
            self._path = self._addrs[self._active]
            self._scheme, self._target = parse_sidecar_address(self._path)
            new_addr = self._path
            active = self._active
        self._evict_pool()
        # a fresh target deserves a closed breaker: the failure streak
        # belongs to the address just left
        self._breaker.record_success()
        if self._c_failover is not None:
            self._c_failover.inc()
        if self._g_active_backend is not None:
            self._g_active_backend.set(active)
        logger.warning(
            "sidecar FAILOVER to %s (backend %d of %d): %s",
            new_addr, active + 1, len(self._addrs), cause,
        )
        target_span = span if span is not None else active_span()
        if target_span is not None:
            target_span.log_kv(event="sidecar.failover", to=new_addr, cause=cause)
        journeys.note_flag(journeys.FLAG_FAILOVER)
        return new_addr

    def _dial(self) -> socket.socket:
        with self._addr_lock:
            scheme, target, path = self._scheme, self._target, self._path
        if self._faults is not None:
            action = self._faults.fire("sidecar.dial")
            if action is not None:
                raise CacheError(f"cannot reach slab sidecar at {path}: injected fault: {action}")
        if scheme == "unix":
            conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            conn.settimeout(self._connect_timeout)
            try:
                conn.connect(target)
            except OSError as e:
                conn.close()
                raise CacheError(f"cannot reach slab sidecar at {path}: {e}")
            conn.settimeout(self._rpc_deadline)
            return conn
        try:
            conn = socket.create_connection(target, timeout=self._connect_timeout)
        except OSError as e:
            raise CacheError(f"cannot reach slab sidecar at {path}: {e}")
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self._tls_ctx is not None:
                conn = self._tls_ctx.wrap_socket(
                    conn, server_hostname=self._tls_server_name or target[0]
                )
        except OSError as e:
            conn.close()
            raise CacheError(f"sidecar TLS handshake failed on {path}: {e}")
        conn.settimeout(self._rpc_deadline)
        return conn

    def _acquire(self) -> tuple[socket.socket, bool]:
        """(connection, came_from_pool): only an idle pooled socket earns
        the free redial (a fresh dial dying mid-RPC is a live failure)."""
        with self._pool_lock:
            if self._pool:
                return self._pool.pop(), True
        return self._dial(), False

    def _release(self, conn: socket.socket) -> None:
        with self._pool_lock:
            if not self._closed and len(self._pool) < self._pool_size:
                self._pool.append(conn)
                return
        conn.close()

    def _evict_pool(self) -> None:
        """Close every pooled connection: an owner restart stales the whole
        pool, and evicting it at once keeps one restart from costing
        pool_size failures."""
        with self._pool_lock:
            stale, self._pool = self._pool, []
        for conn in stale:
            conn.close()

    def _backoff(self, attempt: int) -> float:
        """Exponential backoff with full jitter for retry `attempt` (1-based)."""
        ceiling = min(self._retry_backoff_max, self._retry_backoff * (2 ** (attempt - 1)))
        return self._jitter.uniform(0.0, ceiling)

    def submit(self, items) -> list[int]:
        if not items:
            return []
        return self._submit_payload(encode_items(items)).tolist()

    def submit_rows(self, block: np.ndarray, lease_ops=None) -> np.ndarray:
        """The row verb: the uint32[6, n] block IS the wire layout, so the
        frame is one header and one buffer copy. lease_ops
        (backends/lease.py LeaseOps) rides the frame as the FLAG_LEASE
        trailer: the grants' INCRBY is already in the hits column, and the
        owner registers the liability after the launch."""
        n = block.shape[1]
        if n == 0:
            return np.empty(0, dtype=np.uint32)
        has_lease = lease_ops is not None and (lease_ops.grants or lease_ops.settles)
        # shm fast path for plain frames; a lease trailer rides the socket,
        # and a dead shm transport falls back per call
        shm = self._shm
        if shm is not None and not has_lease and not shm.dead:
            from .shm_ring import ShmUnavailable

            t0 = time.perf_counter() if self._h_shm is not None else 0.0
            try:
                out = shm.submit(block)
                if self._h_shm is not None:
                    self._h_shm.record((time.perf_counter() - t0) * 1e3)
                return out
            except ShmUnavailable as e:
                if self._c_shm_fallback is not None:
                    self._c_shm_fallback.inc()
                if self._g_shm_active is not None and shm.dead:
                    self._g_shm_active.set(0)
                logger.warning("shm submit unavailable (%s): falling back to socket", e)
        payload = _U32.pack(n) + np.ascontiguousarray(block, dtype=np.uint32).tobytes()
        extra_flags = 0
        if has_lease:
            from .lease import encode_lease_ops

            payload += encode_lease_ops(lease_ops)
            extra_flags = FLAG_LEASE
        return self._submit_payload(payload, extra_flags)

    def _submit_payload(self, payload: bytes, extra_flags: int = 0) -> np.ndarray:
        t0 = time.perf_counter() if self._h_rpc is not None else 0.0
        if not self._breaker.allow():
            # the breaker opening on the primary IS the failover trigger:
            # with a standby configured, switch instead of failing fast
            # (its first write will promote it)
            if self._epoch_aware:
                self._failover(cause="circuit breaker open", expect=self._active_index())
            else:
                raise CacheError(f"sidecar circuit open on {self._path}: failing fast")
        # B3 over the wire: a client child span whose context rides the
        # frame as the trace trailer; retries and redials log onto it.
        # Untraced requests build nothing and ship no extra bytes.
        parent = active_span()
        rpc_span = None
        hdr_flags = extra_flags
        epoch_trailer = b""
        if self._epoch_aware:
            # the split-brain fence: the highest epoch this client has
            # seen, so a resurrected stale primary rejects the write
            hdr_flags |= FLAG_EPOCH
            epoch_trailer = _U32.pack(self._epoch_known)
        map_trailer = b""
        if self._map_epoch_fn is not None:
            # the routing fence: the map these rows were bucketed with
            hdr_flags |= FLAG_MAP
            map_trailer = _U32.pack(int(self._map_epoch_fn()))
        trailer = b""
        if parent is not None and parent.tracer is not None:
            rpc_span = parent.tracer.start_span(
                "sidecar.submit",
                child_of=parent,
                tags={"span.kind": "client", "component": "sidecar"},
            )
            raw = encode_textmap(rpc_span.context)
            trailer = _U32.pack(len(raw)) + raw
            hdr_flags |= FLAG_TRACE
        request = (
            _HDR.pack(MAGIC, VERSION, OP_SUBMIT, hdr_flags)
            + payload
            + epoch_trailer
            + map_trailer
            + trailer
        )
        try:
            return self._submit_attempts(request, rpc_span, t0)
        except BaseException as e:
            if rpc_span is not None:
                rpc_span.set_error(e)
            raise
        finally:
            if rpc_span is not None:
                rpc_span.finish()

    def _submit_attempts(self, request: bytes, rpc_span, t0: float) -> np.ndarray:
        attempt = 0
        redialed = False
        # bounded address rotation per call: once an address's retry
        # budget runs out (or it answers stale-epoch) the request moves to
        # the next SIDECAR_ADDRS entry instead of failing, so a primary
        # crash with a live standby costs no failed request. At most one
        # pass over the list; then the error surfaces to the ladder.
        failovers = 0
        used = self._active_index()

        def fail_over_or_raise(cause: str) -> bool:
            nonlocal failovers, attempt, redialed
            if not self._epoch_aware or failovers >= len(self._addrs) - 1:
                return False
            failovers += 1
            attempt = 0
            redialed = False
            self._failover(cause, span=rpc_span, expect=used)
            return True

        while True:
            used = self._active_index()
            try:
                conn, pooled = self._acquire()
            except CacheError as e:
                # dial failure: transport-level, retried under the budget
                attempt += 1
                if attempt > self._retries:
                    self._breaker.record_failure()
                    if fail_over_or_raise(f"dial failed: {e}"):
                        continue
                    raise
                if self._c_retry is not None:
                    self._c_retry.inc()
                if rpc_span is not None:
                    rpc_span.log_kv(event="sidecar.retry", attempt=attempt, cause="dial", error=str(e))
                self._sleep(self._backoff(attempt))
                continue
            stale_epoch = None
            try:
                if self._faults is not None:
                    action = self._faults.fire("sidecar.submit")
                    if action is not None:
                        if rpc_span is not None:
                            rpc_span.log_kv(event="fault", site="sidecar.submit", kind=action)
                        raise ConnectionError(f"injected fault: {action}")
                conn.sendall(request)
                status = _recv_exact(conn, 1)
                if status == b"\x01":
                    (ln,) = _U32.unpack(_recv_exact(conn, _U32.size))
                    message = _recv_exact(conn, ln).decode()
                    self._release(conn)
                    # an error REPLY rode a healthy transport: never retried
                    # (the increment may have been applied)
                    self._breaker.record_success()
                    raise CacheError(f"sidecar error: {message}")
                if status == bytes([STATUS_STALE_MAP]):
                    # the owner refused the ROUTING, not the transport: the
                    # reply carries its map; re-bucketing is the router's
                    # job, so surface at once (no retry, no failover: every
                    # address of this partition serves that map or newer)
                    (ln,) = _U32.unpack(_recv_exact(conn, _U32.size))
                    map_json = _recv_exact(conn, ln)
                    self._release(conn)
                    self._breaker.record_success()
                    if rpc_span is not None:
                        rpc_span.log_kv(event="sidecar.stale_map")
                    raise StaleMapError(
                        f"sidecar at {self._path} rejected the frame's partition-map routing",
                        map_json,
                    )
                if status == bytes([STATUS_STALE_EPOCH]):
                    # the owner serves an OLDER epoch than this client has
                    # seen: a resurrected stale primary. The write was NOT
                    # applied; fail over (safe to re-send)
                    (stale_epoch,) = _U32.unpack(_recv_exact(conn, _U32.size))
                    self._release(conn)
                    self._breaker.record_success()
                else:
                    if status == bytes([STATUS_OK_EPOCH]):
                        (srv_epoch,) = _U32.unpack(_recv_exact(conn, _U32.size))
                        if srv_epoch > self._epoch_known:
                            self._epoch_known = srv_epoch
                    (n,) = _U32.unpack(_recv_exact(conn, _U32.size))
                    out = np.frombuffer(_recv_exact(conn, 4 * n), dtype=np.uint32)
            except CacheError:
                raise
            except (OSError, ConnectionError) as e:
                conn.close()
                if pooled and not redialed:
                    # an idle-stale pooled socket (an owner restart): evict
                    # the pool and redial once, outside the retry budget
                    redialed = True
                    self._evict_pool()
                    if self._c_redial is not None:
                        self._c_redial.inc()
                    if rpc_span is not None:
                        rpc_span.log_kv(event="sidecar.redial", error=str(e))
                    continue
                attempt += 1
                if attempt > self._retries:
                    self._breaker.record_failure()
                    if fail_over_or_raise(f"transport failure: {e}"):
                        continue
                    raise CacheError(f"sidecar transport failure: {e}") from e
                if self._c_retry is not None:
                    self._c_retry.inc()
                if rpc_span is not None:
                    rpc_span.log_kv(
                        event="sidecar.retry", attempt=attempt, cause="transport", error=str(e)
                    )
                self._sleep(self._backoff(attempt))
                continue
            if stale_epoch is not None:
                if rpc_span is not None:
                    rpc_span.log_kv(
                        event="sidecar.stale_epoch",
                        server_epoch=stale_epoch,
                        known_epoch=self._epoch_known,
                    )
                if fail_over_or_raise(f"stale primary (epoch {stale_epoch} < {self._epoch_known})"):
                    continue
                raise CacheError(
                    f"sidecar at {self._path} is a stale primary "
                    f"(epoch {stale_epoch}, cluster at "
                    f"{self._epoch_known}) and no other address answers"
                )
            self._release(conn)
            self._breaker.record_success()
            if self._h_rpc is not None:
                self._h_rpc.record((time.perf_counter() - t0) * 1e3)
            return out

    def flush(self) -> None:
        pass  # submits are synchronous end to end

    def close(self) -> None:
        if self._shm is not None:
            self._shm.close()
        with self._pool_lock:
            self._closed = True
            for conn in self._pool:
                conn.close()
            self._pool.clear()


def cluster_rpc(address: str, op: int, payload: bytes = b"", timeout: float = 30.0) -> bytes:
    """One admin RPC (OP_MAP_GET/SET, OP_RESHARD_PULL/PUSH, OP_HOTKEYS_GET,
    OP_CLOCK_SET) against a device owner: dial, send, read u8 status | u32
    len | blob, return the blob. Pool-less and retry-less: the reshard
    coordinator and admin tools run off the hot path and want failures
    loud. unix and tcp:// addresses only."""
    scheme, target = parse_sidecar_address(address)
    if scheme == "tls":
        raise CacheError("admin RPCs do not ride tls:// addresses")
    if scheme == "unix":
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.settimeout(timeout)
        try:
            conn.connect(target)
        except OSError as e:
            conn.close()
            raise CacheError(f"cannot reach owner at {address}: {e}") from e
    else:
        try:
            conn = socket.create_connection(target, timeout=timeout)
        except OSError as e:
            raise CacheError(f"cannot reach owner at {address}: {e}") from e
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    try:
        conn.sendall(_HDR.pack(MAGIC, VERSION, op, 0) + payload)
        status = _recv_exact(conn, 1)
        (ln,) = _U32.unpack(_recv_exact(conn, _U32.size))
        body = _recv_exact(conn, ln)
        if status != b"\x00":
            raise CacheError(f"cluster op {op} failed on {address}: {body.decode(errors='replace')}")
        return body
    except (OSError, ConnectionError) as e:
        raise CacheError(f"cluster op {op} transport failure on {address}: {e}") from e
    finally:
        conn.close()


def admin_set_faults(address: str, spec: str, seed: int | None = None, timeout: float = 30.0) -> dict:
    """Replace a live owner's fault rule set (OP_FAULTS_SET); returns the
    resulting FaultInjector.describe() document. A junk spec raises
    CacheError with the parse error, nothing changed at the owner."""
    doc: dict = {"spec": spec}
    if seed is not None:
        doc["seed"] = int(seed)
    payload = json.dumps(doc).encode()
    body = cluster_rpc(address, OP_FAULTS_SET, _U32.pack(len(payload)) + payload, timeout=timeout)
    return json.loads(body.decode())


def admin_set_clock(
    address: str, offset_s: float = 0.0, drift_ppm: float = 0.0, timeout: float = 30.0
) -> dict:
    """Step/drift a live owner's clock authority (OP_CLOCK_SET); the
    defaults reset the skew. Returns {"unix_now", "skew"} as the owner now
    sees them."""
    payload = json.dumps({"offset_s": float(offset_s), "drift_ppm": float(drift_ppm)}).encode()
    body = cluster_rpc(address, OP_CLOCK_SET, _U32.pack(len(payload)) + payload, timeout=timeout)
    return json.loads(body.decode())


def new_sidecar_cache_from_settings(
    settings, base_limiter, stats_scope=None, fault_injector=None, lease_table=None
):
    """BACKEND_TYPE=cuda-sidecar factory: a CudaRateLimitCache whose device
    driver is the remote owner (runner.py backend switch). With
    SIDECAR_ADDRS the client gets the whole failover list (primary first);
    unset, it is the single-address client. The import of backends/cuda.py
    loads torch but touches no card."""
    from .cuda import CudaRateLimitCache

    return CudaRateLimitCache(
        base_limiter,
        lease_table=lease_table,
        engine=SidecarEngineClient(
            settings.sidecar_addresses(),
            tls_ca=settings.sidecar_tls_ca,
            tls_cert=settings.sidecar_tls_cert,
            tls_key=settings.sidecar_tls_key,
            tls_server_name=settings.sidecar_tls_server_name,
            scope=stats_scope,
            connect_timeout=settings.sidecar_connect_timeout,
            rpc_deadline=settings.sidecar_rpc_deadline,
            retries=settings.sidecar_retries,
            retry_backoff=settings.sidecar_retry_backoff,
            retry_backoff_max=settings.sidecar_retry_backoff_max,
            breaker_threshold=settings.sidecar_breaker_threshold,
            breaker_reset=settings.sidecar_breaker_reset,
            shm_control_path=settings.shm_control_path(),
            shm_ring_rows=settings.shm_ring_rows_count(),
            fault_injector=fault_injector,
        ),
    )
