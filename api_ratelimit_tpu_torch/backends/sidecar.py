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
                         flags bit 2 (FLAG_EPOCH): u32 epoch, then bit 3
                         (FLAG_MAP): u32 map epoch: the replication and
                         cluster fences (ROADMAP item 9). This owner reads
                         them and answers as a JAX owner without
                         replication or a cluster does: FLAG_EPOCH frames
                         get the ok+epoch reply with epoch 0, FLAG_MAP is
                         not checked
                         flags bit 0 (FLAG_TRACE): u32 len | the B3
                         TextMap carrier (tracing/propagation.py
                         encode_textmap), last, so the frontend's span
                         parents the owner's spans across the RPC
            op 2 PING:   empty
            op 8 HOTKEYS_GET: empty -> the owner's heavy-hitter snapshot
            op 11 CLOCK_SET: u32 len | JSON {"offset_s", "drift_ppm"}
            ops 3-7, 9 (replication, cluster, federation; item 9) and
            op 10 FAULTS_SET (the fault injector; item 11b) answer the
            standard error frame, as a JAX owner without those objects
  response: u8 status (0 ok / 1 error / 2 ok+epoch)
            SUBMIT ok:   u32 n | uint32[n] post-increment counters
            ok+epoch:    u32 epoch | u32 n | uint32[n] counters
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
of stacking up dial timeouts. The failover list (SIDECAR_ADDRS with a
standby) waits for replication, ROADMAP item 9. Both ends consult an
optional fault injector (any object with fire(site) -> action).

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



# the ops of items 9 (replication, cluster, federation) and 11b (fault
# injection): the reasons a JAX owner gives when those objects are None
_NOT_CONFIGURED = {
    OP_MAP_GET: "cluster not configured",
    OP_MAP_SET: "cluster not configured",
    OP_RESHARD_PULL: "cluster not configured",
    OP_RESHARD_PUSH: "cluster not configured",
    OP_FAULTS_SET: "fault injector not configured on this owner",
}


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
    ):
        """address: unix path, tcp://host:port, or tls://host:port.

        fault_injector: optional object with fire(site) -> action,
        consulted at site 'sidecar.server.submit' before each SUBMIT
        reaches the engine (delay_ms = slow engine, error = error reply,
        drop = connection drop without a response, partial_write =
        truncated response).

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
                        _recv_exact(conn, 12)  # u32 epoch | u64 last_seq
                        conn.sendall(self._error("replication not configured"))
                        return
                    if op == OP_FED_EXCHANGE:
                        conn.sendall(self._error("federation not configured"))
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
        epoch_fenced = bool(hdr_flags & FLAG_EPOCH)
        if epoch_fenced:
            _recv_exact(conn, _U32.size)  # no replication: nothing to fence
        if hdr_flags & FLAG_MAP:
            _recv_exact(conn, _U32.size)  # no cluster: nothing to fence
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
            if epoch_fenced:
                # the epoch-carrying reply; an owner without replication
                # answers epoch 0 (clients ignore it)
                conn.sendall(
                    bytes([STATUS_OK_EPOCH]) + _U32.pack(0) + _U32.pack(len(out)) + out.tobytes()
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
            _recv_exact(conn, 12)  # u32 lo | u32 hi | u32 route_sets
        elif op in (OP_MAP_SET, OP_RESHARD_PUSH, OP_FAULTS_SET, OP_CLOCK_SET):
            (blob_len,) = _U32.unpack(_recv_exact(conn, _U32.size))
            cap = MAX_MAP_BYTES if op != OP_RESHARD_PUSH else MAX_RESHARD_BYTES
            if blob_len > cap:
                conn.sendall(self._error(f"cluster op body {blob_len} exceeds cap {cap}"))
                return False
            body = _recv_exact(conn, blob_len)
        reason = _NOT_CONFIGURED.get(op)
        if reason is not None:
            conn.sendall(self._error(reason))
            return True
        try:
            if op == OP_CLOCK_SET:
                out = self._serve_clock_set(body)
            else:  # OP_HOTKEYS_GET
                snap_fn = getattr(self._engine, "hotkeys_snapshot", None)
                snap = (
                    snap_fn()
                    if snap_fn is not None
                    else {"enabled": False, "k": 0, "lanes": 0, "drains": 0, "top": []}
                )
                out = json.dumps(snap).encode()
        except Exception as e:  # noqa: BLE001 - surface to the caller
            logger.exception("admin op %d failed", op)
            conn.sendall(self._error(str(e)))
            return True
        conn.sendall(b"\x00" + _U32.pack(len(out)) + out)
        return True

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
    ):
        """address: unix path, tcp://host:port, or tls://host:port (a list
        or comma-separated string of one). A list of several, the failover
        to a warm standby, needs replication (ROADMAP item 9) and raises.
        tls_ca: CA bundle the server cert must chain to (the system store
        when empty). tls_cert/tls_key: client certificate for mutual TLS.
        tls_server_name: SNI/hostname override when the cert CN does not
        match the dialed host.

        scope: optional stats Scope; records <scope>.sidecar.rpc_ms (the
        SUBMIT round trip: socket plus the owner's own stages) and shm_ms
        (the shm arm's), the <scope>.sidecar.{retry,redial,breaker_open,
        shm_fallback} counters, and the breaker_state (0 closed / 1
        half-open / 2 open) and shm_active gauges.

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

        shm_control_path (SHM_RINGS; backends/shm_ring.py): when set, plain
        row-block submits publish through a shared-memory ring straight
        into the owner's dispatch loop. Frames with a lease trailer stay on
        the socket, and a shm TRANSPORT failure falls back to the socket
        RPC per call (<scope>.sidecar.shm_fallback)."""
        self._h_rpc = None
        self._h_shm = None
        self._c_retry = self._c_redial = self._c_breaker_open = None
        self._c_shm_fallback = None
        self._g_breaker_state = None
        self._g_shm_active = None
        if scope is not None:
            sc = scope.scope("sidecar")
            self._h_rpc = sc.histogram("rpc_ms")
            self._h_shm = sc.histogram("shm_ms")
            self._c_retry = sc.counter("retry")
            self._c_redial = sc.counter("redial")
            self._c_breaker_open = sc.counter("breaker_open")
            self._c_shm_fallback = sc.counter("shm_fallback")
            self._g_breaker_state = sc.gauge("breaker_state")
            self._g_breaker_state.set(0)
            self._g_shm_active = sc.gauge("shm_active")
            self._g_shm_active.set(0)
        if isinstance(address, str):
            addrs = [a.strip() for a in address.split(",") if a.strip()]
        else:
            addrs = [str(a) for a in address]
        if not addrs:
            raise ValueError("sidecar address list is empty")
        if len(addrs) > 1:
            raise ValueError(
                f"{len(addrs)} sidecar addresses: the failover to a warm "
                f"standby needs replication (ROADMAP item 9)"
            )
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
        # fails its boot loudly.
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
        # the shm rings, attached once the ping proved the owner up. An
        # owner that offers none (no SHM_RINGS, direct mode) leaves the
        # socket RPC as the only path.
        self._shm = None
        if shm_control_path:
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

    @property
    def breaker(self) -> CircuitBreaker:
        """The transport circuit breaker."""
        return self._breaker

    def _dial(self) -> socket.socket:
        path, target = self._path, self._target
        if self._faults is not None:
            action = self._faults.fire("sidecar.dial")
            if action is not None:
                raise CacheError(f"cannot reach slab sidecar at {path}: injected fault: {action}")
        if self._scheme == "unix":
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
            raise CacheError(f"sidecar circuit open on {self._path}: failing fast")
        # B3 over the wire: a client child span whose context rides the
        # frame as the trace trailer; retries and redials log onto it.
        # Untraced requests build nothing and ship no extra bytes.
        parent = active_span()
        rpc_span = None
        hdr_flags = extra_flags
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
        request = _HDR.pack(MAGIC, VERSION, OP_SUBMIT, hdr_flags) + payload + trailer
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
        while True:
            try:
                conn, pooled = self._acquire()
            except CacheError as e:
                # dial failure: transport-level, retried under the budget
                attempt += 1
                if attempt > self._retries:
                    self._breaker.record_failure()
                    raise
                if self._c_retry is not None:
                    self._c_retry.inc()
                if rpc_span is not None:
                    rpc_span.log_kv(event="sidecar.retry", attempt=attempt, cause="dial", error=str(e))
                self._sleep(self._backoff(attempt))
                continue
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
                    raise CacheError(f"sidecar transport failure: {e}") from e
                if self._c_retry is not None:
                    self._c_retry.inc()
                if rpc_span is not None:
                    rpc_span.log_kv(
                        event="sidecar.retry", attempt=attempt, cause="transport", error=str(e)
                    )
                self._sleep(self._backoff(attempt))
                continue
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
    """One admin RPC (OP_HOTKEYS_GET, OP_CLOCK_SET) against a device owner:
    dial, send, read u8 status | u32 len | blob, return the blob. Pool-less
    and retry-less: admin callers run off the hot path and want failures
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


def admin_set_clock(
    address: str, offset_s: float = 0.0, drift_ppm: float = 0.0, timeout: float = 30.0
) -> dict:
    """Step/drift a live owner's clock authority (OP_CLOCK_SET); the
    defaults reset the skew. Returns {"unix_now", "skew"} as the owner now
    sees them."""
    payload = json.dumps({"offset_s": float(offset_s), "drift_ppm": float(drift_ppm)}).encode()
    body = cluster_rpc(address, OP_CLOCK_SET, _U32.pack(len(payload)) + payload, timeout=timeout)
    return json.loads(body.decode())


def new_sidecar_cache_from_settings(settings, base_limiter, stats_scope=None, lease_table=None):
    """BACKEND_TYPE=cuda-sidecar factory: a CudaRateLimitCache whose device
    driver is the remote owner (runner.py backend switch). The import of
    backends/cuda.py loads torch but touches no card."""
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
        ),
    )
