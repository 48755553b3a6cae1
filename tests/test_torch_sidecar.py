"""The port's device-owner wire (api_ratelimit_tpu_torch/backends/sidecar.py)
on the CPU, against the JAX package's.

* The JAX package's tests/test_sidecar.py runs on the port
  (reference_tests_on_the_port): the item codec, the end-to-end matrix over
  unix and tcp:// owners (the over-limit sequence, global counts across
  four frontends, the differential against the memory oracle, a dark
  owner), address parsing, mutual TLS (skipped without openssl, as there),
  engine failures, the Runner with BACKEND_TYPE=cuda-sidecar over gRPC, the
  malformed-frame and oversized-frame guards, and the owner restart.
* A JAX client against a port owner and a port client against a JAX owner
  give the same post-increment counters, on one seeded stream, as the
  same-package pairs.
* The SUBMIT frames both packages' clients build are byte-identical, with a
  trace trailer and a lease trailer.
* Each op this owner does not serve (replication, cluster, federation,
  fault injection) answers as a JAX owner with repl, cluster, fed and the
  fault injector set to None; the epoch-fenced frame gets its ok+epoch
  reply.
"""

import json
import socket
import struct
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_victim import reference_tests_on_the_port  # noqa: E402

from api_ratelimit_tpu.backends import lease as jax_lease  # noqa: E402
from api_ratelimit_tpu.backends import sidecar as jax_sidecar  # noqa: E402
from api_ratelimit_tpu.backends.tpu import SlabDeviceEngine as JaxEngine  # noqa: E402
from api_ratelimit_tpu import tracing as jax_tracing  # noqa: E402
from api_ratelimit_tpu.utils import FakeTimeSource as JaxClock  # noqa: E402
from api_ratelimit_tpu_torch import tracing as port_tracing  # noqa: E402
from api_ratelimit_tpu_torch.backends import lease as port_lease  # noqa: E402
from api_ratelimit_tpu_torch.backends import sidecar as port_sidecar  # noqa: E402
from api_ratelimit_tpu_torch.backends.cuda import SlabDeviceEngine  # noqa: E402
from api_ratelimit_tpu_torch.limiter.cache import CacheError  # noqa: E402
from api_ratelimit_tpu_torch.utils import FakeTimeSource  # noqa: E402

_REF = reference_tests_on_the_port(
    "test_sidecar",
    (
        ("api_ratelimit_tpu_torch.backends.tpu", "api_ratelimit_tpu_torch.backends.cuda"),
        ("TpuRateLimitCache", "CudaRateLimitCache"),
        ("use_pallas=False", 'device="cpu"'),
        ('backend_type="tpu-sidecar"', 'backend_type="cuda-sidecar"'),
        ("def test_backend_type_tpu_sidecar", "def test_backend_type_cuda_sidecar"),
    ),
)

sidecar = _REF.sidecar  # the unix/tcp owner fixture the classes take
TestCodec = _REF.TestCodec
TestSidecarEndToEnd = _REF.TestSidecarEndToEnd
TestAddressParsing = _REF.TestAddressParsing
TestTlsTransport = _REF.TestTlsTransport
TestRunnerIntegration = _REF.TestRunnerIntegration
TestSidecarRestart = _REF.TestSidecarRestart
test_malformed_frames_never_kill_the_server = _REF.test_malformed_frames_never_kill_the_server
test_oversized_submit_rejected_before_buffering = _REF.test_oversized_submit_rejected_before_buffering

NOW = 1_000_000
SLOTS = 1 << 10
WAYS = 4
BUCKETS = (8, 128)


def _port_owner(address="tcp://127.0.0.1:0", **kw):
    engine = SlabDeviceEngine(
        FakeTimeSource(NOW), n_slots=SLOTS, ways=WAYS, buckets=BUCKETS, device="cpu",
        block_mode=True, **kw,
    )
    return port_sidecar.SlabSidecarServer(address, engine), engine


def _jax_owner(address="tcp://127.0.0.1:0", **kw):
    engine = JaxEngine(
        JaxClock(NOW), n_slots=SLOTS, ways=WAYS, buckets=BUCKETS, use_pallas=False,
        block_mode=True, **kw,
    )
    return jax_sidecar.SlabSidecarServer(address, engine), engine


def _stream(seed: int, blocks: int = 24):
    """Seeded row blocks: 1-6 items over 40 keys, limits crossed, windows of
    60 and 3600 s."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(blocks):
        n = int(rng.integers(1, 7))
        b = np.zeros((6, n), dtype=np.uint32)
        b[0] = rng.integers(1, 41, n)
        b[1] = 7
        b[2] = rng.integers(1, 4, n)
        b[3] = 20
        b[4] = rng.choice([60, 3600], n)
        out.append(b)
    return out


@pytest.mark.parametrize(
    "owner_pkg, client_pkg",
    [("port", "port"), ("jax", "jax"), ("port", "jax"), ("jax", "port")],
)
def test_cross_package_pairs_count_alike(owner_pkg, client_pkg):
    """Every pairing of owner and client answers one seeded stream with the
    same post-increment counters (the port-port pair is the expectation)."""
    want_server, _ = _port_owner()
    want_client = port_sidecar.SidecarEngineClient(f"tcp://127.0.0.1:{want_server.port}")
    server, _ = (_port_owner if owner_pkg == "port" else _jax_owner)()
    mod = port_sidecar if client_pkg == "port" else jax_sidecar
    client = mod.SidecarEngineClient(f"tcp://127.0.0.1:{server.port}")
    try:
        for block in _stream(7):
            want = want_client.submit_rows(block).tolist()
            got = np.asarray(client.submit_rows(block)).tolist()
            assert got == want
        assert want[-1] > 0
    finally:
        client.close()
        want_client.close()
        server.close()
        want_server.close()


class _Recorder:
    """A tcp listener that answers the client's boot PING and records the
    next frame's bytes, replying with n zero counters."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(4)
        self.port = self.sock.getsockname()[1]
        self.frames: list[bytes] = []
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._conn, args=(conn,), daemon=True).start()

    def _conn(self, conn):
        hdr = port_sidecar._HDR
        with conn:
            try:
                while True:
                    raw = port_sidecar._recv_exact(conn, hdr.size)
                    _m, _v, op, flags = hdr.unpack(raw)
                    if op == port_sidecar.OP_PING:
                        conn.sendall(b"\x00")
                        continue
                    (n,) = struct.unpack("<I", port_sidecar._recv_exact(conn, 4))
                    frame = raw + struct.pack("<I", n) + port_sidecar._recv_exact(conn, 24 * n)
                    for bit in (port_sidecar.FLAG_LEASE, port_sidecar.FLAG_TRACE):
                        if flags & bit:
                            ln = port_sidecar._recv_exact(conn, 4)
                            frame += ln + port_sidecar._recv_exact(conn, struct.unpack("<I", ln)[0])
                    self.frames.append(frame)
                    conn.sendall(b"\x00" + struct.pack("<I", n) + bytes(4 * n))
            except ConnectionError:
                return

    def close(self):
        self.sock.close()


def _frame(mod, tracing_mod, lease_mod, monkeypatch, traced: bool, lease: bool) -> bytes:
    rec = _Recorder()
    client = mod.SidecarEngineClient(f"tcp://127.0.0.1:{rec.port}")
    try:
        block = np.arange(18, dtype=np.uint32).reshape(6, 3) + 5
        ops = None
        if lease:
            ops = lease_mod.LeaseOps(grants=[(0, 8, 999_960, 15)], settles=[(99, 999_960, 3)])
        if traced:
            tracer = tracing_mod.RecordingTracer()
            monkeypatch.setattr(tracer, "_new_ids", lambda: (0x1234 << 64 | 0x5678, 0x9ABC))
            parent = tracer.start_span("request")
            with tracing_mod.activate(parent):
                client.submit_rows(block, lease_ops=ops)
        else:
            client.submit_rows(block, lease_ops=ops)
        return rec.frames[-1]
    finally:
        client.close()
        rec.close()


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "trace_trailer"])
@pytest.mark.parametrize("lease", [False, True], ids=["no_lease", "lease_trailer"])
def test_submit_frames_are_byte_identical(monkeypatch, traced, lease):
    want = _frame(jax_sidecar, jax_tracing, jax_lease, monkeypatch, traced, lease)
    got = _frame(port_sidecar, port_tracing, port_lease, monkeypatch, traced, lease)
    assert got == want
    flags = struct.unpack_from("<IBBH", got)[3]
    assert bool(flags & port_sidecar.FLAG_TRACE) == traced
    assert bool(flags & port_sidecar.FLAG_LEASE) == lease


def _raw_reply(port: int, request: bytes) -> bytes:
    """Send one request and read until the owner closes or 1 s of quiet."""
    conn = socket.create_connection(("127.0.0.1", port), timeout=5)
    try:
        conn.sendall(request)
        conn.settimeout(1.0)
        out = b""
        while True:
            try:
                chunk = conn.recv(4096)
            except socket.timeout:
                break
            if not chunk:
                break
            out += chunk
        return out
    finally:
        conn.close()


def _hdr(op: int, flags: int = 0) -> bytes:
    return port_sidecar._HDR.pack(port_sidecar.MAGIC, port_sidecar.VERSION, op, flags)


_JSON = b'{"epoch": 1}'
UNSERVED_OPS = [
    ("repl_subscribe", _hdr(3) + struct.pack("<IQ", 1, 0)),
    ("map_get", _hdr(4)),
    ("map_set", _hdr(5) + struct.pack("<I", len(_JSON)) + _JSON),
    # the owner answers before reading the exchange's payload: the header only
    ("fed_exchange", _hdr(9)),
    ("faults_set", _hdr(10) + struct.pack("<I", 2) + b"{}"),
    ("bad_op", _hdr(42)),
    ("bad_magic", b"\x00" * 8),
    ("ping", _hdr(2)),
    ("hotkeys_get", _hdr(8)),
]


@pytest.mark.parametrize("request_bytes", [r for _n, r in UNSERVED_OPS], ids=[n for n, _r in UNSERVED_OPS])
def test_unserved_ops_answer_as_a_jax_owner_without_them(request_bytes):
    port_server, _ = _port_owner()
    jax_server, _ = _jax_owner()
    try:
        want = _raw_reply(jax_server.port, request_bytes)
        got = _raw_reply(port_server.port, request_bytes)
        assert got == want
        assert got[:1] in (b"\x00", b"\x01")
    finally:
        port_server.close()
        jax_server.close()


@pytest.mark.parametrize("op", [6, 7], ids=["reshard_pull", "reshard_push"])
def test_reshard_ops_answer_the_error_frame(op):
    """The reshard ops move rows between cluster partitions (item 9): this
    owner answers the standard error frame and keeps the connection."""
    server, _ = _port_owner()
    try:
        body = struct.pack("<III", 0, 1, 256) if op == 6 else struct.pack("<I", 0)
        reply = _raw_reply(server.port, _hdr(op) + body + _hdr(2))
        msg = b"cluster not configured"
        assert reply == b"\x01" + struct.pack("<I", len(msg)) + msg + b"\x00"
    finally:
        server.close()


def test_epoch_and_map_fenced_frames_answer_as_an_owner_without_replication():
    """FLAG_EPOCH and FLAG_MAP trailers are read; the epoch-fenced frame
    gets the ok+epoch reply with epoch 0, byte for byte as a JAX owner."""
    block = np.array([[5], [0], [1], [100], [60], [0]], dtype=np.uint32)
    req = (
        _hdr(1, port_sidecar.FLAG_EPOCH | port_sidecar.FLAG_MAP)
        + struct.pack("<I", 1) + block.tobytes() + struct.pack("<II", 3, 4)
    )
    port_server, _ = _port_owner()
    jax_server, _ = _jax_owner()
    try:
        want = _raw_reply(jax_server.port, req)
        got = _raw_reply(port_server.port, req)
        assert got == want == bytes([2]) + struct.pack("<III", 0, 1, 1)
    finally:
        port_server.close()
        jax_server.close()


def test_clock_set_steps_the_owner_clock():
    from api_ratelimit_tpu_torch.utils.timeutil import SkewableTimeSource

    ts = SkewableTimeSource(FakeTimeSource(NOW))
    engine = SlabDeviceEngine(ts, n_slots=SLOTS, ways=WAYS, buckets=BUCKETS, device="cpu", block_mode=True)
    server = port_sidecar.SlabSidecarServer("tcp://127.0.0.1:0", engine, time_source=ts)
    try:
        addr = f"tcp://127.0.0.1:{server.port}"
        doc = port_sidecar.admin_set_clock(addr, offset_s=3600.0)
        assert doc["unix_now"] == NOW + 3600 == ts.unix_now()
        assert port_sidecar.admin_set_clock(addr)["skew"]["offset_s"] == 0.0
    finally:
        server.close()


def test_block_mode_engine_refuses_the_in_process_verbs():
    engine = SlabDeviceEngine(FakeTimeSource(NOW), n_slots=SLOTS, ways=WAYS, buckets=BUCKETS, device="cpu", block_mode=True)
    try:
        assert engine.block_mode
        with pytest.raises(RuntimeError, match="submit_block"):
            engine.submit_rows(np.zeros((6, 1), dtype=np.uint32))
        block = np.array([[9], [0], [2], [10], [60], [0]], dtype=np.uint32)
        assert engine.submit_block(block).tolist() == [2]
    finally:
        engine.close()
    plain = SlabDeviceEngine(FakeTimeSource(NOW), n_slots=SLOTS, ways=WAYS, buckets=BUCKETS, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="block_mode"):
            plain.submit_block(block)
        assert not hasattr(plain, "submit")  # the server's item verb is for other engines
    finally:
        plain.close()


def test_client_refuses_a_failover_list():
    with pytest.raises(ValueError, match="ROADMAP item 9"):
        port_sidecar.SidecarEngineClient("/run/a.sock,/run/b.sock")


def test_breaker_opens_on_a_dark_owner_and_fails_fast():
    server, _ = _port_owner()
    client = port_sidecar.SidecarEngineClient(
        f"tcp://127.0.0.1:{server.port}", retries=0, breaker_threshold=2, breaker_reset=60.0,
        sleep=lambda _s: None,
    )
    block = np.array([[1], [0], [1], [10], [60], [0]], dtype=np.uint32)
    try:
        assert client.submit_rows(block).tolist() == [1]
        server.close()
        client._evict_pool()
        for _ in range(2):
            with pytest.raises(CacheError):
                client.submit_rows(block)
        assert client.breaker.state == "open"
        with pytest.raises(CacheError, match="circuit open"):
            client.submit_rows(block)
    finally:
        client.close()


def test_windowed_owner_takes_wire_frames_without_a_copy():
    """Through the dispatch loop a wire frame is handed over owned (no
    arena copy): the ring's arena stays unused."""
    server, engine = _port_owner(batch_window_seconds=0.0005)
    client = port_sidecar.SidecarEngineClient(f"tcp://127.0.0.1:{server.port}")
    try:
        for block in _stream(3, blocks=8):
            client.submit_rows(block)
        loop = engine.dispatch_loop
        assert loop.launches >= 1
        assert all(ring.rows_in == 0 for ring in loop._rings)
    finally:
        client.close()
        server.close()


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_trace_trailer_parents_the_owner_span(client_pkg):
    """FLAG_TRACE: the owner's sidecar.submit_rows server span is a child of
    the client's sidecar.submit span, across the wire, from a client of
    either package; the owner's journey recorder keeps a sidecar.submit
    journey."""
    from api_ratelimit_tpu_torch.tracing import journeys

    tracer = port_tracing.RecordingTracer()
    port_tracing.set_global_tracer(tracer)
    recorder = journeys.JourneyRecorder(slow_ms=0.0, retain=16, ring=16)
    journeys.set_global_recorder(recorder)
    server, _ = _port_owner()
    tracing_mod = port_tracing if client_pkg == "port" else jax_tracing
    mod = port_sidecar if client_pkg == "port" else jax_sidecar
    client = mod.SidecarEngineClient(f"tcp://127.0.0.1:{server.port}")
    client_tracer = tracing_mod.RecordingTracer()
    try:
        parent = client_tracer.start_span("request")
        with tracing_mod.activate(parent):
            client.submit_rows(np.array([[3], [0], [1], [10], [60], [0]], dtype=np.uint32))
        parent.finish()
        rpc = next(s for s in client_tracer.finished_spans() if s.operation_name == "sidecar.submit")
        owner = [s for s in tracer.finished_spans() if s.operation_name == "sidecar.submit_rows"]
        assert len(owner) == 1
        assert owner[0].context.trace_id == parent.context.trace_id
        assert owner[0].parent_id == rpc.context.span_id
        assert owner[0].tags["span.kind"] == "server"
        recent = json.loads(recorder.dump_json())["recent"]
        kept = [j for ring in recent.values() for j in ring if j["kind"] == "sidecar.submit"]
        assert len(kept) == 1 and int(kept[0]["trace_id"], 16) == parent.context.trace_id
    finally:
        client.close()
        server.close()
        port_tracing.reset_global_tracer()
        journeys.set_global_recorder(None)
