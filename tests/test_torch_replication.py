"""The port's warm-standby replication (api_ratelimit_tpu_torch/persist/
replication.py, the engine's export_for_replication and apply_replicated in
backends/cuda.py, the owner's ship loop, promote-on-write and epoch fence in
backends/sidecar.py, and the client's failover) on the CPU, against the JAX
package's.

* The JAX package's tests/test_replication.py runs on the port class by
  class (reference_tests_on_the_port): TestFrameCodec, TestStreamAndPromotion,
  TestSplitBrainGuard, TestClientFailover, TestRollbackArm,
  TestDegradedProbes, TestResync (the reference's FaultInjector as the
  fire(site) object: the port takes any) and TestAutoRole. Every case runs;
  none is excluded.
* A JAX primary streams to a port standby, which promotes on a client's
  write and continues the counters; a port primary streams to a JAX
  standby. Both replicas' tables are bit-equal to their primary's, and the
  promoted slab equals reconcile_rows of the primary's last table.
* The SNAPSHOT and DELTA frames, the epoch-fenced SUBMIT, the stale-epoch
  reply and the ok+epoch reply are byte-identical across the packages, and
  the single-address frames stay the legacy bytes.
"""

import socket
import struct
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_victim import reference_tests_on_the_port  # noqa: E402

from api_ratelimit_tpu.backends import sidecar as jax_sidecar  # noqa: E402
from api_ratelimit_tpu.backends.tpu import SlabDeviceEngine as JaxEngine  # noqa: E402
from api_ratelimit_tpu.persist import replication as jax_repl  # noqa: E402
from api_ratelimit_tpu.utils import FakeTimeSource as JaxClock  # noqa: E402
from api_ratelimit_tpu.utils.timeutil import RealTimeSource as JaxRealTime  # noqa: E402
from api_ratelimit_tpu_torch.backends import sidecar as port_sidecar  # noqa: E402
from api_ratelimit_tpu_torch.backends.cuda import SlabDeviceEngine  # noqa: E402
from api_ratelimit_tpu_torch.persist import replication as port_repl  # noqa: E402
from api_ratelimit_tpu_torch.persist.snapshot import (  # noqa: E402
    LEASE_ROW_WIDTH,
    ROW_WIDTH,
    reconcile_rows,
)
from api_ratelimit_tpu_torch.stats import Store, TestSink  # noqa: E402
from api_ratelimit_tpu_torch.utils import FakeTimeSource  # noqa: E402
from api_ratelimit_tpu_torch.utils.timeutil import RealTimeSource  # noqa: E402

_REF = reference_tests_on_the_port(
    "test_replication",
    (
        ("api_ratelimit_tpu_torch.backends.tpu", "api_ratelimit_tpu_torch.backends.cuda"),
        # the reference's injector: the port takes any fire(site) object
        ("api_ratelimit_tpu_torch.testing.faults", "api_ratelimit_tpu.testing.faults"),
        ("use_pallas=False", 'device="cpu"'),
    ),
)

TestFrameCodec = _REF.TestFrameCodec
TestStreamAndPromotion = _REF.TestStreamAndPromotion
TestSplitBrainGuard = _REF.TestSplitBrainGuard
TestClientFailover = _REF.TestClientFailover
TestRollbackArm = _REF.TestRollbackArm
TestDegradedProbes = _REF.TestDegradedProbes
TestResync = _REF.TestResync
TestAutoRole = _REF.TestAutoRole
cluster = _REF.cluster  # the in-process primary/standby pair fixture

SLOTS = 1 << 10
WAYS = 4


@pytest.fixture
def test_store():
    """The port's store (the reference classes read its debug_snapshot)."""
    sink = TestSink()
    return Store(sink), sink


def _port_engine(ts=None):
    return SlabDeviceEngine(
        ts or RealTimeSource(), n_slots=SLOTS, ways=WAYS, buckets=(128,), max_batch=1024,
        device="cpu", block_mode=True,
    )


def _jax_engine(ts=None):
    return JaxEngine(
        time_source=ts or JaxRealTime(), n_slots=SLOTS, ways=WAYS, buckets=(128,), max_batch=1024,
        use_pallas=False, block_mode=True,
    )


PKGS = {
    "port": (_port_engine, port_sidecar, port_repl),
    "jax": (_jax_engine, jax_sidecar, jax_repl),
}


def _block(fps, hits=1, limit=1_000_000, divider=3600):
    fps = np.asarray(fps, dtype=np.uint64)
    b = np.zeros((6, fps.shape[0]), dtype=np.uint32)
    b[0] = (fps & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b[1] = (fps >> np.uint64(32)).astype(np.uint32)
    b[2] = hits
    b[3] = limit
    b[4] = divider
    return b


def _clock(pkg, now):
    """A fake clock of the package at `now`, or None (the real clock)."""
    if now is None:
        return None
    return (FakeTimeSource if pkg == "port" else JaxClock)(now)


class _Pair:
    """A primary of one package and a standby of another over unix
    sockets, each served by its own package's owner."""

    def __init__(self, tmp_path, primary_pkg, standby_pkg, interval_ms=20.0, now=None):
        self.p_sock = str(tmp_path / "p.sock")
        self.s_sock = str(tmp_path / "s.sock")
        mk, side, repl = PKGS[primary_pkg]
        clock = _clock(primary_pkg, now)
        self.p_engine = mk(clock)
        self.p_coord = repl.ReplicationCoordinator(self.p_engine, "primary", interval_ms=interval_ms)
        self.p_server = side.SlabSidecarServer(self.p_sock, self.p_engine, repl=self.p_coord)
        self.p_coord.start()
        mk, side, repl = PKGS[standby_pkg]
        clock = _clock(standby_pkg, now)
        self.s_engine = mk(clock)
        self.s_coord = repl.ReplicationCoordinator(
            self.s_engine, "standby", peer_address=self.p_sock, interval_ms=interval_ms,
            **({"time_source": clock} if clock is not None else {}),
        )
        self.s_server = side.SlabSidecarServer(self.s_sock, self.s_engine, repl=self.s_coord)
        self.s_coord.start()
        self.p_alive = True

    def wait_replica_equals_primary(self, timeout=10.0):
        """Until the standby's shadow table equals the primary's slab."""
        deadline = time.monotonic() + timeout
        want = self.p_engine.export_tables()[0]
        while time.monotonic() < deadline:
            tables, _, _ = self.s_coord.replica_state()
            if tables is not None and np.array_equal(tables[0], want):
                return want
            time.sleep(0.01)
        raise AssertionError("the standby never mirrored the primary's table")

    def kill_primary(self):
        if self.p_alive:
            self.p_alive = False
            self.p_server.close()
            self.p_coord.close()

    def close(self):
        self.kill_primary()
        self.s_server.close()
        self.s_coord.close()


@pytest.mark.parametrize("primary_pkg, standby_pkg", [("jax", "port"), ("port", "jax")])
def test_cross_package_stream_and_promotion(tmp_path, primary_pkg, standby_pkg):
    """A primary of one package streams to a standby of the other: the
    replica's table is bit-equal to the primary's after the snapshot and
    after deltas; killed, the primary's client fails over, the standby
    promotes to epoch 2 and continues every counter, and its slab is
    reconcile_rows of the primary's last table."""
    pair = _Pair(tmp_path, primary_pkg, standby_pkg)
    client_mod = PKGS[standby_pkg][1]
    client = client_mod.SidecarEngineClient(
        [pair.p_sock, pair.s_sock], retries=1, retry_backoff=0.001, retry_backoff_max=0.01,
        breaker_threshold=2, breaker_reset=0.05,
    )
    try:
        rng = np.random.default_rng(5)
        fps = rng.integers(1, 1 << 40, 24, dtype=np.uint64)
        counts = {}
        for _ in range(6):
            pick = rng.choice(fps, 8, replace=False)
            out = client.submit_rows(_block(pick))
            for fp, after in zip(pick.tolist(), out.tolist()):
                counts[fp] = counts.get(fp, 0) + 1
                assert after == counts[fp]
        last = pair.wait_replica_equals_primary()
        now = int(time.time())
        pair.kill_primary()
        seen = np.array(sorted(counts), dtype=np.uint64)
        out = client.submit_rows(_block(seen))
        assert pair.s_coord.role == "primary" and pair.s_coord.epoch == 2
        assert out.tolist() == [counts[fp] + 1 for fp in seen.tolist()]
        assert client.active_address == pair.s_sock
        # the promoted slab under that write: reconcile_rows of the
        # primary's last table, each written row one count up (and its
        # expiry restamped from the write's clock read, never earlier)
        want, _ = reconcile_rows(last, now)
        got = pair.s_engine.export_tables()[0].copy()
        hit = np.isin(got[:, 0], (seen & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        assert hit.sum() == seen.size
        got[hit, 2] -= 1
        assert (got[hit, 4] >= want[hit, 4]).all()
        got[hit, 4] = want[hit, 4]
        assert np.array_equal(got, want)
    finally:
        client.close()
        pair.close()


def test_port_replica_equals_jax_replica(tmp_path):
    """One stream, two pairs (JAX primary -> JAX standby and port primary ->
    port standby), all four on fake clocks at one instant: the two
    replicas' tables are bit-equal, and so are the two promoted slabs."""
    pairs = []
    for pkg in ("jax", "port"):
        (tmp_path / pkg).mkdir()
        pairs.append(_Pair(tmp_path / pkg, pkg, pkg, now=1_700_000_000))
    clients = [
        PKGS[pkg][1].SidecarEngineClient(pair.p_sock, retries=0, breaker_threshold=0)
        for pkg, pair in zip(("jax", "port"), pairs)
    ]
    try:
        rng = np.random.default_rng(11)
        for _ in range(12):
            block = _block(rng.integers(1, 200, 16, dtype=np.uint64), hits=int(rng.integers(1, 4)))
            outs = [c.submit_rows(block).tolist() for c in clients]
            assert outs[0] == outs[1]
        replicas = [pair.wait_replica_equals_primary() for pair in pairs]
        assert np.array_equal(replicas[0], replicas[1])
        for pair in pairs:
            pair.s_coord.promote(reason="test")
        assert np.array_equal(pairs[0].s_engine.export_tables()[0], pairs[1].s_engine.export_tables()[0])
    finally:
        for c in clients:
            c.close()
        for pair in pairs:
            pair.close()


def _tables(seed, n=SLOTS):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 1 << 32, (n, ROW_WIDTH), dtype=np.uint64).astype(np.uint32)
    t[rng.random(n) < 0.5] = 0
    return t


def test_frames_are_byte_identical():
    """The SNAPSHOT and DELTA payloads and their frames, and diff_tables,
    are the JAX package's bytes."""
    prev, cur = _tables(1), _tables(1)
    cur[[3, 77, 900]] += 1
    lease = np.arange(2 * LEASE_ROW_WIDTH, dtype=np.uint32).reshape(2, LEASE_ROW_WIDTH)
    for mod in (port_repl, jax_repl):
        assert mod.REPL_MAGIC == port_repl.REPL_MAGIC
    snap = [m.pack_snapshot_payload([prev], lease, 1_700_000_000, ways=WAYS) for m in (port_repl, jax_repl)]
    assert snap[0] == snap[1]
    idx, rows = port_repl.diff_tables(prev, cur)
    jidx, jrows = jax_repl.diff_tables(prev, cur)
    assert idx.tolist() == jidx.tolist() == [3, 77, 900] and np.array_equal(rows, jrows)
    delta = [m.pack_delta_payload([(0, idx, rows)], lease) for m in (port_repl, jax_repl)]
    assert delta[0] == delta[1]
    for kind, payload in ((port_repl.KIND_SNAPSHOT, snap[0]), (port_repl.KIND_DELTA, delta[0])):
        frame = port_repl.encode_frame(kind, 3, 9, payload)
        assert frame == jax_repl.encode_frame(kind, 3, 9, payload)
    # each package reads the other's payloads
    tables, headers, lease_rows = port_repl.unpack_snapshot_payload(snap[1])
    assert np.array_equal(tables[0], prev) and np.array_equal(lease_rows, lease) and headers[0].ways == WAYS
    dirty, lease_rows = jax_repl.unpack_delta_payload(delta[0], ROW_WIDTH)
    assert dirty[0][1].tolist() == [3, 77, 900] and np.array_equal(lease_rows, lease)


def _raw(path, request: bytes, nbytes: int) -> bytes:
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    conn.settimeout(10)
    conn.connect(path)
    try:
        conn.sendall(request)
        return port_sidecar._recv_exact(conn, nbytes)
    finally:
        conn.close()


@pytest.mark.parametrize("fenced_epoch, want_status", [(1, 2), (2, 3)], ids=["ok_epoch", "stale_epoch"])
def test_epoch_replies_are_byte_identical(tmp_path, fenced_epoch, want_status):
    """An epoch-fenced SUBMIT (built alike by both clients) at a primary of
    each package at epoch 1: the ok+epoch reply for the owner's own epoch,
    the stale-epoch reply for a newer one, byte for byte, and the stale
    write counted and not applied."""
    block = _block([42])
    request = (
        port_sidecar._HDR.pack(port_sidecar.MAGIC, port_sidecar.VERSION, port_sidecar.OP_SUBMIT,
                               port_sidecar.FLAG_EPOCH)
        + struct.pack("<I", 1) + block.tobytes() + struct.pack("<I", fenced_epoch)
    )
    replies = {}
    for pkg in ("port", "jax"):
        mk, side, repl = PKGS[pkg]
        engine = mk()
        coord = repl.ReplicationCoordinator(engine, "primary", interval_ms=50)
        sock = str(tmp_path / f"{pkg}.sock")
        server = side.SlabSidecarServer(sock, engine, repl=coord)
        try:
            n = 13 if want_status == 2 else 5
            replies[pkg] = _raw(sock, request, n)
            assert coord.stale_epoch_rejected_total == (1 if want_status == 3 else 0)
            applied = (engine.export_tables()[0][:, 0] == 42).sum()
            assert applied == (1 if want_status == 2 else 0)
        finally:
            server.close()
            coord.close()
    assert replies["port"] == replies["jax"]
    assert replies["port"][0] == want_status
    assert struct.unpack_from("<I", replies["port"], 1)[0] == 1


@pytest.mark.parametrize("addrs", ["one", "list_of_one", "two"])
def test_submit_frames_match_the_jax_client(tmp_path, addrs):
    """The SUBMIT frames the two clients send are byte-identical: a single
    address (and a one-entry list) ships the legacy frame, two addresses
    add FLAG_EPOCH and its u32 trailer."""
    frames = {}
    for pkg, mod in (("port", port_sidecar), ("jax", jax_sidecar)):
        capture = _REF.TestRollbackArm()
        path = tmp_path / pkg
        path.mkdir()
        sock = str(path / "cap.sock")
        arg = {"one": sock, "list_of_one": [sock], "two": [sock, str(path / "unused.sock")]}[addrs]
        frames[pkg] = _capture_with(capture, path, arg, mod)
    assert frames["port"] == frames["jax"]
    flags = port_sidecar._HDR.unpack(frames["port"][: port_sidecar._HDR.size])[3]
    assert flags == (port_sidecar.FLAG_EPOCH if addrs == "two" else 0)


def _capture_with(capture, path, arg, mod):
    """The reference's capturing server with a client of `mod`."""
    saved = _REF.SidecarEngineClient
    _REF.SidecarEngineClient = mod.SidecarEngineClient
    try:
        return capture._capture_frame(path, arg)
    finally:
        _REF.SidecarEngineClient = saved


def test_ship_loop_under_submits_keeps_the_replica_exact(tmp_path):
    """Port primary and port standby at a short interval while submits run
    between ships: once traffic stops, one more interval makes the replica
    bit-equal to the primary, and every frame applied was shipped."""
    pair = _Pair(tmp_path, "port", "port", interval_ms=5.0)
    client = port_sidecar.SidecarEngineClient(pair.p_sock, retries=0, breaker_threshold=0)
    try:
        rng = np.random.default_rng(3)
        for _ in range(40):
            client.submit_rows(_block(rng.integers(1, 500, 32, dtype=np.uint64)))
        pair.wait_replica_equals_primary()
        assert pair.s_coord.frames_applied_total <= pair.p_coord.frames_shipped_total
        assert pair.s_coord.resyncs_total == 0
        assert pair.p_coord.lag_ms() < 1e4 and pair.s_coord.lag_ms() < 1e4
    finally:
        client.close()
        pair.close()


def test_fake_clock_promotion_matches_the_jax_standby():
    """Standbys of both packages fed the same SNAPSHOT frame (live, dead and
    window-ended rows, a leased row, written with ways 0) promote on one
    fake clock to the same slab and the same lease registry."""
    now = 1_700_000_000
    table = np.zeros((SLOTS, ROW_WIDTH), dtype=np.uint32)
    table[5] = (7, 0, 3, now - now % 3600, now + 600, 3600, 0, 0)
    table[9] = (8, 0, 9, now - 7200, now - 100, 3600, 0, 0)
    table[11] = (21, 0, 2, now - now % 3600, now + 600, 3600, 0, 0)
    lease = np.zeros((1, LEASE_ROW_WIDTH), dtype=np.uint32)
    lease[0] = (21, 0, now - now % 3600, 10, 0, 12, now + 300, 0)
    payload = port_repl.pack_snapshot_payload([table], lease, now, ways=0)
    out = {}
    for pkg, clock in (("port", FakeTimeSource), ("jax", JaxClock)):
        mk, _side, repl = PKGS[pkg]
        ts = clock(now)
        engine = mk(ts)
        coord = repl.ReplicationCoordinator(engine, "standby", peer_address="/nonexistent", interval_ms=10,
                                            time_source=ts)
        coord._apply_frame(repl.KIND_SNAPSHOT, 1, 1, payload)
        assert coord.promote(reason="test") and coord.epoch == 2
        out[pkg] = (engine.export_tables()[0], engine.lease_registry.export_rows(now))
        engine.close()
        coord.close()
    assert np.array_equal(out["port"][0], out["jax"][0])
    assert np.array_equal(out["port"][1], out["jax"][1])


def test_concurrent_failover_fails_no_call(tmp_path):
    """Two threads share one failover client and exhaust their retries at
    the dead primary together (their last dials there meet at a barrier):
    the client moves to the standby once, not once per thread (the second
    rotation would take it back to the dead primary and fail that call),
    so neither call fails and the standby promotes once."""
    import threading

    pair = _Pair(tmp_path, "port", "port")
    barrier = threading.Barrier(2, timeout=10)
    dials = threading.local()

    class MeetAtTheLastDial:
        def fire(self, site):
            if site == "sidecar.dial":
                dials.n = getattr(dials, "n", 0) + 1
                if dials.n == 2:  # each thread's second dial at the primary
                    barrier.wait()
            return None

    client = port_sidecar.SidecarEngineClient(
        [pair.p_sock, pair.s_sock], retries=1, breaker_threshold=0, sleep=lambda _s: None, pool_size=0,
        fault_injector=MeetAtTheLastDial(),
    )
    results, errors = [], []

    def write(fp):
        try:
            results.append(int(client.submit_rows(_block([fp]))[0]))
        except Exception as e:  # noqa: BLE001 - a failed call is the finding
            errors.append(repr(e))

    try:
        pair.kill_primary()
        threads = [threading.Thread(target=write, args=(fp,)) for fp in (7, 8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(20)
    finally:
        client.close()
        pair.close()
    assert errors == []
    assert results == [1, 1]
    assert client.active_address == pair.s_sock
    assert pair.s_coord.promotions_total == 1 and pair.s_coord.epoch == 2


def test_writes_racing_the_promotion_wait_for_it(tmp_path):
    """Two writes reach a standby together while its promotion uploads
    (slowed here): the second waits for the upload, so both land on the
    promoted slab and the replicated counter continues through both."""
    import threading

    now = int(time.time())
    engine = _port_engine()
    coord = port_repl.ReplicationCoordinator(engine, "standby", peer_address="/nonexistent", interval_ms=10)
    table = np.zeros((SLOTS, ROW_WIDTH), dtype=np.uint32)
    engine.submit_block(_block([42], hits=5))
    placed = engine.export_tables()[0].copy()
    engine.import_tables([table])  # cold again; the replica holds count 5
    coord._apply_frame(port_repl.KIND_SNAPSHOT, 1, 1, port_repl.pack_snapshot_payload(
        [placed], np.zeros((0, LEASE_ROW_WIDTH), np.uint32), now, ways=WAYS))
    upload = engine.apply_replicated

    def slow_upload(tables, lease_rows):
        time.sleep(0.3)
        upload(tables, lease_rows)

    engine.apply_replicated = slow_upload
    sock = str(tmp_path / "s.sock")
    server = port_sidecar.SlabSidecarServer(sock, engine, repl=coord)
    answers = []

    def write():
        c = port_sidecar.SidecarEngineClient(sock, retries=0, breaker_threshold=0)
        try:
            answers.append(int(c.submit_rows(_block([42]))[0]))
        finally:
            c.close()

    threads = [threading.Thread(target=write) for _ in range(2)]
    try:
        threads[0].start()
        time.sleep(0.1)  # the first write is promoting
        threads[1].start()
        for th in threads:
            th.join(10)
    finally:
        server.close()
        coord.close()
    assert sorted(answers) == [6, 7]
    assert coord.promotions_total == 1
