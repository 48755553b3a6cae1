"""The port's quota federation (api_ratelimit_tpu_torch/cluster/federation.py,
the share rung of backends/fallback.py, the fed.snap section of
persist/snapshotter.py, the owner's OP_FED_EXCHANGE) on the CPU, against the
JAX package's.

* The JAX package's tests/test_federation.py runs on the port class by class
  (reference_tests_on_the_port): TestMembership, TestExchange,
  TestFrameDiscipline (the port's FaultInjector at fed.exchange and
  fed.apply), TestReclamationAndFencing, TestPartitionChaos, TestOwnerDeath
  (a SIGKILLed port borrower subprocess), TestSnapshotRoundtrip,
  TestFallbackShareRung and TestRollbackArm (the port's owner and engine).
  Every case runs; none is excluded.
* A JAX borrower against a port home, and a port borrower against a JAX
  home, over the real exchange wire (each package's owner serving
  OP_FED_EXCHANGE): the same ledgers as a JAX pair through grants, settles,
  a TTL reclaim, the fence and the stale settle it rejects.
* The exchange bytes both ways (hello, handshake snapshot, request, grant,
  settle, ack, fence), recorded on the wire, are byte-identical between a
  JAX pair and a port pair driven alike; the home's reply to each frame kind
  is byte-identical for one ledger.
* A fed.snap (and its slab.snap) written by either package restores into
  the other with the same restore counts, the same floored table and the
  same re-seeded ledger as a restore into the writer's own package.
* The one departure: the share rung asks the home for a share on its first
  miss (the reference asks only for a dry share).
* The slice as a whole: a JAX Runner and a port Runner, each a federated
  cluster whose card launches fail through POST /debug/faults, answer one v3
  stream byte for byte alike from their home budget and their borrowed
  shares, and both answer the rollback arm (FED_ENABLED=false) alike.
"""

import json
import socket
import struct
import threading
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_victim import reference_tests_on_the_port  # noqa: E402

from api_ratelimit_tpu.backends import sidecar as jax_sidecar  # noqa: E402
from api_ratelimit_tpu.backends.tpu import SlabDeviceEngine as JaxEngine  # noqa: E402
from api_ratelimit_tpu.backends.tpu import _Item as JaxItem  # noqa: E402
from api_ratelimit_tpu.cluster import federation as jax_fed  # noqa: E402
from api_ratelimit_tpu.persist import snapshotter as jax_snapshotter  # noqa: E402
from api_ratelimit_tpu.utils import FakeTimeSource as JaxClock  # noqa: E402
from api_ratelimit_tpu_torch.backends import sidecar as port_sidecar  # noqa: E402
from api_ratelimit_tpu_torch.backends.cuda import SlabDeviceEngine  # noqa: E402
from api_ratelimit_tpu_torch.backends.cuda import _Item  # noqa: E402
from api_ratelimit_tpu_torch.cluster import federation as port_fed  # noqa: E402
from api_ratelimit_tpu_torch.persist import snapshotter as port_snapshotter  # noqa: E402
from api_ratelimit_tpu_torch.persist.snapshot import FED_COL_SPENT, load_snapshot  # noqa: E402
from api_ratelimit_tpu_torch.stats import Store, TestSink  # noqa: E402
from api_ratelimit_tpu_torch.utils import FakeTimeSource  # noqa: E402

_REF = reference_tests_on_the_port(
    "test_federation",
    (
        ("api_ratelimit_tpu_torch.backends.tpu", "api_ratelimit_tpu_torch.backends.cuda"),
        ("use_pallas=False", 'device="cpu"'),
        # the port's ladder has no degraded rung and so no base limiter
        ("            base_limiter=base,\n", ""),
    ),
)

TestMembership = _REF.TestMembership
TestExchange = _REF.TestExchange
TestFrameDiscipline = _REF.TestFrameDiscipline
TestReclamationAndFencing = _REF.TestReclamationAndFencing
TestPartitionChaos = _REF.TestPartitionChaos
TestOwnerDeath = _REF.TestOwnerDeath
TestSnapshotRoundtrip = _REF.TestSnapshotRoundtrip
TestFallbackShareRung = _REF.TestFallbackShareRung
TestRollbackArm = _REF.TestRollbackArm
make_net = _REF.make_net  # the in-process cluster network fixture

NOW = _REF.NOW
W = _REF.W
D = _REF.D
FED = {"jax": jax_fed, "port": port_fed}
SIDECAR = {"jax": jax_sidecar, "port": port_sidecar}


@pytest.fixture
def test_store():
    """The port's store (the reference classes read its debug_snapshot)."""
    sink = TestSink()
    return Store(sink), sink


# -- a network of clusters from either package -------------------------------


class _Net:
    """Clusters wired over loopback TCP, each coordinator from the package
    its name maps to, every listener the accept-and-serve loop of the
    production owner. tap=True puts a recording relay in front of each
    listener: every connection's bytes in each direction are kept in
    `wire` (one (to_home, to_borrower) pair per connection, in order)."""

    def __init__(self, pkgs: dict, ts, tap: bool = False, **kw):
        self.ts = ts
        self._closing = threading.Event()
        self._socks: list = []
        self.wire: list = []
        peers, listeners = {}, {}
        for name in pkgs:
            srv = self._listen()
            listeners[name] = srv
            port = srv.getsockname()[1]
            if tap:
                relay = self._listen()
                threading.Thread(target=self._relay_loop, args=(relay, port), daemon=True).start()
                port = relay.getsockname()[1]
            peers[name] = f"tcp://127.0.0.1:{port}"
        self.peers = peers
        kw.setdefault("share_min", 8)
        kw.setdefault("share_max", 64)
        kw.setdefault("share_ttl_ms", 5_000.0)
        kw.setdefault("breaker_reset_s", 0.05)
        self.coords = {
            name: FED[pkg].FederationCoordinator(name, peers, ts, **kw) for name, pkg in pkgs.items()
        }
        for name, srv in listeners.items():
            threading.Thread(target=self._accept_loop, args=(name, srv, pkgs[name]), daemon=True).start()

    def _listen(self):
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", 0))
        srv.listen(16)
        self._socks.append(srv)
        return srv

    def _accept_loop(self, name, srv, pkg):
        hdr = SIDECAR[pkg]._HDR
        while not self._closing.is_set():
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            self._socks.append(conn)

            def serve(conn=conn):
                try:
                    _magic, _version, op, _flags = hdr.unpack(FED[pkg]._recv_exact(conn, hdr.size))
                    if op == SIDECAR[pkg].OP_FED_EXCHANGE:
                        self.coords[name].serve_exchange(conn)
                except (OSError, ConnectionError, struct.error):
                    pass
                finally:
                    conn.close()

            threading.Thread(target=serve, daemon=True).start()

    def _relay_loop(self, relay, target_port):
        while not self._closing.is_set():
            try:
                down, _ = relay.accept()
            except OSError:
                return
            up = socket.create_connection(("127.0.0.1", target_port))
            self._socks += [down, up]
            record = (bytearray(), bytearray())
            self.wire.append(record)
            for src, dst, buf in ((down, up, record[0]), (up, down, record[1])):
                threading.Thread(target=self._pipe, args=(src, dst, buf), daemon=True).start()

    @staticmethod
    def _pipe(src, dst, buf):
        try:
            while True:
                data = src.recv(65536)
                if not data:
                    break
                buf.extend(data)
                dst.sendall(data)
        except OSError:
            pass
        finally:
            for s in (src, dst):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    def close(self):
        self._closing.set()
        for coord in self.coords.values():
            coord.close()
        for s in self._socks:
            try:
                s.close()
            except OSError:
                pass


@pytest.fixture
def nets():
    made = []

    def _make(pkgs, ts=None, **kw):
        net = _Net(pkgs, ts or FakeTimeSource(NOW), **kw)
        made.append(net)
        return net

    yield _make
    for net in made:
        net.close()


def _ledger(coord) -> dict:
    """Everything of a coordinator's state a scenario moves."""
    with coord._lock:
        return {
            "used": dict(coord._used),
            "shares": {k: (s.granted, s.spent, s.settled, s.base, s.expire_at, s.limit) for k, s in coord._shares.items()},
            "wants": dict(coord._wants),
            "out": {k: {p: (g.granted, g.settled, g.expire_at) for p, g in v.items()} for k, v in coord._out.items()},
            "fence": dict(coord._fence),
            "epochs": {n: link.epoch for n, link in coord._links.items()},
            "totals": {
                k: getattr(coord, k)
                for k in (
                    "grants_total", "grant_tokens_total", "settles_total", "settle_tokens_total",
                    "reclaims_total", "reclaimed_tokens_total", "stale_epoch_rejected_total",
                    "resyncs_total", "exchange_errors_total",
                )
            },
            "export": coord.export_rows().tolist(),
        }


def _scenario(net) -> list:
    """west borrows from east: a grant, spends, a settle with a renewal
    (the share doubles), a TTL reclaim at east with the fence bump, the
    stale settle east rejects and the re-grant under the new epoch. The
    ledgers after each step."""
    east, west = net.coords["east"], net.coords["west"]
    steps = []

    def snap(label):
        steps.append((label, _ledger(east), _ledger(west)))

    assert not west.consume(2, W, 100, deadline=D)
    assert west.pump()["east"] == "ok"
    snap("grant")
    for _ in range(8):
        assert west.consume(2, W, 100, deadline=D)
    assert not west.consume(2, W, 100, deadline=D)
    assert west.pump()["east"] == "ok"
    snap("settle and renew")
    for _ in range(5):
        assert west.consume(2, W, 100, deadline=D)
    net.ts.advance(6)
    assert east.reclaim_sweep() == 24 - 8
    snap("reclaim")
    assert west.pump()["east"] == "ok"  # the stale settle, fenced
    snap("fenced")
    assert not west.consume(2, W, 100, deadline=D)
    assert west.pump()["east"] == "ok"
    assert west.consume(2, W, 100, deadline=D)
    snap("re-grant")
    return steps


@pytest.mark.parametrize("home, borrower", [("port", "jax"), ("jax", "port")])
def test_cross_package_exchange_matches_the_reference(nets, home, borrower):
    """A borrower of one package against a home of the other, over the
    real exchange wire: every step's ledgers equal a JAX pair's."""
    want = _scenario(nets({"east": "jax", "west": "jax"}))
    got = _scenario(nets({"east": home, "west": borrower}))
    assert [label for label, _e, _w in got] == [label for label, _e, _w in want]
    for (label, e_got, w_got), (_l, e_want, w_want) in zip(got, want):
        assert e_got == e_want, label
        assert w_got == w_want, label
    assert got[-1][1]["totals"]["stale_epoch_rejected_total"] == 1


def test_exchange_bytes_are_the_references(nets):
    """The bytes on the exchange wire, both ways and connection by
    connection, equal between a JAX pair and a port pair driven alike."""
    wires = {}
    for pkg in ("jax", "port"):
        net = nets({"east": pkg, "west": pkg}, tap=True)
        _scenario(net)
        net.coords["west"].close()  # flush: the relays see every byte
        time.sleep(0.2)
        wires[pkg] = [(bytes(a), bytes(b)) for a, b in net.wire]
    assert wires["port"] == wires["jax"]
    assert len(wires["port"]) == 1 and all(len(half) > 0 for half in wires["port"][0])


def _home_with_grants(pkg):
    ts = FakeTimeSource(NOW)
    peers = {"east": "tcp://127.0.0.1:1", "west": "tcp://127.0.0.1:2"}
    east = FED[pkg].FederationCoordinator("east", peers, ts, share_ttl_ms=5_000.0)
    east._grant_locked("west", [(2, W, 8, 100), (4, W, 40, 40), (6, W + 60, 3, 10), (3, W, 5, 100)])
    east.consume(4, W, 40, n=1, deadline=D)
    return east


def test_home_replies_are_the_references():
    """One ledger, each frame kind a borrower sends (and a stale epoch):
    the home's reply kind, epoch and payload bytes, and its handshake
    snapshot, equal the JAX home's."""
    homes = {pkg: _home_with_grants(pkg) for pkg in ("jax", "port")}
    frames = [
        (port_fed.KIND_FED_REQUEST, 0, [(2, W, 8, 100), (8, W, 64, 1000), (5, W, 8, 100)]),
        (port_fed.KIND_FED_SETTLE, 0, [(2, W, 6, 0), (4, W, 30, 0), (10, W, 1, 0)]),
        (port_fed.KIND_FED_SETTLE, 3, [(2, W, 7, 0)]),
        (port_fed.KIND_FED_REQUEST, 1, [(2, W, 8, 100)]),
    ]
    for kind, epoch, rows in frames:
        replies = {
            pkg: h._apply_exchange_frame("west", kind, epoch, FED[pkg]._pack_rows(rows)) for pkg, h in homes.items()
        }
        assert replies["port"] == replies["jax"], (kind, epoch)
    assert FED["port"]._pack_rows(homes["port"]._grantor_rows_for("west")) == FED["jax"]._pack_rows(
        homes["jax"]._grantor_rows_for("west")
    )
    for pkg in ("jax", "port"):
        assert FED[pkg].FED_KINDS == (3, 4, 5, 6, 7, 8)
    assert np.array_equal(homes["port"].export_rows(), homes["jax"].export_rows())
    assert homes["port"].describe() == homes["jax"].describe()


# -- fed.snap across the packages ---------------------------------------------


def _engine(pkg, ts):
    if pkg == "jax":
        return JaxEngine(ts, n_slots=1 << 10, buckets=(128,), use_pallas=False)
    return SlabDeviceEngine(ts, n_slots=1 << 10, buckets=(128,), device="cpu")


def _write_set(pkg, directory) -> np.ndarray:
    """A federated cluster of `pkg` whose slab holds key 2 (count 1) and
    whose ledger committed 8 for it at grant time; its drain-style snapshot
    set (slab.snap and fed.snap) in `directory`. Returns its fed rows."""
    ts = (JaxClock if pkg == "jax" else FakeTimeSource)(NOW)
    item = (JaxItem if pkg == "jax" else _Item)(fp=2, hits=1, limit=100, divider=1, jitter=0)
    peers = {"east": "tcp://127.0.0.1:1", "west": "tcp://127.0.0.1:2"}
    east = FED[pkg].FederationCoordinator("east", peers, ts, share_ttl_ms=5_000.0)
    east._grant_locked("west", [(2, W, 8, 100)])
    east._settle_locked("west", [(2, W, 3, 0)])
    east.consume(6, W + 1, 50, n=4, deadline=D)  # a home row with no slab row
    engine = _engine(pkg, ts)
    assert list(engine._launch([item])) == [1]
    snap = (jax_snapshotter if pkg == "jax" else port_snapshotter).SlabSnapshotter(
        engine, str(directory), interval_ms=1000, time_source=ts, fed=east
    )
    assert snap.snapshot_once() > 0
    return east.export_rows()


def _restore_set(pkg, directory):
    ts = (JaxClock if pkg == "jax" else FakeTimeSource)(NOW)
    peers = {"east": "tcp://127.0.0.1:1", "west": "tcp://127.0.0.1:2"}
    east = FED[pkg].FederationCoordinator("east", peers, ts, share_ttl_ms=5_000.0)
    engine = _engine(pkg, ts)
    stats = (jax_snapshotter if pkg == "jax" else port_snapshotter).SlabSnapshotter(
        engine, str(directory), interval_ms=1000, time_source=ts, fed=east
    ).restore()
    return stats, engine.export_tables()[0], east


@pytest.mark.parametrize("writer, reader", [("jax", "port"), ("port", "jax")])
def test_fed_snap_restores_across_the_packages(tmp_path, writer, reader):
    """A snapshot set with fed.snap written by one package restores into
    the other exactly as into the writer's own: the restore counts, the
    slab floored at the share's committed count (1 -> 8) before the upload,
    and the ledger re-seeded with the fence floor at now."""
    rows = _write_set(writer, tmp_path)
    (other,) = {"jax", "port"} - {writer}
    twin_dir = tmp_path / "twin"
    assert np.array_equal(_write_set(other, twin_dir), rows)
    for name in ("slab.snap", "fed.snap"):
        a, b = load_snapshot(str(tmp_path / name)), load_snapshot(str(twin_dir / name))
        assert a[0] == b[0] and np.array_equal(a[1], b[1]), name
    stats, table, east = _restore_set(reader, tmp_path)
    want_stats, want_table, want_east = _restore_set(writer, tmp_path)
    assert stats == want_stats
    assert stats["restored_fed_shares"] == 2 and stats["dropped_fed_shares"] == 0
    assert np.array_equal(table, want_table)
    live = table[table[:, 0] == 2]
    assert live.shape[0] == 1 and int(live[0, 2]) == int(rows[rows[:, 0] == 2][0, FED_COL_SPENT]) == 8
    assert np.array_equal(east.export_rows(), want_east.export_rows())
    assert east._fence_floor == want_east._fence_floor == NOW
    assert east.outstanding_tokens() == 5  # granted 8, settled 3


# -- the departure: the share rung asks on its first miss ---------------------


def test_share_rung_requests_a_share_on_its_first_miss(nets, test_store):
    """A borrowed key with no share yet: the rung answers None (the deny
    rung answers), queues a request, and after one pump serves from the
    granted share. The reference's rung queues nothing here, so a key with
    no share never gets one through it."""
    from api_ratelimit_tpu.cluster.federation import FederationCoordinator as JaxCoordinator
    from api_ratelimit_tpu_torch.limiter.base_limiter import BaseRateLimiter
    from api_ratelimit_tpu_torch.models import Descriptor
    from api_ratelimit_tpu_torch.models.response import DoLimitResponse

    store, _sink = test_store
    desc, fp, window = _REF._fp_and_window()
    home, borrower = ("east", "west") if fp % 2 == 0 else ("west", "east")
    net = nets({"east": "port", "west": "port"})
    coord = net.coords[borrower]
    coord.bind_base(BaseRateLimiter(net.ts))
    limit = _REF._make_limit(store, 3)
    assert coord.consume_for_fallback("chaos", desc, limit, 1, DoLimitResponse()) is None
    assert coord._wants[(fp, window)] == (3, window + 60)
    assert coord.pump()[home] == "ok"
    status = coord.consume_for_fallback("chaos", desc, limit, 1, DoLimitResponse())
    assert status is not None and status.limit_remaining == 2
    # the reference's rung, same state: no want queued
    ref = JaxCoordinator(borrower, {"east": "tcp://127.0.0.1:1", "west": "tcp://127.0.0.1:2"}, JaxClock(NOW))
    from api_ratelimit_tpu.limiter.base_limiter import BaseRateLimiter as JaxBase
    from api_ratelimit_tpu.models import Descriptor as JaxDescriptor
    from api_ratelimit_tpu.models.config import RateLimit, new_rate_limit_stats
    from api_ratelimit_tpu.models.response import DoLimitResponse as JaxResponse
    from api_ratelimit_tpu.models.response import RateLimitValue
    from api_ratelimit_tpu.models import Unit
    from api_ratelimit_tpu.stats import Store as JaxStore
    from api_ratelimit_tpu.stats import TestSink as JaxSink

    ref.bind_base(JaxBase(JaxClock(NOW)))
    jax_limit = RateLimit(
        full_key="key_value",
        stats=new_rate_limit_stats(JaxStore(JaxSink()), "key_value"),
        limit=RateLimitValue(requests_per_unit=3, unit=Unit.MINUTE),
    )
    assert ref.consume_for_fallback("chaos", JaxDescriptor.of(("k", "v")), jax_limit, 1, JaxResponse()) is None
    assert ref._wants == {}
    assert Descriptor.of(("k", "v")) == desc


# -- the slice as a whole: two Runners, each a federated cluster --------------

SHARED_RULES = "domain: fed\ndescriptors:\n  - key: k\n    rate_limit: {unit: hour, requests_per_unit: 12}\n"
RUNNER_NOW = 1_722_300_000


def _shared_keys(fingerprint64, n_each: int = 3) -> list:
    """Descriptor values of the shared rule, n_each homed at east (even
    fingerprints) and n_each at west."""
    homed = {0: [], 1: []}
    i = 0
    while min(len(v) for v in homed.values()) < n_each:
        from api_ratelimit_tpu_torch.models import Descriptor

        fp = fingerprint64("fed", Descriptor.of(("k", f"v{i}")).entries, 3600)
        if len(homed[fp % 2]) < n_each:
            homed[fp % 2].append(f"v{i}")
        i += 1
    return homed[0] + homed[1]


class _Home:
    """East: a coordinator of `pkg` behind that package's owner on loopback
    (the production OP_FED_EXCHANGE dispatch)."""

    def __init__(self, pkg, ts):
        # east never dials a peer here (it only grants), so its own entry
        # and west's are placeholders
        self.coord = FED[pkg].FederationCoordinator(
            "east", {"east": "tcp://127.0.0.1:1", "west": "tcp://127.0.0.1:9"}, ts
        )
        self.server = SIDECAR[pkg].SlabSidecarServer("tcp://127.0.0.1:0", _engine(pkg, ts), fed=self.coord)
        self.address = f"tcp://127.0.0.1:{self.server.port}"

    def close(self):
        self.coord.close()
        self.server.close()


def _runner_env(tmp_path, pkg, east_addr, fed: bool = True) -> dict:
    root = tmp_path / pkg
    (root / "rl" / "config").mkdir(parents=True, exist_ok=True)
    (root / "rl" / "config" / "fed.yaml").write_text(SHARED_RULES)
    env = {
        "BACKEND_TYPE": "tpu" if pkg == "jax" else "cuda", "RUNTIME_ROOT": str(root), "RUNTIME_SUBDIRECTORY": "rl",
        "USE_STATSD": "false", "PORT": "0", "GRPC_PORT": "0", "DEBUG_PORT": "0", "LOG_LEVEL": "WARN",
        "TPU_SLAB_SLOTS": "1024", "TPU_BUCKETS": "128", "SLAB_WAYS": "4", "TPU_BATCH_WINDOW": "200us",
        "HOTKEYS_ENABLED": "false", "FAILURE_MODE_DENY": "deny", "EXPIRATION_JITTER_MAX_SECONDS": "0",
        # the pump thread runs once at start and then sleeps: the test pumps
        "FED_SETTLE_INTERVAL_MS": "3600000",
    }
    if fed:
        env.update({"FED_ENABLED": "true", "FED_SELF": "west", "FED_PEERS": f"east={east_addr},west=tcp://127.0.0.1:9"})
    return env


def _boot(pkg, env):
    if pkg == "jax":
        from api_ratelimit_tpu.runner import Runner
        from api_ratelimit_tpu.settings import new_settings

        runner = Runner(new_settings(env))
    else:
        from api_ratelimit_tpu_torch.runner import Runner
        from api_ratelimit_tpu_torch.settings import new_settings

        runner = Runner(new_settings(env), device="cpu")
    runner.run_background()
    return runner


def _v3_bytes(port: int, values: list) -> list:
    import grpc

    from api_ratelimit_tpu_torch.pb import rls_v3

    out = []
    with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
        call = ch.unary_unary(
            "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=None,
        )
        for value in values:
            req = rls_v3.RateLimitRequest(domain="fed")
            req.descriptors.add().entries.add(key="k", value=value)
            out.append(call(req, timeout=30))
    return out


def _post(port: int, path: str, body: bytes) -> tuple:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture
def one_clock():
    """Both packages' process clocks on one FakeTimeSource at RUNNER_NOW."""
    from api_ratelimit_tpu.utils import timeutil as jax_time
    from api_ratelimit_tpu_torch.utils import timeutil as port_time

    clock = FakeTimeSource(RUNNER_NOW)
    jax_time.install_process_time_source(clock)
    port_time.install_process_time_source(clock)
    yield clock
    jax_time.install_process_time_source(jax_time.RealTimeSource())
    port_time.install_process_time_source(port_time.RealTimeSource())


def _outage_stream(runner, values: list, rounds: int, prime: bool = True) -> list:
    """`rounds` rounds of one call on each value, each round closed by a
    pump (the share requests and settles of the round). prime: first ask
    for a share of each borrowed key through the ledger (consume), so the
    reference's rung, which asks only for a dry share, starts alike."""
    from api_ratelimit_tpu_torch.models import Descriptor
    from api_ratelimit_tpu_torch.ops.hashing import fingerprint64

    window = RUNNER_NOW - RUNNER_NOW % 3600
    if prime:
        for value in values:
            fp = fingerprint64("fed", Descriptor.of(("k", value)).entries, 3600)
            if not runner.federation.is_home(fp):
                assert not runner.federation.consume(fp, window, 12, deadline=window + 3600)
        runner.federation.pump()
    out = []
    for _ in range(rounds):
        out += _v3_bytes(runner.server.grpc_port, values)
        runner.federation.pump()
    return out


def test_federated_runners_answer_the_outage_like_the_reference(tmp_path, one_clock):
    """A JAX Runner and a port Runner, each west of a two-cluster federation
    whose east home (its own package's owner) grants it shares: with the
    card's launches failed through POST /debug/faults (dispatch.launch
    error), 14 rounds over six shared keys (limit 12 an hour, three homed at
    each cluster) answer byte for byte alike; west-homed keys admit 12 from
    the home budget, east-homed keys are refused until a pump brings a
    share and then admit at most 12; the faults document and the ladder's
    counters agree, and so do the ratelimit_fed_* and fallback lines of
    /metrics. Then the empty spec: the card serves again. Each
    borrowed key's first share is asked for through the ledger before the
    stream (the reference's rung asks only once a share ran dry)."""
    from api_ratelimit_tpu_torch.ops.hashing import fingerprint64

    values = _shared_keys(fingerprint64)
    answers, docs, runners, homes = {}, {}, [], []
    try:
        for pkg in ("jax", "port"):
            home = _Home(pkg, FakeTimeSource(RUNNER_NOW))
            homes.append(home)
            runner = _boot(pkg, _runner_env(tmp_path, pkg, home.address))
            runners.append(runner)
            status, doc = _post(runner.server.debug_port, "/debug/faults", b"dispatch.launch:error:1")
            assert status == 200 and doc["rules"][0]["spec"] == "dispatch.launch:error:1"
            answers[pkg] = _outage_stream(runner, values, 14)
            status, docs[pkg] = _post(runner.server.debug_port, "/debug/faults", b"")
            assert status == 200
            answers[pkg] += _v3_bytes(runner.server.grpc_port, ["fresh"])
            docs[pkg]["ledger"] = runner.federation.export_rows().tolist()
            docs[pkg]["home"] = home.coord.export_rows().tolist()
            docs[pkg]["fallback_hits"] = runner.federation.fallback_hits_total
            with urllib.request.urlopen(f"http://127.0.0.1:{runner.server.debug_port}/metrics", timeout=10) as resp:
                docs[pkg]["metrics"] = [
                    line
                    for line in resp.read().decode().splitlines()
                    if ("_fed_" in line or "_fallback_" in line) and "fallback_local" not in line
                ]
            # the reference's degraded rung's counter, which the port has not
            docs[pkg]["stats"] = {
                k: v
                for k, v in runner.stats_store.debug_snapshot().items()
                if (".fallback." in k or ".fed." in k) and k != "ratelimit.fallback.local"
            }
        assert answers["port"] == answers["jax"]
        assert docs["port"] == docs["jax"]
        from api_ratelimit_tpu_torch.pb import rls_v3

        codes = [rls_v3.RateLimitResponse.FromString(raw).overall_code for raw in answers["port"]]
        per_key = {v: codes[i :: len(values)][:14] for i, v in enumerate(values[: len(values)])}
        over = rls_v3.RateLimitResponse.OVER_LIMIT
        for i, value in enumerate(values):
            ok = sum(c == rls_v3.RateLimitResponse.OK for c in per_key[value])
            assert ok == 12, (value, ok)  # the limit, never more
            if i < 3:
                # east-homed: the share of 8 runs dry in round 9, which is
                # refused until the pump brings the last 4; round 14 finds
                # the home at its limit
                assert [j for j, c in enumerate(per_key[value]) if c == over] == [8, 13]
            else:
                assert [j for j, c in enumerate(per_key[value]) if c == over] == [12, 13]
        assert docs["port"]["fired"]["dispatch.launch:error"] > 0
        assert codes[-1] == rls_v3.RateLimitResponse.OK  # the card again
    finally:
        for runner in runners:
            runner.stop()
        for home in homes:
            home.close()


def test_port_runner_asks_for_a_share_on_its_first_miss(tmp_path, one_clock):
    """Unprimed, the port's west refuses each borrowed key's first call
    during the outage, asks the home for a share on that miss, and admits
    from it after the pump; west-homed keys admit from the home budget at
    once."""
    from api_ratelimit_tpu_torch.ops.hashing import fingerprint64
    from api_ratelimit_tpu_torch.pb import rls_v3

    values = _shared_keys(fingerprint64)
    home = _Home("port", FakeTimeSource(RUNNER_NOW))
    runner = _boot("port", _runner_env(tmp_path, "port", home.address))
    try:
        assert _post(runner.server.debug_port, "/debug/faults", b"dispatch.launch:error:1")[0] == 200
        raws = _outage_stream(runner, values, 2, prime=False)
        codes = [rls_v3.RateLimitResponse.FromString(raw).overall_code for raw in raws]
        ok, over = rls_v3.RateLimitResponse.OK, rls_v3.RateLimitResponse.OVER_LIMIT
        assert codes == [over] * 3 + [ok] * 3 + [ok] * 6
        assert runner.federation.describe()["shares_held"] == 3
        assert home.coord.grants_total == 3
    finally:
        runner.stop()
        home.close()


def test_rollback_arm_answers_as_the_federated_cluster(tmp_path, one_clock):
    """FED_ENABLED=false and true answer one healthy stream alike on the
    port (the ledger is not on the served path), as on the reference."""
    from api_ratelimit_tpu_torch.ops.hashing import fingerprint64

    values = _shared_keys(fingerprint64) * 3
    got = {}
    home = _Home("port", FakeTimeSource(RUNNER_NOW))
    try:
        for fed in (False, True):
            runner = _boot("port", _runner_env(tmp_path / str(fed), "port", home.address, fed=fed))
            try:
                got[fed] = _v3_bytes(runner.server.grpc_port, values)
                assert (runner.federation is not None) == fed
            finally:
                runner.stop()
    finally:
        home.close()
    assert got[True] == got[False]


# -- C7: the home's garbage collection ----------------------------------------


def test_home_pump_keeps_a_granted_windows_count():
    """A home whose granted window started over a second ago: the
    reference's pump raises UnboundLocalError from its collection (every
    interval, before the fed.degraded probe updates); the port's pump
    returns, keeps the committed count while the grant is out, keeps what
    a reclaim leaves of it until a day after the window's start, and so
    never grants the window's limit twice."""
    window = NOW - NOW % 3600
    peers = {"east": "tcp://127.0.0.1:1", "west": "tcp://127.0.0.1:2"}
    ref = jax_fed.FederationCoordinator("east", peers, JaxClock(NOW), share_ttl_ms=2000.0)
    ref._grant_locked("west", [(2, window, 8, 10)])
    with pytest.raises(UnboundLocalError):
        ref.pump()
    ts = FakeTimeSource(NOW)
    east = port_fed.FederationCoordinator("east", peers, ts, share_ttl_ms=2000.0)
    east._grant_locked("west", [(2, window, 8, 10)])
    east._settle_locked("west", [(2, window, 6, 0)])
    assert east.pump() == {} and east._used[(2, window)] == 8
    ts.advance(3)
    assert east.reclaim_sweep() == 2
    east.pump()
    assert east._used[(2, window)] == 6  # the settled spend stays counted
    grants = east._grant_locked("west", [(2, window, 64, 10)])
    assert grants == [(2, window, 4, 10)]  # the headroom the limit leaves
    ts.advance(port_fed.WINDOW_HOLD_S)
    assert east.reclaim_sweep() == 4
    east.pump()
    assert (2, window) not in east._used


# -- chip_smoke's federation phase, rehearsed on the CPU ----------------------


def _in_process_east(root, scratch, env):
    """East as sidecar_cmd wires it (the owner on the real clock: its
    engine, the wire with fed= and the injector, the debug port with
    /debug/faults, /debug/clock and /debug/federation), served in this
    process on the CPU."""
    from api_ratelimit_tpu_torch.server.http_server import add_chaos_admin, new_debug_server
    from api_ratelimit_tpu_torch.settings import new_settings
    from api_ratelimit_tpu_torch.testing.faults import FaultInjector
    from api_ratelimit_tpu_torch.utils.timeutil import RealTimeSource, SkewableTimeSource

    settings = new_settings(env)
    _on, name, peers, share_min, share_max, interval, lag, ttl = settings.fed_config()
    clock = SkewableTimeSource(RealTimeSource())
    store = Store(TestSink())
    faults = FaultInjector()
    coord = port_fed.FederationCoordinator(
        name, peers, clock, share_min=share_min, share_max=share_max, settle_interval_ms=interval,
        max_lag_ms=lag, share_ttl_ms=ttl, scope=store.scope("ratelimit"), fault_injector=faults,
    )
    engine = SlabDeviceEngine(clock, n_slots=1 << 12, buckets=(128,), device="cpu", block_mode=True)
    server = port_sidecar.SlabSidecarServer(peers[name], engine, fault_injector=faults, fed=coord)
    debug = new_debug_server(store, "127.0.0.1", 0)
    add_chaos_admin(debug, faults, clock)
    debug.add_debug_endpoint("/debug/federation", lambda: json.dumps(coord.describe(), indent=2))
    debug.serve_background()
    coord.start()

    def stop():
        coord.close()
        server.close()
        debug.shutdown()

    return peers[name], debug.port, stop


def test_chip_smoke_federation_phase_on_the_cpu(monkeypatch):
    """chip_smoke.py's federation phase (15), rehearsed on the CPU at a
    small size with east served in process: the rollback arm
    byte-identical, the outage answered from the home budget and the
    shares within each limit with the fed journeys, the exchange faults
    resynced, the recovery, and the restart: east's reclaim equal to
    fed.snap's unsettled tokens, the live rows restored with their floors,
    the handshake first."""
    import chip_smoke as CS
    from api_ratelimit_tpu_torch.ops import slab_kernels as K

    for name, value in (
        ("FED_LIMIT", 12), ("FED_BURST", 4), ("FED_ROUNDS", 7), ("FED_PARTIAL_ROUNDS", 2),
        ("FED_TTL_MS", 8000), ("FED_CALLS", 96), ("PROCESS_CLOCK_EVERY", 32), ("FED_PUMP_WAIT_S", 0.15),
    ):
        monkeypatch.setattr(CS, name, value)
    monkeypatch.setattr(CS, "FED_RULES", CS.FED_RULES.replace("requests_per_unit: 50}", "requests_per_unit: 12}"))
    small = {"TPU_SLAB_SLOTS": str(1 << 12), "SLAB_WAYS": "4", "TPU_BUCKETS": "128,1024"}
    out = CS.phase_federation(K, device="cpu", east=_in_process_east, **small)
    a, b, c, e = out["a"], out["b"], out["c"], out["e"]
    assert a["calls"] == 96 and not any(a["fallback"].values()) and len(a["fed_families"]) >= 8
    assert b["ok_per_key"]["east_full"] == [12] * 4 and b["ok_per_key"]["west"] == [12] * 8
    assert b["fed_served"] == b["journeys_fed"] == b["ok"] and b["fallback_deny"] == b["calls"]
    assert c["resyncs"] >= 2 and c["exchange_errors"] >= 2
    # the partial keys' unspent tokens: how many depends on when their
    # grants land within a burst
    assert e["east_reclaimed_tokens"] == e["unsettled_tokens"] > 0
    assert e["restore_fed_shares"] == 8 and len(e["floored_rows"]) == 8
    assert all(count >= floor == 12 for count, floor in e["floored_rows"])
