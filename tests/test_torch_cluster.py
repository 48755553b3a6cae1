"""The port's partitioned cluster (api_ratelimit_tpu_torch/cluster/: the
PartitionMap, ClusterNode, the PartitionedEngineClient router and the
ReshardCoordinator; the engine's export_route_range and merge_rows; the
owner's map fence and admin ops; the snapshotter's partition stamp; the
dispatch loop's partition labels) on the CPU, against the JAX package's.

* The JAX package's tests/test_cluster.py runs on the port class by class
  (reference_tests_on_the_port): TestPartitionMap, TestRoutingFuzz,
  TestDifferentialParity, TestRollbackArm, TestStaleMapWire,
  TestLiveReshard, TestPartitionChaos, TestDebugSurfaces,
  TestSnapshotPartitionStamp and TestDispatchPartitionLabel. The
  inspector case runs the port's tools/snapshot_inspect.py. One case is
  not run as the reference writes it:
  - TestDebugSurfaces::test_debug_cluster_http_endpoint mounts the handler
    through the JAX debug server's add_get(path, handler(h)); the port's
    debug server mounts a text endpoint (add_debug_endpoint), as
    cmd/sidecar_cmd.py does, so the case is rewritten here under its name
    and holds the body to the JAX node's describe().
  The reference's in-process client seam (_InprocClient) and the parity
  control call their block-mode engines' submit_rows; the port's
  block-mode engine takes submit_block only, so both call that.
* A JAX router against port owners and the port router against JAX owners
  answer a seeded stream as the memory-backend oracle does.
* A reshard section pulled from a JAX owner merges into a port owner and
  the reverse, through a ReshardCoordinator of either package, and the two
  engines' merge_rows leave bit-equal tables.
* The map JSON, the map-stamped SUBMIT frames (FLAG_MAP, and FLAG_EPOCH
  with FLAG_MAP for a per-partition failover list) and the stale-map reply
  are byte-identical across the packages.
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
from api_ratelimit_tpu.cluster import node as jax_node  # noqa: E402
from api_ratelimit_tpu.cluster import partition_map as jax_pm  # noqa: E402
from api_ratelimit_tpu.cluster import reshard as jax_reshard  # noqa: E402
from api_ratelimit_tpu.cluster import router as jax_router  # noqa: E402
from api_ratelimit_tpu.utils import FakeTimeSource as JaxClock  # noqa: E402
from api_ratelimit_tpu.utils.timeutil import RealTimeSource as JaxRealTime  # noqa: E402
from api_ratelimit_tpu_torch.backends import sidecar as port_sidecar  # noqa: E402
from api_ratelimit_tpu_torch.backends.cuda import SlabDeviceEngine  # noqa: E402
from api_ratelimit_tpu_torch.cluster import node as port_node  # noqa: E402
from api_ratelimit_tpu_torch.cluster import partition_map as port_pm  # noqa: E402
from api_ratelimit_tpu_torch.cluster import reshard as port_reshard  # noqa: E402
from api_ratelimit_tpu_torch.cluster import router as port_router  # noqa: E402
from api_ratelimit_tpu_torch.persist.snapshot import ROW_WIDTH, pack_table_bytes  # noqa: E402
from api_ratelimit_tpu_torch.server.http_server import new_debug_server  # noqa: E402
from api_ratelimit_tpu_torch.stats import Store, TestSink  # noqa: E402
from api_ratelimit_tpu_torch.utils import FakeTimeSource  # noqa: E402
from api_ratelimit_tpu_torch.utils.timeutil import RealTimeSource  # noqa: E402

_REF = reference_tests_on_the_port(
    "test_cluster",
    (
        ("api_ratelimit_tpu_torch.backends.tpu", "api_ratelimit_tpu_torch.backends.cuda"),
        ("use_pallas=False", 'device="cpu"'),
        ('settings.backend_type = "tpu-sidecar"', 'settings.backend_type = "cuda-sidecar"'),
        # the port's block-mode engine takes the block verb only (a
        # deliberate departure); the in-process client seam passes no lease ops
        ("return self.engine.submit_rows(block, lease_ops=lease_ops)", "return self.engine.submit_block(block)"),
        ("want = control.submit_rows(blk.copy())", "want = control.submit_block(blk.copy())"),
        # the port's inspector (api_ratelimit_tpu_torch/tools/snapshot_inspect.py)
        ("import tools.snapshot_inspect as inspect_mod", "import api_ratelimit_tpu_torch.tools.snapshot_inspect as inspect_mod"),
    ),
)

TestPartitionMap = _REF.TestPartitionMap
TestRoutingFuzz = _REF.TestRoutingFuzz
TestDifferentialParity = _REF.TestDifferentialParity
TestRollbackArm = _REF.TestRollbackArm
TestStaleMapWire = _REF.TestStaleMapWire
TestLiveReshard = _REF.TestLiveReshard
TestPartitionChaos = _REF.TestPartitionChaos
TestDispatchPartitionLabel = _REF.TestDispatchPartitionLabel


TestSnapshotPartitionStamp = _REF.TestSnapshotPartitionStamp
class TestDebugSurfaces(_REF.TestDebugSurfaces):
    def test_debug_cluster_http_endpoint(self, test_store):
        """GET /debug/cluster as cmd/sidecar_cmd.py mounts it: the node's
        describe() as JSON, equal to the JAX node's for the same map."""
        store, _sink = test_store
        pmap = port_pm.PartitionMap.even_map([["a"]], route_sets=64, epoch=2)
        node = port_node.ClusterNode(0, pmap)
        debug = new_debug_server(store, "127.0.0.1", 0)
        debug.add_debug_endpoint("/debug/cluster", lambda: json.dumps(node.describe(), indent=2))
        debug.serve_background()
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{debug.port}/debug/cluster", timeout=5) as resp:
                body = json.loads(resp.read())
            assert body["map_epoch"] == 2
            assert body["partition"] == 0
            jmap = jax_pm.PartitionMap.even_map([["a"]], route_sets=64, epoch=2)
            assert body == jax_node.ClusterNode(0, jmap).describe()
        finally:
            debug.shutdown()


@pytest.fixture
def test_store():
    """The port's store (the reference classes read its debug_snapshot)."""
    sink = TestSink()
    return Store(sink), sink


SLOTS = 1 << 10
WAYS = 4
ROUTE_SETS = 64


def _port_engine():
    return SlabDeviceEngine(RealTimeSource(), n_slots=SLOTS, ways=WAYS, buckets=(128,), device="cpu",
                            block_mode=True)


def _jax_engine():
    return JaxEngine(JaxRealTime(), n_slots=SLOTS, ways=WAYS, buckets=(128,), use_pallas=False,
                     block_mode=True)


PKGS = {
    "port": (_port_engine, port_sidecar, port_node, port_pm, port_router, port_reshard),
    "jax": (_jax_engine, jax_sidecar, jax_node, jax_pm, jax_router, jax_reshard),
}

_block = _REF._block
_fast = _REF._fast_client_kwargs


class _Owner:
    """One socket-served partition owner of a package."""

    def __init__(self, pkg, sock, pmap_json, index, engine=None):
        mk, side, node, pm, _r, _rs = PKGS[pkg]
        self.engine = engine if engine is not None else mk()
        self.node = node.ClusterNode(index, pm.PartitionMap.from_json_bytes(pmap_json))
        self.server = side.SlabSidecarServer(sock, self.engine, cluster=self.node)

    def close(self):
        self.server.close()


def _stream(seed, n=30):
    rng = np.random.default_rng(seed)
    return [
        _block(rng.integers(1, 1 << 32, int(rng.integers(1, 9)), dtype=np.uint64) % 97 + 1,
               hits=int(rng.integers(1, 4)), limit=20)
        for _ in range(n)
    ]


def _oracle(blocks):
    """Post-increment counters of the stream on one plain dict."""
    counts, out = {}, []
    for b in blocks:
        row = []
        for lo, hi, hits in zip(b[0].tolist(), b[1].tolist(), b[2].tolist()):
            counts[(lo, hi)] = counts.get((lo, hi), 0) + hits
            row.append(counts[(lo, hi)])
        out.append(row)
    return out


@pytest.mark.parametrize("router_pkg, owner_pkg", [("jax", "port"), ("port", "jax"), ("port", "port")])
def test_router_and_owners_across_packages(tmp_path, router_pkg, owner_pkg):
    """A router of one package over three owners of the other answers a
    seeded stream (blocks spanning partitions, repeated keys) as the plain
    counter oracle does."""
    socks = [str(tmp_path / f"o{i}.sock") for i in range(3)]
    pmap_json = port_pm.PartitionMap.even_map([[s] for s in socks], route_sets=ROUTE_SETS).to_json_bytes()
    owners = [_Owner(owner_pkg, socks[i], pmap_json, i) for i in range(3)]
    pm, rt = PKGS[router_pkg][3], PKGS[router_pkg][4]
    router = rt.PartitionedEngineClient(pm.PartitionMap.from_json_bytes(pmap_json), client_kwargs=_fast())
    try:
        blocks = _stream(17)
        got = [router.submit_rows(b).tolist() for b in blocks]
        assert got == _oracle(blocks)
        # every owner served only its own range
        for i, o in enumerate(owners):
            table = o.engine.export_tables()[0]
            live = table[table.any(axis=1)]
            assert live.shape[0] > 0
            part = port_pm.PartitionMap.from_json_bytes(pmap_json).partition_of(live[:, 0])
            assert (part == i).all()
    finally:
        router.close()
        for o in owners:
            o.close()


@pytest.mark.parametrize("coord_pkg, old_pkg, new_pkg", [
    ("port", "jax", "port"),
    ("jax", "port", "jax"),
    ("port", "port", "jax"),
])
def test_reshard_across_packages(tmp_path, coord_pkg, old_pkg, new_pkg):
    """A 2 -> 3 reshard whose sections cross the packages: the old owners
    of one package, the joining owner of the other, the coordinator of
    either. Afterwards every key continues its counter exactly (no load
    runs during the move), the router adopted the new epoch, and the moved
    rows live on their new owners."""
    socks = [str(tmp_path / f"o{i}.sock") for i in range(3)]
    pmap2 = port_pm.PartitionMap.even_map([[socks[0]], [socks[1]]], route_sets=ROUTE_SETS)
    pmap3 = pmap2.reshard_to([[s] for s in socks])
    owners = [_Owner(old_pkg, socks[i], pmap2.to_json_bytes(), i) for i in range(2)]
    owners.append(_Owner(new_pkg, socks[2], pmap3.to_json_bytes(), 2))
    router = port_router.PartitionedEngineClient(pmap2, client_kwargs=_fast())
    try:
        fps = np.arange(1, 200, dtype=np.uint64) * 2654435761 % (1 << 32)
        for _ in range(3):
            assert (router.submit_rows(_block(fps)) > 0).all()
        pm, rs = PKGS[coord_pkg][3], PKGS[coord_pkg][5]
        report = rs.ReshardCoordinator(
            pm.PartitionMap.from_json_bytes(pmap2.to_json_bytes()),
            pm.PartitionMap.from_json_bytes(pmap3.to_json_bytes()),
        ).run()
        assert report["sets_moved"] > 0 and report["rows_staged"] > 0
        assert (router.submit_rows(_block(fps)) == 4).all()
        assert router.map_epoch() == pmap3.epoch
        table = owners[2].engine.export_tables()[0]
        live = table[table.any(axis=1)]
        assert (pmap3.partition_of(live[:, 0]) == 2).all()
        assert live.shape[0] == int((pmap3.partition_of(fps.astype(np.uint32)) == 2).sum())
    finally:
        router.close()
        for o in owners:
            o.close()


def test_live_reshard_loss_within_each_keys_calls_across_the_flip(tmp_path):
    """A 2 -> 3 reshard of port owners under eight threads of load on twelve
    keys: no call fails, and each key's final counter lies in [n - m, n],
    m its own calls answered after the first map install and started
    before the last reshard reply. The drain's keep-the-newest merge can
    drop only the target's writes from the flip to that merge, so this is
    the per-key form of TestLiveReshard's bound (chip_smoke.py phase 14
    (b) holds the owners on the card to it)."""
    socks = [str(tmp_path / f"o{i}.sock") for i in range(3)]
    pmap2 = port_pm.PartitionMap.even_map([[socks[0]], [socks[1]]], route_sets=ROUTE_SETS)
    pmap3 = pmap2.reshard_to([[s] for s in socks])
    owners = [_Owner("port", socks[i], pmap2.to_json_bytes(), i) for i in range(2)]
    owners.append(_Owner("port", socks[2], pmap3.to_json_bytes(), 2))
    router = port_router.PartitionedEngineClient(pmap2, client_kwargs=_fast())
    keys = np.random.default_rng(41).integers(1, 1 << 30, size=12, dtype=np.uint64).tolist()
    calls, errors, stop, marks = [], [], threading.Event(), {}

    def drive(tid):
        rng = np.random.default_rng(200 + tid)
        while not stop.is_set():
            fp = keys[int(rng.integers(0, len(keys)))]
            t0 = time.time()
            try:
                router.submit_rows(_block([fp]))
            except Exception as e:  # noqa: BLE001 - a failed call is the finding
                errors.append(repr(e))
                return
            calls.append((fp, t0, time.time()))

    def rpc(addr, op, payload):
        if op == port_sidecar.OP_MAP_SET:
            marks.setdefault("flip", time.time())
        reply = port_sidecar.cluster_rpc(addr, op, payload)
        marks["done"] = time.time()
        return reply

    threads = [threading.Thread(target=drive, args=(i,)) for i in range(8)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.3)
        report = port_reshard.ReshardCoordinator(pmap2, pmap3, rpc=rpc).run()
        time.sleep(0.3)
    finally:
        stop.set()
        for t in threads:
            t.join(10)
    try:
        assert errors == [], errors
        assert report["sets_moved"] > 0
        assert router.map_epoch() == pmap3.epoch
        for fp in keys:
            n = sum(1 for k, _t0, _t1 in calls if k == fp)
            m = sum(1 for k, t0, t1 in calls if k == fp and t1 >= marks["flip"] and t0 <= marks["done"])
            final = int(router.submit_rows(_block([fp]))[0]) - 1
            assert n - m <= final <= n, (fp, n, m, final)
    finally:
        router.close()
        for o in owners:
            o.close()


def test_merge_rows_matches_the_jax_engine():
    """The same slab, then the same pushed section (new keys, a newer
    window over an older one, an older window, an equal window with a
    greater count, a non-fixed algorithm row): both engines' merge_rows
    return the same stats and leave bit-equal tables, and the port's guard
    flips as the JAX one does."""
    now = int(time.time())
    window = now - now % 3600
    port, jax = _port_engine(), _jax_engine()
    try:
        seed = _block(np.arange(1, 60, dtype=np.uint64), hits=2)
        port.submit_block(seed)
        jax.submit_block(seed)
        rows = np.zeros((6, ROW_WIDTH), dtype=np.uint32)
        rows[0] = (1001, 0, 5, window, now + 600, 3600, 0, 0)  # a new key
        rows[1] = (1, 0, 9, window, now + 600, 3600, 0, 0)  # same window, greater count
        rows[2] = (2, 0, 1, window, now + 600, 3600, 0, 0)  # same window, smaller count
        rows[3] = (3, 0, 1, window - 3600, now, 3600, 0, 0)  # an older window
        rows[4] = (4, 0, 7, window + 3600, now + 7200, 3600, 0, 0)  # a newer window
        rows[5] = (2002, 0, 3, window, now + 600, 3600 | (1 << 28), 0, 0)  # sliding window
        assert not port.algos_seen
        assert port.merge_rows(rows) == jax.merge_rows(rows)
        assert np.array_equal(port.export_tables()[0], np.asarray(jax.export_tables()[0]))
        assert port.algos_seen
        assert len(port.merge_times) == 1
        # the route-range pull is the same rows, and the same section bytes
        for lo, hi in ((0, 1), (0, 64), (17, 40)):
            want = np.asarray(jax.export_route_range(lo, hi, 64))
            got = port.export_route_range(lo, hi, 64)
            assert np.array_equal(got, want)
            assert pack_table_bytes(got, now, ways=WAYS) == pack_table_bytes(want, now, ways=WAYS)
        with pytest.raises(ValueError, match="power of two"):
            port.export_route_range(0, 1, 3)
        with pytest.raises(ValueError, match="outside"):
            port.export_route_range(4, 4, 64)
    finally:
        port.close()
        jax.close()


def test_map_json_is_byte_identical():
    groups = [["/run/a.sock", "/run/a2.sock"], ["tcp://10.0.0.2:7000"], ["/run/c.sock"]]
    maps = [m.PartitionMap.even_map(groups, route_sets=256, epoch=3) for m in (port_pm, jax_pm)]
    assert maps[0].to_json_bytes() == maps[1].to_json_bytes()
    nxt = [m.reshard_to([["/run/a.sock"], ["/run/b.sock"]]) for m in maps]
    assert nxt[0].to_json_bytes() == nxt[1].to_json_bytes()
    assert [(lo, hi, s.addrs, d.addrs) for lo, hi, s, d in maps[0].moved_ranges(nxt[0])] == [
        (lo, hi, s.addrs, d.addrs) for lo, hi, s, d in maps[1].moved_ranges(nxt[1])
    ]
    fps = np.random.default_rng(2).integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(maps[0].partition_of(fps), maps[1].partition_of(fps))


def _capture(tmp_path, mod, addrs, epoch):
    """The SUBMIT frame a client of `mod` sends with map epoch `epoch` to a
    capturing owner (the first address), answering ok."""
    sock = str(tmp_path / "cap.sock")
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock)
    srv.listen(4)
    captured = []

    def serve():
        try:
            while True:
                conn, _ = srv.accept()
                with conn:
                    while True:
                        hdr = port_sidecar._recv_exact(conn, 8)
                        _m, _v, op, flags = port_sidecar._HDR.unpack(hdr)
                        if op == 2:
                            conn.sendall(b"\x00")
                            continue
                        n_raw = port_sidecar._recv_exact(conn, 4)
                        (n,) = struct.unpack("<I", n_raw)
                        body = n_raw + port_sidecar._recv_exact(conn, 24 * n)
                        extra = 4 * bool(flags & 4) + 4 * bool(flags & 8)
                        body += port_sidecar._recv_exact(conn, extra)
                        captured.append(hdr + body)
                        ones = np.ones(n, dtype=np.uint32).tobytes()
                        if flags & 4:
                            conn.sendall(b"\x02" + struct.pack("<II", 0, n) + ones)
                        else:
                            conn.sendall(b"\x00" + struct.pack("<I", n) + ones)
        except (OSError, ConnectionError):
            return

    threading.Thread(target=serve, daemon=True).start()
    client = mod.SidecarEngineClient([sock] + addrs, retries=0, breaker_threshold=0,
                                     map_epoch_fn=lambda: epoch)
    try:
        client.submit_rows(_block([42, 77]))
    finally:
        client.close()
        srv.close()
    return captured[-1]


@pytest.mark.parametrize("standbys", [0, 1], ids=["map", "epoch_and_map"])
def test_map_stamped_frames_are_byte_identical(tmp_path, standbys):
    """A router's per-partition client frames: FLAG_MAP and its u32
    trailer, after FLAG_EPOCH's when the partition has a standby."""
    frames = []
    for pkg, mod in (("port", port_sidecar), ("jax", jax_sidecar)):
        (tmp_path / pkg).mkdir()
        frames.append(_capture(tmp_path / pkg, mod, [str(tmp_path / pkg / "s.sock")] * standbys, 9))
    assert frames[0] == frames[1]
    flags = port_sidecar._HDR.unpack(frames[0][:8])[3]
    assert flags == (port_sidecar.FLAG_MAP | (port_sidecar.FLAG_EPOCH if standbys else 0))
    assert frames[0][-4:] == struct.pack("<I", 9)


@pytest.mark.parametrize("case", ["stale_epoch", "misrouted"])
def test_stale_map_replies_are_byte_identical(tmp_path, case):
    """An owner of each package holding map epoch 5 answers a frame routed
    with epoch 1 (or routed at the current epoch to rows it does not own)
    with the same STATUS_STALE_MAP bytes, and applies nothing."""
    replies = []
    socks = {"port": str(tmp_path / "p.sock"), "jax": str(tmp_path / "j.sock")}
    for pkg in ("port", "jax"):
        sock = socks[pkg]
        pmap = port_pm.PartitionMap.even_map([[sock], ["/run/other.sock"]], route_sets=ROUTE_SETS, epoch=5)
        owner = _Owner(pkg, sock, pmap.to_json_bytes(), 0)
        epoch, fp = (1, 3) if case == "stale_epoch" else (5, 40)
        request = (
            port_sidecar._HDR.pack(port_sidecar.MAGIC, port_sidecar.VERSION, port_sidecar.OP_SUBMIT,
                                   port_sidecar.FLAG_MAP)
            + struct.pack("<I", 1) + _block([fp]).tobytes() + struct.pack("<I", epoch)
        )
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.settimeout(10)
        conn.connect(sock)
        try:
            conn.sendall(request)
            head = port_sidecar._recv_exact(conn, 5)
            (ln,) = struct.unpack_from("<I", head, 1)
            replies.append(head + port_sidecar._recv_exact(conn, ln))
        finally:
            conn.close()
        assert not owner.engine.export_tables()[0].any()
        owner.close()
    # the maps name each package's own socket: compare with it masked
    a, b = (r.replace(socks[p].encode(), b"OWNER") for r, p in zip(replies, ("port", "jax")))
    assert a == b
    assert a[0] == port_sidecar.STATUS_STALE_MAP
    assert port_pm.PartitionMap.from_json_bytes(replies[0][5:]).epoch == 5


def test_reshard_ops_on_an_owner_without_a_cluster(tmp_path):
    """A port owner without a ClusterNode serves the reshard pull and push
    from its engine, as a JAX owner does, with the same section bytes, and
    answers the map ops with the error frame."""
    addrs = {}
    servers = []
    now = int(time.time())
    for pkg, engine in (
        ("port", SlabDeviceEngine(FakeTimeSource(now), n_slots=SLOTS, ways=WAYS, buckets=(128,), device="cpu",
                                  block_mode=True)),
        ("jax", JaxEngine(JaxClock(now), n_slots=SLOTS, ways=WAYS, buckets=(128,), use_pallas=False,
                          block_mode=True)),
    ):
        side = PKGS[pkg][1]
        engine.submit_block(_block(np.arange(1, 40, dtype=np.uint64)))
        sock = str(tmp_path / f"{pkg}.sock")
        servers.append(side.SlabSidecarServer(sock, engine))
        addrs[pkg] = sock
    try:
        pulls = [
            port_sidecar.cluster_rpc(addrs[p], port_sidecar.OP_RESHARD_PULL, struct.pack("<III", 0, 16, 64))
            for p in ("port", "jax")
        ]
        assert pulls[0] == pulls[1]
        for p in ("port", "jax"):
            stats = json.loads(port_sidecar.cluster_rpc(
                addrs[p], port_sidecar.OP_RESHARD_PUSH, struct.pack("<I", len(pulls[1])) + pulls[1]
            ))
            assert stats["merged"] > 0 or stats.get("kept_existing", 0) >= 0
            with pytest.raises(port_sidecar.CacheError, match="cluster not configured"):
                port_sidecar.cluster_rpc(addrs[p], port_sidecar.OP_MAP_GET)
    finally:
        for s in servers:
            s.close()


def _runner_settings(tmp_path, **kw):
    from api_ratelimit_tpu_torch import settings as port_settings

    import test_server_integration as ref_it

    runtime_path, subdir, _ = ref_it.make_runtime(tmp_path)
    return port_settings.Settings(
        port=0, grpc_port=0, debug_port=0, use_statsd=False, runtime_path=runtime_path,
        runtime_subdirectory=subdir, log_level="ERROR", **kw,
    )


def test_partitioned_runner_answers_as_the_memory_runner(tmp_path):
    """A cuda-sidecar Runner with PARTITIONS=2 over two port owners (the
    router, one failover client a partition) answers a v3 stream byte for
    byte as a memory Runner on the same fake process clock, serves
    /debug/cluster with the router's view, and leaves /healthcheck plain."""
    import grpc

    from api_ratelimit_tpu_torch import runner as port_runner
    from api_ratelimit_tpu_torch.pb import rls_grpc, rls_v3
    from api_ratelimit_tpu_torch.utils import timeutil as port_time

    socks = [str(tmp_path / f"o{i}.sock") for i in range(2)]
    pmap_json = port_pm.PartitionMap.even_map([[s] for s in socks], route_sets=ROUTE_SETS).to_json_bytes()
    clock = FakeTimeSource(1_700_000_000)
    owners = [
        _Owner("port", socks[i], pmap_json, i, engine=SlabDeviceEngine(
            clock, n_slots=SLOTS, ways=WAYS, buckets=(128,), device="cpu", block_mode=True))
        for i in range(2)
    ]
    port_time.install_process_time_source(clock)
    runners = []
    try:
        for i, kw in enumerate((
            dict(backend_type="cuda-sidecar", partitions=2, partition_addrs=";".join(socks),
                 partition_route_sets=ROUTE_SETS),
            dict(backend_type="memory"),
        )):
            (tmp_path / f"r{i}").mkdir()
            r = port_runner.Runner(_runner_settings(tmp_path / f"r{i}", **kw), device="cpu")
            r.run_background()
            assert r.wait_ready(10.0)
            runners.append(r)
        router = runners[0].cache.engine
        assert isinstance(router, port_router.PartitionedEngineClient)
        rng = np.random.default_rng(8)
        served = set()
        chans = [grpc.insecure_channel(f"localhost:{r.server.grpc_port}") for r in runners]
        try:
            stubs = [rls_grpc.RateLimitServiceV3Stub(ch) for ch in chans]
            for _ in range(120):
                req = rls_v3.RateLimitRequest(domain="basic")
                for _d in range(int(rng.integers(1, 4))):
                    key = "one_per_minute" if rng.random() < 0.5 else "key1"
                    req.descriptors.add().entries.add(key=key, value=f"v{int(rng.integers(0, 12))}")
                got, want = (s.ShouldRateLimit(req, timeout=30).SerializeToString() for s in stubs)
                assert got == want
        finally:
            for ch in chans:
                ch.close()
        for o in owners:
            table = o.engine.export_tables()[0]
            served.add(int(table.any(axis=1).sum()) > 0)
        assert served == {True}  # both partitions took rows
        debug = runners[0].server.debug_port
        with urllib.request.urlopen(f"http://127.0.0.1:{debug}/debug/cluster", timeout=5) as resp:
            doc = json.loads(resp.read())
        assert doc["role"] == "router" and doc["map_epoch"] == 1 and len(doc["partitions"]) == 2
        with urllib.request.urlopen(f"http://127.0.0.1:{runners[0].server.http_port}/healthcheck", timeout=5) as resp:
            assert resp.read() == b"OK"
    finally:
        for r in runners:
            r.stop()
        port_time.install_process_time_source(RealTimeSource())
        for o in owners:
            o.close()


def test_runner_failover_probe(tmp_path):
    """A cuda-sidecar Runner whose SIDECAR_ADDRS primary is dark boots on
    its standby, serves, and /healthcheck names the failover (the
    degraded probe), as the JAX runner's does."""
    from api_ratelimit_tpu_torch import runner as port_runner

    live = str(tmp_path / "s.sock")
    engine = _port_engine()
    server = port_sidecar.SlabSidecarServer(live, engine)
    (tmp_path / "r").mkdir()
    runner = port_runner.Runner(_runner_settings(
        tmp_path / "r", backend_type="cuda-sidecar", sidecar_socket=str(tmp_path / "p.sock"),
        sidecar_addrs=f"{tmp_path / 'p.sock'},{live}",
    ), device="cpu")
    try:
        runner.run_background()
        assert runner.wait_ready(10.0)
        assert runner.cache.engine.active_address == live
        with urllib.request.urlopen(f"http://127.0.0.1:{runner.server.http_port}/healthcheck", timeout=5) as resp:
            body = resp.read().decode()
        assert "sidecar.failover: serving from standby" in body
    finally:
        runner.stop()
        server.close()
