"""The port's warm-restart persistence (api_ratelimit_tpu_torch/persist/) on
the CPU, against the JAX package's.

* File bytes: for the same uint32 table, created_at, shard, ways (and
  partition stamp, and section flags) both packages' write_snapshot and
  pack_table_bytes give identical bytes, and every pure-numpy helper
  (reconcile, migration, merge, histogram, the lease and federation
  section rules) the same answer.
* The JAX package's tests/test_persist.py TestSnapshotFormat,
  TestReconcile, TestSnapshotter, TestSnapshotFaultInjection and
  TestSetMigration, case by case, on the port's modules and the port's
  CPU engine and the port's fault injector (testing/faults.py).
  TestShardedSnapshot waits
  for the multi-device engine, and the inspect CLI for the tools.
* JAX to port and port to JAX: a snapshot of a four-algorithm stream
  written by one package's SlabSnapshotter restores into the other's
  engine bit for bit, and the next batches give the same counters and
  table bytes on both; v1 files and v2 files written under other ways
  migrate identically in both packages.
* persist/snapshot.py imports without torch.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from api_ratelimit_tpu.backends.tpu import SlabDeviceEngine as JaxEngine  # noqa: E402
from api_ratelimit_tpu.persist import snapshot as jax_snap  # noqa: E402
from api_ratelimit_tpu.persist import snapshotter as jax_snapshotter  # noqa: E402
from api_ratelimit_tpu_torch.testing.faults import FaultInjector, parse_fault_spec  # noqa: E402
from api_ratelimit_tpu.utils import FakeTimeSource as JaxClock  # noqa: E402
from api_ratelimit_tpu_torch.backends.cuda import SlabDeviceEngine, _Item, _items_to_block  # noqa: E402
from api_ratelimit_tpu_torch.limiter.cache import CacheError  # noqa: E402
from api_ratelimit_tpu_torch.ops import slab as port_slab  # noqa: E402
from api_ratelimit_tpu_torch.persist import snapshot as port_snap  # noqa: E402
from api_ratelimit_tpu_torch.persist.snapshot import (  # noqa: E402
    HEADER_SIZE,
    MAGIC,
    SNAPSHOT_VERSION,
    SnapshotError,
    load_snapshot,
    migrate_rows_to_sets,
    read_header,
    reconcile_rows,
    set_occupancy_histogram,
    write_snapshot,
)
from api_ratelimit_tpu_torch.persist.snapshotter import SlabSnapshotter, snapshot_paths  # noqa: E402
from api_ratelimit_tpu_torch.stats import Store, TestSink  # noqa: E402
from api_ratelimit_tpu_torch.utils import FakeTimeSource  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOW = 1_700_000_000


def _table(n=64, rows=()):
    """A slab table with the given (slot, fp_lo, count, window, expire,
    divider) rows planted."""
    t = np.zeros((n, 8), dtype=np.uint32)
    for slot, fp_lo, count, window, expire, divider in rows:
        t[slot] = [fp_lo, fp_lo ^ 0xABCD, count, window, expire, divider, 0, 0]
    return t


def _row(slot, count=3, window=NOW - (NOW % 60), expire=NOW + 90, divider=60):
    return (slot, 0x1111 + slot, count, window, expire, divider)


def _engine(ts, n_slots=1 << 10, ways=0, buckets=(128,)):
    return SlabDeviceEngine(ts, n_slots=n_slots, ways=ways, buckets=buckets, device="cpu")


def _hit(engine, fp=0xBEEF, n=1, limit=10, divider=1000):
    block = _items_to_block([_Item(fp=fp, hits=1, limit=limit, divider=divider, jitter=0)] * n)
    return engine.submit_rows(block).tolist()


def _snapshotter(eng, tmp_path, ts, **kw):
    return SlabSnapshotter(eng, str(tmp_path), interval_ms=1000, time_source=ts, **kw)


# -- the two packages' file bytes and pure helpers ---------------------------


def _random_table(rng, n=256, live=0.6, algos=True):
    """A slab table of random rows around NOW: live, expired and
    window-ended, of every algorithm, some sliding rows in their grace."""
    t = np.zeros((n, 8), np.uint32)
    occupied = rng.random(n) < live
    k = int(occupied.sum())
    t[occupied, 0] = rng.integers(1, 2**32, k, dtype=np.uint64)
    t[occupied, 1] = rng.integers(0, 2**32, k, dtype=np.uint64)
    t[occupied, 2] = rng.integers(0, 200, k)
    div = rng.choice([1, 60, 3600], k)
    t[occupied, 3] = NOW - rng.integers(0, 2 * 3600, k)
    t[occupied, 4] = NOW + rng.integers(-100, 4000, k)
    algo = rng.integers(0, 4, k) if algos else np.zeros(k, np.int64)
    t[occupied, 5] = div | (algo << 28)
    t[occupied, 6] = rng.integers(0, 50, k)
    return t


WRITE_CASES = {
    "v2_ways_128": dict(ways=128),
    "v2_ways_4_shard_2_of_4": dict(ways=4, shard_index=2, shard_count=4),
    "v1": dict(version=1),
    "partition_stamp": dict(ways=128, partition=(3, 1024, 2048, 64)),
    "lease_section": dict(flags=jax_snap.FLAG_LEASE_TABLE),
    "fed_section": dict(flags=jax_snap.FLAG_FED),
    "victim_section": dict(flags=jax_snap.FLAG_VICTIM),
}


@pytest.mark.parametrize("case", list(WRITE_CASES))
def test_write_snapshot_bytes_equal_the_reference(tmp_path, case):
    table = _random_table(np.random.default_rng(len(case)))
    kw = WRITE_CASES[case]
    want, got = tmp_path / "jax.snap", tmp_path / "port.snap"
    n_want = jax_snap.write_snapshot(str(want), table, created_at=NOW, **kw)
    n_got = port_snap.write_snapshot(str(got), table, created_at=NOW, **kw)
    assert n_got == n_want
    assert got.read_bytes() == want.read_bytes()
    assert port_snap.pack_table_bytes(table, NOW, **kw) == jax_snap.pack_table_bytes(table, NOW, **kw)
    header, rows, end = port_snap.unpack_table_bytes(want.read_bytes(), what="jax file")
    assert header == port_snap.read_header(str(want)) and end == len(want.read_bytes())
    assert np.array_equal(rows, table)


def _lease_rows(rng, n=40):
    t = np.zeros((n, 8), np.uint32)
    t[:, 0] = rng.integers(1, 2**32, n, dtype=np.uint64)
    t[:, 3] = rng.integers(0, 50, n)  # granted
    t[:, 4] = rng.integers(0, 50, n)  # settled / spent
    t[:, 5] = rng.integers(0, 300, n)
    t[:, 6] = NOW + rng.integers(-50, 50, n)
    t[:, 7] = NOW + rng.integers(-50, 50, n)
    return t


def _floors_input(rng, lease_rows):
    """A table holding some of the lease rows' (fp, window) keys."""
    table = _random_table(rng, n=128)
    for i, row in enumerate(lease_rows[::2]):
        table[i, 0], table[i, 1], table[i, 3] = row[0], row[1], row[2]
    return table


HELPERS = {
    "reconcile_rows": lambda m, rng: m.reconcile_rows(_random_table(rng), NOW),
    "migrate_rows_to_sets": lambda m, rng: m.migrate_rows_to_sets(_random_table(rng, live=0.9), 8),
    "migrate_overflow": lambda m, rng: m.migrate_rows_to_sets(_random_table(rng, n=64, live=1.0), 32),
    "merge_rows_into_table": lambda m, rng: m.merge_rows_into_table(
        _random_table(rng), np.vstack([_random_table(rng, n=64), _random_table(rng, n=64)[:8]]), 4
    ),
    "set_occupancy_histogram": lambda m, rng: m.set_occupancy_histogram(_random_table(rng), 16, now=NOW),
    "row_algorithms": lambda m, rng: m.row_algorithms(_random_table(rng)),
    "reconcile_leases": lambda m, rng: m.reconcile_leases(_lease_rows(rng), NOW),
    "apply_lease_floors": lambda m, rng: _floors(m.apply_lease_floors, rng),
    "reconcile_fed_shares": lambda m, rng: m.reconcile_fed_shares(_lease_rows(rng), NOW),
    "apply_fed_floors": lambda m, rng: _floors(m.apply_fed_floors, rng),
}


def _floors(fn, rng):
    rows = _lease_rows(rng)
    table = _floors_input(rng, rows)
    counts = fn([table], rows)
    return counts, table


def _flat(x):
    if isinstance(x, tuple):
        return tuple(_flat(v) for v in x)
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    return x


@pytest.mark.parametrize("helper", list(HELPERS))
@pytest.mark.parametrize("seed", [0, 1])
def test_helpers_answer_as_the_reference(helper, seed):
    got = HELPERS[helper](port_snap, np.random.default_rng(seed))
    want = HELPERS[helper](jax_snap, np.random.default_rng(seed))
    assert _flat(got) == _flat(want)


def test_column_constants_mirror_ops_slab():
    """persist redeclares the row format so offline tools skip the torch
    import; the mirror must never drift from the port's device layout, nor
    from the reference's."""
    assert port_snap.ROW_WIDTH == port_slab.ROW_WIDTH
    for col in ("COL_FP_LO", "COL_FP_HI", "COL_COUNT", "COL_WINDOW", "COL_EXPIRE", "COL_DIVIDER"):
        assert getattr(port_snap, col) == getattr(port_slab, col), col
    assert port_snap.ALGO_SHIFT == port_slab.ALGO_SHIFT
    assert port_snap.ALGO_DIV_MASK == port_slab.ALGO_DIV_MASK
    assert port_snap.ALGO_SLIDING_WINDOW == port_slab.ALGO_SLIDING_WINDOW
    for name in dir(jax_snap):
        if name.isupper() and not name.startswith("_"):
            assert getattr(port_snap, name) == getattr(jax_snap, name), name


def test_snapshot_module_imports_without_torch():
    """Offline tools read snapshots on boxes without torch: the format
    module (and the persist package under it) must not pull torch in."""
    code = (
        "import sys; sys.modules['torch'] = None; "
        "import api_ratelimit_tpu_torch.persist.snapshot, api_ratelimit_tpu_torch.persist; "
        "assert sys.modules['torch'] is None; print('ok')"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


# -- tests/test_persist.py on the port ----------------------------------------


class TestSnapshotFormat:
    def test_round_trip(self, tmp_path):
        table = _table(rows=[_row(3), _row(17, count=9)])
        path = str(tmp_path / "slab.snap")
        n = write_snapshot(path, table, created_at=NOW, shard_index=2, shard_count=4)
        assert n == os.path.getsize(path) == HEADER_SIZE + table.nbytes
        header, got = load_snapshot(path)
        assert (header.version, header.created_at) == (SNAPSHOT_VERSION, NOW)
        assert (header.shard_index, header.shard_count) == (2, 4)
        assert (header.n_slots, header.row_width) == (64, 8)
        np.testing.assert_array_equal(got, table)

    def test_read_header_only(self, tmp_path):
        path = str(tmp_path / "slab.snap")
        write_snapshot(path, _table(), created_at=NOW)
        header = read_header(path)
        assert header.n_slots == 64
        assert header.payload_len == 64 * 8 * 4

    def test_atomic_write_leaves_no_temp(self, tmp_path):
        path = str(tmp_path / "slab.snap")
        write_snapshot(path, _table(), created_at=NOW)
        write_snapshot(path, _table(rows=[_row(1)]), created_at=NOW + 1)
        assert sorted(os.listdir(tmp_path)) == ["slab.snap"]
        assert read_header(path).created_at == NOW + 1

    def test_bad_magic_rejected(self, tmp_path):
        path = str(tmp_path / "slab.snap")
        write_snapshot(path, _table(), created_at=NOW)
        raw = bytearray(open(path, "rb").read())
        raw[:8] = b"NOTASNAP"
        open(path, "wb").write(bytes(raw))
        with pytest.raises(SnapshotError, match="magic"):
            load_snapshot(path)

    def test_version_mismatch_rejected(self, tmp_path):
        import struct
        import zlib

        path = str(tmp_path / "slab.snap")
        write_snapshot(path, _table(), created_at=NOW)
        raw = bytearray(open(path, "rb").read())
        raw[8] = 99  # version field
        # re-stamp the header CRC so ONLY the version check can fire
        raw[56:60] = struct.pack("<I", zlib.crc32(bytes(raw[:56])))
        open(path, "wb").write(bytes(raw))
        with pytest.raises(SnapshotError, match="version 99"):
            load_snapshot(path)

    def test_header_corruption_rejected(self, tmp_path):
        path = str(tmp_path / "slab.snap")
        write_snapshot(path, _table(), created_at=NOW)
        raw = bytearray(open(path, "rb").read())
        raw[20] ^= 0xFF  # inside created_at
        open(path, "wb").write(bytes(raw))
        with pytest.raises(SnapshotError, match="header CRC"):
            load_snapshot(path)

    def test_payload_corruption_rejected(self, tmp_path):
        path = str(tmp_path / "slab.snap")
        write_snapshot(path, _table(rows=[_row(5)]), created_at=NOW)
        raw = bytearray(open(path, "rb").read())
        raw[HEADER_SIZE + 40] ^= 0x01
        open(path, "wb").write(bytes(raw))
        with pytest.raises(SnapshotError, match="payload CRC"):
            load_snapshot(path)

    def test_torn_payload_rejected(self, tmp_path):
        path = str(tmp_path / "slab.snap")
        write_snapshot(path, _table(), created_at=NOW)
        raw = open(path, "rb").read()
        open(path, "wb").write(raw[: len(raw) // 2])
        with pytest.raises(SnapshotError, match="torn"):
            load_snapshot(path)

    def test_truncated_header_rejected(self, tmp_path):
        path = str(tmp_path / "slab.snap")
        open(path, "wb").write(MAGIC)
        with pytest.raises(SnapshotError, match="truncated header"):
            load_snapshot(path)

    def test_missing_file_raises_snapshot_error(self, tmp_path):
        with pytest.raises(SnapshotError):
            load_snapshot(str(tmp_path / "nope.snap"))


class TestReconcile:
    def test_live_row_inside_window_kept(self):
        table = _table(rows=[_row(3, count=7)])
        out, stats = reconcile_rows(table, NOW)
        assert stats == {"restored": 1, "dropped_expired": 0, "dropped_window": 0}
        np.testing.assert_array_equal(out, table)

    def test_expired_row_dropped(self):
        out, stats = reconcile_rows(_table(rows=[_row(3, expire=NOW - 1)]), NOW)
        assert stats["dropped_expired"] == 1 and stats["restored"] == 0
        assert not out.any()

    def test_window_ended_but_ttl_pinned_dropped(self):
        table = _table(rows=[_row(3, window=NOW - 120, expire=NOW + 200)])
        out, stats = reconcile_rows(table, NOW)
        assert stats["dropped_window"] == 1 and stats["restored"] == 0
        assert not out.any()

    def test_legacy_divider_zero_keeps_ttl_rule(self):
        _out, stats = reconcile_rows(_table(rows=[_row(3, window=NOW - 120, divider=0)]), NOW)
        assert stats["restored"] == 1  # TTL-only rule for pre-divider rows

    def test_empty_rows_not_counted(self):
        out, stats = reconcile_rows(_table(), NOW)
        assert stats == {"restored": 0, "dropped_expired": 0, "dropped_window": 0}
        assert not out.any()

    def test_sliding_rows_keep_one_window_of_grace(self):
        sliding = 60 | (port_snap.ALGO_SLIDING_WINDOW << port_snap.ALGO_SHIFT)
        table = _table(rows=[_row(3, window=NOW - 90, expire=NOW + 200, divider=sliding)])
        _out, stats = reconcile_rows(table, NOW)
        assert stats["restored"] == 1  # fixed would drop it: window + 60 <= now


class TestSnapshotter:
    def test_snapshot_restore_round_trip(self, tmp_path):
        ts = FakeTimeSource(NOW)
        eng = _engine(ts)
        _hit(eng, n=4)
        snap = _snapshotter(eng, tmp_path, ts)
        assert snap.snapshot_once() > 0
        assert snap.writes_total == 1
        assert os.path.exists(tmp_path / "slab.snap")

        eng2 = _engine(ts)
        stats = _snapshotter(eng2, tmp_path, ts).restore()
        assert stats["restored"] == 1  # one live slot row
        assert _hit(eng2) == [5]  # counter continues where eng left it

    def test_no_snapshot_boots_cold(self, tmp_path):
        ts = FakeTimeSource(NOW)
        snap = _snapshotter(_engine(ts), tmp_path, ts)
        assert snap.restore() == {"restored": False, "reason": "no snapshot"}
        assert snap.load_rejected_total == 0  # absence is not corruption

    def test_topology_mismatch_boots_cold(self, tmp_path):
        ts = FakeTimeSource(NOW)
        eng = _engine(ts, n_slots=1 << 10)
        _hit(eng, n=3)
        _snapshotter(eng, tmp_path, ts).snapshot_once()
        small = _engine(ts, n_slots=1 << 9)
        snap = _snapshotter(small, tmp_path, ts)
        assert snap.restore()["restored"] is False
        assert snap.load_rejected_total == 1
        assert _hit(small) == [1]  # cold

    def test_corrupt_snapshot_boots_cold(self, tmp_path):
        ts = FakeTimeSource(NOW)
        eng = _engine(ts)
        _hit(eng, n=3)
        _snapshotter(eng, tmp_path, ts).snapshot_once()
        path = tmp_path / "slab.snap"
        raw = bytearray(path.read_bytes())
        raw[HEADER_SIZE + 8] ^= 0xFF
        path.write_bytes(bytes(raw))
        eng2 = _engine(ts)
        snap2 = _snapshotter(eng2, tmp_path, ts)
        assert snap2.restore()["restored"] is False
        assert snap2.load_rejected_total == 1
        assert _hit(eng2) == [1]

    def test_restore_reconciles_against_clock(self, tmp_path):
        ts = FakeTimeSource(NOW)
        eng = _engine(ts)
        _hit(eng, n=4, divider=1000)
        _snapshotter(eng, tmp_path, ts).snapshot_once()
        ts2 = FakeTimeSource(NOW + 5000)  # the window and TTL are long gone
        eng2 = _engine(ts2)
        stats = _snapshotter(eng2, tmp_path, ts2).restore()
        assert "reason" not in stats  # loaded, but reconciled away
        assert stats["restored"] == 0 and stats["dropped_expired"] == 1
        assert _hit(eng2) == [1]

    def test_drain_takes_final_snapshot(self, tmp_path):
        ts = FakeTimeSource(NOW)
        eng = _engine(ts)
        _hit(eng, n=2)
        snap = SlabSnapshotter(eng, str(tmp_path), interval_ms=60_000, time_source=ts)
        assert snap.drain() > 0
        assert snap.writes_total == 1
        with pytest.raises(CacheError):  # the engine is quiesced
            _hit(eng)
        eng2 = _engine(ts)
        _snapshotter(eng2, tmp_path, ts).restore()
        assert _hit(eng2) == [3]

    def test_periodic_thread_writes(self, tmp_path):
        ts = FakeTimeSource(NOW)
        eng = _engine(ts)
        _hit(eng)
        snap = SlabSnapshotter(eng, str(tmp_path), interval_ms=20, time_source=ts)
        snap.start()
        try:
            deadline = time.monotonic() + 5.0
            while snap.writes_total < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            snap.stop()
        assert snap.writes_total >= 2
        assert os.path.exists(tmp_path / "slab.snap")

    def test_stats_and_age(self, tmp_path):
        ts = FakeTimeSource(NOW)
        store = Store(TestSink())
        eng = _engine(ts)
        _hit(eng, n=2)
        snap = SlabSnapshotter(
            eng, str(tmp_path), interval_ms=1000, stale_after_ms=5000, time_source=ts, scope=store.scope("ratelimit")
        )
        assert snap.age_seconds() == -1.0  # never started, never succeeded
        assert snap.stale_reason() is None
        snap.snapshot_once()
        gauges = store.metrics_snapshot()["gauges"]
        counters = store.metrics_snapshot()["counters"]
        assert counters["ratelimit.snapshot.writes"] == 1
        assert gauges["ratelimit.snapshot.bytes"] > 0
        ts.advance(3)
        store.flush()  # runs the age generator
        assert store.metrics_snapshot()["gauges"]["ratelimit.snapshot.age_seconds"] == 3
        assert snap.stale_reason() is None
        ts.advance(10)  # past the 5s staleness budget
        reason = snap.stale_reason()
        assert reason is not None and "stale" in reason

        eng2 = _engine(ts)
        store2 = Store(TestSink())
        SlabSnapshotter(eng2, str(tmp_path), interval_ms=1000, time_source=ts, scope=store2.scope("ratelimit")).restore()
        g2 = store2.metrics_snapshot()["gauges"]
        assert g2["ratelimit.snapshot.restore_rows"] == 1
        assert g2["ratelimit.snapshot.restore_dropped_expired"] == 0

    def test_stats_names_equal_the_reference(self, tmp_path):
        """The snapshot.* counters, gauges and histogram the port registers
        are the reference's, with the same values after one write and one
        restore of the same table."""
        from api_ratelimit_tpu.stats import Store as JaxStore
        from api_ratelimit_tpu.stats import TestSink as JaxSink

        snaps = {}
        for name, Eng, Snapper, St, Sink, Clock, kw in (
            ("port", SlabDeviceEngine, SlabSnapshotter, Store, TestSink, FakeTimeSource, {"device": "cpu"}),
            ("jax", JaxEngine, jax_snapshotter.SlabSnapshotter, JaxStore, JaxSink, JaxClock, {"use_pallas": False}),
        ):
            ts = Clock(NOW)
            store = St(Sink())
            eng = Eng(ts, n_slots=1 << 10, ways=4, buckets=(128,), **kw)
            eng.submit_rows(_items_to_block([_Item(fp=7, hits=1, limit=9, divider=60, jitter=0)] * 3))
            d = tmp_path / name
            Snapper(eng, str(d), interval_ms=1000, time_source=ts, scope=store.scope("ratelimit")).snapshot_once()
            Snapper(eng, str(d), interval_ms=1000, time_source=ts, scope=store.scope("ratelimit")).restore()
            snap = store.metrics_snapshot()
            snaps[name] = {
                kind: {k: v for k, v in snap[kind].items() if ".snapshot." in k and not k.endswith("write_ms")}
                for kind in ("counters", "gauges")
            }
            snaps[name]["names"] = sorted(k for kind in snap.values() if isinstance(kind, dict) for k in kind if ".snapshot." in k)
        assert snaps["port"] == snaps["jax"]

    def test_snapshot_under_concurrent_traffic(self, tmp_path):
        """Submits from several threads while a snapshot loop runs flat
        out: no crash, no lost increment, and the file left is valid."""
        ts = FakeTimeSource(NOW)
        eng = _engine(ts)
        snap = SlabSnapshotter(eng, str(tmp_path), interval_ms=60_000, time_source=ts)
        n_threads, per = 4, 50
        stop = threading.Event()

        def worker():
            for _ in range(per):
                _hit(eng)

        def snapper():
            while not stop.is_set():
                snap.snapshot_once()

        snapper_t = threading.Thread(target=snapper)
        workers = [threading.Thread(target=worker) for _ in range(n_threads)]
        snapper_t.start()
        for t in workers:
            t.start()
        for t in workers:
            t.join()
        stop.set()
        snapper_t.join()
        assert snap.writes_total > 0 and snap.write_errors_total == 0
        assert _hit(eng) == [n_threads * per + 1]  # every increment counted
        _header, table = load_snapshot(str(tmp_path / "slab.snap"))
        assert table.any()

    def test_shard_file_names(self):
        assert snapshot_paths("d", 1) == [os.path.join("d", "slab.snap")]
        assert snapshot_paths("d", 2) == [os.path.join("d", "slab.00-of-02.snap"), os.path.join("d", "slab.01-of-02.snap")]
        assert snapshot_paths("d", 4) == jax_snapshotter.snapshot_paths("d", 4)

    @pytest.mark.parametrize(
        "section, item",
        [
            ("leases.snap", "8"),
            # federation, item 9b (the case keeps its id)
            pytest.param("fed.snap", "9b", id="fed.snap-9"),
            ("victim.snap", "6"),
        ],
    )
    def test_unported_section_warns_and_restores_the_slab(self, tmp_path, caplog, section, item):
        """A snapshot set from a reference deployment with leases,
        federation or the victim tier. fed.snap (item 9b, ported) into a
        snapshotter without a federation coordinator: ignored without a
        warning, the slab restoring alone with the reference's (zero)
        section counts, as the JAX snapshotter restores the same files.
        leases.snap (item 8's in-process
        half, ported): restored as the JAX snapshotter restores the same
        files, with its restore_stats, its floors and its registry.
        victim.snap (item 6, ported) into a tier-less engine: ignored
        without a warning, as the reference's tier-less engine ignores it."""
        ts = FakeTimeSource(NOW)
        eng = _engine(ts)
        _hit(eng, n=3)
        _snapshotter(eng, tmp_path, ts).snapshot_once()
        rows = _lease_rows(np.random.default_rng(0))
        if section == "leases.snap":
            # one live liability on the slab's own row, its floor (9) above
            # the restored count (3)
            rows[0] = (0xBEEF, 0, NOW - NOW % 1000, 8, 0, 9, NOW + 10, 0)
        write_snapshot(str(tmp_path / section), rows, created_at=NOW, flags=1)
        eng2 = _engine(ts)
        with caplog.at_level("WARNING", logger="ratelimit.persist"):
            stats = _snapshotter(eng2, tmp_path, ts).restore()
        warnings = [r.getMessage() for r in caplog.records if section in r.getMessage()]
        assert stats["restored"] == 1
        assert warnings == []
        if section == "fed.snap":
            for key in ("restored_leases", "restored_fed_shares", "restored_victim_rows"):
                assert stats[key] == 0
            jax_eng = JaxEngine(JaxClock(NOW), n_slots=1 << 10, buckets=(128,), use_pallas=False)
            jax_stats = jax_snapshotter.SlabSnapshotter(
                jax_eng, str(tmp_path), interval_ms=1000, time_source=JaxClock(NOW)
            ).restore()
            assert stats == jax_stats
            assert _hit(eng2) == [4]
            return
        if section == "victim.snap":
            assert eng2.victim_tier is None
            assert stats["restored_victim_rows"] == stats["dropped_victim_rows"] == 0
            assert _hit(eng2) == [4]
            return
        jax_eng = JaxEngine(JaxClock(NOW), n_slots=1 << 10, buckets=(128,), use_pallas=False)
        jax_stats = jax_snapshotter.SlabSnapshotter(
            jax_eng, str(tmp_path), interval_ms=1000, time_source=JaxClock(NOW)
        ).restore()
        assert stats == jax_stats and stats["restored_leases"] > 0
        assert np.array_equal(eng2.export_tables()[0], jax_eng.export_tables()[0])
        assert np.array_equal(eng2.lease_registry.export_rows(NOW), jax_eng.lease_registry.export_rows(NOW))
        assert _hit(eng2) == [10]  # floored at the liability's 9


class TestSnapshotFaultInjection:
    """The snapshot.write / snapshot.load sites, with the reference's
    FaultInjector: a fault-injected bad snapshot is rejected at load and
    the slab boots cold, counted."""

    def test_write_error_counted_not_fatal(self, tmp_path):
        ts = FakeTimeSource(NOW)
        eng = _engine(ts)
        _hit(eng)
        faults = FaultInjector.from_spec("snapshot.write:error:1.0")
        snap = _snapshotter(eng, tmp_path, ts, fault_injector=faults)
        assert snap.snapshot_once() == 0
        assert snap.write_errors_total == 1
        assert not os.path.exists(tmp_path / "slab.snap")
        faults.clear()
        assert snap.snapshot_once() > 0  # outage over, writes recover

    @pytest.mark.parametrize("kind", ["torn_write", "corrupt"])
    def test_bad_write_rejected_at_load(self, tmp_path, kind):
        ts = FakeTimeSource(NOW)
        eng = _engine(ts)
        _hit(eng, n=2)
        faults = FaultInjector.from_spec(f"snapshot.write:{kind}:1.0")
        _snapshotter(eng, tmp_path, ts, fault_injector=faults).snapshot_once()
        assert faults.fired().get(f"snapshot.write:{kind}") == 1
        eng2 = _engine(ts)
        snap2 = _snapshotter(eng2, tmp_path, ts)
        assert snap2.restore()["restored"] is False
        assert snap2.load_rejected_total == 1
        assert _hit(eng2) == [1]  # cold boot, service keeps working

    @pytest.mark.parametrize("spec", ["snapshot.load:error:1.0", "snapshot.load:corrupt:1.0"])
    def test_load_faults_reject_good_file(self, tmp_path, spec):
        ts = FakeTimeSource(NOW)
        eng = _engine(ts)
        _hit(eng, n=2)
        _snapshotter(eng, tmp_path, ts).snapshot_once()
        eng2 = _engine(ts)
        snap2 = _snapshotter(eng2, tmp_path, ts, fault_injector=FaultInjector.from_spec(spec))
        assert snap2.restore()["restored"] is False
        assert snap2.load_rejected_total == 1
        assert _hit(eng2) == [1]

    def test_fault_kinds_parse(self):
        rules = parse_fault_spec("snapshot.write:torn_write:0.5,snapshot.load:corrupt:1.0")
        assert [(r.site, r.kind) for r in rules] == [
            (port_snap.FAULT_SITE_WRITE, "torn_write"),
            (port_snap.FAULT_SITE_LOAD, "corrupt"),
        ]


class TestSetMigration:
    def test_migrate_places_rows_by_set_index(self):
        t = _table(rows=[(0, 0x13, 5, NOW - 30, NOW + 90, 60)])
        out, stats = migrate_rows_to_sets(t, ways=8)
        assert stats == {"placed": 1, "dropped_overflow": 0}
        placed = np.flatnonzero(out.any(axis=1))
        assert placed.tolist() == [(0x13 & 7) * 8]  # set 3, way 0
        np.testing.assert_array_equal(out[placed[0]], t[0])

    def test_overflowing_set_drops_lowest_counts(self):
        rows = [(slot, 0x10 * slot + 1, count, NOW - 30, NOW + 90, 60) for slot, count in zip(range(6), (4, 9, 1, 7, 2, 6))]
        out, stats = migrate_rows_to_sets(_table(n=8, rows=rows), ways=2)
        assert stats == {"placed": 2, "dropped_overflow": 4}
        assert sorted(out[out.any(axis=1)][:, 2].tolist()) == [7, 9]

    def test_set_occupancy_histogram(self):
        t = _table(
            n=16,
            rows=[(0, 1, 3, NOW - 30, NOW + 90, 60), (1, 2, 3, NOW - 30, NOW + 90, 60), (4, 3, 3, NOW - 30, NOW - 10, 60)],
        )
        assert set_occupancy_histogram(t, ways=4).tolist() == [2, 1, 1, 0, 0]
        assert set_occupancy_histogram(t, ways=4, now=NOW).tolist() == [3, 0, 1, 0, 0]

    def test_v1_snapshot_round_trips_through_boot_migration(self, tmp_path):
        """A v1 file (a row at its open-addressed probe slot, no ways stamp)
        restores through the migration with no live counter dropped."""
        ts = FakeTimeSource(NOW)
        eng = _engine(ts)  # 1024 slots, 4 ways on the CPU
        window = NOW - (NOW % 1000)
        table = np.zeros((1024, 8), dtype=np.uint32)
        table[0xBEEF % 1024] = [0xBEEF, 0, 4, window, NOW + 1000, 1000, 0, 0]
        write_snapshot(str(tmp_path / "slab.snap"), table, created_at=NOW, version=1)
        header = read_header(str(tmp_path / "slab.snap"))
        assert header.version == 1 and header.ways == 0
        stats = _snapshotter(eng, tmp_path, ts).restore()
        assert "reason" not in stats
        assert (stats["restored"], stats["migrated"], stats["dropped_overflow"]) == (1, 1, 0)
        assert _hit(eng) == [5]

    def test_v2_written_under_different_ways_rehashes(self, tmp_path):
        ts = FakeTimeSource(NOW)
        eng = _engine(ts, ways=32)
        _hit(eng, n=3)
        _snapshotter(eng, tmp_path, ts).snapshot_once()
        assert read_header(str(tmp_path / "slab.snap")).ways == 32
        eng2 = _engine(ts)  # 4 ways: the geometry changed
        stats = _snapshotter(eng2, tmp_path, ts).restore()
        assert stats["restored"] == 1 and stats["migrated"] == 1
        assert _hit(eng2) == [4]

    def test_same_geometry_restore_skips_rehash(self, tmp_path):
        ts = FakeTimeSource(NOW)
        eng = _engine(ts)
        _hit(eng, n=2)
        _snapshotter(eng, tmp_path, ts).snapshot_once()
        header = read_header(str(tmp_path / "slab.snap"))
        assert header.version == SNAPSHOT_VERSION and header.ways == eng.ways
        stats = _snapshotter(_engine(ts), tmp_path, ts).restore()
        assert stats["restored"] == 1 and stats["migrated"] == 0

    def test_restore_counts_set_overflow(self, tmp_path):
        ts = FakeTimeSource(NOW)
        eng = _engine(ts, n_slots=8, ways=4, buckets=(8,))
        window = NOW - (NOW % 1000)
        table = np.zeros((8, 8), dtype=np.uint32)
        for slot, (fp_lo, count) in enumerate([(2, 1), (4, 2), (6, 3), (8, 4), (10, 5), (12, 6)]):
            table[slot] = [fp_lo, 0, count, window, NOW + 1000, 1000, 0, 0]
        write_snapshot(str(tmp_path / "slab.snap"), table, created_at=NOW, version=1)
        stats = _snapshotter(eng, tmp_path, ts).restore()
        assert (stats["restored"], stats["migrated"], stats["dropped_overflow"]) == (6, 4, 2)
        assert _hit(eng, fp=12, divider=1000) == [7]
        assert _hit(eng, fp=2, divider=1000) == [1]


# -- across the packages ------------------------------------------------------

M32 = 0xFFFFFFFF


def _fmix32(x: int) -> int:
    x &= M32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


def _mixed_block(rng, n_keys: int, n: int) -> np.ndarray:
    """uint32[6, n] rows of all four algorithms (a key's algorithm its id
    mod 4, one concurrency item in four a release), 1-3 hits each."""
    keys = rng.integers(0, n_keys, n)
    rows = []
    for k in keys.tolist():
        algo = k % 4
        if algo == 3 and rng.random() < 0.25:
            algo = 4  # release
        div = (5, 30, 60)[k % 3]
        rows.append((_fmix32(k), (k + 1) << 8, int(rng.integers(1, 4)), 3 + k % 7, div | (algo << 28), k % 5))
    return np.array(rows, np.uint32).T.copy()


ENGINES = {
    "jax": lambda ts, **kw: JaxEngine(ts, use_pallas=False, **kw),
    "port": lambda ts, **kw: SlabDeviceEngine(ts, device="cpu", **kw),
}
SNAPSHOTTERS = {"jax": jax_snapshotter.SlabSnapshotter, "port": SlabSnapshotter}
CLOCKS = {"jax": JaxClock, "port": FakeTimeSource}
GEOMETRY = dict(n_slots=1 << 12, ways=4, buckets=(128,), gcra_burst_ratio=1.5)


@pytest.mark.parametrize("writer, reader", [("jax", "port"), ("port", "jax")], ids=["jax_to_port", "port_to_jax"])
def test_snapshot_restores_across_packages(tmp_path, writer, reader):
    """A four-algorithm stream through the writer's engine, a snapshot by
    its SlabSnapshotter, then a restore into a fresh engine of each
    package: the reconciled tables are bit-equal and equal to the reader's
    own restore, the guard flips on import, and the next 8 batches give the
    same counters and table bytes on both."""
    rng = np.random.default_rng(21)
    clock_w = CLOCKS[writer](NOW)
    src = ENGINES[writer](clock_w, **GEOMETRY)
    for _ in range(12):
        clock_w.advance(int(rng.integers(0, 9)))
        src.submit_rows(_mixed_block(rng, 600, 100))
    snap_dir = tmp_path / "snaps"
    assert SNAPSHOTTERS[writer](src, str(snap_dir), interval_ms=1000, time_source=clock_w).snapshot_once() > 0

    later = int(clock_w.unix_now()) + 7  # restart 7 s later: some rows reconcile away
    restored, stats = {}, {}
    for pkg in (writer, reader):
        clock = CLOCKS[pkg](later)
        eng = ENGINES[pkg](clock, **GEOMETRY)
        stats[pkg] = SNAPSHOTTERS[pkg](eng, str(snap_dir), interval_ms=1000, time_source=clock).restore()
        restored[pkg] = (eng, clock)
    assert stats[reader] == stats[writer]
    assert stats[reader]["restored"] > 0 and stats[reader]["dropped_window"] + stats[reader]["dropped_expired"] > 0
    tables = {pkg: np.asarray(e.export_tables()[0]) for pkg, (e, _c) in restored.items()}
    assert tables[reader].tobytes() == tables[writer].tobytes()
    assert restored["port"][0].algos_seen and restored["jax"][0]._algos_seen
    for step in range(8):
        block = _mixed_block(rng, 600, 100)
        adv = int(rng.integers(0, 9))
        afters = {}
        for pkg, (eng, clock) in restored.items():
            clock.advance(adv)
            afters[pkg] = np.asarray(eng.submit_rows(block)).tolist()
        assert afters["port"] == afters["jax"], step
    assert np.asarray(restored["port"][0].export_tables()[0]).tobytes() == np.asarray(restored["jax"][0].export_tables()[0]).tobytes()


@pytest.mark.parametrize("layout", ["v1", "v2_ways_32"])
def test_migration_is_identical_in_both_packages(tmp_path, layout):
    """A v1 file (rows at open-addressed slots) and a v2 file written under
    32 ways both restore into a 4-way engine of each package with the same
    stats and table bytes."""
    rng = np.random.default_rng(4)
    n = 1 << 10
    table = np.zeros((n, 8), np.uint32)
    window = NOW - (NOW % 60)
    for slot in rng.choice(n, 300, replace=False).tolist():
        fp_lo = _fmix32(slot + 1)
        table[slot] = [fp_lo, slot, int(rng.integers(1, 50)), window, NOW + 120, 60, 0, 0]
    kw = {"version": 1} if layout == "v1" else {"ways": 32}
    port_snap.write_snapshot(str(tmp_path / "slab.snap"), table, created_at=NOW, **kw)
    out = {}
    for pkg in ("jax", "port"):
        clock = CLOCKS[pkg](NOW)
        eng = ENGINES[pkg](clock, n_slots=n, ways=4, buckets=(128,))
        stats = SNAPSHOTTERS[pkg](eng, str(tmp_path), interval_ms=1000, time_source=clock).restore()
        out[pkg] = (stats, np.asarray(eng.export_tables()[0]).tobytes())
    assert out["port"] == out["jax"]
    assert out["port"][0]["migrated"] > 0 and out["port"][0]["dropped_overflow"] > 0
