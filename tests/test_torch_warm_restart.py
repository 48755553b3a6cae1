"""Warm restart on the port (tests/test_warm_restart.py's scenarios on the
port's CPU engine and Runner), plus the port's own contracts:

* crash restore: traffic with periodic snapshots, the engine abandoned
  without a drain, a fresh engine restores; against the exact oracle
  (testing/oracle.py parity_report) every disagreement fails open and the
  overshoot is at most one snapshot interval of traffic; a graceful drain
  loses nothing;
* the Runner: SLAB_SNAPSHOT_DIR restores before serving (after precompile,
  so the first served launch reads the restored rows), stop() writes the
  drain snapshot, and /healthcheck's body names a stale snapshot;
* a real SIGKILL: a subprocess owns a CPU engine and snapshots every 5
  batches; the next process restores within one interval of the truth;
* a restored slab holding sliding, GCRA or concurrency rows flips the
  engine's guard before the first launch, which runs the multi body;
* export_tables holds the state lock only for the device-side clone: while
  the host drain of the copy is held back, a submit_rows from another
  thread completes (the export stall this slice repairs).
"""

import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from api_ratelimit_tpu_torch.backends import cuda as cuda_mod  # noqa: E402
from api_ratelimit_tpu_torch.backends.cuda import SlabDeviceEngine, _Item, _items_to_block  # noqa: E402
from api_ratelimit_tpu_torch.persist.snapshot import write_snapshot  # noqa: E402
from api_ratelimit_tpu_torch.persist.snapshotter import SlabSnapshotter  # noqa: E402
from api_ratelimit_tpu_torch.testing.oracle import parity_report  # noqa: E402
from api_ratelimit_tpu_torch.utils import FakeTimeSource  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NOW = 1_700_000_000
N_KEYS = 16
LIMIT = 23
SNAP_EVERY = 5  # batches per "snapshot interval" in the simulated runs


def _engine(ts, **kw):
    return SlabDeviceEngine(ts, n_slots=1 << 12, buckets=(128,), device="cpu", **kw)


def _batch(engine):
    """One round: every key once, in key order; the per-key counters."""
    block = _items_to_block(
        [_Item(fp=5000 + k, hits=1, limit=LIMIT, divider=100_000, jitter=0) for k in range(N_KEYS)]
    )
    return engine.submit_rows(block).tolist()


def _codes(afters):
    """2 = OVER_LIMIT (after > limit), 1 = OK, as the decision rule."""
    return [2 if after > LIMIT else 1 for after in afters]


def _run_phase(engine, n_batches, ids, codes, snapshotter=None):
    for i in range(n_batches):
        afters = _batch(engine)
        ids.extend(range(N_KEYS))
        codes.extend(_codes(afters))
        if snapshotter is not None and (i + 1) % SNAP_EVERY == 0:
            snapshotter.snapshot_once()


class TestCrashRestoreOracle:
    def test_crash_overshoot_bounded_by_snapshot_interval(self, tmp_path):
        """23 batches, a snapshot after every 5th (the last at 20), a crash
        (batches 21-23 forgotten), a restore and 8 more batches: the engine
        fails open for exactly the 3 lost hits a key, within one interval,
        and never fails closed."""
        ts = FakeTimeSource(NOW)
        ids: list[int] = []
        codes: list[int] = []
        eng = _engine(ts)
        snap = SlabSnapshotter(eng, str(tmp_path), interval_ms=60_000, time_source=ts)
        _run_phase(eng, 23, ids, codes, snapshotter=snap)
        del eng  # kill -9 analog: no drain, no final snapshot

        eng2 = _engine(ts)
        snap2 = SlabSnapshotter(eng2, str(tmp_path), interval_ms=60_000, time_source=ts)
        assert snap2.restore()["restored"] == N_KEYS
        _run_phase(eng2, 8, ids, codes)
        report = parity_report(np.asarray(ids, dtype=np.int64), np.asarray(codes), LIMIT)
        assert report["false_over"] == 0
        assert 0 < report["false_ok"] <= SNAP_EVERY * N_KEYS
        assert _batch(eng2)[0] == 20 + 8 + 1  # warm, not cold

    def test_graceful_drain_is_lossless(self, tmp_path):
        ts = FakeTimeSource(NOW)
        ids: list[int] = []
        codes: list[int] = []
        eng = _engine(ts)
        snap = SlabSnapshotter(eng, str(tmp_path), interval_ms=60_000, time_source=ts)
        _run_phase(eng, 28, ids, codes, snapshotter=snap)  # the 28th unsnapped
        snap.drain()  # quiesce + final snapshot at batch 28
        eng2 = _engine(ts)
        snap2 = SlabSnapshotter(eng2, str(tmp_path), interval_ms=60_000, time_source=ts)
        assert snap2.restore()["restored"] == N_KEYS
        _run_phase(eng2, 5, ids, codes)
        report = parity_report(np.asarray(ids, dtype=np.int64), np.asarray(codes), LIMIT)
        assert report["false_over"] == 0
        assert report["false_ok"] == 0
        assert report["agreement"] == 1.0


BASIC = """\
domain: warm
descriptors:
  - key: api
    rate_limit: {unit: hour, requests_per_unit: 10}
"""


def _settings(tmp_path, snap_dir, **kw):
    from api_ratelimit_tpu_torch.settings import Settings

    config_dir = tmp_path / "current" / "ratelimit" / "config"
    if not config_dir.exists():
        config_dir.mkdir(parents=True)
        (config_dir / "warm.yaml").write_text(BASIC)
    return Settings(
        port=0,
        grpc_port=0,
        debug_port=0,
        use_statsd=False,
        runtime_path=str(tmp_path / "current"),
        runtime_subdirectory="ratelimit",
        backend_type="cuda",
        tpu_slab_slots=1 << 10,
        slab_ways=4,
        tpu_buckets="128",
        tpu_precompile=True,
        expiration_jitter_max_seconds=0,
        local_cache_size_in_bytes=0,
        slab_snapshot_dir=str(snap_dir),
        slab_snapshot_interval_ms=60_000.0,
        log_level="ERROR",
        **kw,
    )


def _request(hits):
    from api_ratelimit_tpu_torch.models.descriptors import Descriptor, RateLimitRequest

    return RateLimitRequest(domain="warm", descriptors=(Descriptor.of(("api", "user1")),), hits_addend=hits)


def _boot(settings):
    from api_ratelimit_tpu_torch.runner import Runner
    from api_ratelimit_tpu_torch.stats.sinks import TestSink

    runner = Runner(settings, sink=TestSink(), device="cpu")
    runner.run_background()
    assert runner.wait_ready(10.0)
    return runner


def _healthcheck(runner):
    conn = http.client.HTTPConnection("127.0.0.1", runner.server.http_port, timeout=30)
    try:
        conn.request("GET", "/healthcheck")
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


class TestRunnerWarmRestart:
    """SLAB_SNAPSHOT_DIR through the port's composition root."""

    def test_stop_snapshots_and_next_boot_restores(self, tmp_path):
        from api_ratelimit_tpu_torch.models.response import Code

        snap_dir = tmp_path / "snapshots"
        runner = _boot(_settings(tmp_path, snap_dir))
        assert runner.snapshotter is not None
        assert runner.cache.engine.precompiled  # the restore came after it
        assert runner.server.health.degraded_reasons() == []
        code, _statuses, _headers = runner.service.should_rate_limit(_request(hits=10))
        assert code == Code.OK  # 10/10 used
        runner.stop()  # drain handoff: writes the final snapshot
        assert (snap_dir / "slab.snap").exists()

        runner2 = _boot(_settings(tmp_path, snap_dir))
        try:
            assert runner2.snapshotter.restore_stats["restored"] == 1
            # the restored counter carries the 10 used hits: one more is OVER
            code, _statuses, _headers = runner2.service.should_rate_limit(_request(hits=1))
            assert code == Code.OVER_LIMIT
        finally:
            runner2.stop()

    def test_snapshot_disabled_by_default(self, tmp_path):
        settings = _settings(tmp_path, tmp_path / "unused")
        settings.slab_snapshot_dir = ""
        runner = _boot(settings)
        try:
            assert runner.snapshotter is None
        finally:
            runner.stop()
        assert not (tmp_path / "unused").exists()

    def test_healthcheck_names_a_stale_snapshot(self, tmp_path):
        """No snapshot within the stale window: /healthcheck stays 200 and
        its body carries the snapshotter's reason."""
        from api_ratelimit_tpu_torch.utils import RealTimeSource
        from api_ratelimit_tpu_torch.utils import timeutil

        clock = FakeTimeSource(NOW)
        timeutil.install_process_time_source(clock)
        try:
            runner = _boot(_settings(tmp_path, tmp_path / "snaps", slab_snapshot_stale_after_ms=120_000.0))
            try:
                assert _healthcheck(runner) == (200, "OK")
                clock.advance(121)
                status, body = _healthcheck(runner)
                assert status == 200 and "slab snapshots stale" in body, body
                assert runner.snapshotter.snapshot_once() > 0
                assert _healthcheck(runner) == (200, "OK")
            finally:
                runner.stop()
        finally:
            timeutil.install_process_time_source(RealTimeSource())

    def test_bad_snapshot_settings_refuse_the_boot(self, tmp_path):
        from api_ratelimit_tpu_torch.runner import Runner

        settings = _settings(tmp_path, tmp_path / "snaps", slab_snapshot_stale_after_ms=10.0)
        with pytest.raises(ValueError, match="SLAB_SNAPSHOT_STALE_AFTER_MS"):
            Runner(settings, device="cpu").run_background()


_CHILD = """\
import json, os, sys, time

sys.path.insert(0, {repo!r})

from api_ratelimit_tpu_torch.backends.cuda import SlabDeviceEngine, _Item, _items_to_block
from api_ratelimit_tpu_torch.persist.snapshotter import SlabSnapshotter
from api_ratelimit_tpu_torch.utils.timeutil import RealTimeSource

snap_dir, progress_path, phase = sys.argv[1], sys.argv[2], sys.argv[3]
engine = SlabDeviceEngine(RealTimeSource(), n_slots=1 << 12, buckets=(128,), device="cpu")
snap = SlabSnapshotter(engine, snap_dir, interval_ms=3_600_000.0)
restored = snap.restore()
BLOCK = _items_to_block(
    [_Item(fp=9000 + k, hits=1, limit=1_000_000, divider=1_000_000, jitter=0) for k in range(8)]
)


def batch():
    return engine.submit_rows(BLOCK).tolist()


if phase == "crash":
    with open(progress_path, "a") as f:
        for i in range(100_000):  # runs until SIGKILLed
            afters = batch()
            f.write(json.dumps([i, afters[0]]) + "\\n")
            f.flush()
            os.fsync(f.fileno())
            if (i + 1) % 5 == 0:
                snap.snapshot_once()
            time.sleep(0.01)
else:
    final = None
    for _ in range(20):
        final = batch()
    print(json.dumps({{"restored": restored, "final": final}}))
"""


class TestSigkillRestart:
    def test_kill9_midwindow_restores_with_bounded_loss(self, tmp_path):
        """The process that owns the engine is SIGKILLed mid-window; the
        next one restores from the last periodic snapshot (every 5 batches)
        and its counters land within one interval of the true traffic."""
        child_py = tmp_path / "child.py"
        child_py.write_text(_CHILD.format(repo=REPO))
        snap_dir = str(tmp_path / "snaps")
        progress = tmp_path / "progress.jsonl"
        progress.touch()
        proc = subprocess.Popen(
            [sys.executable, str(child_py), snap_dir, str(progress), "crash"],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        try:
            deadline = time.monotonic() + 120.0
            batches_seen = 0
            while time.monotonic() < deadline:
                batches_seen = len(progress.read_text().splitlines())
                if batches_seen >= 12:
                    break
                if proc.poll() is not None:
                    pytest.fail(f"child died early: {proc.stderr.read()[-2000:]}")
                time.sleep(0.05)
            assert batches_seen >= 12, "child too slow to make traffic"
            os.kill(proc.pid, signal.SIGKILL)
        finally:
            proc.wait(timeout=30)
            proc.stdout.close()
            proc.stderr.close()

        lines = progress.read_text().splitlines()
        b1 = len(lines)
        last_batch, last_after = json.loads(lines[-1])
        assert last_after == last_batch + 1
        out = subprocess.run(
            [sys.executable, str(child_py), snap_dir, str(progress), "restore"],
            capture_output=True,
            text=True,
            timeout=120,
        )
        assert out.returncode == 0, out.stderr[-2000:]
        result = json.loads(out.stdout)
        assert result["restored"]["restored"] == 8  # all 8 key rows warm
        finals = result["final"]
        assert len(set(finals)) == 1
        final = finals[0]
        assert final >= b1 + 20 - 5, (final, b1)  # at most one interval lost
        assert final <= b1 + 1 + 20, (final, b1)  # no traffic invented


@pytest.mark.parametrize("algo", [1, 2, 3], ids=["sliding_window", "gcra", "concurrency"])
def test_restored_algorithm_rows_flip_the_guard_before_the_first_launch(tmp_path, algo, monkeypatch):
    """A snapshot holding a non-fixed row restores into a precompiled
    all-fixed engine: the guard is up before any launch, and the first
    launch (a fixed-window item) runs the multi-algorithm body."""
    ts = FakeTimeSource(NOW)
    table = np.zeros((1 << 12, 8), np.uint32)
    table[0] = (4, 9, 2, NOW - 10, NOW + 500, 60 | (algo << 28), NOW + 20 if algo == 2 else 0, 0)
    write_snapshot(str(tmp_path / "slab.snap"), table, created_at=NOW, ways=4)
    eng = _engine(ts, ways=4, precompile=True)
    assert not eng.algos_seen
    stats = SlabSnapshotter(eng, str(tmp_path), interval_ms=1000, time_source=ts).restore()
    assert stats["restored"] == 1 and eng.algos_seen
    bodies = []
    real = cuda_mod.slab_step_after

    def spy(*a, **kw):
        bodies.append(kw["multi_algo"])
        return real(*a, **kw)

    monkeypatch.setattr(cuda_mod, "slab_step_after", spy)
    assert _batch(eng) == [1] * N_KEYS
    assert bodies == [True]
    assert np.array_equal(eng.export_tables()[0][0], table[0])


def test_first_launch_after_restore_reads_the_restored_table(tmp_path):
    """Precompile warms every shape, then the restore replaces the slab:
    the first served launch counts on from the restored rows, and the
    table the next export reads holds both."""
    ts = FakeTimeSource(NOW)
    eng = _engine(ts, precompile=True)
    for _ in range(3):
        _batch(eng)
    SlabSnapshotter(eng, str(tmp_path), interval_ms=1000, time_source=ts).snapshot_once()
    eng2 = _engine(ts, precompile=True)
    SlabSnapshotter(eng2, str(tmp_path), interval_ms=1000, time_source=ts).restore()
    assert _batch(eng2) == [4] * N_KEYS
    _batch(eng)
    assert np.array_equal(eng2.export_tables()[0], eng.export_tables()[0])


def test_export_holds_the_state_lock_only_for_the_clone(monkeypatch):
    """With the host drain of an export held back, another thread's
    submit_rows launches and completes: the lock covers the clone alone.
    The export then returns the table as it stood at the clone."""
    ts = FakeTimeSource(NOW)
    eng = _engine(ts)
    _batch(eng)
    before = eng.export_tables()[0].copy()
    draining, release = threading.Event(), threading.Event()
    real = cuda_mod.slab_export_host

    def held_drain(copy, ready):
        draining.set()
        assert release.wait(30)
        return real(copy, ready)

    monkeypatch.setattr(cuda_mod, "slab_export_host", held_drain)
    exported = []
    exporter = threading.Thread(target=lambda: exported.append(eng.export_tables()[0]))
    exporter.start()
    try:
        assert draining.wait(30)
        done = []
        submitter = threading.Thread(target=lambda: done.append(_batch(eng)))
        submitter.start()
        submitter.join(10)
        assert done == [[2] * N_KEYS]  # launched while the export drained
    finally:
        release.set()
        exporter.join(30)
    assert np.array_equal(exported[0], before)  # the clone predates it
    lock_ms, drain_ms = eng.export_times[-1]
    assert lock_ms >= 0 and drain_ms >= 0
    assert len(eng.export_times) == 2


def test_chip_smoke_warm_restart_phase_on_the_cpu(monkeypatch):
    """chip_smoke.py's warm restart phase, rehearsed on the CPU at a small
    size: the drain handoff byte-identical to the memory runner, the crash
    restore failing open within the lost hits, snapshots under traffic and
    the timed restore, and the redis oracle's responses equal to the cuda
    runner's."""
    import types

    import chip_smoke as CS
    from api_ratelimit_tpu_torch.backends import cuda as cuda_mod
    from api_ratelimit_tpu_torch.ops import slab_kernels as K

    for name, value in (
        ("WARM_CALLS", 96), ("CRASH_CALLS", 100), ("CRASH_EVERY", 32), ("CRASH_AFTER", 64),
        ("UNDER_THREADS", 3), ("UNDER_SNAPSHOTS", 2), ("UNDER_GAP_S", 0.05), ("UNDER_BATCH", 512),
        ("UNDER_KEYS", 4096), ("REDIS_CALLS", 96), ("PROCESS_CLOCK_EVERY", 32),
    ):
        monkeypatch.setattr(CS, name, value)
    monkeypatch.setattr(CS, "BUCKETS", (128, 1024))
    small = {"TPU_SLAB_SLOTS": 1 << 14, "SLAB_WAYS": 4, "TPU_BUCKETS": "128,1024"}
    out = CS.phase_warm_restart(types.SimpleNamespace(cuda_mod=cuda_mod), K, device="cpu", **small)
    handoff, crash, under, redis = out["handoff"], out["crash"], out["under_traffic"], out["redis"]
    assert handoff["snapshot_bytes"] == 60 + (1 << 14) * 32
    assert handoff["restore_stats"]["restored"] == handoff["live_rows"] > 0
    assert crash["last_snapshot_call"] == 96 and crash["lost_calls"] == 4 and crash["false_over"] == 0
    assert under["snapshots"] == 2 and len(under["lock_held_ms"]) == 2
    assert under["submit_rows_during_snapshot"]["n"] > 0 and under["restore"]["rows"] > 0
    assert redis["incrby"] == redis["descriptors"] and len(redis["codes"]) >= 2
