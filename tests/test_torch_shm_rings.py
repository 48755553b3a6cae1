"""The port's shared-memory submit rings (api_ratelimit_tpu_torch/backends/
shm_ring.py) and the dispatch loop's cross-process half on the CPU, against
the JAX package's.

* The JAX package's tests/test_shm_rings.py runs on the port
  (reference_tests_on_the_port): round trips through the port's dispatch
  loop, verdict error codes, arena exhaustion, the arena-pressure
  telemetry, the SHM_RINGS=false rollback arm byte-identical to the shm
  arm, the SIGKILL of a frontend process mid-publish (the torn frame never
  launches, the dead ring is detached and its segment unlinked, the
  survivor sees no failure) and two frontend processes sharing one exact
  counter. The producer processes import the port's module, which loads no
  torch.
* A JAX ShmRingProducer publishes into a port ShmRingConsumer on one
  segment, and a port producer into a JAX consumer: the layout is the same
  byte for byte, so the verdicts come back equal.
* TestFrontendProcessFleet (slow, as in the JAX package): a cuda-sidecar
  master with two workers dials an owner this test serves in process on the
  CPU; the workers share one HTTP port, answer /json from the one slab, and
  SIGTERM tears the fleet down leaving no segment behind.
"""

import collections
import glob
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_victim import reference_tests_on_the_port  # noqa: E402

from api_ratelimit_tpu.backends import dispatch as jax_dispatch  # noqa: E402
from api_ratelimit_tpu.backends import shm_ring as jax_shm  # noqa: E402
from api_ratelimit_tpu_torch.backends import dispatch as port_dispatch  # noqa: E402
from api_ratelimit_tpu_torch.backends import shm_ring as port_shm  # noqa: E402

_REF = reference_tests_on_the_port(
    "test_shm_rings",
    (
        ("api_ratelimit_tpu_torch.backends.tpu", "api_ratelimit_tpu_torch.backends.cuda"),
        ("use_pallas=False", 'device="cpu"'),
    ),
)

shm_stack = _REF.shm_stack
TestShmRoundTrip = _REF.TestShmRoundTrip
TestArenaPressureTelemetry = _REF.TestArenaPressureTelemetry
TestByteIdenticalRollback = _REF.TestByteIdenticalRollback
TestChaosSigkillMidPublish = _REF.TestChaosSigkillMidPublish
TestMultiProcessEndToEnd = _REF.TestMultiProcessEndToEnd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _echo_loop(mod):
    """A dispatch loop of package `mod` whose launch answers each item's
    hits * 3 + its block's first fingerprint."""

    def launch(blocks):
        return [np.asarray(b[2], dtype=np.uint32) * 3 + b[0] for b in blocks]

    return mod.DispatchLoop(launch, lambda token: np.concatenate(token), window_seconds=0.001)


def _blocks(seed: int, count: int = 40):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(rng.integers(1, 50))
        b = np.zeros((6, n), dtype=np.uint32)
        b[0] = rng.integers(0, 1 << 20, n)
        b[2] = rng.integers(1, 1000, n)
        out.append(b)
    return out


@pytest.mark.parametrize(
    "producer_mod, consumer_pkg",
    [(jax_shm, "port"), (port_shm, "jax"), (port_shm, "port")],
    ids=["jax_producer_port_consumer", "port_producer_jax_consumer", "port_both"],
)
def test_cross_package_segment(producer_mod, consumer_pkg):
    """One segment, a producer of one package and a consumer of the other:
    the consumer's loop takes every frame and the producer reads back the
    verdicts the loop computed."""
    consumer_shm, dispatch = (port_shm, port_dispatch) if consumer_pkg == "port" else (jax_shm, jax_dispatch)
    loop = _echo_loop(dispatch)
    name = f"rlring_xpkg_{os.getpid()}_{os.urandom(3).hex()}"
    producer = producer_mod.ShmRingProducer(name, slots=16, arena_rows=256)
    try:
        consumer = consumer_shm.ShmRingConsumer(name)
        loop.attach_ring(consumer)
        for b in _blocks(5):
            idx, seq = producer.publish(b, b.shape[1])
            loop.kick()
            got = producer.redeem(idx, seq, timeout=10.0).tolist()
            assert got == (b[2] * 3 + b[0]).tolist()
        assert consumer.items_out == consumer.items_in == sum(b.shape[1] for b in _blocks(5))
    finally:
        loop.close()
        producer.close(unlink=True)
    assert not glob.glob(f"/dev/shm/{name}")


def test_ring_geometry_matches_the_reference():
    """The 768-byte header, 16-word slots and the uint32[7, rows] arena."""
    for slots, rows in ((16, 4096), (8, 64), (128, 1 << 12)):
        assert port_shm.ring_nbytes(slots, rows) == jax_shm.ring_nbytes(slots, rows)
    assert port_shm.ring_nbytes(16, 4096) == 768 + 16 * 128 + 7 * 4096 * 4


def test_trace_context_rides_the_slot_words():
    """A traced publish writes the span identity into the slot's four ctx
    words; the port loop's take rebuilds the SpanContext the batch span
    links to."""
    from api_ratelimit_tpu_torch import tracing

    seen = []

    def launch(blocks):
        return [np.asarray(b[2], dtype=np.uint32) for b in blocks]

    loop = port_dispatch.DispatchLoop(launch, lambda t: np.concatenate(t))
    orig_take = loop._take

    def take():
        frames, *rest = orig_take()
        seen.extend(ctx for _r, _c, _t, ctx in frames)
        return (frames, *rest)

    loop._take = take
    td = tempfile.mkdtemp()
    server = port_shm.ShmControlServer(loop, os.path.join(td, "ctl.sock"))
    client = port_shm.ShmRingClient(os.path.join(td, "ctl.sock"), arena_rows=64)
    tracer = tracing.RecordingTracer()
    try:
        span = tracer.start_span("request")
        with tracing.activate(span):
            assert client.submit(np.ones((6, 2), dtype=np.uint32)).tolist() == [1, 1]
        assert client.submit(np.ones((6, 1), dtype=np.uint32)).tolist() == [1]
        traced = [c for c in seen if c is not None]
        assert len(traced) == 1 and len(seen) == 2
        assert (traced[0].trace_id, traced[0].span_id) == (span.context.trace_id, span.context.span_id)
    finally:
        client.close()
        server.close()
        loop.close()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.mp
@pytest.mark.slow
class TestFrontendProcessFleet:
    def test_cuda_sidecar_fleet_serves_and_tears_down(self, tmp_path):
        """FRONTEND_PROCS=2 with BACKEND_TYPE=cuda-sidecar through the real
        entry point, against an owner served here on the CPU over shm rings:
        both workers share one HTTP port, /json counts exactly through the
        one slab, the fleet's /metrics merges three members, and SIGTERM
        tears the fleet down with no segment left."""
        from api_ratelimit_tpu_torch.backends.cuda import SlabDeviceEngine
        from api_ratelimit_tpu_torch.backends.sidecar import SlabSidecarServer
        from api_ratelimit_tpu_torch.utils.timeutil import RealTimeSource

        sock = str(tmp_path / "owner.sock")
        engine = SlabDeviceEngine(
            RealTimeSource(), n_slots=1 << 12, ways=4, buckets=(8, 128), device="cpu",
            batch_window_seconds=0.0005, max_batch=512, block_mode=True,
        )
        owner = SlabSidecarServer(sock, engine, shm_control_path=sock + ".shmctl")
        config_dir = tmp_path / "rt" / "rl" / "config"
        config_dir.mkdir(parents=True)
        (config_dir / "fleet.yaml").write_text(
            "domain: fleet\n"
            "descriptors:\n"
            "  - key: k\n"
            "    rate_limit: {unit: hour, requests_per_unit: 1000}\n"
        )
        http_port, grpc_port, debug_port = _free_port(), _free_port(), _free_port()
        env = dict(os.environ)
        env.update(
            {
                "FRONTEND_PROCS": "2",
                "BACKEND_TYPE": "cuda-sidecar",
                "RUNTIME_ROOT": str(tmp_path / "rt"),
                "RUNTIME_SUBDIRECTORY": "rl",
                "RUNTIME_WATCH_ROOT": "false",
                "USE_STATSD": "false",
                "LOG_LEVEL": "WARN",
                "PORT": str(http_port),
                "GRPC_PORT": str(grpc_port),
                "DEBUG_PORT": str(debug_port),
                "SIDECAR_SOCKET": sock,
            }
        )
        master = subprocess.Popen(
            [sys.executable, "-m", "api_ratelimit_tpu_torch.cmd.service_cmd"], env=env, cwd=REPO
        )
        body = json.dumps(
            {"domain": "fleet", "descriptors": [{"entries": [{"key": "k", "value": "v"}]}]}
        ).encode()

        def post():
            req = urllib.request.Request(
                f"http://localhost:{http_port}/json", data=body,
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=10) as r:
                return r.status, json.loads(r.read().decode())

        try:
            deadline = time.monotonic() + 120.0
            while True:
                try:
                    status, out = post()
                    break
                except (urllib.error.URLError, ConnectionError, OSError):
                    assert master.poll() is None, "fleet master died"
                    assert time.monotonic() < deadline, "fleet never served"
                    time.sleep(0.5)
            answers = [out["statuses"][0]["limitRemaining"]]
            for _ in range(30):
                status, out = post()
                assert status == 200, out
                answers.append(out["statuses"][0]["limitRemaining"])
            # one slab behind both workers: every call saw its own counter
            assert answers == sorted(answers, reverse=True)
            assert len(set(answers)) == len(answers)
            with urllib.request.urlopen(f"http://127.0.0.1:{debug_port}/metrics?fleet=1", timeout=10) as r:
                merged = r.read().decode()
            assert "ratelimit_native_available" in merged
            assert master.poll() is None
            # the ring producers: a segment is named rlring_<producer pid>_*
            workers = _children(master.pid)
            assert len(workers) == 2, workers
        finally:
            master.terminate()  # the master takes its workers down
            try:
                master.wait(60.0)
            except subprocess.TimeoutExpired:
                master.kill()
                master.wait()
            owner.close()
        assert master.returncode == 0
        left = [p for pid in workers for p in glob.glob(f"/dev/shm/rlring_{pid}_*")]
        assert not left, left


def _children(pid: int) -> list[int]:
    """The live child processes of pid (/proc)."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                if int(f.read().rsplit(")", 1)[1].split()[1]) == pid:
                    out.append(int(d))
        except (OSError, ValueError, IndexError):
            continue
    return out


@pytest.mark.parametrize("calls", [24, 43, 60])
def test_fleet_client_spreads_shared_keys_evenly(calls):
    """chip_smoke phase 13's eight load processes of 16 threads, each given
    its first thread's index: whatever number of calls every thread
    completes, each shared and each concurrency key gets the same number of
    calls, so the fewest any key gets is the mean, not a third of it."""
    from api_ratelimit_tpu_torch.tools.fleet_client import thread_stream

    shared, conc = collections.Counter(), collections.Counter()
    for proc in range(8):
        for t in range(16):
            stream = thread_stream((300 + proc) * 1000 + t, calls, 1 << 16, 8, 16, 16, offset=proc * 16 + t)
            for _, _, key in stream:
                if key is not None:
                    (shared if key[0] == "shared" else conc)[key[1]] += 1
    assert sorted(shared) == sorted(f"s{j}" for j in range(16))
    assert sorted(conc) == sorted(f"c{j}" for j in range(16))
    assert len(set(shared.values())) == 1 and len(set(conc.values())) == 1
    assert shared["s0"] == 128 * len(range(7, calls, 16)) // 16


@pytest.mark.mp
def test_fleet_client_load_is_exact_through_the_rings(tmp_path):
    """chip_smoke phase 13's load at a small size on the CPU: two
    tools/fleet_client.py processes drive a cuda-sidecar Runner whose owner
    this test serves over shm rings; every shared key admits exactly
    min(limit, calls), no call fails, and the owner's rings carried the
    frames."""
    from api_ratelimit_tpu_torch.backends.cuda import SlabDeviceEngine
    from api_ratelimit_tpu_torch.backends.sidecar import SlabSidecarServer
    from api_ratelimit_tpu_torch.runner import Runner
    from api_ratelimit_tpu_torch.settings import Settings
    from api_ratelimit_tpu_torch.stats.sinks import TestSink
    from api_ratelimit_tpu_torch.utils.timeutil import RealTimeSource

    limit = 3
    config_dir = tmp_path / "rt" / "rl" / "config"
    config_dir.mkdir(parents=True)
    (config_dir / "proc.yaml").write_text(
        "domain: proc\n"
        "descriptors:\n"
        "  - key: user\n    rate_limit: {unit: minute, requests_per_unit: 20}\n"
        "  - key: tenant\n    descriptors:\n      - key: path\n        rate_limit: {unit: hour, requests_per_unit: 400}\n"
        "  - key: ip\n    rate_limit: {unit: second, requests_per_unit: 10}\n"
        f"  - key: shared\n    rate_limit: {{unit: hour, requests_per_unit: {limit}}}\n"
    )
    sock = str(tmp_path / "owner.sock")
    engine = SlabDeviceEngine(
        RealTimeSource(), n_slots=1 << 12, ways=4, buckets=(8, 128), device="cpu",
        batch_window_seconds=0.0005, max_batch=512, block_mode=True,
    )
    owner = SlabSidecarServer(sock, engine, shm_control_path=sock + ".shmctl")
    runner = Runner(
        Settings(
            port=0, grpc_port=0, debug_port=0, use_statsd=False, runtime_path=str(tmp_path / "rt"),
            runtime_subdirectory="rl", backend_type="cuda-sidecar", sidecar_socket=sock, log_level="ERROR",
        ),
        sink=TestSink(),
    )
    runner.run_background()
    try:
        assert runner.wait_ready(10.0)
        outs = []
        procs = []
        for i in range(2):
            out = str(tmp_path / f"c{i}.json")
            outs.append(out)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "api_ratelimit_tpu_torch.tools.fleet_client", "--port",
                 str(runner.server.grpc_port), "--seconds", "2", "--threads", "3", "--seed", str(i + 1),
                 "--thread-offset", str(3 * i), "--shared-keys", "2", "--shared-every", "4", "--out", out],
                cwd=REPO, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
            ))
        for proc in procs:
            assert proc.wait(timeout=120) == 0
        shared, calls = {}, 0
        for out in outs:
            with open(out) as f:
                doc = json.load(f)
            assert doc["failures"] == []
            calls += doc["calls"]
            for key, (ok, over) in doc["shared"].items():
                got = shared.setdefault(key, [0, 0])
                got[0] += ok
                got[1] += over
        assert calls > 0 and set(shared) == {"shared:s0", "shared:s1"}
        for ok, over in shared.values():
            assert ok == min(limit, ok + over) and ok + over > limit
        rings = engine.dispatch_loop._ext_rings
        assert rings and sum(r.items_out for r in rings) > 0
    finally:
        runner.stop()
        runner.cache.close()
        owner.close()


def test_detach_after_close_leaves_the_ring_to_close(tmp_path):
    """C8: the control connection's EOF detaches its ring after the loop's
    owner thread exited, while close() tears the rings down. A ring
    close() already took and released is close()'s: the late detach skips
    it instead of reading its released header and closing its mapping a
    second time (the race failed test_dead_owner_raises_shm_unavailable
    now and then with EBADF, and raised in the control thread)."""
    from api_ratelimit_tpu_torch.backends.shm_ring import ShmControlServer, ShmRingClient

    loop = _REF._echo_loop()
    server = ShmControlServer(loop, str(tmp_path / "ctl.sock"))
    client = ShmRingClient(str(tmp_path / "ctl.sock"), arena_rows=64)
    try:
        assert client.submit(_REF._block([1])).tolist() == [1]
        (ring,) = loop._ext_rings
        loop.close()  # releases the ring
        loop.detach_rings([ring])  # the control thread's late EOF
        assert loop._ext_rings == [] and loop._detach_pending == []
    finally:
        server.close()
        client.close()
