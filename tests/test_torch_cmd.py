"""The port's commands: config_check_cmd exits as the JAX package's does,
client_cmd talks to a port server, and service_cmd boots, serves and exits
0 on SIGTERM with the memory backend, refuses an unported knob, and with
BACKEND_TYPE=cuda and no card exits non-zero with the engine's error."""

import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")

from api_ratelimit_tpu.cmd import config_check_cmd as jax_check  # noqa: E402
from api_ratelimit_tpu_torch.cmd import client_cmd, config_check_cmd  # noqa: E402
from api_ratelimit_tpu_torch.runner import Runner  # noqa: E402
from api_ratelimit_tpu_torch.settings import Settings  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RULES = "domain: d\ndescriptors:\n  - key: k\n    rate_limit: {unit: minute, requests_per_unit: 1}\n"

CONFIG_DIRS = {
    "valid": {"ok.yaml": "domain: d\ndescriptors:\n  - key: k\n"},
    "unknown_field": {"bad.yaml": "domain: d\nunknown_field: 1\n"},
    "duplicate_domain": {"a.yaml": "domain: d\n", "b.yml": "domain: d\n"},
    "bad_unit": {"u.yaml": "domain: d\ndescriptors:\n  - key: k\n    rate_limit: {unit: fortnight, requests_per_unit: 1}\n"},
    "not_yaml_ignored": {"ok.yaml": "domain: d\n", "notes.txt": "domain: d\n"},
    "empty": {},
}


@pytest.mark.parametrize("case", list(CONFIG_DIRS))
def test_config_check_exit_codes_are_the_references(case, tmp_path, capsys):
    for name, text in CONFIG_DIRS[case].items():
        (tmp_path / name).write_text(text)
    want = jax_check.main(["-config_dir", str(tmp_path)])
    want_io = capsys.readouterr()
    got = config_check_cmd.main(["-config_dir", str(tmp_path)])
    got_io = capsys.readouterr()
    assert got == want
    assert (got_io.out, got_io.err) == (want_io.out, want_io.err)
    assert (got == 0) == (case in ("valid", "not_yaml_ignored", "empty"))


def test_parse_descriptor():
    d = client_cmd.parse_descriptor("database=users,tier=gold")
    assert [(e.key, e.value) for e in d.entries] == [("database", "users"), ("tier", "gold")]
    with pytest.raises(ValueError):
        client_cmd.parse_descriptor("noequals")


def _runtime(tmp_path):
    config = tmp_path / "rt" / "ratelimit" / "config"
    config.mkdir(parents=True)
    (config / "d.yaml").write_text(RULES)
    return str(tmp_path / "rt")


def test_client_cmd_against_a_port_server(tmp_path, capsys):
    settings = Settings(
        port=0, grpc_port=0, debug_port=0, use_statsd=False, runtime_path=_runtime(tmp_path),
        runtime_subdirectory="ratelimit", backend_type="memory", log_level="ERROR",
    )
    runner = Runner(settings, device="cpu")
    runner.run_background()
    try:
        dial = f"localhost:{runner.server.grpc_port}"
        args = ["-dial_string", dial, "-domain", "d", "-descriptors", "k=v"]
        assert client_cmd.main(args) == 0
        assert client_cmd.main(args) == 0
        out = capsys.readouterr().out.split("response:")
        assert "overall_code: OK" in out[1] and "overall_code: OVER_LIMIT" in out[2]
        assert client_cmd.main(["-dial_string", dial, "-domain", "", "-descriptors", "k=v"]) == 1
        assert "INTERNAL" in capsys.readouterr().err
    finally:
        runner.stop()


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _service_env(tmp_path, **extra):
    http, grpc_port, debug = _free_ports(3)
    env = dict(
        os.environ,
        PYTHONPATH=REPO,
        RUNTIME_ROOT=_runtime(tmp_path),
        RUNTIME_SUBDIRECTORY="ratelimit",
        USE_STATSD="false",
        PORT=str(http),
        GRPC_PORT=str(grpc_port),
        DEBUG_PORT=str(debug),
        LOG_LEVEL="ERROR",
    )
    env.update(extra)
    return env


def _service(env):
    return subprocess.Popen(
        [sys.executable, "-m", "api_ratelimit_tpu_torch.cmd.service_cmd"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


def test_service_cmd_serves_and_exits_0_on_sigterm(tmp_path):
    env = _service_env(tmp_path, BACKEND_TYPE="memory")
    proc = _service(env)
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{env['PORT']}/healthcheck", timeout=2) as r:
                    assert (r.status, r.read()) == (200, b"OK")
                break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None, proc.communicate()
                assert time.monotonic() < deadline, "service_cmd never became healthy"
                time.sleep(0.1)
        out = subprocess.run(
            [sys.executable, "-m", "api_ratelimit_tpu_torch.cmd.client_cmd", "-dial_string",
             f"localhost:{env['GRPC_PORT']}", "-domain", "d", "-descriptors", "k=v"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=60,
        )
        assert out.returncode == 0 and "overall_code: OK" in out.stdout, out.stderr
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_service_cmd_without_a_card_exits_nonzero(tmp_path):
    """BACKEND_TYPE=cuda (the default) with torch.cuda.is_available() false:
    the engine raises and the process exits non-zero; it never serves from
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the boot would succeed")
    proc = _service(_service_env(tmp_path))
    _out, err = proc.communicate(timeout=60)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is false" in err


def test_service_cmd_refuses_an_unported_knob(tmp_path):
    # federation (item 9b) is served now; the multi-device engine is not
    proc = _service(_service_env(tmp_path, BACKEND_TYPE="memory", TPU_MESH_DEVICES="4"))
    _out, err = proc.communicate(timeout=60)
    assert proc.returncode != 0
    assert "ROADMAP item 10" in err


def test_sidecar_cmd_without_a_card_exits_1(tmp_path):
    """The device owner has no CPU switch: without a card it exits 1."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the owner would boot")
    env = _service_env(tmp_path, SIDECAR_SOCKET=str(tmp_path / "owner.sock"))
    out = subprocess.run(
        [sys.executable, "-m", "api_ratelimit_tpu_torch.cmd.sidecar_cmd"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=60,
    )
    assert out.returncode == 1
    assert "torch.cuda.is_available() is false" in out.stderr
    assert not os.path.exists(tmp_path / "owner.sock")


def test_fleet_without_a_card_exits_nonzero(tmp_path):
    """FRONTEND_PROCS=2 with BACKEND_TYPE=cuda: the master spawns the owner
    first, and when the owner cannot hold the card the master exits
    non-zero before any worker starts."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the fleet would boot")
    env = _service_env(tmp_path, FRONTEND_PROCS="2", SIDECAR_SOCKET=str(tmp_path / "owner.sock"))
    proc = _service(env)
    _out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert "device owner exited with 1" in err
    assert "spawned frontend worker" not in err


def test_fleet_needs_a_card_backend(tmp_path):
    proc = _service(_service_env(tmp_path, BACKEND_TYPE="memory", FRONTEND_PROCS="2"))
    _out, err = proc.communicate(timeout=60)
    assert proc.returncode != 0
    assert "FRONTEND_PROCS=2 requires BACKEND_TYPE cuda or cuda-sidecar" in err


def test_fleet_restarts_a_killed_worker(tmp_path):
    """A cuda-sidecar master over an owner served here on the CPU: SIGKILL
    one worker, and the master spawns a new one on the same debug port
    while the owner detaches the dead worker's rings; SIGTERM then takes
    the fleet down with exit 0."""
    import glob
    import json

    from api_ratelimit_tpu_torch.backends.cuda import SlabDeviceEngine
    from api_ratelimit_tpu_torch.backends.sidecar import SlabSidecarServer
    from api_ratelimit_tpu_torch.utils.timeutil import RealTimeSource

    sock = str(tmp_path / "owner.sock")
    engine = SlabDeviceEngine(
        RealTimeSource(), n_slots=1 << 12, ways=4, buckets=(8, 128), device="cpu",
        batch_window_seconds=0.0005, max_batch=512, block_mode=True,
    )
    owner = SlabSidecarServer(sock, engine, shm_control_path=sock + ".shmctl")
    env = _service_env(
        tmp_path, BACKEND_TYPE="cuda-sidecar", FRONTEND_PROCS="2", SIDECAR_SOCKET=sock, LOG_LEVEL="WARN",
    )
    master = _service(env)
    debug = int(env["DEBUG_PORT"])

    def worker_pid(i):
        url = f"http://127.0.0.1:{debug + 1 + i}/debug/pprof/"
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status

    def post():
        body = json.dumps({"domain": "d", "descriptors": [{"entries": [{"key": "k", "value": "x"}]}]})
        req = urllib.request.Request(
            f"http://127.0.0.1:{env['PORT']}/json", data=body.encode(), headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                return r.status
        except urllib.error.HTTPError as e:  # 429 once over the limit
            return e.code

    def wait(cond, timeout=60.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                if cond():
                    return True
            except (urllib.error.URLError, ConnectionError, OSError):
                pass
            assert master.poll() is None, master.communicate()
            time.sleep(0.2)
        return False

    try:
        assert wait(lambda: worker_pid(0) == 200 and worker_pid(1) == 200)
        for _ in range(8):
            assert post() in (200, 429)
        loop = engine.dispatch_loop
        assert wait(lambda: len(loop._ext_rings) >= 1)
        out = subprocess.run(
            ["pgrep", "-f", "-P", str(master.pid), "api_ratelimit_tpu_torch.cmd.service_cmd"],
            capture_output=True, text=True,
        )
        pids = [int(p) for p in out.stdout.split()]
        assert len(pids) == 2
        os.kill(pids[0], signal.SIGKILL)
        # the master restarts it and the owner detaches its rings
        assert wait(lambda: len(subprocess.run(
            ["pgrep", "-P", str(master.pid)], capture_output=True, text=True
        ).stdout.split()) == 2 and pids[0] not in [
            int(p) for p in subprocess.run(["pgrep", "-P", str(master.pid)], capture_output=True, text=True).stdout.split()
        ])
        assert wait(lambda: worker_pid(0) == 200 and worker_pid(1) == 200)
        assert wait(lambda: not glob.glob(f"/dev/shm/rlring_{pids[0]}_*"))
        for _ in range(8):
            assert post() in (200, 429)
        master.send_signal(signal.SIGTERM)
        assert master.wait(timeout=60) == 0
    finally:
        if master.poll() is None:
            # SIGTERM takes the workers down with the master
            master.send_signal(signal.SIGTERM)
            try:
                master.wait(timeout=60)
            except subprocess.TimeoutExpired:
                master.kill()
                master.wait()
        owner.close()


def test_chip_smoke_fleet_helpers_on_the_cpu(tmp_path):
    """Phase 13's readers on synthetic inputs: the trace's busy share is the
    union of its device intervals over the capture and counts kernels by
    name; the process and connection readers see this process's children
    and sockets; the ring segments read are the named producers'; the
    exactness check takes min(limit, calls)."""
    import json

    import chip_smoke as CS

    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "void way_scan_kernel<false>(int)", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "Kernel", "name": "void way_scan_kernel<true>(int)", "ts": 50, "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 400, "dur": 100},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 0, "dur": 1000},
    ]}
    (tmp_path / "t.json").write_text(json.dumps(trace))
    busy, names = CS.trace_busy(str(tmp_path), 1.0)  # a 1 ms capture
    assert busy == pytest.approx(0.25)
    assert CS.named(names, "way_scan_kernel<true>") == 1 and CS.named(names, "way_scan_kernel") == 2

    child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(30)"])
    try:
        assert child.pid in CS.children(os.getpid())
        assert not CS.holds_card(child.pid)
    finally:
        child.kill()
        child.wait()
    server = socket.socket()
    server.bind(("127.0.0.1", 0))
    server.listen(4)
    port = server.getsockname()[1]
    client = socket.create_connection(("127.0.0.1", port))
    accepted, _ = server.accept()
    try:
        assert CS.tcp_conns(os.getpid(), port) == (1, 0)
    finally:
        for s in (client, accepted, server):
            s.close()

    seg = f"/dev/shm/rlring_{os.getpid()}_0_{os.urandom(3).hex()}"
    with open(seg, "wb"):
        pass
    try:  # a producer's segments only, not a pid that starts alike
        assert CS.ring_segments([os.getpid()]) == [os.path.basename(seg)]
        assert CS.ring_segments([os.getpid() // 10]) == []
    finally:
        os.remove(seg)

    import collections

    load = {"shared": collections.Counter({"k:0": 8, "k:1": 5}), "over": collections.Counter({"k:0": 4, "k:1": 0})}
    assert CS.shared_exact({**load, "shared": collections.Counter({"k:0": 8})}, "k:", 8, 1) == {"k:0": [8, 4]}
    with pytest.raises(RuntimeError, match="not more than its limit"):
        CS.shared_exact(load, "k:", 8, 2)
    assert CS.batch_mean({"m_sum": 10, "m_count": 2}, {"m_sum": 40, "m_count": 4}, "m") == 15.0
    assert CS.owner_launches(
        {"ratelimit_owner_launches_way_scan": 3}, {"ratelimit_owner_launches_way_scan": 10, "x": 1}
    ) == {"way_scan": 7}
