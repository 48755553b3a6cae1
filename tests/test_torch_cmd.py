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
    proc = _service(_service_env(tmp_path, BACKEND_TYPE="memory", FED_ENABLED="true"))
    _out, err = proc.communicate(timeout=60)
    assert proc.returncode != 0
    assert "ROADMAP item 9" in err
