"""Port of api_ratelimit_tpu/cmd/service_cmd.py: the server's entry point
(src/service_cmd/main.go:5-8).

    BACKEND_TYPE=cuda python -m api_ratelimit_tpu_torch.cmd.service_cmd

FRONTEND_PROCS=1 (the default) is one process: settings from the
environment (settings.py new_settings, which refuses what this package does
not serve), then Runner(settings).run(), which serves gRPC (v3, v2, health),
HTTP /json and the debug port until SIGTERM/SIGINT/SIGHUP, failing health
first. The engine runs on the card: without one, BACKEND_TYPE=cuda exits
non-zero with the engine's error, and nothing serves from the CPU.

FRONTEND_PROCS=N turns it into a process fleet: N frontend server PROCESSES,
each a full Runner with its own interpreter (its own GIL), sharing PORT and
GRPC_PORT through SO_REUSEPORT so the kernel spreads connections over them,
all feeding ONE device-owner process (cmd/sidecar_cmd.py) through the
sidecar socket and, with SHM_RINGS (the default), through shared-memory
submit rings (backends/shm_ring.py). This is the reference's deployment
shape, 2-3 stateless replicas against one Redis
(nomad/apigw-ratelimit/common.hcl), with the owner on the card in Redis's
place.

With BACKEND_TYPE=cuda the master spawns the owner itself (it inherits the
TPU_* knobs) and rewrites the workers to BACKEND_TYPE=cuda-sidecar pointed at
SIDECAR_SOCKET; with BACKEND_TYPE=cuda-sidecar an owner is already running
and only the workers spawn. Workers never touch the card: the master starts
them with CUDA_VISIBLE_DEVICES="". Every child starts through subprocess,
never fork, so a master or caller that holds a CUDA context passes none on.
Debug ports: the master keeps DEBUG_PORT and serves the fleet metrics
aggregator there (GET /metrics?fleet=1 merges every member's exposition,
stats/fleet.py); worker i listens on DEBUG_PORT+1+i and the owner on
DEBUG_PORT+1+N. Dead workers restart after 1 s; SIGTERM takes the workers
down first and the owner last, so the owner drains last.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.parse

from ..runner import Runner, setup_logging
from ..settings import Settings, new_settings

logger = logging.getLogger("ratelimit.service_cmd")

_OWNER_MODULE = "api_ratelimit_tpu_torch.cmd.sidecar_cmd"
_WORKER_MODULE = "api_ratelimit_tpu_torch.cmd.service_cmd"


def main() -> int:
    settings = new_settings()
    n = settings.frontend_procs_count()
    if n <= 1:
        Runner(settings).run()
        return 0
    return run_frontend_fleet(settings, n)


def _wait_for_unix_socket(path: str, proc, timeout: float = 600.0) -> None:
    """Block until the device owner's unix socket exists (its precompile
    may build the kernels first) or its process dies."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(
                f"device owner exited with {proc.returncode} before its socket {path} appeared"
            )
        if time.monotonic() > deadline:
            raise TimeoutError(f"device owner socket {path} never appeared")
        time.sleep(0.1)


def _serve_fleet_aggregator(settings: Settings, member_ports: list[int]):
    """Mount the master's debug listener: GET /metrics?fleet=1 scrapes
    every member's /metrics and serves one merged exposition; a plain GET
    /metrics answers with the member port map (the master has no stats
    store of its own). Returns the listener, or None when the port could
    not bind (the fleet must still serve traffic)."""
    from ..server.http_server import DebugServer
    from ..stats import fleet as fleet_mod
    from ..utils import provenance

    try:
        server = DebugServer("", settings.debug_port)
    except OSError as e:
        logger.error(
            "fleet aggregator cannot bind debug port %d: %s (per-member /metrics remain on ports %s)",
            settings.debug_port, e, member_ports,
        )
        return None

    def handle_metrics(path: str):
        query = urllib.parse.parse_qs(urllib.parse.urlparse(path).query)
        if query.get("fleet", ["0"])[0] not in ("1", "true"):
            body = json.dumps(
                {
                    "fleet": True,
                    "member_debug_ports": member_ports,
                    # the master's own box facts: it owns no card, so its
                    # block says cpu/0; the owner reports the card in the
                    # merged exposition's ratelimit.build.* gauges
                    "build": provenance.build_provenance("cpu", 0),
                    "hint": "GET /metrics?fleet=1 for the merged fleet-wide exposition",
                },
                indent=2,
            ).encode()
            return 200, body, "application/json"
        merged, errors = fleet_mod.fleet_metrics(member_ports)
        for port, reason in errors:
            logger.warning("fleet scrape: member on port %d did not answer: %s", port, reason)
        return 200, merged.encode(), fleet_mod.CONTENT_TYPE

    def handle_index(_path: str):
        lines = ["fleet master endpoints:"] + [f"  {e}" for e in server.endpoints()]
        return 200, ("\n".join(lines) + "\n").encode(), "text/plain"

    server.add_route("/metrics", handle_metrics)
    server.add_route("/", handle_index)
    server.serve_background()
    logger.warning(
        "fleet metrics aggregator on debug port %d (members: %s)", settings.debug_port, member_ports
    )
    return server


def run_frontend_fleet(settings: Settings, n: int) -> int:
    """The master process: spawn (the owner and) N workers, supervise them,
    tear them down on a signal. Returns the exit code."""
    setup_logging(settings)
    stop = threading.Event()
    worker_env = dict(os.environ)
    worker_env["FRONTEND_PROCS"] = "1"
    owner_debug_port = settings.debug_port + 1 + n
    owner = None
    owner_env = None
    if settings.backend_type == "cuda":
        owner_env = dict(os.environ)
        owner_env["FRONTEND_PROCS"] = "1"
        owner_env["DEBUG_PORT"] = str(owner_debug_port)
        owner = subprocess.Popen([sys.executable, "-m", _OWNER_MODULE], env=owner_env)
        logger.warning(
            "FRONTEND_PROCS=%d: spawned device owner pid %d on %s",
            n, owner.pid, settings.sidecar_socket,
        )
        worker_env["BACKEND_TYPE"] = "cuda-sidecar"
        if "://" not in settings.sidecar_socket:
            _wait_for_unix_socket(settings.sidecar_socket, owner)
    # frontends never hold the card the owner serves
    worker_env["CUDA_VISIBLE_DEVICES"] = ""

    def spawn_worker(i: int) -> subprocess.Popen:
        env = dict(worker_env)
        # gRPC/HTTP share the ports through SO_REUSEPORT; the debug
        # listener stays one port per process or scrapes would split
        env["DEBUG_PORT"] = str(settings.debug_port + 1 + i)
        proc = subprocess.Popen([sys.executable, "-m", _WORKER_MODULE], env=env)
        logger.warning(
            "spawned frontend worker %d/%d pid %d (debug port %s)",
            i + 1, n, proc.pid, env["DEBUG_PORT"],
        )
        return proc

    workers = [spawn_worker(i) for i in range(n)]
    member_ports = [settings.debug_port + 1 + i for i in range(n)]
    if owner is not None:
        member_ports.append(owner_debug_port)
    aggregator = _serve_fleet_aggregator(settings, member_ports)

    def on_signal(signum, frame):
        logger.warning("got signal %s, tearing down the fleet", signum)
        stop.set()

    for sig in (signal.SIGINT, signal.SIGTERM, signal.SIGHUP):
        signal.signal(sig, on_signal)

    try:
        while not stop.is_set():
            for i, proc in enumerate(workers):
                rc = proc.poll()
                if rc is not None and not stop.is_set():
                    logger.error(
                        "frontend worker %d (pid %d) exited with %s; restarting in 1s",
                        i + 1, proc.pid, rc,
                    )
                    time.sleep(1.0)
                    workers[i] = spawn_worker(i)
            if owner is not None and owner.poll() is not None and not stop.is_set():
                # the owner IS the slab: without it the workers serve only
                # their degradation ladders
                logger.error(
                    "device owner (pid %d) exited with %s; restarting in 1s",
                    owner.pid, owner.returncode,
                )
                time.sleep(1.0)
                owner = subprocess.Popen([sys.executable, "-m", _OWNER_MODULE], env=owner_env)
            stop.wait(0.5)
    finally:
        if aggregator is not None:
            aggregator.shutdown()
        # workers first (they finish their in-flight requests against a
        # live owner), the owner last
        for proc in workers:
            if proc.poll() is None:
                proc.terminate()
        deadline = time.monotonic() + 15.0
        for proc in workers:
            try:
                proc.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        if owner is not None and owner.poll() is None:
            owner.terminate()
            try:
                owner.wait(60.0)
            except subprocess.TimeoutExpired:
                owner.kill()
                owner.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
