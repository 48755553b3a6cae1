"""Repeated /debug/profile captures of a loaded device owner (card only).

Builds the owner's engine as cmd/sidecar_cmd.py serves it (2^22 rows,
W = 128, the sketch on, the dispatch loop with a 200us window,
precompiled), loads it from --threads threads that submit row blocks
through the dispatch loop without pause, and takes --captures GET
/debug/profile?ms=--ms captures in a row on a debug server with
TPU_PROFILE_DIR set (server/http_server.py new_debug_server). For each
capture it prints one JSON line: the GET's wall ms, the launches the
engine counted meanwhile (ops/slab_kernels.py LAUNCHES), and from the
Chrome trace the kernels, the CUDA runtime and driver calls, the CPU ops
and the served kernels by name. A capture is empty when its trace names
no kernel while the engine launched; the last line sums them up.

--mode picks how the captures are taken, the arms that found C10's cause:
    route       GET /debug/profile on the debug server as the runner and
                the device owner wire it: sessions start and stop inside
                the engine's launches_quiesced, after the boot's warm-up
    route-free  the same route with neither (the capture before C10's fix)
    fresh       torch.profiler on a new thread each capture, as the
                threading HTTP server runs each request
    main-warm   one short capture on the main thread first, then fresh
    one         every capture on one long-lived thread, which also ran
                a short warm-up capture first
    one-settle  one, and the capture synchronizes the card and waits
                20 ms before it stops the profiler
    cuda-only   fresh, with the CUDA activity alone
    quiesce     fresh, with the engine's state lock held (no launch in
                flight, the card synchronized) while the profiler starts
                and while it stops
    quiesce-start / quiesce-stop   the same around the start or the stop

    python -m api_ratelimit_tpu_torch.tools.profile_probe \\
        [--mode route] [--captures 20] [--ms 200] [--threads 4]

Exit 0 when no capture was empty, 1 otherwise, 2 without a card.
"""

from __future__ import annotations

import argparse
import collections
import http.client
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np

SERVED = ("way_scan_kernel", "slab_apply_kernel", "sketch_update_kernel")


def trace_counts(path: str) -> dict:
    """Event counts of one Chrome trace by category, and its kernels by
    name."""
    with open(path) as f:
        doc = json.load(f)
    cats = collections.Counter()
    names = collections.Counter()
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        cat = str(ev.get("cat", "")).lower()
        cats[cat] += 1
        if cat == "kernel":
            names[ev.get("name", "")] += 1
    return {
        "kernels": cats.get("kernel", 0),
        "runtime": cats.get("cuda_runtime", 0) + cats.get("cuda_driver", 0),
        "cpu_ops": cats.get("cpu_op", 0),
        "served": {s: sum(n for k, n in names.items() if s in k) for s in SERVED},
    }


MODES = (
    "route", "route-free", "fresh", "main-warm", "one", "one-settle", "cuda-only",
    "quiesce", "quiesce-start", "quiesce-stop",
)


def _capture(profile_dir: str, ms: float, settle: bool = False, cuda_only: bool = False,
             lock=None, at: tuple = ()) -> None:
    """One torch.profiler session of ms (CPU and CUDA), exported into
    profile_dir: the route's capture outside the HTTP server. With `lock`,
    the profiler starts ("start" in `at`) and stops ("stop") while holding
    it, after a synchronize."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    def held(point):
        if lock is None or point not in at:
            return contextlib.nullcontext()
        return lock

    acts = [ProfilerActivity.CUDA] if cuda_only else [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    prof = profile(activities=acts)
    with held("start"):
        torch.cuda.synchronize()
        prof.__enter__()
    time.sleep(ms / 1e3)
    with held("stop"):
        torch.cuda.synchronize()
        if settle:
            time.sleep(0.02)
        prof.__exit__(None, None, None)
    prof.export_chrome_trace(os.path.join(profile_dir, f"probe_{time.time_ns()}.json"))


class _OneThread:
    """Runs every capture on one long-lived thread."""

    def __init__(self):
        import queue

        self._q = queue.Queue()
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self):
        while True:
            fn, done = self._q.get()
            fn()
            done.set()

    def call(self, fn):
        done = threading.Event()
        self._q.put((fn, done))
        done.wait()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--captures", type=int, default=20)
    parser.add_argument("--ms", type=float, default=200.0)
    parser.add_argument("--threads", type=int, default=4)
    parser.add_argument("--batch", type=int, default=256, help="items a submit")
    parser.add_argument("--mode", choices=MODES, default="route")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_probe: no card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    from ..backends.cuda import SlabDeviceEngine
    from ..ops import slab_kernels as K
    from ..server.http_server import new_debug_server, warm_device_profiler
    from ..stats import Store, TestSink
    from ..utils.timeutil import RealTimeSource

    t0 = time.perf_counter()
    engine = SlabDeviceEngine(
        RealTimeSource(),
        n_slots=1 << 22,
        device="cuda",
        hotkey_lanes=128,
        batch_window_seconds=0.0002,
        max_batch=65536,
        precompile=True,
    )
    boot_engine_s = time.perf_counter() - t0
    profile_dir = tempfile.mkdtemp(prefix="profile_probe_")
    t0 = time.perf_counter()
    server = new_debug_server(Store(TestSink()), profile_dir=profile_dir)
    if args.mode == "route":
        server.profile_quiesce = engine.launches_quiesced
        warm_device_profiler(server)
    server.serve_background()
    boot_server_s = time.perf_counter() - t0
    stop = threading.Event()
    submits = [0]

    def load(seed: int) -> None:
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            block = np.empty((6, args.batch), dtype=np.uint32)
            block[:2] = rng.integers(0, 1 << 32, size=(2, args.batch), dtype=np.uint64).astype(np.uint32)
            block[2], block[3], block[4], block[5] = 1, 1 << 30, 3600, 0
            engine.submit_rows(block)
            submits[0] += 1

    threads = [threading.Thread(target=load, args=(i,), daemon=True) for i in range(args.threads)]
    for t in threads:
        t.start()
    time.sleep(0.5)
    worker = None
    warm_dir = tempfile.mkdtemp(prefix="profile_probe_warm_")
    if args.mode == "main-warm":
        _capture(warm_dir, 10.0)
    elif args.mode in ("one", "one-settle"):
        worker = _OneThread()
        worker.call(lambda: _capture(warm_dir, 10.0))
    rows = []
    try:
        for i in range(args.captures):
            before = dict(K.LAUNCHES)
            t_get = time.perf_counter()
            if args.mode.startswith("route"):
                conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=120)
                conn.request("GET", f"/debug/profile?ms={args.ms}")
                resp = conn.getresponse()
                status, body = resp.status, resp.read()
                conn.close()
                answer = json.loads(body) if status == 200 else body.decode()[:200]
            else:
                at = {"quiesce": ("start", "stop"), "quiesce-start": ("start",), "quiesce-stop": ("stop",)}.get(args.mode, ())
                fn = lambda: _capture(  # noqa: E731
                    profile_dir, args.ms, settle=args.mode == "one-settle", cuda_only=args.mode == "cuda-only",
                    lock=engine._state_lock, at=at,
                )
                if worker is not None:
                    worker.call(fn)
                else:
                    t = threading.Thread(target=fn)
                    t.start()
                    t.join()
                status, answer = 200, None
            wall_ms = (time.perf_counter() - t_get) * 1e3
            launched = {k: K.LAUNCHES[k] - before.get(k, 0) for k in ("way_scan", "slab_apply", "sketch_update")}
            files = sorted(os.listdir(profile_dir))
            row = {"i": i, "status": status, "answer": answer, "wall_ms": wall_ms, "launched": launched}
            if status == 200 and files:
                path = os.path.join(profile_dir, files[-1])
                row |= trace_counts(path)
                os.remove(path)
            row["empty"] = bool(launched["way_scan"]) and not row.get("kernels")
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        stop.set()
        for t in threads:
            t.join(30)
        server.shutdown()
        engine.close()
    summary = {
        "probe": "profile",
        "mode": args.mode,
        "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "boot_engine_s": boot_engine_s,
        "boot_debug_server_s": boot_server_s,
        "captures": len(rows),
        "empty": sum(r["empty"] for r in rows),
        "empty_at": [r["i"] for r in rows if r["empty"]],
        "first_wall_ms": rows[0]["wall_ms"] if rows else None,
        "later_wall_ms_max": max((r["wall_ms"] for r in rows[1:]), default=None),
        "submits": submits[0],
    }
    print(json.dumps(summary), flush=True)
    return 1 if summary["empty"] else 0


if __name__ == "__main__":
    sys.exit(main())
