"""Run one cell several times in one process, with the frontend count and
block size of its mix replaced, to see how the closed loop's shape moves
its numbers and how steady each shape reads, and what the host did in each
second of the window.

    python3 -m rlbench.sweep --workload fixed.zipf --shapes 4x32768,16x8192,64x4:1048576 \\
        --seeds 11,12 --seconds 20 [--set KEY=VALUE ...]

A shape is <frontends>x<block rows>, optionally :<pool rows>; the mix's
warm-up blocks a frontend stay as they are. Each run
prints one JSON line: the shape, the seed, `correct`, decisions a second,
the block latency's median and 99th percentile, rows a dispatch-loop launch,
and per second of the window the rows answered, this process's CPU seconds,
the machine's busy share of its CPUs and the garbage collector's seconds.
The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import threading
import time

import numpy as np


def _machine_cpu() -> tuple[float, float]:
    """(busy, total) jiffies of all the machine's CPUs, from /proc/stat."""
    with open("/proc/stat") as f:
        fields = [float(x) for x in f.readline().split()[1:]]
    idle = fields[3] + fields[4]
    return sum(fields) - idle, sum(fields)


class Sampler:
    """Samples the clock, this process's CPU times and the machine's CPU
    every `period` seconds, and the garbage collector's time."""

    def __init__(self, period: float = 0.5):
        self._period = period
        self._stop = threading.Event()
        self.samples: list = []
        self.gc_spans: list = []
        self._gc_t0 = 0.0
        self._thread = threading.Thread(target=self._run, name="rlbench-sampler", daemon=True)

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        else:
            self.gc_spans.append((self._gc_t0, time.perf_counter(), info["generation"]))

    def _run(self):
        while not self._stop.is_set():
            t = os.times()
            self.samples.append((time.perf_counter(), t.user + t.system, *_machine_cpu()))
            self._stop.wait(self._period)

    def __enter__(self):
        gc.callbacks.append(self._on_gc)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        gc.callbacks.remove(self._on_gc)

    def per_second(self, t0: float, t1: float) -> dict:
        s = np.array(self.samples)
        edges = np.arange(t0, t1 + 1e-9, 1.0)
        proc = np.interp(edges, s[:, 0], s[:, 1])
        busy = np.interp(edges, s[:, 0], s[:, 2])
        total = np.interp(edges, s[:, 0], s[:, 3])
        gc_s = np.zeros(max(0, edges.size - 1))
        for a, b, _gen in self.gc_spans:
            i = int(np.searchsorted(edges, a)) - 1
            if 0 <= i < gc_s.size:
                gc_s[i] += b - a
        return {
            "process_cpu_s": np.round(np.diff(proc), 3).tolist(),
            "machine_busy": np.round(np.diff(busy) / np.maximum(np.diff(total), 1), 3).tolist(),
            "gc_s": np.round(gc_s, 4).tolist(),
            "gc_gen2": sum(1 for a, _b, g in self.gc_spans if g == 2 and t0 <= a < t1),
        }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--shapes", required=True, help="comma-separated FxR[:pool rows]")
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=20.0)
    parser.add_argument("--set", action="append", default=[], help="a configuration setting KEY=VALUE")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from . import manifest as mf
    from .run import run_cell

    manifest = mf.load()
    cell = mf.cell(manifest, args.workload)
    config = mf.config(manifest, cell["config"])
    for item in args.set:
        key, value = item.split("=", 1)
        config["settings"][key] = value
    base = mf.traffic(cell["traffic"])
    for shape in args.shapes.split(","):
        dims, _, pool_rows = shape.partition(":")
        frontends, rows = (int(x) for x in dims.split("x"))
        traffic = dict(base, frontends=frontends, block_rows=rows)
        for seed in (int(s) for s in args.seeds.split(",")):
            with Sampler() as sampler:
                result, numbers = run_cell(manifest, cell, config, traffic, seed, args.seconds, False,
                                           device=args.device,
                                           pool_rows=int(pool_rows) if pool_rows else None)
            t0, t1 = numbers["window"]
            lat = numbers["latency_ms"]
            line = {
                "shape": shape, "seed": seed, "correct": result["correct"],
                "decisions_per_s": result["metrics"].get("decisions_per_s", {}).get("value"),
                "p50_ms": float(np.percentile(lat, 50)) if lat.size else None,
                "p99_ms": float(np.percentile(lat, 99)) if lat.size else None,
                "blocks": int(lat.size),
                "rows_per_launch": numbers["rows_per_launch"],
                "rows_a_second": numbers["rows_per_second"],
                **sampler.per_second(t0, t1),
                "compared": {k: v["value"] for k, v in result["compared"].items()},
            }
            print(json.dumps(line))
            sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
