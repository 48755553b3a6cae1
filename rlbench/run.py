"""Run one cell of the benchmark once.

    python3 -m rlbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
Set-up builds the device owner of the cell's configuration, draws the
traffic pool from the seed and warms the closed loop; the window then runs
for --seconds; the comparison with the reference runs after it. The last
line of standard output is one JSON object (`correct`, `attempted`,
`failed`, `metrics`, `device`, with --trace 1 `breakdown`, then `compared`,
the numbers that decided `correct` beside their limits, which also close
standard error). Without a card, or with fewer than the cell asks for, it
exits 2 and prints no result; if JAX or the JAX package is loaded once the
window has closed, it exits 3; if no traced slice of a --trace 1 run
recorded a device activity, it exits 4.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "api_ratelimit_tpu")
TOP_OPS = 10
NAME_CHARS = 120  # of a device op's name in the breakdown


def process_start() -> float:
    """Epoch seconds at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_PROCESS = process_start()


class RunView:
    """What a per-layer metric reader sees of a run."""

    def __init__(self, config, pool, log, spans, slice_, frontends, window, traced):
        from .owner import slab_geometry

        self.config = config
        self.pool = pool
        self.log = log
        self.slice = slice_
        self._spans = spans  # [(snapshot at start, snapshot at end)] of the untraced parts
        self._frontends = frontends
        self._window = window
        self._traced = traced
        self.n_slots, self.ways, _ = slab_geometry(config)
        self.lanes = int(config["settings"].get("HOTKEY_LANES", "0"))

    def histogram(self, name: str) -> tuple[int, float]:
        """(count, sum) a program histogram gained over the window, outside
        the traced slice (the profiler slows the host inside it)."""
        count, total = 0, 0.0
        for h0, h1 in self._spans:
            count += h1[name][0] - h0[name][0]
            total += h1[name][1] - h0[name][1]
        return count, total

    def block_latencies_ms(self):
        """Latency of each block answered in the window, leaving out those
        in flight during the traced slice (the profiler holds the owner)."""
        import numpy as np

        t0, t1 = self._window
        a, b = self._traced if self._traced is not None else (t1, t1)
        out = []
        for fe in self._frontends:
            k = fe.done
            sent, done, ok = fe.t_sent[:k], fe.t_done[:k], fe.rows[:k] >= 0
            keep = ok & (((done >= t0) & (done < a)) | ((sent >= b) & (done <= t1)))
            out.append((done - sent)[keep])
        return np.concatenate(out) * 1e3

    def slice_launches(self):
        """fp_lo of each device launch in the traced slice."""
        from .pool import FP_LO

        if self.slice is None:
            return
        lo, hi = self.slice.log_range
        blocks = self.pool.blocks
        rows = self.pool.block_rows
        for _readings, order, chunk_rows, _t0 in self.log.entries[lo:hi]:
            pos = 0
            for n in chunk_rows:
                k = n // rows
                yield blocks[list(order[pos : pos + k]), FP_LO, :].ravel()
                pos += k


def _rows_per_second(frontends, t0: float, t1: float) -> list:
    """Rows answered in each whole second of the window (a diagnostic)."""
    import numpy as np

    edges = np.arange(t0, t1 + 1e-9, 1.0)
    total = np.zeros(max(0, edges.size - 1), dtype=np.int64)
    for fe in frontends:
        k = fe.done
        ok = fe.rows[:k] >= 0
        hist, _ = np.histogram(fe.t_done[:k][ok], bins=edges, weights=fe.rows[:k][ok])
        total += hist.astype(np.int64)
    return total.tolist()


HISTOGRAMS = ("dispatch.batch_size", "dispatch.ring_wait_ms", "device.launch_ms")


def _histograms(store) -> dict:
    out = {}
    for name in HISTOGRAMS:
        scope, leaf = name.rsplit(".", 1)
        snap = store.scope(scope).histogram(leaf).snapshot()
        out[name] = (snap["count"], snap["sum"])
    return out


def run_cell(manifest: dict, cell: dict, config: dict, traffic: dict, seed: int, seconds: float,
             trace: bool, device: str = "cuda", pool_rows: int | None = None,
             make_owner=None, bench_dir: str | None = None,
             trace_slice: bool = True) -> tuple[dict, dict]:
    """One run of `cell`: (result line, compared numbers). trace=True
    reports the per-layer metrics; trace_slice=False leaves out the
    profiled slice (the CPU has no device to trace)."""
    import numpy as np

    from api_ratelimit_tpu_torch.stats.store import Store

    from . import manifest as mf
    from .check import LIMITS, compare, sampled_lanes, verdict
    from .loop import Loop, window_stats
    from .owner import LaunchClock, LaunchLog, build_owner
    from .pool import make_pool
    from .trace import Tracer

    marks = [("start", time.time() - T_PROCESS)]
    pool = make_pool(config, traffic, seed, pool_rows)
    marks.append(("pool", time.time() - T_PROCESS))
    clock = LaunchClock()
    log = LaunchLog(pool.blocks)
    store = Store()
    owner = (make_owner or build_owner)(config, clock, log, store, device)
    marks.append(("owner", time.time() - T_PROCESS))
    sets, lanes = sampled_lanes(config, pool, seed)
    loop = Loop(owner, pool, lanes)
    loop.start()
    warm = int(traffic["warmup_blocks_per_frontend"]) * pool.frontends
    if not loop.wait_completed(warm, timeout=600.0):
        raise RuntimeError(f"warm-up did not complete {warm} blocks")
    spans = [[_histograms(store)]]
    t0 = time.perf_counter()
    setup_s = time.time() - T_PROCESS
    read_slice = None
    traced = None  # (start, end) of the traced slice, perf_counter
    if trace and trace_slice:
        time.sleep(seconds * 0.25)
        spans[-1].append(_histograms(store))
        traced = [time.perf_counter()]
        read_slice = Tracer(owner, log).capture(min(1.0, seconds * 0.5))
        traced.append(time.perf_counter())
        spans.append([_histograms(store)])
    time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
    t1 = time.perf_counter()
    spans[-1].append(_histograms(store))
    unanswered = loop.stop(timeout=60.0)
    served = window_stats(loop.frontends, t0, t1)
    export = getattr(owner, "export_sketch", None)
    planes = export() if export is not None else None
    memory_peak = 0
    kind = "cpu"
    if device != "cpu":
        import torch

        memory_peak = int(torch.cuda.max_memory_allocated())
        kind = torch.cuda.get_device_name(0)
    owner.close()
    del owner
    slice_ = read_slice() if read_slice is not None else None
    t_check = time.perf_counter()
    numbers = compare(config, pool, log, loop.frontends, unanswered, sets, lanes,
                      planes, int(traffic.get("sketch_topk", 0)))
    correct = verdict(numbers)
    marks += [("window", setup_s), ("check_s", time.perf_counter() - t_check)]
    print("rlbench: " + ", ".join(f"{k} {v:.3f}" for k, v in marks)
          + f"; launches {len(log.entries)}, served blocks {served['blocks']}"
          + (f", p99 {np.percentile(served['latency_ms'], 99):.3f} ms" if served["blocks"] else "")
          + "; rows a second "
          + " ".join(str(r) for r in _rows_per_second(loop.frontends, t0, t1)), file=sys.stderr)
    window = t1 - t0
    metrics = {}
    if trace:
        view = RunView(config, pool, log, spans, slice_, loop.frontends, (t0, t1), traced)
        for m in mf.cell_metrics(manifest, cell, "per_layer"):
            value = mf.reader(m["name"], bench_dir or mf.BENCH_DIR)(view)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        e2e = {
            "decisions_per_s": served["rows"] / window if window > 0 else None,
            "setup_s": setup_s,
        }
        for m in mf.cell_metrics(manifest, cell, "end_to_end"):
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    result = {
        "correct": correct,
        "attempted": served["attempted"],
        "failed": served["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device != "cpu" else "cpu",
            "kind": kind,
            "count": int(cell["chips"]),
            "memory_peak_bytes": memory_peak,
        },
    }
    if slice_ is not None:
        result["device"]["busy_s"] = slice_.busy_s
        result["device"]["window_s"] = slice_.window_s
        ops = sorted(slice_.op_seconds().items(), key=lambda kv: -kv[1])[:TOP_OPS]
        ops = [(name.removeprefix("void ")[:NAME_CHARS], sec) for name, sec in ops]
        gaps = sorted(slice_.gaps.items(), key=lambda kv: -kv[1])[:TOP_OPS]
        result["breakdown"] = {"device_ops": [list(o) for o in ops], "idle_gaps": [list(g) for g in gaps]}
    result["compared"] = {
        name: {"value": numbers[name], "limit": f"{op} {limit}"} for name, (op, limit) in LIMITS.items()
    }
    numbers["served_blocks"] = served["blocks"]
    numbers["window"] = (t0, t1)
    in_window = [sum(e[2]) for e in log.entries if t0 <= e[3] < t1]
    numbers["rows_per_launch"] = float(np.mean(in_window)) if in_window else 0.0
    numbers["rows_per_second"] = _rows_per_second(loop.frontends, t0, t1)
    numbers["latency_ms"] = served["latency_ms"]
    return result, numbers


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from . import manifest as mf

    manifest = mf.load()
    cell = mf.cell(manifest, args.workload)
    config = mf.config(manifest, cell["config"])
    traffic = mf.traffic(cell["traffic"])
    try:
        import torch
        import api_ratelimit_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"rlbench: cannot import the program: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(
            f"rlbench: the cell needs {cell['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
            file=sys.stderr,
        )
        return 2
    from .trace import TraceEmpty

    try:
        result, numbers = run_cell(manifest, cell, config, traffic, args.seed, args.seconds, bool(args.trace))
    except TraceEmpty as e:
        print(f"rlbench: {e}", file=sys.stderr)
        return 4
    loaded = sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"rlbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    for fault in numbers["faults"]:
        print(f"rlbench: {fault}", file=sys.stderr)
    for name, entry in result["compared"].items():
        print(f"{name} {entry['value']} limit {entry['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
