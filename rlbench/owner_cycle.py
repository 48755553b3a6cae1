"""The device owner's cycle laid over the device trace: a diagnostic beside
the benchmark, whose result line does not read it.

    python3 -m rlbench.owner_cycle [--workload fixed.zipf] [--seed N]
        [--slices 6] [--slice-seconds 1.0] [--out chiprun_out/owner_cycle.json]

builds the cell's owner, traffic and closed loop as rlbench.run does, warms
it, then takes traced slices (rlbench/trace.py, quiesced start and stop) in
turns with the program's span recorder registered (even slices) and not
(odd ones), and prints one JSON line a slice, then one for the run:

  - every slice: the owner's cycle (window ms a dispatch-loop launch) and
    `device.idle_pct`: the pairs of slices give what recording costs;
  - a recorded slice: the device idle ms a launch split by the owner's
    phase (OWNER_PHASES, over its cycle spans: backends/dispatch.py), the
    share of the idle they cover, the idle in no owner span by the pair of
    spans around it, and how many of the owner's cudaLaunchKernel and
    cudaMemcpyAsync calls lie inside an owner span (the program's clock
    against the profiler's);
  - the run: the means of the always-on histograms device.step_enqueue_ms,
    device.launch_ms, dispatch.wake_ms and the off-CPU share (dispatch.
    offcpu_ms over dispatch.cycle_ms) outside the slices, and `correct`
    from rlbench/check.py over the whole run.

A program that records no owner span gives the cycle and idle only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import trace as T

OWNER_RING = 1 << 18  # spans the recorder keeps a slice
RUNTIME_CALLS = ("cudaLaunchKernel", "cudaMemcpyAsync")
# the owner's cycle spans by the phase an idle gap is laid to
OWNER_PHASES = {
    "enqueue": ("engine.promote", "engine.step_enqueue", "engine.readback_enqueue"),
    "pack": ("dispatch.take", "engine.pack", "engine.operand_wait"),
    "redeem": ("engine.fence_wait", "engine.copy", "dispatch.scatter"),
    "turn": ("dispatch.turn",),
    "starved": ("dispatch.linger", "dispatch.wait"),
}
HISTOGRAMS = ("device.step_enqueue_ms", "device.launch_ms", "dispatch.wake_ms",
              "dispatch.offcpu_ms", "dispatch.cycle_ms")
SLACK_US = 10.0  # the epoch floats' rounding, when a call is matched to a span


def owner_timeline(spans, trace_start_ns: int) -> list:
    """(name, start_us, end_us) of finished spans on the profiler's
    timeline (each span's epoch start less the trace's), sorted."""
    base_us = trace_start_ns / 1e3
    out = [(s.operation_name, s.start_time * 1e6 - base_us, (s.start_time + s.duration) * 1e6 - base_us)
           for s in spans]
    return sorted(out, key=lambda t: t[1])


def idle_gaps(device: list) -> list:
    """(start_us, end_us) of the gaps between merged device activities."""
    _, merged = T._union_us([(s, e) for _, s, e in device])
    return [(a, b) for (_, a), (b, _) in zip(merged[:-1], merged[1:]) if b > a]


def overlap_us(a: list, b: list) -> float:
    """Total overlap of two sorted lists of disjoint (start, end) pairs."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def children(owner: list) -> list:
    """The owner's cycle spans without their dispatch.batch parents: one
    thread's, so they never overlap."""
    return [o for o in owner if o[0] != "dispatch.batch"]


def split_idle(device: list, owner: list, launches: int) -> dict:
    """Device idle ms a launch in each phase of OWNER_PHASES, "between"
    (idle in no owner span), "idle" (all of it) and "share" (the phases'
    part of the idle)."""
    gaps = idle_gaps(device)
    kids = children(owner)
    out = {p: overlap_us(gaps, [(s, e) for n, s, e in kids if n in names]) / 1e3 / launches
           for p, names in OWNER_PHASES.items()}
    idle = sum(b - a for a, b in gaps) / 1e3 / launches
    covered = sum(out.values())
    out.update(between=idle - covered, idle=idle, share=covered / idle if idle else None)
    return out


def idle_between_by_pair(device: list, owner: list, launches: int, top: int = 6) -> dict:
    """Idle ms a launch in the holes between consecutive owner spans, by
    "<span before>><span after>", the largest first."""
    kids = children(owner)
    holes = {}
    gaps = idle_gaps(device)
    for (n0, _, e0), (n1, s1, _) in zip(kids, kids[1:]):
        if s1 > e0:
            key = f"{n0}>{n1}"
            holes[key] = holes.get(key, 0.0) + overlap_us(gaps, [(e0, s1)]) / 1e3 / launches
    return dict(sorted(holes.items(), key=lambda kv: -kv[1])[:top])


def calls_inside(runtime: list, owner: list, window_us: float) -> tuple[int, int]:
    """(calls inside an owner span, calls) of the runtime calls that start
    in the slice, each matched to the last span starting before it."""
    import numpy as np

    kids = children(owner)
    starts = np.array([s for _, s, _ in kids])
    calls = [(a, b) for _, a, b in runtime if 0.0 <= a <= window_us]
    inside = 0
    for a, b in calls:
        i = int(np.searchsorted(starts, a + SLACK_US, side="right")) - 1
        inside += bool(i >= 0 and a >= kids[i][1] - SLACK_US and b <= kids[i][2] + SLACK_US)
    return inside, len(calls)


class OwnerTracer(T.Tracer):
    """rlbench/trace.py's slice, with the program's RecordingTracer as the
    global tracer over it when `record` (then restored): read() gives the
    Slice and, recorded, (owner spans on its timeline, whether the ring
    filled, the owner thread's runtime calls)."""

    def capture(self, seconds: float, attempts: int = 4, record: bool = True):
        from torch.profiler import ProfilerActivity, profile

        from api_ratelimit_tpu_torch import tracing

        for _ in range(attempts):
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            recorder = tracing.RecordingTracer(OWNER_RING, keep_unsampled=True) if record else None
            previous = tracing.global_tracer() if tracing.is_global_tracer_registered() else None
            with self._engine.launches_quiesced():
                n0, l0 = self._counts()
                if recorder is not None:
                    tracing.set_global_tracer(recorder)
                prof.start()
                t0 = time.perf_counter()
            time.sleep(seconds)
            with self._engine.launches_quiesced():
                t1 = time.perf_counter()
                prof.stop()
                if recorder is not None:
                    if previous is not None:
                        tracing.set_global_tracer(previous)
                    else:
                        tracing.reset_global_tracer()
                n1, l1 = self._counts()
            if T._names_device_activity(prof):
                return lambda: self._with_owner(self._read(prof, t1 - t0, n1 - n0, (l0, l1)), prof, recorder)
        raise T.TraceEmpty(f"{attempts} traced slices of {seconds} s recorded no device activity")

    @staticmethod
    def _with_owner(slice_, prof, recorder):
        if recorder is None:
            return slice_, None
        spans = recorder.finished_spans()
        owner = owner_timeline(spans, prof.profiler.kineto_results.trace_start_ns())
        runtime = [(e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name in RUNTIME_CALLS]
        return slice_, (owner, len(spans) >= OWNER_RING, runtime)


def read_slice(slice_, recorded) -> dict:
    """One slice's line (the module's docstring)."""
    launches = max(1, slice_.launches)
    out = {
        "recorded": recorded is not None,
        "launches": slice_.launches,
        "cycle_ms": slice_.window_s / launches * 1e3,
        "device.idle_pct": 100.0 * (1.0 - slice_.busy_s / slice_.window_s),
    }
    if recorded is not None:
        owner, dropped, runtime = recorded
        out["owner_spans"] = len(owner)
        out["ring_full"] = dropped
        if owner and not dropped:
            out["idle_ms"] = split_idle(slice_.device, owner, launches)
            out["between_by_pair"] = idle_between_by_pair(slice_.device, owner, launches)
            out["calls_inside"] = calls_inside(runtime, owner, slice_.window_s * 1e6)
    return out


def _snapshot(store) -> dict:
    out = {}
    for name in HISTOGRAMS:
        scope, leaf = name.rsplit(".", 1)
        snap = store.scope(scope).histogram(leaf).snapshot()
        out[name] = (snap["count"], snap["sum"])
    return out


def _means(parts: list) -> dict:
    """The histograms' means over (before, after) snapshot pairs, and the
    off-CPU share of the owner's cycle."""
    count = {n: sum(b[n][0] - a[n][0] for a, b in parts) for n in HISTOGRAMS}
    total = {n: sum(b[n][1] - a[n][1] for a, b in parts) for n in HISTOGRAMS}
    out = {n: total[n] / count[n] for n in HISTOGRAMS if count[n]}
    if total["dispatch.cycle_ms"] > 0:
        out["dispatch.owner_offcpu_pct"] = 100.0 * total["dispatch.offcpu_ms"] / total["dispatch.cycle_ms"]
    return out


def measure(workload: str, seed: int, slices: int, slice_seconds: float, device: str = "cuda",
            tiny=None, emit=print) -> dict:
    """Run the diagnostic; `tiny` (config, traffic, pool rows) shrinks it
    for the CPU. Returns {"slices": [line, ...], "run": line}."""
    from api_ratelimit_tpu_torch.stats.store import Store

    from . import manifest as mf
    from .check import compare, sampled_lanes, verdict
    from .loop import Loop
    from .owner import LaunchClock, LaunchLog, build_owner
    from .pool import make_pool

    manifest = mf.load()
    cell = mf.cell(manifest, workload)
    config, traffic, rows = mf.config(manifest, cell["config"]), mf.traffic(cell["traffic"]), None
    if tiny is not None:
        config, traffic, rows = tiny(config, traffic)
    pool = make_pool(config, traffic, seed, rows)
    clock, log, store = LaunchClock(), LaunchLog(pool.blocks), Store()
    owner = build_owner(config, clock, log, store, device)
    sets, lanes = sampled_lanes(config, pool, seed)
    loop = Loop(owner, pool, lanes)
    loop.start()
    warm = int(traffic["warmup_blocks_per_frontend"]) * pool.frontends
    if not loop.wait_completed(warm, timeout=600.0):
        raise RuntimeError(f"warm-up did not complete {warm} blocks")
    tracer = OwnerTracer(owner, log)
    reads, parts = [], []
    try:
        for i in range(slices):
            before = _snapshot(store)
            time.sleep(slice_seconds)
            parts.append((before, _snapshot(store)))
            reads.append(tracer.capture(slice_seconds, record=i % 2 == 0))
    finally:
        unanswered = loop.stop(timeout=60.0)
        export = getattr(owner, "export_sketch", None)
        planes = export() if export is not None else None
        owner.close()
    lines = [read_slice(*read()) for read in reads]
    for line in lines:
        emit(json.dumps(line))
    numbers = compare(config, pool, log, loop.frontends, unanswered, sets, lanes,
                      planes, int(traffic.get("sketch_topk", 0)))
    run = dict(_means(parts), correct=verdict(numbers), seed=seed)
    emit(json.dumps(run))
    return {"slices": lines, "run": run}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", default="fixed.zipf")
    parser.add_argument("--seed", type=int, default=2**31 + 101)
    parser.add_argument("--slices", type=int, default=6)
    parser.add_argument("--slice-seconds", type=float, default=1.0)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    got = measure(args.workload, args.seed, args.slices, args.slice_seconds)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(got, f, indent=1)
    return 0 if got["run"]["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
