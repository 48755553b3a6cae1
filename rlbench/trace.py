"""The traced slice of a `--trace 1` run: torch.profiler over a slice of the
window, started and stopped with the owner's launches quiesced (a session
that starts while a launch is in flight can record no kernel). When a
capture names no device activity, further slices are tried; if none names
one, the run fails (TraceEmpty): no other clock stands in for the
profiler's device time."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

GAP_NO_OP = "host outside any recorded call"


class TraceEmpty(RuntimeError):
    """No traced slice recorded a device activity."""


@dataclass
class Slice:
    window_s: float
    launches: int  # dispatch-loop launches in the slice
    log_range: tuple  # launch-log entries [lo, hi) in the slice
    busy_s: float
    device: list = field(default_factory=list)  # (name, start_us, end_us)
    gaps: dict = field(default_factory=dict)  # host label -> idle seconds

    def kernel_seconds(self, needle: str) -> float:
        return sum(e - s for name, s, e in self.device if needle in name) * 1e-6

    def op_seconds(self) -> dict:
        out: dict = {}
        for name, s, e in self.device:
            out[name] = out.get(name, 0.0) + (e - s) * 1e-6
        return out


def _union_us(intervals: list) -> tuple[float, list]:
    """(total busy us, merged intervals) of (start, end) pairs."""
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def _label_gaps(merged: list, cpu_ops: list) -> dict:
    """Idle seconds between device activities, by the host call that
    overlaps each gap most: a CUDA runtime call (which the profiler records
    on every thread) or a torch op of a thread it follows."""
    gaps: dict = {}
    if not cpu_ops:
        return gaps
    cpu_ops.sort()
    starts = np.array([s for s, _, _ in cpu_ops])
    for (_, a), (b, _) in zip(merged[:-1], merged[1:]):
        if b <= a:
            continue
        best, label = 0.0, GAP_NO_OP
        i = int(np.searchsorted(starts, b))
        for s, e, name in cpu_ops[max(0, i - 64) : i]:
            overlap = min(e, b) - max(s, a)
            if overlap > best:
                best, label = overlap, name
        gaps[label] = gaps.get(label, 0.0) + (b - a) * 1e-6
    return gaps


def _names_device_activity(prof) -> bool:
    """Whether a stopped capture recorded any device activity, from the raw
    results (cheap), without building the event tree."""
    try:
        raw = prof.profiler.kineto_results.events()
        return any(str(e.device_type()).endswith("CUDA") for e in raw)
    except (AttributeError, TypeError):
        return any(str(getattr(e, "device_type", "")).endswith("CUDA") for e in prof.events())


class Tracer:
    """Profiles a slice of the window of `engine` (a SlabDeviceEngine)."""

    def __init__(self, engine, log):
        self._engine = engine
        self._log = log

    def _counts(self):
        return self._engine.dispatch_loop.launches, len(self._log.entries)

    def capture(self, seconds: float, attempts: int = 4):
        """Profile `seconds` of the window; returns read() -> Slice, to call
        once the window has closed (reading the trace holds the host)."""
        from torch.profiler import ProfilerActivity, profile

        for _ in range(attempts):
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            with self._engine.launches_quiesced():
                n0, l0 = self._counts()
                prof.start()
                t0 = time.perf_counter()
            time.sleep(seconds)
            with self._engine.launches_quiesced():
                t1 = time.perf_counter()
                prof.stop()
                n1, l1 = self._counts()
            if _names_device_activity(prof):
                return lambda: self._read(prof, t1 - t0, n1 - n0, (l0, l1))
        raise TraceEmpty(f"{attempts} traced slices of {seconds} s recorded no device activity")

    @staticmethod
    def _read(prof, window_s: float, launches: int, log_range: tuple) -> Slice:
        device, cpu_ops = [], []
        for e in prof.events():
            kind = str(getattr(e, "device_type", "")).rsplit(".", 1)[-1]
            s, t = e.time_range.start, e.time_range.end
            if kind == "CUDA":
                device.append((e.name, s, t))
            elif kind == "CPU" and e.cpu_parent is None:
                cpu_ops.append((s, t, e.name))
        busy_us, merged = _union_us([(s, t) for _, s, t in device])
        return Slice(
            window_s, launches, log_range, busy_us * 1e-6,
            device, _label_gaps(merged, cpu_ops),
        )
