"""Port of api_ratelimit_tpu/utils/timeutil.py: the time source and window math.

Reference parity: src/utils/utilities.go:10-14 (TimeSource iface),
src/utils/time.go:17-29 (real impl), src/utils/utilities.go:34-38
(CalculateReset).

Every time-semantic call site (window math, TTLs) draws its clock from a
TimeSource instead of the `time` module, so tests can pin it. The runner
hands every component one process clock (process_time_source), a
SkewableTimeSource whose base tests replace (install_process_time_source).
"""

from __future__ import annotations

import threading
import time
from typing import Protocol

from ..models.units import Unit, unit_to_divider


class TimeSource(Protocol):
    def unix_now(self) -> int:
        """Current unix time in whole seconds."""
        ...

    def monotonic(self) -> float:
        """Monotonic seconds (interval math)."""
        ...

    def sleep(self, seconds: float) -> None: ...


class RealTimeSource:
    def unix_now(self) -> int:
        return int(time.time())

    def monotonic(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


class FakeTimeSource:
    """Settable clock for tests and the chip smoke; sleeps advance virtual
    time, and monotonic() tracks the same virtual clock."""

    def __init__(self, now: int = 0):
        self.now = int(now)
        self.sleeps: list[float] = []

    def unix_now(self) -> int:
        return self.now

    def monotonic(self) -> float:
        return float(self.now)

    def sleep(self, seconds: float) -> None:
        self.sleeps.append(seconds)
        self.now += int(seconds)

    def advance(self, seconds: int) -> None:
        self.now += int(seconds)


class SkewableTimeSource:
    """A TimeSource view over a base clock with a runtime-adjustable skew:
    a step offset (seconds) plus a drift rate (ppm of elapsed base time
    since the skew was set). unix_now() is skewed — that is what window
    math, TTLs and GCRA's TAT read. monotonic()
    passes through unskewed: real wall-clock skew never bends a process's
    monotonic clock.

    set_skew() replaces the whole skew (offset anchored at call time);
    set_skew() with defaults resets to the base clock. Thread-safe.
    """

    def __init__(self, base: TimeSource):
        self._base = base
        self._lock = threading.Lock()
        self._offset_s = 0.0
        self._drift_ppm = 0.0
        self._anchor = 0.0  # base unix seconds when the skew was set

    def set_skew(self, offset_s: float = 0.0, drift_ppm: float = 0.0) -> None:
        offset_s = float(offset_s)
        drift_ppm = float(drift_ppm)
        with self._lock:
            self._offset_s = offset_s
            self._drift_ppm = drift_ppm
            self._anchor = float(self._base.unix_now())

    def skew(self) -> dict:
        """Current skew description."""
        with self._lock:
            return {
                "offset_s": self._offset_s,
                "drift_ppm": self._drift_ppm,
                "anchor": self._anchor,
            }

    def unix_now(self) -> int:
        base = float(self._base.unix_now())
        with self._lock:
            skew = self._offset_s
            if self._drift_ppm:
                skew += (base - self._anchor) * self._drift_ppm * 1e-6
        return int(base + skew)

    def monotonic(self) -> float:
        return self._base.monotonic()

    def sleep(self, seconds: float) -> None:
        self._base.sleep(seconds)


_process_lock = threading.Lock()
_process_source: SkewableTimeSource | None = None


def process_time_source() -> SkewableTimeSource:
    """The process-wide clock authority. Boot code (runner.py, cmd/*)
    hands this single source to every component it constructs, so one
    admin op skews the whole process coherently."""
    global _process_source
    with _process_lock:
        if _process_source is None:
            _process_source = SkewableTimeSource(RealTimeSource())
        return _process_source


def install_process_time_source(base: TimeSource) -> SkewableTimeSource:
    """Replace the process clock's BASE (tests pin it
    to a FakeTimeSource). Returns the new skewable wrapper."""
    global _process_source
    with _process_lock:
        _process_source = (
            base
            if isinstance(base, SkewableTimeSource)
            else SkewableTimeSource(base)
        )
        return _process_source


def calculate_reset(unit: Unit, now: int) -> int:
    """Seconds until the current fixed window for `unit` resets."""
    sec = unit_to_divider(unit)
    return sec - now % sec
