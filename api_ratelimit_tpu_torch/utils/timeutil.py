"""Port of api_ratelimit_tpu/utils/timeutil.py: the time source and window math.

Reference parity: src/utils/utilities.go:10-14 (TimeSource iface),
src/utils/time.go:17-29 (real impl), src/utils/utilities.go:34-38
(CalculateReset).

Every time-semantic call site (window math, TTLs) draws its clock from a
TimeSource instead of the `time` module, so tests can pin it. The skewable
process clock of the reference waits for the slice that ports the runner.
"""

from __future__ import annotations

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


def calculate_reset(unit: Unit, now: int) -> int:
    """Seconds until the current fixed window for `unit` resets."""
    sec = unit_to_divider(unit)
    return sec - now % sec
