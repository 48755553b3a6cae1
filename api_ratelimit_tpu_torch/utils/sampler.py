"""Port of api_ratelimit_tpu/utils/sampler.py (unchanged semantics).

Event samplers used for detail-header sampling.

Reference parity: src/utils/sampler.go (zerolog-derived Random/Basic/Burst
samplers; BurstSampler wired as the report-details sampler at
src/service/ratelimit.go:324-328).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Protocol


class Sampler(Protocol):
    def sample(self) -> bool:
        """True when the event should be included in the sample."""
        ...


class RandomSampler:
    """Pass ~1 out of every N events at random."""

    def __init__(self, n: int):
        self.n = int(n)

    def sample(self) -> bool:
        if self.n <= 0:
            return False
        return random.randrange(self.n) == 0


class BasicSampler:
    """Pass every Nth event."""

    def __init__(self, n: int):
        self.n = int(n)
        self._counter = 0
        self._lock = threading.Lock()

    def sample(self) -> bool:
        if self.n <= 0:
            return False
        if self.n == 1:
            return True
        with self._lock:
            self._counter += 1
            return self._counter % self.n == 1


class BurstSampler:
    """Pass up to `burst` events per `period_seconds`, then defer to
    next_sampler (reject when next_sampler is None)."""

    def __init__(self, burst: int, period_seconds: float, next_sampler: Sampler | None = None):
        self.burst = int(burst)
        self.period_ns = int(period_seconds * 1e9)
        self.next_sampler = next_sampler
        self._counter = 0
        self._reset_at = 0
        self._lock = threading.Lock()

    def sample(self) -> bool:
        if self.burst > 0 and self.period_ns > 0:
            if self._inc() <= self.burst:
                return True
        if self.next_sampler is None:
            return False
        return self.next_sampler.sample()

    def _inc(self) -> int:
        now = time.monotonic_ns()
        with self._lock:
            if now > self._reset_at:
                self._counter = 1
                self._reset_at = now + self.period_ns
            else:
                self._counter += 1
            return self._counter


# Shorthand samplers (reference: Often/Sometimes/Rarely).
OFTEN = RandomSampler(10)
SOMETIMES = RandomSampler(100)
RARELY = RandomSampler(1000)
