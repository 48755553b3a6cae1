"""Port of api_ratelimit_tpu/models/config.py (unchanged semantics).

Config-side data models.

Reference parity: src/config/config.go:11-32 (RateLimit, RateLimitStats,
RateLimitConfigError) and the per-rule stats paths created at
src/config/config_impl.go:64-71.
"""

from __future__ import annotations

from dataclasses import dataclass

from .response import RateLimitValue
from .units import Unit


class ConfigError(Exception):
    """A rate limit configuration error (RateLimitConfigError in the
    reference). Raised during load; callers keep the last good config."""


# Canonical per-rule decision algorithms and their wire ids — the SAME ids
# ops/slab.py carries in bits 28-30 of the divider word (tests pin the
# equivalence; redeclared here so the config layer never imports torch).
# fixed_window is the reference semantics and the default; the rest are the
# sibling kernels: sliding_window (two-window interpolation — no 2x
# boundary burst), gcra (token bucket via theoretical arrival time), and
# concurrency (in-flight cap with a Release path).
ALGORITHM_IDS = {
    "fixed_window": 0,
    "sliding_window": 1,
    "gcra": 2,
    "concurrency": 3,
}
ALGO_ID_FIXED_WINDOW = 0
ALGO_ID_SLIDING_WINDOW = 1
ALGO_ID_GCRA = 2
ALGO_ID_CONCURRENCY = 3

# Idle TTL for concurrency rows when CONCURRENCY_TTL_S is not configured:
# a key whose holders all died without releasing stops being touched and
# its whole row is reclaimed after this long — the leak bound.
DEFAULT_CONCURRENCY_TTL_S = 60


@dataclass(slots=True)
class RateLimitStats:
    """Per-rule counters: total_hits / over_limit / near_limit /
    over_limit_with_local_cache (src/config/config_impl.go:64-71), plus
    shadow_mode — hits that would have been rejected but were let through
    because the rule runs in shadow mode (BASELINE configs[3])."""

    total_hits: "Counter"
    over_limit: "Counter"
    near_limit: "Counter"
    over_limit_with_local_cache: "Counter"
    shadow_mode: "Counter"


def new_rate_limit_stats(scope, key: str) -> RateLimitStats:
    return RateLimitStats(
        total_hits=scope.counter(key + ".total_hits"),
        over_limit=scope.counter(key + ".over_limit"),
        near_limit=scope.counter(key + ".near_limit"),
        over_limit_with_local_cache=scope.counter(key + ".over_limit_with_local_cache"),
        shadow_mode=scope.counter(key + ".shadow_mode"),
    )


@dataclass(slots=True)
class RateLimit:
    """A resolved rate limit rule.

    full_key is the dotted composite path (e.g. "domain.key_value.key2"),
    used both for stats attribution and debugging. sleep_on_throttle and
    report_details are Kentik fork extras (src/config/config.go:26-32).
    shadow_mode evaluates and counts the rule but never enforces it: the
    descriptor status is always OK, so operators can stage limits against
    live traffic before turning them on.

    algorithm selects the decision kernel (ALGORITHM_IDS above;
    "fixed_window" default). window_override_s, when nonzero, replaces
    the unit-derived window length — concurrency rules carry their idle
    TTL here (they have no unit; the loader rejects one).
    """

    full_key: str
    stats: RateLimitStats
    limit: RateLimitValue
    sleep_on_throttle: bool = False
    report_details: bool = False
    shadow_mode: bool = False
    algorithm: str = "fixed_window"
    window_override_s: int = 0

    @property
    def requests_per_unit(self) -> int:
        return self.limit.requests_per_unit

    @property
    def unit(self) -> Unit:
        return self.limit.unit
