"""Port of api_ratelimit_tpu/models/units.py (unchanged semantics).

Rate limit time units.

Wire-compatible with envoy.service.ratelimit.v3 RateLimitResponse.RateLimit.Unit
(values UNKNOWN=0, SECOND=1, MINUTE=2, HOUR=3, DAY=4).

Reference parity: src/utils/utilities.go:19-32 (UnitToDivider).
"""

import enum


class Unit(enum.IntEnum):
    UNKNOWN = 0
    SECOND = 1
    MINUTE = 2
    HOUR = 3
    DAY = 4


_DIVIDERS = {
    Unit.SECOND: 1,
    Unit.MINUTE: 60,
    Unit.HOUR: 60 * 60,
    Unit.DAY: 60 * 60 * 24,
}


def unit_to_divider(unit: Unit) -> int:
    """Seconds per window for a unit. Raises on UNKNOWN (reference panics)."""
    divider = _DIVIDERS.get(unit)  # fast path: already a Unit (hot loop)
    if divider is not None:
        return divider
    try:
        return _DIVIDERS[Unit(unit)]
    except (KeyError, ValueError):
        raise ValueError(f"no divider for unit {unit!r}")


def unit_from_string(name: str) -> Unit | None:
    """Parse a YAML unit string (case-insensitive). None when not a valid,
    non-UNKNOWN unit — mirrors the validity check at src/config/config_impl.go:141-147."""
    try:
        unit = Unit[name.upper()]
    except KeyError:
        return None
    if unit == Unit.UNKNOWN:
        return None
    return unit
