"""Port of api_ratelimit_tpu/limiter/cache_key.py (unchanged semantics).

Cache key codec: descriptor -> fixed-window cache key.

Key layout (src/limiter/cache_key.go:43-73):
    "<domain>_" + "".join(f"{key}_{value}_" for entries) + str(window_start)
where window_start = (now // divider) * divider snaps the timestamp to the
unit's fixed window. A key therefore changes identity at every window
boundary, which is how the reference expires windows (Redis TTL + new key).

The TPU slab backend does not use string keys on its hot path — it
fingerprints (domain, entries, unit) and keeps the window separate — but the
codec remains the identity for the local over-limit cache, oracle backends,
and wire-compatible Redis/Memcache backends.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..models.config import RateLimit
from ..models.descriptors import Descriptor
from ..models.units import Unit, unit_to_divider


@dataclass(frozen=True, slots=True)
class CacheKey:
    key: str
    # True when the limit's unit is SECOND — routes to the per-second store
    # when one is configured (src/limiter/cache_key.go:27-35).
    per_second: bool


EMPTY = CacheKey("", False)


def generate_cache_key(
    domain: str, descriptor: Descriptor, limit: RateLimit | None, now: int
) -> CacheKey:
    if limit is None:
        return EMPTY
    divider = unit_to_divider(limit.unit)
    window_start = (now // divider) * divider
    parts = [domain]
    for entry in descriptor.entries:
        parts.append(entry.key)
        parts.append(entry.value)
    parts.append(str(window_start))
    return CacheKey("_".join(parts), limit.unit == Unit.SECOND)
