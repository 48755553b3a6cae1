"""Port of api_ratelimit_tpu/models/response.py (unchanged semantics).

Response-side data models (internal, proto-shaped).

These are lightweight dataclass twins of the envoy.service.ratelimit.v3
response messages. The hot path works on these; the transport layer converts
to/from real protobuf at the edge.

Reference parity:
  - Code / DescriptorStatus shape: rls.proto v3 (SURVEY.md section 2.2).
  - DoLimitResponse: src/limiter/cache.go:9-12 (DescriptorStatuses +
    ThrottleMillis, ThrottleMillis excluded from JSON).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from .units import Unit


class Code(enum.IntEnum):
    UNKNOWN = 0
    OK = 1
    OVER_LIMIT = 2


@dataclass(frozen=True, slots=True)
class RateLimitValue:
    """envoy RateLimitResponse.RateLimit: requests_per_unit + unit."""

    requests_per_unit: int
    unit: Unit
    name: str = ""

    def to_json(self) -> dict:
        return {
            "requests_per_unit": self.requests_per_unit,
            "unit": Unit(self.unit).name,
            **({"name": self.name} if self.name else {}),
        }


@dataclass(slots=True)
class DescriptorStatus:
    """envoy RateLimitResponse.DescriptorStatus."""

    code: Code = Code.UNKNOWN
    current_limit: RateLimitValue | None = None
    limit_remaining: int = 0
    # Seconds until the current window resets; None when no limit applied
    # (reference only sets DurationUntilReset when a limit is present,
    # src/limiter/base_limiter.go:179-195).
    duration_until_reset: int | None = None

    def to_json(self) -> dict:
        out: dict = {"code": Code(self.code).name}
        if self.current_limit is not None:
            out["current_limit"] = self.current_limit.to_json()
        out["limit_remaining"] = self.limit_remaining
        if self.duration_until_reset is not None:
            out["duration_until_reset"] = f"{self.duration_until_reset}s"
        return out


@dataclass(frozen=True, slots=True)
class HeaderValue:
    key: str
    value: str


@dataclass(slots=True)
class DoLimitResponse:
    """Result of RateLimitCache.do_limit (src/limiter/cache.go:9-12)."""

    descriptor_statuses: list[DescriptorStatus] = field(default_factory=list)
    # Server-side pacing hint; deliberately not part of the JSON detail dump
    # (`json:"-"` in the reference).
    throttle_millis: int = 0

    def to_json(self) -> dict:
        return {
            "descriptor_statuses": [s.to_json() for s in self.descriptor_statuses]
        }
