"""Port of api_ratelimit_tpu/models/descriptors.py (unchanged semantics).

Request-side data models (internal, proto-shaped).

Lightweight twins of envoy.extensions.common.ratelimit.v3.RateLimitDescriptor
and envoy.service.ratelimit.v3.RateLimitRequest. Entries are stored as plain
tuples so a Descriptor is hashable and cheap to fingerprint.
"""

from __future__ import annotations

from dataclasses import dataclass

from .units import Unit


@dataclass(frozen=True, slots=True)
class Entry:
    key: str
    value: str = ""


@dataclass(frozen=True, slots=True)
class LimitOverride:
    """Request-level limit override (descriptor.limit in the v3 proto);
    handled at src/config/config_impl.go:281-290."""

    requests_per_unit: int
    unit: Unit


@dataclass(frozen=True, slots=True)
class Descriptor:
    entries: tuple[Entry, ...] = ()
    limit: LimitOverride | None = None

    @staticmethod
    def of(*pairs: tuple[str, str]) -> "Descriptor":
        return Descriptor(entries=tuple(Entry(k, v) for k, v in pairs))


@dataclass(frozen=True, slots=True)
class RateLimitRequest:
    domain: str = ""
    descriptors: tuple[Descriptor, ...] = ()
    hits_addend: int = 0
