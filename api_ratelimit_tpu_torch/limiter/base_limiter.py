"""Port of api_ratelimit_tpu/limiter/base_limiter.py (unchanged semantics).

Backend-agnostic fixed-window decision algorithm (host scalar path).

This is the semantic oracle for the framework: the TPU slab engine's
vectorized decision math (ops/decide.py) must agree with this module
decision-for-decision; differential tests enforce it.

Reference parity: src/limiter/base_limiter.go —
  * generate_cache_keys           (:39-54)
  * is_over_limit_with_local_cache(:57-66)
  * get_response_descriptor_status(:70-115), including:
      - near threshold = floor(limit * near_limit_ratio)   (:83-86)
      - OVER_LIMIT stats attribution split                  (:129-145)
      - OK near-limit accounting + ThrottleMillis pacing    (:154-177)
      - DurationUntilReset                                  (:179-195)
"""

from __future__ import annotations

import math
import random
import struct
from typing import Sequence

from ..assertx import assert_
from ..models.config import RateLimit
from ..models.descriptors import RateLimitRequest
from ..models.response import Code, DescriptorStatus, DoLimitResponse
from ..models.units import Unit, unit_to_divider
from ..utils.timeutil import TimeSource, calculate_reset
from .cache_key import EMPTY, CacheKey, generate_cache_key
from .local_cache import LocalCache


# Preallocated status template for unchecked descriptors (no matching
# rule): every field is request-independent, so all backends share ONE
# instance instead of constructing an identical dataclass per descriptor.
# Treat as frozen — transports and tests only read statuses.
UNCHECKED_STATUS = DescriptorStatus(
    code=Code.OK, current_limit=None, limit_remaining=0
)


class LimitInfo:
    __slots__ = ("limit", "before", "after", "near_threshold", "over_threshold")

    def __init__(self, limit: RateLimit, before: int, after: int):
        self.limit = limit
        self.before = before
        self.after = after
        self.near_threshold = 0
        self.over_threshold = 0


class BaseRateLimiter:
    def __init__(
        self,
        time_source: TimeSource,
        jitter_rand: random.Random | None = None,
        expiration_jitter_max_seconds: int = 0,
        local_cache: LocalCache | None = None,
        near_limit_ratio: float = 0.8,
    ):
        self.time_source = time_source
        self.jitter_rand = jitter_rand or random.Random()
        self.expiration_jitter_max_seconds = int(expiration_jitter_max_seconds)
        self.local_cache = local_cache
        self.near_limit_ratio = float(near_limit_ratio)
        self._near_ratio_f32 = _f32(self.near_limit_ratio)
        # rpu -> floor(f32(rpu) * f32(ratio)); the rule set is small and
        # static between reloads, so this stays tiny
        self._near_threshold_cache: dict[int, int] = {}

    def _near_threshold(self, requests_per_unit: int) -> int:
        """nearLimitThreshold (base_limiter.go:83-86): float32 multiply to
        match the reference's float32 math, memoized per limit value."""
        threshold = self._near_threshold_cache.get(requests_per_unit)
        if threshold is None:
            threshold = int(
                math.floor(_f32(_f32(requests_per_unit) * self._near_ratio_f32))
            )
            # bound: requests_per_unit can be a client-supplied request-level
            # override (config/loader.py get_limit), so the key space is
            # attacker-controlled; dump and restart rather than grow forever
            if len(self._near_threshold_cache) >= 4096:
                self._near_threshold_cache.clear()
            self._near_threshold_cache[requests_per_unit] = threshold
        return threshold

    # -- key generation --

    def generate_cache_keys(
        self,
        request: RateLimitRequest,
        limits: Sequence[RateLimit | None],
        hits_addend: int,
    ) -> list[CacheKey]:
        assert_(len(request.descriptors) == len(limits))
        now = self.time_source.unix_now()
        checked = [i for i, limit in enumerate(limits) if limit is not None]
        for i in checked:
            limits[i].stats.total_hits.add(hits_addend)

        # batched native key composition (ops/native.py) when the request
        # is big enough to amortize the FFI call; byte-identical to the
        # Python codec below
        if len(checked) >= 8:
            from ..ops import native

            if native.available():
                records, windows = [], []
                for i in checked:
                    divider = unit_to_divider(limits[i].unit)
                    records.append(
                        native.record_strings(request.domain, request.descriptors[i].entries)
                    )
                    windows.append((now // divider) * divider)
                composed = native.compose_keys_batch(records, windows)
                keys = [EMPTY] * len(limits)
                for key_str, i in zip(composed, checked):
                    keys[i] = CacheKey(key_str, limits[i].unit == Unit.SECOND)
                return keys

        return [
            generate_cache_key(request.domain, descriptor, limit, now)
            for descriptor, limit in zip(request.descriptors, limits)
        ]

    # -- local cache --

    def is_over_limit_with_local_cache(self, key: str, limit: RateLimit | None = None) -> bool:
        # A shadow-mode rule never consults the cache: an entry seeded while
        # the rule was still enforced (then flipped by a hot reload) would
        # otherwise short-circuit evaluation for up to a full window and
        # fabricate the staging metrics the operator is watching.
        if limit is not None and limit.shadow_mode:
            return False
        # only fixed_window denials are sticky for the rest of a window,
        # so only fixed_window consults the cache. For every sibling
        # algorithm a cached "over" entry would deny traffic the
        # algorithm itself admits: a concurrency Release can free a slot
        # immediately, a GCRA TAT drains continuously (unit=hour,
        # limit=3600 re-admits one request per second), and a sliding
        # interpolated position decays mid-window.
        if limit is not None and limit.algorithm != "fixed_window":
            return False
        return self.local_cache is not None and self.local_cache.contains(key)

    def expiration_seconds(self, divider: int) -> int:
        """Window TTL plus optional herd-avoidance jitter
        (src/redis/fixed_cache_impl.go:69-72)."""
        expiration = divider
        if self.expiration_jitter_max_seconds > 0:
            expiration += self.jitter_rand.randrange(self.expiration_jitter_max_seconds)
        return expiration

    # -- decision --

    def get_response_descriptor_status(
        self,
        key: str,
        limit_info: LimitInfo | None,
        is_over_limit_with_local_cache: bool,
        hits_addend: int,
        response: DoLimitResponse | None,
    ) -> DescriptorStatus:
        if key == "":
            return UNCHECKED_STATUS

        limit = limit_info.limit
        now = self.time_source.unix_now()

        if is_over_limit_with_local_cache:
            limit.stats.over_limit.add(hits_addend)
            limit.stats.over_limit_with_local_cache.add(hits_addend)
            return DescriptorStatus(
                code=self._enforced_code(limit, hits_addend),
                current_limit=limit.limit,
                limit_remaining=0,
                duration_until_reset=calculate_reset(limit.unit, now),
            )

        limit_info.over_threshold = limit.requests_per_unit
        limit_info.near_threshold = self._near_threshold(limit.requests_per_unit)

        if limit_info.after > limit_info.over_threshold:
            status = DescriptorStatus(
                code=self._enforced_code(limit, hits_addend),
                current_limit=limit.limit,
                limit_remaining=0,
                duration_until_reset=calculate_reset(limit.unit, now),
            )
            self._check_over_limit_threshold(limit_info, hits_addend)
            if (
                self.local_cache is not None
                and not limit.shadow_mode
                and limit.algorithm == "fixed_window"
            ):
                # TTL = the full unit duration; the window-stamped key ages out
                # naturally at the window boundary. Shadow-mode rules skip the
                # cache: its hits short-circuit evaluation, and a staged rule
                # must keep counting real traffic. Non-fixed algorithms never
                # seed it — their denials are not sticky for a window (the
                # is_over_limit_with_local_cache rationale above).
                self.local_cache.set(key, unit_to_divider(limit.unit))
        else:
            status = DescriptorStatus(
                code=Code.OK,
                current_limit=limit.limit,
                limit_remaining=limit_info.over_threshold - limit_info.after,
                duration_until_reset=calculate_reset(limit.unit, now),
            )
            self._check_near_limit_threshold(limit_info, hits_addend, now, response)
        return status

    @staticmethod
    def _enforced_code(limit: RateLimit, hits_addend: int) -> Code:
        """OVER_LIMIT, unless the rule is staged in shadow mode: then the
        breach is counted (shadow_mode stat) but the caller is let through."""
        if limit.shadow_mode:
            limit.stats.shadow_mode.add(hits_addend)
            return Code.OK
        return Code.OVER_LIMIT

    @staticmethod
    def _check_over_limit_threshold(limit_info: LimitInfo, hits_addend: int) -> None:
        # If the counter was already over the threshold before this addend,
        # every hit in the addend was over limit; otherwise split the addend
        # into its over-limit and near-limit portions.
        stats = limit_info.limit.stats
        if limit_info.before >= limit_info.over_threshold:
            stats.over_limit.add(hits_addend)
        else:
            stats.over_limit.add(limit_info.after - limit_info.over_threshold)
            stats.near_limit.add(
                limit_info.over_threshold
                - max(limit_info.near_threshold, limit_info.before)
            )

    def _check_near_limit_threshold(
        self,
        limit_info: LimitInfo,
        hits_addend: int,
        now: int,
        response: DoLimitResponse | None,
    ) -> None:
        if limit_info.after <= limit_info.near_threshold:
            return

        # Pacing: spread the remaining calls across the remainder of the
        # window; callers sleeping this long will not trip the limit.
        divider = unit_to_divider(limit_info.limit.unit)
        window_end = (now // divider) * divider + divider
        millis_remaining = (window_end - now) * 1000
        calls_remaining = max(limit_info.over_threshold - limit_info.after, 1)
        throttle_millis = millis_remaining // calls_remaining
        if response is not None and throttle_millis > response.throttle_millis:
            response.throttle_millis = throttle_millis

        stats = limit_info.limit.stats
        if limit_info.before >= limit_info.near_threshold:
            stats.near_limit.add(hits_addend)
        else:
            stats.near_limit.add(limit_info.after - limit_info.near_threshold)


def _f32(x: float) -> float:
    """Round a python float through IEEE float32, matching Go's float32 math."""
    return struct.unpack("f", struct.pack("f", x))[0]
