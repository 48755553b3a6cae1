"""Port of api_ratelimit_tpu/backends/memory.py: the in-process backend with
Redis fixed-window semantics.

Plays the role miniredis plays in the reference test suite
(test/redis/driver_impl_test.go:13-20) and doubles as a real single-process
backend (BACKEND_TYPE=memory): a dict of cache key -> (count, expire_at)
driven through the same INCRBY + EXPIRE sequence the Redis backend issues
(src/redis/fixed_cache_impl.go:26-29), with the same BaseRateLimiter decision
path. The chip smoke holds the CUDA backend's gRPC answers to this one.
"""

from __future__ import annotations

import itertools
import threading
from typing import Sequence

from ..assertx import assert_
from ..limiter.base_limiter import BaseRateLimiter, LimitInfo
from ..models.config import RateLimit
from ..models.descriptors import RateLimitRequest
from ..models.response import DescriptorStatus, DoLimitResponse
from ..models.units import unit_to_divider
from ..tracing import tag_do_limit_start


class MemoryRateLimitCache:
    def __init__(self, base_limiter: BaseRateLimiter, max_keys: int = 1 << 20):
        self._base = base_limiter
        self._data: dict[str, tuple[int, int]] = {}
        self._max_keys = max_keys
        self._high_water = max_keys
        self._lock = threading.Lock()

    def _incrby_expire(self, key: str, hits: int, expiration_seconds: int, now: int) -> int:
        """INCRBY key hits; EXPIRE key ttl — returns the post-increment count."""
        with self._lock:
            entry = self._data.get(key)
            count = 0
            if entry is not None and entry[1] > now:
                count = entry[0]
            count += hits
            self._data[key] = (count, now + expiration_seconds)
            if len(self._data) > self._high_water:
                self._sweep_expired(now)
            return count

    def _sweep_expired(self, now: int) -> None:
        dead = [k for k, (_, exp) in self._data.items() if exp <= now]
        for k in dead:
            del self._data[k]
        if len(self._data) > self._max_keys:
            # Hard bound: evict oldest-inserted live entries (fail-open for
            # the evicted keys, matching the reference's posture on backend
            # data loss). Raise max_keys if this ever triggers in practice.
            overflow = len(self._data) - self._max_keys
            for k in list(itertools.islice(iter(self._data), overflow)):
                del self._data[k]
        # Re-arm the sweep trigger above the current size so a full scan does
        # not run on every insert while the table sits near its cap.
        self._high_water = max(self._max_keys, int(len(self._data) * 1.25))

    def do_limit(
        self,
        request: RateLimitRequest,
        limits: Sequence[RateLimit | None],
    ) -> DoLimitResponse:
        hits_addend = max(1, request.hits_addend)
        cache_keys = self._base.generate_cache_keys(request, limits, hits_addend)
        now = self._base.time_source.unix_now()

        tag_do_limit_start("memory", len(limits), len(cache_keys))

        n = len(request.descriptors)
        over_local = [False] * n
        results = [0] * n
        for i, cache_key in enumerate(cache_keys):
            if cache_key.key == "":
                continue
            if self._base.is_over_limit_with_local_cache(cache_key.key, limits[i]):
                over_local[i] = True
                continue
            expiration = self._base.expiration_seconds(
                unit_to_divider(limits[i].unit)
            )
            results[i] = self._incrby_expire(cache_key.key, hits_addend, expiration, now)

        response = DoLimitResponse(
            descriptor_statuses=[DescriptorStatus() for _ in range(n)]
        )
        for i, cache_key in enumerate(cache_keys):
            info = (
                LimitInfo(limits[i], results[i] - hits_addend, results[i])
                if limits[i] is not None
                else None
            )
            response.descriptor_statuses[i] = self._base.get_response_descriptor_status(
                cache_key.key, info, over_local[i], hits_addend, response
            )
        assert_(len(response.descriptor_statuses) == n)
        return response

    def flush(self) -> None:
        """No async work — reads and updates are synchronous (like Redis)."""
