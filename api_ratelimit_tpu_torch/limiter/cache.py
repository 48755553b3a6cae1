"""Port of api_ratelimit_tpu/limiter/cache.py (unchanged semantics).

Backend seam: the cache interface every backend implements.

Reference parity: src/limiter/cache.go:15-33. A nil/None limit means the
descriptor is unchecked. flush() joins asynchronous work (used by tests and
by backends that settle asynchronously, like the reference memcache backend
and this framework's micro-batched TPU backend).

Failure contract: a backend signals ANY failure by raising CacheError —
transport exhausted its retries, circuit breaker open, device launch
failure, closed batcher. That single typed channel is what the service's
FAILURE_MODE_DENY degradation ladder keys off (backends/fallback.py):
with a ladder configured the error becomes a policy decision (deny-all /
fail-open) instead of a wire error, so backends
must never let raw OSErrors or RuntimeErrors escape do_limit.
"""

from __future__ import annotations

from typing import Protocol, Sequence

from ..models.config import RateLimit
from ..models.descriptors import RateLimitRequest
from ..models.response import DoLimitResponse


class CacheError(Exception):
    """Backend failure (RedisError equivalent) — surfaced at the service
    boundary as a typed gRPC error + redis_error counter
    (src/redis/driver_impl.go:50-54, src/service/ratelimit.go:276-281)."""


class DeadlineExceededError(CacheError):
    """The request's propagated deadline (utils/deadline.py) expired before
    the backend could answer — raised by the micro-batcher when it drops
    expired items ahead of a device launch, or by the service when a
    request arrives already expired. The transport maps it to gRPC
    DEADLINE_EXCEEDED / HTTP 504: a late answer is worthless to a caller
    that already timed out, so expired work must abort, never queue.

    Subclasses CacheError so a layer that only knows the generic failure
    contract still treats it as a counted backend condition — but the
    service handles it BEFORE the FAILURE_MODE_DENY ladder (a fallback
    answer would still be late)."""


class RateLimitCache(Protocol):
    def do_limit(
        self,
        request: RateLimitRequest,
        limits: Sequence[RateLimit | None],
    ) -> DoLimitResponse: ...

    def flush(self) -> None: ...
