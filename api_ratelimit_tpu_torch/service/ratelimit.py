"""Port of api_ratelimit_tpu/service/ratelimit.py: ShouldRateLimit orchestration.

Validation, config snapshot, per-descriptor rule resolution, cache do_limit,
server-side throttle sleeping, overall-code aggregation and sampled detail
headers, as in the reference (src/service/ratelimit.go). The worker raises
typed exceptions; should_rate_limit counts them (`redis_error` /
`service_error`) and re-raises for the transport to map.

With host_fast_path (the default, HOST_FAST_PATH) each descriptor resolves
through the config's compiled matcher into a ResolvedLimit record and the
cache's do_limit_resolved; host_fast_path=False keeps the trie walk and
do_limit. Not ported yet, and therefore absent rather than stubbed:
admission control and shedding, the failure-mode fallback ladder, leases,
deadlines, request journeys and tracing spans.
"""

from __future__ import annotations

import base64
import json
import logging
import threading
import time
from typing import Callable, Protocol, Sequence

from ..assertx import assert_
from ..config.loader import ConfigFile, RateLimitConfig, load_config
from ..limiter.cache import CacheError, RateLimitCache
from ..models.config import ConfigError, RateLimit
from ..models.descriptors import RateLimitRequest
from ..models.response import Code, DoLimitResponse, HeaderValue
from ..stats.store import HOST_STAGE_BUCKETS_MS
from ..utils.sampler import BurstSampler, RandomSampler, Sampler
from ..utils.timeutil import TimeSource

logger = logging.getLogger("ratelimit.service")


class ServiceError(Exception):
    """Request-level error (serviceError in the reference)."""


class RuntimeSnapshot(Protocol):
    """A point-in-time view of the runtime config dir (goruntime Snapshot)."""

    def keys(self) -> Sequence[str]: ...
    def get(self, key: str) -> str: ...


class RuntimeLoader(Protocol):
    """goruntime loader.IFace equivalent (src/server/server_impl.go:191-206)."""

    def snapshot(self) -> RuntimeSnapshot: ...
    def add_update_callback(self, callback: Callable[[], None]) -> None: ...


class _ServiceStats:
    """config_load_success/error + call.should_rate_limit.{redis,service}_error
    (ratelimit.go:32-56), plus the end-to-end request latency histogram and
    the compiled-matcher resolve time per request (host.matcher_ms)."""

    def __init__(self, scope):
        self.config_load_success = scope.counter("config_load_success")
        self.config_load_error = scope.counter("config_load_error")
        call_scope = scope.scope("call.should_rate_limit")
        self.redis_error = call_scope.counter("redis_error")
        self.service_error = call_scope.counter("service_error")
        self.sleep_shed = call_scope.counter("sleep_shed")
        self.latency = call_scope.histogram("latency_ms")
        self.matcher = scope.scope("host").histogram(
            "matcher_ms", boundaries=HOST_STAGE_BUCKETS_MS
        )


class RateLimitService:
    def __init__(
        self,
        runtime: RuntimeLoader,
        cache: RateLimitCache,
        stats_scope,
        time_source: TimeSource,
        runtime_watch_root: bool = True,
        max_sleeping_routines: int = 0,
        config_loader: Callable[[list[ConfigFile]], RateLimitConfig] | None = None,
        report_detail_sampler: Sampler | None = None,
        host_fast_path: bool = True,
    ):
        """config_loader turns the runtime's files into a RateLimitConfig;
        the default parses them as YAML (config/loader.py load_config).

        host_fast_path: resolve descriptors through the config's compiled
        matcher and answer through cache.do_limit_resolved when the cache
        has one (HOST_FAST_PATH); False keeps the trie walk and do_limit."""
        self._runtime = runtime
        self._cache = cache
        self._do_limit_resolved = (
            getattr(cache, "do_limit_resolved", None) if host_fast_path else None
        )
        self._stats = _ServiceStats(stats_scope)
        # per-rule stats live under <scope>.rate_limit.<domain>.<composite>
        self._rl_stats_scope = stats_scope.scope("rate_limit")
        self._runtime_watch_root = runtime_watch_root
        self._time_source = time_source
        self._config: RateLimitConfig | None = None
        self._config_lock = threading.Lock()
        self._config_loader = config_loader or (
            lambda files: load_config(files, self._rl_stats_scope)
        )
        # sleep_on_throttle cap (MAX_SLEEPING_ROUTINES, ratelimit.go:337-341)
        self._sleeper_semaphore = (
            threading.Semaphore(max_sleeping_routines)
            if max_sleeping_routines > 0
            else None
        )
        # detail-header sampling: burst 100/s then ~1/100 (ratelimit.go:324-328)
        self._report_detail_sampler = report_detail_sampler or BurstSampler(
            burst=100, period_seconds=1.0, next_sampler=RandomSampler(100)
        )
        runtime.add_update_callback(self.reload_config)
        self.reload_config()

    # -- config lifecycle (ratelimit.go:81-110) --

    def reload_config(self) -> None:
        try:
            snapshot = self._runtime.snapshot()
            files: list[ConfigFile] = []
            for key in snapshot.keys():
                # When watching the runtime root, only keys under config/
                # are rate-limit rule files (ratelimit.go:94-102).
                if self._runtime_watch_root and not key.startswith("config."):
                    continue
                files.append(ConfigFile(name=key, contents=snapshot.get(key)))
            new_config = self._config_loader(files)
        except ConfigError as e:
            self._stats.config_load_error.add(1)
            logger.error("error loading new configuration from runtime: %s", e)
            return
        self._stats.config_load_success.add(1)
        logger.info("loaded new configuration from runtime")
        with self._config_lock:
            self._config = new_config

    def get_current_config(self) -> RateLimitConfig | None:
        with self._config_lock:
            return self._config

    # -- the hot path (ratelimit.go:124-296) --

    def should_rate_limit(self, request: RateLimitRequest):
        """Returns (overall_code, statuses, response_headers). Raises
        CacheError / ServiceError after counting them; every call lands in
        the latency_ms histogram."""
        t_start = time.perf_counter()
        try:
            return self._worker(request)
        except CacheError:
            self._stats.redis_error.add(1)
            raise
        except ServiceError:
            self._stats.service_error.add(1)
            raise
        except Exception as e:
            # the reference's recovery counts any panic as serviceError and
            # returns a typed error (ratelimit.go:260-290)
            self._stats.service_error.add(1)
            logger.exception("unexpected error in should_rate_limit")
            raise ServiceError(f"unexpected error: {e}") from e
        finally:
            self._stats.latency.record((time.perf_counter() - t_start) * 1e3)

    def _worker(
        self, request: RateLimitRequest
    ) -> tuple[Code, list, list[HeaderValue]]:
        if request.domain == "":
            raise ServiceError("rate limit domain must not be empty")
        if not request.descriptors:
            raise ServiceError("rate limit descriptor list must not be empty")
        config = self.get_current_config()
        if config is None:
            raise ServiceError("no rate limit configuration loaded")

        sleep_on_throttle = False
        report_details = False
        debug = logger.isEnabledFor(logging.DEBUG)
        if self._do_limit_resolved is not None:
            # one memoized matcher lookup per descriptor yields the full
            # precomputed record
            t0 = time.perf_counter()
            resolve = config.compiled.resolve
            domain = request.domain
            resolved = [resolve(domain, d) for d in request.descriptors]
            self._stats.matcher.record((time.perf_counter() - t0) * 1e3)
            for record in resolved:
                if record is not None:
                    sleep_on_throttle = sleep_on_throttle or record.sleep_on_throttle
                    report_details = report_details or record.report_details
                    if debug:
                        logger.debug(
                            "applying limit: %d requests per %s",
                            record.requests_per_unit,
                            record.limit.unit.name,
                        )
                elif debug:
                    logger.debug("descriptor does not match any limit")
            do_limit_response = self._do_limit_resolved(request, resolved)
        else:
            limits: list[RateLimit | None] = []
            for descriptor in request.descriptors:
                limit = config.get_limit(request.domain, descriptor)
                if debug:
                    if limit is None:
                        logger.debug("descriptor does not match any limit")
                    else:
                        logger.debug(
                            "applying limit: %d requests per %s",
                            limit.requests_per_unit,
                            limit.unit.name,
                        )
                limits.append(limit)
                if limit is not None:
                    sleep_on_throttle = sleep_on_throttle or limit.sleep_on_throttle
                    report_details = report_details or limit.report_details
            do_limit_response = self._cache.do_limit(request, limits)
        assert_(
            len(request.descriptors)
            == len(do_limit_response.descriptor_statuses)
        )

        if sleep_on_throttle and do_limit_response.throttle_millis > 0:
            self._maybe_sleep(do_limit_response)

        statuses = do_limit_response.descriptor_statuses
        overall = Code.OK
        for status in statuses:
            if status.code == Code.OVER_LIMIT:
                overall = Code.OVER_LIMIT

        headers = (
            self._detail_headers(do_limit_response) if report_details else []
        )
        return overall, statuses, headers

    def release(self, request: RateLimitRequest) -> int:
        """The concurrency Release: decrement each matched concurrency
        descriptor's in-flight count (the cache's do_release, a release row
        on the normal row-block wire). Returns how many release rows were
        submitted; descriptors that resolve to no rule or to a rule of
        another algorithm are ignored. Served over HTTP as POST /release
        (server/http_server.py); holders that never release are reclaimed
        by the rule's idle TTL."""
        if request.domain == "":
            raise ServiceError("rate limit domain must not be empty")
        if not request.descriptors:
            raise ServiceError("rate limit descriptor list must not be empty")
        config = self.get_current_config()
        if config is None:
            raise ServiceError("no rate limit configuration loaded")
        do_release = getattr(self._cache, "do_release", None)
        if do_release is None:
            return 0  # a cache without a release path
        resolved = [config.compiled.resolve(request.domain, d) for d in request.descriptors]
        return do_release(request, resolved)

    def _maybe_sleep(self, do_limit_response: DoLimitResponse) -> None:
        """Server-side pacing: sleep the handler instead of answering
        immediately, bounded by the sleeper semaphore (ratelimit.go:180-205);
        with every sleeper slot busy the sleep is shed and counted."""
        sem = self._sleeper_semaphore
        if sem is None:
            return
        if sem.acquire(blocking=False):
            try:
                self._time_source.sleep(do_limit_response.throttle_millis / 1000.0)
            finally:
                sem.release()
            # throttled server-side by sleeping; don't also report it
            do_limit_response.throttle_millis = 0
        else:
            self._stats.sleep_shed.inc()

    def _detail_headers(
        self, do_limit_response: DoLimitResponse
    ) -> list[HeaderValue]:
        """Sampled x-ratelimit-details (base64url JSON, no padding) +
        unconditional x-ratelimit-throttle-ms (ratelimit.go:221-249)."""
        headers: list[HeaderValue] = []
        if self._report_detail_sampler.sample():
            encoded = (
                base64.urlsafe_b64encode(
                    json.dumps(do_limit_response.to_json()).encode()
                )
                .rstrip(b"=")
                .decode()
            )
            headers.append(HeaderValue("x-ratelimit-details", encoded))
        if do_limit_response.throttle_millis > 0:
            headers.append(
                HeaderValue(
                    "x-ratelimit-throttle-ms",
                    str(do_limit_response.throttle_millis),
                )
            )
        return headers
