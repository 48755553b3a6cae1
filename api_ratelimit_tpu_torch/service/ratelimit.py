"""Port of api_ratelimit_tpu/service/ratelimit.py: ShouldRateLimit orchestration.

Validation, config snapshot, per-descriptor rule resolution, cache do_limit,
server-side throttle sleeping, overall-code aggregation and sampled detail
headers, as in the reference (src/service/ratelimit.go). The worker raises
typed exceptions; should_rate_limit counts them (`redis_error` /
`service_error`) and re-raises for the transport to map.

With host_fast_path (the default, HOST_FAST_PATH) each descriptor resolves
through the config's compiled matcher into a ResolvedLimit record and the
cache's do_limit_resolved; host_fast_path=False keeps the trie walk and
do_limit.

Around the cache call, as in the reference: the deadline abort and the
brownout shed before any config work, the shed postures (OVERLOAD_SHED_MODE)
for an OverloadError, the failure-mode ladder (FAILURE_MODE_DENY) for any
other CacheError, the request's journey (tracing/journeys.py) and the
active span's events and error tags, and the latency exemplar. The
reference's lease consultation comes with leases (ROADMAP item 8).
"""

from __future__ import annotations

import base64
import json
import logging
import threading
import time
from typing import Callable, Protocol, Sequence

from ..assertx import assert_
from ..backends.overload import (
    SHED_MODE_ALLOW,
    SHED_MODE_DENY,
    BrownoutError,
    OverloadError,
)
from ..config.loader import ConfigFile, RateLimitConfig, load_config
from ..limiter.cache import CacheError, DeadlineExceededError, RateLimitCache
from ..models.config import ConfigError, RateLimit
from ..models.descriptors import RateLimitRequest
from ..models.response import Code, DescriptorStatus, DoLimitResponse, HeaderValue
from ..stats.store import HOST_STAGE_BUCKETS_MS
from ..tracing import active_span, journeys
from ..utils import deadline as request_deadline
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


def _limits_of(limits, resolved) -> Sequence[RateLimit | None]:
    """Materialize the per-descriptor RateLimit list on the cold paths
    that still need one (shed / fallback answers); the fast path carries
    ResolvedLimit records instead and skips the allocation."""
    if limits is not None:
        return limits
    return [r.limit if r is not None else None for r in resolved]


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
        fallback=None,
        overload=None,
        draining_probe: Callable[[], bool] | None = None,
        host_fast_path: bool = True,
    ):
        """config_loader turns the runtime's files into a RateLimitConfig;
        the default parses them as YAML (config/loader.py load_config).

        fallback: optional backends.fallback.FallbackLimiter, the
        FAILURE_MODE_DENY ladder. When set, a backend CacheError no longer
        propagates: redis_error is still counted, and the fallback answers
        the request (deny-all / fail-open). None
        keeps the raise-through.

        overload: optional backends.overload.AdmissionController. Requests
        arriving during a brownout are shed before any descriptor work,
        and an OverloadError from the backend (queue full) is answered by
        the configured shed posture instead of the failure ladder. None
        treats OverloadError like any CacheError.

        draining_probe: () -> True while the server is draining (health
        flipped for shutdown); throttle pacing sleeps are skipped then.

        host_fast_path: resolve descriptors through the config's compiled
        matcher and answer through cache.do_limit_resolved when the cache
        has one (HOST_FAST_PATH); False keeps the trie walk and do_limit."""
        self._runtime = runtime
        self._cache = cache
        self._do_limit_resolved = (
            getattr(cache, "do_limit_resolved", None) if host_fast_path else None
        )
        self._fallback = fallback
        self._overload = overload
        self._draining_probe = draining_probe
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
        # Test hook: extra seconds slept inside every should_rate_limit,
        # which forces a request into the latency histogram's top bucket to
        # exercise exemplar capture and span force-sampling
        self.debug_inject_latency_s: float = 0.0
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
        CacheError / ServiceError after counting them.

        Every call, success or error, lands in the latency_ms histogram. A
        request that falls in the top (overflow) bucket attaches its trace
        id as an exemplar and force-samples the active span, so the p99
        tail in /metrics links to a span in /debug/traces. When a journey
        recorder is registered (tracing/journeys.py) the request's stage
        itinerary is recorded here too, tail-sampled by outcome into
        /debug/journeys."""
        t_start = time.perf_counter()
        journey = None
        recorder = journeys.global_recorder()
        if recorder is not None:
            span0 = active_span()
            if span0 is not None:
                ctx = span0.context
                journey = recorder.begin(
                    "request", trace_id=ctx.trace_id, span_id=ctx.span_id
                )
            else:
                journey = recorder.begin("request")
        journey_flag = None
        overall_code = None
        try:
            result = self._worker(request)
            overall_code = result[0]
            return result
        except DeadlineExceededError as e:
            # shed, not a backend failure: no redis_error (the drop is
            # counted in overload.deadline_expired where it happened); the
            # transport maps it to DEADLINE_EXCEEDED / 504
            journey_flag = journeys.FLAG_DEADLINE
            span = active_span()
            if span is not None:
                span.set_error(e)
            raise
        except OverloadError as e:
            # the unavailable posture (or no controller): UNAVAILABLE / 503,
            # counted in overload.shed at the shed decision, never as
            # redis_error
            journey_flag = journeys.FLAG_SHED
            span = active_span()
            if span is not None:
                span.set_error(e)
            raise
        except CacheError as e:
            self._stats.redis_error.add(1)
            journey_flag = journeys.FLAG_FAULT
            span = active_span()
            if span is not None:
                span.set_error(e)
            raise
        except ServiceError as e:
            self._stats.service_error.add(1)
            journey_flag = journeys.FLAG_FAULT
            span = active_span()
            if span is not None:
                span.set_error(e)
            raise
        except Exception as e:
            # the reference's recovery counts any panic as serviceError and
            # returns a typed error (ratelimit.go:260-290)
            self._stats.service_error.add(1)
            journey_flag = journeys.FLAG_FAULT
            span = active_span()
            if span is not None:
                span.set_error(e)
            logger.exception("unexpected error in should_rate_limit")
            raise ServiceError(f"unexpected error: {e}") from e
        finally:
            if self.debug_inject_latency_s > 0:  # test hook (see __init__)
                self._time_source.sleep(self.debug_inject_latency_s)
            ms = (time.perf_counter() - t_start) * 1e3
            exemplar = None
            if self._stats.latency.is_slow(ms):
                span = active_span()
                if span is not None and span.tracer is not None:
                    exemplar = f"{span.context.trace_id:032x}"
                    span.force_sample()
            self._stats.latency.record(ms, exemplar=exemplar)
            if journey is not None:
                flags = [journey_flag] if journey_flag else []
                if overall_code == Code.OVER_LIMIT:
                    flags.append(journeys.FLAG_OVER_LIMIT)
                recorder.finish(journey, ms, flags)

    def _worker(
        self, request: RateLimitRequest
    ) -> tuple[Code, list, list[HeaderValue]]:
        span = active_span()
        if span is not None:
            span.log_kv(event="shouldRateLimitWorker.start")
        try:
            result = self._worker_inner(request)
        except BaseException:
            if span is not None:
                span.log_kv(event="shouldRateLimitWorker.done")
            raise
        if span is not None:
            span.log_kv(
                event="shouldRateLimitWorker.done",
                response_code=int(result[0]),
            )
        return result

    def _worker_inner(
        self, request: RateLimitRequest
    ) -> tuple[Code, list, list[HeaderValue]]:
        if request.domain == "":
            raise ServiceError("rate limit domain must not be empty")
        if not request.descriptors:
            raise ServiceError("rate limit descriptor list must not be empty")
        # admission control, cheapest first (backends/overload.py): a
        # request whose propagated deadline already passed aborts now, and
        # a brownout sheds before any config or descriptor work
        if request_deadline.expired():
            if self._overload is not None:
                self._overload.note_deadline_expired()
            raise DeadlineExceededError(
                "request deadline expired before dispatch"
            )
        if self._overload is not None and self._overload.should_shed():
            return self._shed_answer(
                request,
                (),
                BrownoutError("admission brownout: shedding pre-dispatch"),
            )
        config = self.get_current_config()
        if config is None:
            raise ServiceError("no rate limit configuration loaded")

        sleep_on_throttle = False
        report_details = False
        debug = logger.isEnabledFor(logging.DEBUG)
        resolved = None
        limits: list[RateLimit | None] | None = None
        if self._do_limit_resolved is not None:
            # one memoized matcher lookup per descriptor yields the full
            # precomputed record; `limits` is materialized only on the
            # cold paths that need it (_limits_of)
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
        else:
            limits = []
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

        try:
            if resolved is not None:
                do_limit_response = self._do_limit_resolved(request, resolved)
            else:
                do_limit_response = self._cache.do_limit(request, limits)
        except DeadlineExceededError:
            # expired in the batcher queue or the dispatch ring: abort,
            # never answer late, and never consult the failure ladder (its
            # answer would still be late)
            raise
        except OverloadError as e:
            # pressure, not failure: answered by the OVERLOAD_SHED_MODE
            # posture; without a controller it surfaces (UNAVAILABLE).
            # Overload never reaches the failure ladder, which would misread
            # pressure as a dead card.
            if self._overload is None:
                raise
            return self._shed_answer(request, _limits_of(limits, resolved), e)
        except CacheError as e:
            # the failure ladder (FAILURE_MODE_DENY): a failed launch
            # degrades to a policy decision instead of an error storm.
            # redis_error is counted here because the exception no longer
            # reaches the boundary counter in should_rate_limit.
            if self._fallback is None:
                raise
            self._stats.redis_error.add(1)
            span = active_span()
            if span is not None:
                span.log_kv(event="fallback", failure_mode=self._fallback.mode)
            do_limit_response = self._fallback.do_limit(
                request, _limits_of(limits, resolved), e
            )
        else:
            if self._fallback is not None:
                self._fallback.note_success()
            if self._overload is not None:
                self._overload.note_ok()
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

    def _shed_answer(
        self,
        request: RateLimitRequest,
        limits: Sequence[RateLimit | None],
        error: OverloadError,
    ) -> tuple[Code, list, list[HeaderValue]]:
        """Answer one shed request by the configured posture
        (OVERLOAD_SHED_MODE): `unavailable` re-raises (a retriable
        UNAVAILABLE), `allow` fails open with an `x-ratelimit-shed` header
        so upstreams can tell a shed OK from an enforced one, `deny` answers
        OVER_LIMIT for every descriptor. The statuses mirror
        FallbackLimiter's: the two ladders share response semantics and
        differ in their cause."""
        overload = self._overload
        overload.note_shed(error)
        # the allow and deny postures answer without raising, so the
        # journey's shed flag is noted here (the unavailable posture
        # re-raises and is flagged at the should_rate_limit boundary)
        journeys.note_flag(journeys.FLAG_SHED)
        span = active_span()
        if span is not None:
            span.log_kv(
                event="overload_shed",
                shed_mode=overload.shed_mode,
                cause=error.token,
            )
        if overload.shed_mode == SHED_MODE_ALLOW:
            code = Code.OK
        elif overload.shed_mode == SHED_MODE_DENY:
            code = Code.OVER_LIMIT
        else:  # unavailable: the wire error is the policy
            raise error
        statuses = []
        for i in range(len(request.descriptors)):
            limit = limits[i] if i < len(limits) else None
            statuses.append(
                DescriptorStatus(
                    code=code,
                    current_limit=limit.limit if limit is not None else None,
                    limit_remaining=0,
                )
            )
        return code, statuses, [HeaderValue("x-ratelimit-shed", error.token)]

    def _maybe_sleep(self, do_limit_response: DoLimitResponse) -> None:
        """Server-side pacing: sleep the handler instead of answering
        immediately, bounded by the sleeper semaphore (ratelimit.go:180-205),
        traced as a child span carrying the sleep duration, with an error
        tag when the semaphore is exhausted (ratelimit.go:181-204). The
        sleep is skipped (and sleep_shed counted) while the server drains
        or the admission controller is browned out, and when every sleeper
        slot is busy: pacing never pins worker threads."""
        # as in the reference, the span opens before the semaphore check,
        # so a missing semaphore still emits an (empty) pacing span
        parent = active_span()
        throttle_span = None
        if parent is not None and parent.tracer is not None:
            throttle_span = parent.tracer.start_span(
                "sleep_on_throttle", child_of=parent
            )
            throttle_span.set_tag(
                "throttling.sleep_ms", do_limit_response.throttle_millis
            )
        try:
            if self._draining_probe is not None and self._draining_probe():
                self._stats.sleep_shed.inc()
                if throttle_span is not None:
                    throttle_span.log_kv(event="throttling.drain_shed")
                return
            if self._overload is not None and self._overload.should_shed():
                self._stats.sleep_shed.inc()
                self._overload.note_sleep_shed()
                if throttle_span is not None:
                    throttle_span.log_kv(event="throttling.overload_shed")
                return
            sem = self._sleeper_semaphore
            if sem is None:
                return
            if sem.acquire(blocking=False):
                try:
                    self._time_source.sleep(
                        do_limit_response.throttle_millis / 1000.0
                    )
                finally:
                    sem.release()
                # throttled server-side by sleeping; don't also report it
                do_limit_response.throttle_millis = 0
            else:
                self._stats.sleep_shed.inc()
                if throttle_span is not None:
                    throttle_span.log_kv(event="throttling.sem_exhausted")
                    throttle_span.set_tag("error", True)
        finally:
            if throttle_span is not None:
                throttle_span.finish()

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
