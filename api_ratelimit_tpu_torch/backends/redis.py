"""Port of api_ratelimit_tpu/backends/redis.py (unchanged): the Redis parity
backend, fixed-window INCRBY + EXPIRE over the wire.

Mirror of src/redis/fixed_cache_impl.go on the from-scratch RESP driver
(redis_driver.py): per key append `INCRBY key hits` + `EXPIRE key ttl`
(:26-29), skip empty keys and local-cache hits (:55-65), jittered expiry
(:69-72), route SECOND-unit keys to the optional per-second client
(:75-85), execute both pipelines in one RTT each (:91-99), then compute
each status through the shared BaseRateLimiter with before = after - hits
(:108-117). Serves as a live oracle for the H100 engine (backends/cuda.py),
reached over the wire, and completes BACKEND_TYPE=redis capability parity.
"""

from __future__ import annotations

from typing import Sequence

from ..limiter.base_limiter import BaseRateLimiter, LimitInfo
from ..models.config import RateLimit
from ..models.descriptors import RateLimitRequest
from ..models.response import DescriptorStatus, DoLimitResponse
from ..models.units import unit_to_divider
from ..tracing import tag_do_limit_start
from .redis_driver import RedisClient, RedisClusterClient


class RedisRateLimitCache:
    def __init__(
        self,
        client,
        base_limiter: BaseRateLimiter,
        per_second_client=None,
    ):
        self._client = client
        self._per_second_client = per_second_client
        self._base = base_limiter

    def do_limit(
        self,
        request: RateLimitRequest,
        limits: Sequence[RateLimit | None],
    ) -> DoLimitResponse:
        hits_addend = max(1, request.hits_addend)
        cache_keys = self._base.generate_cache_keys(request, limits, hits_addend)

        span = tag_do_limit_start("redis", len(limits), len(cache_keys))

        n = len(request.descriptors)
        over_local = [False] * n
        main_cmds, main_idx = [], []
        second_cmds, second_idx = [], []
        for i, cache_key in enumerate(cache_keys):
            if cache_key.key == "":
                continue
            if self._base.is_over_limit_with_local_cache(cache_key.key, limits[i]):
                over_local[i] = True
                continue
            expiration = self._base.expiration_seconds(
                unit_to_divider(limits[i].unit)
            )
            if self._per_second_client is not None and cache_key.per_second:
                cmds, idx = second_cmds, second_idx
            else:
                cmds, idx = main_cmds, main_idx
            cmds.append(("INCRBY", cache_key.key, hits_addend))
            cmds.append(("EXPIRE", cache_key.key, expiration))
            idx.append(i)

        results = [0] * n
        if span is not None:
            span.log_kv(event="lookup.start")
        for name, client, cmds, idx in (
            ("main", self._client, main_cmds, main_idx),
            ("per_second", self._per_second_client, second_cmds, second_idx),
        ):
            if not cmds:
                continue
            try:
                replies = client.pipe_do(cmds)
            except Exception as e:
                # error-tag the span on the failure path, not just log
                # events on success (the do_limit span audit)
                if span is not None:
                    span.set_error(e)
                raise
            for j, i in enumerate(idx):
                results[i] = int(replies[2 * j])  # INCRBY reply; EXPIRE ignored
            if span is not None:
                span.log_kv(event="redis.lookup.done", client=name)

        response = DoLimitResponse()
        for i, cache_key in enumerate(cache_keys):
            limit_info = None
            if cache_key.key != "" and not over_local[i]:
                limit_info = LimitInfo(
                    limits[i], before=results[i] - hits_addend, after=results[i]
                )
            elif over_local[i]:
                limit_info = LimitInfo(limits[i], before=0, after=0)
            response.descriptor_statuses.append(
                self._base.get_response_descriptor_status(
                    cache_key.key, limit_info, over_local[i], hits_addend, response
                )
            )
        return response

    def flush(self) -> None:  # synchronous backend (fixed_cache_impl.go:126)
        pass


def new_redis_client_from_settings(settings, stats_store, per_second: bool):
    """Build one client from the main or per-second settings block
    (src/redis/cache_impl.go:13-31)."""
    scope = stats_store.scope("ratelimit").scope(
        "redis_per_second_pool" if per_second else "redis_pool"
    )
    prefix = "redis_per_second" if per_second else "redis"

    def get(name):
        return getattr(settings, f"{prefix}_{name}")

    if get("type").upper() == "CLUSTER":
        return RedisClusterClient(
            url=get("url"),
            pool_size=get("pool_size"),
            auth=get("auth"),
            use_tls=get("tls"),
            stats_scope=scope,
        )
    return RedisClient(
        socket_type=get("socket_type"),
        url=get("url"),
        pool_size=get("pool_size"),
        auth=get("auth"),
        use_tls=get("tls"),
        pipeline_window_seconds=get("pipeline_window"),
        pipeline_limit=get("pipeline_limit"),
        stats_scope=scope,
        redis_type=get("type"),
    )


def new_redis_cache_from_settings(
    settings, base_limiter: BaseRateLimiter, stats_store
) -> RedisRateLimitCache:
    per_second_client = None
    if settings.redis_per_second:
        per_second_client = new_redis_client_from_settings(
            settings, stats_store, per_second=True
        )
    client = new_redis_client_from_settings(settings, stats_store, per_second=False)
    return RedisRateLimitCache(client, base_limiter, per_second_client)
