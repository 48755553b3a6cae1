"""Port of api_ratelimit_tpu/cluster/router.py: PartitionedEngineClient,
the frontend-side cluster router.

Duck-types the engine-client verb set CudaRateLimitCache drives
(``submit_rows(block, lease_ops=None)`` / ``submit`` / ``flush`` /
``close`` / ``failover_reason``), but behind it sit K per-partition
SidecarEngineClients, each with its OWN failover address list, retry
budget and circuit breaker, so one partition's primary dying promotes that
partition's standby and touches nothing else.

Routing: each submitted uint32[6, n] row block is bucketed by
``PartitionMap.partition_of(fp_lo)`` (set_index at the map's resolution),
the per-partition sub-blocks fan out concurrently, and the verdict
counters scatter back into submit order through the caller's one output
array. Blocks that land wholly in one partition (the common case: a
request's descriptors) skip the fan-out.

Map convergence: every per-partition frame is stamped with this router's
map epoch (FLAG_MAP, backends/sidecar.py). An owner holding a newer map
answers STATUS_STALE_MAP + that map; the router adopts it, re-buckets the
rejected sub-block (the write was never applied, so the resubmit is
exact) and retries, bounded. That is the whole client side of live
resharding: no coordinator ever talks to frontends.

Lease traffic splits with the rows: grant riders are re-indexed into
their sub-block positions, settle records route by their own fingerprint.

PARTITIONS=1 never constructs this class: the runner builds the plain
single-partition client, whose frames stay the pre-cluster bytes.
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..backends.sidecar import SidecarEngineClient, StaleMapError
from ..limiter.cache import CacheError
from ..tracing import journeys
from .partition_map import PartitionMap

logger = logging.getLogger("ratelimit.cluster")

# bounded re-bucket attempts per sub-block: each retry requires a strictly
# newer adopted map epoch, so this only triggers repeatedly during an
# active reshard storm; past the bound the request degrades through the
# FAILURE_MODE_DENY ladder like any backend failure
MAX_REROUTE = 4


class PartitionedEngineClient:
    """K per-partition device-owner clients behind one engine verb set."""

    def __init__(
        self,
        pmap: PartitionMap,
        scope=None,
        client_factory=None,
        client_kwargs=None,
    ):
        """pmap: the boot PartitionMap (settings.cluster_config() builds
        the even split over PARTITION_ADDRS). client_factory(addrs,
        map_epoch_fn) -> engine client is the test seam; the default
        builds SidecarEngineClient(addrs, map_epoch_fn=...,
        **client_kwargs) — addrs is the partition's (primary, *standbys)
        failover list, so per-partition promotion rides the existing
        failover machinery unchanged."""
        self._lock = threading.Lock()
        self._pmap = pmap
        self._closed = False
        kwargs = dict(client_kwargs or {})
        if client_factory is None:
            def client_factory(addrs, map_epoch_fn):
                return SidecarEngineClient(
                    list(addrs), map_epoch_fn=map_epoch_fn, **kwargs
                )

        self._factory = client_factory
        # owner-group -> client. Keyed by the ADDRESS tuple, not the
        # partition index: resharding renumbers ranges but a surviving
        # owner pair keeps its pooled connections and breaker state.
        self._clients: dict[tuple, object] = {}
        self._c_misrouted = None
        self._g_epoch = self._g_active = None
        if scope is not None:
            sc = scope.scope("cluster")
            self._c_misrouted = sc.counter("misrouted_rejected")
            self._g_epoch = sc.gauge("map_epoch")
            self._g_active = sc.gauge("partition_active")
            self._g_epoch.set(pmap.epoch)
            self._g_active.set(len(pmap))
        # the fan-out pool: one submit call dispatches its per-partition
        # sub-blocks concurrently (serial submits would multiply the
        # request's device round trip by the partitions it touches)
        self._pool = ThreadPoolExecutor(
            max_workers=max(2, min(16, 2 * len(pmap))),
            thread_name_prefix="cluster-submit",
        )
        # eager dial: a frontend must fail its boot loudly when a whole
        # partition is dark (same posture as the single client's boot
        # ping); each group walks its own failover list first
        for p in pmap.partitions:
            self._client_for(p.addrs)

    # -- map state --

    @property
    def pmap(self) -> PartitionMap:
        with self._lock:
            return self._pmap

    def map_epoch(self) -> int:
        with self._lock:
            return self._pmap.epoch

    def adopt(self, pmap: PartitionMap) -> bool:
        """Install a newer map (monotonic, like the owner side)."""
        with self._lock:
            if pmap.epoch <= self._pmap.epoch:
                return False
            self._pmap = pmap
        if self._g_epoch is not None:
            self._g_epoch.set(pmap.epoch)
        if self._g_active is not None:
            self._g_active.set(len(pmap))
        logger.warning(
            "router adopted partition map epoch %d (%d partitions)",
            pmap.epoch,
            len(pmap),
        )
        return True

    def _client_for(self, addrs: tuple):
        key = tuple(addrs)
        with self._lock:
            client = self._clients.get(key)
            if client is not None:
                return client
        # dial outside the lock (it pings); racing builders are settled
        # by the second lock take — the loser closes its extra client
        client = self._factory(addrs, self.map_epoch)
        with self._lock:
            existing = self._clients.get(key)
            if existing is not None:
                loser = client
            else:
                self._clients[key] = client
                loser = None
        if loser is not None:
            try:
                loser.close()
            except Exception:  # noqa: BLE001 - best effort
                pass
            return self._clients[key]
        return client

    # -- engine verbs --

    def submit_rows(
        self, block: np.ndarray, lease_ops=None
    ) -> np.ndarray:
        n = block.shape[1]
        if n == 0:
            return np.empty(0, dtype=np.uint32)
        out = np.empty(n, dtype=np.uint32)
        cols = np.arange(n, dtype=np.int64)
        self._dispatch(block, cols, lease_ops, out, depth=0)
        return out

    def _dispatch(self, block, cols, lease_ops, out, depth: int) -> None:
        """Bucket `cols` of `block` by the current map and submit each
        partition's sub-block; verdicts land in out[cols]. Recurses
        (bounded) when an owner answers STATUS_STALE_MAP."""
        pmap = self.pmap
        pidx = np.asarray(pmap.partition_of(block[0, cols]))
        parts = np.unique(pidx)
        if parts.size == 1:
            self._submit_group(
                pmap, int(parts[0]), block, cols, lease_ops, out, depth
            )
            return
        if depth > 0:
            # stale-map re-bucket running INSIDE a pool thread: go serial
            # rather than re-entering the bounded pool (a fan-out waiting
            # on a fan-out could otherwise exhaust it and deadlock)
            err = None
            for k in parts:
                group = cols[pidx == k]
                try:
                    self._submit_group(
                        pmap, int(k), block, group, lease_ops, out, depth
                    )
                except Exception as e:  # noqa: BLE001 - surfaced below
                    err = e
            if err is not None:
                raise err
            return
        futures = []
        for k in parts:
            group = cols[pidx == k]
            futures.append(
                self._pool.submit(
                    self._submit_group,
                    pmap,
                    int(k),
                    block,
                    group,
                    lease_ops,
                    out,
                    depth,
                )
            )
        err = None
        for f in futures:
            try:
                f.result()
            except Exception as e:  # noqa: BLE001 - surfaced below
                err = e
        if err is not None:
            # at least one partition failed after its own ladder; the
            # others may have applied their increments — the exact
            # posture an error reply already has on the single-owner wire
            raise err

    def _submit_group(
        self, pmap, k: int, block, cols, lease_ops, out, depth: int
    ) -> None:
        """Submit one partition's share of a block. lease_ops stays in
        ORIGINAL block-column space all the way down (stale-map retries
        re-bucket with it); the sub-block remap happens only here, at
        the wire."""
        part = pmap.partitions[k]
        # cols is always a sorted unique subset of the block's columns,
        # so full size means the whole block in order — skip the copy
        # (the common case: every descriptor of a request on one
        # partition)
        sub = (
            block
            if cols.size == block.shape[1]
            else np.ascontiguousarray(block[:, cols])
        )
        client = self._client_for(part.addrs)
        # flight-recorder breadcrumb: which partition served (or shed)
        # this request's rows
        journeys.mark(f"partition_{k}")
        try:
            res = client.submit_rows(
                sub, lease_ops=self._split_lease(lease_ops, cols, pmap, k)
            )
        except StaleMapError as e:
            if self._c_misrouted is not None:
                self._c_misrouted.inc()
            if depth >= MAX_REROUTE:
                raise CacheError(
                    f"partition routing did not converge after "
                    f"{MAX_REROUTE} map adoptions: {e}"
                ) from e
            try:
                new_map = PartitionMap.from_json_bytes(e.map_json)
            except ValueError as bad:
                raise CacheError(
                    f"owner returned a malformed partition map: {bad}"
                ) from bad
            self.adopt(new_map)
            # the rejected write was never applied: re-bucket exactly
            # this sub-block under the (possibly) newer map and resubmit
            self._dispatch(block, cols, lease_ops, out, depth + 1)
            return
        out[cols] = res

    @staticmethod
    def _split_lease(lease_ops, cols, pmap, k: int):
        """Partition k's share of a LeaseOps: grant riders whose row
        landed in this sub-block, re-indexed to sub-block positions, plus
        the settle records whose OWN fingerprint routes here (settles
        carry no row, so they route like any key would — each lands on
        exactly one partition's liability registry)."""
        if lease_ops is None:
            return None
        from ..backends.lease import LeaseOps

        pos_of = {int(c): i for i, c in enumerate(cols)}
        grants = [
            (pos_of[idx], n, window, ttl_s)
            for idx, n, window, ttl_s in lease_ops.grants
            if idx in pos_of
        ]
        settles = [
            s
            for s in lease_ops.settles
            if int(pmap.partition_of(np.uint32(s[0] & 0xFFFFFFFF))) == k
        ]
        if not grants and not settles:
            return None
        return LeaseOps(grants=grants, settles=settles)

    def submit(self, items) -> list[int]:
        from ..backends.cuda import _items_to_block

        if not items:
            return []
        return self.submit_rows(_items_to_block(items)).tolist()

    def flush(self) -> None:
        for client in self._snapshot_clients():
            client.flush()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._pool.shutdown(wait=True)
        for client in self._snapshot_clients():
            try:
                client.close()
            except Exception:  # noqa: BLE001 - teardown best effort
                pass

    def _snapshot_clients(self):
        with self._lock:
            return list(self._clients.values())

    # -- health / debug --

    def failover_reason(self) -> str | None:
        """HealthChecker degraded-probe contract: any partition serving
        from a standby makes the whole frontend degraded (that partition
        is one failure from its ladder)."""
        pmap = self.pmap
        reasons = []
        for p in pmap.partitions:
            client = self._clients.get(tuple(p.addrs))
            probe = getattr(client, "failover_reason", None)
            if probe is None:
                continue
            reason = probe()
            if reason:
                reasons.append(f"partition {p.index}: {reason}")
        return "; ".join(reasons) or None

    def cluster_snapshot(self) -> dict:
        """The /debug/cluster body for this frontend: the adopted map,
        each partition's live transport state, and — when the owners run
        the heavy-hitter sketch — each partition's last drained top-K
        plus a count-merged cluster-wide head. Keys route to exactly one
        partition, so merging the per-owner lists by count is exact (no
        fingerprint appears under two owners)."""
        pmap = self.pmap
        parts = []
        hot_merged: list[dict] = []
        hot_k = 0
        for p in pmap.partitions:
            client = self._clients.get(tuple(p.addrs))
            entry = {
                "index": p.index,
                "range": [p.lo, p.hi],
                "addrs": list(p.addrs),
            }
            active = None
            if client is not None:
                active = getattr(client, "active_address", None)
                if active is not None:
                    entry["active_address"] = active
                breaker = getattr(client, "breaker", None)
                if breaker is not None:
                    entry["breaker_state"] = breaker.state
            try:
                import json as _json

                from ..backends.sidecar import OP_HOTKEYS_GET, cluster_rpc

                snap = _json.loads(
                    cluster_rpc(
                        active or p.addrs[0], OP_HOTKEYS_GET, timeout=2.0
                    )
                )
                entry["hotkeys"] = snap
                if snap.get("enabled"):
                    hot_k = max(hot_k, int(snap.get("k", 0)))
                    for item in snap.get("top", ()):
                        hot_merged.append(dict(item, partition=p.index))
            except Exception as e:  # noqa: BLE001 - debug body best effort
                entry["hotkeys"] = {"error": str(e)}
            parts.append(entry)
        out = {
            "role": "router",
            "map_epoch": pmap.epoch,
            "route_sets": pmap.route_sets,
            "partitions": parts,
        }
        if hot_merged:
            hot_merged.sort(key=lambda x: -int(x.get("count", 0)))
            out["hotkeys"] = hot_merged[: hot_k or len(hot_merged)]
        return out


def new_partitioned_cache_from_settings(
    settings, base_limiter, stats_scope=None, fault_injector=None, lease_table=None
):
    """PARTITIONS>1 factory (runner.py backend switch): a
    CudaRateLimitCache whose device driver is the partition router over
    PARTITION_ADDRS. PARTITIONS=1 never reaches this: the runner keeps the
    single-owner client and its pre-cluster frames. The per-partition
    clients take no shm rings (shm frames carry no map stamp)."""
    from ..backends.cuda import CudaRateLimitCache

    _k, addr_groups, route_sets, _mb_s = settings.cluster_config()
    pmap = PartitionMap.even_map(addr_groups, route_sets=route_sets)
    router = PartitionedEngineClient(
        pmap,
        scope=stats_scope,
        client_kwargs=dict(
            tls_ca=settings.sidecar_tls_ca,
            tls_cert=settings.sidecar_tls_cert,
            tls_key=settings.sidecar_tls_key,
            tls_server_name=settings.sidecar_tls_server_name,
            scope=stats_scope,
            connect_timeout=settings.sidecar_connect_timeout,
            rpc_deadline=settings.sidecar_rpc_deadline,
            retries=settings.sidecar_retries,
            retry_backoff=settings.sidecar_retry_backoff,
            retry_backoff_max=settings.sidecar_retry_backoff_max,
            breaker_threshold=settings.sidecar_breaker_threshold,
            breaker_reset=settings.sidecar_breaker_reset,
            fault_injector=fault_injector,
        ),
    )
    return CudaRateLimitCache(
        base_limiter, lease_table=lease_table, engine=router
    )
