"""Port of api_ratelimit_tpu/cluster/node.py: the device-owner side of
cluster membership.

One ClusterNode rides each partition's sidecar server
(backends/sidecar.py): it holds the owner's current PartitionMap plus its
own partition index, and fences every SUBMIT frame:

  * a frame routed with an OLDER map epoch than this owner's is answered
    STATUS_STALE_MAP + the current map (the client re-buckets and
    resubmits; the write is NOT applied);
  * a frame whose rows include route indices this partition does not own
    under the CURRENT map is rejected the same way and counted
    ``ratelimit.cluster.misrouted_rejected``: the never-silently-
    misrouted-write guarantee, whatever epoch the client claims.

Map adoption (OP_MAP_SET, or the reshard coordinator's flip) is monotonic:
only a strictly newer epoch replaces the held map, so a delayed or
duplicated install can never roll membership backwards, the rule the
replication epoch fence keeps too.
"""

from __future__ import annotations

import logging
import threading

import numpy as np

from .partition_map import PartitionMap

logger = logging.getLogger("ratelimit.cluster")


class ClusterNode:
    """Owner-side membership state for ONE partition."""

    def __init__(self, partition_index: int, pmap: PartitionMap, scope=None):
        if not 0 <= partition_index < len(pmap):
            raise ValueError(
                f"partition index {partition_index} outside the map's "
                f"{len(pmap)} partitions"
            )
        self._index = int(partition_index)
        self._map = pmap
        self._lock = threading.Lock()
        self._c_misrouted = self._c_stale = None
        self._g_epoch = self._g_active = None
        if scope is not None:
            sc = scope.scope("cluster")
            self._c_misrouted = sc.counter("misrouted_rejected")
            self._c_stale = sc.counter("stale_map_rejected")
            self._g_epoch = sc.gauge("map_epoch")
            self._g_epoch.set(pmap.epoch)
            self._g_active = sc.gauge("partition_active")
            self._g_active.set(len(pmap))

    @property
    def partition_index(self) -> int:
        return self._index

    @property
    def pmap(self) -> PartitionMap:
        with self._lock:
            return self._map

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._map.epoch

    def adopt(self, pmap: PartitionMap) -> bool:
        """Install a newer map; returns True when adopted. Older/equal
        epochs are ignored (monotonic), and a map that no longer lists
        this node's partition index still installs — the node then owns
        nothing and rejects everything, which is exactly right for a
        decommissioned owner draining away."""
        with self._lock:
            if pmap.epoch <= self._map.epoch:
                return False
            self._map = pmap
        if self._g_epoch is not None:
            self._g_epoch.set(pmap.epoch)
        if self._g_active is not None:
            self._g_active.set(len(pmap))
        logger.warning(
            "partition %d adopted map epoch %d (%d partitions)",
            self._index,
            pmap.epoch,
            len(pmap),
        )
        return True

    def adopt_json(self, raw: bytes) -> bool:
        return self.adopt(PartitionMap.from_json_bytes(raw))

    def check_block(
        self, frame_map_epoch: int | None, block: np.ndarray
    ) -> bytes | None:
        """The SUBMIT fence: None = the write may proceed; otherwise the
        STATUS_STALE_MAP reply body (the current map's JSON) and the
        write must NOT be applied. Frames without a map stamp
        (frame_map_epoch None — a pre-cluster client, or the admin
        tools) are only membership-checked, not epoch-fenced."""
        with self._lock:
            pmap = self._map
        if frame_map_epoch is not None and frame_map_epoch < pmap.epoch:
            # routed with a map this cluster has already moved past
            if self._c_stale is not None:
                self._c_stale.inc()
            return pmap.to_json_bytes()
        if self._index < len(pmap) and block.shape[1]:
            if not bool(
                np.all(pmap.owned_mask(block[0], self._index))
            ):
                if self._c_misrouted is not None:
                    self._c_misrouted.inc()
                return pmap.to_json_bytes()
        elif self._index >= len(pmap):
            # decommissioned owner: owns no range under the current map
            if self._c_misrouted is not None:
                self._c_misrouted.inc()
            return pmap.to_json_bytes()
        return None

    def describe(self) -> dict:
        """The /debug/cluster body for this owner."""
        with self._lock:
            pmap = self._map
        me = (
            pmap.partitions[self._index].to_json()
            if self._index < len(pmap)
            else None
        )
        return {
            "role": "owner",
            "partition": self._index,
            "map_epoch": pmap.epoch,
            "route_sets": pmap.route_sets,
            "owned_range": me,
            "map": pmap.to_json(),
        }
