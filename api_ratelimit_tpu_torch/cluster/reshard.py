"""Port of api_ratelimit_tpu/cluster/reshard.py: live resharding, moving
route-set ranges owner to owner under load.

The coordinator is an OFFLINE admin actor (a CLI invocation, a test, an
operator runbook): it talks only to device owners, never to frontends.
Frontends converge on the new map through the STATUS_STALE_MAP fence: the
first write they route with the old map is rejected with the new map
attached, they re-bucket, and the rejected write, which was never applied,
is resubmitted exactly. No request fails by construction.

The move rides the snapshot-section format: each moved range streams as a
``pack_table_bytes`` section (the bytes a snapshot file or a replication
full-sync frame holds), and the receiving owner merges rows by fingerprint
with a keep-the-newest rule (persist/snapshot.py merge_rows_into_table,
under the engine's state lock: backends/cuda.py merge_rows).

Sequence, and why the overshoot stays bounded:

  1. STAGE    pull each moved range from its source, push to its target.
              Traffic keeps hitting the source; the copy goes stale at
              the rate the range takes writes.
  2. FLIP     install the new map on every GAINING owner first (they now
              accept the moved ranges), then on every losing owner:
              from that instant the source REJECTS writes for the moved
              ranges (stale-map fence), so clients drain to the target.
  3. DRAIN    re-pull each moved range from the frozen source and merge
              into the target: every admission the source took between
              stage and flip lands, keep-the-newest, on the target.

  Decisions admitted on the source during the stage-to-flip gap are the
  only ones the target can briefly under-count (one coordinator pass, the
  counterpart of one replication interval), plus whatever outstanding
  leases frontends still answer from: the bound the warm-standby failover
  documents.

RESHARD_RATE_LIMIT_MB_S throttles the section streaming so a reshard of a
hot fleet cannot starve the owners' serving path of socket bandwidth.
"""

from __future__ import annotations

import json
import logging
import struct
import time

from ..backends.sidecar import (
    OP_MAP_SET,
    OP_RESHARD_PULL,
    OP_RESHARD_PUSH,
    cluster_rpc,
)
from ..limiter.cache import CacheError
from .partition_map import PartitionMap

logger = logging.getLogger("ratelimit.cluster.reshard")

_U32 = struct.Struct("<I")
_PULL = struct.Struct("<III")


class ReshardCoordinator:
    """One K-change (or rebalance): old map -> new map, epoch + 1."""

    def __init__(
        self,
        old_map: PartitionMap,
        new_map: PartitionMap,
        scope=None,
        rate_limit_mb_s: float = 0.0,
        rpc=cluster_rpc,
        sleep=time.sleep,
    ):
        if new_map.epoch <= old_map.epoch:
            raise ValueError(
                f"new map epoch {new_map.epoch} must exceed the old "
                f"map's {old_map.epoch}"
            )
        if new_map.route_sets != old_map.route_sets:
            raise ValueError("resharding cannot change route_sets")
        self._old = old_map
        self._new = new_map
        self._rpc = rpc
        self._sleep = sleep
        self._rate_limit_mb_s = float(rate_limit_mb_s)
        self._c_sets_moved = None
        self._g_epoch = None
        if scope is not None:
            sc = scope.scope("cluster")
            self._c_sets_moved = sc.counter("reshard_sets_moved")
            self._g_epoch = sc.gauge("map_epoch")

    def _throttle(self, nbytes: int) -> None:
        if self._rate_limit_mb_s > 0 and nbytes:
            self._sleep(nbytes / (self._rate_limit_mb_s * 1e6))

    def _rpc_any(self, addrs, op: int, payload: bytes) -> bytes:
        """Walk a partition's failover list: the primary may have died
        and promoted its standby mid-reshard — the move must follow."""
        last: CacheError | None = None
        for addr in addrs:
            try:
                return self._rpc(addr, op, payload)
            except CacheError as e:
                last = e
        raise last if last is not None else CacheError("no owner address")

    def _move_range(self, lo: int, hi: int, src, dst) -> tuple[int, int]:
        """Pull [lo, hi) from src, push into dst; returns (rows, bytes)."""
        blob = self._rpc_any(
            src.addrs, OP_RESHARD_PULL, _PULL.pack(lo, hi, self._old.route_sets)
        )
        self._throttle(len(blob))
        reply = self._rpc_any(
            dst.addrs, OP_RESHARD_PUSH, _U32.pack(len(blob)) + blob
        )
        stats = json.loads(reply.decode() or "{}")
        return int(stats.get("merged", 0)), len(blob)

    def _install_map(self, addr_groups) -> None:
        raw = self._new.to_json_bytes()
        body = _U32.pack(len(raw)) + raw
        for addrs in addr_groups:
            errs = 0
            for addr in addrs:
                try:
                    self._rpc(addr, OP_MAP_SET, body)
                except CacheError as e:
                    # a dark standby learns the map at its next promote-
                    # and-reject cycle; a dark PRIMARY is the range's
                    # serving problem, not the map install's
                    errs += 1
                    logger.warning("map install skipped %s: %s", addr, e)
            if errs == len(addrs):
                raise CacheError(
                    f"no owner of {addrs} accepted the new partition map"
                )

    def run(self) -> dict:
        """Execute the reshard; returns the move report. Raises
        CacheError when a range cannot stream or a whole partition
        refuses the map — the cluster is then still on the OLD map for
        the failed ranges (owners adopt monotonically, so a partial run
        re-executes safely: pulls are idempotent and pushes merge)."""
        moved = self._old.moved_ranges(self._new)
        report = {
            "from_epoch": self._old.epoch,
            "to_epoch": self._new.epoch,
            "ranges_moved": len(moved),
            "sets_moved": 0,
            "rows_staged": 0,
            "rows_drained": 0,
            "bytes_streamed": 0,
        }
        t0 = time.monotonic()
        # 1. STAGE: bulk copy while the source still serves
        for lo, hi, src, dst in moved:
            rows, nbytes = self._move_range(lo, hi, src, dst)
            report["rows_staged"] += rows
            report["bytes_streamed"] += nbytes
        # 2. FLIP: gainers first, then everyone else — the instant a
        # loser adopts, its stale-map fence drains clients to owners
        # that already accept the range
        gainers = []
        seen = set()
        for _lo, _hi, _src, dst in moved:
            if dst.addrs not in seen:
                seen.add(dst.addrs)
                gainers.append(dst.addrs)
        rest = [
            p.addrs
            for p in (*self._new.partitions, *self._old.partitions)
            if p.addrs not in seen and not seen.add(p.addrs)
        ]
        self._install_map(gainers)
        self._install_map(rest)
        # 3. DRAIN: the sources now reject writes for the moved ranges,
        # so one final pull catches every admission from the stage→flip
        # gap; merge keeps the newest row per fingerprint
        for lo, hi, src, dst in moved:
            rows, nbytes = self._move_range(lo, hi, src, dst)
            report["rows_drained"] += rows
            report["bytes_streamed"] += nbytes
            report["sets_moved"] += hi - lo
        report["elapsed_ms"] = round((time.monotonic() - t0) * 1e3, 3)
        if self._c_sets_moved is not None:
            self._c_sets_moved.add(report["sets_moved"])
        if self._g_epoch is not None:
            self._g_epoch.set(self._new.epoch)
        logger.warning(
            "reshard %d->%d partitions complete: %s",
            len(self._old),
            len(self._new),
            report,
        )
        return report
