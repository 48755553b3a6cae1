"""Port of api_ratelimit_tpu/cluster/partition_map.py: the epoch-versioned
keyspace split.

Routing is deterministic from the slab fingerprint: a row's *route index*
is ``set_index(fp_lo, route_sets)`` (ops/hashing.py: the set split the
kernels, the snapshot migration and the router share), and a partition
owns a contiguous range ``[lo, hi)`` of route indices. Every slab set
therefore lives wholly on one partition, which is what makes live
resharding a stream of whole set ranges (reshard.py) instead of a per-key
migration.

The map is the cluster's one piece of shared configuration, versioned by
``epoch`` exactly like the replication fence (persist/replication.py):
clients stamp the epoch of the map they routed with onto every SUBMIT
(FLAG_MAP, backends/sidecar.py) and an owner holding a NEWER map answers
STATUS_STALE_MAP + its map instead of applying a misrouted write. A
resharded cluster therefore converges through rejected writes, never
through silently double-counted ones: the posture of Redis Cluster's MOVED
redirect for its 16384 hash slots.

route_sets is the resolution of the split (the slot-table size): a power
of two, fixed for the lifetime of a cluster (resharding moves ranges
between owners; it never changes the resolution). The map JSON is the
reference's byte for byte (json.dumps with sorted keys).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from ..ops.hashing import set_index

DEFAULT_ROUTE_SETS = 256


@dataclasses.dataclass(frozen=True)
class Partition:
    """One keyspace partition: a contiguous route-set range and the
    device-owner address pair that serves it (primary first, then warm
    standbys — the per-partition SIDECAR_ADDRS failover order)."""

    index: int
    lo: int  # inclusive route-set range start
    hi: int  # exclusive range end
    addrs: tuple[str, ...]

    def to_json(self) -> dict:
        return {
            "index": self.index,
            "lo": self.lo,
            "hi": self.hi,
            "addrs": list(self.addrs),
        }


class PartitionMap:
    """Immutable epoch-versioned route-set assignment. Construction
    validates exhaustively (ranges must tile [0, route_sets) exactly) —
    a malformed map must fail where it is built, never misroute a key."""

    __slots__ = ("epoch", "route_sets", "partitions", "_lookup")

    def __init__(self, epoch: int, route_sets: int, partitions):
        if route_sets <= 0 or route_sets & (route_sets - 1):
            raise ValueError(
                f"route_sets must be a power of two, got {route_sets}"
            )
        parts = tuple(partitions)
        if not parts:
            raise ValueError("a partition map needs at least one partition")
        ordered = sorted(parts, key=lambda p: p.lo)
        cursor = 0
        for i, p in enumerate(ordered):
            if p.index != i:
                raise ValueError(
                    f"partition indices must be 0..K-1 in range order, "
                    f"got index {p.index} at position {i}"
                )
            if p.lo != cursor or p.hi <= p.lo:
                raise ValueError(
                    f"partition ranges must tile [0, {route_sets}) "
                    f"contiguously: partition {p.index} covers "
                    f"[{p.lo}, {p.hi}) after cursor {cursor}"
                )
            if not p.addrs:
                raise ValueError(f"partition {p.index} has no owner address")
            cursor = p.hi
        if cursor != route_sets:
            raise ValueError(
                f"partition ranges cover [0, {cursor}) but route_sets is "
                f"{route_sets}"
            )
        object.__setattr__(self, "epoch", int(epoch))
        object.__setattr__(self, "route_sets", int(route_sets))
        object.__setattr__(self, "partitions", ordered)
        # route index -> partition index, the O(1) routing table (u32 so
        # it indexes numpy fancy-index paths without a cast)
        lookup = np.empty(route_sets, dtype=np.uint32)
        for p in ordered:
            lookup[p.lo : p.hi] = p.index
        lookup.setflags(write=False)
        object.__setattr__(self, "_lookup", lookup)

    def __setattr__(self, name, value):  # immutability guard
        raise AttributeError("PartitionMap is immutable")

    def __len__(self) -> int:
        return len(self.partitions)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, PartitionMap)
            and self.epoch == other.epoch
            and self.route_sets == other.route_sets
            and self.partitions == other.partitions
        )

    def route_of(self, fp_lo):
        """Route index (array or scalar) of fp_lo — set_index at the
        map's resolution, the ONE routing rule every consumer shares."""
        return set_index(fp_lo, self.route_sets)

    def partition_of(self, fp_lo):
        """Partition index (array or scalar) owning fp_lo."""
        return self._lookup[self.route_of(fp_lo)]

    def owner_of_route(self, route: int) -> Partition:
        return self.partitions[int(self._lookup[route])]

    def owned_mask(self, fp_lo: np.ndarray, index: int) -> np.ndarray:
        """Boolean mask of rows partition `index` owns under this map —
        the owner-side membership check (node.py)."""
        return self.partition_of(np.asarray(fp_lo)) == np.uint32(index)

    # -- construction helpers --

    @classmethod
    def even_map(
        cls,
        addr_groups,
        route_sets: int = DEFAULT_ROUTE_SETS,
        epoch: int = 1,
    ) -> "PartitionMap":
        """K contiguous near-equal ranges over [0, route_sets), one per
        owner address group (the PARTITION_ADDRS boot layout)."""
        groups = [tuple(g) for g in addr_groups]
        k = len(groups)
        if k == 0:
            raise ValueError("even_map needs at least one address group")
        if k > route_sets:
            raise ValueError(
                f"{k} partitions cannot split {route_sets} route sets"
            )
        parts = [
            Partition(
                index=i,
                lo=i * route_sets // k,
                hi=(i + 1) * route_sets // k,
                addrs=groups[i],
            )
            for i in range(k)
        ]
        return cls(epoch, route_sets, parts)

    def reshard_to(self, addr_groups) -> "PartitionMap":
        """The even map over a NEW owner-group list at epoch + 1 — the
        coordinator's target map for a K change (reshard.py)."""
        return PartitionMap.even_map(
            addr_groups, route_sets=self.route_sets, epoch=self.epoch + 1
        )

    def moved_ranges(self, new: "PartitionMap"):
        """Contiguous route ranges whose owner ADDRESS PAIR changes
        between self and `new`: [(lo, hi, src Partition, dst Partition)].
        Compared by address (not index) so renumbering alone moves
        nothing — only ranges whose serving pair actually changes
        stream."""
        if new.route_sets != self.route_sets:
            raise ValueError(
                f"reshard cannot change route_sets "
                f"({self.route_sets} -> {new.route_sets})"
            )
        moved = []
        run = None  # (lo, src, dst)
        for r in range(self.route_sets):
            src = self.owner_of_route(r)
            dst = new.owner_of_route(r)
            key = None if src.addrs == dst.addrs else (src, dst)
            if run is not None and (key is None or run[1:] != (src, dst)):
                moved.append((run[0], r, run[1], run[2]))
                run = None
            if key is not None and run is None:
                run = (r, src, dst)
        if run is not None:
            moved.append((run[0], self.route_sets, run[1], run[2]))
        return moved

    # -- wire / debug codec (the STATUS_STALE_MAP reply body) --

    def to_json(self) -> dict:
        return {
            "epoch": self.epoch,
            "route_sets": self.route_sets,
            "partitions": [p.to_json() for p in self.partitions],
        }

    def to_json_bytes(self) -> bytes:
        return json.dumps(self.to_json(), sort_keys=True).encode()

    @classmethod
    def from_json(cls, obj: dict) -> "PartitionMap":
        return cls(
            int(obj["epoch"]),
            int(obj["route_sets"]),
            [
                Partition(
                    index=int(p["index"]),
                    lo=int(p["lo"]),
                    hi=int(p["hi"]),
                    addrs=tuple(str(a) for a in p["addrs"]),
                )
                for p in obj["partitions"]
            ],
        )

    @classmethod
    def from_json_bytes(cls, raw: bytes) -> "PartitionMap":
        try:
            return cls.from_json(json.loads(raw.decode()))
        except (ValueError, KeyError, TypeError) as e:
            raise ValueError(f"malformed partition map: {e}") from e
