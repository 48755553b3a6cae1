"""Port of api_ratelimit_tpu/cluster: the partitioned device-owner cluster.

The keyspace splits into K *partitions*, each an independent device-owner
process (or a primary/standby pair) with its own slab on the card, its own
dispatch loop, snapshotter and warm standby, and frontends bucket their row
blocks per partition before submit: the Redis Cluster architecture mapped
onto the slab. The modules are the reference's, their wire bytes too.

    partition_map.py  PartitionMap: the epoch-versioned assignment of
                      route-set ranges to owner address groups, and THE
                      routing rule: partition = owner of
                      set_index(fp_lo, route_sets)
    node.py           ClusterNode: owner-side membership; every SUBMIT is
                      fenced against the node's map, so a stale client map
                      gets STATUS_STALE_MAP and the new map, never a
                      silently misrouted write
    router.py         PartitionedEngineClient: the frontend-side router,
                      one SidecarEngineClient per partition (each with its
                      own failover list), blocks split by route index and
                      verdicts scattered back in submit order
    reshard.py        ReshardCoordinator: live resharding, streaming the
                      moved route-set ranges owner to owner as
                      pack_table_bytes sections, flipping the map with an
                      epoch bump, then draining the frozen source ranges

The reference's cluster/federation.py (global quota federation) is ROADMAP
item 9b and is not imported here.

PARTITIONS=1 (the default) builds none of this: the frontend keeps the
single-owner SidecarEngineClient and its frames byte for byte.
"""

from .partition_map import Partition, PartitionMap  # noqa: F401
