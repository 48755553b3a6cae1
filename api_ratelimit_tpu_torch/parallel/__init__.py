"""Port of api_ratelimit_tpu/parallel: the hash-sharded slab over several
shards.

Each key has one owning shard, (fp_lo ^ fp_hi) mod n_shards, the way a Redis
Cluster client hashes each key to its owning node; each shard is a slab of
its own on its device, and its launches are the single-device step's
kernels (ops/slab.py). See sharded_slab.py.
"""

from .sharded_slab import Mesh, ShardedSlabEngine, make_mesh, mesh_devices

__all__ = ["Mesh", "ShardedSlabEngine", "make_mesh", "mesh_devices"]
