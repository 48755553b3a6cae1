"""The 99th percentile of a frontend block's wait at the owner, from its
submit to its counters returned, over the blocks of the window outside the
traced slice. In a closed loop it moves with throughput (each frontend has
one block in flight), so it is a per-layer figure here, not an end-to-end
one."""

import numpy as np


def read(run):
    lat = run.block_latencies_ms()
    return float(np.percentile(lat, 99)) if lat.size >= 100 else None
