"""The way scan's share of its roofline in the traced slice: the least time
for the bytes its launches needed (rlbench/roofline.py: every distinct set
once, 45 B an item) at the HBM peak, over the device time of every
way_scan_kernel instantiation."""

from rlbench.roofline import share_pct, way_scan_bytes


def read(run):
    s = run.slice
    seconds = s.kernel_seconds("way_scan_kernel") if s is not None else 0.0
    if seconds <= 0:
        return None
    n_sets = run.n_slots // run.ways
    nbytes = sum(way_scan_bytes(lo, n_sets, run.ways) for lo in run.slice_launches())
    return share_pct(nbytes, seconds)
