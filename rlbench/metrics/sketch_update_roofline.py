"""The heavy-hitter sketch update's share of its roofline in the traced
slice: 13 B an item plus its planes read and written once, at the HBM
peak, over the device time of sketch_update_kernel."""

from rlbench.roofline import share_pct, sketch_update_bytes


def read(run):
    s = run.slice
    seconds = s.kernel_seconds("sketch_update_kernel") if s is not None else 0.0
    if seconds <= 0 or not run.lanes:
        return None
    nbytes = sum(sketch_update_bytes(lo.size, run.lanes) for lo in run.slice_launches())
    return share_pct(nbytes, seconds)
