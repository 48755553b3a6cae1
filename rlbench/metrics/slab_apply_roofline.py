"""The fixed-window apply's share of its roofline in the traced slice: 57 B
an item at the HBM peak, over the device time of slab_apply_kernel. The
multi-algorithm body runs no apply kernel, so its cells read nothing."""

from rlbench.roofline import share_pct, slab_apply_bytes


def read(run):
    s = run.slice
    seconds = s.kernel_seconds("slab_apply_kernel") if s is not None else 0.0
    if seconds <= 0:
        return None
    return share_pct(sum(slab_apply_bytes(lo.size) for lo in run.slice_launches()), seconds)
