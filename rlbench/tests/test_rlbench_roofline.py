"""The frozen byte counts, on a hand-made launch."""

import numpy as np
import pytest

from rlbench import roofline


def test_byte_counts_on_a_hand_made_batch():
    # 5 items over 3 distinct sets of a 4-set slab at W = 128
    fp_lo = np.array([0, 4, 1, 5, 2], dtype=np.uint32)
    assert roofline.way_scan_bytes(fp_lo, 4, 128) == 3 * 128 * 32 + 5 * 45
    assert roofline.slab_apply_bytes(5) == 5 * 57
    assert roofline.sketch_update_bytes(5, 128) == 5 * 13 + 2 * 3 * 128 * 4


def test_share_against_the_peak():
    # 3.35 GB in 2 ms is half of 3.35 TB/s
    assert roofline.share_pct(3_350_000_000, 0.002) == pytest.approx(50.0)
