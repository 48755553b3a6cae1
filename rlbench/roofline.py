"""The yardstick of the kernels' roofline shares: the card's published peak
and the bytes each kernel needs, counted from the traffic's own rows and the
slab's shapes, never from what a kernel does. NumPy only.

The counts are frozen from the port's kernel report (PERF.md section 6,
"TPU kernel table" and the note under it; chip_smoke.py kernel_report
`nbytes`), which counts each byte once:

- way scan (`way_scan_kernel<false|true>`): every distinct set of a launch
  read once, W rows of 32 bytes (8 uint32 columns), plus 45 bytes an item
  (the 8-byte query, the 4-byte way and 1-byte match out, the 32-byte
  picked row out). PERF.md: "way scan: each distinct set plus 45 B an item".
- apply (`slab_apply_kernel`, the fixed-window body): 57 bytes an item (5
  int32 planes and the seg_start byte in, the 5 stored-row words in, 4
  planes out). PERF.md: "applies 57/85/65 B".
- sketch update (`sketch_update_kernel`): 13 bytes an item (fp_lo, fp_hi,
  weight, the candidate byte) plus the planes (3 uint32 planes of `lanes`)
  read once and written once. PERF.md: "sketch update 13 B an item plus the
  planes".

A launch's items are the rows it carried (`n`), not the padding of its
bucket.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # one H100 SXM, NVIDIA's data sheet, at 700 W
ROW_BYTES = 32
WAY_SCAN_ITEM_BYTES = 45
SLAB_APPLY_ITEM_BYTES = 57
SKETCH_ITEM_BYTES = 13
SKETCH_PLANES = 3


def way_scan_bytes(fp_lo: np.ndarray, n_sets: int, ways: int) -> int:
    sets = np.unique(np.asarray(fp_lo, dtype=np.int64) & (n_sets - 1)).size
    return sets * ways * ROW_BYTES + WAY_SCAN_ITEM_BYTES * int(np.asarray(fp_lo).size)


def slab_apply_bytes(n: int) -> int:
    return SLAB_APPLY_ITEM_BYTES * int(n)


def sketch_update_bytes(n: int, lanes: int) -> int:
    return SKETCH_ITEM_BYTES * int(n) + 2 * SKETCH_PLANES * int(lanes) * 4


def share_pct(nbytes: int, seconds: float) -> float:
    """The least time for `nbytes` at the HBM peak, as a share of `seconds`."""
    return nbytes / HBM_BYTES_PER_S / seconds * 100.0
