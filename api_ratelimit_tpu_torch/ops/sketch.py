"""Port of api_ratelimit_tpu/ops/sketch.py: the heavy-hitter sketch.

A few uint32 lanes beside the slab hold a space-saving top-K of the keys the
launches carry. Per launch the update sees one candidate per distinct key
(the sorted segment ends the slab step already delineates), weighted by the
segment's total hits, and runs two phases:

  A. matched candidates add their weight to their lane in place;
  B. per sketch set, one unmatched candidate (the lexicographic maximum of
     (weight, fp_hi, fp_lo), unsigned) replaces the argmin-count way of its
     set, inheriting that way's pre-launch count: count = victim + weight.

The stats cadence drains the planes to the host (sketch_topk), halves the
counts (sketch_decay) and uploads them again; the engine owns that
(backends/cuda.py drain_hotkeys).

Layout: `int32[SKETCH_PLANES, lanes]` holding uint32 bits (the slab's
convention: torch's uint32 support is partial), planes fp_lo, fp_hi, count,
each viewed as `[n_sets, ways]` with ways = min(slab ways, lanes). A key lives
only in set `fp_lo & (n_sets - 1)`. Counts are read signed, as the reference
reads them: a lane is occupied iff its int32 count is > 0.

On the card the whole update - the scan, phase A and phase B - is one
kernel launch (ops/sketch_kernels.py sketch_update_fused, CUDA in
csrc/sketch_kernels.cu); on the CPU its plain version runs the same steps
as torch ops. HostTopK is the same summary on the host: the mesh engine's
sketch (parallel/sharded_slab.py), fed by its host routing pass.
"""

from __future__ import annotations

import numpy as np
import torch

from .sketch_kernels import (
    PLANE_COUNT,
    PLANE_FP_HI,
    PLANE_FP_LO,
    SKETCH_PLANES,
    sketch_update_fused,
)
from .slab_kernels import resolve_device

# one warp-strided set of head keys on the card: a top-16 report with 8x
# slack for churn, one sketch set at the default 128-way geometry
DEFAULT_LANES = 128


def validate_lanes(lanes: int) -> int:
    lanes = int(lanes)
    if lanes <= 0 or lanes & (lanes - 1):
        raise ValueError(
            f"hotkey lanes must be a positive power of two, got {lanes}"
        )
    return lanes


def sketch_ways(slab_ways: int, lanes: int) -> int:
    """Sketch set associativity: the slab's own W where it fits, else the
    whole sketch is one set (fully associative)."""
    return min(int(slab_ways), validate_lanes(lanes))


def make_sketch(lanes: int, device="cuda") -> torch.Tensor:
    """Cleared planes, int32[SKETCH_PLANES, lanes]."""
    return torch.zeros(
        (SKETCH_PLANES, validate_lanes(lanes)),
        dtype=torch.int32,
        device=resolve_device(device),
    )


def sketch_import_planes(planes, device="cuda") -> torch.Tensor:
    """Upload uint32[SKETCH_PLANES, lanes] host planes (for example a JAX
    sketch's `np.asarray(planes)`, or a drained copy) as sketch state."""
    planes = np.asarray(planes, dtype=np.uint32)
    if planes.ndim != 2 or planes.shape[0] != SKETCH_PLANES:
        raise ValueError(
            f"sketch planes must be ({SKETCH_PLANES}, lanes), got {planes.shape}"
        )
    validate_lanes(planes.shape[1])
    return torch.from_numpy(planes.view(np.int32).copy()).to(
        resolve_device(device)
    )


def sketch_export_copy(planes: torch.Tensor) -> np.ndarray:
    """Host copy of the planes as uint32[SKETCH_PLANES, lanes]."""
    return planes.cpu().numpy().view(np.uint32).copy()


def sketch_update(
    planes: torch.Tensor,  # int32[SKETCH_PLANES, lanes]
    fp_lo: torch.Tensor,  # int32[b] sorted batch fingerprints (uint32 bits)
    fp_hi: torch.Tensor,
    weight: torch.Tensor,  # int32[b] segment-total hits (valid at cand rows)
    cand: torch.Tensor,  # bool[b] one True per distinct key (segment end)
    ways: int,
) -> torch.Tensor:
    """One launch's sketch update (module docstring); returns new planes."""
    return sketch_update_fused(planes, fp_lo, fp_hi, weight, cand, ways)


# --- host-side drain helpers (numpy copies of the reference's) ---------------


def sketch_topk(planes: np.ndarray, k: int):
    """Top-k occupied entries of a drained uint32 plane copy, hottest first:
    [(fp_lo, fp_hi, count)] ordered by (count, fp_hi, fp_lo) descending."""
    planes = np.asarray(planes)
    cnt = planes[PLANE_COUNT]
    occ = np.flatnonzero(cnt > 0)
    if occ.size == 0 or k <= 0:
        return []
    order = occ[
        np.lexsort(
            (planes[PLANE_FP_LO][occ], planes[PLANE_FP_HI][occ], cnt[occ])
        )[::-1]
    ][:k]
    return [
        (int(planes[PLANE_FP_LO][i]), int(planes[PLANE_FP_HI][i]), int(cnt[i]))
        for i in order
    ]


def sketch_decay(planes: np.ndarray) -> np.ndarray:
    """Post-drain decay, in place on the uint32 host copy: halve every
    count and clear the fingerprints of entries that decayed to zero."""
    planes = np.asarray(planes)
    cnt = planes[PLANE_COUNT]
    cnt >>= 1
    dead = cnt == 0
    planes[PLANE_FP_LO][dead] = 0
    planes[PLANE_FP_HI][dead] = 0
    return planes


class HostTopK:
    """Space-saving top-K on the host: the mesh engine's sketch.

    The device planes ride one slab's launch; the mesh engine's per-shard
    launches would each see only their shard's share of the stream, so
    ShardedSlabEngine feeds this summary from the one place that sees the
    whole stream, the host routing pass that buckets rows by shard.

    The same algorithm family as the planes (a full summary evicts its
    min-count entry and the newcomer inherits that count, so estimates
    only over-count), the same drain order (sketch_topk's: count desc, fp
    as the tiebreak) and the same halve-on-drain decay. A dict and numpy;
    its cost rides the host routing pass, not the card."""

    def __init__(self, lanes: int):
        self.lanes = validate_lanes(lanes)
        self._counts: dict[int, int] = {}

    def update(self, fp_lo, fp_hi, hits) -> None:
        """Fold a batch in: fp halves and per-row hit weights (uint32
        arrays, padding already stripped), aggregated by key first."""
        fp_lo = np.asarray(fp_lo, dtype=np.uint64)
        fp_hi = np.asarray(fp_hi, dtype=np.uint64)
        combined = fp_lo | (fp_hi << np.uint64(32))
        keys, inv = np.unique(combined, return_inverse=True)
        sums = np.bincount(inv, weights=np.asarray(hits, dtype=np.float64)).astype(np.int64)
        counts = self._counts
        for key, add in zip(keys.tolist(), sums.tolist()):
            cur = counts.get(key)
            if cur is not None:
                counts[key] = cur + add
            elif len(counts) < self.lanes:
                counts[key] = add
            else:
                # space-saving eviction: the newcomer inherits the floor
                victim = min(counts, key=counts.get)
                floor = counts.pop(victim)
                counts[key] = floor + add

    def topk(self, k: int) -> list:
        """[(fp_lo, fp_hi, count)] in sketch_topk's order: count desc,
        then (fp_hi, fp_lo) desc."""
        if k <= 0 or not self._counts:
            return []
        order = sorted(
            self._counts.items(),
            key=lambda kv: (kv[1], kv[0] >> 32, kv[0] & 0xFFFFFFFF),
            reverse=True,
        )[:k]
        return [(int(fp & 0xFFFFFFFF), int(fp >> 32), int(cnt)) for fp, cnt in order]

    def decay(self) -> None:
        """sketch_decay's halve-and-drop on the dict."""
        self._counts = {fp: cnt >> 1 for fp, cnt in self._counts.items() if cnt >> 1}
