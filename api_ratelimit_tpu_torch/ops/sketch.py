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

The scan (match way, victim) is the kernel (ops/sketch_kernels.py, CUDA in
csrc/sketch_kernels.cu). Phases A and B stay plain torch ops, as XLA owned
them on the TPU, and stay sync-free: no boolean-mask compaction; writes that
must not land go to a scratch lane past the last. The host copy HostTopK of
the reference belongs to the mesh engine, which is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .sketch_kernels import SKETCH_PLANES, sketch_scan
from .slab_kernels import _M32, _u32, _wrap32, resolve_device

PLANE_FP_LO, PLANE_FP_HI, PLANE_COUNT = range(SKETCH_PLANES)

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
    lanes = planes.shape[1]
    n_sets = lanes // ways
    dev = planes.device
    set_idx = (fp_lo & (n_sets - 1)).long()
    m_way, m_any, v_way, v_cnt = sketch_scan(planes, fp_lo, fp_hi, ways)
    w_u = _u32(weight)

    # phase A: matched candidates accumulate in place. A fingerprint holds
    # at most one lane of its set and candidates are distinct keys, so the
    # landing lanes are unique; the rest add 0 to the scratch lane `lanes`.
    matched = m_any & cand
    add_lane = torch.where(matched, set_idx * ways + m_way.long(), lanes)
    cnt = torch.cat([_u32(planes[PLANE_COUNT]), w_u.new_zeros(1)])
    cnt.index_add_(0, add_lane, torch.where(matched, w_u, 0))
    cnt_a = cnt[:lanes] & _M32

    # phase B: one winner per set among unmatched candidates, ranked by
    # (weight, fp_hi, fp_lo) unsigned through three masked segment maxima
    # over {0} and the set's candidates (unique: candidates are distinct).
    # Dense (b, n_sets) reductions, as in the reference: n_sets is 1 at the
    # default geometry, where a scatter-max would send every row's atomic
    # to the same address.
    unmatched = cand & ~m_any
    onehot = set_idx[:, None] == torch.arange(n_sets, device=dev)[None, :]

    def seg_max(mask, vals):
        return torch.where(mask[:, None] & onehot, vals[:, None], 0).amax(dim=0)

    hi_u, lo_u = _u32(fp_hi), _u32(fp_lo)
    w_max = seg_max(unmatched, w_u)
    w_ok = unmatched & (w_u == w_max[set_idx])
    h_max = seg_max(w_ok, hi_u)
    h_ok = w_ok & (hi_u == h_max[set_idx])
    l_max = seg_max(h_ok, lo_u)

    # the write is per set: the victim (first way at the minimum of the
    # PRE-launch signed counts) takes the winner, whose count overwrites
    # any phase-A add to that lane with victim count + weight. The scan
    # gave every item its set's victim, so scattering them by set lands
    # equal values; a set without items has no winner, so its (unwritten)
    # entries are masked out below.
    vic_way = torch.empty(n_sets, dtype=torch.int32, device=dev)
    vic_way.index_put_((set_idx,), v_way)
    vic_cnt = torch.empty(n_sets, dtype=torch.int32, device=dev)
    vic_cnt.index_put_((set_idx,), v_cnt)
    vic_cnt = _u32(vic_cnt)
    win_exists = w_max > 0
    way_iota = torch.arange(ways, device=dev)
    win_mask = (
        (way_iota[None, :] == vic_way[:, None]) & win_exists[:, None]
    ).reshape(lanes)
    lo_plane = torch.where(
        win_mask, l_max.repeat_interleave(ways), _u32(planes[PLANE_FP_LO])
    )
    hi_plane = torch.where(
        win_mask, h_max.repeat_interleave(ways), _u32(planes[PLANE_FP_HI])
    )
    cnt_plane = torch.where(
        win_mask, ((vic_cnt + w_max) & _M32).repeat_interleave(ways), cnt_a
    )
    return _wrap32(torch.stack([lo_plane, hi_plane, cnt_plane])).to(torch.int32)


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
