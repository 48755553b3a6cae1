"""Port of api_ratelimit_tpu/ops/sketch.py pallas_sketch_scan and the XLA
phases around it: the sketch update's kernels.

The kernels are CUDA C++ for sm_90a in csrc/sketch_kernels.cu, part of the
one library ops/slab_kernels.py builds. Beside each sits its plain PyTorch
version:

    sketch_update_fused  <- sketch_update(use_pallas=True): pallas_sketch_scan
                            and phases A and B, one launch (the served path)
    sketch_scan          <- pallas_sketch_scan alone (plus the set gathers of
                            the planes that surrounded it), standalone

A wrapper runs the plain version only because the tensors it was given lie
on the CPU; for CUDA tensors it launches the kernel or raises, and counts
the launch in slab_kernels.LAUNCHES["sketch_update"] / ["sketch_scan"].
"""

from __future__ import annotations

import torch

from .slab_kernels import LAUNCHES, _M32, _check, _require, _u32, _wrap32, build

SKETCH_PLANES = 3
PLANE_FP_LO, PLANE_FP_HI, PLANE_COUNT = range(SKETCH_PLANES)


def _check_geometry(lanes: int, ways: int) -> int:
    if lanes <= 0 or lanes & (lanes - 1) or lanes >= (1 << 31):
        raise ValueError(f"lanes {lanes} must be a power of two below 2^31")
    ways = int(ways)
    if ways <= 0 or ways & (ways - 1) or ways > lanes:
        raise ValueError(f"ways {ways} must be a power of two <= lanes {lanes}")
    return ways


def sketch_scan_plain(planes, q_lo, q_hi, ways: int):
    """Plain version of the sketch scan (the reference's _sketch_scan with
    its set gathers): per query, over its set of `planes`
    (int32[3, lanes], uint32 bits) - (int32 match way, bool match any,
    int32 victim way, int32-bits victim count). Counts read signed; the
    match way is the first occupied lane holding the query's fingerprint,
    0 when none; the victim is the first way at the minimum count."""
    lanes = planes.shape[1]
    n_sets = lanes // ways
    set_idx = (q_lo & (n_sets - 1)).long()
    sets = planes.view(SKETCH_PLANES, n_sets, ways)
    rows_lo, rows_hi, cnt = (sets[p][set_idx] for p in range(SKETCH_PLANES))
    match = (cnt > 0) & (rows_lo == q_lo[:, None]) & (rows_hi == q_hi[:, None])
    m_any = match.any(dim=1)
    m_way = match.to(torch.uint8).argmax(dim=1)  # first match; 0 when none
    v_way = cnt.argmin(dim=1)  # first way at the minimum
    v_cnt = cnt.gather(1, v_way[:, None])[:, 0]
    return m_way.to(torch.int32), m_any, v_way.to(torch.int32), v_cnt


def sketch_scan(planes, q_lo, q_hi, ways: int):
    """The sketch set scan for each query (q_lo/q_hi int32[b], uint32
    bits) over its set `q_lo & (n_sets - 1)` of `ways` lanes of `planes`
    (int32[3, lanes]). Returns (int32[b] match way, bool[b] match any,
    int32[b] victim way, int32[b] victim count bits)."""
    device = planes.device
    _require(planes, "planes", torch.int32, 2, device)
    _require(q_lo, "q_lo", torch.int32, 1, device)
    _require(q_hi, "q_hi", torch.int32, 1, device)
    if planes.shape[0] != SKETCH_PLANES:
        raise ValueError(f"planes must be ({SKETCH_PLANES}, lanes)")
    lanes = planes.shape[1]
    ways = _check_geometry(lanes, ways)
    if q_hi.shape != q_lo.shape:
        raise ValueError("q_lo and q_hi must have the same shape")
    if device.type == "cpu":
        return sketch_scan_plain(planes, q_lo, q_hi, ways)
    if device.type != "cuda":
        raise ValueError(f"sketch_scan: unsupported device {device}")
    b = q_lo.shape[0]
    m_way = torch.empty(b, dtype=torch.int32, device=device)
    m_any = torch.empty(b, dtype=torch.bool, device=device)
    v_way = torch.empty(b, dtype=torch.int32, device=device)
    v_cnt = torch.empty(b, dtype=torch.int32, device=device)
    if b == 0:
        return m_way, m_any, v_way, v_cnt
    lib = build()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.rl_sketch_scan(
        planes.data_ptr(), lanes, q_lo.data_ptr(), q_hi.data_ptr(), b,
        lanes // ways, ways, m_way.data_ptr(), m_any.data_ptr(),
        v_way.data_ptr(), v_cnt.data_ptr(), stream,
    )
    _check("sketch_scan", err)
    LAUNCHES["sketch_scan"] += 1
    return m_way, m_any, v_way, v_cnt


def sketch_update_plain(planes, fp_lo, fp_hi, weight, cand, ways: int, scan=sketch_scan_plain):
    """Plain version of one launch's sketch update (ops/sketch.py module
    docstring): the scan, then phases A and B as torch ops, sync-free (no
    boolean-mask compaction; writes that must not land go to a scratch lane
    past the last). Returns new int32[SKETCH_PLANES, lanes] planes.
    scan=sketch_scan runs the update as the served path ran it before the
    fused kernel: the scan kernel, then the torch phases."""
    lanes = planes.shape[1]
    n_sets = lanes // ways
    dev = planes.device
    set_idx = (fp_lo & (n_sets - 1)).long()
    m_way, m_any, v_way, v_cnt = scan(planes, fp_lo, fp_hi, ways)
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


def sketch_update_fused(planes, fp_lo, fp_hi, weight, cand, ways: int):
    """One launch's sketch update: `planes` int32[3, lanes] (uint32 bits),
    the sorted batch's fp_lo/fp_hi and segment weights int32[b], cand
    bool[b] (one True per distinct key), set associativity `ways`. Returns
    fresh int32[3, lanes] planes; `planes` is not written.

    On the card this is one launch of csrc/sketch_kernels.cu
    sketch_update_kernel (scan, phase A and phase B), after a memset of its
    scratch, which is allocated here per call (launches come from more than
    one thread)."""
    device = planes.device
    _require(planes, "planes", torch.int32, 2, device)
    for name, t in (("fp_lo", fp_lo), ("fp_hi", fp_hi), ("weight", weight)):
        _require(t, name, torch.int32, 1, device)
    _require(cand, "cand", torch.bool, 1, device)
    if planes.shape[0] != SKETCH_PLANES:
        raise ValueError(f"planes must be ({SKETCH_PLANES}, lanes)")
    lanes = planes.shape[1]
    ways = _check_geometry(lanes, ways)
    b = fp_lo.shape[0]
    if any(t.shape[0] != b for t in (fp_hi, weight, cand)):
        raise ValueError("fp_lo, fp_hi, weight and cand must share the batch length")
    if device.type == "cpu":
        return sketch_update_plain(planes, fp_lo, fp_hi, weight, cand, ways)
    if device.type != "cuda":
        raise ValueError(f"sketch_update: unsupported device {device}")
    if b == 0:
        return planes.clone()
    lib = build()
    n_sets = lanes // ways
    if lib.rl_sketch_update_smem_bytes(lanes, n_sets) < 0:
        raise ValueError(
            f"sketch_update: {n_sets} sets of {lanes} lanes do not fit one block's shared memory"
        )
    out = torch.empty_like(planes)
    scratch = torch.empty(
        lib.rl_sketch_update_scratch_bytes(b, lanes, n_sets), dtype=torch.uint8, device=device
    )
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.rl_sketch_update(
        planes.data_ptr(), lanes, fp_lo.data_ptr(), fp_hi.data_ptr(),
        weight.data_ptr(), cand.data_ptr(), b, n_sets, ways, out.data_ptr(),
        scratch.data_ptr(), stream,
    )
    _check("sketch_update", err)
    LAUNCHES["sketch_update"] += 1
    return out
