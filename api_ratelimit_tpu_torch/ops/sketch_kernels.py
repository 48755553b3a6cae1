"""Port of api_ratelimit_tpu/ops/sketch.py pallas_sketch_scan: the sketch
update's kernel.

The kernel is CUDA C++ for sm_90a in csrc/sketch_kernels.cu, part of the one
library ops/slab_kernels.py builds. Beside it sits its plain PyTorch version:

    sketch_scan  <- pallas_sketch_scan (plus the set gathers of the planes
                    that surrounded it in ops/sketch.py sketch_update)

The wrapper runs the plain version only because the tensors it was given lie
on the CPU; for CUDA tensors it launches the kernel or raises, and counts the
launch in slab_kernels.LAUNCHES["sketch_scan"].
"""

from __future__ import annotations

import torch

from .slab_kernels import LAUNCHES, _check, _require, build

SKETCH_PLANES = 3


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
    ways = int(ways)
    if lanes <= 0 or lanes & (lanes - 1) or lanes >= (1 << 31):
        raise ValueError(f"lanes {lanes} must be a power of two below 2^31")
    if ways <= 0 or ways & (ways - 1) or ways > lanes:
        raise ValueError(f"ways {ways} must be a power of two <= lanes {lanes}")
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
