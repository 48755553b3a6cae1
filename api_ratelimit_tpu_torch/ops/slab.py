"""Port of api_ratelimit_tpu/ops/slab.py: the slab step, every algorithm.

The counter store is a W-way set-associative row table in device memory,
`int32[n_slots, ROW_WIDTH]` holding the reference's uint32 rows bit for bit
(torch's uint32 support is partial, so rows travel as int32 and every
unsigned compare or add is written out). A key lives only in set
`fp_lo & (n_sets - 1)`; a full set evicts its least-valuable way in place
(dead, then window-ended, then lowest-count live, rotation tiebreak).

The port covers the reference's steps, with the heavy-hitter sketch on or
off and slab_step_after's demote readback on or off (victim=True, the
VICTIM_TIER_ENABLED arm), in two bodies:

    multi_algo=False (fixed window only; the engine's program until its
    sticky guard sees another algorithm):
    way scan (kernel) -> eviction class -> packed-key stable sort
    -> INCRBY apply (kernel) -> one row scatter
    [-> segment weights -> sketch update (fused kernel, ops/sketch.py)]

    multi_algo=True (fixed window, sliding window, GCRA, concurrency and
    its release rows; the algorithm id rides bits 28-30 of the divider):
    way scan (kernel, multi-algorithm form: the sliding grace)
    -> eviction class -> packed-key stable sort -> the multi-algorithm
    body (torch ops, as XLA ran it: _multi_algo_body) -> one row scatter
    [-> sketch update (fused kernel)]; the decided steps then decide with
    ops/decide.py decide (the decide kernel on the card)

and then, per entry point:

    slab_step_after         after mode (production): unsort the counters,
                            saturating cast; the host decides
    slab_step_packed        the apply fuses the decision (kernel): one
                            uint32[9, b] block in sorted order + permutation
    slab_step_decided       the apply fuses only the code (lean kernel):
                            uint8 codes in arrival order
    slab_update_and_decide  the full decision, unsorted (SlabResult)

slab_promote_rows re-inserts the victim tier's rows (backends/victim.py)
ahead of a launch: the way scan's multi-algorithm form places them, and the
gather, stable sort and scatter around it are torch ops, as they were XLA
glue in the reference.

On CUDA tables the fixed-window decided steps run the fused INCRBY+decide
kernel, as the reference's use_pallas=True does on the TPU; on CPU tables the
apply's plain version runs ops/decide.py decide_plain, as the reference's XLA
twin does. The reference runs its multi-algorithm body only in XLA (its
Mosaic kernels are fixed-window only); the port runs the way scan and sketch
kernels around it, which compute the same function. The entry points default
to multi_algo=False, the engine's program until its guard flips (the
reference defaults to True); an all-fixed batch gives the same bytes either
way.

The slab's kernels live in ops/slab_kernels.py (CUDA C++ in csrc/), which
also defines the row layout; the glue between the kernels stays plain torch
ops, as XLA owned it on the TPU. Unlike the reference's donated, immutable
state, the step updates `state.table` in place.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .decide import DecideResult
from .decide import decide as decide_items
from .hashing import set_index
from .sketch import sketch_update
from .slab_kernels import (  # noqa: F401  (the row layout is re-exported)
    _M32,
    _gather_sets,
    ALGO_DIV_MASK,
    ALGO_SHIFT,
    COL_AUX,
    COL_COUNT,
    COL_DIVIDER,
    COL_EXPIRE,
    COL_FP_HI,
    COL_FP_LO,
    COL_PREV,
    COL_WINDOW,
    ROW_WIDTH,
    SCORE_TIER_SHIFT,
    TIER_DEAD,
    TIER_LIVE,
    TIER_WINDOW_ENDED,
    _u32,
    _wrap32,
    resolve_device,
    slab_apply,
    way_scan,
    window_span,
)

(
    ALGO_FIXED_WINDOW,
    ALGO_SLIDING_WINDOW,
    ALGO_GCRA,
    ALGO_CONCURRENCY,
    ALGO_CONC_RELEASE,
) = range(5)
ALGO_NAMES = {
    ALGO_FIXED_WINDOW: "fixed_window",
    ALGO_SLIDING_WINDOW: "sliding_window",
    ALGO_GCRA: "gcra",
    ALGO_CONCURRENCY: "concurrency",
}
GCRA_TAT_CAP_MS = 1 << 30
GCRA_DIV_CAP_S = 1_000_000

# One warp-strided scan of 128 ways per set on the card (the kernel's
# shape); a cache-line-scale set on hosts, as in the reference.
DEFAULT_WAYS = 128
DEFAULT_WAYS_HOST = 4

(
    HEALTH_EVICT_EXPIRED,
    HEALTH_EVICT_WINDOW,
    HEALTH_EVICT_LIVE,
    HEALTH_DROPS,
    HEALTH_ALGO_RESETS,
) = range(5)
HEALTH_WIDTH = 5

EVICT_NONE, EVICT_EXPIRED, EVICT_WINDOW, EVICT_LIVE = range(4)

# packed launch operand rows (uint32[7, b]); row 6 carries the scalars
ROW_FP_LO, ROW_FP_HI, ROW_HITS, ROW_LIMIT, ROW_DIVIDER, ROW_JITTER, ROW_SCALARS = range(7)
PACKED_IN_ROWS = 7
OUT_CODE, OUT_REMAINING, OUT_DURATION, OUT_THROTTLE, OUT_NEAR, OUT_OVER, OUT_BEFORE, OUT_AFTER, OUT_ORDER = range(9)
PACKED_OUT_ROWS = 9

# saturating readback widths (numpy dtype -> torch dtype)
_TORCH_UNSIGNED = {
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.uint32): torch.uint32,
}


class SlabBatch(NamedTuple):
    """One launch's items on the device, int32[b] each (uint32 bits where
    the reference is unsigned). hits == 0 marks padding."""

    fp_lo: torch.Tensor
    fp_hi: torch.Tensor
    hits: torch.Tensor
    limit: torch.Tensor  # requests_per_unit
    divider: torch.Tensor  # seconds per window
    jitter: torch.Tensor  # expiry jitter seconds


class SlabResult(NamedTuple):
    """slab_update_and_decide's result, in arrival order: int32[b] before
    and after (uint32 bits), the DecideResult, int64[5] health."""

    before: torch.Tensor
    after: torch.Tensor
    decision: DecideResult
    health: torch.Tensor


def default_ways(platform: str) -> int:
    """Platform-matched set associativity for SLAB_WAYS=0 (auto): the
    kernel's 128 on the card, 4 on hosts."""
    return DEFAULT_WAYS if platform == "cuda" else DEFAULT_WAYS_HOST


def validate_ways(n_slots: int, ways: int) -> int:
    """Ways must be a power of two; a slab smaller than one set runs fully
    associative (ways = n_slots)."""
    ways = int(ways)
    if ways <= 0 or ways & (ways - 1):
        raise ValueError(f"ways must be a positive power of two, got {ways}")
    return min(ways, n_slots)


class SlabState:
    """The row table, `int32[n_slots, ROW_WIDTH]` (uint32 bits). `table` is
    a view of the first n_slots rows of `rows`, whose one extra row is
    scratch: the step's scatter sends the writes that must not land there,
    so it needs no mask compaction and no host sync."""

    __slots__ = ("rows", "table")

    def __init__(self, n_slots: int, device: torch.device):
        self.rows = torch.zeros(
            (n_slots + 1, ROW_WIDTH), dtype=torch.int32, device=device
        )
        self.table = self.rows[:n_slots]

    @property
    def n_slots(self) -> int:
        return self.table.shape[0]

    @property
    def device(self) -> torch.device:
        return self.table.device


def make_slab(n_slots: int, device="cuda") -> SlabState:
    if n_slots <= 0 or n_slots & (n_slots - 1):
        raise ValueError(f"n_slots must be a power of two, got {n_slots}")
    return SlabState(n_slots, resolve_device(device))


def _choose_ways(
    state: SlabState, fp_lo, fp_hi, hits, now: int, ways: int, multi_algo: bool = False
):
    """The W-wide set scan; returns (int64[b] chosen slot = set * W + way,
    n_slots for padding; int64[b] eviction class; bool[b] matched;
    int32[b, ROW_WIDTH] the chosen way's stored row). multi_algo runs the
    scan's multi-algorithm form and classifies evictions with the same
    sliding grace (window_span), so the health counters see what the scan
    saw."""
    n = state.n_slots
    way, match_any, picked = way_scan(state.table, fp_lo, fp_hi, now, ways, multi_algo=multi_algo)
    set_idx = set_index(fp_lo, n // ways).long()
    chosen = set_idx * ways + way.long()

    p_expire = picked[:, COL_EXPIRE]
    p_window = picked[:, COL_WINDOW].long()
    p_div = (picked[:, COL_DIVIDER] & ALGO_DIV_MASK).long()
    p_span = window_span(picked[:, COL_DIVIDER], True) if multi_algo else p_div
    p_live = p_expire > now
    p_window_ended = p_live & (p_div > 0) & (_wrap32(p_window + p_span) <= now)
    valid = hits != 0
    evict_class = torch.where(
        match_any | ~valid,
        EVICT_NONE,
        torch.where(
            p_live,
            torch.where(p_window_ended, EVICT_WINDOW, EVICT_LIVE),
            torch.where(p_expire > 0, EVICT_EXPIRED, EVICT_NONE),
        ),
    )
    return (
        torch.where(valid, chosen, n),
        evict_class,
        match_any & valid,
        picked,
    )


def _sort_key(chosen, matched, fp_hi, n: int) -> torch.Tensor:
    """The packed key of the reference (slot, then the matched bit, then
    the top fp_hi bits), held in int64: it fills all 32 bits, so an int32
    sort would misorder keys above 2^31."""
    slot_bits = n.bit_length()
    fp_bits = max(0, min(16, 32 - slot_bits - 1))
    key = ((chosen << 1) | matched.long()) & _M32
    if not fp_bits:
        return key
    return ((key << fp_bits) & _M32) | (_u32(fp_hi) >> (32 - fp_bits))


def _unsort(values: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """out[order[i]] = values[i]."""
    out = torch.empty_like(values)
    out[order] = values
    return out


def _host_operand(packed) -> np.ndarray:
    """The launch operand as a contiguous host uint32[7, b]."""
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    if packed.ndim != 2 or packed.shape[0] != PACKED_IN_ROWS:
        raise ValueError(f"packed operand must be (7, b), got {packed.shape}")
    return packed


def _operand_for(packed, multi_algo: bool):
    """The operand of a decided entry point. With multi_algo=False it is
    refused when a divider word carries algorithm bits: those entry points
    have no engine in front of them to refuse a sibling algorithm's rows,
    and that body is fixed-window only. A host check: it costs no device
    sync."""
    if multi_algo:
        return packed
    packed = _host_operand(packed)
    if np.any(packed[ROW_DIVIDER] & np.uint32(7 << ALGO_SHIFT)):
        raise ValueError(
            "a divider word carries algorithm bits: pass multi_algo=True "
            "(the fixed-window body serves fixed_window only)"
        )
    return packed


def _unpack(packed, device) -> tuple[SlabBatch, int, float, float]:
    """Host operand uint32[7, b] -> (the batch on `device`, now, near_ratio,
    burst_ratio): `now` is [6, 0] as int32, near_ratio the float32 bitcast
    of [6, 1] and the GCRA burst ratio that of [6, 2], where 0 (a producer
    that predates the slot) means 1.0. `packed` is the numpy operand, or
    the same bits as a host int32 tensor (the engine's operand pool, pinned
    on the card), whose upload is non-blocking: the caller must not rewrite
    it before the launch's work on the stream has finished
    (backends/cuda.py fences it)."""
    if isinstance(packed, torch.Tensor):
        if (
            packed.device.type != "cpu"
            or packed.dtype != torch.int32
            or packed.dim() != 2
            or packed.shape[0] != PACKED_IN_ROWS
            or not packed.is_contiguous()
        ):
            raise ValueError(
                "a tensor operand must be a contiguous host int32[7, b], got "
                f"{packed.dtype} {tuple(packed.shape)} on {packed.device}"
            )
        uploaded = packed[: ROW_JITTER + 1].to(device, non_blocking=True)
        packed = packed.numpy().view(np.uint32)
    else:
        packed = _host_operand(packed)
        uploaded = torch.from_numpy(packed.view(np.int32)[: ROW_JITTER + 1]).to(device)
    now = int(packed.view(np.int32)[ROW_SCALARS, 0])
    # the reference's static indices clamp to the last column: at b == 1
    # near_ratio is `now`'s bits, and at b <= 2 the burst slot is column
    # b - 1
    last = packed.shape[1] - 1
    near_ratio = float(packed[ROW_SCALARS, min(1, last) :][:1].view(np.float32)[0])
    burst = packed[ROW_SCALARS, min(2, last) :][:1]
    burst_ratio = float(burst.view(np.float32)[0]) if burst[0] else 1.0
    return SlabBatch(*uploaded), now, near_ratio, burst_ratio


def _finish_update(
    state, order, s_slot, same_prev, evict_class, s_fp_lo, s_fp_hi, s_hits,
    s_div, s_after, cur_window, expire, count_health=True, multi=None,
):
    """One row write per slot (the slot's last sorted item) and the health
    vector: the eviction mix of winning writes plus contention drops
    (zeros when count_health is False). `multi` is the multi-algorithm
    body's (prev_store, aux_store, algo_reset), the row's columns 6-7 and
    the matches whose stored algorithm differed (counted on winning writes
    as algorithm resets); without it columns 6-7 are written 0 and no reset
    is counted, the fixed-window body's bytes. s_div is the divider word
    to store (window length and algorithm id), s_after, cur_window and
    expire the count, window and expire columns."""
    n = state.n_slots
    dev = s_slot.device
    true1 = torch.ones(1, dtype=torch.bool, device=dev)
    is_last = torch.cat([s_slot[1:] != s_slot[:-1], true1])
    s_valid = s_hits != 0
    win = s_valid & is_last
    if count_health:
        seg_end = torch.cat([~same_prev, true1])
        s_class = evict_class[order]
        health = torch.stack(
            [
                (win & (s_class == cls)).sum()
                for cls in (EVICT_EXPIRED, EVICT_WINDOW, EVICT_LIVE)
            ]
            + [
                (s_valid & seg_end & ~is_last).sum(),
                (win & multi[2]).sum() if multi is not None
                else torch.zeros((), dtype=torch.int64, device=dev),
            ]
        )
    else:
        health = torch.zeros(HEALTH_WIDTH, dtype=torch.int64, device=dev)
    if multi is None:
        prev = aux = torch.zeros_like(s_fp_lo)
    else:
        prev, aux = multi[0], multi[1]
    new_rows = torch.stack(
        [s_fp_lo, s_fp_hi, s_after, cur_window, expire, s_div, prev, aux],
        dim=1,
    )
    # the reference's scatter mode="drop": only winning writes land; the
    # rest go to the scratch row n (winning slots are unique, so no two
    # writes that land share a row)
    write_idx = torch.where(win & (s_slot < n), s_slot, n)
    state.rows.index_put_((write_idx,), new_rows)
    return health


def _segment_weights(s_hits, seg_start):
    """The sketch's weights over a slot-sorted batch on the CPU: each item's
    running total within its distinct-key segment, in uint32 wraparound -
    the reference's cumsum/cummax forward fill - so a segment's last row
    carries its total hits. Returns int32 weight bits. On the card the
    apply kernel stores the same plane (slab_apply(weight=True))."""
    hits = _u32(s_hits)
    incl = torch.cumsum(hits, dim=0) & _M32
    excl = (incl - hits) & _M32
    seg_base = torch.cummax(torch.where(seg_start, excl, 0), dim=0).values
    return _wrap32((incl - seg_base) & _M32).to(torch.int32)


def _fdiv(a: torch.Tensor, b) -> torch.Tensor:
    """Exact floor division of int64 values: the reference's
    floor_div_exact_i32, which is exact for every int32 dividend and the
    divisors (1 ... 2^30) the body gives it."""
    return torch.div(a, b, rounding_mode="floor")


class _MultiOut(NamedTuple):
    """The multi-algorithm body's per-item results, sorted order, int32 bits."""

    before: torch.Tensor  # uint32 bits
    after: torch.Tensor  # uint32 bits
    div: torch.Tensor  # the window length (the divider word's bits 0-27)
    count: torch.Tensor  # the row's columns 2-7 to store
    window: torch.Tensor
    expire: torch.Tensor
    div_word: torch.Tensor
    prev: torch.Tensor
    aux: torch.Tensor
    algo_reset: torch.Tensor  # bool: a match whose stored algorithm differed
    weight: torch.Tensor  # the sketch's segment weight, prior + hits


def _multi_algo_body(
    now: int, s_fp_lo, s_fp_hi, s_hits, s_limit, s_div, s_jit, seg_start, st_rows,
    burst_ratio: float,
) -> _MultiOut:
    """The reference's multi-algorithm body (api_ratelimit_tpu/ops/slab.py
    _slab_update_sorted, multi_algo=True, use_pallas=False) over a
    slot-sorted batch: the fixed-window counter core, the sliding window's
    two-window interpolation, GCRA's TAT in int32 milliseconds, concurrency
    acquires and releases (releases apply after the same batch's acquires,
    the count floors at 0), and each algorithm's row stores. Plain torch
    ops, as XLA ran it on the TPU.

    Values are held as int64: uint32 ones in [0, 2^32) (every sum masked,
    as the reference's uint32 cumsums wrap, and every running max taken
    over the wrapped values), int32 ones wrapped after each add, subtract
    and multiply (_wrap32) where the reference's int32 op would wrap. The
    two float32 spots, GCRA's tau here and the near threshold in
    ops/decide.py, are one IEEE float32 multiply then a floor; tau's
    float-to-int32 convert saturates, as XLA's does."""
    dev = s_hits.device
    hits = _u32(s_hits)
    limit_u = _u32(s_limit)
    valid = hits != 0
    incl = torch.cumsum(hits, dim=0) & _M32
    excl = (incl - hits) & _M32
    seg_base = torch.cummax(torch.where(seg_start, excl, 0), dim=0).values
    prior = (excl - seg_base) & _M32

    st_count = _u32(st_rows[:, COL_COUNT])
    st_window = st_rows[:, COL_WINDOW].long()
    st_expire = st_rows[:, COL_EXPIRE]
    st_algo = (st_rows[:, COL_DIVIDER].long() >> ALGO_SHIFT) & 7
    st_prev = st_rows[:, COL_PREV].long()  # int32 value (uint32 bits)
    st_aux = st_rows[:, COL_AUX].long()

    # the wire divider word: window length low, algorithm id high; a
    # release row (id 4) mutates a stored concurrency (3) row
    word = s_div.long()
    algo = (word >> ALGO_SHIFT) & 7
    div = word & ALGO_DIV_MASK
    store_algo = torch.where(algo == ALGO_CONC_RELEASE, ALGO_CONCURRENCY, algo)
    safe_div = torch.clamp(div, min=1)
    cur_window = _wrap32(_fdiv(torch.full_like(safe_div, now), safe_div) * safe_div)
    slot_live = st_expire > now
    fp_match = slot_live & (st_rows[:, COL_FP_LO] == s_fp_lo) & (st_rows[:, COL_FP_HI] == s_fp_hi)
    algo_same = st_algo == store_algo
    match_ok = fp_match & algo_same
    algo_reset = fp_match & ~algo_same
    same_window = st_window == cur_window

    # fixed / sliding: the shared windowed counter
    base = torch.where(valid & match_ok & same_window, st_count, 0)
    before_raw = (base + prior) & _M32
    after_raw = (before_raw + hits) & _M32
    expire_at = _wrap32(now + safe_div + s_jit.long())

    is_slide = algo == ALGO_SLIDING_WINDOW
    is_gcra = algo == ALGO_GCRA
    is_acq = algo == ALGO_CONCURRENCY
    is_rel = algo == ALGO_CONC_RELEASE
    is_conc = is_acq | is_rel

    # sliding window: cur + floor(prev * (div - elapsed) / div), prev
    # clamped so the int32 product cannot overflow (a count >= 2^31 reads
    # as a negative int32, as in the reference)
    prev_raw = torch.where(
        match_ok & same_window,
        st_prev & _M32,
        torch.where(match_ok & (st_window == _wrap32(cur_window - safe_div)), st_count, 0),
    )
    elapsed = _wrap32(now - cur_window)
    prev_cap = _fdiv(torch.full_like(safe_div, 0x7FFFFFFF), safe_div)
    prev_c = torch.minimum(_wrap32(prev_raw), prev_cap)
    carried = _fdiv(_wrap32(prev_c * (safe_div - elapsed)), safe_div) & _M32

    # GCRA: int32 milliseconds relative to now
    limit_c = torch.clamp(_wrap32(limit_u), min=1)
    div_ms = torch.clamp(safe_div, max=GCRA_DIV_CAP_S) * 1000
    t_ms = torch.clamp(_fdiv(div_ms, limit_c), min=1)
    ratio = torch.tensor(np.float32(burst_ratio), device=dev)
    tau_f = torch.floor(div_ms.to(torch.float32) * ratio).double()
    tau_i = torch.clamp(tau_f, -(1 << 31), (1 << 31) - 1).long()
    tau = torch.clamp(_wrap32(tau_i - t_ms), min=0)
    tat_dsec = torch.clamp(_wrap32(st_prev - now), -(1 << 20), 1 << 20)
    tat0 = torch.clamp(_wrap32(tat_dsec * 1000 + st_aux), min=0)
    tat0 = torch.where(match_ok & is_gcra, tat0, 0)
    # admit <=> prior <= floor((tau - tat0) / T): a segment's admits are a
    # prefix, and the admitted total is the running max of the admitted
    # inclusive prefix, floored at the segment base
    q_admissible = _fdiv(torch.clamp(tau - tat0, min=0), t_ms)
    admit_g = valid & is_gcra & (tat0 <= tau) & (prior <= q_admissible)
    adm_run = torch.cummax(
        torch.maximum(torch.where(admit_g, incl, 0), torch.where(seg_start, excl, 0)), dim=0
    ).values
    adm_total_g = (adm_run - seg_base) & _M32
    a_cap = _fdiv(torch.full_like(t_ms, GCRA_TAT_CAP_MS), t_ms)
    a_eff = torch.minimum(_wrap32(adm_total_g), a_cap)
    tat_new = torch.clamp(_wrap32(tat0 + _wrap32(a_eff * t_ms)), max=GCRA_TAT_CAP_MS)
    tat_sec_new = _wrap32(now + _fdiv(tat_new, 1000))
    tat_frac = _wrap32(tat_new - _wrap32(tat_sec_new - now) * 1000)
    # the synthesized counter position: <= limit iff admitted
    used0 = _fdiv(_wrap32(tat0 + t_ms - 1), t_ms) & _M32
    vafter = (used0 + prior + hits) & _M32
    over_after = (limit_u + hits) & _M32
    after_gcra = torch.where(admit_g, torch.minimum(vafter, limit_u), over_after)

    # concurrency: the in-flight count, acquires then releases
    count0 = torch.where(match_ok & is_conc, st_count, 0)
    hits_acq = torch.where(is_acq & valid, hits, 0)
    hits_rel = torch.where(is_rel & valid, hits, 0)
    incl_a = torch.cumsum(hits_acq, dim=0) & _M32
    excl_a = (incl_a - hits_acq) & _M32
    segbase_a = torch.cummax(torch.where(seg_start, excl_a, 0), dim=0).values
    prior_a = (excl_a - segbase_a) & _M32
    pos_a = (count0 + prior_a + hits) & _M32
    admit_c = valid & is_acq & (pos_a <= limit_u)
    adm_run_c = torch.cummax(
        torch.maximum(torch.where(admit_c, incl_a, 0), torch.where(seg_start, excl_a, 0)), dim=0
    ).values
    adm_total_c = (adm_run_c - segbase_a) & _M32
    incl_r = torch.cumsum(hits_rel, dim=0) & _M32
    segbase_r = torch.cummax(torch.where(seg_start, (incl_r - hits_rel) & _M32, 0), dim=0).values
    rel_total = (incl_r - segbase_r) & _M32
    count_acq = (count0 + adm_total_c) & _M32
    count_conc = torch.where(count_acq >= rel_total, count_acq - rel_total, 0)
    after_conc = torch.where(is_rel, 0, torch.where(admit_c, pos_a, over_after))

    # per item: fixed window is the default arm
    s_after = torch.where(
        is_slide,
        (after_raw + carried) & _M32,
        torch.where(is_gcra, after_gcra, torch.where(is_conc, after_conc, after_raw)),
    )
    s_before = torch.where(
        is_slide,
        (before_raw + carried) & _M32,
        torch.where(
            is_gcra | is_conc, torch.where(s_after >= hits, s_after - hits, 0), before_raw
        ),
    )

    # the row's stores
    count_store = torch.where(
        is_gcra,
        torch.clamp(_fdiv(tat_new, t_ms), max=ALGO_DIV_MASK) & _M32,
        torch.where(is_conc, count_conc, after_raw),
    )
    window_store = torch.where(
        is_gcra,
        _wrap32(tat_sec_new - safe_div),
        torch.where(is_conc, torch.full_like(cur_window, now), cur_window),
    )
    expire_store = torch.where(
        is_slide,
        # the prev count must survive into the next window's interpolation
        _wrap32(expire_at + safe_div),
        # a GCRA row lives until its TAT drains, plus one window
        torch.where(is_gcra, _wrap32(expire_at + _fdiv(_wrap32(tat_new + 999), 1000)), expire_at),
    )
    div_store = div | (store_algo << ALGO_SHIFT)
    prev_store = torch.where(is_slide, prev_raw, torch.where(is_gcra, tat_sec_new & _M32, 0))
    aux_store = torch.where(is_gcra, tat_frac & _M32, 0)

    as_i32 = lambda x: _wrap32(x).to(torch.int32)  # noqa: E731
    return _MultiOut(
        *(as_i32(x) for x in (
            s_before, s_after, div, count_store, window_store, expire_store,
            div_store, prev_store, aux_store,
        )),
        algo_reset,
        as_i32(prior + hits),
    )


def _slab_update_sorted(
    state: SlabState,
    batch: SlabBatch,
    now: int,
    ways: int,
    count_health: bool = True,
    near_ratio: float = 0.8,
    decide: bool = False,
    lean: bool = False,
    sketch: torch.Tensor | None = None,
    sketch_ways: int = 0,
    multi_algo: bool = False,
    burst_ratio: float = 1.0,
    victim: bool = False,
):
    """The stateful core of every step: set scan, serialize duplicates,
    window rollover, increment, one row scatter, in place. Returns, in
    slot-sorted order, (s_before, s_after, (s_hits, s_limit, s_div), order,
    health, decision), the updated sketch planes as a next element when
    `sketch` is given, and with victim=True the demote readback as the last
    element: int32[b, ROW_WIDTH] in sorted order, each lane the stored row
    a winning insert displaced from a live in-window way (EVICT_LIVE, the
    only lossy eviction class) or all-zero. It is recomputed from the
    eviction class, so it never depends on count_health.

    decide=True decides at `near_ratio`: `decision` is then the
    DecideResult (lean=True: the code alone, the other five fields None)
    and s_limit the sorted limits; with decide=False both are None. The
    fixed-window body fuses the decision into the apply kernel; the
    multi-algorithm body (multi_algo=True, GCRA tau at `burst_ratio`) runs
    the standalone decide after it, over its before/after and the masked
    window length (s_div). count_health=False skips the health reductions
    (zeros come back)."""
    n = state.n_slots
    chosen, evict_class, matched, picked = _choose_ways(
        state, batch.fp_lo, batch.fp_hi, batch.hits, now, ways, multi_algo
    )
    key = _sort_key(chosen, matched, batch.fp_hi, n)
    order = torch.sort(key, stable=True).indices
    s_slot = chosen[order]
    s_fp_lo = batch.fp_lo[order]
    s_fp_hi = batch.fp_hi[order]
    s_hits = batch.hits[order]
    s_div = batch.divider[order]
    s_jit = batch.jitter[order]
    s_limit = batch.limit[order] if decide or multi_algo else None
    same_prev = (
        (s_slot[1:] == s_slot[:-1])
        & (s_fp_lo[1:] == s_fp_lo[:-1])
        & (s_fp_hi[1:] == s_fp_hi[:-1])
    )
    true1 = torch.ones(1, dtype=torch.bool, device=state.device)
    seg_start = torch.cat([true1, ~same_prev])
    st_rows = picked[order]

    decision = None
    if multi_algo:
        body = _multi_algo_body(
            now, s_fp_lo, s_fp_hi, s_hits, s_limit, s_div, s_jit, seg_start, st_rows, burst_ratio
        )
        s_before, s_after, weight = body.before, body.after, body.weight
        health = _finish_update(
            state, order, s_slot, same_prev, evict_class, s_fp_lo, s_fp_hi,
            s_hits, body.div_word, body.count, body.window, body.expire, count_health,
            multi=(body.prev, body.aux, body.algo_reset),
        )
        s_div = body.div
        if decide:
            d = decide_items(s_before, s_after, s_hits, s_limit, s_div, now, near_ratio)
            decision = DecideResult(d.code, *[None] * 5) if lean else d
    else:
        # on the card the sketch's segment weights come from the apply's own
        # scan; on the CPU _segment_weights recomputes them
        weight_from_apply = sketch is not None and state.device.type == "cuda"
        outs = slab_apply(
            s_fp_lo, s_fp_hi, s_hits, s_div, s_jit, seg_start, st_rows, now,
            s_limit=s_limit, near_ratio=near_ratio, decide=decide, lean=lean,
            weight=weight_from_apply,
        )
        if weight_from_apply:
            *outs, weight = outs
        s_before, s_after, cur_window, expire = outs[:4]
        if decide:
            decision = DecideResult(outs[4], *[None] * 5) if lean else DecideResult(*outs[4:])
        health = _finish_update(
            state, order, s_slot, same_prev, evict_class, s_fp_lo, s_fp_hi,
            s_hits, s_div, s_after, cur_window, expire, count_health,
        )
        if sketch is not None and not weight_from_apply:
            weight = _segment_weights(s_hits, seg_start)
    result = (s_before, s_after, (s_hits, s_limit if decide else None, s_div), order, health, decision)
    if victim:
        # the demote readback: the reference's _finish_update, the winning
        # write of each slot over a live in-window way
        is_last = torch.cat([s_slot[1:] != s_slot[:-1], true1])
        demote = (s_hits != 0) & is_last & (evict_class[order] == EVICT_LIVE)
        victim_rows = torch.where(demote[:, None], st_rows, 0)
    if sketch is not None:
        # one candidate per distinct-key segment, its last row (padding
        # segments carry hits 0 there and drop out)
        cand = torch.cat([~same_prev, true1]) & (s_hits != 0)
        result = (*result, sketch_update(sketch, s_fp_lo, s_fp_hi, weight, cand, sketch_ways))
    return (*result, victim_rows) if victim else result


def slab_step_after(
    state: SlabState,
    packed: np.ndarray,
    ways: int = DEFAULT_WAYS,
    out_dtype=np.uint32,
    sketch: torch.Tensor | None = None,
    sketch_ways: int = 0,
    multi_algo: bool = False,
    victim: bool = False,
):
    """One launch: stateful update only. `packed` is the host operand
    uint32[7, b] (fp_lo, fp_hi, hits, limit, divider, jitter, scalars with
    `now` in [6, 0] and the GCRA burst ratio in [6, 2]), as numpy or as a
    host int32 tensor (_unpack). Returns (post-increment counters in
    arrival order, saturating-cast to out_dtype, as a device tensor of that
    width; int64[5] health vector on the device). The table updates in
    place. multi_algo=True runs the multi-algorithm body; with False the
    fixed-window body runs, and a row with another algorithm id is the
    caller's to route (backends/cuda.py's sticky guard) or refuse.

    A non-None `sketch` (hotkey planes, ops/sketch.py; the HOTKEYS_ENABLED
    arm) appends the updated planes as a third element, with `sketch_ways`
    its set associativity. None runs exactly the sketch-free step.

    victim=True (the VICTIM_TIER_ENABLED arm) appends the demote readback
    as the last element: uint32[b, ROW_WIDTH] in slot-sorted order, each
    nonzero lane the full stored row this launch displaced from a live
    in-window way, for the host to drain into the victim tier
    (backends/victim.py). False runs exactly the step without it."""
    batch, now, _near_ratio, burst_ratio = _unpack(packed, state.device)
    _before, s_after, _inputs, order, health, _none, *extra = _slab_update_sorted(
        state, batch, now, ways, sketch=sketch, sketch_ways=sketch_ways,
        multi_algo=multi_algo, burst_ratio=burst_ratio, victim=victim,
    )
    after = _u32(_unsort(s_after, order))
    out_dtype = np.dtype(out_dtype)
    cap = int(np.iinfo(out_dtype).max)
    out = torch.clamp(after, max=cap).to(_TORCH_UNSIGNED[out_dtype])
    if victim:
        extra[-1] = extra[-1].view(torch.uint32)
    return (out, health, *extra)


def _slab_step_sorted(
    state: SlabState,
    batch: SlabBatch,
    now: int,
    near_ratio: float,
    ways: int,
    count_health: bool = True,
    lean: bool = False,
    sketch: torch.Tensor | None = None,
    sketch_ways: int = 0,
    multi_algo: bool = False,
    burst_ratio: float = 1.0,
):
    """The step with the decision on the device: (s_before, s_after,
    DecideResult, order, health), all in slot-sorted order, plus the
    updated sketch planes when `sketch` is given. On a CUDA table the
    fixed-window body's apply kernel computes the decision (lean=True: the
    code alone, the other fields None), and the multi-algorithm body's
    decision is the decide kernel's; on a CPU table decide_plain runs."""
    s_before, s_after, _inputs, order, health, decision, *new_sketch = _slab_update_sorted(
        state, batch, now, ways, count_health, near_ratio=near_ratio,
        decide=True, lean=lean, sketch=sketch, sketch_ways=sketch_ways,
        multi_algo=multi_algo, burst_ratio=burst_ratio,
    )
    return (s_before, s_after, decision, order, health, *new_sketch)


def slab_step_packed(
    state: SlabState,
    packed: np.ndarray,
    ways: int = DEFAULT_WAYS,
    sketch: torch.Tensor | None = None,
    sketch_ways: int = 0,
    multi_algo: bool = False,
):
    """One launch with the full decision on the device: `packed` is the
    host operand uint32[7, b], near_ratio the float32 in [6, 1]. Returns
    (uint32[9, b] device block in slot-sorted order, rows OUT_CODE ...
    OUT_AFTER and the permutation in OUT_ORDER; int64[5] health), plus the
    updated sketch planes when `sketch` is given. With multi_algo=False
    (the fixed-window body) an operand with algorithm bits raises
    ValueError."""
    batch, now, near_ratio, burst_ratio = _unpack(_operand_for(packed, multi_algo), state.device)
    s_before, s_after, d, order, health, *new_sketch = _slab_step_sorted(
        state, batch, now, near_ratio, ways, sketch=sketch, sketch_ways=sketch_ways,
        multi_algo=multi_algo, burst_ratio=burst_ratio,
    )
    out = torch.stack([*d, s_before, s_after, order.to(torch.int32)]).view(torch.uint32)
    return (out, health, *new_sketch)


def slab_step_decided(
    state: SlabState,
    packed: np.ndarray,
    ways: int = DEFAULT_WAYS,
    count_health: bool = True,
    sketch: torch.Tensor | None = None,
    sketch_ways: int = 0,
    multi_algo: bool = False,
):
    """One launch of the decided mode: only the code per item comes back.
    Returns (uint8[b] codes in arrival order, 1=OK and 2=OVER_LIMIT;
    int64[5] health, zeros when count_health is False), plus the updated
    sketch planes when `sketch` is given. On the card the fixed-window
    body's apply runs lean (it computes and stores the code and no other
    decision field); the multi-algorithm body decides with the decide
    kernel. With multi_algo=False an operand with algorithm bits raises
    ValueError."""
    batch, now, near_ratio, burst_ratio = _unpack(_operand_for(packed, multi_algo), state.device)
    _before, _after, d, order, health, *new_sketch = _slab_step_sorted(
        state, batch, now, near_ratio, ways, count_health, lean=True,
        sketch=sketch, sketch_ways=sketch_ways, multi_algo=multi_algo, burst_ratio=burst_ratio,
    )
    return (_unsort(d.code, order).to(torch.uint8), health, *new_sketch)


def slab_update_and_decide(
    state: SlabState, packed: np.ndarray, ways: int = DEFAULT_WAYS, multi_algo: bool = False
) -> SlabResult:
    """One launch with the full decision, every field in arrival order.
    With multi_algo=False an operand with algorithm bits raises
    ValueError."""
    batch, now, near_ratio, burst_ratio = _unpack(_operand_for(packed, multi_algo), state.device)
    s_before, s_after, d, order, health = _slab_step_sorted(
        state, batch, now, near_ratio, ways, multi_algo=multi_algo, burst_ratio=burst_ratio
    )
    return SlabResult(
        before=_unsort(s_before, order),
        after=_unsort(s_after, order),
        decision=DecideResult(*(_unsort(f, order) for f in d)),
        health=health,
    )


def slab_promote_rows(state: SlabState, rows, now: int, ways: int = DEFAULT_WAYS):
    """Re-insert demoted rows from the host-RAM victim tier
    (backends/victim.py) ahead of a launch that is about to touch their
    keys, in place: the reference's slab_promote_rows. `rows` is uint32[k,
    ROW_WIDTH] (numpy, or a tensor of uint32/int32 bits), all-zero lanes
    padding. A row lands with its counter, window, divider, algorithm bits
    and sliding/GCRA words intact, so a demoted key resumes mid-window.

    Placement rides the hot path's way scan in its multi-algorithm form
    (the reference's _choose_ways default), so a promoted row lands where a
    request for its key will look, and the sliding grace classifies ended
    windows as the reference does. Per lane:

      * fp match: keep-the-newest (greater window wins, equal windows keep
        the greater count); either way the lane reports landed;
      * no match: the row overwrites the scan's victim way, and a live
        in-window row it displaces comes back in `displaced`.

    Lanes picking one slot serialize on (slot << 1) | matched, a stable
    sort with the reference's two-field key (not the hot path's packed
    key): the run's last lane writes if it wants to, the others report
    landed False and stay in the tier. Padding lanes, and rows whose own
    expire_at has passed, choose the scratch row n and report landed False.

    Returns (bool[k] landed in arrival order, uint32[k, ROW_WIDTH]
    displaced rows in sorted order, nonzero lanes only), device tensors."""
    n = state.n_slots
    dev = state.device
    if isinstance(rows, torch.Tensor):
        rows = rows.to(dev).view(torch.int32)
    else:
        rows = np.ascontiguousarray(rows, dtype=np.uint32)
        rows = torch.from_numpy(rows.view(np.int32)).to(dev)
    k = rows.shape[0]
    now = ((int(now) + (1 << 31)) & _M32) - (1 << 31)  # int32, as the reference's
    valid = rows[:, COL_EXPIRE] > now
    fp_lo, fp_hi = rows[:, COL_FP_LO].contiguous(), rows[:, COL_FP_HI].contiguous()
    chosen, evict_class, matched, picked = _choose_ways(
        state, fp_lo, fp_hi, valid.to(torch.int32), now, ways, multi_algo=True
    )
    # keep-the-newest against a matched live row (unsigned compares)
    r_window, p_window = _u32(rows[:, COL_WINDOW]), _u32(picked[:, COL_WINDOW])
    newer = (r_window > p_window) | (
        (r_window == p_window) & (_u32(rows[:, COL_COUNT]) > _u32(picked[:, COL_COUNT]))
    )
    stale = matched & valid & ~newer
    want_write = valid & ~stale
    # same-slot collisions serialize as on the hot path: matched lanes
    # order after evicting lanes, so a contended way's winning write is
    # the fp match
    key = (chosen << 1) | matched.long()
    order = torch.sort(key, stable=True).indices
    s_chosen = chosen[order]
    true1 = torch.ones(1, dtype=torch.bool, device=dev)
    is_last = torch.cat([s_chosen[1:] != s_chosen[:-1], true1])
    s_wrote = want_write[order] & is_last
    write_idx = torch.where(s_wrote, s_chosen, n)
    state.rows.index_put_((write_idx,), rows[order])
    # the swap's far side: a winning write over a live in-window way hands
    # that row back for re-demotion
    s_displaced = s_wrote & (evict_class[order] == EVICT_LIVE)
    displaced = torch.where(s_displaced[:, None], picked[order], 0).view(torch.uint32)
    # landed: written, or matched a row already fresher than the copy
    landed = _unsort(s_wrote | stale[order], order)
    return landed, displaced


# --- warm-restart export/import (persist/) ----------------------------------
#
# The snapshot path must never stall the launch pipeline: export enqueues a
# DEVICE-SIDE clone (ordered after every launch already enqueued on the
# stream) and hands it back; the caller drains it to the host outside any
# lock, on a side stream, while later launches keep updating the live table.
# Import is the boot-time inverse: one upload of a reconciled host table
# (persist/snapshot.py reconcile_rows applies the expiry rules on the host,
# where the restore-time clock lives).


def make_split_programs(ways: int):
    """The three stages of the slab step, one callable each, for the
    `slab_split` stage baseline (SlabDeviceEngine.profile_slab_split ->
    tools/hotpath_profile.py --slab-split): the W-way set GATHER, the
    SCAN, and the one-row-per-way SCATTER. Each is the code the shipped
    step runs, isolated only so it can be timed:

        gather(table, fp_lo)               -> int32[b, W, ROW_WIDTH]
        scan(table, fp_lo, fp_hi, now)     -> (way[b], matched[b], picked)
        scatter(rows, write_idx, new_rows) -> rows, written in place

    The scan is the way scan the step launches (ops/slab_kernels.py
    way_scan: on the card way_scan_kernel, or its set-major form where
    the routing rule picks it; on the CPU the plain version). On the card
    the kernel reads each item's set itself, so the gather is no stage
    the step runs in addition: it is the same set reads timed alone as a
    torch gather (_gather_sets, the plain version's), the memory half of
    the scan. The scatter is the step's row scatter (_finish_update's
    index_put_ over the table and its scratch row). The reference's scan
    takes the gathered rows; this one takes the table, as its kernel
    does."""

    def gather(table, fp_lo):
        return _gather_sets(table, fp_lo, ways)

    def scan(table, fp_lo, fp_hi, now):
        return way_scan(table, fp_lo, fp_hi, now, ways)

    def scatter(rows, write_idx, new_rows):
        rows.index_put_((write_idx,), new_rows)
        return rows

    return gather, scan, scatter


def slab_export_device(state: SlabState) -> tuple[torch.Tensor, object]:
    """Detached device-side copy of the row table, enqueued on the current
    stream, and on the card the CUDA event recorded after it (None on the
    CPU). The reference's slab_export_copy; drain it with slab_export_host
    once the state lock is released."""
    copy = state.table.clone()
    ready = None
    if copy.is_cuda:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(copy.device))
    return copy, ready


def slab_export_host(copy: torch.Tensor, ready) -> np.ndarray:
    """Host drain of a slab_export_device copy and its event,
    uint32[n_slots, ROW_WIDTH]. On the card the copy to pinned memory runs
    on a side stream that waits only for `ready`, so launches enqueued
    meanwhile do not queue behind it; the caller blocks until it lands."""
    if not copy.is_cuda:
        return copy.numpy().view(np.uint32)
    side = torch.cuda.Stream(copy.device)
    side.wait_event(ready)
    host = torch.empty(copy.shape, dtype=copy.dtype, pin_memory=True)
    with torch.cuda.stream(side):
        host.copy_(copy, non_blocking=True)
    side.synchronize()
    return host.numpy().view(np.uint32)


def slab_export_copy(state: SlabState) -> np.ndarray:
    """Host copy of the row table as uint32[n_slots, ROW_WIDTH]: the clone
    and its drain in one call."""
    return slab_export_host(*slab_export_device(state))


def slab_import_rows(rows, device="cuda") -> SlabState:
    """Upload a (n_slots, ROW_WIDTH) uint32 host table (for example a JAX
    state's `np.asarray(state.table)`) as fresh slab state."""
    rows = np.asarray(rows, dtype=np.uint32)
    if rows.ndim != 2 or rows.shape[1] != ROW_WIDTH:
        raise ValueError(
            f"slab rows must be (n_slots, {ROW_WIDTH}), got {rows.shape}"
        )
    n_slots = rows.shape[0]
    if n_slots & (n_slots - 1):
        raise ValueError(f"n_slots must be a power of two, got {n_slots}")
    state = SlabState(n_slots, resolve_device(device))
    state.table.copy_(torch.from_numpy(rows.view(np.int32).copy()))
    return state


def live_slot_count(table: torch.Tensor, now: int) -> int:
    """Count of live (unexpired) rows — THE liveness definition."""
    return int((table[:, COL_EXPIRE] > int(now)).sum())


def find_row_host(table, fp_lo: int, fp_hi: int, ways: int) -> int:
    """Row index of live (fp_lo, fp_hi) in a HOST uint32 copy of a table,
    or -1; the set split is set_index, as on the device."""
    table = np.asarray(table)
    n_slots = table.shape[0]
    ways = min(int(ways), n_slots)
    n_sets = n_slots // ways
    base = int(set_index(np.uint32(fp_lo), n_sets)) * ways
    rows = table[base : base + ways]
    hit = np.flatnonzero(
        (rows[:, COL_FP_LO] == np.uint32(fp_lo))
        & (rows[:, COL_FP_HI] == np.uint32(fp_hi))
        & (rows[:, COL_EXPIRE] != 0)
    )
    return base + int(hit[0]) if hit.size else -1
