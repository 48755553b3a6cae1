"""Port of api_ratelimit_tpu/ops/pallas_slab.py: the slab step's two kernels,
and the build of the port's one kernel library.

Every kernel is CUDA C++ for sm_90a under csrc/. All csrc/*.cu sources build
on first use into one library, build/libkernels-<hash of the sources and
flags>.so: one nvcc per source, all started together, then one link. It is
bound with ctypes (a plain C interface; pointers and the stream pass as
c_void_p, and the returned cudaError_t is checked after every launch).
Beside each kernel sits its plain PyTorch version, the same function written
with torch ops. This module holds the slab step's two:

    way_scan    <- pallas_way_scan (plus the set gather and picked-row
                   select that surrounded it in ops/slab.py _choose_ways)
    slab_apply  <- pallas_slab_apply(decide=False), and with decide=True
                   (lean=True) the fused INCRBY+decide forms

(the sketch's two wrappers, the fused update and the standalone scan, are
in ops/sketch_kernels.py, the standalone decide's in ops/decide.py, whose
decision math the fused apply shares through csrc/decide.cuh, and the
compare/select micro-benchmark's two kernels' in ops/select_kernels.py). A
wrapper runs the plain version only because the tensors it was given lie
on the CPU; for CUDA tensors it launches the kernel or raises. Each wrapper
counts its launches in LAUNCHES, so a run can show that it went through the
kernel. Nothing here imports or builds anything CUDA at import time.

The row layout the kernels read is defined here (ops/slab.py re-exports
it); csrc/slab_kernels.cu mirrors the same constants.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

from .hashing import set_index

ROW_WIDTH = 8
COL_FP_LO, COL_FP_HI, COL_COUNT, COL_WINDOW, COL_EXPIRE, COL_DIVIDER = range(6)
COL_PREV, COL_AUX = 6, 7

ALGO_SHIFT = 28
ALGO_DIV_MASK = (1 << ALGO_SHIFT) - 1

SCORE_TIER_SHIFT = 28
TIER_DEAD, TIER_WINDOW_ENDED, TIER_LIVE = 0, 1, 2

_M32 = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> their uint32 value as int64."""
    return x.long() & _M32


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 two's-complement wrap of its low 32 bits (as int64)."""
    return ((x + (1 << 31)) & _M32) - (1 << 31)


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. CUDA is the default and never
    falls back: without a card it raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel name -> launches made through its wrapper; the apply counts each
# of its three forms under its own name
LAUNCHES = {
    "way_scan": 0,
    "slab_apply": 0,
    "sketch_scan": 0,
    "sketch_update": 0,
    "slab_apply_decide": 0,
    "slab_apply_lean": 0,
    "decide": 0,
    "sel": 0,
    "chain": 0,
}

_lib = None
_lib_lock = threading.Lock()
BUILD_LOG: dict = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def sources() -> list[str]:
    """Every CUDA source of the library, in a fixed order."""
    return sorted(
        os.path.join(CSRC_DIR, name)
        for name in os.listdir(CSRC_DIR)
        if name.endswith(".cu")
    )


def library_path() -> str:
    """The built library's path, keyed on a hash of every source, every
    header they include (csrc/*.cuh) and the nvcc flags, so an edit to any
    of them builds a new library."""
    headers = sorted(
        os.path.join(CSRC_DIR, name)
        for name in os.listdir(CSRC_DIR)
        if name.endswith(".cuh")
    )
    digest = hashlib.sha256()
    for src in sources() + headers:
        digest.update(os.path.basename(src).encode() + b"\0")
        with open(src, "rb") as f:
            digest.update(f.read())
    digest.update("\0".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libkernels-{digest.hexdigest()[:16]}.so")


def _run_nvcc_all(nvcc: str, srcs: list[str], tmp: str) -> list[str]:
    """Compile each source to an object with its own nvcc, all started
    together; returns the object paths. Raises with the compiler's output
    if any of them fails."""
    procs = []
    for src in srcs:
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )))
    failed, objs, ptxas = [], [], []
    for src, obj, proc in procs:
        _out, err = proc.communicate()
        ptxas.append(err)
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(src)} ({proc.returncode}):\n{err}")
        objs.append(obj)
    if failed:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    BUILD_LOG["ptxas"] = "".join(ptxas)
    return objs


def build() -> ctypes.CDLL:
    """Compile csrc/*.cu into one library (unless a library built from the
    same sources and flags exists) and load it. BUILD_LOG records the
    seconds and ptxas's register/shared-memory report."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        library = library_path()
        if not os.path.exists(library):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{library}.{os.getpid()}.tmp"
            nvcc = _nvcc()
            t0 = time.perf_counter()
            objs = _run_nvcc_all(nvcc, sources(), tmp)
            try:
                proc = subprocess.run(
                    [nvcc, "-shared", "-o", tmp, *objs],
                    capture_output=True,
                    text=True,
                )
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc link failed ({proc.returncode}):\n{proc.stderr}"
                    )
            finally:
                for obj in objs:
                    if os.path.exists(obj):
                        os.remove(obj)
            os.replace(tmp, library)
            BUILD_LOG["seconds"] = time.perf_counter() - t0
        lib = ctypes.CDLL(library)
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rl_way_scan.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, vp, vp, vp, vp]
        lib.rl_way_scan.restype = ci
        lib.rl_slab_apply_scratch_bytes.argtypes = [ci]
        lib.rl_slab_apply_scratch_bytes.restype = ctypes.c_longlong
        lib.rl_slab_apply.argtypes = [vp] * 7 + [ci, ci] + [vp] * 7
        lib.rl_slab_apply.restype = ci
        lib.rl_slab_apply_decide.argtypes = [vp] * 8 + [ci, ci, cf, ci] + [vp] * 13
        lib.rl_slab_apply_decide.restype = ci
        lib.rl_sketch_scan.argtypes = [vp, ci, vp, vp, ci, ci, ci, vp, vp, vp, vp, vp]
        lib.rl_sketch_scan.restype = ci
        lib.rl_sketch_update_scratch_bytes.argtypes = [ci, ci, ci]
        lib.rl_sketch_update_scratch_bytes.restype = ctypes.c_longlong
        lib.rl_sketch_update_smem_bytes.argtypes = [ci, ci]
        lib.rl_sketch_update_smem_bytes.restype = ctypes.c_longlong
        lib.rl_sketch_update.argtypes = [vp, ci, vp, vp, vp, vp, ci, ci, ci, vp, vp, vp]
        lib.rl_sketch_update.restype = ci
        lib.rl_decide.argtypes = [vp] * 5 + [ci, ci, cf] + [vp] * 7
        lib.rl_decide.restype = ci
        for fn in (lib.rl_sel, lib.rl_chain):
            fn.argtypes = [vp, vp, ctypes.c_longlong, vp]
            fn.restype = ci
        _lib = lib
        return lib


def _check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def _require(t: torch.Tensor, name: str, dtype, ndim: int, device) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(
            f"{name}: expected {dtype} with {ndim} dims, got {t.dtype} {tuple(t.shape)}"
        )
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_int32(name: str, value: int) -> int:
    value = int(value)
    if not -(1 << 31) <= value < (1 << 31):
        raise ValueError(f"{name} {value} does not fit int32")
    return value


# --- way scan ----------------------------------------------------------------


def _gather_sets(table, fp_lo: torch.Tensor, ways: int):
    """int32[b, W, ROW_WIDTH]: each item's full set of `table`."""
    n = table.shape[0]
    if n % ways:
        raise ValueError(f"n_slots {n} is not a multiple of ways {ways}")
    n_sets = n // ways
    set_idx = set_index(fp_lo, n_sets).long()
    return table.view(n_sets, ways, ROW_WIDTH)[set_idx]


def _scan_ways(rows, fp_lo, fp_hi, now: int, ways: int):
    """The W-wide scan arithmetic on pre-gathered sets (multi_algo=False):
    (int32[b] way, bool[b] match_any). Count compares unsigned against the
    cap; window, expire and the divider are signed int32."""
    expire = rows[:, :, COL_EXPIRE]
    window = rows[:, :, COL_WINDOW].long()
    divider = (rows[:, :, COL_DIVIDER] & ALGO_DIV_MASK).long()
    count = _u32(rows[:, :, COL_COUNT])
    live = expire > now
    match = (
        live
        & (rows[:, :, COL_FP_LO] == fp_lo[:, None])
        & (rows[:, :, COL_FP_HI] == fp_hi[:, None])
    )
    window_ended = live & (divider > 0) & (_wrap32(window + divider) <= now)

    way_bits = max(1, (ways - 1).bit_length())
    way_iota = torch.arange(ways, dtype=torch.int64, device=rows.device)
    pref = (_u32(fp_hi) >> way_bits) & (ways - 1)
    rot = (way_iota[None, :] - pref[:, None]) & (ways - 1)
    count_cap = (1 << (SCORE_TIER_SHIFT - way_bits)) - 1
    cnt = torch.clamp(count, max=count_cap)
    tier = torch.where(
        live,
        torch.where(window_ended, TIER_WINDOW_ENDED, TIER_LIVE),
        TIER_DEAD,
    )
    sub = torch.where(live, (cnt << way_bits) | rot, rot)
    score = (tier << SCORE_TIER_SHIFT) | sub

    match_any = match.any(dim=1)
    match_way = match.to(torch.uint8).argmax(dim=1)  # first match
    victim_way = score.argmin(dim=1)  # scores are unique within a set
    way = torch.where(match_any, match_way, victim_way).to(torch.int32)
    return way, match_any


def way_scan_plain(table, fp_lo, fp_hi, now: int, ways: int):
    """Plain version of the way scan: gather each item's set, run the scan
    arithmetic, select the chosen way's row. Returns (int32[b] way,
    bool[b] matched, int32[b, ROW_WIDTH] picked row)."""
    rows = _gather_sets(table, fp_lo, ways)
    way, matched = _scan_ways(rows, fp_lo, fp_hi, now, ways)
    picked = rows[torch.arange(rows.shape[0], device=rows.device), way.long()]
    return way, matched, picked


def way_scan(table, fp_lo, fp_hi, now: int, ways: int):
    """Per item over its set (`fp_lo & (n_sets - 1)`) of `ways` rows of
    `table` (int32[n_slots, 8]): the chosen way (first live tag match, else
    the argmin eviction score), the matched flag and the chosen row."""
    device = table.device
    _require(table, "table", torch.int32, 2, device)
    _require(fp_lo, "fp_lo", torch.int32, 1, device)
    _require(fp_hi, "fp_hi", torch.int32, 1, device)
    n_slots = table.shape[0]
    ways = int(ways)
    if table.shape[1] != ROW_WIDTH:
        raise ValueError(f"table rows must be {ROW_WIDTH} wide")
    if ways <= 0 or ways & (ways - 1) or n_slots % ways:
        raise ValueError(f"ways {ways} must be a power of two dividing {n_slots}")
    n_sets = n_slots // ways
    if n_sets & (n_sets - 1) or n_sets > (1 << 31):
        raise ValueError(f"n_sets {n_sets} must be a power of two <= 2^31")
    if fp_hi.shape != fp_lo.shape:
        raise ValueError("fp_lo and fp_hi must have the same shape")
    now = _check_int32("now", now)
    if device.type == "cpu":
        return way_scan_plain(table, fp_lo, fp_hi, now, ways)
    if device.type != "cuda":
        raise ValueError(f"way_scan: unsupported device {device}")
    b = fp_lo.shape[0]
    way = torch.empty(b, dtype=torch.int32, device=device)
    matched = torch.empty(b, dtype=torch.bool, device=device)
    picked = torch.empty((b, ROW_WIDTH), dtype=torch.int32, device=device)
    if b == 0:
        return way, matched, picked
    lib = build()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.rl_way_scan(
        table.data_ptr(), fp_lo.data_ptr(), fp_hi.data_ptr(), b, n_sets, ways,
        max(1, (ways - 1).bit_length()), now, way.data_ptr(),
        matched.data_ptr(), picked.data_ptr(), stream,
    )
    _check("way_scan", err)
    LAUNCHES["way_scan"] += 1
    return way, matched, picked


# --- INCRBY apply --------------------------------------------------------------


def f32(value) -> float:
    """`value` rounded to float32 (kernels take near_ratio as a C float)."""
    return float(np.float32(value))


def slab_apply_plain(
    s_fp_lo, s_fp_hi, s_hits, s_div, s_jit, seg_start, st_rows, now: int,
    s_limit=None, near_ratio=0.8, decide=False, lean=False, weight=False,
):
    """Plain version of the INCRBY apply over a slot-sorted batch. Returns
    int32[b] (before, after, cur_window, expire); before and after hold
    uint32 bits. decide=True appends the six DecideResult fields of the
    decision (ops/decide.py decide_plain) against `s_limit`; lean=True
    appends the code alone. weight=True appends the sketch's segment weight
    prior + hits (uint32 bits) last."""
    hits = _u32(s_hits)
    incl = torch.cumsum(hits, dim=0) & 0xFFFFFFFF
    excl = (incl - hits) & 0xFFFFFFFF
    # forward-fill each segment's starting exclusive sum: an unsigned
    # running max of the segment-start-masked values
    seg_base = torch.cummax(torch.where(seg_start, excl, 0), dim=0).values
    prior = (excl - seg_base) & 0xFFFFFFFF

    safe_div = torch.clamp(s_div.long(), min=1)
    now_t = torch.full_like(safe_div, now)
    cur_window = _wrap32(torch.div(now_t, safe_div, rounding_mode="floor") * safe_div)
    slot_live = st_rows[:, COL_EXPIRE] > now
    fp_match = (
        slot_live
        & (st_rows[:, COL_FP_LO] == s_fp_lo)
        & (st_rows[:, COL_FP_HI] == s_fp_hi)
    )
    same_window = st_rows[:, COL_WINDOW].long() == cur_window
    base = torch.where(
        (hits != 0) & fp_match & same_window, _u32(st_rows[:, COL_COUNT]), 0
    )
    before = (base + prior) & 0xFFFFFFFF
    after = (before + hits) & 0xFFFFFFFF
    expire = _wrap32(now + safe_div + s_jit.long())
    as_i32 = lambda x: _wrap32(x).to(torch.int32)  # noqa: E731
    outs = (as_i32(before), as_i32(after), cur_window.to(torch.int32), expire.to(torch.int32))
    if decide:
        # decide.py imports this module's build and launch counts
        from .decide import decide_plain

        d = decide_plain(outs[0], outs[1], s_hits, s_limit, s_div, now, near_ratio)
        outs = (*outs, d.code) if lean else (*outs, *d)
    return (*outs, as_i32(prior + hits)) if weight else outs


def slab_apply(
    s_fp_lo, s_fp_hi, s_hits, s_div, s_jit, seg_start, st_rows, now: int,
    s_limit=None, near_ratio=0.8, decide=False, lean=False, weight=False,
):
    """The INCRBY over a slot-sorted batch: segmented exclusive prefix of
    hits, window rollover against the stored row (int32[b, 8]),
    before/after counters, the new window and expire. decide=True fuses
    the fixed-window decision against `s_limit` (int32[b], uint32 bits) at
    `near_ratio` and appends code, remaining, duration, throttle, near and
    over deltas; lean=True appends only the code. weight=True appends the
    sketch's segment weight, prior + hits (uint32 bits), last. Each form
    counts its launches under its own name (slab_apply, slab_apply_decide,
    slab_apply_lean).

    On the card every form is one launch of the chained-scan kernel
    (csrc/slab_kernels.cu slab_apply_kernel): tiles of 512 items, one block
    each, whose sum and then max prefixes come from a decoupled look-back
    over the tiles before them. Its scratch (two status words a tile and
    the tile ticket) is allocated here per call, since launches come from
    more than one thread, and zeroed by the entry point on the launch
    stream."""
    device = s_hits.device
    named = [
        ("s_fp_lo", s_fp_lo), ("s_fp_hi", s_fp_hi), ("s_hits", s_hits),
        ("s_div", s_div), ("s_jit", s_jit),
    ]
    if lean and not decide:
        raise ValueError("lean=True is a form of decide=True")
    if decide:
        if s_limit is None:
            raise ValueError("decide=True needs s_limit")
        named.append(("s_limit", s_limit))
    for name, t in named:
        _require(t, name, torch.int32, 1, device)
    _require(seg_start, "seg_start", torch.bool, 1, device)
    _require(st_rows, "st_rows", torch.int32, 2, device)
    b = s_hits.shape[0]
    if any(t.shape[0] != b for _name, t in named) or seg_start.shape[0] != b or st_rows.shape[0] != b:
        raise ValueError("slab_apply inputs must share the batch length")
    if st_rows.shape[1] != ROW_WIDTH:
        raise ValueError(f"st_rows must be (b, {ROW_WIDTH})")
    now = _check_int32("now", now)
    near_ratio = f32(near_ratio)
    if device.type == "cpu":
        return slab_apply_plain(
            s_fp_lo, s_fp_hi, s_hits, s_div, s_jit, seg_start, st_rows, now,
            s_limit, near_ratio, decide, lean, weight,
        )
    if device.type != "cuda":
        raise ValueError(f"slab_apply: unsupported device {device}")
    n_out = (5 if lean else 10) if decide else 4
    outs = [torch.empty(b, dtype=torch.int32, device=device) for _ in range(n_out + bool(weight))]
    if b == 0:
        return tuple(outs)
    lib = build()
    scratch = torch.empty(lib.rl_slab_apply_scratch_bytes(b) // 8, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    head = (s_fp_lo.data_ptr(), s_fp_hi.data_ptr(), s_hits.data_ptr())
    tail = (s_div.data_ptr(), s_jit.data_ptr(), seg_start.data_ptr(), st_rows.data_ptr())
    ptrs = [o.data_ptr() for o in outs[:n_out]]
    weight_ptr = outs[-1].data_ptr() if weight else None
    if not decide:
        err = lib.rl_slab_apply(*head, *tail, b, now, *ptrs, weight_ptr, scratch.data_ptr(), stream)
        name = "slab_apply"
    else:
        ptrs += [None] * (10 - n_out)  # lean stores no other decision plane
        err = lib.rl_slab_apply_decide(
            *head, s_limit.data_ptr(), *tail, b, now, near_ratio, int(lean), *ptrs,
            weight_ptr, scratch.data_ptr(), stream,
        )
        name = "slab_apply_lean" if lean else "slab_apply_decide"
    _check(name, err)
    LAUNCHES[name] += 1
    return tuple(outs)
