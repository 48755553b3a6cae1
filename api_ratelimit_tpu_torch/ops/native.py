"""Port of api_ratelimit_tpu/ops/native.py: ctypes bindings for the native
host codec (csrc/host_codec.cpp, a copy of the JAX package's
native/host_codec.cpp; host code for the CPU, built with g++, no device code).

The library covers the host-side work in front of the device batch, one FFI
call per batch: descriptor fingerprinting (ops/hashing.py
fingerprint_many), cache-key composition (limiter/base_limiter.py
generate_cache_keys), the compiled matcher's memo-miss walk
(config/compiled.py, rl_match_batch), the dispatch loop's verdict scatter
(backends/dispatch.py, rl_scatter_rows) and the batcher's row-block gather
(backends/cuda.py, rl_pack_rows).

`ensure_built()` compiles it at first use with `g++ -O3 -shared -fPIC
-std=c++17` into api_ratelimit_tpu_torch/_native/ (gitignored): a per-pid
temp file renamed into place, rebuilt when the source is newer, so several
processes starting together (a FRONTEND_PROCS fleet) never load a torn
library. Loading is best-effort, as in the JAX package: on a host without a
compiler `lib()` returns None and every caller keeps its Python path, with
identical output. The runner and the device owner report the outcome as the
ratelimit.native.available gauge.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

logger = logging.getLogger("ratelimit.native")

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc", "host_codec.cpp"
)
_OUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_native"
)
_SO_PATH = os.path.join(_OUT_DIR, "libratelimit_host.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed = False


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.rl_xxh64.restype = ctypes.c_uint64
    lib.rl_xxh64.argtypes = [u8p, ctypes.c_uint64, ctypes.c_uint64]
    lib.rl_fingerprint_batch.restype = None
    lib.rl_fingerprint_batch.argtypes = [
        u8p, u64p, u64p, u64p, ctypes.c_uint64, u8p, u64p,
    ]
    lib.rl_compose_keys.restype = ctypes.c_int64
    lib.rl_compose_keys.argtypes = [
        u8p, u64p, u64p, i64p, ctypes.c_uint64, u8p, ctypes.c_uint64, u64p,
    ]
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.rl_match_batch.restype = None
    lib.rl_match_batch.argtypes = [
        u64p, ctypes.c_uint64,  # ht, ht_mask
        u32p, u32p, u64p, u32p, u8p,  # e_parent, e_node, key off/len, blob
        i32p, u8p,  # n_limit, n_children
        u8p, u64p, u64p,  # request blob, str_off, rec_off
        ctypes.c_uint64, u8p, i32p,  # n_records, scratch, out
    ]
    vpp = ctypes.POINTER(ctypes.c_void_p)
    lib.rl_pack_rows.restype = None
    lib.rl_pack_rows.argtypes = [
        vpp, u64p, u64p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
    ]
    lib.rl_scatter_rows.restype = None
    lib.rl_scatter_rows.argtypes = [
        ctypes.c_void_p, u64p, ctypes.c_uint64, vpp,
    ]
    return lib


def ensure_built() -> bool:
    """Compile the shared object if it is missing or older than its source.
    Best-effort and safe to call repeatedly/concurrently: builds go to a
    per-pid temp path then atomically rename into place, and every failure
    mode (no toolchain, read-only install, ...) returns False so callers
    fall back to the Python path."""
    try:
        if not os.path.exists(_SRC):
            return os.path.exists(_SO_PATH)
        if (
            os.path.exists(_SO_PATH)
            and os.path.getmtime(_SO_PATH) >= os.path.getmtime(_SRC)
        ):
            return True  # up to date; stale .so rebuilds below
        os.makedirs(_OUT_DIR, exist_ok=True)
        tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, _SRC],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, _SO_PATH)
    except (OSError, subprocess.SubprocessError) as e:
        logger.warning("native codec build failed (%s); using Python path", e)
        return False
    logger.info("built native host codec: %s", _SO_PATH)
    return True


def lib() -> ctypes.CDLL | None:
    """The loaded library, building it on first use; None => Python path."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if not ensure_built():
            _load_failed = True
            return None
        try:
            _lib = _configure(ctypes.CDLL(_SO_PATH))
        except (OSError, AttributeError) as e:
            # AttributeError = a stale .so missing a newer entry point:
            # fall back rather than crash the boot
            logger.warning("native codec load failed (%s); using Python path", e)
            _load_failed = True
    return _lib


def available() -> bool:
    return lib() is not None


def build_info() -> dict:
    """Boot-time surfacing of the codec state (runner/sidecar log this and
    export the `native.available` gauge so the pure-Python fallback can
    never silently eat the dispatch-path win): whether the library loaded,
    where it was expected, and whether the source is present to build."""
    return {
        "available": available(),
        "so_path": _SO_PATH,
        "source_present": os.path.exists(_SRC),
    }


def _as_u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _as_u64p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def xxh64(data: bytes, seed: int = 0) -> int:
    """One-shot native hash (parity primitive; tests compare vs xxhash)."""
    native = lib()
    buf = np.frombuffer(data, dtype=np.uint8) if data else np.zeros(0, np.uint8)
    return int(native.rl_xxh64(_as_u8p(buf), len(data), seed))


class _Flattened:
    """Records flattened to the C layout: one UTF-8 blob + string/record
    offset arrays. A record is (domain, k1, v1, k2, v2, ...)."""

    __slots__ = ("blob", "str_off", "rec_off", "max_record_bytes")

    def __init__(self, records):
        chunks: list[bytes] = []
        str_off = [0]
        rec_off = [0]
        total = 0
        max_rec = 0
        for strings in records:
            rec_bytes = 0
            n_strings = 0
            for s in strings:
                b = s.encode()
                chunks.append(b)
                total += len(b)
                str_off.append(total)
                rec_bytes += len(b)
                n_strings += 1
            rec_off.append(rec_off[-1] + n_strings)
            max_rec = max(max_rec, rec_bytes + 4 * n_strings)
        self.blob = np.frombuffer(
            b"".join(chunks) or b"\0", dtype=np.uint8
        ).copy()
        self.str_off = np.asarray(str_off, dtype=np.uint64)
        self.rec_off = np.asarray(rec_off, dtype=np.uint64)
        self.max_record_bytes = max_rec


def record_strings(domain: str, entries) -> list[str]:
    """The flattened string sequence for one descriptor record."""
    out = [domain]
    for entry in entries:
        out.append(entry.key)
        out.append(entry.value)
    return out


def fingerprint_batch(records, seeds) -> np.ndarray:
    """records: sequence of string sequences (from `record_strings`);
    seeds: per-record hash seed (the window divider). Returns uint64[n]."""
    native = lib()
    flat = _Flattened(records)
    n = len(flat.rec_off) - 1
    seeds_arr = np.asarray(seeds, dtype=np.uint64)
    if seeds_arr.size != n:
        raise ValueError(f"{seeds_arr.size} seeds for {n} records")
    out = np.empty(n, dtype=np.uint64)
    scratch = np.empty(max(1, flat.max_record_bytes), dtype=np.uint8)
    native.rl_fingerprint_batch(
        _as_u8p(flat.blob),
        _as_u64p(flat.str_off),
        _as_u64p(flat.rec_off),
        _as_u64p(seeds_arr),
        n,
        _as_u8p(scratch),
        _as_u64p(out),
    )
    return out


class MatcherTable:
    """The flattened rule trie rl_match_batch walks (built by
    config/compiled.py at load/hot-reload; see host_codec.cpp for the
    layout contract). Holds the numpy arrays alive for the C side."""

    __slots__ = (
        "ht", "ht_mask", "e_parent", "e_node", "e_key_off", "e_key_len",
        "key_blob", "n_limit", "n_children",
    )

    def __init__(self, ht, e_parent, e_node, e_key_off, e_key_len,
                 key_blob, n_limit, n_children):
        self.ht = np.ascontiguousarray(ht, dtype=np.uint64)
        self.ht_mask = self.ht.size - 1
        self.e_parent = np.ascontiguousarray(e_parent, dtype=np.uint32)
        self.e_node = np.ascontiguousarray(e_node, dtype=np.uint32)
        self.e_key_off = np.ascontiguousarray(e_key_off, dtype=np.uint64)
        self.e_key_len = np.ascontiguousarray(e_key_len, dtype=np.uint32)
        self.key_blob = np.ascontiguousarray(key_blob, dtype=np.uint8)
        self.n_limit = np.ascontiguousarray(n_limit, dtype=np.int32)
        self.n_children = np.ascontiguousarray(n_children, dtype=np.uint8)


def match_batch(table: MatcherTable, records) -> np.ndarray:
    """Batched rule matching: records are record_strings-style string
    sequences (domain, k1, v1, ...); returns int32[n] of matched rule
    indices (-1 = no rule). Exact tree-walker semantics, pinned by the
    differential fuzz in tests/test_compiled_matcher.py."""
    native = lib()
    flat = _Flattened(records)
    n = len(flat.rec_off) - 1
    out = np.empty(n, dtype=np.int32)
    if n == 0:
        return out
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    # compose scratch: one "key_value" join is bounded by the record's
    # total string bytes plus the separator
    scratch = np.empty(max(2, flat.max_record_bytes + 2), dtype=np.uint8)
    native.rl_match_batch(
        _as_u64p(table.ht),
        table.ht_mask,
        table.e_parent.ctypes.data_as(u32p),
        table.e_node.ctypes.data_as(u32p),
        _as_u64p(table.e_key_off),
        table.e_key_len.ctypes.data_as(u32p),
        _as_u8p(table.key_blob),
        table.n_limit.ctypes.data_as(i32p),
        _as_u8p(table.n_children),
        _as_u8p(flat.blob),
        _as_u64p(flat.str_off),
        _as_u64p(flat.rec_off),
        n,
        _as_u8p(scratch),
        out.ctypes.data_as(i32p),
    )
    return out


def pack_rows(blocks, dst: np.ndarray, total: int) -> None:
    """Row-block gather (dispatch hot path): copy the uint32[6, n_i]
    `blocks` side by side into the first 6 rows of the padded launch
    operand `dst` (uint32[7, dst_cols] C-order). Blocks may be column
    slices of a wider arena — each block's row stride travels with it.
    `total` is sum(n_i) (bounds-checked here; the C side trusts it).
    Callers fall back to the numpy per-block copy loop when `available()`
    is False."""
    native = lib()
    n = len(blocks)
    if total > dst.shape[1]:
        raise ValueError(f"{total} rows exceed operand width {dst.shape[1]}")
    srcs = (ctypes.c_void_p * n)(*[b.ctypes.data for b in blocks])
    counts = np.fromiter((b.shape[1] for b in blocks), dtype=np.uint64, count=n)
    strides = np.fromiter(
        (b.strides[0] // 4 for b in blocks), dtype=np.uint64, count=n
    )
    native.rl_pack_rows(
        srcs, _as_u64p(counts), _as_u64p(strides), n,
        dst.ctypes.data, dst.shape[1],
    )


def scatter_rows(src: np.ndarray, dsts, counts) -> None:
    """Verdict scatter (dispatch redeem path): split the uint32[n] counter
    array `src` into the per-ticket uint32 buffers `dsts` (dsts[i] takes
    counts[i] leading values). Inverse of pack_rows; numpy slice-copy is
    the fallback."""
    native = lib()
    n = len(dsts)
    counts_arr = np.asarray(counts, dtype=np.uint64)
    if int(counts_arr.sum()) > src.shape[0]:
        raise ValueError("scatter counts exceed source length")
    ptrs = (ctypes.c_void_p * n)(*[d.ctypes.data for d in dsts])
    native.rl_scatter_rows(src.ctypes.data, _as_u64p(counts_arr), n, ptrs)


def compose_keys_batch(records, window_starts) -> list[str]:
    """Batched cache-key composition: "<domain>_<k>_<v>_..._<window>"
    (src/limiter/cache_key.go:43-73). Returns the decoded key strings."""
    native = lib()
    flat = _Flattened(records)
    n = len(flat.rec_off) - 1
    windows = np.asarray(window_starts, dtype=np.int64)
    out_off = np.empty(n + 1, dtype=np.uint64)
    cap = int(flat.blob.size + flat.str_off.size * 1 + n * 24 + 64)
    while True:
        out = np.empty(cap, dtype=np.uint8)
        written = native.rl_compose_keys(
            _as_u8p(flat.blob),
            _as_u64p(flat.str_off),
            _as_u64p(flat.rec_off),
            windows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n,
            _as_u8p(out),
            cap,
            _as_u64p(out_off),
        )
        if written >= 0:
            break
        cap *= 2
    raw = out[:written].tobytes()
    return [
        raw[int(out_off[i]) : int(out_off[i + 1])].decode()
        for i in range(n)
    ]
