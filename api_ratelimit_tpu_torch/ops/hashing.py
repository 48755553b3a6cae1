"""Port of api_ratelimit_tpu/ops/hashing.py: descriptor fingerprinting.

A rule-resolved descriptor is identified by a 64-bit xxh64 fingerprint of
(domain, entry key/value path) seeded with the window divider; the window
timestamp stays out of the fingerprint (the slab keeps the window start per
row). Every field is length-prefixed so request-controlled strings cannot
alias across field boundaries.

The xxh64 here is the package's own, in pure Python: it matches
`xxhash.xxh64(data, seed=divider).intdigest()` bit for bit (pinned by
tests/test_torch_hashing.py), so the port needs no `xxhash` package.
fingerprint_many hands batches of four or more to the native codec
(ops/native.py) when it is built, with identical output.
"""

from __future__ import annotations

import struct

import numpy as np

_M64 = (1 << 64) - 1
_P1 = 11400714785074694791
_P2 = 14029467366897019727
_P3 = 1609587929392839161
_P4 = 9650029242287828579
_P5 = 2870177450012600261

_LEN = struct.Struct("<I").pack
_U64 = struct.Struct("<Q").unpack_from
_U32 = struct.Struct("<I").unpack_from


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of `data` (the published algorithm, little-endian lanes)."""
    n = len(data)
    seed &= _M64
    p = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M64
        v2 = (seed + _P2) & _M64
        v3 = seed
        v4 = (seed - _P1) & _M64
        limit = n - 32
        while p <= limit:
            v1 = _round(v1, _U64(data, p)[0])
            v2 = _round(v2, _U64(data, p + 8)[0])
            v3 = _round(v3, _U64(data, p + 16)[0])
            v4 = _round(v4, _U64(data, p + 24)[0])
            p += 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = (((h ^ _round(0, v)) * _P1) + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        h ^= _round(0, _U64(data, p)[0])
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        h ^= (_U32(data, p)[0] * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h ^= (data[p] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    h ^= h >> 32
    return h


def fingerprint64(domain: str, entries, divider: int) -> int:
    """64-bit fingerprint of a resolved (domain, descriptor, window-unit)."""
    d = domain.encode()
    parts = [_LEN(len(d)), d]
    for entry in entries:
        k = entry.key.encode()
        v = entry.value.encode()
        parts += (_LEN(len(k)), k, _LEN(len(v)), v)
    return xxh64(b"".join(parts), divider)


def fingerprint_many(records, dividers) -> np.ndarray:
    """Batch fingerprinting: `records` is a sequence of (domain, entries)
    and `dividers` the per-record window divider (= hash seed). Uses the
    native codec (ops/native.py) when it is available and the batch is big
    enough to amortize the FFI call; otherwise the per-record Python path,
    with identical output."""
    from . import native

    if len(records) >= 4 and native.available():
        return native.fingerprint_batch(
            [native.record_strings(d, e) for d, e in records], dividers
        )
    return np.array(
        [fingerprint64(d, e, int(s)) for (d, e), s in zip(records, dividers)],
        dtype=np.uint64,
    )


def split_fingerprints(fps: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized split of uint64 fingerprints into (lo, hi) uint32 arrays."""
    fps = np.asarray(fps, dtype=np.uint64)
    lo = (fps & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (fps >> np.uint64(32)).astype(np.uint32)
    return lo, hi


def set_index(fp_lo, n_sets: int):
    """THE set-index split of the fingerprint for the W-way slab
    (ops/slab.py): the low log2(n_sets) bits of the LOW half select the
    set; the full (lo, hi) pair stays the stored tag. Works on numpy arrays,
    torch tensors and ints alike (a pure mask)."""
    if n_sets <= 0 or n_sets & (n_sets - 1):
        raise ValueError(f"n_sets must be a power of two, got {n_sets}")
    return fp_lo & (n_sets - 1)
