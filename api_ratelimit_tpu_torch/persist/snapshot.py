"""Port of api_ratelimit_tpu/persist/snapshot.py: the slab snapshot file
format, with a versioned header, a CRC-protected payload and atomic
replacement.

The format is the reference's, byte for byte: a file written by either
package loads in the other. One file per slab shard. Layout (all integers
little-endian):

    offset  size  field
    0       8     magic          b"SLABSNP1"
    8       4     version        format version (SNAPSHOT_VERSION)
    12      4     flags          bit 0: lease table; bits 16-31: slab ways
    16      8     created_at     unix seconds the copy was taken at
    24      8     n_slots        rows in this shard's table
    32      4     row_width      uint32 words per row (ops/slab.py ROW_WIDTH)
    36      4     shard_index    which shard this file holds
    40      4     shard_count    total shards the slab was split into
    44      4     payload_crc    zlib.crc32 of the payload bytes
    48      8     payload_len    payload byte length (n_slots*row_width*4)
    56      4     header_crc     zlib.crc32 of bytes [0, 56)
    60      ...   payload        the raw uint32 row table, C order

Writes are crash-safe by construction: the bytes land in a same-directory
temp file, fsync, then one atomic os.replace over the destination (and an
fsync of the directory so the rename itself is durable) — a crash at any
point leaves either the previous complete snapshot or none, never a torn
one. The loader re-derives everything it trusts: magic/version/header CRC
first, then payload length against both the header and the actual file
size, then the payload CRC. Anything off raises SnapshotError — the caller
boots cold rather than serving from a corrupt counter table.

This module is numpy + stdlib only: offline tools read these files without
paying a torch import. The column constants below mirror ops/slab.py's row
format (tests assert they stay equal). The lease, federation and victim
section helpers are pure numpy too; their callers (the victim tier, leases,
federation) are later slices of the port, so the comments below that name
backends/lease.py, backends/victim.py, cluster/ or tools/snapshot_inspect.py
name the reference package's modules.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import zlib

import numpy as np

from ..ops.hashing import set_index

MAGIC = b"SLABSNP1"
# Version history:
#   1  open-addressed slab: rows placed by the K-probe double hash;
#      flags carried only FLAG_LEASE_TABLE.
#   2  W-way set-associative slab: a row may live ONLY in set
#      fp_lo mod n_sets (ops/hashing.py set_index); the header flags'
#      high half records the ways the writer ran with. v1 files (and v2
#      files written under a different SLAB_WAYS) load fine and are
#      REHASHED into sets at restore (migrate_rows_to_sets) — an
#      old-version snapshot is migrated, never rejected.
SNAPSHOT_VERSION = 2
SUPPORTED_VERSIONS = (1, 2)

# Mirror of ops/slab.py's fused row format (tests/test_torch_persist.py pins
# the equivalence) — redeclared here so offline tools read rows without torch.
ROW_WIDTH = 8
COL_FP_LO, COL_FP_HI, COL_COUNT, COL_WINDOW, COL_EXPIRE, COL_DIVIDER = range(6)

# Algorithm id in bits 28-30 of the divider word (ops/slab.py ALGO_*).
# Pre-algorithm rows carry 0 there, so every v2 file from before the
# algorithm subsystem classifies as fixed_window and reconciles EXACTLY as
# it always did — the zero-drop round-trip guarantee.
ALGO_SHIFT = 28
ALGO_DIV_MASK = (1 << ALGO_SHIFT) - 1
ALGO_SLIDING_WINDOW = 1
ALGO_NAMES = {
    0: "fixed_window",
    ALGO_SLIDING_WINDOW: "sliding_window",
    2: "gcra",
    3: "concurrency",
}


def row_algorithms(table: np.ndarray) -> np.ndarray:
    """Per-row algorithm id (0 = fixed_window) from the divider word —
    THE classification the inspector and reconcile share."""
    table = np.asarray(table, dtype=np.uint32)
    return (table[:, COL_DIVIDER] >> ALGO_SHIFT) & 7

# header `flags` values: what kind of table the payload holds. 0 (the
# pre-flag format) is a slab shard; FLAG_LEASE_TABLE marks the lease
# liability registry (backends/lease.py export_rows — one row per
# outstanding (fp, window) grant). The flag keeps the two table kinds from
# masquerading as each other: both are (n, 8) uint32. Bits 16-31 carry the
# writer's set associativity (v2 slab shards; 0 = unknown/v1 — the loader
# treats that as "rehash on restore").
FLAG_LEASE_TABLE = 1
# FLAG_PARTITION (cluster/): a 20-byte extension block sits between the
# header and the payload — <IIII> partition_index, range_lo, range_hi,
# route_sets, then a u32 CRC of those 16 bytes. Stamped by partitioned
# device owners so an operator holding a pile of snapshot files can tell
# WHICH keyspace slice each one holds (tools/snapshot_inspect.py renders
# it); files without the flag parse exactly as before — byte-identical
# unpartitioned format.
FLAG_PARTITION = 2
# FLAG_FED (cluster/federation.py): the federation share ledger — one
# row per (fp, window) holding this cluster's quota-share state (tokens
# granted in, spent locally, settled to the grantor, outstanding to
# borrowers). Same (n, 8) uint32 shape as the other table kinds; the
# flag keeps it from masquerading as a slab shard or lease table.
FLAG_FED = 4
# FLAG_VICTIM (backends/victim.py): the host-RAM victim tier — demoted
# live slab rows awaiting promotion, stored in the SAME slab row wire
# (fp_lo, fp_hi, count, window, expire, divider, ...), so restore runs
# the ordinary reconcile_rows clock discipline before re-seeding the
# tier. The flag keeps it from masquerading as a slab shard: a victim
# table must never be imported onto the device directly (its rows were
# evicted precisely because the slab had no room for them).
FLAG_VICTIM = 8
FLAG_WAYS_SHIFT = 16

_PARTITION_EXT = struct.Struct("<IIII")
_PARTITION_CRC = struct.Struct("<I")
PARTITION_EXT_SIZE = _PARTITION_EXT.size + _PARTITION_CRC.size  # 20 bytes

# Mirror of backends/lease.py's liability row layout (tests pin equality).
LEASE_ROW_WIDTH = 8
(
    LEASE_COL_FP_LO,
    LEASE_COL_FP_HI,
    LEASE_COL_WINDOW,
    LEASE_COL_GRANTED,
    LEASE_COL_SETTLED,
    LEASE_COL_FLOOR,
    LEASE_COL_EXPIRE,
) = range(7)

# Mirror of cluster/federation.py's share-ledger row layout (tests pin
# equality). GRANTED/SPENT/SETTLED are the borrower-side share state for
# the row's (fp, window); OUT is the grantor-side unsettled tokens still
# outstanding at peers; SPENT doubles as the restored-counter watermark
# (apply_fed_floors) — on the home cluster it holds the full committed
# count (local spend + grants out), the never-double-grant floor.
FED_ROW_WIDTH = 8
(
    FED_COL_FP_LO,
    FED_COL_FP_HI,
    FED_COL_WINDOW,
    FED_COL_GRANTED,
    FED_COL_SPENT,
    FED_COL_SETTLED,
    FED_COL_OUT,
    FED_COL_EXPIRE,
) = range(8)

_HEADER = struct.Struct("<8sIIqQIIIIQ")
_HEADER_CRC = struct.Struct("<I")
HEADER_SIZE = _HEADER.size + _HEADER_CRC.size  # 60 bytes

FAULT_SITE_WRITE = "snapshot.write"  # testing/faults.py chaos site
FAULT_SITE_LOAD = "snapshot.load"  # testing/faults.py chaos site


class SnapshotError(Exception):
    """A snapshot file failed validation (bad magic/version/CRC/shape) or
    could not be read. The restore path answers every SnapshotError the
    same way: reject the file, count snapshot.load_rejected, boot cold."""


@dataclasses.dataclass(frozen=True, slots=True)
class SnapshotHeader:
    version: int
    created_at: int
    n_slots: int
    row_width: int
    shard_index: int
    shard_count: int
    payload_crc: int
    payload_len: int
    flags: int = 0
    # (partition_index, range_lo, range_hi, route_sets) from the
    # FLAG_PARTITION extension block; None on unpartitioned files
    partition: tuple | None = None

    @property
    def ext_size(self) -> int:
        """Bytes between the 60-byte base header and the payload."""
        return PARTITION_EXT_SIZE if self.flags & FLAG_PARTITION else 0

    @property
    def ways(self) -> int:
        """Set associativity the writer ran with; 0 = unknown (a v1 file,
        or a lease table) — restore rehashes when it differs from the
        running config."""
        return (self.flags >> FLAG_WAYS_SHIFT) & 0xFFFF

    def pack(self) -> bytes:
        head = _HEADER.pack(
            MAGIC,
            self.version,
            self.flags,
            self.created_at,
            self.n_slots,
            self.row_width,
            self.shard_index,
            self.shard_count,
            self.payload_crc,
            self.payload_len,
        )
        out = head + _HEADER_CRC.pack(zlib.crc32(head))
        if self.flags & FLAG_PARTITION:
            ext = _PARTITION_EXT.pack(*self.partition)
            out += ext + _PARTITION_CRC.pack(zlib.crc32(ext))
        return out


def _unpack_header(raw: bytes, path: str) -> SnapshotHeader:
    if len(raw) < HEADER_SIZE:
        raise SnapshotError(
            f"{path}: truncated header ({len(raw)} bytes, need {HEADER_SIZE})"
        )
    (
        magic,
        version,
        flags,
        created_at,
        n_slots,
        row_width,
        shard_index,
        shard_count,
        payload_crc,
        payload_len,
    ) = _HEADER.unpack_from(raw)
    if magic != MAGIC:
        raise SnapshotError(f"{path}: bad magic {magic!r} (not a slab snapshot)")
    (header_crc,) = _HEADER_CRC.unpack_from(raw, _HEADER.size)
    if zlib.crc32(raw[: _HEADER.size]) != header_crc:
        raise SnapshotError(f"{path}: header CRC mismatch")
    if version not in SUPPORTED_VERSIONS:
        raise SnapshotError(
            f"{path}: snapshot version {version} not in supported "
            f"{SUPPORTED_VERSIONS}"
        )
    header = SnapshotHeader(
        version=version,
        created_at=created_at,
        n_slots=n_slots,
        row_width=row_width,
        shard_index=shard_index,
        shard_count=shard_count,
        payload_crc=payload_crc,
        payload_len=payload_len,
        flags=flags,
    )
    if header.payload_len != header.n_slots * header.row_width * 4:
        raise SnapshotError(
            f"{path}: payload_len {header.payload_len} does not match "
            f"{header.n_slots} rows x {header.row_width} uint32 words"
        )
    if flags & FLAG_PARTITION:
        ext_raw = raw[HEADER_SIZE : HEADER_SIZE + PARTITION_EXT_SIZE]
        if len(ext_raw) < PARTITION_EXT_SIZE:
            raise SnapshotError(f"{path}: truncated partition extension")
        (ext_crc,) = _PARTITION_CRC.unpack_from(ext_raw, _PARTITION_EXT.size)
        if zlib.crc32(ext_raw[: _PARTITION_EXT.size]) != ext_crc:
            raise SnapshotError(f"{path}: partition extension CRC mismatch")
        header = dataclasses.replace(
            header, partition=_PARTITION_EXT.unpack_from(ext_raw)
        )
    return header


def pack_table_bytes(
    table: np.ndarray,
    created_at: int,
    shard_index: int = 0,
    shard_count: int = 1,
    flags: int = 0,
    ways: int = 0,
    version: int = SNAPSHOT_VERSION,
    partition: tuple | None = None,
) -> bytes:
    """One table as a self-describing versioned+CRC section: the exact
    bytes a snapshot file holds (header.pack() + payload). Shared by the
    file writer below, the replication stream (persist/replication.py),
    and the cluster reshard stream (cluster/reshard.py), so a standby's
    full-sync frame and a moved route range ARE the snapshot format —
    same CRCs, same ways stamp, same validation path.

    partition: optional (partition_index, range_lo, range_hi,
    route_sets) — stamped as the FLAG_PARTITION extension block so the
    file/section records which keyspace slice it holds. None (the
    default) writes the byte-identical unpartitioned format."""
    table = np.ascontiguousarray(table, dtype="<u4")
    if table.ndim != 2:
        raise ValueError(f"snapshot table must be 2-D, got {table.shape}")
    payload = table.tobytes()
    if ways:
        flags = int(flags) | (int(ways) << FLAG_WAYS_SHIFT)
    if partition is not None:
        if len(partition) != 4:
            raise ValueError(
                f"partition stamp must be (index, lo, hi, route_sets), "
                f"got {partition!r}"
            )
        flags = int(flags) | FLAG_PARTITION
        partition = tuple(int(v) for v in partition)
    header = SnapshotHeader(
        version=int(version),
        created_at=int(created_at),
        n_slots=table.shape[0],
        row_width=table.shape[1],
        shard_index=int(shard_index),
        shard_count=int(shard_count),
        payload_crc=zlib.crc32(payload),
        payload_len=len(payload),
        flags=int(flags),
        partition=partition,
    )
    return header.pack() + payload


def unpack_table_bytes(
    buf: bytes, offset: int = 0, what: str = "<buffer>"
) -> tuple[SnapshotHeader, np.ndarray, int]:
    """Inverse of pack_table_bytes against a byte buffer: validates the
    header + payload CRCs exactly like load_snapshot and returns
    (header, table copy, offset past the section) so concatenated
    sections parse sequentially."""
    raw = buf[offset : offset + HEADER_SIZE + PARTITION_EXT_SIZE]
    header = _unpack_header(raw, what)
    start = offset + HEADER_SIZE + header.ext_size
    payload = buf[start : start + header.payload_len]
    if len(payload) != header.payload_len:
        raise SnapshotError(
            f"{what}: section payload is {len(payload)} bytes, header "
            f"says {header.payload_len} (truncated)"
        )
    if zlib.crc32(payload) != header.payload_crc:
        raise SnapshotError(f"{what}: section payload CRC mismatch")
    table = np.frombuffer(payload, dtype="<u4").reshape(
        header.n_slots, header.row_width
    )
    return header, table.astype(np.uint32), start + header.payload_len


def write_snapshot(
    path: str,
    table: np.ndarray,
    created_at: int,
    shard_index: int = 0,
    shard_count: int = 1,
    fault_injector=None,
    flags: int = 0,
    ways: int = 0,
    version: int = SNAPSHOT_VERSION,
    partition: tuple | None = None,
) -> int:
    """Atomically write one shard's row table; returns bytes written.
    ways (slab shards only) stamps the writer's set associativity into
    the header flags so a restore under a different SLAB_WAYS knows to
    rehash. partition optionally stamps the owner's keyspace slice
    (pack_table_bytes). `version` exists for tests that craft old-format
    fixtures.

    fault_injector (testing/faults.py) is consulted at site
    'snapshot.write': 'error' raises OSError before any byte lands;
    'torn_write' truncates the payload mid-row (rehearsing a crash the
    atomic rename normally hides — the direct-write failure mode);
    'corrupt' flips payload bytes AFTER the CRC was computed, so the file
    is well-formed but fails its checksum on load. delay_ms stalls the
    writer (a slow disk)."""
    action = None
    if fault_injector is not None:
        action = fault_injector.fire(FAULT_SITE_WRITE)
        if action == "error":
            raise OSError(f"injected {FAULT_SITE_WRITE} error")
    blob = pack_table_bytes(
        table,
        created_at,
        shard_index=shard_index,
        shard_count=shard_count,
        flags=flags,
        ways=ways,
        version=version,
        partition=partition,
    )
    payload_len = len(blob) - HEADER_SIZE
    if action == "corrupt":
        mutated = bytearray(blob)
        mutated[HEADER_SIZE + payload_len // 2] ^= 0xFF
        blob = bytes(mutated)
    elif action == "torn_write":
        blob = blob[: HEADER_SIZE + max(HEADER_SIZE, payload_len // 2)]
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    # make the rename itself durable: fsync the directory entry
    dir_fd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)
    return len(blob)


def read_header(path: str) -> SnapshotHeader:
    """Validate and return just the header (magic/version/CRC checked)."""
    try:
        with open(path, "rb") as f:
            raw = f.read(HEADER_SIZE + PARTITION_EXT_SIZE)
    except OSError as e:
        raise SnapshotError(f"{path}: {e}") from e
    return _unpack_header(raw, path)


def load_snapshot(
    path: str, fault_injector=None
) -> tuple[SnapshotHeader, np.ndarray]:
    """Read and fully validate one snapshot file; returns (header, table).

    fault_injector site 'snapshot.load': 'error' raises SnapshotError
    before the read; 'corrupt' flips payload bytes in memory before the
    CRC check (so validation must catch it); delay_ms stalls the loader.
    Every validation failure raises SnapshotError — the caller boots cold."""
    if fault_injector is not None:
        action = fault_injector.fire(FAULT_SITE_LOAD)
        if action == "error":
            raise SnapshotError(f"{path}: injected {FAULT_SITE_LOAD} error")
    else:
        action = None
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as e:
        raise SnapshotError(f"{path}: {e}") from e
    header = _unpack_header(raw, path)
    payload = raw[HEADER_SIZE + header.ext_size :]
    if action == "corrupt" and payload:
        mutated = bytearray(payload)
        mutated[len(mutated) // 2] ^= 0xFF
        payload = bytes(mutated)
    if len(payload) != header.payload_len:
        raise SnapshotError(
            f"{path}: payload is {len(payload)} bytes, header says "
            f"{header.payload_len} (torn write?)"
        )
    if zlib.crc32(payload) != header.payload_crc:
        raise SnapshotError(f"{path}: payload CRC mismatch (corrupt)")
    table = np.frombuffer(payload, dtype="<u4").reshape(
        header.n_slots, header.row_width
    )
    # native-endian writable copy: the restore path reconciles in place
    return header, table.astype(np.uint32)


def reconcile_rows(table: np.ndarray, now: int) -> tuple[np.ndarray, dict]:
    """Reconcile a restored row table against the current clock.

    Restore-time reality check, applied before the table touches the
    device:

      * rows whose jittered TTL passed (expire_at <= now) are DEAD — they
        would be probe-reclaimed anyway; drop them so occupancy restarts
        honest;
      * rows whose FIXED WINDOW ended (window + divider <= now) carry no
        decision state even while TTL-pinned — the next touch would roll
        the window and restart at 0 (ops/slab.py same_window gate) — so
        they are dropped too, exactly the population the set scan evicts
        ahead of any live-window row. The divider word's algorithm bits
        (28-30) are masked before the arithmetic, so the SAME rule serves
        every algorithm: GCRA rows store window = tat_sec - divider, which
        makes "window ended" mean "TAT drained"; concurrency rows store
        window = last touch with divider = idle TTL, which makes it mean
        "idle past the leak TTL". SLIDING rows get one extra window of
        grace (window + 2*divider <= now): a row whose window just ended
        still carries the count the NEXT window's interpolation reads —
        that is why the slab stamps sliding rows with a 2-window
        expire_at (ops/slab.py expire_store) — so dropping it at one
        window would silently disable the 2x boundary-burst protection
        across a warm restart. Pre-algorithm rows carry zero algorithm
        bits, so their reconcile is bit-identical to before (zero drops on
        a v2 round-trip);
      * live rows inside a still-open window keep their counts: these are
        the counters a warm restart exists to preserve.

    Rows written before the divider column existed (divider == 0) keep the
    conservative TTL-only rule, like the sweep. Returns (reconciled copy,
    {'restored', 'dropped_expired', 'dropped_window'} row counts)."""
    table = np.array(table, dtype=np.uint32, copy=True)
    if table.ndim != 2 or table.shape[1] < COL_DIVIDER + 1:
        raise SnapshotError(
            f"cannot reconcile table of shape {table.shape}: need at least "
            f"{COL_DIVIDER + 1} row columns"
        )
    now = np.int64(now)
    occupied = table.any(axis=1)
    expire_at = table[:, COL_EXPIRE].astype(np.int64)
    window = table[:, COL_WINDOW].astype(np.int64)
    algo = (table[:, COL_DIVIDER] >> np.uint32(ALGO_SHIFT)) & np.uint32(7)
    divider = (table[:, COL_DIVIDER] & np.uint32(ALGO_DIV_MASK)).astype(
        np.int64
    )
    live = occupied & (expire_at > now)
    # sliding rows stay useful one window past their own end (see the
    # grace rationale in the docstring); every other algorithm ends at
    # window + divider
    span = np.where(algo == ALGO_SLIDING_WINDOW, divider * 2, divider)
    window_ended = live & (divider > 0) & (window + span <= now)
    keep = live & ~window_ended
    table[~keep] = 0
    return table, {
        "restored": int(np.sum(keep)),
        "dropped_expired": int(np.sum(occupied & ~live)),
        "dropped_window": int(np.sum(window_ended)),
    }


def migrate_rows_to_sets(
    table: np.ndarray, ways: int
) -> tuple[np.ndarray, dict]:
    """Rehash a shard table into the W-way set-associative layout — the
    boot migration for v1 (open-addressed) snapshots and for v2 snapshots
    written under a different SLAB_WAYS. Row CONTENT is layout-independent
    (fp, count, window, expire, divider); only PLACEMENT moves: each
    occupied row lands in set `fp_lo mod n_sets` (the same
    ops/hashing.py set_index split the kernel uses), filling ways in
    descending-count order so that if a set overflows its W ways the
    lowest-count rows are the ones dropped (counted — the same
    least-valuable-first rule the in-kernel eviction applies).

    Call AFTER reconcile_rows: dead and window-ended rows are already
    gone, so only live counters compete for ways. Returns (migrated
    table, {'placed', 'dropped_overflow'})."""
    table = np.asarray(table, dtype=np.uint32)
    n_slots = table.shape[0]
    if ways <= 0 or ways & (ways - 1):
        raise SnapshotError(f"ways must be a power of two, got {ways}")
    ways = min(ways, n_slots)
    if n_slots % ways:
        raise SnapshotError(
            f"table of {n_slots} rows does not split into {ways}-way sets"
        )
    n_sets = n_slots // ways
    out = np.zeros_like(table)
    occupied = np.flatnonzero(table.any(axis=1))
    placed = dropped = 0
    if occupied.size == 0:
        return out, {"placed": 0, "dropped_overflow": 0}
    rows = table[occupied]
    # the set-index split the kernel uses (ops/hashing.py, torch-free)
    sets = set_index(rows[:, COL_FP_LO], n_sets).astype(np.int64)
    counts = rows[:, COL_COUNT].astype(np.int64)
    # group by set; within a set highest counts first (overflow drops the
    # least valuable), stable so equal counts keep their original order
    order = np.lexsort((-counts, sets))
    sets_sorted = sets[order]
    run_start = np.r_[0, np.flatnonzero(sets_sorted[1:] != sets_sorted[:-1]) + 1]
    marker = np.zeros(order.size, dtype=np.int64)
    marker[run_start] = 1
    run_id = np.cumsum(marker) - 1
    rank = np.arange(order.size) - run_start[run_id]
    keep = rank < ways
    placed_idx = order[keep]
    out[sets[placed_idx] * ways + rank[keep]] = rows[placed_idx]
    placed = int(keep.sum())
    dropped = int((~keep).sum())
    return out, {"placed": placed, "dropped_overflow": dropped}


def merge_rows_into_table(
    table: np.ndarray, rows: np.ndarray, ways: int
) -> tuple[np.ndarray, dict]:
    """Merge incoming rows into a W-way table by fingerprint — the
    reshard-push primitive (cluster/reshard.py): the target owner merges
    a streamed route range into its live slab.

    Keep-the-newest rule per (fp_lo, fp_hi): the row with the GREATER
    window wins (a later fixed window, a further-advanced GCRA TAT, a
    fresher concurrency touch — every algorithm stores monotonic
    progress there); equal windows keep the greater count, so a
    stage-then-drain double delivery can only converge upward toward the
    true counter, never roll an admission back. Placement then rebuilds
    through migrate_rows_to_sets — the SAME descending-count,
    overflow-drops-least-valuable discipline every other table migration
    uses. Returns (merged table, {'merged', 'replaced', 'dropped_overflow'})."""
    table = np.asarray(table, dtype=np.uint32)
    rows = np.asarray(rows, dtype=np.uint32)
    if rows.ndim != 2 or rows.shape[1] != table.shape[1]:
        raise SnapshotError(
            f"cannot merge rows of shape {rows.shape} into a table of "
            f"shape {table.shape}"
        )
    n_slots = table.shape[0]
    existing = table[table.any(axis=1)]
    incoming = rows[rows.any(axis=1)]
    stats = {"merged": int(incoming.shape[0]), "replaced": 0,
             "dropped_overflow": 0}
    if incoming.shape[0] == 0:
        return np.array(table, copy=True), stats
    combined = np.vstack([existing, incoming])
    key = combined[:, COL_FP_LO].astype(np.uint64) | (
        combined[:, COL_FP_HI].astype(np.uint64) << np.uint64(32)
    )
    # per fingerprint: keep max window, then max count (lexsort is
    # ascending; the LAST row of each key run is the keeper)
    order = np.lexsort(
        (combined[:, COL_COUNT], combined[:, COL_WINDOW], key)
    )
    sorted_key = key[order]
    is_last = np.r_[sorted_key[1:] != sorted_key[:-1], True]
    best = combined[order[is_last]]
    stats["replaced"] = int(combined.shape[0] - best.shape[0])
    if best.shape[0] > n_slots:
        # more live fingerprints than the table holds at all: keep the
        # highest counts (the in-kernel eviction's value rule)
        keep = np.argsort(-best[:, COL_COUNT].astype(np.int64), kind="stable")
        stats["dropped_overflow"] += int(best.shape[0] - n_slots)
        best = best[keep[:n_slots]]
    scratch = np.zeros_like(table)
    scratch[: best.shape[0]] = best
    out, mig = migrate_rows_to_sets(scratch, ways)
    stats["dropped_overflow"] += mig["dropped_overflow"]
    return out, stats


def set_occupancy_histogram(
    table: np.ndarray, ways: int, now: int | None = None
) -> np.ndarray:
    """int64[ways + 1] histogram of per-set occupancy: entry k = how many
    sets hold exactly k occupied (or, with `now`, live) rows. The offline
    inspector renders this so operators can see set pressure — a mass
    near W means collisions are about to start costing live evictions."""
    table = np.asarray(table, dtype=np.uint32)
    n_slots = table.shape[0]
    ways = min(ways, n_slots) if ways > 0 else n_slots
    if ways & (ways - 1) or n_slots % ways:
        raise SnapshotError(
            f"table of {n_slots} rows does not split into {ways}-way sets"
        )
    if now is None:
        used = table.any(axis=1)
    else:
        used = table[:, COL_EXPIRE].astype(np.int64) > int(now)
    per_set = used.reshape(n_slots // ways, ways).sum(axis=1)
    return np.bincount(per_set, minlength=ways + 1).astype(np.int64)


def reconcile_leases(table: np.ndarray, now: int) -> tuple[np.ndarray, dict]:
    """Reconcile a restored lease-liability table (backends/lease.py
    export_rows layout) against the current clock: TTL-dead leases and
    fully-settled liabilities are dropped (their frontends can no longer
    serve from them — the counted snapshot.restore_dropped_leases
    population); live outstanding liabilities survive to re-seed the
    registry and to floor the restored slab counters. Returns
    (kept rows, {'restored', 'dropped'})."""
    table = np.asarray(table, dtype=np.uint32)
    if table.ndim != 2 or table.shape[1] < LEASE_COL_EXPIRE + 1:
        raise SnapshotError(
            f"cannot reconcile lease table of shape {table.shape}: need at "
            f"least {LEASE_COL_EXPIRE + 1} row columns"
        )
    expire_at = table[:, LEASE_COL_EXPIRE].astype(np.int64)
    outstanding = table[:, LEASE_COL_GRANTED].astype(np.int64) > table[
        :, LEASE_COL_SETTLED
    ].astype(np.int64)
    keep = (expire_at > np.int64(now)) & outstanding
    return table[keep], {
        "restored": int(np.sum(keep)),
        "dropped": int(np.sum(~keep)),
    }


def apply_lease_floors(
    tables: list[np.ndarray], lease_rows: np.ndarray
) -> tuple[int, int]:
    """The never-double-grant rule: every live lease liability floors its
    slab row's counter at the post-grant watermark the device had already
    answered with. A slab snapshot older than a grant would otherwise
    restore a counter BELOW budget the frontends are still serving from —
    the device would re-admit tokens already handed out. Mutates the
    reconciled tables in place; returns (rows floored, liabilities whose
    row was not found — e.g. probe-stolen or swept slots, counted so the
    uncovered overshoot stays observable)."""
    floored = unmatched = 0
    for row in np.asarray(lease_rows, dtype=np.uint32):
        fp_lo, fp_hi = row[LEASE_COL_FP_LO], row[LEASE_COL_FP_HI]
        window = row[LEASE_COL_WINDOW]
        floor = row[LEASE_COL_FLOOR]
        hit = False
        for table in tables:
            match = np.flatnonzero(
                (table[:, COL_FP_LO] == fp_lo)
                & (table[:, COL_FP_HI] == fp_hi)
                & (table[:, COL_WINDOW] == window)
            )
            for idx in match:
                hit = True
                if table[idx, COL_COUNT] < floor:
                    table[idx, COL_COUNT] = floor
                    floored += 1
        if not hit:
            unmatched += 1
    return floored, unmatched


def reconcile_fed_shares(table: np.ndarray, now: int) -> tuple[np.ndarray, dict]:
    """Reconcile a restored federation share ledger (cluster/federation.py
    export_rows layout) against the current clock: TTL-dead rows and rows
    with neither live borrowed balance (GRANTED > SPENT) nor unsettled
    grantor-side outstanding (OUT > 0) are dropped — fully-settled state
    carries no quota liability across a restart. Survivors re-seed the
    coordinator and floor the restored slab counters. Returns
    (kept rows, {'restored', 'dropped'})."""
    table = np.asarray(table, dtype=np.uint32)
    if table.ndim != 2 or table.shape[1] < FED_COL_EXPIRE + 1:
        raise SnapshotError(
            f"cannot reconcile fed share table of shape {table.shape}: "
            f"need at least {FED_COL_EXPIRE + 1} row columns"
        )
    expire_at = table[:, FED_COL_EXPIRE].astype(np.int64)
    granted = table[:, FED_COL_GRANTED].astype(np.int64)
    spent = table[:, FED_COL_SPENT].astype(np.int64)
    settled = table[:, FED_COL_SETTLED].astype(np.int64)
    outstanding = table[:, FED_COL_OUT].astype(np.int64) > 0
    fully_settled = (granted <= spent) & (settled >= spent) & ~outstanding
    keep = (expire_at > np.int64(now)) & ~fully_settled
    return table[keep], {
        "restored": int(np.sum(keep)),
        "dropped": int(np.sum(~keep)),
    }


def apply_fed_floors(
    tables: list[np.ndarray], fed_rows: np.ndarray
) -> tuple[int, int]:
    """The federation analog of apply_lease_floors: every live share row
    floors its slab row's counter at the SPENT watermark — on the home
    cluster that is the full committed count (local spend + grants out),
    so a slab snapshot older than a grant can never restore a counter
    below budget other clusters are still serving from. Mutates the
    reconciled tables in place; returns (rows floored, share rows whose
    slab row was not found)."""
    floored = unmatched = 0
    for row in np.asarray(fed_rows, dtype=np.uint32):
        fp_lo, fp_hi = row[FED_COL_FP_LO], row[FED_COL_FP_HI]
        window = row[FED_COL_WINDOW]
        floor = row[FED_COL_SPENT]
        hit = False
        for table in tables:
            match = np.flatnonzero(
                (table[:, COL_FP_LO] == fp_lo)
                & (table[:, COL_FP_HI] == fp_hi)
                & (table[:, COL_WINDOW] == window)
            )
            for idx in match:
                hit = True
                if table[idx, COL_COUNT] < floor:
                    table[idx, COL_COUNT] = floor
                    floored += 1
        if not hit:
            unmatched += 1
    return floored, unmatched
