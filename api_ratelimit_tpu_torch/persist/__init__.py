"""Port of api_ratelimit_tpu/persist: warm restart, the crash-safe slab
snapshot and restore.

A periodic, off-hot-path snapshotter copies the device slab to a
CRC-protected, versioned file (snapshot.py: temp file + fsync + rename, so
a crash mid-write leaves the previous snapshot intact), a boot-time
restorer validates and reconciles it against the current clock before the
first request, and a final snapshot rides the graceful-drain path so
planned restarts lose ~0 state. Without it a restarted limiter forgets
every window and fails open for a full window per key.

snapshot.py holds the file format and the reconcile rules (numpy only: it
imports without torch); snapshotter.py holds the runtime service (periodic
thread, boot restore, drain handoff, stats, staleness probe);
replication.py streams the slab to a warm standby owner and promotes it on
failover (the frame codec, the ship and apply loops, the epoch fence).
"""

from .snapshot import (
    SNAPSHOT_VERSION,
    SnapshotError,
    SnapshotHeader,
    load_snapshot,
    pack_table_bytes,
    read_header,
    reconcile_rows,
    unpack_table_bytes,
    write_snapshot,
)
from .snapshotter import SlabSnapshotter, snapshot_paths

__all__ = [
    "SNAPSHOT_VERSION",
    "SlabSnapshotter",
    "SnapshotError",
    "SnapshotHeader",
    "load_snapshot",
    "pack_table_bytes",
    "read_header",
    "reconcile_rows",
    "snapshot_paths",
    "unpack_table_bytes",
    "write_snapshot",
]
