"""Port of api_ratelimit_tpu/persist/snapshotter.py: the warm-restart
runtime service (periodic snapshots, boot restore, drain handoff,
staleness probe).

SlabSnapshotter sits NEXT to the device engine, never inside its hot path:
on a cadence (SLAB_SNAPSHOT_INTERVAL_MS) it asks the engine for a
quiesce-and-copy of the slab (backends/cuda.py export_tables: only a
device-side clone is enqueued under the state lock, so launches keep
flowing while the copy drains to the host) and writes one CRC-protected
file per shard via snapshot.py's atomic temp+fsync+rename. At boot,
restore() validates every shard file, reconciles rows against the current
clock (snapshot.reconcile_rows: drop dead and window-ended rows, keep live
counters), and uploads the table back to the device BEFORE the first
request. During graceful drain, drain() quiesces the engine (batcher
refuses new submits, queued work finishes) and takes one final copy — a
planned restart therefore loses ~0 state; an unplanned one loses at most
one snapshot interval of traffic, and every loss fails open (a restored
undercount can only under-enforce).

A bad snapshot never takes the boot down: any validation failure rejects
the file set (counted in snapshot.load_rejected) and the slab starts cold
— the pre-warm-restart behavior, and the same fail-open posture as the
rest of the resilience ladder.

Beside the slab shards the set carries the lease liabilities (leases.snap,
FLAG_LEASE_TABLE: restore floors each restored counter at its live grant's
watermark, so a restart never grants twice) and the victim tier
(victim.snap, FLAG_VICTIM: demoted rows re-seed the tier and resume
mid-window) and, with quota federation, the share ledger (fed.snap,
FLAG_FED: restore floors each restored counter at its live share's
watermark before the table is uploaded to the card, so a restart never
re-serves budget another cluster holds, and re-seeds the coordinator's
ledger with the restart fence floor raised), each written with the
reference's rule: when it has rows or the file already exists. A bad
section file degrades to a slab-only restore, counted in load_rejected.
Files move between the two packages in both directions.

This module is numpy + stdlib only (the engine owns all device work).
"""

from __future__ import annotations

import logging
import os
import threading
import time

import numpy as np

from .snapshot import (
    FED_ROW_WIDTH,
    FLAG_FED,
    FLAG_LEASE_TABLE,
    FLAG_VICTIM,
    LEASE_ROW_WIDTH,
    ROW_WIDTH,
    SNAPSHOT_VERSION,
    SnapshotError,
    apply_fed_floors,
    apply_lease_floors,
    load_snapshot,
    migrate_rows_to_sets,
    reconcile_fed_shares,
    reconcile_leases,
    reconcile_rows,
    write_snapshot,
)

_log = logging.getLogger("ratelimit.persist")


def snapshot_paths(directory: str, shard_count: int) -> list[str]:
    """The canonical per-shard snapshot file names: one `slab.snap` for a
    single-device slab, `slab.<i>-of-<n>.snap` per shard for a mesh — the
    shard split is part of the name so a topology change can never
    silently load another layout's files."""
    if shard_count <= 1:
        return [os.path.join(directory, "slab.snap")]
    return [
        os.path.join(directory, f"slab.{i:02d}-of-{shard_count:02d}.snap")
        for i in range(shard_count)
    ]


def lease_snapshot_path(directory: str) -> str:
    """The lease-liability section of the snapshot set (one file — the
    registry is global, not per-shard), written with FLAG_LEASE_TABLE so
    it can never masquerade as a slab shard."""
    return os.path.join(directory, "leases.snap")


def fed_snapshot_path(directory: str) -> str:
    """The federation share-ledger section of the snapshot set (one file —
    the ledger is global, not per-shard), written with FLAG_FED so it can
    never masquerade as a slab shard or a lease table."""
    return os.path.join(directory, "fed.snap")


def victim_snapshot_path(directory: str) -> str:
    """The victim-tier section of the snapshot set (one file — the tier
    is host-global, not per-shard), written with FLAG_VICTIM so it can
    never masquerade as a slab shard: its rows are DEMOTED state, and a
    restart must re-seed them into the tier for promotion, not upload
    them onto a device that had no room for them."""
    return os.path.join(directory, "victim.snap")


class SlabSnapshotter:
    """Periodic slab snapshotter + boot restorer + drain handoff.

    engine contract (backends/cuda.py SlabDeviceEngine provides it):
        export_tables() -> list[np.ndarray]   one (shard_slots, ROW_WIDTH)
                                              uint32 table per shard
        import_tables(list[np.ndarray])      upload reconciled tables
        shard_count / shard_slots            the snapshot file layout
        ways                                 stamped into each header
        drain()                              optional: quiesce before the
                                             final drain snapshot
        lease_registry                       optional: leases.snap
        victim_tier                          optional (None: no tier):
                                             victim.snap

    scope: optional stats Scope rooted at the service prefix; registers
    the snapshot.* telemetry (the reference's counters, gauges and the
    write_ms histogram) and an age-gauge generator on the owning store.
    fault_injector: any object with fire(site) -> action or None
    (testing/faults.py FaultInjector), consulted at the snapshot.write /
    snapshot.load sites (snapshot.py); None disables them.
    partition: (partition_index, range_lo, range_hi, route_sets) of a
    partitioned owner (cluster/), stamped into every slab-shard header
    (snapshot.py FLAG_PARTITION) so a file says which keyspace slice it
    holds; None keeps the unpartitioned format byte for byte.
    fed: optional cluster/federation.py FederationCoordinator whose share
    ledger rides the set as fed.snap (FLAG_FED); None writes the exact
    federation-free set."""

    def __init__(
        self,
        engine,
        directory: str,
        interval_ms: float = 10_000.0,
        stale_after_ms: float = 0.0,
        time_source=None,
        scope=None,
        fault_injector=None,
        partition: tuple | None = None,
        fed=None,
    ):
        if interval_ms <= 0:
            raise ValueError(
                f"snapshot interval must be positive, got {interval_ms}"
            )
        self._engine = engine
        self._dir = directory
        self._partition = partition
        self._interval_s = float(interval_ms) / 1e3
        # default staleness: 3 missed intervals — one in-flight write plus
        # real slack before the health surface starts reporting degraded
        self._stale_after_s = (
            float(stale_after_ms) / 1e3
            if stale_after_ms > 0
            else 3.0 * self._interval_s
        )
        if time_source is None:
            from ..utils.timeutil import RealTimeSource

            time_source = RealTimeSource()
        self._time_source = time_source
        self._faults = fault_injector
        # the federation share ledger rides the snapshot set so a restart
        # never re-serves budget another cluster already holds
        self._fed = fed
        self._lock = threading.Lock()  # serializes snapshot_once callers
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._last_ok_unix: float | None = None
        self._started_unix: float | None = None
        self.writes_total = 0
        self.write_errors_total = 0
        self.load_rejected_total = 0
        self.last_bytes = 0
        self.restore_stats: dict | None = None
        self._c_writes = self._c_errors = self._c_rejected = None
        self._g_bytes = self._g_age = None
        self._g_rows = self._g_dropped_expired = self._g_dropped_window = None
        self._g_leases = self._g_dropped_leases = None
        self._g_fed = self._g_dropped_fed = None
        self._g_victim = self._g_dropped_victim = None
        self._h_write = None
        if scope is not None:
            snap = scope.scope("snapshot")
            self._c_writes = snap.counter("writes")
            self._c_errors = snap.counter("write_errors")
            self._c_rejected = snap.counter("load_rejected")
            self._g_bytes = snap.gauge("bytes")
            self._g_age = snap.gauge("age_seconds")
            self._g_rows = snap.gauge("restore_rows")
            self._g_dropped_expired = snap.gauge("restore_dropped_expired")
            self._g_dropped_window = snap.gauge("restore_dropped_window")
            self._g_leases = snap.gauge("restore_leases")
            self._g_dropped_leases = snap.gauge("restore_dropped_leases")
            self._g_fed = snap.gauge("restore_fed_shares")
            self._g_dropped_fed = snap.gauge("restore_dropped_fed_shares")
            self._g_victim = snap.gauge("restore_victim_rows")
            self._g_dropped_victim = snap.gauge("restore_dropped_victim_rows")
            self._h_write = snap.histogram("write_ms")
            scope.add_stat_generator(self)
        os.makedirs(directory, exist_ok=True)

    # -- stats --

    def age_seconds(self) -> float:
        """Seconds since the last successful snapshot — or since start()
        when none has succeeded yet (so a snapshotter that never manages a
        write still goes stale); -1 before the first start()/success."""
        basis = (
            self._last_ok_unix
            if self._last_ok_unix is not None
            else self._started_unix
        )
        if basis is None:
            return -1.0
        return max(0.0, float(self._time_source.unix_now()) - basis)

    def generate_stats(self) -> None:
        """StatGenerator hook: refresh the age gauge at every flush."""
        if self._g_age is not None:
            self._g_age.set(int(self.age_seconds()))

    def stale_reason(self) -> str | None:
        """HealthChecker degraded-probe contract: a reason string while
        snapshots are stale (no success within the stale window), else
        None. Degraded-only — serving from a live slab with stale
        durability must not drain the instance."""
        age = self.age_seconds()
        if age < 0 or age <= self._stale_after_s:
            return None
        return (
            f"slab snapshots stale: last success {age:.0f}s ago "
            f"(limit {self._stale_after_s:.0f}s)"
        )

    # -- snapshot --

    def snapshot_once(self) -> int:
        """Export every shard and write its snapshot file atomically;
        returns total bytes written, 0 on failure (counted + logged —
        a failing disk must degrade durability, never the service)."""
        with self._lock:
            t0 = time.perf_counter()
            try:
                tables = self._engine.export_tables()
                now = int(self._time_source.unix_now())
                paths = snapshot_paths(self._dir, len(tables))
                total = 0
                ways = int(getattr(self._engine, "ways", 0))
                for i, (path, table) in enumerate(zip(paths, tables)):
                    total += write_snapshot(
                        path,
                        table,
                        created_at=now,
                        shard_index=i,
                        shard_count=len(tables),
                        fault_injector=self._faults,
                        ways=ways,
                        partition=self._partition,
                    )
                # lease-liability section: outstanding grants ride the
                # same snapshot set so a restart never double-grants
                # (backends/lease.py). Lease-free deployments keep the
                # exact pre-lease snapshot set (no extra file/fault-site
                # firing); once liabilities exist the file is maintained
                # even when they drain back to zero — a stale liability
                # file must never floor a fresh slab.
                registry = getattr(self._engine, "lease_registry", None)
                if registry is not None:
                    rows = registry.export_rows(now)
                    lease_path = lease_snapshot_path(self._dir)
                    if rows.shape[0] or os.path.exists(lease_path):
                        total += write_snapshot(
                            lease_path,
                            rows,
                            created_at=now,
                            fault_injector=self._faults,
                            flags=FLAG_LEASE_TABLE,
                        )
                # federation share-ledger section: the same liability
                # discipline one level up. Shares this cluster granted
                # out, holds, or has committed locally ride the snapshot
                # set so a restart floors restored counters at the live
                # share watermarks instead of re-serving granted budget.
                # Federation-free deployments keep the exact pre-fed set.
                if self._fed is not None:
                    fed_rows = self._fed.export_rows()
                    fed_path = fed_snapshot_path(self._dir)
                    if fed_rows.shape[0] or os.path.exists(fed_path):
                        total += write_snapshot(
                            fed_path,
                            fed_rows,
                            created_at=now,
                            fault_injector=self._faults,
                            flags=FLAG_FED,
                        )
                # victim-tier section: demoted live rows ride the same
                # snapshot set so a restart resumes them mid-window
                # instead of re-serving a fresh window to every demoted
                # key (backends/victim.py). Tier-less deployments keep
                # the exact pre-tier snapshot set; once the file exists
                # it is maintained even when the tier drains empty — a
                # stale victim file must never re-seed dead counters.
                victim = getattr(self._engine, "victim_tier", None)
                if victim is not None:
                    victim_rows = victim.export_rows()
                    victim_path = victim_snapshot_path(self._dir)
                    if victim_rows.shape[0] or os.path.exists(victim_path):
                        total += write_snapshot(
                            victim_path,
                            victim_rows,
                            created_at=now,
                            fault_injector=self._faults,
                            flags=FLAG_VICTIM,
                        )
            except Exception as e:
                self.write_errors_total += 1
                if self._c_errors is not None:
                    self._c_errors.inc()
                _log.warning("slab snapshot failed: %s", e)
                return 0
            self.writes_total += 1
            self.last_bytes = total
            self._last_ok_unix = float(now)
            if self._c_writes is not None:
                self._c_writes.inc()
                self._g_bytes.set(total)
                self._h_write.record((time.perf_counter() - t0) * 1e3)
            return total

    # -- restore --

    def restore(self) -> dict:
        """Boot-time restore: load + validate every shard file, reconcile
        against the current clock, upload to the device. Returns a stats
        dict; {'restored': False} means the slab boots cold (no files, or
        a rejected set — counted in snapshot.load_rejected)."""
        shard_count = int(getattr(self._engine, "shard_count", 1))
        paths = snapshot_paths(self._dir, shard_count)
        if not any(os.path.exists(p) for p in paths):
            self.restore_stats = {"restored": False, "reason": "no snapshot"}
            return self.restore_stats
        now = int(self._time_source.unix_now())
        shard_slots = int(getattr(self._engine, "shard_slots"))
        engine_ways = int(getattr(self._engine, "ways", 0))
        tables: list[np.ndarray] = []
        totals = {
            "restored": 0,
            "dropped_expired": 0,
            "dropped_window": 0,
            "migrated": 0,
            "dropped_overflow": 0,
        }
        created_at = None
        try:
            for i, path in enumerate(paths):
                header, table = load_snapshot(path, fault_injector=self._faults)
                if (header.shard_index, header.shard_count) != (i, shard_count):
                    raise SnapshotError(
                        f"{path}: file is shard {header.shard_index} of "
                        f"{header.shard_count}, expected {i} of {shard_count}"
                    )
                if header.n_slots != shard_slots:
                    raise SnapshotError(
                        f"{path}: snapshot has {header.n_slots} slots per "
                        f"shard, slab is configured for {shard_slots}"
                    )
                if header.row_width != ROW_WIDTH:
                    raise SnapshotError(
                        f"{path}: row width {header.row_width} != {ROW_WIDTH}"
                    )
                if created_at is None or header.created_at < created_at:
                    created_at = header.created_at  # oldest shard bounds loss
                table, stats = reconcile_rows(table, now)
                # layout migration: a v1 (open-addressed) shard, or a v2
                # shard written under a different SLAB_WAYS, rehashes its
                # live rows into the running set geometry — an old
                # snapshot is migrated, never rejected. Same-geometry v2
                # files skip the rehash entirely.
                if engine_ways and (
                    header.version < SNAPSHOT_VERSION
                    or header.ways != engine_ways
                ):
                    table, mig = migrate_rows_to_sets(table, engine_ways)
                    totals["migrated"] += mig["placed"]
                    totals["dropped_overflow"] += mig["dropped_overflow"]
                for k in stats:
                    totals[k] += stats[k]
                tables.append(table)
            lease_stats = self._restore_leases(tables, now)
            # the floors land on the reconciled tables before the upload
            fed_stats = self._restore_fed(tables, now)
            victim_stats = self._restore_victim(now)
            self._engine.import_tables(tables)
        except (SnapshotError, OSError, ValueError) as e:
            self.load_rejected_total += 1
            if self._c_rejected is not None:
                self._c_rejected.inc()
            _log.warning(
                "slab snapshot rejected, booting cold: %s", e
            )
            self.restore_stats = {"restored": False, "reason": str(e)}
            return self.restore_stats
        if self._g_rows is not None:
            self._g_rows.set(totals["restored"])
            self._g_dropped_expired.set(totals["dropped_expired"])
            self._g_dropped_window.set(totals["dropped_window"])
        _log.info(
            "slab restored from %s: %d live rows (%d expired, %d "
            "window-ended dropped, %d rehashed into sets, %d set-overflow "
            "dropped), snapshot age %ds",
            self._dir,
            totals["restored"],
            totals["dropped_expired"],
            totals["dropped_window"],
            totals["migrated"],
            totals["dropped_overflow"],
            max(0, now - created_at) if created_at is not None else -1,
        )
        # success contract: 'restored' carries the live-row COUNT and there
        # is no 'reason' key; a cold boot is {'restored': False, 'reason'}
        self.restore_stats = {
            "snapshot_age_seconds": (
                max(0, now - created_at) if created_at is not None else -1
            ),
            **totals,
            **lease_stats,
            **fed_stats,
            **victim_stats,
        }
        return self.restore_stats

    def _restore_leases(self, tables: list[np.ndarray], now: int) -> dict:
        """The lease-liability half of restore: reconcile leases.snap
        against the clock (TTL-dead and fully-settled liabilities drop —
        snapshot.restore_dropped_leases), floor the reconciled slab
        counters at each live liability's post-grant watermark (a restart
        must never double-grant budget frontends still hold), and re-seed
        the engine's registry. A bad lease file degrades to a slab-only
        restore (counted in load_rejected), never a cold boot."""
        registry = getattr(self._engine, "lease_registry", None)
        path = lease_snapshot_path(self._dir)
        stats = {"restored_leases": 0, "dropped_leases": 0}
        if registry is None or not os.path.exists(path):
            return stats
        try:
            header, rows = load_snapshot(path, fault_injector=self._faults)
            if header.flags != FLAG_LEASE_TABLE:
                raise SnapshotError(
                    f"{path}: flags {header.flags} is not a lease table"
                )
            if header.row_width != LEASE_ROW_WIDTH:
                raise SnapshotError(
                    f"{path}: lease row width {header.row_width} != "
                    f"{LEASE_ROW_WIDTH}"
                )
            kept, rec = reconcile_leases(rows, now)
        except (SnapshotError, OSError, ValueError) as e:
            self.load_rejected_total += 1
            if self._c_rejected is not None:
                self._c_rejected.inc()
            _log.warning(
                "lease liability snapshot rejected (slab restores without "
                "floors): %s",
                e,
            )
            return stats
        floored, unmatched = apply_lease_floors(tables, kept)
        registry.import_rows(kept)
        stats = {
            "restored_leases": rec["restored"],
            "dropped_leases": rec["dropped"],
        }
        if self._g_leases is not None:
            self._g_leases.set(rec["restored"])
            self._g_dropped_leases.set(rec["dropped"])
        if rec["restored"] or rec["dropped"]:
            _log.info(
                "lease liabilities restored: %d live (%d TTL-dead/settled "
                "dropped), %d slab counters floored, %d liabilities "
                "unmatched",
                rec["restored"],
                rec["dropped"],
                floored,
                unmatched,
            )
        return stats

    def _restore_fed(self, tables: list[np.ndarray], now: int) -> dict:
        """The federation-share half of restore: reconcile fed.snap against
        the clock (TTL-dead and fully-settled shares drop —
        snapshot.restore_dropped_fed_shares), floor the reconciled slab
        counters at each live share's committed watermark (a restart must
        never re-serve budget other clusters already hold), and re-seed
        the coordinator's ledger (federation.import_rows also raises the
        restart fence floor so pre-crash settlements are rejected as
        stale-epoch). A bad fed file degrades to a slab-only restore
        (counted in load_rejected), never a cold boot."""
        path = fed_snapshot_path(self._dir)
        stats = {"restored_fed_shares": 0, "dropped_fed_shares": 0}
        if self._fed is None or not os.path.exists(path):
            return stats
        try:
            header, rows = load_snapshot(path, fault_injector=self._faults)
            if header.flags != FLAG_FED:
                raise SnapshotError(
                    f"{path}: flags {header.flags} is not a federation "
                    f"share ledger"
                )
            if header.row_width != FED_ROW_WIDTH:
                raise SnapshotError(
                    f"{path}: fed row width {header.row_width} != "
                    f"{FED_ROW_WIDTH}"
                )
            kept, rec = reconcile_fed_shares(rows, now)
        except (SnapshotError, OSError, ValueError) as e:
            self.load_rejected_total += 1
            if self._c_rejected is not None:
                self._c_rejected.inc()
            _log.warning(
                "federation share snapshot rejected (slab restores without "
                "share floors): %s",
                e,
            )
            return stats
        floored, unmatched = apply_fed_floors(tables, kept)
        self._fed.import_rows(kept, now)
        stats = {
            "restored_fed_shares": rec["restored"],
            "dropped_fed_shares": rec["dropped"],
        }
        if self._g_fed is not None:
            self._g_fed.set(rec["restored"])
            self._g_dropped_fed.set(rec["dropped"])
        if rec["restored"] or rec["dropped"]:
            _log.info(
                "federation shares restored: %d live (%d TTL-dead/settled "
                "dropped), %d slab counters floored, %d shares unmatched",
                rec["restored"],
                rec["dropped"],
                floored,
                unmatched,
            )
        return stats

    def _restore_victim(self, now: int) -> dict:
        """The victim-tier half of restore: reconcile victim.snap against
        the clock (the SAME reconcile_rows rules the slab shards get —
        dead and window-ended demoted rows carry no decision state and
        drop; snapshot.restore_dropped_victim_rows), then re-seed the
        engine's tier so every surviving demoted key still resumes
        mid-window across the restart. import_rows re-applies the running
        config's bounds, so a snapshot written under a larger
        VICTIM_MAX_ROWS can never overflow a smaller tier. A bad victim
        file degrades to a tier-less restore (counted in load_rejected),
        never a cold boot."""
        victim = getattr(self._engine, "victim_tier", None)
        path = victim_snapshot_path(self._dir)
        stats = {"restored_victim_rows": 0, "dropped_victim_rows": 0}
        if victim is None or not os.path.exists(path):
            return stats
        try:
            header, rows = load_snapshot(path, fault_injector=self._faults)
            if header.flags != FLAG_VICTIM:
                raise SnapshotError(
                    f"{path}: flags {header.flags} is not a victim tier"
                )
            if header.row_width != ROW_WIDTH:
                raise SnapshotError(
                    f"{path}: victim row width {header.row_width} != "
                    f"{ROW_WIDTH}"
                )
            kept, rec = reconcile_rows(rows, now)
        except (SnapshotError, OSError, ValueError) as e:
            self.load_rejected_total += 1
            if self._c_rejected is not None:
                self._c_rejected.inc()
            _log.warning(
                "victim tier snapshot rejected (slab restores without the "
                "tier's demoted rows): %s",
                e,
            )
            return stats
        kept = kept[kept.any(axis=1)]  # compact: the tier stores occupied
        absorbed = victim.import_rows(kept, now)
        dropped = rec["dropped_expired"] + rec["dropped_window"]
        stats = {
            "restored_victim_rows": absorbed,
            "dropped_victim_rows": dropped,
        }
        if self._g_victim is not None:
            self._g_victim.set(absorbed)
            self._g_dropped_victim.set(dropped)
        if absorbed or dropped:
            _log.info(
                "victim tier restored: %d demoted rows re-seeded (%d "
                "dead/window-ended dropped)",
                absorbed,
                dropped,
            )
        return stats

    def start(self) -> None:
        """Spawn the periodic snapshot thread (daemon; one per process)."""
        if self._thread is not None:
            return
        self._started_unix = float(self._time_source.unix_now())
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self._interval_s):
                self.snapshot_once()

        self._thread = threading.Thread(
            target=loop, name="slab-snapshot", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def drain(self) -> int:
        """Graceful-drain handoff: stop the periodic loop, quiesce the
        engine (refuse new submits, finish everything already queued —
        backends/batcher.py and dispatch.py drain), then take one final
        snapshot. A planned restart therefore hands the next process a
        slab that includes every admitted decision; returns bytes
        written."""
        self.stop()
        engine_drain = getattr(self._engine, "drain", None)
        if engine_drain is not None:
            try:
                engine_drain()
            except Exception as e:  # drain is best-effort; snapshot anyway
                _log.warning("engine drain before final snapshot failed: %s", e)
        return self.snapshot_once()
