"""Port of tools/snapshot_inspect.py: the offline slab-snapshot inspector,
which dumps headers, verifies CRCs and summarizes rows.

Operator muscle for the warm-restart subsystem
(api_ratelimit_tpu_torch/persist/):
given snapshot files written by the SlabSnapshotter, print each file's
header, verify both CRCs and the payload length, and summarize the rows —
how many slots are occupied, how many would survive the restore
reconciliation at a given clock, counter totals. Exit 1 if ANY file fails
validation, so the tool doubles as a pre-restore health gate in deploy
scripts:

    python -m api_ratelimit_tpu_torch.tools.snapshot_inspect \\
        /var/lib/ratelimit/snapshots/*.snap
    python -m api_ratelimit_tpu_torch.tools.snapshot_inspect --json \\
        --now 1754300000 slab.snap

No torch import — inspection must run on any box (deploy tooling, a laptop
with a copied snapshot), not just GPU hosts; the format lives in
persist/snapshot.py which is numpy + stdlib only, and is the JAX
package's byte for byte, so either package's files inspect alike.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from ..persist.snapshot import (
    ALGO_DIV_MASK,
    ALGO_NAMES,
    COL_COUNT,
    COL_DIVIDER,
    COL_EXPIRE,
    COL_WINDOW,
    row_algorithms,
    FED_COL_EXPIRE,
    FED_COL_GRANTED,
    FED_COL_OUT,
    FED_COL_SETTLED,
    FED_COL_SPENT,
    FLAG_FED,
    FLAG_LEASE_TABLE,
    FLAG_VICTIM,
    LEASE_COL_EXPIRE,
    LEASE_COL_GRANTED,
    LEASE_COL_SETTLED,
    SNAPSHOT_VERSION,
    SnapshotError,
    load_snapshot,
    reconcile_fed_shares,
    reconcile_leases,
    reconcile_rows,
    set_occupancy_histogram,
)


def inspect_file(path: str, now: int | None) -> dict:
    """Fully validate one snapshot file and return its report dict;
    raises SnapshotError on any validation failure. Lease-liability
    tables (FLAG_LEASE_TABLE — the leases.snap section) get their own
    report shape: outstanding grants, unsettled tokens, and how the
    boot-time reconcile at `now` would treat them. Federation share
    ledgers (FLAG_FED — the fed.snap section, cluster/federation.py)
    likewise: outstanding inter-cluster shares, unsettled spend, and the
    reconcile-at-`now` preview."""
    header, table = load_snapshot(path)
    at = int(now) if now is not None else int(header.created_at)
    if header.flags & FLAG_LEASE_TABLE:
        granted = table[:, LEASE_COL_GRANTED].astype(np.int64)
        settled = table[:, LEASE_COL_SETTLED].astype(np.int64)
        expire_at = table[:, LEASE_COL_EXPIRE].astype(np.int64)
        _kept, rec = reconcile_leases(table, at)
        return {
            "path": path,
            "valid": True,
            "kind": "leases",
            "version": header.version,
            "created_at": header.created_at,
            "age_seconds": max(0, at - header.created_at),
            "bytes": os.path.getsize(path),
            "leases": {
                "outstanding": int(table.shape[0]),
                "granted_tokens": int(granted.sum()),
                "settled_tokens": int(settled.sum()),
                # the Σ budgets term of the crash-overshoot bound
                "unsettled_tokens": int((granted - settled).sum()),
                "ttl_dead_at_now": int(np.sum(expire_at <= at)),
                "restorable": rec["restored"],
                "dropped_on_restore": rec["dropped"],
            },
        }
    if header.flags & FLAG_FED:
        granted = table[:, FED_COL_GRANTED].astype(np.int64)
        spent = table[:, FED_COL_SPENT].astype(np.int64)
        settled = table[:, FED_COL_SETTLED].astype(np.int64)
        out = table[:, FED_COL_OUT].astype(np.int64)
        expire_at = table[:, FED_COL_EXPIRE].astype(np.int64)
        _kept, rec = reconcile_fed_shares(table, at)
        return {
            "path": path,
            "valid": True,
            "kind": "federation",
            "version": header.version,
            "created_at": header.created_at,
            "age_seconds": max(0, at - header.created_at),
            "bytes": os.path.getsize(path),
            "shares": {
                "rows": int(table.shape[0]),
                "granted_tokens": int(granted.sum()),
                "spent_tokens": int(spent.sum()),
                "settled_tokens": int(settled.sum()),
                # the Σ outstanding-shares term of the partition
                # overshoot bound (cluster/federation.py)
                "outstanding_tokens": int(out.sum()),
                "unsettled_tokens": int(
                    np.maximum(spent - settled, 0).sum()
                ),
                "ttl_dead_at_now": int(np.sum(expire_at <= at)),
                "restorable": rec["restored"],
                "dropped_on_restore": rec["dropped"],
            },
        }
    if header.flags & FLAG_VICTIM:
        # victim-tier section (backends/victim.py — the victim.snap file):
        # demoted live slab rows in the ordinary slab row wire, so the
        # slab reconcile rules preview the restore and the divider word
        # classifies per-row algorithms. Age histogram over window
        # position: how long rows had been parked when the file was cut.
        occupied = table.any(axis=1)
        expire_at = table[:, COL_EXPIRE].astype(np.int64)
        live = occupied & (expire_at > at)
        _kept, rec = reconcile_rows(table, at)
        counts = table[:, COL_COUNT].astype(np.int64)
        algos = row_algorithms(table)
        algo_counts = {
            name: int(np.sum(occupied & (algos == aid)))
            for aid, name in ALGO_NAMES.items()
        }
        ages = np.maximum(
            0, at - table[:, COL_WINDOW].astype(np.int64)
        )[occupied]
        age_hist = {}
        prev = 0
        for bound, label in (
            (10, "<10s"),
            (60, "<60s"),
            (600, "<600s"),
            (1 << 62, ">=600s"),
        ):
            n = int(np.sum(ages < bound))
            age_hist[label] = n - prev
            prev = n
        return {
            "path": path,
            "valid": True,
            "kind": "victim",
            "version": header.version,
            "created_at": header.created_at,
            "age_seconds": max(0, at - header.created_at),
            "bytes": os.path.getsize(path),
            "algorithms": algo_counts,
            "rows": {
                "occupied": int(np.sum(occupied)),
                "live_at_now": int(np.sum(live)),
                "restorable": rec["restored"],
                "dropped_expired": rec["dropped_expired"],
                "dropped_window": rec["dropped_window"],
                # Σ counts parked in the tier — the decision state the
                # tier is holding against loss
                "count_sum": (
                    int(counts[occupied].sum()) if occupied.any() else 0
                ),
                "age_histogram": age_hist,
            },
        }
    occupied = table.any(axis=1)
    expire_at = table[:, COL_EXPIRE].astype(np.int64)
    live = occupied & (expire_at > at)
    _reconciled, rec = reconcile_rows(table, at)
    counts = table[:, COL_COUNT].astype(np.int64)
    # per-set occupancy: v2 headers carry the writer's ways; v1 files are
    # open-addressed, so the set view only applies post-migration — show
    # the histogram at the default geometry with a migration note instead
    ways = header.ways or 0
    set_view = None
    if ways and header.n_slots % ways == 0:
        hist = set_occupancy_histogram(table, ways)
        nonzero = {
            int(k): int(v) for k, v in enumerate(hist) if v
        }
        full_sets = int(hist[ways]) if hist.shape[0] > ways else 0
        set_view = {
            "ways": ways,
            "n_sets": header.n_slots // ways,
            "occupancy_histogram": nonzero,
            "full_sets": full_sets,
            "max_set_occupancy": max(nonzero) if nonzero else 0,
        }
    # per-row algorithm class (divider word bits 28-30; pre-algorithm
    # files carry 0 everywhere => all rows classify fixed_window)
    algos = row_algorithms(table)
    algo_counts = {
        name: int(np.sum(occupied & (algos == aid)))
        for aid, name in ALGO_NAMES.items()
    }
    report = {
        "path": path,
        "valid": True,
        "kind": "slab",
        "algorithms": algo_counts,
        "version": header.version,
        "needs_migration": header.version < SNAPSHOT_VERSION,
        "sets": set_view,
        "created_at": header.created_at,
        "age_seconds": max(0, at - header.created_at),
        "shard": f"{header.shard_index}/{header.shard_count}",
        "n_slots": header.n_slots,
        "row_width": header.row_width,
        # cluster keyspace stamp (FLAG_PARTITION; cluster/): which
        # partition and route-set range this file's owner served
        "partition": (
            {
                "index": header.partition[0],
                "range": [header.partition[1], header.partition[2]],
                "route_sets": header.partition[3],
            }
            if header.partition is not None
            else None
        ),
        "bytes": os.path.getsize(path),
        "rows": {
            "occupied": int(np.sum(occupied)),
            "live_at_now": int(np.sum(live)),
            "restorable": rec["restored"],
            "dropped_expired": rec["dropped_expired"],
            "dropped_window": rec["dropped_window"],
            "count_sum": int(counts[occupied].sum()) if occupied.any() else 0,
            "count_max": int(counts[occupied].max()) if occupied.any() else 0,
            "dividers": sorted(
                int(d)
                for d in np.unique(
                    table[occupied, COL_DIVIDER] & np.uint32(ALGO_DIV_MASK)
                )
            )
            if occupied.any()
            else [],
            "window_span_s": (
                int(
                    table[occupied, COL_WINDOW].astype(np.int64).max()
                    - table[occupied, COL_WINDOW].astype(np.int64).min()
                )
                if occupied.any()
                else 0
            ),
        },
    }
    return report


def _print_text(report: dict) -> None:
    if report.get("kind") == "leases":
        leases = report["leases"]
        print(f"{report['path']}:")
        print(
            f"  header  v{report['version']} lease-liability table "
            f"created_at={report['created_at']} "
            f"(age {report['age_seconds']}s) "
            f"({report['bytes']} bytes)  CRC OK"
        )
        print(
            f"  leases  outstanding={leases['outstanding']} "
            f"unsettled_tokens={leases['unsettled_tokens']} "
            f"(granted={leases['granted_tokens']}, "
            f"settled={leases['settled_tokens']})"
        )
        print(
            f"  restore restorable={leases['restorable']} "
            f"dropped={leases['dropped_on_restore']} "
            f"ttl_dead={leases['ttl_dead_at_now']}"
        )
        return
    if report.get("kind") == "federation":
        shares = report["shares"]
        print(f"{report['path']}:")
        print(
            f"  header  v{report['version']} federation share ledger "
            f"created_at={report['created_at']} "
            f"(age {report['age_seconds']}s) "
            f"({report['bytes']} bytes)  CRC OK"
        )
        print(
            f"  shares  rows={shares['rows']} "
            f"outstanding_tokens={shares['outstanding_tokens']} "
            f"unsettled_tokens={shares['unsettled_tokens']} "
            f"(granted={shares['granted_tokens']}, "
            f"spent={shares['spent_tokens']}, "
            f"settled={shares['settled_tokens']})"
        )
        print(
            f"  restore restorable={shares['restorable']} "
            f"dropped={shares['dropped_on_restore']} "
            f"ttl_dead={shares['ttl_dead_at_now']}"
        )
        return
    if report.get("kind") == "victim":
        rows = report["rows"]
        print(f"{report['path']}:")
        print(
            f"  header  v{report['version']} victim tier "
            f"created_at={report['created_at']} "
            f"(age {report['age_seconds']}s) "
            f"({report['bytes']} bytes)  CRC OK"
        )
        print(
            f"  rows    occupied={rows['occupied']} "
            f"live={rows['live_at_now']} "
            f"restorable={rows['restorable']} "
            f"dropped(expired={rows['dropped_expired']}, "
            f"window_ended={rows['dropped_window']}) "
            f"count_sum={rows['count_sum']}"
        )
        algos = report.get("algorithms")
        if algos:
            body = " ".join(f"{k}:{v}" for k, v in algos.items() if v)
            print(f"  algos   {body or 'fixed_window:0 (empty)'}")
        ages = " ".join(
            f"{k}:{v}" for k, v in rows["age_histogram"].items()
        )
        print(f"  ages    {ages}")
        return
    rows = report["rows"]
    print(f"{report['path']}:")
    print(
        f"  header  v{report['version']} shard {report['shard']} "
        f"created_at={report['created_at']} "
        f"(age {report['age_seconds']}s) "
        f"{report['n_slots']} slots x {report['row_width']} words "
        f"({report['bytes']} bytes)  CRC OK"
    )
    print(
        f"  rows    occupied={rows['occupied']} live={rows['live_at_now']} "
        f"restorable={rows['restorable']} "
        f"dropped(expired={rows['dropped_expired']}, "
        f"window_ended={rows['dropped_window']})"
    )
    part = report.get("partition")
    if part:
        print(
            f"  cluster partition {part['index']} owning route sets "
            f"[{part['range'][0]}, {part['range'][1]}) of "
            f"{part['route_sets']}"
        )
    print(
        f"  counts  sum={rows['count_sum']} max={rows['count_max']} "
        f"dividers={rows['dividers']} window_span={rows['window_span_s']}s"
    )
    algos = report.get("algorithms")
    if algos:
        body = " ".join(f"{k}:{v}" for k, v in algos.items() if v)
        print(f"  algos   {body or 'fixed_window:0 (empty)'}")
    if report.get("needs_migration"):
        print(
            f"  layout  v{report['version']} open-addressed — boot will "
            f"rehash rows into the running set geometry (migration path)"
        )
    sets = report.get("sets")
    if sets:
        hist = sets["occupancy_histogram"]
        # render a compact k:count line, capped to the busiest entries
        top = sorted(hist.items())[-8:]
        body = " ".join(f"{k}:{v}" for k, v in top)
        print(
            f"  sets    {sets['n_sets']} x {sets['ways']}-way; "
            f"occupancy histogram (rows/set: sets) {body}; "
            f"full={sets['full_sets']} max={sets['max_set_occupancy']}"
        )


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Dump and verify slab snapshot files offline."
    )
    parser.add_argument("files", nargs="+", help="snapshot file(s)")
    parser.add_argument(
        "--json", action="store_true", help="emit one JSON array of reports"
    )
    parser.add_argument(
        "--now",
        type=int,
        default=None,
        help="clock (unix s) for liveness/reconcile stats; default: each "
        "file's created_at (set this to time.time() to preview a restore "
        "happening now)",
    )
    parser.add_argument(
        "--wallclock",
        action="store_true",
        help="shorthand for --now=<current unix time>",
    )
    args = parser.parse_args(argv)
    now = int(time.time()) if args.wallclock else args.now

    reports: list[dict] = []
    failed = 0
    for path in args.files:
        try:
            reports.append(inspect_file(path, now))
        except SnapshotError as e:
            failed += 1
            reports.append({"path": path, "valid": False, "error": str(e)})
    if args.json:
        print(json.dumps(reports, indent=2))
    else:
        for report in reports:
            if report["valid"]:
                _print_text(report)
            else:
                print(f"{report['path']}: INVALID — {report['error']}")
    if failed:
        print(
            f"snapshot-inspect: {failed} of {len(args.files)} file(s) "
            f"failed validation",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
