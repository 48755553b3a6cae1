"""Port of api_ratelimit_tpu/cmd/sidecar_cmd.py: the device-owner process.

    BACKEND_TYPE=cuda python -m api_ratelimit_tpu_torch.cmd.sidecar_cmd \
        [--role primary|standby|auto] [--partition K]

Run ONE of these per card, then any number of frontend servers with
BACKEND_TYPE=cuda-sidecar sharing its SIDECAR_SOCKET: they bind the serving
ports together through SO_REUSEPORT and the kernel spreads connections over
them, while every increment serializes through this process's slab
(backends/sidecar.py). A FRONTEND_PROCS=N master with BACKEND_TYPE=cuda
spawns this process itself (cmd/service_cmd.py).

The engine is SlabDeviceEngine(block_mode=True) on the card, at the same
TPU_* knobs as the in-process backend (TPU_SLAB_SLOTS, SLAB_WAYS,
TPU_BUCKETS, TPU_BATCH_WINDOW (the cross-frontend coalescing window; > 0
runs the dispatch loop that the shared-memory rings feed), TPU_BATCH_LIMIT,
TPU_PRECOMPILE, HOTKEY_*, VICTIM_*, GCRA_BURST_RATIO) and the SLAB_SNAPSHOT_*
warm-restart knobs: the owner owns the slab, so restore, the periodic
snapshot and the drain snapshot on SIGTERM run here, never in the frontends.
There is no CPU switch: the process holds the card or exits 1.

Telemetry: the owner holds the device, so the device-stage histograms, the
dispatch loop's, the slab's health, the sketch's, the victim tier's and the
lease registry's gauges live here. It runs its own stats store (statsd push
per USE_STATSD) and its own debug listener on DEBUG_PORT with /metrics,
/stats, /debug/profile (TPU_PROFILE_DIR), /debug/hotkeys, /debug/victim and
/healthcheck. Give it a DEBUG_PORT apart from any same-host frontend's.

Warm-standby redundancy (--role / REPL_ROLE with SIDECAR_ADDRS;
persist/replication.py): a SECOND owner with --role standby (or auto),
pointed at the same SIDECAR_ADDRS list, subscribes to the primary, mirrors
the slab through streamed dirty-row deltas, and promotes itself (epoch bump,
boot-style reconcile, upload) the moment a failed-over frontend writes to
it. `--role auto` is the restart-friendly choice: a restarted old primary
finds the promoted standby serving and rejoins as ITS standby. A standby
takes no snapshot until it promotes, and never a drain snapshot unpromoted.

The partitioned cluster (PARTITIONS>1, PARTITION_ADDRS; cluster/): this
owner serves one keyspace partition (--partition, or the PARTITION_ADDRS
group listing its SIDECAR_SOCKET), fences every SUBMIT against its map,
serves the map and reshard admin ops, stamps its slice into its snapshot
headers and serves GET /debug/cluster. A replicated or partitioned owner
takes the socket RPC only: shm frames carry no epoch or map stamp, so the
rings stay off.

Quota federation (FED_ENABLED, FED_SELF, FED_PEERS naming every cluster's
owner address; cluster/federation.py): the owner hosts its cluster's share
ledger. Peers dial this listener's OP_FED_EXCHANGE for grants and
settlements and its pump dials theirs; the ledger rides the snapshot set as
fed.snap, the fed.degraded probe joins /healthcheck and GET
/debug/federation serves the ledger's view.

The fault injector (FAULT_INJECT, FAULT_INJECT_SEED; testing/faults.py) is
always built, empty by default, and reaches the engine's sites, the wire's,
the snapshotter's, replication's and federation's. The wire's
OP_FAULTS_SET and the debug port's POST /debug/faults replace its rules on
the live owner; /debug/clock skews the owner's clock.
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import sys
import threading

from ..backends.cuda import SlabDeviceEngine, SlabHealthStats
from ..backends.lease import LeaseRegistryStats
from ..backends.overload import AdmissionController
from ..backends.sidecar import SlabSidecarServer
from ..runner import setup_logging
from ..server.health import HealthChecker
from ..server.http_server import add_chaos_admin, new_debug_server, warm_device_profiler
from ..settings import new_settings
from ..stats.sinks import NullSink, StatsdSink
from ..stats.store import Store
from ..tracing import journeys as journeys_mod
from ..tracing import set_global_tracer, tracer_from_env
from ..utils import provenance
from ..utils.timeutil import process_time_source

logger = logging.getLogger("ratelimit.sidecar.main")


class OwnerStats:
    """StatGenerator of the owner's own counts on every flush and scrape:

        <scope>.launches.<kernel>  kernel launches through the wrappers
                                   (ops/slab_kernels.py LAUNCHES; the way
                                   scan also per form and instantiation,
                                   way_scan.<form> / way_scan_multi.<form>)
        <scope>.shm.rings          frontend rings attached to the dispatch
                                   loop
        <scope>.shm.items_in       items those rings published
        <scope>.shm.items_out      items the loop took from them
        <scope>.merge.count        reshard merges (merge_rows) this owner
                                   ran, their summed and largest state-lock
        <scope>.merge.total_us     hold in microseconds: launches wait that
        <scope>.merge.max_us       long

    The counts are the process's: a fleet reads which kernels its owner ran,
    whether the rings carried the frames and what a reshard cost it."""

    def __init__(self, engine, scope):
        self._engine = engine
        self._scope = scope

    def generate_stats(self) -> None:
        from ..ops import slab_kernels as K

        launches = self._scope.scope("launches")
        for name, count in K.LAUNCHES.items():
            launches.gauge(name).set(count)
        for form, count in K.WAY_SCAN_FORMS.items():
            launches.gauge(f"way_scan.{form}").set(count)
        for form, count in K.WAY_SCAN_MULTI_FORMS.items():
            launches.gauge(f"way_scan_multi.{form}").set(count)
        loop = self._engine.dispatch_loop
        rings = [r for r in (loop._ext_rings if loop is not None else ()) if not r.dead]
        shm = self._scope.scope("shm")
        items_in = items_out = 0
        for ring in rings:
            try:
                items_in += ring.items_in
                items_out += ring.items_out
            except (TypeError, ValueError):  # released while we read
                continue
        shm.gauge("rings").set(len(rings))
        shm.gauge("items_in").set(items_in)
        shm.gauge("items_out").set(items_out)
        merges = list(self._engine.merge_times)
        merge = self._scope.scope("merge")
        merge.gauge("count").set(len(merges))
        merge.gauge("total_us").set(round(sum(merges) * 1e3))
        merge.gauge("max_us").set(round(max(merges, default=0.0) * 1e3))


def build_engine(
    settings, scope, overload=None, partition: int = -1, fault_injector=None
) -> SlabDeviceEngine:
    """The owner's engine on the card from the TPU_* knobs: block mode, the
    sketch, the victim tier, precompiled before the first frontend
    connects; partition labels its dispatch loop's telemetry, and
    fault_injector reaches its dispatch loop's and victim tier's sites."""
    hk_enabled, hk_k, hk_lanes = settings.hotkey_config()
    v_enabled, v_max_rows, v_watermark = settings.victim_config()
    kwargs = {}
    if settings.buckets():
        kwargs["buckets"] = settings.buckets()
    return SlabDeviceEngine(
        time_source=process_time_source(),
        n_slots=settings.tpu_slab_slots,
        ways=settings.slab_ways_count(),
        device="cuda",
        batch_window_seconds=settings.tpu_batch_window,
        max_batch=settings.tpu_batch_limit,
        dispatch_loop=settings.dispatch_loop,
        max_queue=settings.overload_max_queue,
        overload=overload,
        fault_injector=fault_injector,
        scope=scope,
        watermark_high=settings.slab_watermark(),
        gcra_burst_ratio=settings.gcra_burst(),
        # frontends ship packed uint32[6, n] wire blocks: the block verb
        # keeps per-item Python objects off the aggregation path
        block_mode=True,
        # no frontend RPC may ride a first-touch kernel build
        precompile=settings.tpu_precompile,
        hotkey_lanes=hk_lanes if hk_enabled else 0,
        hotkey_k=hk_k,
        victim_max_rows=v_max_rows if v_enabled else 0,
        victim_watermark=v_watermark,
        partition=partition,
        **kwargs,
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="the device-owner process on the card")
    parser.add_argument(
        "--role",
        choices=("primary", "standby", "auto"),
        default=None,
        help="warm-standby replication role (overrides REPL_ROLE; standby "
        "and auto need SIDECAR_ADDRS to name the peer)",
    )
    parser.add_argument(
        "--partition",
        type=int,
        default=None,
        help="which cluster partition this owner serves (PARTITIONS>1); "
        "defaults to the PARTITION_ADDRS group listing SIDECAR_SOCKET",
    )
    args = parser.parse_args(argv)
    settings = new_settings()
    if args.role is not None:
        settings.repl_role = args.role
    setup_logging(settings)
    if settings.backend_type not in ("cuda", "cuda-sidecar"):
        raise SystemExit(
            f"sidecar_cmd owns the card: BACKEND_TYPE must be cuda or "
            f"cuda-sidecar, got {settings.backend_type!r}"
        )
    sink = (
        StatsdSink(settings.statsd_host, settings.statsd_port)
        if settings.use_statsd
        else NullSink()
    )
    store = Store(sink, latency_buckets=settings.latency_buckets())
    scope = store.scope("ratelimit")

    # the tracer and journey recorder: the dispatch loop's batch spans
    # parent into frontend traces arriving over the wire (the B3 trailer)
    tracer = tracer_from_env(environ=settings.environ)
    set_global_tracer(tracer)
    jr_enabled, jr_slow_ms, jr_retain, jr_ring = settings.journey_config()
    if jr_enabled:
        journeys_mod.set_global_recorder(
            journeys_mod.JourneyRecorder(
                slow_ms=jr_slow_ms, retain=jr_retain, ring=jr_ring,
                scope=scope.scope("journeys"),
            )
        )

    # the native host codec: the owner's pack and scatter must not ride
    # the Python path unseen
    from ..ops import native

    native_info = native.build_info()
    scope.scope("native").gauge("available").set(1 if native_info["available"] else 0)
    if native_info["available"]:
        logger.info("native host codec loaded: %s", native_info["so_path"])
    else:
        logger.warning(
            "native host codec UNAVAILABLE (so=%s, source_present=%s): "
            "pack/scatter run on the Python path",
            native_info["so_path"], native_info["source_present"],
        )

    # the fault injector (FAULT_INJECT): a junk spec fails the boot here.
    # Always built (empty, a lock-free no-op) so OP_FAULTS_SET and POST
    # /debug/faults can arm faults on the live owner
    from ..testing.faults import FaultInjector

    fault_rules = settings.fault_rules()
    fault_injector = FaultInjector(fault_rules, seed=settings.fault_inject_seed)
    if fault_rules:
        logger.warning("FAULT_INJECT active (%d rule(s)): chaos mode", len(fault_rules))
    # one clock authority for the owner: engine windows, lease expiry, fed
    # share TTLs, repl lag and snapshot staleness all read it, so
    # OP_CLOCK_SET and POST /debug/clock skew them together
    time_source = process_time_source()

    # admission control for the shared dispatch loop: a shed surfaces to
    # frontends as an error reply, which their FAILURE_MODE_DENY answers
    overload = AdmissionController(
        shed_mode=settings.shed_mode(),
        max_queue=settings.overload_max_queue,
        brownout_target_ms=settings.overload_brownout_target_ms,
        brownout_exit_ms=settings.overload_brownout_exit_ms,
        ewma_alpha=settings.overload_ewma_alpha,
        scope=scope,
    )
    # the partitioned cluster's membership (PARTITIONS>1): this owner
    # serves ONE partition of the boot map. PARTITIONS=1 builds none of it
    cluster_k, cluster_groups, cluster_route_sets, _mb_s = settings.cluster_config()
    partition_index = None
    if cluster_k > 1:
        partition_index = (
            args.partition
            if args.partition is not None
            else settings.cluster_partition_of(settings.sidecar_socket)
        )
        if partition_index is None:
            raise SystemExit(
                f"PARTITIONS={cluster_k} but neither --partition was "
                f"given nor does any PARTITION_ADDRS group list this "
                f"process's SIDECAR_SOCKET ({settings.sidecar_socket!r})"
            )
    repl_role, repl_interval_ms, repl_max_lag_ms = settings.repl_config()
    settings.warn_deprecated_knobs(logger)
    try:
        engine = build_engine(
            settings, scope, overload,
            partition=-1 if partition_index is None else partition_index,
            fault_injector=fault_injector,
        )
    except (RuntimeError, ValueError) as e:
        logger.error("device owner cannot hold the card: %s", e)
        return 1

    import torch

    # the owner is the fleet member whose build gauges name the card; the
    # fleet merge takes the max, so they win over the frontends' cpu/0
    provenance.register_build_gauges(
        scope, platform="gpu", device_count=torch.cuda.device_count()
    )
    store.add_stat_generator(SlabHealthStats(engine, scope.scope("slab")))
    if engine.hotkeys_enabled:
        from ..backends.cuda import HotkeyStats

        # the stats cadence is the sketch's drain cadence
        store.add_stat_generator(HotkeyStats(engine, scope.scope("hotkeys")))
    if engine.victim_enabled:
        from ..backends.cuda import VictimStats

        store.add_stat_generator(VictimStats(engine, scope.scope("victim")))
    # the lease liability frontends ship in their FLAG_LEASE trailers
    store.add_stat_generator(LeaseRegistryStats(engine.lease_registry, scope.scope("lease")))
    store.add_stat_generator(OwnerStats(engine, scope.scope("owner")))

    cluster_node = None
    if partition_index is not None:
        from ..cluster.node import ClusterNode
        from ..cluster.partition_map import PartitionMap

        cluster_node = ClusterNode(
            partition_index,
            PartitionMap.even_map(cluster_groups, route_sets=cluster_route_sets),
            scope=scope,
        )
        logger.warning(
            "cluster partition %d of %d (route sets %d)",
            partition_index, cluster_k, cluster_route_sets,
        )

    # warm-standby replication, built before the snapshotter: a standby
    # defers its restore (the replicated stream supersedes any local
    # snapshot, and snapshotting an unpromoted standby's empty slab would
    # clobber good files) and starts snapshotting only at promotion
    repl = None
    on_promote_hooks: list = []
    if repl_role:
        from ..persist.replication import ReplicationCoordinator

        repl = ReplicationCoordinator(
            engine,
            repl_role,
            peer_address=settings.repl_peer_address(),
            interval_ms=repl_interval_ms,
            max_lag_ms=repl_max_lag_ms,
            scope=scope.scope("repl"),
            fault_injector=fault_injector,
            time_source=time_source,
            on_promote=lambda: [hook() for hook in on_promote_hooks],
        )

    # quota federation (FED_ENABLED; cluster/federation.py): the owner hosts
    # its cluster's share ledger; peers dial this listener's
    # OP_FED_EXCHANGE and its pump dials theirs. Built before the
    # snapshotter so the ledger rides fed.snap. FED_ENABLED=false builds
    # none of it: the owner's wire is the pre-federation one
    fed = None
    fed_on, fed_self, fed_peers, fed_min, fed_max, fed_interval, fed_lag, fed_ttl = (
        settings.fed_config()
    )
    if fed_on:
        from ..cluster.federation import FederationCoordinator

        fed = FederationCoordinator(
            fed_self,
            fed_peers,
            time_source=time_source,
            share_min=fed_min,
            share_max=fed_max,
            settle_interval_ms=fed_interval,
            max_lag_ms=fed_lag,
            share_ttl_ms=fed_ttl,
            scope=scope,
            fault_injector=fault_injector,
        )
        logger.warning(
            "federation cluster %r joining %s (settle interval %.0fms, share ttl %.0fms)",
            fed_self, sorted(fed_peers), fed_interval, fed_ttl,
        )

    snapshotter = None
    snap_dir, snap_interval_ms, snap_stale_ms = settings.snapshot_config()
    if snap_dir:
        from ..persist.snapshotter import SlabSnapshotter

        snap_partition = None
        if cluster_node is not None:
            own = cluster_node.pmap.partitions[partition_index]
            snap_partition = (partition_index, own.lo, own.hi, cluster_route_sets)
        snapshotter = SlabSnapshotter(
            engine,
            snap_dir,
            interval_ms=snap_interval_ms,
            stale_after_ms=snap_stale_ms,
            time_source=time_source,
            scope=scope,
            fault_injector=fault_injector,
            # this owner's keyspace slice, in every shard header
            partition=snap_partition,
            # the share ledger rides the set as fed.snap
            fed=fed,
        )
        if repl is None or not repl.is_standby:
            # restore the slab before the first frontend connects
            snapshotter.restore()
            snapshotter.start()
        # a standby or auto owner waits until its role resolves (below)

    health = HealthChecker(name="ratelimit-sidecar")
    health.add_degraded_probe(overload.degraded_reason)
    health.add_degraded_probe(engine.watermark_reason)
    if repl is not None:
        # no standby subscribed, or the stream lagging: degraded only
        health.add_degraded_probe(repl.degraded_reason)
    if snapshotter is not None:
        health.add_degraded_probe(snapshotter.stale_reason)
    if fed is not None:
        # settlement lag past FED_MAX_LAG_MS: degraded only, the cluster
        # keeps serving its granted slice
        health.add_degraded_probe(fed.degraded_reason)
    if engine.victim_enabled:
        health.add_degraded_probe(engine.victim_watermark_reason)

    debug = new_debug_server(
        store,
        "",
        settings.debug_port,
        enable_metrics=settings.debug_metrics_enabled,
        profile_dir=settings.tpu_profile_dir,
    )
    # /debug/profile starts its sessions with no launch in flight (C10); the
    # tracer's start-up stall falls here, before the owner serves
    debug.profile_quiesce = engine.launches_quiesced
    if settings.tpu_profile_dir:
        warm_device_profiler(debug)

    def healthcheck(_path: str):
        status, body = health.http_response()
        return status, body.encode(), "text/plain"

    debug.add_route("/healthcheck", healthcheck)
    # the wire's OP_FAULTS_SET and OP_CLOCK_SET on the debug port
    add_chaos_admin(debug, fault_injector, time_source)
    if engine.hotkeys_enabled:
        # fingerprints only: the frontends hold the key witnesses
        debug.add_debug_endpoint(
            "/debug/hotkeys", lambda: json.dumps(engine.hotkeys_snapshot(), indent=2)
        )
    if engine.victim_enabled:
        debug.add_debug_endpoint(
            "/debug/victim", lambda: json.dumps(engine.victim_debug(), indent=2)
        )
    if cluster_node is not None:
        debug.add_debug_endpoint(
            "/debug/cluster", lambda: json.dumps(cluster_node.describe(), indent=2)
        )
    if fed is not None:
        # the ledger's view: peer links, outstanding shares, settlement
        # lag, grants, settles and reclaims
        debug.add_debug_endpoint("/debug/federation", lambda: json.dumps(fed.describe(), indent=2))
    debug.serve_background()
    store.start_flushing()
    # shm frames carry no epoch or map stamp: they would bypass the
    # promote-on-write, the epoch fence and the map fence, which live in
    # the wire handler, so a replicated or partitioned owner takes the
    # socket RPC only
    shm_control = settings.shm_control_path()
    if shm_control and repl is not None:
        logger.warning(
            "SHM_RINGS disabled: REPL_ROLE is set and shm frames would "
            "bypass the epoch fence (socket RPC only on this owner)"
        )
        shm_control = ""
    if shm_control and cluster_node is not None:
        logger.warning(
            "SHM_RINGS disabled: PARTITIONS>1 and shm frames would "
            "bypass the partition-map fence (socket RPC only)"
        )
        shm_control = ""
    server = SlabSidecarServer(
        settings.sidecar_socket,
        engine,
        socket_mode=settings.sidecar_socket_mode,
        tls_cert=settings.sidecar_tls_cert,
        tls_key=settings.sidecar_tls_key,
        tls_ca=settings.sidecar_tls_ca,
        fault_injector=fault_injector,
        shm_control_path=shm_control,
        time_source=time_source,
        repl=repl,
        cluster=cluster_node,
        fed=fed,
    )
    if fed is not None:
        # the pump starts once this listener is up: clusters booting
        # together must find each other
        fed.start()
    if repl is not None:
        # resolve the auto role and start the standby's subscription only
        # once this listener is up (an auto pair booting together must
        # find each other)
        was_standby_at_boot = repl.is_standby
        repl.start()
        logger.warning(
            "replication role %s (epoch %d, interval %.0fms)",
            repl.role, repl.epoch, repl_interval_ms,
        )
        if snapshotter is not None and was_standby_at_boot:
            if repl.is_standby:
                # promotion makes the standby the durability owner: its
                # periodic snapshots start then, with no restore (the
                # replica it uploads is newer than any local file)
                on_promote_hooks.append(snapshotter.start)
            else:
                # auto resolved to primary (peer dark): a normal warm boot
                snapshotter.restore()
                snapshotter.start()
    logger.warning(
        "device owner on %s (%s, %d slots, debug port %d, shm %s, role %s, partition %s)",
        settings.sidecar_socket,
        torch.cuda.get_device_name(engine.device),
        settings.tpu_slab_slots,
        debug.port,
        "on" if server.shm_control is not None else "off",
        repl.role if repl is not None else "-",
        partition_index if partition_index is not None else "-",
    )

    stop = threading.Event()

    def on_signal(signum, frame):
        logger.warning("got signal %s, shutting down the device owner", signum)
        stop.set()

    for sig in (signal.SIGINT, signal.SIGTERM, signal.SIGHUP):
        signal.signal(sig, on_signal)
    stop.wait()
    # the listener and the shm control socket close first (frontends see
    # the owner go), then the engine, whose dispatch loop finishes every
    # frame already published
    server.close()
    if fed is not None:
        # stop the settle pump before the drain snapshot, so fed.snap
        # captures a quiescent ledger
        fed.close()
    if repl is not None:
        repl.close()
    if snapshotter is not None and (repl is None or not repl.is_standby):
        # the drain snapshot: the next process restores a slab holding
        # every admitted decision (a never-promoted standby never started
        # the cycle and must not overwrite the primary's files)
        snapshotter.drain()
    store.stop_flushing()
    debug.shutdown()
    tracer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
