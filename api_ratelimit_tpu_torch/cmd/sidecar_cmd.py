"""Port of api_ratelimit_tpu/cmd/sidecar_cmd.py: the device-owner process.

    BACKEND_TYPE=cuda python -m api_ratelimit_tpu_torch.cmd.sidecar_cmd

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

Replication, the partitioned cluster and federation (ROADMAP item 9) and the
fault injector (item 11b) are refused by settings.py check_ported; the
server answers their wire ops as a JAX owner without them does.
"""

from __future__ import annotations

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
from ..server.http_server import new_debug_server
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

    The counts are the process's: a fleet reads which kernels its owner ran
    and whether the rings carried the frames."""

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


def build_engine(settings, scope, overload=None) -> SlabDeviceEngine:
    """The owner's engine on the card from the TPU_* knobs: block mode, the
    sketch, the victim tier, precompiled before the first frontend
    connects."""
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
        **kwargs,
    )


def main(argv=None) -> int:
    settings = new_settings()
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
    settings.warn_deprecated_knobs(logger)
    try:
        engine = build_engine(settings, scope, overload)
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

    snapshotter = None
    snap_dir, snap_interval_ms, snap_stale_ms = settings.snapshot_config()
    if snap_dir:
        from ..persist.snapshotter import SlabSnapshotter

        snapshotter = SlabSnapshotter(
            engine,
            snap_dir,
            interval_ms=snap_interval_ms,
            stale_after_ms=snap_stale_ms,
            time_source=process_time_source(),
            scope=scope,
        )
        # restore the slab before the first frontend connects
        snapshotter.restore()
        snapshotter.start()

    health = HealthChecker(name="ratelimit-sidecar")
    health.add_degraded_probe(overload.degraded_reason)
    health.add_degraded_probe(engine.watermark_reason)
    if snapshotter is not None:
        health.add_degraded_probe(snapshotter.stale_reason)
    if engine.victim_enabled:
        health.add_degraded_probe(engine.victim_watermark_reason)

    debug = new_debug_server(
        store,
        "",
        settings.debug_port,
        enable_metrics=settings.debug_metrics_enabled,
        profile_dir=settings.tpu_profile_dir,
    )

    def healthcheck(_path: str):
        status, body = health.http_response()
        return status, body.encode(), "text/plain"

    debug.add_route("/healthcheck", healthcheck)
    if engine.hotkeys_enabled:
        # fingerprints only: the frontends hold the key witnesses
        debug.add_debug_endpoint(
            "/debug/hotkeys", lambda: json.dumps(engine.hotkeys_snapshot(), indent=2)
        )
    if engine.victim_enabled:
        debug.add_debug_endpoint(
            "/debug/victim", lambda: json.dumps(engine.victim_debug(), indent=2)
        )
    debug.serve_background()
    store.start_flushing()
    server = SlabSidecarServer(
        settings.sidecar_socket,
        engine,
        socket_mode=settings.sidecar_socket_mode,
        tls_cert=settings.sidecar_tls_cert,
        tls_key=settings.sidecar_tls_key,
        tls_ca=settings.sidecar_tls_ca,
        shm_control_path=settings.shm_control_path(),
        time_source=process_time_source(),
    )
    logger.warning(
        "device owner on %s (%s, %d slots, debug port %d, shm %s)",
        settings.sidecar_socket,
        torch.cuda.get_device_name(engine.device),
        settings.tpu_slab_slots,
        debug.port,
        "on" if server.shm_control is not None else "off",
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
    if snapshotter is not None:
        # the drain snapshot: the next process restores a slab holding
        # every admitted decision
        snapshotter.drain()
    store.stop_flushing()
    debug.shutdown()
    tracer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
