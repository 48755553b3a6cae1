"""Port of api_ratelimit_tpu/runner.py: the composition root, the Python twin
of src/service_cmd/runner/runner.go.

Run(): parse settings, refuse what this package does not serve
(settings.py check_ported), configure logging, build the process clock, the
SIGUSR2 stack and journey dump, the tracer (K_TRACING_*) and the journey
recorder (JOURNEY_*), the local over-limit cache, the stats store and its
sink, the transport server (with /metrics, the debug suite and
/debug/profile), the fault injector (FAULT_INJECT, always built, empty by
default; /debug/faults and /debug/clock arm faults and skew the clock on
the live process), the admission controller with its shed posture, quota
federation (FED_ENABLED with BACKEND_TYPE=cuda: the share ledger, its pump,
the fed.degraded probe and /debug/federation), the backend selected by
BACKEND_TYPE (cuda: the H100 engine, backends/cuda.py;
cuda-sidecar: a frontend of a device-owner process, backends/sidecar.py,
or with PARTITIONS>1 the partition router over K owners, cluster/router.py;
memory, redis and memcache: the host backends), the native host codec's
prewarm and its ratelimit.native.available gauge, the ratelimit.build.*
provenance gauges, the slab and sketch stat generators, the victim tier
(VICTIM_TIER_ENABLED: ratelimit.victim.*, GET /debug/victim and its
watermark probe), quota leasing (LEASE_ENABLED: the lease table, its
lease.degraded probe and ratelimit.lease.*), the warm-restart
snapshotter (SLAB_SNAPSHOT_DIR: restore before serving, a periodic
snapshot, the staleness probe, and a final snapshot at teardown; with
federation the fed.snap section), the runtime loader, the failure-mode
ladder (FAILURE_MODE_DENY, with the lease and federation-share rungs) and
the service; register v3 + v2 gRPC and /json (runner.go:115-121), hang
/rlconfig and /debug/hotkeys on the debug port (runner.go:108-113), and
serve.

The device is a constructor argument and nothing else: Runner(settings,
device="cuda") is what service_cmd builds, and no setting or environment
variable moves a deployment onto the CPU. Tests pass device="cpu", which
runs the kernels' plain versions. A cuda-sidecar frontend holds no card:
it reports platform cpu and 0 devices, and only the device owner
(cmd/sidecar_cmd.py) reports the card. Its failover to a standby owner
shows as the failover_reason degraded probe, and a partitioned frontend
serves GET /debug/cluster. A cuda-sidecar frontend builds no federation
coordinator: its device owner holds the share ledger, as it holds the slab.
"""

from __future__ import annotations

import faulthandler
import json
import logging
import random
import signal
import sys
import threading

from .backends.memory import MemoryRateLimitCache
from .backends.overload import AdmissionController
from .config.loader import load_config
from .limiter.base_limiter import BaseRateLimiter
from .limiter.cache import RateLimitCache
from .limiter.local_cache import LocalCache, LocalCacheStats
from .server.http_server import warm_device_profiler
from .server.runtime_loader import DirectoryRuntimeLoader
from .server.server import Server, new_server
from .service.ratelimit import RateLimitService
from .settings import Settings, new_settings
from .stats.sinks import NullSink, StatsdSink
from .stats.store import Store
from .tracing import global_tracer, reset_global_tracer, set_global_tracer, tracer_from_env
from .tracing import journeys as journeys_mod
from .utils import provenance
from .utils.timeutil import process_time_source

logger = logging.getLogger("ratelimit.runner")

_LOG_LEVELS = {
    "TRACE": logging.DEBUG,
    "DEBUG": logging.DEBUG,
    "INFO": logging.INFO,
    "WARN": logging.WARNING,
    "WARNING": logging.WARNING,
    "ERROR": logging.ERROR,
    "FATAL": logging.CRITICAL,
}


class _JsonFormatter(logging.Formatter):
    """LOG_FORMAT=json with the reference's field remaps: @timestamp/@message
    (runner.go:75-83) so existing log collectors keep working."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "@timestamp": self.formatTime(record, "%Y-%m-%dT%H:%M:%S%z"),
            "@message": record.getMessage(),
            "level": record.levelname.lower(),
            "logger": record.name,
        }
        if record.exc_info:
            out["exception"] = self.formatException(record.exc_info)
        return json.dumps(out)


def setup_logging(settings: Settings) -> None:
    level = _LOG_LEVELS.get(settings.log_level.upper())
    if level is None:
        raise ValueError(f"invalid log level: {settings.log_level}")
    handler = logging.StreamHandler(sys.stderr)
    if settings.log_format == "json":
        handler.setFormatter(_JsonFormatter())
    elif settings.log_format == "text":
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
    else:
        raise ValueError(f"invalid log format: {settings.log_format}")
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(level)


def create_limiter(
    settings: Settings,
    base: BaseRateLimiter,
    stats_store: Store,
    overload=None,
    device="cuda",
    lease_table=None,
    fault_injector=None,
) -> RateLimitCache:
    """BackendType switch (runner.go:43-64). The CUDA engine gets the
    `ratelimit` scope, so its per-stage histograms (batcher.queue_wait_ms,
    device.{pack,launch,readback}_ms) and the per-algorithm counters land
    in the store /stats reads; overload (the AdmissionController) wires
    the bounded queue and the brownout into its batcher or dispatch loop.
    device: where the engine runs ("cuda", or "cpu" for the plain
    versions); cuda-sidecar and the host backends ignore it, and the host
    backends lease_table too. fault_injector (FAULT_INJECT) reaches the
    engine's sites (the dispatch loop's and batcher's, the victim tier's)
    and the sidecar client's."""
    backend = settings.backend_type
    if backend == "cuda":
        from .backends.cuda import CudaRateLimitCache

        settings.warn_deprecated_knobs(logger)
        kwargs = {}
        ladder = settings.buckets()
        if ladder is not None:
            kwargs["buckets"] = ladder
        hk_enabled, hk_k, hk_lanes = settings.hotkey_config()
        v_enabled, v_max_rows, v_watermark = settings.victim_config()
        return CudaRateLimitCache(
            base,
            n_slots=settings.tpu_slab_slots,
            ways=settings.slab_ways_count(),
            device=device,
            hotkey_lanes=hk_lanes if hk_enabled else 0,
            hotkey_k=hk_k,
            batch_window_seconds=settings.tpu_batch_window,
            max_batch=settings.tpu_batch_limit,
            dispatch_loop=settings.dispatch_loop,
            max_queue=settings.overload_max_queue,
            overload=overload,
            stats_scope=stats_store.scope("ratelimit"),
            # every launch shape is warmed BEFORE the server reports
            # healthy: no request rides a first-touch kernel build
            precompile=settings.tpu_precompile,
            gcra_burst_ratio=settings.gcra_burst(),
            watermark_high=settings.slab_watermark(),
            victim_max_rows=v_max_rows if v_enabled else 0,
            victim_watermark=v_watermark,
            lease_table=lease_table,
            fault_injector=fault_injector,
            **kwargs,
        )
    if backend == "cuda-sidecar":
        k, _groups, _route_sets, _rate = settings.cluster_config()
        if k > 1:
            # PARTITIONS>1: the partition router, one failover client per
            # partition behind the same engine verbs. PARTITIONS=1 never
            # builds it: the plain client below ships the pre-cluster
            # frames byte for byte
            from .cluster.router import new_partitioned_cache_from_settings

            return new_partitioned_cache_from_settings(
                settings, base, stats_scope=stats_store.scope("ratelimit"),
                fault_injector=fault_injector, lease_table=lease_table,
            )
        from .backends.sidecar import new_sidecar_cache_from_settings

        return new_sidecar_cache_from_settings(
            settings, base, stats_scope=stats_store.scope("ratelimit"),
            fault_injector=fault_injector, lease_table=lease_table,
        )
    if backend == "memory":
        return MemoryRateLimitCache(base)
    if backend == "redis":
        from .backends.redis import new_redis_cache_from_settings

        return new_redis_cache_from_settings(settings, base, stats_store)
    if backend == "memcache":
        from .backends.memcache import new_memcache_cache_from_settings

        return new_memcache_cache_from_settings(settings, base)
    raise ValueError(f"invalid backend type: {backend!r}")


class Runner:
    def __init__(self, settings: Settings | None = None, sink=None, device="cuda"):
        """settings: new_settings() (the environment) when None. sink: the
        stats sink; StatsdSink when USE_STATSD, else NullSink, when None.
        device: where BACKEND_TYPE=cuda runs its engine, "cuda" (the card)
        unless a caller such as a test asks for "cpu"."""
        self.settings = settings if settings is not None else new_settings()
        if sink is None:
            sink = (
                StatsdSink(self.settings.statsd_host, self.settings.statsd_port)
                if self.settings.use_statsd
                else NullSink()
            )
        self.device = device
        self.stats_store = Store(sink, latency_buckets=self.settings.latency_buckets())
        self.scope = self.stats_store.scope("ratelimit")
        self.server: Server | None = None
        self.service: RateLimitService | None = None
        self.runtime: DirectoryRuntimeLoader | None = None
        self.cache: RateLimitCache | None = None
        self.overload: AdmissionController | None = None
        self.tracer = None
        self.journeys: journeys_mod.JourneyRecorder | None = None
        self.fallback = None
        self.snapshotter = None
        self.lease_table = None
        self.fault_injector = None
        self.federation = None
        self._ready = threading.Event()

    def _build(self) -> None:
        settings = self.settings
        setup_logging(settings)
        settings.check_ported()

        # One clock authority per process (utils/timeutil.py): every
        # time-semantic component below shares it.
        self.time_source = process_time_source()

        # Post-mortem: faulthandler dumps every thread's stack on a hard
        # fault, and SIGUSR2 dumps them on demand with the journey
        # recorder's retained tail. Signal handlers install from the main
        # thread only (a background boot skips it).
        try:
            faulthandler.enable()
        except (OSError, ValueError):
            # sys.stderr is not a file (a host that captures it): no fault
            # dumps, and serving goes on
            logger.warning("faulthandler not enabled: sys.stderr has no file descriptor")
        if hasattr(signal, "SIGUSR2") and threading.current_thread() is threading.main_thread():

            def on_sigusr2(signum, frame):
                faulthandler.dump_traceback(all_threads=True)
                recorder = journeys_mod.global_recorder()
                if recorder is not None:
                    sys.stderr.write(recorder.dump_json())
                    sys.stderr.flush()

            signal.signal(signal.SIGUSR2, on_sigusr2)

        # the tracer from K_TRACING_* in the mapping that built the
        # settings, registered globally so the gRPC
        # interceptor and the /json middleware pick it up (runner.go:90-95);
        # closed with a bounded flush at teardown (runner.go:91)
        self.tracer = tracer_from_env(environ=settings.environ)
        set_global_tracer(self.tracer)

        # the journey recorder: every request's stage itinerary,
        # tail-sampled by outcome into /debug/journeys and the SIGUSR2 dump;
        # global like the tracer so the service and every dispatch arm
        # find it
        jr_enabled, jr_slow_ms, jr_retain, jr_ring = settings.journey_config()
        if jr_enabled:
            self.journeys = journeys_mod.JourneyRecorder(
                slow_ms=jr_slow_ms,
                retain=jr_retain,
                ring=jr_ring,
                scope=self.scope.scope("journeys"),
            )
        journeys_mod.set_global_recorder(self.journeys)

        local_cache = None
        if settings.local_cache_size_in_bytes > 0:
            # freecache is sized in bytes; entries here are (key -> expiry)
            # pairs of ~100 bytes, so the byte knob maps onto an entry cap.
            local_cache = LocalCache(
                max_entries=max(1, settings.local_cache_size_in_bytes // 100),
                time_source=self.time_source,
            )
            self.stats_store.add_stat_generator(
                LocalCacheStats(local_cache, self.scope.scope("localcache"))
            )

        self.server = new_server(settings, self.stats_store)

        base = BaseRateLimiter(
            time_source=self.time_source,
            jitter_rand=random.Random(),
            expiration_jitter_max_seconds=settings.expiration_jitter_max_seconds,
            local_cache=local_cache,
            near_limit_ratio=settings.near_limit_ratio,
        )

        # prewarm the native host codec (ops/native.py) at boot, for every
        # backend: its first use builds it with g++, which must not land
        # inside a request. The outcome is logged and exported as
        # ratelimit.native.available, so the Python fallback never runs
        # unseen.
        from .ops import native

        info = native.build_info()
        self.scope.scope("native").gauge("available").set(1 if info["available"] else 0)
        if info["available"]:
            logger.info("native host codec loaded: %s", info["so_path"])
        else:
            logger.warning(
                "native host codec UNAVAILABLE (so=%s, source_present=%s): "
                "fingerprint/match/pack/scatter run on the Python path",
                info["so_path"], info["source_present"],
            )

        # the fault injector (FAULT_INJECT; testing/faults.py): a junk spec
        # fails the boot here. Always built (empty, it is a lock-free no-op
        # on the hot path) so /debug/faults can arm faults on the live
        # process, and /debug/clock skews the process clock
        from .server.http_server import add_chaos_admin
        from .testing.faults import FaultInjector

        fault_rules = settings.fault_rules()
        self.fault_injector = FaultInjector(fault_rules, seed=settings.fault_inject_seed)
        if fault_rules:
            logger.warning("FAULT_INJECT active (%d rule(s)): chaos mode", len(fault_rules))
        add_chaos_admin(self.server.debug, self.fault_injector, self.time_source)

        # Overload admission control (backends/overload.py): always built;
        # the default knobs (no queue bound, no brownout) leave it inert on
        # the hot path while keeping the overload.* stats defined.
        self.overload = AdmissionController(
            shed_mode=settings.shed_mode(),
            max_queue=settings.overload_max_queue,
            brownout_target_ms=settings.overload_brownout_target_ms,
            brownout_exit_ms=settings.overload_brownout_exit_ms,
            ewma_alpha=settings.overload_ewma_alpha,
            scope=self.scope,
        )
        self.server.health.add_degraded_probe(self.overload.degraded_reason)

        # quota leasing (LEASE_ENABLED; backends/lease.py): the lease table
        # answers hot-key decisions on the host from budget the card
        # granted. The card's engines lease (in process, or over the sidecar
        # wire's lease trailer), and only on the compiled-matcher path: the
        # host backends, and HOST_FAST_PATH=false, boot unleased, as in the
        # reference.
        self.lease_table = None
        lease_on, lease_min, lease_max, lease_ttl, lease_near = settings.lease_config()
        if lease_on and settings.backend_type in ("cuda", "cuda-sidecar"):
            if not settings.host_fast_path:
                logger.warning("LEASE_ENABLED requires HOST_FAST_PATH; leasing disabled")
            else:
                from .backends.lease import LeaseTable

                self.lease_table = LeaseTable(
                    base,
                    min_size=lease_min,
                    max_size=lease_max,
                    ttl_fraction=lease_ttl,
                    near_limit_ratio=lease_near,
                    scope=self.scope.scope("lease"),
                )
                self.server.health.add_degraded_probe(self.lease_table.degraded_reason)

        # quota federation (FED_ENABLED; cluster/federation.py): an engine
        # on the card in this process (BACKEND_TYPE=cuda) hosts the
        # cluster's share ledger, which peers exchange settlement frames
        # against; a cuda-sidecar frontend builds none (its device owner,
        # cmd/sidecar_cmd.py, holds the ledger as it holds the slab).
        # FED_ENABLED=false builds nothing: the rollback arm
        fed_on, fed_self, fed_peers, fed_min, fed_max, fed_interval, fed_lag, fed_ttl = (
            settings.fed_config()
        )
        if fed_on and settings.backend_type == "cuda":
            from .cluster.federation import FederationCoordinator

            federation = self.federation = FederationCoordinator(
                fed_self,
                fed_peers,
                time_source=self.time_source,
                share_min=fed_min,
                share_max=fed_max,
                settle_interval_ms=fed_interval,
                max_lag_ms=fed_lag,
                share_ttl_ms=fed_ttl,
                scope=self.scope,
                fault_injector=self.fault_injector,
            )
            federation.bind_base(base)
            self.server.health.add_degraded_probe(federation.degraded_reason)
            self.server.add_debug_endpoint(
                "/debug/federation", lambda: json.dumps(federation.describe(), indent=2)
            )

        cache = self.cache = create_limiter(
            settings, base, self.stats_store, self.overload, device=self.device,
            lease_table=self.lease_table, fault_injector=self.fault_injector,
        )
        engine = getattr(cache, "engine", None)
        # an engine that owns a slab: /debug/profile starts its sessions with
        # no launch in flight (C10), and the tracer's start-up stall falls
        # here, before serving (a frontend or host backend launches nothing)
        if hasattr(engine, "launches_quiesced"):
            self.server.debug.profile_quiesce = engine.launches_quiesced
            if settings.tpu_profile_dir:
                warm_device_profiler(self.server.debug)
        # ratelimit.build.*: the card's facts once the engine holds it; a
        # runner on the CPU, a host backend or a cuda-sidecar frontend (its
        # engine is the owner's client and has no device) reports cpu and 0
        # devices
        device = getattr(engine, "device", None)
        if device is not None and device.type == "cuda":
            import torch

            provenance.register_build_gauges(
                self.scope, platform="gpu", device_count=torch.cuda.device_count()
            )
        else:
            provenance.register_build_gauges(self.scope)
        # the slab's stat generators and probes attach to an engine that
        # owns the slab; a cuda-sidecar frontend's owner exports them
        if engine is not None and hasattr(engine, "health_snapshot"):
            from .backends.cuda import HotkeyStats, SlabHealthStats

            # ratelimit.slab.* on every stats flush
            self.stats_store.add_stat_generator(
                SlabHealthStats(engine, self.scope.scope("slab"))
            )
            # the outstanding leased budget: the crash-overshoot bound's
            # sum of budgets (backends/lease.py)
            if self.lease_table is not None:
                from .backends.lease import LeaseRegistryStats

                self.stats_store.add_stat_generator(
                    LeaseRegistryStats(engine.lease_registry, self.scope.scope("lease"))
                )
            # the HotkeyStats generator is the sketch's drain cadence:
            # ratelimit.hotkeys.* and the ranked top-K of /debug/hotkeys
            if engine.hotkeys_enabled:
                self.stats_store.add_stat_generator(
                    HotkeyStats(engine, self.scope.scope("hotkeys"))
                )
                self.server.add_debug_endpoint(
                    "/debug/hotkeys",
                    lambda: json.dumps(cache.hotkeys_debug(), indent=2),
                )
            # the VictimStats generator is the tier's reclamation cadence:
            # ratelimit.victim.* on every flush, the document on
            # /debug/victim
            if engine.victim_enabled:
                from .backends.cuda import VictimStats

                self.stats_store.add_stat_generator(
                    VictimStats(engine, self.scope.scope("victim"))
                )
            self.server.add_debug_endpoint(
                "/debug/victim",
                lambda: json.dumps(cache.victim_debug(), indent=2),
            )
            # slab pressure shows in the /healthcheck body beside the
            # overload reason, and the tier's own watermark beside it
            self.server.health.add_degraded_probe(engine.watermark_reason)
            self.server.health.add_degraded_probe(engine.victim_watermark_reason)
        # the device-owner failover probe (SIDECAR_ADDRS): while this
        # frontend serves from a standby the owner pair is one failure from
        # the ladder, which /healthcheck shows while it keeps serving. The
        # partition router aggregates its per-partition clients' probes
        if engine is not None and hasattr(engine, "failover_reason"):
            self.server.health.add_degraded_probe(engine.failover_reason)
        # the partitioned cluster's frontend view (PARTITIONS>1): the
        # adopted map epoch and each partition's range, active address and
        # breaker (each owner's own view is on its debug port)
        if engine is not None and hasattr(engine, "cluster_snapshot"):
            self.server.add_debug_endpoint(
                "/debug/cluster",
                lambda: json.dumps(engine.cluster_snapshot(), indent=2),
            )

        # Warm restart (persist/): restore the slab from the last snapshot
        # BEFORE serving (after precompile, so the first served launch
        # reads the restored table), then re-snapshot on a cadence off the
        # hot path; teardown takes a final copy so planned restarts lose
        # ~0 state. The settings are validated whether or not a directory
        # is set.
        snap_dir, snap_interval_ms, snap_stale_ms = settings.snapshot_config()
        if snap_dir and hasattr(engine, "export_tables"):
            from .persist.snapshotter import SlabSnapshotter

            self.snapshotter = SlabSnapshotter(
                engine,
                snap_dir,
                interval_ms=snap_interval_ms,
                stale_after_ms=snap_stale_ms,
                time_source=self.time_source,
                scope=self.scope,
                fault_injector=self.fault_injector,
                fed=self.federation,
            )
            self.snapshotter.restore()
            self.snapshotter.start()
            # staleness is degraded-only: durability at risk must not
            # drain an instance that is still serving fine from the card
            self.server.health.add_degraded_probe(self.snapshotter.stale_reason)

        self.runtime = DirectoryRuntimeLoader(
            runtime_path=settings.runtime_path,
            runtime_subdirectory=settings.runtime_subdirectory,
            ignore_dotfiles=settings.runtime_ignoredotfiles,
            poll_interval_seconds=settings.runtime_poll_interval,
            watcher=settings.runtime_watcher,
            safety_rescan_seconds=settings.runtime_safety_rescan,
        )
        # the failure-mode ladder (FAILURE_MODE_DENY): when a rung is named,
        # a CacheError from the engine becomes a policy answer (deny /
        # fail-open), counted, and /healthcheck names the degraded state
        # while staying 200; empty raises through
        failure_mode = settings.failure_mode()
        if failure_mode is not None:
            from .backends.fallback import FallbackLimiter

            # outstanding leases answer before the rung does: budget the
            # card granted outlives the card's failure (lease.py); federation
            # shares answer next: global budget this cluster already owns
            self.fallback = FallbackLimiter(
                failure_mode, scope=self.scope, lease_table=self.lease_table,
                fed_shares=self.federation,
            )
            self.server.health.set_degraded_probe(self.fallback.degraded_reason)

        # the config loader carries the validated concurrency idle TTL,
        # stamped into rules at load and on every hot reload
        service_scope = self.scope.scope("service")
        rl_scope = service_scope.scope("rate_limit")
        concurrency_ttl = settings.concurrency_ttl()
        self.service = RateLimitService(
            runtime=self.runtime,
            cache=cache,
            stats_scope=service_scope,
            time_source=self.time_source,
            runtime_watch_root=settings.runtime_watch_root,
            max_sleeping_routines=settings.max_sleeping_routines,
            config_loader=lambda files: load_config(
                files, rl_scope, concurrency_ttl_s=concurrency_ttl
            ),
            fallback=self.fallback,
            overload=self.overload,
            # drain-aware pacing: once health flips for shutdown, throttle
            # sleeps shed instead of pinning workers through the drain
            draining_probe=lambda: not self.server.health.ok(),
            host_fast_path=settings.host_fast_path,
            lease=self.lease_table,
        )

        def dump_config() -> str:
            config = self.service.get_current_config()
            return config.dump() if config is not None else ""

        self.server.add_debug_endpoint("/rlconfig", dump_config)
        self.server.register_service(self.service, service_scope)
        if self.federation is not None:
            self.federation.start()
        self.runtime.start_watching()
        self.stats_store.start_flushing()

    def run(self) -> None:
        """Build and serve; blocks until shutdown (Runner.Run, runner.go:66)."""
        self._build()
        self.server.install_signal_handlers()
        self._ready.set()
        try:
            self.server.start()
        finally:
            self._teardown()

    def run_background(self) -> None:
        """Build and serve on daemon threads (the in-process boot)."""
        self._build()
        self.server.start_background()
        self._ready.set()

    def wait_ready(self, timeout: float = 10.0) -> bool:
        return self._ready.wait(timeout)

    def stop(self) -> None:
        """Fail health, then close the listeners on the server's own thread
        (Server.stop), and stop the watcher and the federation pump, take
        the drain snapshot (with SLAB_SNAPSHOT_DIR), stop the stats flush
        and the tracer's exporter."""
        if self.server is not None:
            self.server.stop()
        self._teardown()

    def _teardown(self) -> None:
        if self.runtime is not None:
            self.runtime.stop()
        if self.federation is not None:
            # stop the settle pump before the drain snapshot, so the
            # fed.snap section captures a quiescent ledger
            federation, self.federation = self.federation, None
            federation.close()
        if self.snapshotter is not None:
            # drain handoff: quiesce the engine and take the final
            # snapshot — the state the next process warm-boots from
            snapshotter, self.snapshotter = self.snapshotter, None
            snapshotter.drain()
        self.stats_store.stop_flushing()
        # unregister only this runner's tracer and recorder: in-process
        # boots share the module globals, and a later Runner may own them
        if self.tracer is not None:
            self.tracer.close()
            if global_tracer() is self.tracer:
                reset_global_tracer()
        if self.journeys is not None:
            if journeys_mod.global_recorder() is self.journeys:
                journeys_mod.set_global_recorder(None)
            self.journeys = None
