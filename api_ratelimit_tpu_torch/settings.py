"""Port of api_ratelimit_tpu/settings.py: process settings.

One env-var struct with defaults, with the reference's variable names
(src/settings/settings.go:10-48) and the JAX package's whole table, parsed
exactly as the JAX package parses them: the same fields, the same parsers
and the same error text (a parse error raises at once, as
envconfig.MustProcess panics, settings.go:52-61). The validators of the
knobs this package reads are the JAX package's, word for word.

Three differences:

* BACKEND_TYPE defaults to `cuda`, the engine of this package
  (backends/cuda.py); `memory` is the host backend. `tpu` and `tpu-sidecar`
  are the JAX package's and raise an error naming `cuda`; `redis` and
  `memcache` are ROADMAP item 4c.
* A setting that turns on a feature this package has not ported is refused
  at boot (check_ported, which new_settings and the runner call) with a
  ValueError naming its ROADMAP item: a deployment must never believe it
  runs a mesh, a sidecar, snapshots or leases that are not there.

Observability and shedding are served as in the JAX package: GET /metrics
(DEBUG_METRICS_ENABLED), the journey recorder (JOURNEY_*), the tracer (its
K_TRACING_* variables, read from the mapping new_settings read by
tracing/tracer.py tracer_from_env), the /debug/profile device trace (TPU_PROFILE_DIR), the
failure-mode ladder (FAILURE_MODE_DENY deny or allow; empty, the default,
raises through; degraded is refused)
and the shed postures (OVERLOAD_SHED_MODE).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, ClassVar, Mapping


def _parse_bool(raw: str) -> bool:
    v = raw.strip().lower()
    if v in ("1", "t", "true", "yes", "on"):
        return True
    if v in ("0", "f", "false", "no", "off"):
        return False
    raise ValueError(f"invalid boolean: {raw!r}")


def _parse_duration_seconds(raw: str) -> float:
    """Go time.Duration strings ("75us", "100ms", "2s") or a bare number of
    seconds -> float seconds (REDIS_PIPELINE_WINDOW uses Go durations)."""
    raw = raw.strip()
    units = [("us", 1e-6), ("µs", 1e-6), ("ms", 1e-3), ("ns", 1e-9),
             ("s", 1.0), ("m", 60.0), ("h", 3600.0)]
    for suffix, scale in units:
        if raw.endswith(suffix):
            return float(raw[: -len(suffix)]) * scale
    return float(raw)


# the backends this package serves
BACKEND_TYPES = ("cuda", "memory")

# sidecar transport knobs (ROADMAP item 8): any value but the default is
# refused at boot
_SIDECAR_FIELDS = (
    ("sidecar_socket", "SIDECAR_SOCKET"),
    ("sidecar_socket_mode", "SIDECAR_SOCKET_MODE"),
    ("sidecar_tls_cert", "SIDECAR_TLS_CERT"),
    ("sidecar_tls_key", "SIDECAR_TLS_KEY"),
    ("sidecar_tls_ca", "SIDECAR_TLS_CA"),
    ("sidecar_tls_server_name", "SIDECAR_TLS_SERVER_NAME"),
    ("sidecar_addrs", "SIDECAR_ADDRS"),
    ("sidecar_connect_timeout", "SIDECAR_CONNECT_TIMEOUT"),
    ("sidecar_rpc_deadline", "SIDECAR_RPC_DEADLINE"),
    ("sidecar_retries", "SIDECAR_RETRIES"),
    ("sidecar_retry_backoff", "SIDECAR_RETRY_BACKOFF"),
    ("sidecar_retry_backoff_max", "SIDECAR_RETRY_BACKOFF_MAX"),
    ("sidecar_breaker_threshold", "SIDECAR_BREAKER_THRESHOLD"),
    ("sidecar_breaker_reset", "SIDECAR_BREAKER_RESET"),
)


def _unported(knob: str, feature: str, item: str) -> ValueError:
    return ValueError(
        f"{knob} turns on {feature}, which this package does not serve yet "
        f"(ROADMAP item {item})"
    )


@dataclasses.dataclass
class Settings:
    """Every field of the JAX package's Settings, with its default (but
    BACKEND_TYPE's). What this package serves, and how: see check_ported
    for the refused knobs."""

    # the mapping new_settings read (os.environ when None): the runner
    # builds its tracer from it (K_TRACING_*); not a field, so not part of
    # the JAX package's table
    environ: ClassVar[Mapping[str, str] | None] = None

    # server (settings.go:14-16)
    port: int = 8080
    grpc_port: int = 8081
    debug_port: int = 6070
    # statsd (settings.go:17-19); USE_STATSD picks StatsdSink or NullSink
    use_statsd: bool = True
    statsd_host: str = "localhost"
    statsd_port: int = 8125
    # GET /metrics on the debug port and the latency histogram ladder in ms
    # (comma-separated floats; empty = the default)
    debug_metrics_enabled: bool = True
    metrics_latency_buckets_ms: str = ""
    # runtime config dir (settings.go:20-23) and its watcher
    # (server/runtime_loader.py)
    runtime_path: str = "/srv/runtime_data/current"
    runtime_subdirectory: str = ""
    runtime_ignoredotfiles: bool = False
    runtime_watch_root: bool = True
    runtime_watcher: str = "auto"  # auto | inotify | poll
    runtime_poll_interval: float = 0.25  # seconds (poll mode)
    runtime_safety_rescan: float = 5.0  # seconds (inotify backstop rescan)
    # logging (settings.go:24-25)
    log_level: str = "WARN"
    log_format: str = "text"
    # the redis backend (settings.go:26-42; item 4c, read by no backend
    # this package has)
    redis_socket_type: str = "unix"
    redis_type: str = "SINGLE"
    redis_url: str = "/var/run/nutcracker/ratelimit.sock"
    redis_pool_size: int = 10
    redis_auth: str = ""
    redis_tls: bool = False
    redis_pipeline_window: float = 0.0
    redis_pipeline_limit: int = 0
    redis_per_second: bool = False
    redis_per_second_socket_type: str = "unix"
    redis_per_second_type: str = "SINGLE"
    redis_per_second_url: str = "/var/run/nutcracker/ratelimitpersecond.sock"
    redis_per_second_pool_size: int = 10
    redis_per_second_auth: str = ""
    redis_per_second_tls: bool = False
    redis_per_second_pipeline_window: float = 0.0
    redis_per_second_pipeline_limit: int = 0
    # limiter behavior (settings.go:43-45)
    expiration_jitter_max_seconds: int = 300
    local_cache_size_in_bytes: int = 0
    near_limit_ratio: float = 0.8
    # backends (settings.go:46-47; memcache is item 4c)
    memcache_host_port: str = ""
    backend_type: str = "cuda"  # reference defaults to "redis"; here: cuda
    max_sleeping_routines: int = 0  # src/service/ratelimit.go:337-341
    # --- the device engine (backends/cuda.py; TPU_* keep their names) ---
    tpu_slab_slots: int = 1 << 22
    # set associativity; 0 picks the device's (128 on the card), else a
    # power of two
    slab_ways: int = 0
    tpu_batch_window: float = 0.0  # seconds; 0 = direct mode
    tpu_batch_limit: int = 65536
    tpu_mesh_devices: int = 0  # > 1 is the multi-device engine (item 10)
    tpu_use_pallas: bool = True  # false: refused, no plain path on the card
    # warm every launch shape at boot, before health reports SERVING
    tpu_precompile: bool = True
    # the launch-shape bucket ladder (comma-separated ints; empty = the
    # engine's 128,1024,8192,65536)
    tpu_buckets: str = ""
    host_fast_path: bool = True  # compiled matcher -> row-block submit
    dispatch_loop: bool = True  # windowed mode: the device-owner loop
    tpu_profile_dir: str = ""  # /debug/profile's trace directory
    # --- the journey flight recorder (tracing/journeys.py) ---
    journey_recorder_enabled: bool = True
    journey_slow_ms: float = 0.0
    journey_retain: int = 256
    journey_ring: int = 64
    # --- the sidecar transport (item 8: any non-default is refused) ---
    sidecar_socket: str = "/tmp/api-ratelimit-tpu-sidecar.sock"
    sidecar_socket_mode: int = 0o600
    sidecar_tls_cert: str = ""
    sidecar_tls_key: str = ""
    sidecar_tls_ca: str = ""
    sidecar_tls_server_name: str = ""
    sidecar_addrs: str = ""
    # --- warm-standby replication (item 9) ---
    repl_role: str = ""
    repl_interval_ms: float = 100.0
    repl_max_lag_ms: float = 0.0
    # --- the failure-mode ladder (backends/fallback.py; empty raises
    # through) ---
    failure_mode_deny: str = ""
    sidecar_connect_timeout: float = 5.0
    sidecar_rpc_deadline: float = 30.0
    sidecar_retries: int = 2
    sidecar_retry_backoff: float = 0.01
    sidecar_retry_backoff_max: float = 0.25
    sidecar_breaker_threshold: int = 5
    sidecar_breaker_reset: float = 5.0
    # --- admission control (backends/overload.py) ---
    # the shed posture: unavailable (gRPC UNAVAILABLE), allow or deny
    overload_shed_mode: str = "unavailable"
    overload_max_queue: int = 0  # 0 = unbounded
    overload_brownout_target_ms: float = 0.0  # 0 disables the brownout
    overload_brownout_exit_ms: float = 0.0
    overload_ewma_alpha: float = 0.2
    # capture the gRPC client deadline and drop expired work before launch
    overload_deadline_propagation: bool = True
    # slab occupancy fraction past which the degraded health probe raises
    # (0 = off); the critical watermark is deprecated and ignored
    slab_watermark_high: float = 0.0
    slab_watermark_critical: float = 0.0
    # --- slab snapshots (item 7) ---
    slab_snapshot_dir: str = ""
    slab_snapshot_interval_ms: float = 10_000.0
    slab_snapshot_stale_after_ms: float = 0.0
    # --- quota leasing (item 8) ---
    lease_enabled: bool = False
    lease_min: int = 8
    lease_max: int = 1024
    lease_ttl_fraction: float = 0.25
    lease_near_limit_ratio: float = 0.9
    # --- shared-memory submit rings (item 8; read only with a sidecar) ---
    shm_rings: bool = True
    shm_control_sock: str = ""
    shm_ring_rows: int = 4096
    frontend_procs: int = 1  # > 1 is the frontend fleet (item 8)
    # --- the partitioned cluster (item 9) ---
    partitions: int = 1
    partition_addrs: str = ""
    partition_route_sets: int = 256
    reshard_rate_limit_mb_s: float = 32.0
    # --- rate-limit algorithms (config/loader.py, backends/cuda.py) ---
    concurrency_ttl_s: int = 60
    gcra_burst_ratio: float = 1.0
    # --- fault injection (item 11) ---
    fault_inject: str = ""
    fault_inject_seed: int = 0
    # --- the heavy-hitter sketch (ops/sketch.py, /debug/hotkeys) ---
    hotkeys_enabled: bool = True
    hotkey_k: int = 16
    hotkey_lanes: int = 128
    # --- the victim tier (item 6) ---
    victim_tier_enabled: bool = False
    victim_max_rows: int = 1 << 20
    victim_watermark: float = 0.85
    # --- sharded dispatch (item 10; read only by the multi-device engine)
    shard_routed_batching: bool = True
    hot_tier_enabled: bool = True
    hot_tier_salt_ways: int = 0
    # --- quota federation (item 9) ---
    fed_enabled: bool = False
    fed_self: str = ""
    fed_peers: str = ""
    fed_share_min: int = 8
    fed_share_max: int = 1024
    fed_settle_interval_ms: float = 50.0
    fed_max_lag_ms: float = 0.0
    fed_share_ttl_ms: float = 0.0

    def latency_buckets(self) -> tuple[float, ...] | None:
        """Parsed METRICS_LATENCY_BUCKETS_MS, or None for the default.
        Raises ValueError on junk — a typo'd bucket ladder must fail the
        boot, not silently fall back and skew every percentile."""
        raw = self.metrics_latency_buckets_ms.strip()
        if not raw:
            return None
        buckets = tuple(
            sorted(float(p) for p in raw.split(",") if p.strip())
        )
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError(
                f"METRICS_LATENCY_BUCKETS_MS must be positive floats, "
                f"got {raw!r}"
            )
        return buckets

    def buckets(self) -> tuple[int, ...] | None:
        """Parsed TPU_BUCKETS ladder, or None for the engine default.
        Junk (non-ints, non-positive, empty after parsing) fails the boot
        like a typo'd bucket ladder must."""
        raw = self.tpu_buckets.strip()
        if not raw:
            return None
        try:
            ladder = tuple(sorted(int(p) for p in raw.split(",") if p.strip()))
        except ValueError as e:
            raise ValueError(f"TPU_BUCKETS must be integers, got {raw!r}") from e
        if not ladder or any(b <= 0 for b in ladder):
            raise ValueError(
                f"TPU_BUCKETS must be positive integers, got {raw!r}"
            )
        return ladder

    def failure_mode(self) -> str | None:
        """Parsed FAILURE_MODE_DENY: None (empty — legacy raise-through),
        'deny', 'allow', or 'degraded'. Upstream boolean values keep their
        meaning (true = deny-all, false = fail-open); junk fails the boot
        like latency_buckets() does."""
        v = self.failure_mode_deny.strip().lower()
        if v == "":
            return None
        if v in ("1", "t", "true", "yes", "on", "deny"):
            return "deny"
        if v in ("0", "f", "false", "no", "off", "allow"):
            return "allow"
        if v == "degraded":
            return "degraded"
        raise ValueError(
            f"FAILURE_MODE_DENY must be a boolean, 'degraded', or empty, "
            f"got {self.failure_mode_deny!r}"
        )

    def shed_mode(self) -> str:
        """Validated OVERLOAD_SHED_MODE. Junk fails the boot like a typo'd
        bucket ladder — a misspelled shed posture must not silently become
        a different policy."""
        from .backends.overload import SHED_MODES

        v = self.overload_shed_mode.strip().lower()
        if v not in SHED_MODES:
            raise ValueError(
                f"OVERLOAD_SHED_MODE must be one of {', '.join(SHED_MODES)}, "
                f"got {self.overload_shed_mode!r}"
            )
        return v

    def slab_watermark(self) -> float:
        """Validated SLAB_WATERMARK_HIGH occupancy pressure watermark
        (0 = off; drives only the degraded health probe). Junk (out of
        [0, 1]) fails the boot. A set SLAB_WATERMARK_CRITICAL is
        DEPRECATED: it no longer gates anything (the set-associative slab
        evicts in-kernel instead of shedding) and is reported once at
        boot by warn_deprecated_knobs(), never a boot failure."""
        high = float(self.slab_watermark_high)
        if high < 0 or high > 1:
            raise ValueError(
                f"SLAB_WATERMARK_HIGH must be an occupancy fraction in "
                f"[0, 1], got {high}"
            )
        return high

    def slab_ways_count(self) -> int:
        """Validated SLAB_WAYS set associativity; 0 = auto (the engine
        picks the platform default — ops/slab.py default_ways). Junk
        (non-power-of-two, negative) fails the boot like every other
        knob — a typo'd associativity must not silently become a
        different table geometry."""
        ways = int(self.slab_ways)
        if ways == 0:
            return 0
        if ways < 0 or ways & (ways - 1):
            raise ValueError(
                f"SLAB_WAYS must be 0 (auto) or a positive power of two, "
                f"got {ways}"
            )
        return ways

    def warn_deprecated_knobs(self, log) -> None:
        """One-line deprecation warnings for knobs that are accepted but
        ignored, so old deployment configs keep booting (the runner calls
        this once at startup)."""
        if float(self.slab_watermark_critical) > 0:
            log.warning(
                "SLAB_WATERMARK_CRITICAL is deprecated and ignored: the "
                "set-associative slab evicts least-valuable ways in-kernel "
                "instead of shedding admission (see README, slab layout)"
            )

    def hotkey_config(self) -> tuple[bool, int, int]:
        """Validated (enabled, k, lanes) for the heavy-hitter sketch.
        Junk fails the boot like every other knob — a typo'd lane count
        must not silently become 'no hot-key telemetry'."""
        k = int(self.hotkey_k)
        lanes = int(self.hotkey_lanes)
        if k < 1:
            raise ValueError(f"HOTKEY_K must be >= 1, got {k}")
        if lanes < 1 or lanes & (lanes - 1):
            raise ValueError(
                f"HOTKEY_LANES must be a positive power of two, got {lanes}"
            )
        if k > lanes:
            raise ValueError(
                f"HOTKEY_K ({k}) must not exceed HOTKEY_LANES ({lanes})"
            )
        return bool(self.hotkeys_enabled), k, lanes

    def journey_config(self) -> tuple[bool, float, int, int]:
        """Validated (enabled, slow_ms, retain, ring) for the journey
        flight recorder. Junk fails the boot like every other knob — a
        typo'd buffer size must not silently become 'no tail capture'."""
        slow_ms = float(self.journey_slow_ms)
        retain = int(self.journey_retain)
        ring = int(self.journey_ring)
        if slow_ms < 0:
            raise ValueError(
                f"JOURNEY_SLOW_MS must be >= 0, got {slow_ms}"
            )
        if retain <= 0:
            raise ValueError(
                f"JOURNEY_RETAIN must be > 0, got {retain}"
            )
        if ring <= 0:
            raise ValueError(f"JOURNEY_RING must be > 0, got {ring}")
        return bool(self.journey_recorder_enabled), slow_ms, retain, ring

    def concurrency_ttl(self) -> int:
        """Validated CONCURRENCY_TTL_S idle TTL. Junk (<= 0, or past the
        divider word's 28-bit field) fails the boot like every other knob —
        a typo'd TTL must not silently become 'leak forever' or corrupt
        the algorithm bits of the wire divider."""
        ttl = int(self.concurrency_ttl_s)
        if ttl <= 0 or ttl >= (1 << 28):
            raise ValueError(
                f"CONCURRENCY_TTL_S must be in [1, 2^28), got {ttl}"
            )
        return ttl

    def gcra_burst(self) -> float:
        """Validated GCRA_BURST_RATIO. Junk (<= 0 or > 16) fails the
        boot — a zero ratio would deny everything and a huge one would
        never deny, neither silently."""
        ratio = float(self.gcra_burst_ratio)
        if not 0.0 < ratio <= 16.0:
            raise ValueError(
                f"GCRA_BURST_RATIO must be in (0, 16], got {ratio}"
            )
        return ratio

    def check_ported(self) -> None:
        """Refuse, with the ROADMAP item that ports it, every setting that
        turns on a feature this package lacks, and a backend it does not
        have. Called by new_settings and at boot (runner.py)."""
        backend = self.backend_type
        if backend in ("tpu", "tpu-sidecar"):
            raise ValueError(
                f"BACKEND_TYPE={backend!r} is the JAX package's TPU engine; "
                f"this package serves BACKEND_TYPE=cuda (the H100 engine) "
                f"or memory"
            )
        if backend in ("redis", "memcache"):
            raise _unported(
                f"BACKEND_TYPE={backend}", f"the {backend} host backend", "4c"
            )
        if backend not in BACKEND_TYPES:
            raise ValueError(f"invalid backend type: {backend!r}")
        if self.tpu_mesh_devices > 1:
            raise _unported(
                f"TPU_MESH_DEVICES={self.tpu_mesh_devices}",
                "the multi-device engine", "10",
            )
        if not self.tpu_use_pallas:
            raise ValueError(
                "TPU_USE_PALLAS=false asks for the plain versions of the "
                "kernels; this package has no plain path on the card (a "
                "CUDA tensor launches its kernel or raises)"
            )
        if self.failure_mode() == "degraded":
            raise ValueError(
                "FAILURE_MODE_DENY=degraded answers a failed launch from a "
                "process-local limiter on the CPU; this package moves no "
                "decision off the card (ROADMAP \"Deliberate departures\"): "
                "use deny, allow or empty"
            )
        if self.frontend_procs < 1:
            raise ValueError(
                f"FRONTEND_PROCS must be >= 1, got {self.frontend_procs}"
            )
        if self.frontend_procs > 1:
            raise _unported(
                f"FRONTEND_PROCS={self.frontend_procs}",
                "the multi-process frontend fleet", "8",
            )
        defaults = Settings()
        for field, var in _SIDECAR_FIELDS:
            if getattr(self, field) != getattr(defaults, field):
                raise _unported(var, "the sidecar transport", "8")
        if self.lease_enabled:
            raise _unported("LEASE_ENABLED=true", "quota leasing", "8")
        if self.slab_snapshot_dir.strip():
            raise _unported("SLAB_SNAPSHOT_DIR", "slab snapshots", "7")
        if self.victim_tier_enabled:
            raise _unported("VICTIM_TIER_ENABLED=true", "the victim tier", "6")
        if self.fed_enabled:
            raise _unported("FED_ENABLED=true", "quota federation", "9")
        if self.partitions != 1 or self.partition_addrs.strip():
            raise _unported(
                f"PARTITIONS={self.partitions}", "the partitioned cluster", "9"
            )
        if self.repl_role.strip():
            raise _unported(
                f"REPL_ROLE={self.repl_role}", "warm-standby replication", "9"
            )
        if self.fault_inject.strip():
            raise _unported("FAULT_INJECT", "fault injection", "11")


_FIELD_ENV: list[tuple[str, str, Callable]] = [
    ("port", "PORT", int),
    ("grpc_port", "GRPC_PORT", int),
    ("debug_port", "DEBUG_PORT", int),
    ("use_statsd", "USE_STATSD", _parse_bool),
    ("statsd_host", "STATSD_HOST", str),
    ("statsd_port", "STATSD_PORT", int),
    ("debug_metrics_enabled", "DEBUG_METRICS_ENABLED", _parse_bool),
    ("metrics_latency_buckets_ms", "METRICS_LATENCY_BUCKETS_MS", str),
    ("runtime_path", "RUNTIME_ROOT", str),
    ("runtime_subdirectory", "RUNTIME_SUBDIRECTORY", str),
    ("runtime_ignoredotfiles", "RUNTIME_IGNOREDOTFILES", _parse_bool),
    ("runtime_watch_root", "RUNTIME_WATCH_ROOT", _parse_bool),
    ("runtime_watcher", "RUNTIME_WATCHER", str),
    ("runtime_poll_interval", "RUNTIME_POLL_INTERVAL", float),
    ("runtime_safety_rescan", "RUNTIME_SAFETY_RESCAN", float),
    ("log_level", "LOG_LEVEL", str),
    ("log_format", "LOG_FORMAT", str),
    ("redis_socket_type", "REDIS_SOCKET_TYPE", str),
    ("redis_type", "REDIS_TYPE", str),
    ("redis_url", "REDIS_URL", str),
    ("redis_pool_size", "REDIS_POOL_SIZE", int),
    ("redis_auth", "REDIS_AUTH", str),
    ("redis_tls", "REDIS_TLS", _parse_bool),
    ("redis_pipeline_window", "REDIS_PIPELINE_WINDOW", _parse_duration_seconds),
    ("redis_pipeline_limit", "REDIS_PIPELINE_LIMIT", int),
    ("redis_per_second", "REDIS_PERSECOND", _parse_bool),
    ("redis_per_second_socket_type", "REDIS_PERSECOND_SOCKET_TYPE", str),
    ("redis_per_second_type", "REDIS_PERSECOND_TYPE", str),
    ("redis_per_second_url", "REDIS_PERSECOND_URL", str),
    ("redis_per_second_pool_size", "REDIS_PERSECOND_POOL_SIZE", int),
    ("redis_per_second_auth", "REDIS_PERSECOND_AUTH", str),
    ("redis_per_second_tls", "REDIS_PERSECOND_TLS", _parse_bool),
    (
        "redis_per_second_pipeline_window",
        "REDIS_PERSECOND_PIPELINE_WINDOW",
        _parse_duration_seconds,
    ),
    ("redis_per_second_pipeline_limit", "REDIS_PERSECOND_PIPELINE_LIMIT", int),
    (
        "expiration_jitter_max_seconds",
        "EXPIRATION_JITTER_MAX_SECONDS",
        int,
    ),
    ("local_cache_size_in_bytes", "LOCAL_CACHE_SIZE_IN_BYTES", int),
    ("near_limit_ratio", "NEAR_LIMIT_RATIO", float),
    ("memcache_host_port", "MEMCACHE_HOST_PORT", str),
    ("backend_type", "BACKEND_TYPE", str),
    ("max_sleeping_routines", "MAX_SLEEPING_ROUTINES", int),
    ("tpu_slab_slots", "TPU_SLAB_SLOTS", int),
    ("tpu_batch_window", "TPU_BATCH_WINDOW", _parse_duration_seconds),
    ("tpu_batch_limit", "TPU_BATCH_LIMIT", int),
    ("tpu_mesh_devices", "TPU_MESH_DEVICES", int),
    ("tpu_use_pallas", "TPU_USE_PALLAS", _parse_bool),
    ("tpu_precompile", "TPU_PRECOMPILE", _parse_bool),
    ("tpu_buckets", "TPU_BUCKETS", str),
    ("host_fast_path", "HOST_FAST_PATH", _parse_bool),
    ("dispatch_loop", "DISPATCH_LOOP", _parse_bool),
    ("tpu_profile_dir", "TPU_PROFILE_DIR", str),
    ("journey_recorder_enabled", "JOURNEY_RECORDER_ENABLED", _parse_bool),
    ("journey_slow_ms", "JOURNEY_SLOW_MS", float),
    ("journey_retain", "JOURNEY_RETAIN", int),
    ("journey_ring", "JOURNEY_RING", int),
    ("sidecar_socket", "SIDECAR_SOCKET", str),
    ("sidecar_socket_mode", "SIDECAR_SOCKET_MODE", lambda raw: int(raw, 8)),
    ("sidecar_tls_cert", "SIDECAR_TLS_CERT", str),
    ("sidecar_tls_key", "SIDECAR_TLS_KEY", str),
    ("sidecar_tls_ca", "SIDECAR_TLS_CA", str),
    ("sidecar_tls_server_name", "SIDECAR_TLS_SERVER_NAME", str),
    ("sidecar_addrs", "SIDECAR_ADDRS", str),
    ("repl_role", "REPL_ROLE", str),
    ("repl_interval_ms", "REPL_INTERVAL_MS", float),
    ("repl_max_lag_ms", "REPL_MAX_LAG_MS", float),
    ("failure_mode_deny", "FAILURE_MODE_DENY", str),
    ("sidecar_connect_timeout", "SIDECAR_CONNECT_TIMEOUT", _parse_duration_seconds),
    ("sidecar_rpc_deadline", "SIDECAR_RPC_DEADLINE", _parse_duration_seconds),
    ("sidecar_retries", "SIDECAR_RETRIES", int),
    ("sidecar_retry_backoff", "SIDECAR_RETRY_BACKOFF", _parse_duration_seconds),
    (
        "sidecar_retry_backoff_max",
        "SIDECAR_RETRY_BACKOFF_MAX",
        _parse_duration_seconds,
    ),
    ("sidecar_breaker_threshold", "SIDECAR_BREAKER_THRESHOLD", int),
    ("sidecar_breaker_reset", "SIDECAR_BREAKER_RESET", _parse_duration_seconds),
    ("overload_shed_mode", "OVERLOAD_SHED_MODE", str),
    ("overload_max_queue", "OVERLOAD_MAX_QUEUE", int),
    (
        "overload_brownout_target_ms",
        "OVERLOAD_BROWNOUT_TARGET_MS",
        float,
    ),
    ("overload_brownout_exit_ms", "OVERLOAD_BROWNOUT_EXIT_MS", float),
    ("overload_ewma_alpha", "OVERLOAD_EWMA_ALPHA", float),
    (
        "overload_deadline_propagation",
        "OVERLOAD_DEADLINE_PROPAGATION",
        _parse_bool,
    ),
    ("slab_watermark_high", "SLAB_WATERMARK_HIGH", float),
    ("slab_watermark_critical", "SLAB_WATERMARK_CRITICAL", float),
    ("slab_ways", "SLAB_WAYS", int),
    ("slab_snapshot_dir", "SLAB_SNAPSHOT_DIR", str),
    (
        "slab_snapshot_interval_ms",
        "SLAB_SNAPSHOT_INTERVAL_MS",
        float,
    ),
    (
        "slab_snapshot_stale_after_ms",
        "SLAB_SNAPSHOT_STALE_AFTER_MS",
        float,
    ),
    ("lease_enabled", "LEASE_ENABLED", _parse_bool),
    ("lease_min", "LEASE_MIN", int),
    ("lease_max", "LEASE_MAX", int),
    ("lease_ttl_fraction", "LEASE_TTL_FRACTION", float),
    ("lease_near_limit_ratio", "LEASE_NEAR_LIMIT_RATIO", float),
    ("shm_rings", "SHM_RINGS", _parse_bool),
    ("shm_control_sock", "SHM_CONTROL_SOCK", str),
    ("shm_ring_rows", "SHM_RING_ROWS", int),
    ("frontend_procs", "FRONTEND_PROCS", int),
    ("partitions", "PARTITIONS", int),
    ("partition_addrs", "PARTITION_ADDRS", str),
    ("partition_route_sets", "PARTITION_ROUTE_SETS", int),
    ("reshard_rate_limit_mb_s", "RESHARD_RATE_LIMIT_MB_S", float),
    ("concurrency_ttl_s", "CONCURRENCY_TTL_S", int),
    ("gcra_burst_ratio", "GCRA_BURST_RATIO", float),
    ("fault_inject", "FAULT_INJECT", str),
    ("fault_inject_seed", "FAULT_INJECT_SEED", int),
    ("hotkeys_enabled", "HOTKEYS_ENABLED", _parse_bool),
    ("hotkey_k", "HOTKEY_K", int),
    ("hotkey_lanes", "HOTKEY_LANES", int),
    ("victim_tier_enabled", "VICTIM_TIER_ENABLED", _parse_bool),
    ("victim_max_rows", "VICTIM_MAX_ROWS", int),
    ("victim_watermark", "VICTIM_WATERMARK", float),
    ("shard_routed_batching", "SHARD_ROUTED_BATCHING", _parse_bool),
    ("hot_tier_enabled", "HOT_TIER_ENABLED", _parse_bool),
    ("hot_tier_salt_ways", "HOT_TIER_SALT_WAYS", int),
    ("fed_enabled", "FED_ENABLED", _parse_bool),
    ("fed_self", "FED_SELF", str),
    ("fed_peers", "FED_PEERS", str),
    ("fed_share_min", "FED_SHARE_MIN", int),
    ("fed_share_max", "FED_SHARE_MAX", int),
    ("fed_settle_interval_ms", "FED_SETTLE_INTERVAL_MS", float),
    ("fed_max_lag_ms", "FED_MAX_LAG_MS", float),
    ("fed_share_ttl_ms", "FED_SHARE_TTL_MS", float),
]


def new_settings(environ: dict[str, str] | None = None) -> Settings:
    """Build Settings from the environment (settings.go:52-61), then
    refuse what this package cannot serve (check_ported)."""
    env = os.environ if environ is None else environ
    s = Settings()
    for field, var, parse in _FIELD_ENV:
        raw = env.get(var)
        if raw is None or raw == "":
            continue
        try:
            setattr(s, field, parse(raw))
        except ValueError as e:
            raise ValueError(f"bad env var {var}={raw!r}: {e}") from e
    s.check_ported()
    s.environ = env
    return s
