"""Port of api_ratelimit_tpu/settings.py: process settings.

One env-var struct with defaults, with the reference's variable names
(src/settings/settings.go:10-48) and the JAX package's whole table, parsed
exactly as the JAX package parses them: the same fields, the same parsers
and the same error text (a parse error raises at once, as
envconfig.MustProcess panics, settings.go:52-61). The validators of the
knobs this package reads are the JAX package's, word for word.

Three differences:

* BACKEND_TYPE defaults to `cuda`, the engine of this package
  (backends/cuda.py); `cuda-sidecar` is a frontend of a device-owner
  process (backends/sidecar.py, cmd/sidecar_cmd.py); `memory`, `redis` and
  `memcache` are the host backends. `tpu` and `tpu-sidecar` are the JAX
  package's and raise an error naming `cuda` and `cuda-sidecar`.
* A setting that turns on a feature this package has not ported is refused
  at boot (check_ported, which new_settings and the runner call) with a
  ValueError naming its ROADMAP item: a deployment must never believe it
  runs a mesh that is not there.

Observability and shedding are served as in the JAX package: GET /metrics
(DEBUG_METRICS_ENABLED), the journey recorder (JOURNEY_*), the tracer (its
K_TRACING_* variables, read from the mapping new_settings read by
tracing/tracer.py tracer_from_env), the /debug/profile device trace (TPU_PROFILE_DIR), the
failure-mode ladder (FAILURE_MODE_DENY deny or allow; empty, the default,
raises through; degraded is refused)
and the shed postures (OVERLOAD_SHED_MODE). Warm restart is served as in the
JAX package: SLAB_SNAPSHOT_DIR, _INTERVAL_MS and _STALE_AFTER_MS
(snapshot_config) drive persist/snapshotter.py. The victim tier
(VICTIM_TIER_ENABLED, VICTIM_MAX_ROWS, VICTIM_WATERMARK: victim_config) and
in-process quota leasing (LEASE_ENABLED and LEASE_*: lease_config) serve on
BACKEND_TYPE=cuda; with a host backend LEASE_ENABLED boots unleased, as in
the reference. The multi-process edge is served as in the JAX package:
FRONTEND_PROCS (frontend_procs_count) with BACKEND_TYPE cuda or
cuda-sidecar, the SIDECAR_* transport (sidecar_addresses) and the
shared-memory rings (SHM_RINGS, SHM_CONTROL_SOCK, SHM_RING_ROWS:
shm_control_path, shm_ring_rows_count). Warm-standby replication
(SIDECAR_ADDRS with a standby, REPL_ROLE, REPL_INTERVAL_MS,
REPL_MAX_LAG_MS: repl_peer_address, repl_config) and the partitioned
cluster (PARTITIONS, PARTITION_ADDRS, PARTITION_ROUTE_SETS,
RESHARD_RATE_LIMIT_MB_S: cluster_config, cluster_partition_of) are served
as in the JAX package, with its error text. So are quota federation
(FED_ENABLED, FED_SELF, FED_PEERS, FED_SHARE_*, FED_SETTLE_INTERVAL_MS,
FED_MAX_LAG_MS: fed_config; served on BACKEND_TYPE=cuda and by the device
owner) and fault injection (FAULT_INJECT, FAULT_INJECT_SEED: fault_rules,
the testing/faults.py grammar).
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
BACKEND_TYPES = ("cuda", "cuda-sidecar", "memory", "redis", "memcache")


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
    # the redis backend (settings.go:26-42; backends/redis.py)
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
    # backends (settings.go:46-47; memcache: backends/memcache.py)
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
    # --- the sidecar transport (backends/sidecar.py) ---
    sidecar_socket: str = "/tmp/api-ratelimit-tpu-sidecar.sock"
    sidecar_socket_mode: int = 0o600
    sidecar_tls_cert: str = ""
    sidecar_tls_key: str = ""
    sidecar_tls_ca: str = ""
    sidecar_tls_server_name: str = ""
    sidecar_addrs: str = ""
    # --- warm-standby replication (persist/replication.py) ---
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
    # --- slab snapshots (persist/; snapshot_config) ---
    slab_snapshot_dir: str = ""
    slab_snapshot_interval_ms: float = 10_000.0
    slab_snapshot_stale_after_ms: float = 0.0
    # --- quota leasing (backends/lease.py) ---
    lease_enabled: bool = False
    lease_min: int = 8
    lease_max: int = 1024
    lease_ttl_fraction: float = 0.25
    lease_near_limit_ratio: float = 0.9
    # --- shared-memory submit rings (backends/shm_ring.py; read by the
    # device owner and its cuda-sidecar frontends) ---
    shm_rings: bool = True
    shm_control_sock: str = ""
    shm_ring_rows: int = 4096
    frontend_procs: int = 1  # > 1 is the frontend fleet (cmd/service_cmd.py)
    # --- the partitioned cluster (cluster/) ---
    partitions: int = 1
    partition_addrs: str = ""
    partition_route_sets: int = 256
    reshard_rate_limit_mb_s: float = 32.0
    # --- rate-limit algorithms (config/loader.py, backends/cuda.py) ---
    concurrency_ttl_s: int = 60
    gcra_burst_ratio: float = 1.0
    # --- fault injection (testing/faults.py) ---
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
    # --- quota federation (cluster/federation.py) ---
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

    def lease_config(self) -> tuple[bool, int, int, float, float]:
        """Validated (enabled, min, max, ttl_fraction, near_limit_ratio)
        for hierarchical quota leasing. Junk fails the boot like every
        other knob — a typo'd lease bound must not silently become a
        different overshoot contract."""
        lease_min = int(self.lease_min)
        lease_max = int(self.lease_max)
        ttl_fraction = float(self.lease_ttl_fraction)
        near_ratio = float(self.lease_near_limit_ratio)
        if lease_min < 1:
            raise ValueError(f"LEASE_MIN must be >= 1, got {lease_min}")
        if lease_max < lease_min:
            raise ValueError(
                f"LEASE_MAX ({lease_max}) must not sit below LEASE_MIN "
                f"({lease_min})"
            )
        if not 0.0 < ttl_fraction <= 1.0:
            raise ValueError(
                f"LEASE_TTL_FRACTION must be in (0, 1], got {ttl_fraction}"
            )
        if not 0.0 < near_ratio <= 1.0:
            raise ValueError(
                f"LEASE_NEAR_LIMIT_RATIO must be in (0, 1], got {near_ratio}"
            )
        return (
            bool(self.lease_enabled),
            lease_min,
            lease_max,
            ttl_fraction,
            near_ratio,
        )

    def victim_config(self) -> tuple[bool, int, float]:
        """Validated (enabled, max_rows, watermark) for the host-RAM
        victim tier. Junk fails the boot like every other knob — a typo'd
        row bound must not silently become 'no tier' (counters would go
        back to vanishing on live eviction)."""
        max_rows = int(self.victim_max_rows)
        watermark = float(self.victim_watermark)
        if max_rows < 1:
            raise ValueError(
                f"VICTIM_MAX_ROWS must be >= 1, got {max_rows}"
            )
        if not 0.0 < watermark <= 1.0:
            raise ValueError(
                f"VICTIM_WATERMARK must be in (0, 1], got {watermark}"
            )
        return bool(self.victim_tier_enabled), max_rows, watermark

    def snapshot_config(self) -> tuple[str, float, float]:
        """Validated (dir, interval_ms, stale_after_ms) for the warm-
        restart snapshotter; dir == "" disables. Junk fails the boot like
        every other knob: a typo'd interval must not silently become "no
        durability". stale_after 0 defaults to three intervals."""
        directory = self.slab_snapshot_dir.strip()
        interval = float(self.slab_snapshot_interval_ms)
        stale = float(self.slab_snapshot_stale_after_ms)
        if interval <= 0:
            raise ValueError(
                f"SLAB_SNAPSHOT_INTERVAL_MS must be > 0, got {interval}"
            )
        if stale < 0:
            raise ValueError(
                f"SLAB_SNAPSHOT_STALE_AFTER_MS must be >= 0, got {stale}"
            )
        if 0 < stale < interval:
            raise ValueError(
                f"SLAB_SNAPSHOT_STALE_AFTER_MS ({stale}) must not sit "
                f"below SLAB_SNAPSHOT_INTERVAL_MS ({interval})"
            )
        return directory, interval, stale if stale > 0 else 3.0 * interval

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

    def fault_rules(self):
        """Parsed FAULT_INJECT rules (testing/faults.py grammar). Raises
        ValueError on junk — a typo'd chaos spec must fail the boot, not
        silently inject nothing."""
        from .testing.faults import parse_fault_spec

        try:
            return parse_fault_spec(self.fault_inject)
        except ValueError as e:
            raise ValueError(
                f"bad env var FAULT_INJECT={self.fault_inject!r}: {e}"
            ) from e

    def sidecar_addresses(self) -> list[str]:
        """The frontend's device-owner address list: parsed SIDECAR_ADDRS,
        or [SIDECAR_SOCKET] when unset. Junk (empty entries only, malformed
        tcp:// or tls:// authorities) fails the boot like every other knob.
        The first entry is the primary, the rest its warm standbys in
        failover order."""
        raw = self.sidecar_addrs.strip()
        if not raw:
            return [self.sidecar_socket]
        from .backends.sidecar import parse_sidecar_address

        addrs = [a.strip() for a in raw.split(",") if a.strip()]
        if not addrs:
            raise ValueError(
                f"SIDECAR_ADDRS must hold at least one address, "
                f"got {self.sidecar_addrs!r}"
            )
        for addr in addrs:
            try:
                parse_sidecar_address(addr)
            except ValueError as e:
                raise ValueError(f"bad SIDECAR_ADDRS entry {addr!r}: {e}") from e
        return addrs

    def repl_peer_address(self) -> str | None:
        """The replication peer a sidecar process subscribes to: the first
        SIDECAR_ADDRS entry that is not its own SIDECAR_SOCKET, or None
        when the list names nobody else."""
        for addr in self.sidecar_addresses():
            if addr != self.sidecar_socket:
                return addr
        return None

    def repl_config(self) -> tuple[str, float, float]:
        """Validated (role, interval_ms, max_lag_ms) for warm-standby
        replication; role == "" disables. Junk fails the boot like every
        other knob — a typo'd role must not silently become 'no standby',
        and a lag bound below the ship cadence would flap the health
        probe every interval. max_lag 0 defaults to five intervals."""
        role = self.repl_role.strip().lower()
        if role not in ("", "primary", "standby", "auto"):
            raise ValueError(
                f"REPL_ROLE must be primary, standby, auto, or empty, "
                f"got {self.repl_role!r}"
            )
        interval = float(self.repl_interval_ms)
        max_lag = float(self.repl_max_lag_ms)
        if interval <= 0:
            raise ValueError(
                f"REPL_INTERVAL_MS must be > 0, got {interval}"
            )
        if max_lag < 0:
            raise ValueError(
                f"REPL_MAX_LAG_MS must be >= 0, got {max_lag}"
            )
        if 0 < max_lag < interval:
            raise ValueError(
                f"REPL_MAX_LAG_MS ({max_lag}) must not sit below "
                f"REPL_INTERVAL_MS ({interval})"
            )
        if role in ("standby", "auto") and self.repl_peer_address() is None:
            raise ValueError(
                f"REPL_ROLE={role} needs SIDECAR_ADDRS to name a peer "
                f"other than this process's SIDECAR_SOCKET "
                f"({self.sidecar_socket!r})"
            )
        return role, interval, max_lag if max_lag > 0 else 5.0 * interval

    def fed_config(self) -> tuple[bool, str, dict, int, int, float, float, float]:
        """Validated (enabled, self_name, peers, share_min, share_max,
        settle_interval_ms, max_lag_ms, share_ttl_ms) for global quota
        federation (cluster/federation.py); enabled=False builds no
        coordinator (the byte-identical rollback arm). Junk fails the
        boot like every other knob — a typo'd membership must not
        silently become a different home assignment, and a lag bound
        below the settle cadence would flap the fed.degraded probe
        every interval. max_lag 0 defaults to five settle intervals,
        share TTL 0 to ten."""
        share_min = int(self.fed_share_min)
        share_max = int(self.fed_share_max)
        if share_min < 1:
            raise ValueError(f"FED_SHARE_MIN must be >= 1, got {share_min}")
        if share_max < share_min:
            raise ValueError(
                f"FED_SHARE_MAX ({share_max}) must be >= FED_SHARE_MIN "
                f"({share_min})"
            )
        interval = float(self.fed_settle_interval_ms)
        if interval <= 0:
            raise ValueError(
                f"FED_SETTLE_INTERVAL_MS must be > 0, got {interval}"
            )
        max_lag = float(self.fed_max_lag_ms)
        if max_lag < 0:
            raise ValueError(f"FED_MAX_LAG_MS must be >= 0, got {max_lag}")
        if 0 < max_lag < interval:
            raise ValueError(
                f"FED_MAX_LAG_MS ({max_lag}) must not sit below "
                f"FED_SETTLE_INTERVAL_MS ({interval})"
            )
        ttl = float(self.fed_share_ttl_ms)
        if ttl < 0:
            raise ValueError(f"FED_SHARE_TTL_MS must be >= 0, got {ttl}")
        if 0 < ttl < interval:
            raise ValueError(
                f"FED_SHARE_TTL_MS ({ttl}) must not sit below "
                f"FED_SETTLE_INTERVAL_MS ({interval})"
            )
        max_lag = max_lag if max_lag > 0 else 5.0 * interval
        ttl = ttl if ttl > 0 else 10.0 * interval
        if not self.fed_enabled:
            return False, "", {}, share_min, share_max, interval, max_lag, ttl
        self_name = self.fed_self.strip()
        if not self_name:
            raise ValueError("FED_ENABLED needs FED_SELF to name this cluster")
        raw = self.fed_peers.strip()
        if not raw:
            raise ValueError(
                "FED_ENABLED needs FED_PEERS to name the full membership "
                "(comma-separated name=address, incl. this cluster)"
            )
        peers: dict = {}
        from .backends.sidecar import parse_sidecar_address

        for entry in raw.split(","):
            entry = entry.strip()
            if not entry:
                continue
            name, sep, addr = entry.partition("=")
            name, addr = name.strip(), addr.strip()
            if not sep or not name or not addr:
                raise ValueError(
                    f"bad FED_PEERS entry {entry!r}: want name=address"
                )
            if name in peers:
                raise ValueError(f"duplicate FED_PEERS name {name!r}")
            try:
                parse_sidecar_address(addr)
            except ValueError as e:
                raise ValueError(
                    f"bad FED_PEERS address for {name!r}: {e}"
                ) from e
            peers[name] = addr
        if len(peers) < 2:
            raise ValueError(
                f"FED_PEERS must name at least two clusters, got {len(peers)}"
            )
        if self_name not in peers:
            raise ValueError(
                f"FED_SELF {self_name!r} does not appear in FED_PEERS "
                f"({sorted(peers)})"
            )
        return (
            True, self_name, peers,
            share_min, share_max, interval, max_lag, ttl,
        )

    def cluster_config(self) -> tuple[int, list[list[str]], int, float]:
        """Validated (partitions, addr_groups, route_sets,
        reshard_rate_limit_mb_s) for the partitioned cluster (cluster/).
        PARTITIONS=1 returns ([], ...) — the pre-cluster rollback arm
        builds no router. Junk fails the boot like every other knob: a
        typo'd partition count must not silently become a different
        keyspace split."""
        k = int(self.partitions)
        if k < 1:
            raise ValueError(f"PARTITIONS must be >= 1, got {k}")
        route_sets = int(self.partition_route_sets)
        if route_sets <= 0 or route_sets & (route_sets - 1):
            raise ValueError(
                f"PARTITION_ROUTE_SETS must be a power of two, "
                f"got {route_sets}"
            )
        rate = float(self.reshard_rate_limit_mb_s)
        if rate <= 0:
            raise ValueError(
                f"RESHARD_RATE_LIMIT_MB_S must be > 0, got {rate}"
            )
        if k == 1:
            return 1, [], route_sets, rate
        if k > route_sets:
            raise ValueError(
                f"PARTITIONS ({k}) cannot exceed PARTITION_ROUTE_SETS "
                f"({route_sets})"
            )
        raw = self.partition_addrs.strip()
        groups = [
            [a.strip() for a in grp.split(",") if a.strip()]
            for grp in raw.split(";")
            if grp.strip()
        ]
        if len(groups) != k:
            raise ValueError(
                f"PARTITIONS={k} needs exactly {k} ';'-separated "
                f"PARTITION_ADDRS groups, got {len(groups)} "
                f"({self.partition_addrs!r})"
            )
        from .backends.sidecar import parse_sidecar_address

        for i, grp in enumerate(groups):
            if not grp:
                raise ValueError(f"PARTITION_ADDRS group {i} is empty")
            for addr in grp:
                try:
                    parse_sidecar_address(addr)
                except ValueError as e:
                    raise ValueError(
                        f"bad PARTITION_ADDRS entry {addr!r} "
                        f"(group {i}): {e}"
                    ) from e
        return k, groups, route_sets, rate

    def cluster_partition_of(self, address: str) -> int | None:
        """Which PARTITION_ADDRS group lists `address` — how a sidecar
        process discovers its own partition index without a flag (the
        --partition argument overrides). None when unlisted."""
        _k, groups, _rs, _rate = self.cluster_config()
        for i, grp in enumerate(groups):
            if address in grp:
                return i
        return None

    def shm_control_path(self) -> str:
        """The shm-ring control socket path, or "" when shm rings are off
        or underivable. Explicit SHM_CONTROL_SOCK wins; otherwise a unix
        SIDECAR_SOCKET derives <socket>.shmctl (same host by construction),
        and a tcp:// or tls:// owner disables shm: shared memory cannot
        cross hosts."""
        if not self.shm_rings:
            return ""
        explicit = self.shm_control_sock.strip()
        if explicit:
            return explicit
        if "://" in self.sidecar_socket:
            return ""
        return self.sidecar_socket + ".shmctl"

    def shm_ring_rows_count(self) -> int:
        """Validated SHM_RING_ROWS arena capacity: a typo'd arena size
        must not silently become a shed-everything ring."""
        rows = int(self.shm_ring_rows)
        if rows < 64:
            raise ValueError(f"SHM_RING_ROWS must be >= 64, got {rows}")
        return rows

    def frontend_procs_count(self) -> int:
        """Validated FRONTEND_PROCS worker count (1 = the single-process
        boot)."""
        n = int(self.frontend_procs)
        if n < 1:
            raise ValueError(f"FRONTEND_PROCS must be >= 1, got {n}")
        if n > 1 and self.backend_type not in ("cuda", "cuda-sidecar"):
            raise ValueError(
                f"FRONTEND_PROCS={n} requires BACKEND_TYPE cuda or "
                f"cuda-sidecar, got {self.backend_type!r}"
            )
        return n

    def check_ported(self) -> None:
        """Refuse, with the ROADMAP item that ports it, every setting that
        turns on a feature this package lacks, and a backend it does not
        have. Called by new_settings and at boot (runner.py)."""
        backend = self.backend_type
        if backend == "tpu":
            raise ValueError(
                f"BACKEND_TYPE={backend!r} is the JAX package's TPU engine; "
                f"this package serves BACKEND_TYPE=cuda (the H100 engine) "
                f"or memory"
            )
        if backend == "tpu-sidecar":
            raise ValueError(
                f"BACKEND_TYPE={backend!r} is a frontend of the JAX package's "
                f"TPU owner; this package's frontend of its device owner is "
                f"BACKEND_TYPE=cuda-sidecar"
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
