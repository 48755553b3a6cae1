"""The port's settings against the JAX package's: the same environment
parses into the same fields (BACKEND_TYPE's cuda standing for tpu), a bad
value raises the same message, the boot validators agree, and every knob
that turns on a feature the port has not ported is refused at boot with its
ROADMAP item. The observability and shedding knobs (FAILURE_MODE_DENY,
OVERLOAD_SHED_MODE, TPU_PROFILE_DIR, the tracer's switches, the journey
recorder) parse as the reference's, and the default boot warns of nothing
unserved. Quota federation's and the fault injector's knobs (FED_*,
FAULT_INJECT, FAULT_INJECT_SEED) boot, and their validators (fed_config,
fault_rules) answer as the reference's, value or error."""

import dataclasses

import pytest

pytest.importorskip("torch")

from api_ratelimit_tpu import settings as R  # noqa: E402
from api_ratelimit_tpu_torch import settings as P  # noqa: E402

# (name, env) pairs; valid and invalid, each through both new_settings
ENVS = [
    ("empty", {}),
    ("ports", {"PORT": "9080", "GRPC_PORT": "9081", "DEBUG_PORT": "7070"}),
    ("statsd", {"USE_STATSD": "false", "STATSD_HOST": "stats.local", "STATSD_PORT": "9125"}),
    ("runtime", {"RUNTIME_ROOT": "/srv/rt", "RUNTIME_SUBDIRECTORY": "rl", "RUNTIME_IGNOREDOTFILES": "yes", "RUNTIME_WATCH_ROOT": "off"}),
    ("watcher", {"RUNTIME_WATCHER": "poll", "RUNTIME_POLL_INTERVAL": "0.5", "RUNTIME_SAFETY_RESCAN": "2"}),
    ("logging", {"LOG_LEVEL": "debug", "LOG_FORMAT": "json"}),
    ("limiter", {"EXPIRATION_JITTER_MAX_SECONDS": "0", "LOCAL_CACHE_SIZE_IN_BYTES": "1048576", "NEAR_LIMIT_RATIO": "0.9"}),
    ("engine", {"TPU_SLAB_SLOTS": "8388608", "SLAB_WAYS": "128", "TPU_BUCKETS": "1024,128", "TPU_PRECOMPILE": "0"}),
    ("windowed", {"TPU_BATCH_WINDOW": "200us", "TPU_BATCH_LIMIT": "32768", "DISPATCH_LOOP": "f"}),
    ("durations", {"TPU_BATCH_WINDOW": "1.5ms", "REDIS_PIPELINE_WINDOW": "75µs", "REDIS_PERSECOND_PIPELINE_WINDOW": "2"}),
    ("hotpath", {"HOST_FAST_PATH": "false", "MAX_SLEEPING_ROUTINES": "4"}),
    ("hotkeys", {"HOTKEYS_ENABLED": "true", "HOTKEY_K": "8", "HOTKEY_LANES": "256"}),
    ("algorithms", {"CONCURRENCY_TTL_S": "30", "GCRA_BURST_RATIO": "1.5"}),
    ("overload", {"OVERLOAD_MAX_QUEUE": "4096", "OVERLOAD_BROWNOUT_TARGET_MS": "20", "OVERLOAD_EWMA_ALPHA": "0.5"}),
    ("deadlines", {"OVERLOAD_DEADLINE_PROPAGATION": "false", "OVERLOAD_SHED_MODE": "unavailable"}),
    ("watermark", {"SLAB_WATERMARK_HIGH": "0.9", "SLAB_WATERMARK_CRITICAL": "0.95"}),
    ("metrics", {"DEBUG_METRICS_ENABLED": "false", "METRICS_LATENCY_BUCKETS_MS": "1,5,25"}),
    ("journeys", {"JOURNEY_RECORDER_ENABLED": "0", "JOURNEY_SLOW_MS": "12.5", "JOURNEY_RETAIN": "32", "JOURNEY_RING": "8"}),
    ("failure_mode_deny", {"FAILURE_MODE_DENY": "true", "OVERLOAD_SHED_MODE": "deny"}),
    ("failure_mode_allow", {"FAILURE_MODE_DENY": "false"}),
    ("profile_dir", {"TPU_PROFILE_DIR": "/tmp/prof"}),
    ("tracing_on", {"K_TRACING_ENABLED": "true", "K_TRACING_ZIPKIN_URL": "http://127.0.0.1:9411"}),
    ("lightstep_on", {"K_TRACING_LIGHTSTEP_ENABLED": "1"}),
    ("redis_knobs", {"REDIS_URL": "localhost:6379", "REDIS_POOL_SIZE": "4", "REDIS_PERSECOND": "1"}),
    ("memory_backend", {"BACKEND_TYPE": "memory"}),
    ("redis_backend", {"BACKEND_TYPE": "redis", "REDIS_URL": "127.0.0.1:6379", "REDIS_TYPE": "SENTINEL"}),
    ("memcache_backend", {"BACKEND_TYPE": "memcache", "MEMCACHE_HOST_PORT": "127.0.0.1:11211"}),
    ("snapshots", {"SLAB_SNAPSHOT_DIR": "/var/lib/rl", "SLAB_SNAPSHOT_INTERVAL_MS": "5000", "SLAB_SNAPSHOT_STALE_AFTER_MS": "20000"}),
    ("snapshots_default_staleness", {"SLAB_SNAPSHOT_DIR": "/var/lib/rl", "SLAB_SNAPSHOT_INTERVAL_MS": "250"}),
    ("tpu_backend", {"BACKEND_TYPE": "tpu"}),
    ("empty_values_keep_defaults", {"PORT": "", "HOTKEY_K": "", "TPU_BATCH_WINDOW": ""}),
    ("mesh_one_chip", {"TPU_MESH_DEVICES": "1"}),
    # invalid: a parse error, the same text from both
    ("bad_int", {"PORT": "eighty"}),
    ("bad_bool", {"USE_STATSD": "maybe"}),
    ("bad_float", {"NEAR_LIMIT_RATIO": "high"}),
    ("bad_duration", {"TPU_BATCH_WINDOW": "fastms"}),
    ("bad_octal", {"SIDECAR_SOCKET_MODE": "0999"}),
    ("bad_hotkey_k", {"HOTKEY_K": "1.5"}),
    ("bad_slots", {"TPU_SLAB_SLOTS": "1<<22"}),
    ("bad_watch_root", {"RUNTIME_WATCH_ROOT": "2"}),
    ("bad_dispatch_loop", {"DISPATCH_LOOP": "yes please"}),
]

# the boot validators both packages have, called as their runners call them
VALIDATORS = (
    "latency_buckets",
    "buckets",
    "failure_mode",
    "shed_mode",
    "slab_watermark",
    "slab_ways_count",
    "hotkey_config",
    "concurrency_ttl",
    "gcra_burst",
    "journey_config",
    "snapshot_config",
    # the multi-process edge's (slice 13)
    "sidecar_addresses",
    "shm_control_path",
    "shm_ring_rows_count",
    # replication and the partitioned cluster's
    "repl_peer_address",
    "repl_config",
    "cluster_config",
    # quota federation's and the fault injector's (slice 15)
    "fed_config",
    "fault_rules",
)

# parsed, but a validator refuses it at boot: the same text from both
VALIDATOR_ENVS = [
    ("junk_buckets", {"TPU_BUCKETS": "128,x"}),
    ("zero_bucket", {"TPU_BUCKETS": "0,128"}),
    ("ways_not_pow2", {"SLAB_WAYS": "6"}),
    ("watermark_out_of_range", {"SLAB_WATERMARK_HIGH": "1.5"}),
    ("hotkey_k_over_lanes", {"HOTKEY_K": "64", "HOTKEY_LANES": "32"}),
    ("lanes_not_pow2", {"HOTKEY_LANES": "100"}),
    ("ttl_zero", {"CONCURRENCY_TTL_S": "0"}),
    ("burst_too_big", {"GCRA_BURST_RATIO": "17"}),
    ("latency_buckets_negative", {"METRICS_LATENCY_BUCKETS_MS": "-1,2"}),
    ("shed_mode_junk", {"OVERLOAD_SHED_MODE": "drop"}),
    ("failure_mode_junk", {"FAILURE_MODE_DENY": "sometimes"}),
    # parsed as the reference parses it; the port refuses the rung at boot
    # (test_degraded_failure_mode_is_refused)
    ("failure_mode_degraded", {"FAILURE_MODE_DENY": "degraded", "OVERLOAD_SHED_MODE": "allow"}),
    ("ways_negative", {"SLAB_WAYS": "-4"}),
    ("lanes_zero", {"HOTKEY_LANES": "0"}),
    ("journey_slow_negative", {"JOURNEY_SLOW_MS": "-1"}),
    ("journey_retain_zero", {"JOURNEY_RETAIN": "0"}),
    ("journey_ring_negative", {"JOURNEY_RING": "-8"}),
    ("snapshot_interval_zero", {"SLAB_SNAPSHOT_DIR": "/var/lib/rl", "SLAB_SNAPSHOT_INTERVAL_MS": "0"}),
    ("snapshot_interval_negative", {"SLAB_SNAPSHOT_INTERVAL_MS": "-5"}),
    ("snapshot_stale_negative", {"SLAB_SNAPSHOT_STALE_AFTER_MS": "-1"}),
    ("snapshot_stale_below_interval", {"SLAB_SNAPSHOT_INTERVAL_MS": "10000", "SLAB_SNAPSHOT_STALE_AFTER_MS": "500"}),
    ("shm_ring_rows_small", {"SHM_RING_ROWS": "32"}),
    ("shm_rings_off", {"SHM_RINGS": "false", "SIDECAR_SOCKET": "/run/o.sock"}),
    ("shm_over_tcp", {"SIDECAR_SOCKET": "tcp://owner:7000"}),
    ("shm_control_explicit", {"SHM_CONTROL_SOCK": "/run/ctl.sock"}),
    ("sidecar_addrs_malformed", {"SIDECAR_ADDRS": "tcp://nohost"}),
    ("sidecar_addrs_empty_entries", {"SIDECAR_ADDRS": " , "}),
    ("repl_standby_without_peer", {"REPL_ROLE": "standby"}),
    ("repl_auto_with_peer", {"REPL_ROLE": "auto", "SIDECAR_SOCKET": "/run/b.sock", "SIDECAR_ADDRS": "/run/a.sock,/run/b.sock"}),
    ("repl_role_junk", {"REPL_ROLE": "leader"}),
    ("repl_interval_zero", {"REPL_INTERVAL_MS": "0"}),
    ("repl_lag_negative", {"REPL_MAX_LAG_MS": "-1"}),
    ("repl_lag_below_interval", {"REPL_INTERVAL_MS": "100", "REPL_MAX_LAG_MS": "50"}),
    ("partitions_zero", {"PARTITIONS": "0"}),
    ("partitions_without_addrs", {"PARTITIONS": "2"}),
    ("partitions_two", {"PARTITIONS": "2", "PARTITION_ADDRS": "/run/a.sock,/run/a2.sock;tcp://10.0.0.2:7000"}),
    ("partitions_over_route_sets", {"PARTITIONS": "4", "PARTITION_ROUTE_SETS": "2"}),
    ("route_sets_not_pow2", {"PARTITION_ROUTE_SETS": "100"}),
    ("partition_addr_malformed", {"PARTITIONS": "2", "PARTITION_ADDRS": "/run/a.sock;tcp://nohost"}),
    ("partition_group_empty", {"PARTITIONS": "2", "PARTITION_ADDRS": "/run/a.sock; , ;"}),
    ("reshard_rate_zero", {"RESHARD_RATE_LIMIT_MB_S": "0"}),
    # quota federation (fed_config) and the fault injector (fault_rules)
    ("fed_two_clusters", {"FED_ENABLED": "true", "FED_SELF": "east", "FED_PEERS": "east=/run/e.sock,west=tcp://10.0.0.9:7000"}),
    ("fed_defaults_off", {"FED_SHARE_MIN": "4", "FED_SETTLE_INTERVAL_MS": "20"}),
    ("fed_knobs", {"FED_ENABLED": "1", "FED_SELF": "a", "FED_PEERS": "a=/a.sock,b=/b.sock,c=/c.sock", "FED_SHARE_MIN": "2", "FED_SHARE_MAX": "64", "FED_SETTLE_INTERVAL_MS": "25", "FED_MAX_LAG_MS": "400", "FED_SHARE_TTL_MS": "2000"}),
    ("fed_without_self", {"FED_ENABLED": "true", "FED_PEERS": "a=/a.sock,b=/b.sock"}),
    ("fed_without_peers", {"FED_ENABLED": "true", "FED_SELF": "a"}),
    ("fed_self_not_a_peer", {"FED_ENABLED": "true", "FED_SELF": "c", "FED_PEERS": "a=/a.sock,b=/b.sock"}),
    ("fed_one_member", {"FED_ENABLED": "true", "FED_SELF": "a", "FED_PEERS": "a=/a.sock"}),
    ("fed_entry_malformed", {"FED_ENABLED": "true", "FED_SELF": "a", "FED_PEERS": "a=/a.sock,b"}),
    ("fed_duplicate_name", {"FED_ENABLED": "true", "FED_SELF": "a", "FED_PEERS": "a=/a.sock,a=/b.sock"}),
    ("fed_bad_address", {"FED_ENABLED": "true", "FED_SELF": "a", "FED_PEERS": "a=/a.sock,b=tcp://nohost"}),
    ("fed_share_min_zero", {"FED_SHARE_MIN": "0"}),
    ("fed_share_max_below_min", {"FED_SHARE_MIN": "16", "FED_SHARE_MAX": "8"}),
    ("fed_interval_zero", {"FED_SETTLE_INTERVAL_MS": "0"}),
    ("fed_lag_negative", {"FED_MAX_LAG_MS": "-1"}),
    ("fed_lag_below_interval", {"FED_SETTLE_INTERVAL_MS": "100", "FED_MAX_LAG_MS": "50"}),
    ("fed_ttl_negative", {"FED_SHARE_TTL_MS": "-5"}),
    ("fed_ttl_below_interval", {"FED_SETTLE_INTERVAL_MS": "100", "FED_SHARE_TTL_MS": "50"}),
    ("faults_two_rules", {"FAULT_INJECT": "sidecar.submit:error:0.2,sidecar.submit:delay_ms:500", "FAULT_INJECT_SEED": "7"}),
    ("faults_qualified", {"FAULT_INJECT": "fed.exchange:drop:1.0:after=5:times=1,dispatch.launch:error:1:times:2"}),
    ("faults_junk_kind", {"FAULT_INJECT": "sidecar.submit:explode:1"}),
    ("faults_junk_probability", {"FAULT_INJECT": "sidecar.submit:error:1.5"}),
    ("faults_junk_site", {"FAULT_INJECT": "Sidecar..Submit:error:1"}),
    ("faults_junk_qualifier", {"FAULT_INJECT": "a.b:error:1:twice=2"}),
]


def _outcome(new_settings, env):
    try:
        s = new_settings(env)
    except ValueError as e:
        return "error", str(e)
    return "ok", dataclasses.asdict(s)


def _port_env(env):
    return dict(env, BACKEND_TYPE="cuda") if env.get("BACKEND_TYPE") == "tpu" else env


@pytest.mark.parametrize("env", [e for _n, e in ENVS], ids=[n for n, _e in ENVS])
def test_new_settings_parses_like_the_reference(env):
    want = _outcome(R.new_settings, env)
    got = _outcome(P.new_settings, _port_env(env))
    if want[0] == "ok":
        assert want[1].pop("backend_type") == env.get("BACKEND_TYPE", "tpu")
        assert got[1].pop("backend_type") == _port_env(env).get("BACKEND_TYPE", "cuda")
    assert got == want


def _plain(value):
    """A validator's value with each package's dataclasses (fault_rules'
    FaultRule) as plain dicts, so the two packages' values compare."""
    if dataclasses.is_dataclass(value):
        return dataclasses.asdict(value)
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(v) for v in value)
    return value


def _validated_one(settings, name):
    try:
        return _plain(getattr(settings, name)())
    except ValueError as e:
        return "error: " + str(e)


def _validated(settings):
    return [(name, _validated_one(settings, name)) for name in VALIDATORS]


@pytest.mark.parametrize("env", [e for _n, e in ENVS + VALIDATOR_ENVS], ids=[n for n, _e in ENVS + VALIDATOR_ENVS])
def test_boot_validators_agree(env):
    """Each validator's value, or its error text, is the reference's.
    The port's refusals (check_ported) run after the parse, so the port's
    Settings are built field by field here, as the reference parses them."""
    try:
        want_settings = R.new_settings(env)
    except ValueError:
        return  # a parse error: test_new_settings_parses_like_the_reference
    got_settings = P.Settings(**{**dataclasses.asdict(want_settings), "backend_type": "cuda"})
    assert _validated(got_settings) == _validated(want_settings)


# (env, the ROADMAP item the refusal names; None: the item is ported, and
# the knob that was refused now boots; a validator's name: the knob boots
# and that validator answers as the reference's, its value or its error)
UNPORTED = [
    ({"TPU_MESH_DEVICES": "4"}, "10"),
    ({"FRONTEND_PROCS": "2"}, None),  # item 8, the multi-process edge
    ({"SIDECAR_SOCKET": "/run/owner.sock"}, None),  # item 8
    # item 9a: a standby list is accepted
    ({"SIDECAR_ADDRS": "/run/a.sock,/run/b.sock"}, "sidecar_addresses"),
    ({"SIDECAR_RETRIES": "5"}, None),  # item 8
    ({"SLAB_SNAPSHOT_DIR": "/var/lib/rl"}, None),  # item 7
    ({"LEASE_ENABLED": "true"}, None),  # item 8, its in-process half
    # item 9b: FED_ENABLED boots, and fed_config refuses it without FED_SELF
    # with the reference's message
    ({"FED_ENABLED": "true"}, "fed_config"),
    # item 9a: PARTITIONS=2 without PARTITION_ADDRS boots, and
    # cluster_config refuses it with the reference's message
    ({"PARTITIONS": "2"}, "cluster_config"),
    ({"REPL_ROLE": "primary"}, "repl_config"),
    # REPL_ROLE=standby without a peer: repl_config's refusal
    ({"REPL_ROLE": "standby"}, "repl_config"),
    ({"VICTIM_TIER_ENABLED": "true"}, None),  # item 6
    # item 11b's injector: FAULT_INJECT boots, its rules the reference's
    ({"FAULT_INJECT": "sidecar.submit:error:0.2"}, "fault_rules"),
    ({"BACKEND_TYPE": "redis"}, None),  # item 4c
    ({"BACKEND_TYPE": "memcache"}, None),  # item 4c
]


@pytest.mark.parametrize("env, item", UNPORTED, ids=[next(iter(e)) + "=" + next(iter(e.values())) for e, _i in UNPORTED])
def test_unported_knob_is_refused_with_its_item(env, item):
    """Each knob of an unported item is refused naming the item; a knob
    whose item has been ported boots, with the reference's fields."""
    want = R.new_settings(env)  # the reference accepts it
    if item is None or not item[0].isdigit():
        got_settings = P.new_settings(env)
        if item is not None:
            assert _validated_one(got_settings, item) == _validated_one(want, item)
        got = dataclasses.asdict(got_settings)
        want = dataclasses.asdict(want)
        assert got.pop("backend_type") == env.get("BACKEND_TYPE", "cuda")
        assert want.pop("backend_type") == env.get("BACKEND_TYPE", "tpu")
        assert got == want
        return
    with pytest.raises(ValueError, match=f"ROADMAP item {item}\\)"):
        P.new_settings(env)


@pytest.mark.parametrize("backend", ["tpu", "tpu-sidecar"])
def test_jax_backends_name_cuda(backend):
    """The JAX package's backends name their counterparts: tpu names cuda,
    tpu-sidecar names cuda-sidecar."""
    want = "BACKEND_TYPE=cuda-sidecar" if backend == "tpu-sidecar" else "BACKEND_TYPE=cuda "
    with pytest.raises(ValueError, match=want):
        P.new_settings({"BACKEND_TYPE": backend})


def test_plain_path_is_refused():
    with pytest.raises(ValueError, match="no plain path on the card"):
        P.new_settings({"TPU_USE_PALLAS": "false"})


@pytest.mark.parametrize("backend", ["cuda", "memory"])
def test_degraded_failure_mode_is_refused(backend):
    """The reference's degraded rung decides on the CPU when the card
    fails; the port refuses it for every backend, and takes deny and
    allow."""
    env = {"FAILURE_MODE_DENY": "degraded", "BACKEND_TYPE": backend}
    assert R.new_settings(dict(env, BACKEND_TYPE="tpu" if backend == "cuda" else backend)).failure_mode() == "degraded"
    with pytest.raises(ValueError, match="moves no decision off the card"):
        P.new_settings(env)
    for value, mode in (("deny", "deny"), ("allow", "allow"), ("true", "deny"), ("false", "allow")):
        assert P.new_settings(dict(env, FAILURE_MODE_DENY=value)).failure_mode() == mode


def test_runner_traces_as_its_settings_mapping_says(tmp_path, monkeypatch):
    """The tracer reads K_TRACING_* from the mapping new_settings read: a
    dict-booted Runner traces as its dict says, whatever os.environ
    holds."""
    from api_ratelimit_tpu_torch import tracing
    from api_ratelimit_tpu_torch.runner import Runner

    monkeypatch.delenv("K_TRACING_ENABLED", raising=False)
    monkeypatch.delenv("LIGHTSTEP_ENABLED", raising=False)
    (tmp_path / "rl" / "config").mkdir(parents=True)
    env = {
        "BACKEND_TYPE": "memory", "RUNTIME_ROOT": str(tmp_path), "RUNTIME_SUBDIRECTORY": "rl",
        "USE_STATSD": "false", "PORT": "0", "GRPC_PORT": "0", "DEBUG_PORT": "0",
    }
    for extra, kind in (({"K_TRACING_ENABLED": "true"}, tracing.RecordingTracer), ({}, tracing.NoopTracer)):
        settings = P.new_settings(dict(env, **extra))
        assert settings.environ == dict(env, **extra)
        runner = Runner(settings, device="cpu")
        runner.run_background()
        try:
            assert type(runner.tracer) is kind and tracing.global_tracer() is runner.tracer
        finally:
            runner.stop()
    assert P.Settings().environ is None and "environ" not in dataclasses.asdict(P.Settings())


def test_unknown_backend_is_invalid():
    with pytest.raises(ValueError, match="invalid backend type: 'gpu'"):
        P.new_settings({"BACKEND_TYPE": "gpu"})


def test_defaults_boot_with_warnings_for_item_4b(tmp_path, capsys):
    """The reference's own defaults turn on /metrics and the journey
    recorder, and the port now serves both: a Runner booted from the
    default environment mounts /metrics, registers a recorder, and logs no
    warning about DEBUG_METRICS_ENABLED, JOURNEY_RECORDER_ENABLED or item
    4b."""
    from api_ratelimit_tpu_torch.runner import Runner
    from api_ratelimit_tpu_torch.tracing import journeys

    (tmp_path / "rl" / "config").mkdir(parents=True)
    env = {
        "BACKEND_TYPE": "memory", "RUNTIME_ROOT": str(tmp_path), "RUNTIME_SUBDIRECTORY": "rl",
        "USE_STATSD": "false", "PORT": "0", "GRPC_PORT": "0", "DEBUG_PORT": "0",
    }
    runner = Runner(P.new_settings(env), device="cpu")
    runner.run_background()
    try:
        assert "/metrics" in runner.server.debug.endpoints()
        assert journeys.global_recorder() is runner.journeys is not None
    finally:
        runner.stop()
    assert journeys.global_recorder() is None
    err = capsys.readouterr().err
    for word in ("DEBUG_METRICS_ENABLED", "JOURNEY_RECORDER_ENABLED", "ROADMAP item 4b"):
        assert word not in err


def test_field_table_is_the_reference():
    assert [(f, v) for f, v, _p in P._FIELD_ENV] == [(f, v) for f, v, _p in R._FIELD_ENV]
