"""The port's /metrics layer against the JAX package's: the Prometheus
renderer (stats/prometheus.py), the ratelimit.build.* provenance gauges
(utils/provenance.py) and the exposition parser.

* The same seeded stat operations on each package's Store render
  byte-identical exposition text.
* The provenance gauges have the reference's names and values; a runner on
  the CPU reports platform cpu and 0 devices, and GET /metrics serves them.
* The port's parse_exposition reads /metrics as the JAX package's
  stats/fleet.py parser does (the fleet merge itself is ROADMAP item 8).
"""

import http.client

import numpy as np
import pytest

pytest.importorskip("torch")

from api_ratelimit_tpu.stats import Store as JStore  # noqa: E402
from api_ratelimit_tpu.stats import TestSink as JTestSink  # noqa: E402
from api_ratelimit_tpu.stats import fleet as jax_fleet  # noqa: E402
from api_ratelimit_tpu.stats import prometheus as jax_prom  # noqa: E402
from api_ratelimit_tpu.utils import provenance as jax_prov  # noqa: E402
from api_ratelimit_tpu_torch.stats import Store, TestSink  # noqa: E402
from api_ratelimit_tpu_torch.stats import prometheus as port_prom  # noqa: E402
from api_ratelimit_tpu_torch.utils import provenance as port_prov  # noqa: E402

def _stat_ops(seed: int, n: int = 300) -> list:
    """A seeded list of stat operations: (kind, name, value[, extra])."""
    rng = np.random.default_rng(seed)
    names = [f"ratelimit.s{seed}.{part}" for part in ("a", "b.c", "d-e", "0f", "g.h.i")]
    ops = []
    for _ in range(n):
        kind = ["counter", "gauge", "timer", "histogram", "sized", "exemplar"][int(rng.integers(0, 6))]
        name = names[int(rng.integers(0, len(names)))] + "." + kind
        value = float(rng.choice([0.0, 0.25, 1.0, 3.0, 17.5, 250.0, 1e4, float(rng.exponential(5.0))]))
        ops.append((kind, name, value))
    return ops


def _apply(store, ops) -> None:
    for kind, name, value in ops:
        if kind == "counter":
            store.counter(name).add(int(value))
        elif kind == "gauge":
            store.gauge(name).set(int(value))
        elif kind == "timer":
            store.timer(name).add_value_ms(value)
        elif kind == "histogram":
            store.histogram(name).record(value)
        elif kind == "sized":
            store.histogram(name, boundaries=(1, 8, 64, 512)).record(value)
        else:
            h = store.histogram(name)
            h.record(value, exemplar=f"{int(value * 1000):032x}" if h.is_slow(value) else None)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("buckets", [None, (0.5, 2.0, 10.0)], ids=["default_buckets", "custom_buckets"])
def test_metrics_text_is_byte_identical(seed, buckets):
    ops = _stat_ops(seed)
    jstore, pstore = JStore(JTestSink(), latency_buckets=buckets), Store(TestSink(), latency_buckets=buckets)
    _apply(jstore, ops)
    _apply(pstore, ops)
    want = jax_prom.render(jstore)
    got = port_prom.render(pstore)
    assert got == want
    assert got.count("# TYPE") >= 5
    assert port_prom.CONTENT_TYPE == jax_prom.CONTENT_TYPE


def test_empty_store_renders_nothing():
    assert port_prom.render(Store()) == jax_prom.render(JStore()) == ""


@pytest.mark.parametrize("name", ["ratelimit.slab.occupancy", "9lives.x", "a-b.c d", "ok_name:x"])
def test_prom_names_mangle_alike(name):
    assert port_prom.prom_name(name) == jax_prom.prom_name(name)


@pytest.mark.parametrize("platform, count", [("cpu", 0), ("gpu", 1), ("gpu", 4), ("npu", 2)])
def test_provenance_gauges_match_the_reference(platform, count):
    jstore, pstore = JStore(JTestSink()), Store(TestSink())
    jax_prov.register_build_gauges(jstore.scope("ratelimit"), platform=platform, device_count=count)
    port_prov.register_build_gauges(pstore.scope("ratelimit"), platform=platform, device_count=count)
    got = {k: v for k, v in pstore.debug_snapshot().items() if k.startswith("ratelimit.build.")}
    assert got == {k: v for k, v in jstore.debug_snapshot().items() if k.startswith("ratelimit.build.")}
    assert got["ratelimit.build.platform_id"] == {"cpu": 0, "gpu": 2}.get(platform, -1)
    assert got["ratelimit.build.device_count"] == count
    assert port_prom.render(pstore) == jax_prom.render(jstore)


def _runtime(tmp_path):
    config = tmp_path / "rl" / "config"
    config.mkdir(parents=True)
    (config / "m.yaml").write_text("domain: m\ndescriptors:\n  - key: k\n    rate_limit: {unit: minute, requests_per_unit: 2}\n")
    return str(tmp_path)


@pytest.mark.parametrize("backend", ["memory", "cuda"])
def test_runner_on_the_cpu_reports_no_device_on_metrics(tmp_path, backend):
    """A runner on the CPU (the tests' device="cpu", or the memory backend)
    reports platform cpu and 0 devices, and GET /metrics serves the build
    gauges beside the service's counters."""
    from api_ratelimit_tpu_torch.runner import Runner
    from api_ratelimit_tpu_torch.settings import new_settings

    env = {
        "BACKEND_TYPE": backend, "RUNTIME_ROOT": _runtime(tmp_path), "RUNTIME_SUBDIRECTORY": "rl",
        "USE_STATSD": "false", "PORT": "0", "GRPC_PORT": "0", "DEBUG_PORT": "0", "LOG_LEVEL": "ERROR",
        "TPU_SLAB_SLOTS": "4096", "SLAB_WAYS": "4", "TPU_BUCKETS": "128", "TPU_PRECOMPILE": "false",
    }
    runner = Runner(new_settings(env), device="cpu")
    runner.run_background()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", runner.server.debug_port, timeout=10)
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        text = resp.read().decode()
        conn.close()
    finally:
        runner.stop()
    assert resp.status == 200 and resp.getheader("Content-Type") == port_prom.CONTENT_TYPE
    _types, families = port_prom.parse_exposition(text)
    assert families["ratelimit_build_platform_id"] == {"ratelimit_build_platform_id": 0.0}
    assert families["ratelimit_build_device_count"] == {"ratelimit_build_device_count": 0.0}
    assert families["ratelimit_service_config_load_success"]["ratelimit_service_config_load_success"] == 1.0


# -- the exposition parser (the JAX package's stats/fleet.py parse_exposition) --

BAD = "# TYPE ratelimit_ok counter\nratelimit_ok 5\nratelimit_truncated{le=\nratelimit_notanumber NaNope\n"

both_parsers = pytest.mark.parametrize(
    "parse_exposition", [jax_fleet.parse_exposition, port_prom.parse_exposition], ids=["jax", "port"]
)


@both_parsers
def test_parse_counts_dropped_lines(parse_exposition):
    report: dict = {}
    _, families = parse_exposition(BAD, report)
    assert report["dropped_lines"] == 2
    assert families["ratelimit_ok"]["ratelimit_ok"] == 5.0


@pytest.mark.parametrize("seed", range(3))
def test_parse_of_rendered_stores_is_identical(seed):
    """A rendered store, and a truncated copy of it, parse to the same
    types, families and drop count through both parsers."""
    store = Store(TestSink())
    _apply(store, _stat_ops(seed, 120))
    text = port_prom.render(store)
    for body in (text, text[: len(text) * 2 // 3] + "\nratelimit_x{le=\n"):
        want_report: dict = {}
        got_report: dict = {}
        want = jax_fleet.parse_exposition(body, want_report)
        got = port_prom.parse_exposition(body, got_report)
        assert got == want and got_report == want_report
    assert want_report["dropped_lines"] >= 1
