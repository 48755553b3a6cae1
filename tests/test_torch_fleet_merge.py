"""The port's fleet exposition merge (api_ratelimit_tpu_torch/stats/fleet.py)
and the fleet master's aggregator on the CPU, against the JAX package's.

* The JAX package's tests/test_fleet_merge.py runs on the port
  (reference_tests_on_the_port): max vs sum per name (high-water marks,
  epochs, the build family), malformed expositions degrading to a partial
  merge with a visible drop count, the merged output passing the
  exposition lint, histogram and summary merges.
* The port's merge of seeded port /metrics texts (three frontends on the
  CPU and an owner on the card, by their build gauges) equals the JAX
  merge of the same texts, byte for byte.
* The master's GET /metrics?fleet=1 (cmd/service_cmd.py
  _serve_fleet_aggregator) over live member debug listeners serves that
  merge; a plain GET /metrics answers the member port map.
"""

import json
import random
import urllib.request

import pytest

torch = pytest.importorskip("torch")

from test_torch_victim import reference_tests_on_the_port  # noqa: E402

from api_ratelimit_tpu.stats import fleet as jax_fleet  # noqa: E402
from api_ratelimit_tpu_torch.cmd import service_cmd  # noqa: E402
from api_ratelimit_tpu_torch.server.http_server import new_debug_server  # noqa: E402
from api_ratelimit_tpu_torch.settings import Settings  # noqa: E402
from api_ratelimit_tpu_torch.stats import Store, fleet  # noqa: E402
from api_ratelimit_tpu_torch.stats.sinks import NullSink  # noqa: E402
from api_ratelimit_tpu_torch.utils import provenance  # noqa: E402

_REF = reference_tests_on_the_port("test_fleet_merge")

TestMaxVsSum = _REF.TestMaxVsSum
TestMalformedExposition = _REF.TestMalformedExposition
TestHistogramMerge = _REF.TestHistogramMerge


def _member(seed: int, owner: bool) -> Store:
    """One member's store with seeded stat ops: counters, gauges (a
    high-water mark among them), a histogram, the native gauge and the
    build gauges (the owner reports the card)."""
    rng = random.Random(seed)
    store = Store(NullSink())
    scope = store.scope("ratelimit")
    for name in ("service.rate_limit.total_hits", "service.rate_limit.over_limit", "sidecar.retry"):
        scope.counter(name).add(rng.randrange(0, 1000))
    scope.gauge("dispatch.queue_depth").set(rng.randrange(0, 50))
    scope.gauge("dispatch.ring.arena_hwm").set(rng.randrange(0, 4096))
    scope.scope("native").gauge("available").set(1)
    hist = scope.histogram("sidecar.rpc_ms")
    for _ in range(rng.randrange(5, 40)):
        hist.record(rng.random() * 20)
    provenance.register_build_gauges(
        scope, platform="gpu" if owner else "cpu", device_count=1 if owner else 0
    )
    return store


def _texts(seed: int):
    from api_ratelimit_tpu_torch.stats import prometheus

    return [prometheus.render(_member(seed + i, owner=(i == 3))) for i in range(4)]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_port_merge_equals_the_reference_merge(seed):
    texts = _texts(seed * 10)
    report, jax_report = {}, {}
    got = fleet.merge_expositions(texts, report)
    assert got == jax_fleet.merge_expositions(texts, jax_report)
    assert report == jax_report
    assert "ratelimit_build_platform_id 2" in got.splitlines()  # the owner's gpu
    assert "ratelimit_build_device_count 1" in got.splitlines()
    assert "ratelimit_native_available 1" in got.splitlines()


def test_master_aggregator_serves_the_fleet_merge():
    stores = [_member(40 + i, owner=(i == 2)) for i in range(3)]
    members = [new_debug_server(store, "127.0.0.1", 0) for store in stores]
    for m in members:
        m.serve_background()
    ports = [m.port for m in members]
    settings = Settings(debug_port=0)
    aggregator = service_cmd._serve_fleet_aggregator(settings, ports)
    try:
        base = f"http://127.0.0.1:{aggregator.port}"
        with urllib.request.urlopen(base + "/metrics?fleet=1", timeout=10) as r:
            merged = r.read().decode()
        want, errors = jax_fleet.fleet_metrics(ports)
        assert errors == [] and merged == want
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            doc = json.loads(r.read().decode())
        assert doc["fleet"] is True and doc["member_debug_ports"] == ports
    finally:
        aggregator.shutdown()
        for m in members:
            m.shutdown()
