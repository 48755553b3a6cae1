"""The port's /json service end to end on the CPU against the JAX package:
the same request stream through the JAX service with TpuRateLimitCache
(use_pallas=False, no hotkey sketch) and through the port's server with
CudaRateLimitCache on device="cpu", with the same slab geometry. Status codes,
parsed response bodies and the exported slab bytes must be identical, a
sliding-window rule included. Also the port's import guard and its refusal to
run without a card."""

import http.client
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from api_ratelimit_tpu.backends.tpu import TpuRateLimitCache  # noqa: E402
from api_ratelimit_tpu.limiter import BaseRateLimiter, LocalCache  # noqa: E402
from api_ratelimit_tpu.server.http_server import HttpServer, add_json_handler  # noqa: E402
from api_ratelimit_tpu.service import RateLimitService  # noqa: E402
from api_ratelimit_tpu.stats import Store  # noqa: E402
from api_ratelimit_tpu.utils import FakeTimeSource  # noqa: E402
from api_ratelimit_tpu.utils.sampler import BasicSampler  # noqa: E402
from api_ratelimit_tpu_torch.backends.cuda import CudaRateLimitCache, SlabDeviceEngine  # noqa: E402
from api_ratelimit_tpu_torch.config import ConfigDoc, build_config  # noqa: E402
from api_ratelimit_tpu_torch.limiter import BaseRateLimiter as PBase  # noqa: E402
from api_ratelimit_tpu_torch.limiter import LocalCache as PLocal  # noqa: E402
from api_ratelimit_tpu_torch.ops import slab as port_slab  # noqa: E402
from api_ratelimit_tpu_torch.server.http_server import HttpServer as PortServer  # noqa: E402
from api_ratelimit_tpu_torch.service import RateLimitService as PortService  # noqa: E402
from api_ratelimit_tpu_torch.stats import Store as PStore  # noqa: E402
from api_ratelimit_tpu_torch.utils import FakeTimeSource as PFake  # noqa: E402
from api_ratelimit_tpu_torch.utils.sampler import BasicSampler as PBasic  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SLOTS, WAYS, NOW0 = 1 << 10, 4, 1_700_000_000

RULES = """
domain: api
descriptors:
  - key: user
    rate_limit: {unit: minute, requests_per_unit: 3}
  - key: user
    value: vip
    report_details: true
    rate_limit: {unit: second, requests_per_unit: 5}
  - key: path
    descriptors:
      - key: method
        value: GET
        sleep_on_throttle: true
        rate_limit: {unit: hour, requests_per_unit: 10}
  - key: staged
    shadow_mode: true
    rate_limit: {unit: minute, requests_per_unit: 1}
  - key: sliding
    rate_limit: {unit: minute, requests_per_unit: 5, algorithm: sliding_window}
"""


class _Runtime:
    def __init__(self, files):
        self.files = files

    def snapshot(self):
        return self

    def keys(self):
        return list(self.files)

    def get(self, key):
        return self.files[key]

    def add_update_callback(self, cb):
        pass


def _req(*descs, hits=None, domain="api"):
    body = {"domain": domain, "descriptors": [{"entries": [{"key": k, "value": v} for k, v in d]} for d in descs]}
    if hits is not None:
        body["hitsAddend"] = hits
    return json.dumps(body).encode()


def _stream():
    """(seconds to advance the clock first, body) pairs."""
    rng = np.random.default_rng(4)
    out = []
    users = [f"u{i}" for i in range(12)] + ["vip"]
    for i in range(60):
        kind = i % 6
        if kind == 0:
            body = _req([("user", str(rng.choice(users)))])
        elif kind == 1:
            body = _req([("user", "vip")], [("user", str(rng.choice(users)))], hits=int(rng.integers(1, 3)))
        elif kind == 2:
            body = _req([("path", "/x"), ("method", "GET")], [("nomatch", "1")])
        elif kind == 3:
            body = _req([("staged", "s")], [("user", "u1")])
        elif kind == 4:
            body = json.dumps({"domain": "api", "descriptors": [{"entries": [{"key": "k", "value": str(i % 3)}], "limit": {"requests_per_unit": 2, "unit": "SECOND"}}]}).encode()
        else:
            body = _req([("user", str(rng.choice(users)))], hits=3)
        out.append((int(rng.choice([0, 0, 1, 30])), body))
    out += [
        (0, b'{"domain": "api"'),  # malformed JSON
        (0, b'{"domain": "api", "bogus": 1}'),  # unknown field
        (0, _req([("user", "x")], domain="")),  # empty domain: service error
        (0, b'{"domain": "api", "descriptors": [{"entries": [{"key": "user", "value": "q"}], "limit": {"unit": 9}}]}'),
    ]
    return out


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", "/json", body=body, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _reference_server(ts):
    base = BaseRateLimiter(ts, local_cache=LocalCache(1000, ts), near_limit_ratio=0.8)
    cache = TpuRateLimitCache(base, n_slots=N_SLOTS, ways=WAYS, use_pallas=False, hotkey_lanes=0, buckets=(128, 1024))
    store = Store()
    svc = RateLimitService(_Runtime({"config.rules": RULES}), cache, store.scope("ratelimit"), ts, report_detail_sampler=BasicSampler(1))
    server = HttpServer("127.0.0.1", 0, "ref")
    add_json_handler(server, svc)
    return server, cache


def _port_server(ts):
    base = PBase(ts, local_cache=PLocal(1000, ts), near_limit_ratio=0.8)
    cache = CudaRateLimitCache(base, n_slots=N_SLOTS, ways=WAYS, buckets=(128, 1024), device="cpu")
    store = PStore()
    svc = PortService(_Runtime({"config.rules": RULES}), cache, store.scope("ratelimit"), ts, report_detail_sampler=PBasic(1))
    return PortServer(svc), cache


def test_json_stream_matches_reference():
    ts_ref, ts_port = FakeTimeSource(NOW0), PFake(NOW0)
    ref, ref_cache = _reference_server(ts_ref)
    port, port_cache = _port_server(ts_port)
    ref.serve_background()
    port.serve_background()
    try:
        seen = set()
        for advance, body in _stream():
            ts_ref.advance(advance)
            ts_port.advance(advance)
            s_ref, b_ref = _post(ref.port, body)
            s_port, b_port = _post(port.port, body)
            assert s_port == s_ref, (body, b_ref, b_port)
            seen.add(s_ref)
            if s_ref in (200, 429):
                assert json.loads(b_port) == json.loads(b_ref), body
                assert b_port == b_ref  # byte-identical, not only equal JSON
        assert {200, 429, 400, 500} <= seen
        # a sliding-window rule is served by its own algorithm, as the
        # reference serves it: past its limit of 5, then the next window's
        # carried count
        assert not port_cache.engine.algos_seen
        for advance in (0,) * 7 + (60, 0, 0):
            ts_ref.advance(advance)
            ts_port.advance(advance)
            s_ref, b_ref = _post(ref.port, _req([("sliding", "a")]))
            s_port, b_port = _post(port.port, _req([("sliding", "a")]))
            assert (s_port, b_port) == (s_ref, b_ref)
            seen.add(s_ref)
        assert port_cache.engine.algos_seen
    finally:
        ref.shutdown()
        port.shutdown()
    want = ref_cache.engine.export_tables()[0]
    got = port_cache.engine.export_tables()[0]
    assert got.dtype == np.uint32 and np.array_equal(got, want)
    assert port_cache.engine.health_snapshot()["decisions"] > 0


def test_config_from_mapping_matches_yaml():
    yaml = pytest.importorskip("yaml")
    from api_ratelimit_tpu_torch.config import ConfigFile, load_config
    from api_ratelimit_tpu_torch.models import Descriptor

    a = load_config([ConfigFile("config.rules", RULES)], PStore())
    b = build_config([ConfigDoc("rules", yaml.safe_load(RULES))], PStore())
    for pairs in ([("user", "vip")], [("user", "x")], [("path", "/"), ("method", "GET")], [("nope", "")]):
        la, lb = (c.get_limit("api", Descriptor.of(*pairs)) for c in (a, b))
        assert (la is None) == (lb is None)
        if la is not None:
            assert (la.full_key, la.limit, la.sleep_on_throttle, la.report_details) == (lb.full_key, lb.limit, lb.sleep_on_throttle, lb.report_details)


def test_cuda_entry_points_raise_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        SlabDeviceEngine(PFake(NOW0), n_slots=N_SLOTS)
    with pytest.raises(RuntimeError, match="cuda"):
        port_slab.make_slab(N_SLOTS)
    with pytest.raises(RuntimeError, match="cuda"):
        port_slab.slab_import_rows(np.zeros((N_SLOTS, 8), np.uint32))


def test_port_imports_no_jax_and_no_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "path = list(sys.path)\n"
        "import api_ratelimit_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'api_ratelimit_tpu', 'xxhash', 'envoy', 'grpc_health_pb'))\n"
        "assert not bad, bad\n"
        "assert sys.path == path, 'an import edited sys.path'\n"
        "new = ('ops.sketch', 'ops.sketch_kernels', 'config.compiled', 'server.http_server', "
        "'pb', 'pb.rls_grpc', 'settings', 'runner', 'backends.memory', 'server.server', "
        "'server.grpc_service', 'server.health', 'server.runtime_loader', "
        "'cmd.service_cmd', 'cmd.client_cmd', 'cmd.config_check_cmd', "
        "'tracing', 'tracing.tracer', 'tracing.propagation', 'tracing.middleware', "
        "'tracing.journeys', 'stats.prometheus', 'utils.provenance', "
        "'backends.fallback', 'parallel', 'parallel.sharded_slab')\n"
        "missing = [m for m in new if 'api_ratelimit_tpu_torch.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
        "print('ok', len([m for m in sys.modules if m.startswith('api_ratelimit_tpu_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
