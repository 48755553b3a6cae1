"""/json through the port's windowed path on the CPU (TPU_BATCH_WINDOW > 0):
CudaRateLimitCache(batch_window_seconds=0.002, device="cpu") behind the
port's ThreadingHTTPServer.

- A concurrent stream (8 client threads) in both windowed arms leaves every
  key with the same row (count, window, expiry) as the same requests served
  serially by the direct-mode port, and answers as many descriptors
  OVER_LIMIT.
- A serial stream through the JAX package's windowed cache
  (TpuRateLimitCache, use_pallas=False) and the port's windowed cache gets
  the same status codes and body bytes, and leaves the same slab bytes."""

import http.client
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from api_ratelimit_tpu.backends.tpu import TpuRateLimitCache  # noqa: E402
from api_ratelimit_tpu.limiter import BaseRateLimiter, LocalCache  # noqa: E402
from api_ratelimit_tpu.server.http_server import HttpServer, add_json_handler  # noqa: E402
from api_ratelimit_tpu.service import RateLimitService  # noqa: E402
from api_ratelimit_tpu.stats import Store  # noqa: E402
from api_ratelimit_tpu.utils import FakeTimeSource  # noqa: E402
from api_ratelimit_tpu_torch.backends.cuda import CudaRateLimitCache  # noqa: E402
from api_ratelimit_tpu_torch.limiter import BaseRateLimiter as PBase  # noqa: E402
from api_ratelimit_tpu_torch.limiter import LocalCache as PLocal  # noqa: E402
from api_ratelimit_tpu_torch.server.http_server import HttpServer as PortServer  # noqa: E402
from api_ratelimit_tpu_torch.service import RateLimitService as PortService  # noqa: E402
from api_ratelimit_tpu_torch.stats import Store as PStore  # noqa: E402
from api_ratelimit_tpu_torch.utils import FakeTimeSource as PFake  # noqa: E402

N_SLOTS, WAYS, NOW0, WINDOW = 1 << 10, 4, 1_700_000_000, 0.002

RULES = """
domain: api
descriptors:
  - key: user
    rate_limit: {unit: minute, requests_per_unit: 20}
  - key: path
    descriptors:
      - key: method
        value: GET
        rate_limit: {unit: hour, requests_per_unit: 100}
  - key: burst
    rate_limit: {unit: second, requests_per_unit: 3}
"""


class _Runtime:
    def snapshot(self):
        return self

    def keys(self):
        return ["config.rules"]

    def get(self, key):
        return RULES

    def add_update_callback(self, cb):
        pass


def _req(*descs, hits=None):
    body = {"domain": "api", "descriptors": [{"entries": [{"key": k, "value": v} for k, v in d]} for d in descs]}
    if hits is not None:
        body["hitsAddend"] = hits
    return json.dumps(body).encode()


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", "/json", body=body, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _port_server(ts, window, dispatch_loop=True, local_cache=False):
    base = PBase(ts, local_cache=PLocal(1000, ts) if local_cache else None, near_limit_ratio=0.8)
    cache = CudaRateLimitCache(
        base, n_slots=N_SLOTS, ways=WAYS, buckets=(128, 1024), device="cpu",
        batch_window_seconds=window, max_batch=1024, dispatch_loop=dispatch_loop,
    )
    svc = PortService(_Runtime(), cache, PStore().scope("ratelimit"), ts)
    server = PortServer(svc)
    server.serve_background()
    return server, cache


def _over_limit(body: bytes) -> int:
    return sum(st.get("code") == "OVER_LIMIT" for st in json.loads(body)["statuses"])


def _live_rows(table):
    """The multiset of live rows: each key's full row, independent of the
    way it landed in."""
    return sorted(map(tuple, table[table[:, 4] != 0].tolist()))


def _concurrent_bodies():
    rng = np.random.default_rng(8)
    bodies = []
    for i in range(192):
        user = f"u{int(rng.integers(0, 10))}"
        if i % 3 == 0:
            bodies.append(_req([("user", user)], [("path", "/a"), ("method", "GET")]))
        elif i % 3 == 1:
            bodies.append(_req([("user", user)]))
        else:
            bodies.append(_req([("burst", str(int(rng.integers(0, 3))))], [("user", user)]))
    return bodies


@pytest.mark.parametrize("dispatch_loop", [True, False])
def test_concurrent_json_leaves_the_direct_mode_counts(dispatch_loop):
    bodies = _concurrent_bodies()
    server, cache = _port_server(PFake(NOW0), WINDOW, dispatch_loop)
    answers = []
    lock = threading.Lock()

    def client(k):
        for body in bodies[k::8]:
            answer = _post(server.port, body)
            with lock:
                answers.append(answer)

    try:
        threads = [threading.Thread(target=client, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        assert not any(t.is_alive() for t in threads)
        cache.flush()
    finally:
        server.shutdown()
    engine = cache.engine
    assert (engine.dispatch_loop is not None) == dispatch_loop
    windowed = engine.export_tables()[0]
    decisions = engine.health_snapshot()["decisions"]
    cache.close()

    direct, direct_cache = _port_server(PFake(NOW0), 0.0)
    try:
        want = [_post(direct.port, body) for body in bodies]
    finally:
        direct.shutdown()
    assert direct_cache.engine.batcher.launches == len(bodies)
    assert _live_rows(windowed) == _live_rows(direct_cache.engine.export_tables()[0])
    assert decisions == direct_cache.engine.health_snapshot()["decisions"]
    # hits are 1 per descriptor: each key answers OVER_LIMIT to its hits
    # past the limit, whatever the order (which requests carry them, and so
    # the count of 429s, depends on the order)
    assert len(answers) == len(bodies) and {s for s, _ in answers} == {200, 429}
    assert sum(_over_limit(b) for _, b in answers) == sum(_over_limit(b) for _, b in want) > 0
    direct_cache.close()


def _serial_stream():
    rng = np.random.default_rng(5)
    out = []
    for i in range(80):
        user = f"u{int(rng.integers(0, 6))}"
        kind = i % 4
        if kind == 0:
            body = _req([("user", user)], hits=int(rng.integers(1, 4)))
        elif kind == 1:
            body = _req([("path", "/b"), ("method", "GET")], [("user", user)])
        elif kind == 2:
            body = _req([("burst", "x")], [("nomatch", "1")])
        else:
            body = _req([("user", user)], [("burst", "y")], hits=2)
        out.append((int(rng.choice([0, 0, 0, 1, 61])), body))
    return out


def test_serial_json_stream_matches_the_jax_windowed_cache():
    ts_ref, ts_port = FakeTimeSource(NOW0), PFake(NOW0)
    base = BaseRateLimiter(ts_ref, local_cache=LocalCache(1000, ts_ref), near_limit_ratio=0.8)
    ref_cache = TpuRateLimitCache(
        base, n_slots=N_SLOTS, ways=WAYS, use_pallas=False, buckets=(128, 1024),
        batch_window_seconds=WINDOW, max_batch=1024,
    )
    ref_svc = RateLimitService(_Runtime(), ref_cache, Store().scope("ratelimit"), ts_ref)
    ref = HttpServer("127.0.0.1", 0, "ref")
    add_json_handler(ref, ref_svc)
    ref.serve_background()
    port, port_cache = _port_server(ts_port, WINDOW, local_cache=True)
    seen = set()
    try:
        for advance, body in _serial_stream():
            ts_ref.advance(advance)
            ts_port.advance(advance)
            s_ref, b_ref = _post(ref.port, body)
            s_port, b_port = _post(port.port, body)
            assert s_port == s_ref, (body, b_ref, b_port)
            assert b_port == b_ref, body
            seen.add(s_ref)
        assert seen == {200, 429}
    finally:
        ref.shutdown()
        port.shutdown()
    assert port_cache.engine.dispatch_loop is not None
    got = port_cache.engine.export_tables()[0]
    assert np.array_equal(got, np.asarray(ref_cache.engine.export_tables()[0]))
    ref_cache.close()
    port_cache.close()
