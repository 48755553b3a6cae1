"""The port's redis host backend (api_ratelimit_tpu_torch/backends/
{redis,redis_driver}.py, testing/fake_redis.py) on the CPU.

* The JAX package's own tests run on the port: tests/test_redis_backend.py
  (TestDriver, TestRedisFixedCache, TestRedisVsMemoryOracle,
  TestRespParserRobustness) and tests/test_server_integration.py
  TestBackendMatrix and TestBackendMatrixTopologies (TLS + AUTH, cluster,
  sentinel, the per-second pool, memcache), with every import of the JAX
  package pointed at the port (port_test_module): the same test code
  against the port's driver, cache, fakes and Runner.
* One stream through the JAX and the port RedisRateLimitCache, each against
  its own port fake, sends the same RESP bytes and gets the same statuses;
  the JAX fake serving the port's client and the port's fake serving the
  JAX client see the same commands.
* A JAX Runner and a port Runner, both BACKEND_TYPE=redis on one fake
  process clock, answer one gRPC stream byte for byte, and the two fakes
  hold the same counters.
"""

import os
import random
import re
import types

import pytest

torch = pytest.importorskip("torch")
grpc = pytest.importorskip("grpc")

from api_ratelimit_tpu.backends import redis as jax_redis  # noqa: E402
from api_ratelimit_tpu.backends import redis_driver as jax_driver  # noqa: E402
from api_ratelimit_tpu.limiter.base_limiter import BaseRateLimiter as JaxBase  # noqa: E402
from api_ratelimit_tpu.models import config as jax_config  # noqa: E402
from api_ratelimit_tpu.models import descriptors as jax_desc  # noqa: E402
from api_ratelimit_tpu.models import response as jax_response  # noqa: E402
from api_ratelimit_tpu.stats import Store as JaxStore  # noqa: E402
from api_ratelimit_tpu.testing.fake_redis import FakeRedisServer as JaxFakeRedis  # noqa: E402
from api_ratelimit_tpu.utils import FakeTimeSource as JaxClock  # noqa: E402
from api_ratelimit_tpu_torch.backends import redis as port_redis  # noqa: E402
from api_ratelimit_tpu_torch.backends import redis_driver as port_driver  # noqa: E402
from api_ratelimit_tpu_torch.limiter.base_limiter import BaseRateLimiter as PortBase  # noqa: E402
from api_ratelimit_tpu_torch.models import config as port_config  # noqa: E402
from api_ratelimit_tpu_torch.models import descriptors as port_desc  # noqa: E402
from api_ratelimit_tpu_torch.models import response as port_response  # noqa: E402
from api_ratelimit_tpu_torch.stats import Store as PortStore  # noqa: E402
from api_ratelimit_tpu_torch.testing.fake_redis import FakeRedisServer  # noqa: E402
from api_ratelimit_tpu_torch.utils import FakeTimeSource as PortClock  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))


def port_test_module(name: str) -> types.ModuleType:
    """The JAX package's tests/<name>.py with every import of the JAX
    package pointed at the port's module of the same path: the same test
    code, run on the port."""
    path = os.path.join(TESTS, name + ".py")
    with open(path) as f:
        src = re.sub(r"\bapi_ratelimit_tpu\b", "api_ratelimit_tpu_torch", f.read())
    mod = types.ModuleType("port_" + name)
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


_BACKEND = port_test_module("test_redis_backend")
_SERVER = port_test_module("test_server_integration")

fake_redis = _BACKEND.fake_redis
TestDriver = _BACKEND.TestDriver
TestRedisFixedCache = _BACKEND.TestRedisFixedCache
TestRedisVsMemoryOracle = _BACKEND.TestRedisVsMemoryOracle
TestRespParserRobustness = _BACKEND.TestRespParserRobustness
TestBackendMatrix = _SERVER.TestBackendMatrix
TestBackendMatrixTopologies = _SERVER.TestBackendMatrixTopologies

NOW = 1_722_300_000

# one package's pieces, so a stream can run through either
PKGS = {
    "jax": types.SimpleNamespace(
        redis=jax_redis, driver=jax_driver, Base=JaxBase, config=jax_config,
        desc=jax_desc, response=jax_response, Store=JaxStore, Clock=JaxClock,
    ),
    "port": types.SimpleNamespace(
        redis=port_redis, driver=port_driver, Base=PortBase, config=port_config,
        desc=port_desc, response=port_response, Store=PortStore, Clock=PortClock,
    ),
}

def _stream(seed: int, n: int) -> list:
    """(clock step, [(key, value, requests_per_unit, unit)], hits) calls:
    1-3 descriptors, limits crossed, per-second keys among them."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        descs = []
        for _d in range(rng.randint(1, 3)):
            k = rng.choice(["u", "p", "s", "t"])
            rpu = {"u": 3, "p": 5, "s": 2, "t": 7}[k]
            unit = {"u": "MINUTE", "p": "HOUR", "s": "SECOND", "t": "MINUTE"}[k]
            descs.append((k, f"v{rng.randint(0, 4)}", rpu, unit))
        out.append((rng.choice([0, 0, 0, 1, 2]), descs, rng.choice([0, 0, 1, 3])))
    return out


def _run(pkg, stream, main_addr: str, second_addr: str | None, jitter: int = 0):
    """The stream through one package's RedisRateLimitCache; returns each
    call's (code, remaining, reset) per descriptor."""
    P = PKGS[pkg]
    clock = P.Clock(NOW)
    base = P.Base(
        time_source=clock, jitter_rand=random.Random(5), expiration_jitter_max_seconds=jitter,
        local_cache=None, near_limit_ratio=0.8,
    )
    client = P.driver.RedisClient("tcp", main_addr, pool_size=1)
    second = P.driver.RedisClient("tcp", second_addr, pool_size=1) if second_addr else None
    cache = P.redis.RedisRateLimitCache(client, base, per_second_client=second)
    scope = P.Store().scope("rl")
    limits = {}
    out = []
    for step, descs, hits in stream:
        clock.advance(step)
        req = P.desc.RateLimitRequest(
            domain="wire", descriptors=tuple(P.desc.Descriptor.of((k, v)) for k, v, _r, _u in descs), hits_addend=hits
        )
        lims = []
        for k, _v, rpu, unit in descs:
            if (k, rpu, unit) not in limits:
                limits[k, rpu, unit] = P.config.RateLimit(
                    full_key=k, limit=P.response.RateLimitValue(rpu, getattr(P.config.Unit, unit)),
                    stats=P.config.new_rate_limit_stats(scope, k),
                )
            lims.append(limits[k, rpu, unit])
        resp = cache.do_limit(req, lims)
        out.append([(int(s.code), s.limit_remaining, s.duration_until_reset) for s in resp.descriptor_statuses])
    client.close()
    if second is not None:
        second.close()
    return out


@pytest.mark.parametrize("per_second", [False, True], ids=["one_pool", "per_second_pool"])
@pytest.mark.parametrize("jitter", [0, 300], ids=["no_jitter", "jitter"])
def test_same_wire_bytes_and_statuses_as_the_reference(per_second, jitter):
    """One stream through each package's cache, each against two port
    fakes (main, per-second): the RESP bytes each fake received (PING,
    then one INCRBY + EXPIRE pipeline a call) and the statuses are the
    same; the jittered EXPIRE draws the same seeded offsets."""
    stream = _stream(11, 300)
    wires, answers, counters = {}, {}, {}
    for pkg in PKGS:
        main, second = FakeRedisServer(), FakeRedisServer() if per_second else None
        try:
            answers[pkg] = _run(pkg, stream, main.addr, second.addr if second else None, jitter)
            wires[pkg] = (main.wire, second.wire if second else None)
            counters[pkg] = sorted(main._data.items()) + (sorted(second._data.items()) if second else [])
        finally:
            main.close()
            if second is not None:
                second.close()
    assert answers["port"] == answers["jax"]
    assert wires["port"] == wires["jax"]
    assert [k for k, _ in counters["port"]] == [k for k, _ in counters["jax"]]
    assert [v[0] for _, v in counters["port"]] == [v[0] for _, v in counters["jax"]]
    codes = {c for call in answers["port"] for c, _r, _d in call}
    assert {1, 2} <= codes  # OK and OVER_LIMIT both answered
    assert any(w.startswith(b"*3\r\n$6\r\nINCRBY\r\n") for w in wires["port"][0])
    if per_second:
        assert any(b"\r\ns_" not in w and b"_s_" in w for w in wires["port"][1])


def test_each_fake_serves_the_other_packages_client():
    """The JAX fake serving the port's client and the port's fake serving
    the JAX client see the same commands and give the same answers."""
    stream = _stream(3, 40)
    jax_fake, port_fake = JaxFakeRedis(), FakeRedisServer()
    try:
        got = _run("port", stream, jax_fake.addr, None)
        want = _run("jax", stream, port_fake.addr, None)
        assert got == want
        assert jax_fake.commands_seen == port_fake.commands_seen
        # each recorded command is the reference encoder's bytes for it
        assert port_fake.wire == [jax_driver.encode_commands([c]) for c in port_fake.commands_seen]
    finally:
        jax_fake.close()
        port_fake.close()


def test_jax_runner_and_port_runner_answer_alike_over_redis(tmp_path):
    """BACKEND_TYPE=redis through both packages' Runners, each against its
    own port fake on one fake process clock: test_torch_server.py's 160
    v3/v2//json calls answer byte for byte, each fake received the same
    RESP bytes, and the two hold the same counters."""
    import numpy as np
    import test_torch_server as ts

    from api_ratelimit_tpu import runner as jax_runner
    from api_ratelimit_tpu import settings as jax_settings
    from api_ratelimit_tpu.utils import timeutil as jax_time
    from api_ratelimit_tpu_torch import runner as port_runner
    from api_ratelimit_tpu_torch import settings as port_settings
    from api_ratelimit_tpu_torch.utils import RealTimeSource
    from api_ratelimit_tpu_torch.utils import timeutil as port_time

    config_dir = tmp_path / "ratelimit" / "config"
    config_dir.mkdir(parents=True)
    (config_dir / "par.yaml").write_text(ts.PARITY_RULES)
    clock = PortClock(ts.NOW)
    fakes = {pkg: FakeRedisServer(clock=clock.unix_now) for pkg in PKGS}
    env = dict(ts.PARITY_ENV, RUNTIME_ROOT=str(tmp_path), BACKEND_TYPE="redis", REDIS_SOCKET_TYPE="tcp")
    jax_time.install_process_time_source(clock)
    port_time.install_process_time_source(clock)
    runners = {}
    try:
        runners["jax"] = jax_runner.Runner(jax_settings.new_settings(dict(env, REDIS_URL=fakes["jax"].addr)))
        runners["port"] = port_runner.Runner(port_settings.new_settings(dict(env, REDIS_URL=fakes["port"].addr)))
        for r in runners.values():
            r.run_background()
            assert r.wait_ready(10.0)
        jr, pr = runners["jax"], runners["port"]
        seen = set()
        for kind, descs, hits, override, step in ts._parity_stream(np.random.default_rng(9), 160):
            clock.advance(step)
            if kind == "json":
                body = ts._json(descs, hits)
                got = ts.http_call(pr.server.http_port, "POST", "/json", body)
                want = ts.http_call(jr.server.http_port, "POST", "/json", body)
                seen.add(got[0])
            else:
                req = ts._v3(descs, hits, override) if kind == "v3" else ts._v2(descs, hits)
                got = ts._grpc_call(pr.server.grpc_port, kind, req)
                want = ts._grpc_call(jr.server.grpc_port, kind, req)
            assert got == want, (kind, descs, hits, override)
        assert {200, 429} <= seen
        assert fakes["port"].wire == fakes["jax"].wire
        assert sorted(fakes["port"]._data.items()) == sorted(fakes["jax"]._data.items())
    finally:
        for r in runners.values():
            if r.server is not None:
                r.stop()
        for f in fakes.values():
            f.close()
        jax_time.install_process_time_source(jax_time.RealTimeSource())
        port_time.install_process_time_source(RealTimeSource())
