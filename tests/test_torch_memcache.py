"""The port's memcache host backend (api_ratelimit_tpu_torch/backends/
memcache.py, testing/fake_memcache.py) on the CPU.

* The JAX package's tests/test_memcache_backend.py (TestClient,
  TestMemcacheCache, TestWireRobustness) runs on the port with every
  import of the JAX package pointed at the port (test_torch_redis.py
  port_test_module). The Runner-level memcache case runs in
  test_torch_redis.py (TestBackendMatrix).
* One stream through the JAX and the port MemcacheRateLimitCache, each
  against its own port fake, gets the same statuses and sends the same
  bytes: each call's read, and its increments (an unordered set, since
  they run on the backend's worker pool; flush() joins them after each
  call), with and without expiry jitter.
"""

import collections
import random

import pytest

torch = pytest.importorskip("torch")

from test_torch_redis import NOW, PKGS, _stream, port_test_module  # noqa: E402

from api_ratelimit_tpu.backends import memcache as jax_memcache  # noqa: E402
from api_ratelimit_tpu.testing.fake_memcache import FakeMemcacheServer as JaxFakeMemcache  # noqa: E402
from api_ratelimit_tpu_torch.backends import memcache as port_memcache  # noqa: E402
from api_ratelimit_tpu_torch.testing.fake_memcache import FakeMemcacheServer  # noqa: E402

_BACKEND = port_test_module("test_memcache_backend")

fake_memcache = _BACKEND.fake_memcache
TestClient = _BACKEND.TestClient
TestMemcacheCache = _BACKEND.TestMemcacheCache
TestWireRobustness = _BACKEND.TestWireRobustness

MEMCACHE = {"jax": jax_memcache, "port": port_memcache}


def _run(pkg, stream, fake, jitter: int = 0):
    """The stream through one package's MemcacheRateLimitCache; returns
    each call's (code, remaining, reset) per descriptor and each call's
    wire messages (the read, then the increments as a multiset)."""
    P = PKGS[pkg]
    clock = P.Clock(NOW)
    base = P.Base(
        time_source=clock, jitter_rand=random.Random(5), expiration_jitter_max_seconds=jitter,
        local_cache=None, near_limit_ratio=0.8,
    )
    cache = MEMCACHE[pkg].MemcacheRateLimitCache(MEMCACHE[pkg].MemcacheClient(fake.addr), base)
    scope = P.Store().scope("rl")
    limits = {}
    answers, wire = [], []
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
        at = len(fake.wire)
        resp = cache.do_limit(req, lims)
        cache.flush()
        sent = fake.wire[at:]
        wire.append((sent[0], collections.Counter(sent[1:])))
        answers.append([(int(s.code), s.limit_remaining, s.duration_until_reset) for s in resp.descriptor_statuses])
    return answers, wire


@pytest.mark.parametrize("jitter", [0, 300], ids=["no_jitter", "jitter"])
def test_same_wire_bytes_and_statuses_as_the_reference(jitter):
    stream = _stream(17, 200)
    out = {}
    for pkg in PKGS:
        fake = FakeMemcacheServer()
        try:
            # the counters (their expiry is the fake's wall clock)
            out[pkg] = _run(pkg, stream, fake, jitter) + (sorted((k, v[0]) for k, v in fake._data.items()),)
        finally:
            fake.close()
    assert out["port"][0] == out["jax"][0]  # statuses
    assert out["port"][1] == out["jax"][1]  # wire bytes, call by call
    assert out["port"][2] == out["jax"][2]  # the fakes' counters
    codes = {c for call in out["port"][0] for c, _r, _d in call}
    assert {1, 2} <= codes
    assert all(read.startswith(b"get wire_") for read, _incs in out["port"][1])
    assert any(b"add " in m for _read, incs in out["port"][1] for m in incs)


def test_each_fake_serves_the_other_packages_client():
    """The JAX fake serving the port's client and the port's fake serving
    the JAX client see the same command lines and give the same answers."""
    stream = _stream(5, 60)
    jax_fake, port_fake = JaxFakeMemcache(), FakeMemcacheServer()
    try:
        got = _run("port", stream, _Recorder(jax_fake))[0]
        want = _run("jax", stream, port_fake)[0]
        assert got == want
        assert collections.Counter(jax_fake.commands_seen) == collections.Counter(port_fake.commands_seen)
    finally:
        jax_fake.close()
        port_fake.close()


class _Recorder:
    """The reference's fake seen through the port fake's `wire` (command
    lines only: the reference keeps no data blocks), for _run."""

    def __init__(self, fake):
        self._fake = fake
        self.addr = fake.addr

    @property
    def wire(self):
        return self._fake.commands_seen
