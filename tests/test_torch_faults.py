"""The port's fault injector (api_ratelimit_tpu_torch/testing/faults.py) and
its live surfaces (/debug/faults, /debug/clock, the owner's OP_FAULTS_SET)
on the CPU, against the JAX package's.

* The grammar: each spec, valid or junk, parses into the reference's rules or
  raises the reference's message; rules_to_spec and to_spec round-trip.
* For a set of specs (probabilities, delays, qualifiers, several rules a
  site, several sites) and seeds, the port's and the JAX injector's fire()
  sequences, their sleeps, fired() and describe() are equal over 10^4
  calls, through a configure() and a clear() midway: one spec and seed trip
  the same calls in both packages.
* /debug/faults and /debug/clock answer a JAX Runner's bodies, status codes
  and content types, call by call (a spec, a JSON body with a seed, junk
  specs and bodies, a clock step and drift, a reset).
* OP_FAULTS_SET across the packages: a JAX admin_set_faults against a port
  owner and a port admin_set_faults against a JAX owner answer the
  same-package documents; a junk spec and an owner without an injector
  answer the reference's error.
* The JAX package's tests/test_chaos.py classes that drive only the
  injector, the sidecar, the breaker and the ladder run on the port
  (reference_tests_on_the_port): TestFaultInjectorUnit, TestSidecarRetries,
  TestBreakerCycle, TestFailureModeLadder and TestLeaseFailureLadder. The
  reference's degraded rung decides on the CPU and the port refuses it, so
  its two cases check the refusal.
"""

import dataclasses
import json
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")

from test_torch_victim import reference_tests_on_the_port  # noqa: E402

from api_ratelimit_tpu.backends import sidecar as jax_sidecar  # noqa: E402
from api_ratelimit_tpu.backends.tpu import SlabDeviceEngine as JaxEngine  # noqa: E402
from api_ratelimit_tpu.testing import faults as jax_faults  # noqa: E402
from api_ratelimit_tpu.utils import FakeTimeSource as JaxClock  # noqa: E402
from api_ratelimit_tpu_torch.backends import sidecar as port_sidecar  # noqa: E402
from api_ratelimit_tpu_torch.backends.cuda import SlabDeviceEngine  # noqa: E402
from api_ratelimit_tpu_torch.stats import Store, TestSink  # noqa: E402
from api_ratelimit_tpu_torch.testing import faults as port_faults  # noqa: E402
from api_ratelimit_tpu_torch.utils import FakeTimeSource  # noqa: E402

_REF = reference_tests_on_the_port(
    "test_chaos",
    (
        ("api_ratelimit_tpu_torch.backends.tpu", "api_ratelimit_tpu_torch.backends.cuda"),
        ("TpuRateLimitCache", "CudaRateLimitCache"),
        ("use_pallas=False", 'device="cpu"'),
        # the reference's degraded rung, which the port refuses, by name
        ("    FAILURE_MODE_DEGRADED,\n", ""),
        ("    CircuitBreaker,\n    FallbackLimiter,\n)\n", '    CircuitBreaker,\n    FallbackLimiter,\n)\n\nFAILURE_MODE_DEGRADED = "degraded"\n'),
        # the port's ladder has no degraded rung and so no base limiter
        ("        base_limiter=BaseRateLimiter(ts, near_limit_ratio=0.8),\n", ""),
        ("            base_limiter=base,\n", ""),
    ),
)

sidecar_tcp = _REF.sidecar_tcp  # the tcp:// owner fixture the classes take
TestFaultInjectorUnit = _REF.TestFaultInjectorUnit
TestSidecarRetries = _REF.TestSidecarRetries
TestBreakerCycle = _REF.TestBreakerCycle
Code = _REF.Code


class TestFailureModeLadder(_REF.TestFailureModeLadder):
    def test_degraded_mode_keeps_local_enforcement(self, test_store):
        """The reference's degraded rung decides on a process-local limiter
        on the CPU; the port refuses it (ROADMAP "Deliberate departures")."""
        store, _sink = test_store
        with pytest.raises(ValueError, match="failure mode must be one of"):
            _REF._ladder_service(_REF.FAILURE_MODE_DEGRADED, store)


class TestLeaseFailureLadder(_REF.TestLeaseFailureLadder):
    @pytest.mark.parametrize(
        "mode,expected_code",
        [
            (_REF.FAILURE_MODE_DENY, Code.OVER_LIMIT),
            (_REF.FAILURE_MODE_ALLOW, Code.OK),
            (_REF.FAILURE_MODE_DEGRADED, None),
        ],
    )
    def test_exhausted_lease_falls_to_rung(self, test_store, mode, expected_code):
        """The reference's case for deny and allow; its degraded rung is
        refused at construction here."""
        if expected_code is None:
            store, _sink = test_store
            with pytest.raises(ValueError, match="failure mode must be one of"):
                _REF._lease_ladder_service(mode, store)
            return
        super().test_exhausted_lease_falls_to_rung(test_store, mode, expected_code)


@pytest.fixture
def test_store():
    """The port's store (the reference classes read its debug_snapshot)."""
    sink = TestSink()
    return Store(sink), sink


PKGS = {"jax": jax_faults, "port": port_faults}


def _plain(rules) -> list:
    return [dataclasses.asdict(r) for r in rules]


def _parsed(pkg, spec):
    try:
        return "ok", _plain(PKGS[pkg].parse_fault_spec(spec))
    except ValueError as e:
        return "error", str(e)


SPECS = [
    "",
    "  ",
    "a.b:error:1",
    "sidecar.submit:error:0.2,sidecar.submit:delay_ms:500",
    "x:drop:0.5, y:partial_write:0.25 ,z:queue_full:1",
    "fed.exchange:drop:1.0:after=5:times=1",
    "fed.exchange:drop:1.0:after:5:times:1",
    "snapshot.write:corrupt:1.0:times=2:after=3",
    "repl.ship:torn_write:0.4:after=0",
    "dispatch.launch:delay_ms:0",
    "dispatch.launch:delay_ms:2.5e1",
    "a_1.b_2.c_3:error:1e-3",
    ",,a:error:1,,",
    # junk
    "a.b:error",
    "A.b:error:1",
    "a..b:error:1",
    "a.b.:error:1",
    "a b:error:1",
    "a.b:explode:1",
    "a.b:error:0",
    "a.b:error:1.01",
    "a.b:error:-0.5",
    "a.b:error:nan",
    "a.b:error:high",
    "a.b:delay_ms:-1",
    "a.b:error:1:after=-1",
    "a.b:error:1:times=0",
    "a.b:error:1:after=x",
    "a.b:error:1:after",
    "a.b:error:1:times=1:times=2",
    "a.b:error:1:twice=2",
    "a.b:error:1:after:1:bogus",
]


@pytest.mark.parametrize("spec", SPECS)
def test_grammar_is_the_references(spec):
    got, want = _parsed("port", spec), _parsed("jax", spec)
    assert got == want
    if got[0] == "ok":
        rules = port_faults.parse_fault_spec(spec)
        assert port_faults.rules_to_spec(rules) == jax_faults.rules_to_spec(jax_faults.parse_fault_spec(spec))
        assert _plain(port_faults.parse_fault_spec(port_faults.rules_to_spec(rules))) == _plain(rules)


FIRE_SPECS = [
    ("x.y:error:0.5", ("x.y",)),
    ("s:error:0.3,s:drop:0.3,s:delay_ms:2", ("s", "t")),
    ("a:corrupt:0.7:after=100:times=40,b:torn_write:0.2,a:queue_full:0.9", ("a", "b", "c")),
    ("fed.exchange:drop:1.0:after=5:times=1,fed.apply:error:0.05:after=50", ("fed.exchange", "fed.apply")),
    ("dispatch.launch:error:0.01,dispatch.launch:delay_ms:1:times=3,batcher.submit:queue_full:0.5", ("dispatch.launch", "batcher.submit")),
]


def _run(pkg, spec, seed, sites, n):
    slept = []
    inj = PKGS[pkg].FaultInjector.from_spec(spec, seed=seed, sleep=slept.append)
    out = []
    for i in range(n):
        if i == n // 2:
            # reconfigure midway with a new seed, then keep going
            inj.configure(spec, seed=seed + 1)
        out.append(inj.fire(sites[i % len(sites) if i % 7 else 0]))
    doc = inj.describe()
    fired = inj.fired()
    inj.clear()
    after_clear = [inj.fire(s) for s in sites]
    return out, slept, fired, doc, inj.describe(), after_clear, inj.enabled()


@pytest.mark.parametrize("seed", [0, 7, 123456789])
@pytest.mark.parametrize("spec, sites", FIRE_SPECS, ids=[s for s, _ in FIRE_SPECS])
def test_fire_sequences_are_the_references(spec, sites, seed):
    """10^4 fire() calls: the same actions in the same order, the same
    sleeps, counts and documents, in both packages (the per-rule RNG is
    seeded by the same string)."""
    got = _run("port", spec, seed, sites, 10_000)
    want = _run("jax", spec, seed, sites, 10_000)
    assert got == want
    actions = [a for a in got[0] if a is not None]
    assert actions  # the spec trips something
    assert got[6] is False and got[5] == [None] * len(sites)


def test_empty_injector_costs_no_lock():
    """The always-built injector's fast path: with no rules, fire() never
    takes the lock (a held lock does not block it)."""
    inj = port_faults.FaultInjector()
    with inj._lock:
        assert inj.fire("dispatch.launch") is None
    assert not inj.enabled()


# -- /debug/faults and /debug/clock against the JAX Runner ---------------------


def _http(port: int, method: str, path: str, body: bytes | None = None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


ADMIN_CALLS = [
    ("GET", "/debug/faults", None),
    ("POST", "/debug/faults", b"dispatch.launch:error:1,sidecar.submit:delay_ms:5:times=2"),
    ("GET", "/debug/faults", None),
    ("POST", "/debug/faults", b'{"spec": "fed.exchange:corrupt:1:times=1", "seed": 42}'),
    ("POST", "/debug/faults", b"a.b:explode:1"),
    ("POST", "/debug/faults", b"{not json"),
    ("POST", "/debug/faults", b'{"spec": "a:error:1", "seed": "x"}'),
    ("GET", "/debug/faults", None),
    ("POST", "/debug/faults", b""),
    ("GET", "/debug/faults", None),
    ("GET", "/debug/clock", None),
    ("POST", "/debug/clock", b'{"offset_s": 30.5}'),
    ("POST", "/debug/clock", b'{"offset_s": -10, "drift_ppm": 250}'),
    ("POST", "/debug/clock", b'{"offset_s": "soon"}'),
    ("POST", "/debug/clock", b"[1, 2]"),
    ("GET", "/debug/clock", None),
    ("POST", "/debug/clock", b""),
    ("GET", "/debug/clock", None),
    ("POST", "/debug/nope", b"x"),
]


def test_debug_admin_bodies_are_the_references(tmp_path):
    """Both Runners (memory backend) on one fake process clock answer each
    admin call with the same status, content type and body; the index
    lists both endpoints in both."""
    from api_ratelimit_tpu import runner as jax_runner
    from api_ratelimit_tpu import settings as jax_settings
    from api_ratelimit_tpu.utils import timeutil as jax_time
    from api_ratelimit_tpu_torch import runner as port_runner
    from api_ratelimit_tpu_torch import settings as port_settings
    from api_ratelimit_tpu_torch.utils import timeutil as port_time

    (tmp_path / "rl" / "config").mkdir(parents=True)
    env = {
        "BACKEND_TYPE": "memory", "RUNTIME_ROOT": str(tmp_path), "RUNTIME_SUBDIRECTORY": "rl",
        "USE_STATSD": "false", "PORT": "0", "GRPC_PORT": "0", "DEBUG_PORT": "0",
        "FAULT_INJECT": "victim.demote:drop:0.5", "FAULT_INJECT_SEED": "9",
    }
    answers = {}
    try:
        for pkg, rmod, smod, tmod in (
            ("jax", jax_runner, jax_settings, jax_time),
            ("port", port_runner, port_settings, port_time),
        ):
            tmod.install_process_time_source(FakeTimeSource(1_722_300_000))
            runner = rmod.Runner(smod.new_settings(env), **({"device": "cpu"} if pkg == "port" else {}))
            runner.run_background()
            try:
                port = runner.server.debug_port
                answers[pkg] = [_http(port, m, p, b) for m, p, b in ADMIN_CALLS]
                index = _http(port, "GET", "/")[2].decode()
                assert "/debug/faults" in index and "/debug/clock" in index
            finally:
                runner.stop()
    finally:
        jax_time.install_process_time_source(jax_time.RealTimeSource())
        port_time.install_process_time_source(port_time.RealTimeSource())
    assert answers["port"] == answers["jax"]
    statuses = [a[0] for a in answers["port"]]
    assert statuses == [200, 200, 200, 200, 400, 400, 400, 200, 200, 200, 200, 200, 200, 400, 400, 200, 200, 200, 404]
    first = json.loads(answers["port"][0][2])
    assert first["seed"] == 9 and first["rules"][0]["spec"] == "victim.demote:drop:0.5"


# -- OP_FAULTS_SET across the packages ----------------------------------------


def _owner(pkg, faults):
    if pkg == "jax":
        engine = JaxEngine(JaxClock(1_000_000), n_slots=1 << 10, buckets=(128,), use_pallas=False, block_mode=True)
        return jax_sidecar.SlabSidecarServer("tcp://127.0.0.1:0", engine, fault_injector=faults)
    engine = SlabDeviceEngine(FakeTimeSource(1_000_000), n_slots=1 << 10, buckets=(128,), device="cpu", block_mode=True)
    return port_sidecar.SlabSidecarServer("tcp://127.0.0.1:0", engine, fault_injector=faults)


def _admin(client_pkg, address, spec, seed=None):
    mod = {"jax": jax_sidecar, "port": port_sidecar}[client_pkg]
    try:
        return "ok", mod.admin_set_faults(address, spec, seed=seed)
    except Exception as e:  # noqa: BLE001 - each package's CacheError
        return "error", str(e).replace(address, "<owner>")


@pytest.mark.parametrize("owner_pkg, client_pkg", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_faults_set_across_the_packages(owner_pkg, client_pkg):
    """Each admin call against an owner of one package from a client of
    the other answers what the JAX pair answers, and the owner's injector
    takes the rules (its next fire trips them)."""
    calls = [
        ("dispatch.launch:error:1:times=1", None),
        ("fed.apply:drop:1:times=1,sidecar.server.submit:delay_ms:0", 5),
        ("a.b:explode:1", None),
        ("", None),
    ]
    results = {}
    for pair in ((owner_pkg, client_pkg), ("jax", "jax")):
        faults = PKGS[pair[0]].FaultInjector()
        server = _owner(pair[0], faults)
        try:
            address = f"tcp://127.0.0.1:{server.port}"
            out = []
            for spec, seed in calls:
                out.append(_admin(pair[1], address, spec, seed))
                if spec.startswith("dispatch.launch"):
                    out.append(("fire", faults.fire("dispatch.launch"), faults.fire("dispatch.launch")))
            results[pair] = out
        finally:
            server.close()
    got, want = results[(owner_pkg, client_pkg)], results[("jax", "jax")]
    assert got == want
    assert got[0][0] == "ok" and got[1] == ("fire", "error", None)
    assert got[2][1]["seed"] == 5 and got[3][0] == "error" and "explode" in got[3][1]


@pytest.mark.parametrize("owner_pkg, client_pkg", [("port", "jax"), ("jax", "port")])
def test_faults_set_without_an_injector_is_the_references_error(owner_pkg, client_pkg):
    server = _owner(owner_pkg, None)
    try:
        got = _admin(client_pkg, f"tcp://127.0.0.1:{server.port}", "a:error:1")
    finally:
        server.close()
    assert got[0] == "error" and "fault injector not configured on this owner" in got[1]
