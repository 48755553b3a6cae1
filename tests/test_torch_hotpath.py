"""The port's production-default serving path on the CPU against the JAX
package: the compiled matcher (config/compiled.py) record for record, and a
/json stream through both servers with the host fast path on and the
heavy-hitter sketch at HOTKEY_LANES=128, HOTKEY_K=16 (status, body bytes,
slab bytes, sketch planes, the drained /debug/hotkeys document and the slab
health gauges), plus the trie arm (host_fast_path=False)."""

import http.client
import json
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_service import N_SLOTS, NOW0, RULES, WAYS, _post, _Runtime, _stream  # noqa: E402

from api_ratelimit_tpu.backends.tpu import HotkeyStats as JHotkeyStats  # noqa: E402
from api_ratelimit_tpu.backends.tpu import SlabHealthStats as JSlabHealthStats  # noqa: E402
from api_ratelimit_tpu.backends.tpu import TpuRateLimitCache  # noqa: E402
from api_ratelimit_tpu.config.loader import ConfigFile as JConfigFile  # noqa: E402
from api_ratelimit_tpu.config.loader import load_config as j_load_config  # noqa: E402
from api_ratelimit_tpu.limiter import BaseRateLimiter, LocalCache  # noqa: E402
from api_ratelimit_tpu.models import descriptors as JD  # noqa: E402
from api_ratelimit_tpu.server.http_server import HttpServer, add_json_handler  # noqa: E402
from api_ratelimit_tpu.server.http_server import new_debug_server as j_new_debug_server  # noqa: E402
from api_ratelimit_tpu.service import RateLimitService  # noqa: E402
from api_ratelimit_tpu.stats import Store  # noqa: E402
from api_ratelimit_tpu.utils import FakeTimeSource  # noqa: E402
from api_ratelimit_tpu.utils.sampler import BasicSampler  # noqa: E402
from api_ratelimit_tpu_torch.backends.cuda import CudaRateLimitCache, HotkeyStats, SlabHealthStats  # noqa: E402
from api_ratelimit_tpu_torch.config import ConfigFile, load_config  # noqa: E402
from api_ratelimit_tpu_torch.limiter import BaseRateLimiter as PBase  # noqa: E402
from api_ratelimit_tpu_torch.limiter import LocalCache as PLocal  # noqa: E402
from api_ratelimit_tpu_torch.models import descriptors as PD  # noqa: E402
from api_ratelimit_tpu_torch.models.units import Unit  # noqa: E402
from api_ratelimit_tpu_torch.server.http_server import HttpServer as PortServer  # noqa: E402
from api_ratelimit_tpu_torch.server.http_server import new_debug_server  # noqa: E402
from api_ratelimit_tpu_torch.service import RateLimitService as PortService  # noqa: E402
from api_ratelimit_tpu_torch.stats import Store as PStore  # noqa: E402
from api_ratelimit_tpu_torch.utils import FakeTimeSource as PFake  # noqa: E402
from api_ratelimit_tpu_torch.utils.sampler import BasicSampler as PBasic  # noqa: E402

MATCHER_RULES = """
domain: d1
descriptors:
  - key: a
    rate_limit: {unit: second, requests_per_unit: 5}
    descriptors:
      - key: b
        value: v
        rate_limit: {unit: minute, requests_per_unit: 7}
      - key: deep
        descriptors:
          - key: k_
            rate_limit: {unit: day, requests_per_unit: 9}
  - key: a_b
    shadow_mode: true
    rate_limit: {unit: hour, requests_per_unit: 3}
  - key: key1
    value: "1"
    sleep_on_throttle: true
    report_details: true
    rate_limit: {unit: minute, requests_per_unit: 11}
  - key: key1
    rate_limit: {unit: hour, requests_per_unit: 13}
  - key: x_y_z
    rate_limit: {unit: second, requests_per_unit: 2, algorithm: sliding_window}
  - key: conc
    rate_limit: {requests_per_unit: 4, algorithm: concurrency}
"""
MATCHER_RULES_2 = """
domain: d2
descriptors:
  - key: a
    value: b
    rate_limit: {unit: minute, requests_per_unit: 17}
  - key: deep
    rate_limit: {unit: day, requests_per_unit: 19, algorithm: gcra}
"""
_KEYS = ["a", "b", "key1", "a_b", "k_", "x_y_z", "deep", "conc"]
_VALUES = ["", "v", "1", "b", "a_b", "y_z"]
_FIELDS = (
    "fp", "fp_lo", "fp_hi", "key_prefix", "divider", "wire_divider",
    "requests_per_unit", "shadow_mode", "sleep_on_throttle", "report_details",
    "per_second", "algorithm",
)


def _record_view(rec):
    if rec is None:
        return None
    view = tuple(getattr(rec, f) for f in _FIELDS)
    return view + (rec.limit.full_key, rec.limit.algorithm, int(rec.limit.unit))


def test_compiled_matcher_matches_reference():
    """A few hundred seeded descriptors: wildcard and exact rules, nested
    levels, the "a_b" <-> ("a", "b") aliasing quirk, unknown domains and
    request overrides, each resolved twice (memo miss, then hit)."""
    files = [("config.one", MATCHER_RULES), ("config.two", MATCHER_RULES_2)]
    jcfg = j_load_config([JConfigFile(n, c) for n, c in files], Store().scope("rl"))
    pcfg = load_config([ConfigFile(n, c) for n, c in files], PStore().scope("rl"))
    rng = random.Random(2)
    seen = set()
    for _ in range(400):
        domain = rng.choice(["d1", "d1", "d2", "nope"])
        pairs = [(rng.choice(_KEYS), rng.choice(_VALUES)) for _ in range(rng.randint(1, 3))]
        override = None
        if rng.random() < 0.2:
            override = (rng.randint(1, 100), rng.choice([1, 2, 3, 4]))
        jd = JD.Descriptor(
            entries=tuple(JD.Entry(k, v) for k, v in pairs),
            limit=None if override is None else JD.LimitOverride(override[0], override[1]),
        )
        pd = PD.Descriptor(
            entries=tuple(PD.Entry(k, v) for k, v in pairs),
            limit=None if override is None else PD.LimitOverride(override[0], Unit(override[1])),
        )
        for _twice in range(2):
            want = _record_view(jcfg.compiled.resolve(domain, jd))
            got = _record_view(pcfg.compiled.resolve(domain, pd))
            assert got == want, (domain, pairs, override)
        limit = pcfg.get_limit(domain, pd)
        assert (limit is None) == (got is None)
        if got is not None and override is None:
            assert pcfg.compiled.resolve(domain, pd).limit is limit
        seen.add(None if got is None else (got[3], got[-3]))
    # the quirk: a bare config key "a_b" answers the entry ("a", "b")
    alias = pcfg.compiled.resolve("d1", PD.Descriptor.of(("a", "b")))
    assert alias is not None and alias.limit.full_key == "d1.a_b" and alias.shadow_mode
    assert len(seen) > 15


HOT_RULES = RULES + """
  - key: tenant
    rate_limit: {unit: hour, requests_per_unit: 1000000}
"""


def _hot_stream():
    """The service stream plus one dominating descriptor, woven in."""
    out = []
    for i, (advance, body) in enumerate(_stream()):
        out.append((advance, body))
        if i % 2 == 0:
            out.append((0, json.dumps({"domain": "api", "descriptors": [{"entries": [{"key": "tenant", "value": "acme"}]}]}).encode()))
    return out


def _servers(fast_path: bool, lanes: int):
    ts_ref, ts_port = FakeTimeSource(NOW0), PFake(NOW0)
    rules = {"config.rules": HOT_RULES}
    base = BaseRateLimiter(ts_ref, local_cache=LocalCache(1000, ts_ref), near_limit_ratio=0.8)
    ref_cache = TpuRateLimitCache(base, n_slots=N_SLOTS, ways=WAYS, use_pallas=False, hotkey_lanes=lanes, hotkey_k=16, buckets=(128, 1024))
    ref_store = Store()
    ref_svc = RateLimitService(_Runtime(rules), ref_cache, ref_store.scope("ratelimit"), ts_ref, report_detail_sampler=BasicSampler(1), host_fast_path=fast_path)
    ref = HttpServer("127.0.0.1", 0, "ref")
    add_json_handler(ref, ref_svc)
    pbase = PBase(ts_port, local_cache=PLocal(1000, ts_port), near_limit_ratio=0.8)
    port_cache = CudaRateLimitCache(pbase, n_slots=N_SLOTS, ways=WAYS, buckets=(128, 1024), device="cpu", hotkey_lanes=lanes, hotkey_k=16)
    port_store = PStore()
    port_svc = PortService(_Runtime(rules), port_cache, port_store.scope("ratelimit"), ts_port, report_detail_sampler=PBasic(1), host_fast_path=fast_path)
    return (ts_ref, ref, ref_cache, ref_store), (ts_port, PortServer(port_svc), port_cache, port_store)


def _drive(ref_side, port_side):
    (ts_ref, ref, _, _), (ts_port, port, _, _) = ref_side, port_side
    ref.serve_background()
    port.serve_background()
    statuses = set()
    try:
        for advance, body in _hot_stream():
            ts_ref.advance(advance)
            ts_port.advance(advance)
            s_ref, b_ref = _post(ref.port, body)
            s_port, b_port = _post(port.port, body)
            assert s_port == s_ref, (body, b_ref, b_port)
            statuses.add(s_ref)
            if s_ref in (200, 429):
                assert b_port == b_ref, body
    finally:
        ref.shutdown()
        port.shutdown()
    assert {200, 429, 400, 500} <= statuses
    want = ref_side[2].engine.export_tables()[0]
    assert np.array_equal(port_side[2].engine.export_tables()[0], np.asarray(want))


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_json_fast_path_with_hotkeys_matches_reference():
    ref_side, port_side = _servers(fast_path=True, lanes=128)
    _drive(ref_side, port_side)
    ref_cache, ref_store = ref_side[2], ref_side[3]
    port_cache, port_store = port_side[2], port_side[3]
    assert port_cache.engine.hotkeys_enabled
    planes = port_cache.engine.export_sketch()
    assert planes.shape == (3, 128)
    assert np.array_equal(planes, np.asarray(ref_cache.engine._sketch))

    # the stats cadence: one drain on each side, then the debug documents
    JHotkeyStats(ref_cache.engine, ref_store.scope("ratelimit").scope("hotkeys")).generate_stats()
    hot_gen = HotkeyStats(port_cache.engine, port_store.scope("ratelimit").scope("hotkeys"))
    hot_gen.generate_stats()
    doc = port_cache.hotkeys_debug()
    assert doc == ref_cache.hotkeys_debug()
    assert doc["enabled"] and doc["lanes"] == 128 and doc["k"] == 16 and doc["drains"] == 1
    assert doc["top"][0]["key"] == "api_tenant_acme_"
    assert np.array_equal(port_cache.engine.export_sketch(), np.asarray(ref_cache.engine._sketch))

    # /debug/hotkeys as the runner mounts it, on both debug ports
    jdbg = j_new_debug_server("127.0.0.1", 0, ref_store)
    jdbg.add_get("/debug/hotkeys", lambda h: h._write(200, json.dumps(ref_cache.hotkeys_debug(), indent=2).encode()))
    pdbg = new_debug_server(port_store)
    pdbg.add_debug_endpoint("/debug/hotkeys", lambda: json.dumps(port_cache.hotkeys_debug(), indent=2))
    port_store.add_stat_generator(hot_gen)
    port_store.add_stat_generator(SlabHealthStats(port_cache.engine, port_store.scope("ratelimit").scope("slab")))
    JSlabHealthStats(ref_cache.engine, ref_store.scope("ratelimit").scope("slab")).generate_stats()
    jdbg.serve_background()
    pdbg.serve_background()
    try:
        s_j, b_j = _get(jdbg.port, "/debug/hotkeys")
        s_p, b_p = _get(pdbg.port, "/debug/hotkeys")
        assert s_p == s_j == 200 and b_p == b_j
        s_idx, idx = _get(pdbg.port, "/")
        assert s_idx == 200 and b"/debug/hotkeys" in idx and b"/stats" in idx
        assert _get(pdbg.port, "/nope")[0] == 404
        s_st, stats = _get(pdbg.port, "/stats")  # runs the generators: a second drain
    finally:
        jdbg.shutdown()
        pdbg.shutdown()
    assert s_st == 200
    stats = json.loads(stats)
    assert stats["ratelimit.hotkeys.drains"] == 2 and stats["ratelimit.hotkeys.tracked"] >= 1
    ref_stats = ref_store.debug_snapshot()
    slab_keys = [k for k in stats if k.startswith("ratelimit.slab.")]
    assert len(slab_keys) == 10  # the reference's ten, the watermark gauge included
    assert {k: stats[k] for k in slab_keys} == {k: ref_stats[k] for k in slab_keys}


def test_json_trie_arm_matches_reference():
    """host_fast_path=False, sketch off: the trie walk and do_limit."""
    ref_side, port_side = _servers(fast_path=False, lanes=0)
    _drive(ref_side, port_side)
    assert port_side[2].engine.export_sketch() is None
    assert port_side[2].hotkeys_debug()["top"] == []
