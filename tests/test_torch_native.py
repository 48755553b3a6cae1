"""The port's native host codec (api_ratelimit_tpu_torch/ops/native.py over
its own build of csrc/host_codec.cpp) on the CPU, against the JAX package's.

* The JAX package's tests/test_native.py runs on the port's build
  (reference_tests_on_the_port): pack_rows/scatter_rows against the numpy
  copies and their bounds checks, xxh64 and the batched fingerprints
  against the Python hash, fingerprint_many's dispatch, compose_keys_batch
  and generate_cache_keys against the Python key codec, the output buffer's
  growth.
* The port's .so and the JAX package's .so, two builds of one source, give
  identical outputs on the same seeded inputs for every entry point.
* The compiled matcher's native memo-miss walk (rl_match_batch) resolves
  like the tree walker over seeded random configs, and like the JAX
  package's native walk on the same configs.
* The dispatch loop scatters verdicts and the engine gathers row blocks
  through the codec, with the Python path's results.
"""

import ctypes
import os
import random

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from test_torch_victim import reference_tests_on_the_port  # noqa: E402

from api_ratelimit_tpu.config import loader as jax_loader  # noqa: E402
from api_ratelimit_tpu.ops import native as jax_native  # noqa: E402
from api_ratelimit_tpu.stats import Store as JaxStore  # noqa: E402
from api_ratelimit_tpu.stats.sinks import NullSink as JaxNullSink  # noqa: E402
from api_ratelimit_tpu_torch.config import loader as port_loader  # noqa: E402
from api_ratelimit_tpu_torch.models.config import ConfigError  # noqa: E402
from api_ratelimit_tpu_torch.models.descriptors import Descriptor, Entry  # noqa: E402
from api_ratelimit_tpu_torch.ops import native  # noqa: E402
from api_ratelimit_tpu_torch.stats import Store  # noqa: E402
from api_ratelimit_tpu_torch.stats.sinks import NullSink  # noqa: E402

_REF = reference_tests_on_the_port("test_native")

TestPackScatterParity = _REF.TestPackScatterParity
TestXxh64Parity = _REF.TestXxh64Parity
TestFingerprintBatchParity = _REF.TestFingerprintBatchParity
TestComposeKeysParity = _REF.TestComposeKeysParity


def test_the_port_builds_its_own_library():
    """The port's .so lives in its own package, built from its own copy of
    the source: the port loads nothing of the JAX package."""
    info = native.build_info()
    assert info["available"] and info["source_present"]
    assert "api_ratelimit_tpu_torch" in info["so_path"]
    assert info["so_path"] != jax_native.build_info()["so_path"]
    assert native._SRC.endswith(os.path.join("api_ratelimit_tpu_torch", "csrc", "host_codec.cpp"))


def _records(rng: random.Random, n: int):
    alphabet = "ab_xyz09-./"
    out = []
    for _ in range(n):
        strings = ["".join(rng.choice(alphabet) for _ in range(rng.randrange(0, 12)))]
        for _ in range(rng.randrange(1, 4)):
            strings.append("".join(rng.choice(alphabet) for _ in range(rng.randrange(0, 10))))
            strings.append("".join(rng.choice(alphabet) for _ in range(rng.randrange(0, 10))))
        out.append(strings)
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_both_builds_fingerprint_and_compose_alike(seed):
    rng = random.Random(seed)
    records = _records(rng, 300)
    seeds = [rng.choice([1, 60, 3600, 86400, 1 << 31]) for _ in records]
    windows = [rng.randrange(-5, 1 << 40) for _ in records]
    got = native.fingerprint_batch(records, seeds)
    want = jax_native.fingerprint_batch(records, seeds)
    assert got.tolist() == want.tolist()
    assert native.compose_keys_batch(records, windows) == jax_native.compose_keys_batch(records, windows)
    data = os.urandom(rng.randrange(0, 200))
    assert native.xxh64(data, seed) == jax_native.xxh64(data, seed)


@pytest.mark.parametrize("seed", [4, 5])
def test_both_builds_pack_and_scatter_alike(seed):
    rng = np.random.default_rng(seed)
    arena = rng.integers(0, 1 << 32, (7, 4096), dtype=np.uint32)
    counts = rng.integers(1, 300, 12)
    blocks, off = [], 0
    for c in counts:
        blocks.append(arena[0:6, off : off + c])
        off += int(c)
    total = int(counts.sum())
    outs = []
    for mod in (native, jax_native):
        dst = np.zeros((7, 4096), dtype=np.uint32)
        mod.pack_rows(blocks, dst, total)
        src = rng.integers(0, 1 << 32, total, dtype=np.uint32) if mod is native else outs[0][1]
        dsts = [np.zeros(int(c), dtype=np.uint32) for c in counts]
        mod.scatter_rows(src, dsts, counts)
        outs.append((dst, src, dsts))
    (d0, _s, x0), (d1, _s1, x1) = outs
    assert np.array_equal(d0, d1)
    assert np.array_equal(d0[:6, :total], np.concatenate(blocks, axis=1))
    assert all(np.array_equal(a, b) for a, b in zip(x0, x1))


_KEYS = ["a", "b", "key1", "a_b", "k_", "x_y_z", "deep"]
_VALUES = ["", "v", "1", "b", "a_b", "with_underscore", "y_z"]


def _descriptor_config(rng, depth):
    desc = {"key": rng.choice(_KEYS)}
    value = rng.choice(_VALUES)
    if value:
        desc["value"] = value
    if rng.random() < 0.7:
        desc["rate_limit"] = {
            "unit": rng.choice(["second", "minute", "hour", "day"]),
            "requests_per_unit": rng.randrange(0, 50),
        }
    if depth > 0 and rng.random() < 0.6:
        desc["descriptors"] = [_descriptor_config(rng, depth - 1) for _ in range(rng.randrange(1, 3))]
    return desc


def _configs(seed: int, count: int):
    """(port config, JAX config) pairs loaded from the same random YAML."""
    rng = random.Random(seed)
    out = []
    while len(out) < count:
        tree = {
            "domain": rng.choice(["d1", "d2", "dom_x"]),
            "descriptors": [_descriptor_config(rng, 2) for _ in range(rng.randrange(1, 4))],
        }
        text = yaml.safe_dump(tree)
        try:
            port_cfg = port_loader.load_config(
                [port_loader.ConfigFile(name="fuzz.yaml", contents=text)], Store(NullSink()).scope("rl")
            )
        except ConfigError:
            continue
        jax_cfg = jax_loader.load_config(
            [jax_loader.ConfigFile(name="fuzz.yaml", contents=text)], JaxStore(JaxNullSink()).scope("rl")
        )
        out.append((port_cfg, jax_cfg))
    return out


def test_native_matcher_resolves_like_the_walker_and_the_reference():
    """match_uncached (rl_match_batch) is the memo-miss path: it must map
    back to the very RateLimit object the port's trie walk finds, and name
    the same rule as the JAX package's native walk on the same config."""
    from api_ratelimit_tpu.models.descriptors import Descriptor as JaxDescriptor
    from api_ratelimit_tpu.models.descriptors import Entry as JaxEntry

    configs = _configs(4321, 30)
    assert all(p.compiled.native_active and j.compiled.native_active for p, j in configs)
    rng = random.Random(99)
    hits = 0
    for _ in range(12000):
        port_cfg, jax_cfg = rng.choice(configs)
        domain = rng.choice(["d1", "d2", "dom_x", "missing"])
        pairs = [(rng.choice(_KEYS), rng.choice(_VALUES)) for _ in range(rng.randrange(1, 4))]
        descriptor = Descriptor(entries=tuple(Entry(k, v) for k, v in pairs))
        got = port_cfg.compiled.match_uncached(domain, descriptor)
        assert got is port_cfg.get_limit(domain, descriptor)
        want = jax_cfg.compiled.match_uncached(
            domain, JaxDescriptor(entries=tuple(JaxEntry(k, v) for k, v in pairs))
        )
        assert (got is None) == (want is None)
        if got is not None:
            hits += 1
            assert got.full_key == want.full_key
            assert got.limit.requests_per_unit == want.limit.requests_per_unit
    assert hits >= 20


def test_dispatch_loop_scatters_through_the_codec():
    from api_ratelimit_tpu_torch.backends.dispatch import DispatchLoop

    calls = []
    real = native.scatter_rows

    def counting(*a):
        calls.append(len(a[1]))
        return real(*a)

    loop = DispatchLoop(lambda blocks: [b[2].copy() for b in blocks], lambda t: np.concatenate(t))
    loop._scatter = counting
    frames = [np.full((6, k), k, dtype=np.uint32) for k in (1, 2, 3)]
    try:
        out = loop._launch([f for f in frames])
        n = sum(f.shape[1] for f in frames)

        class _T:
            def __init__(self):
                self.buf = None

            def reserve(self, count):
                self.buf = np.empty(count, dtype=np.uint32)
                return self.buf

            def resolve(self):
                pass

        tickets = [_T() for _ in frames]
        loop._redeem(out, [(f, f.shape[1], t, None) for f, t in zip(frames, tickets)], n, None, None)
        assert calls == [3]
        assert [t.buf.tolist() for t in tickets] == [[1], [2, 2], [3, 3, 3]]
    finally:
        loop.close()


def test_engine_gathers_row_blocks_through_the_codec():
    from api_ratelimit_tpu_torch.backends.cuda import SlabDeviceEngine
    from api_ratelimit_tpu_torch.utils import FakeTimeSource

    engine = SlabDeviceEngine(FakeTimeSource(1_000_000), n_slots=1 << 10, ways=4, buckets=(8, 128), device="cpu")
    calls = []
    real = engine._pack_rows
    assert real is not None

    def counting(blocks, dst, total):
        calls.append(total)
        return real(blocks, dst, total)

    engine._pack_rows = counting
    try:
        blocks = [np.array([[i], [0], [1], [5], [60], [0]], dtype=np.uint32) for i in range(1, 4)]
        blocks.append(np.array([[1], [0], [2], [5], [60], [0]], dtype=np.uint32))
        assert engine._execute_blocks(blocks).tolist() == [1, 1, 1, 3]
        assert calls == [4]
    finally:
        engine.close()


def test_codec_entry_points_exist_in_the_port_build():
    lib = native.lib()
    for name in ("rl_xxh64", "rl_fingerprint_batch", "rl_compose_keys", "rl_match_batch", "rl_pack_rows", "rl_scatter_rows"):
        assert isinstance(getattr(lib, name), ctypes._CFuncPtr)
