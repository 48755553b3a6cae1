"""The port's fingerprinting (api_ratelimit_tpu_torch/ops/hashing.py, its own
pure-Python xxh64) against the JAX package's ops/hashing.py and the xxhash
library: bit-exact, tolerance 0."""

import numpy as np
import pytest

pytest.importorskip("torch")

import xxhash  # noqa: E402

from api_ratelimit_tpu.models.descriptors import Entry  # noqa: E402
from api_ratelimit_tpu.ops import hashing as ref  # noqa: E402
from api_ratelimit_tpu.ops import slab as ref_slab  # noqa: E402
from api_ratelimit_tpu_torch.models.descriptors import Entry as PortEntry  # noqa: E402
from api_ratelimit_tpu_torch.ops import hashing as port  # noqa: E402
from api_ratelimit_tpu_torch.ops import slab as port_slab  # noqa: E402

_ALPHABET = list("abcXYZ019_.-:/ ") + ["é", "ß", "漢", "🙂", "\x00"]


def _random_string(rng, max_len):
    return "".join(rng.choice(_ALPHABET, size=rng.integers(0, max_len + 1)))


def _records(seed, n, max_len=40):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        domain = _random_string(rng, max_len)
        pairs = [
            (_random_string(rng, max_len), _random_string(rng, max_len))
            for _ in range(rng.integers(0, 4))
        ]
        out.append((domain, pairs))
    return out


@pytest.mark.parametrize("length", [0, 1, 3, 4, 7, 8, 15, 31, 32, 33, 63, 64, 100, 1000])
def test_xxh64_matches_xxhash(length):
    rng = np.random.default_rng(length)
    for seed in (0, 1, 60, 3600, int(rng.integers(0, 1 << 63)), (1 << 64) - 1):
        data = rng.integers(0, 256, size=length, dtype=np.uint8).tobytes()
        assert port.xxh64(data, seed) == xxhash.xxh64(data, seed=seed).intdigest()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fingerprint64_random_and_unicode(seed):
    for domain, pairs in _records(seed, 150):
        for divider in (1, 60, 3600, 86400):
            want = ref.fingerprint64(domain, [Entry(k, v) for k, v in pairs], divider)
            got = port.fingerprint64(domain, [PortEntry(k, v) for k, v in pairs], divider)
            assert got == want


def test_fingerprint_separator_embedding_does_not_alias():
    cases = [
        ("d", [("a_b", "c")]),
        ("d", [("a", "b_c")]),
        ("d", [("a", "b"), ("c", "")]),
        ("d_a", [("b", "c")]),
        ("d", [("", "ab"), ("c", "")]),
        ("d\x00", [("a", "b")]),
    ]
    fps = set()
    for domain, pairs in cases:
        want = ref.fingerprint64(domain, [Entry(k, v) for k, v in pairs], 60)
        got = port.fingerprint64(domain, [PortEntry(k, v) for k, v in pairs], 60)
        assert got == want
        fps.add(got)
    assert len(fps) == len(cases)


def test_fingerprint_many_and_split():
    records = _records(7, 64)
    dividers = np.random.default_rng(7).choice([1, 60, 3600, 86400], size=64)
    want = ref.fingerprint_many(
        [(d, [Entry(k, v) for k, v in p]) for d, p in records], dividers
    )
    got = port.fingerprint_many(
        [(d, [PortEntry(k, v) for k, v in p]) for d, p in records], dividers
    )
    assert got.dtype == np.uint64
    assert np.array_equal(got, want)
    for a, b in zip(port.split_fingerprints(got), ref.split_fingerprints(want)):
        assert a.dtype == np.uint32 and np.array_equal(a, b)


def test_set_index_equal():
    lo = np.random.default_rng(3).integers(0, 1 << 32, size=4096, dtype=np.uint64).astype(np.uint32)
    for n_sets in (1, 2, 1024, 1 << 15):
        assert np.array_equal(port.set_index(lo, n_sets), ref.set_index(lo, n_sets))
    with pytest.raises(ValueError):
        port.set_index(lo, 3)


def test_layout_constants_equal():
    names = [
        "ROW_WIDTH", "COL_FP_LO", "COL_FP_HI", "COL_COUNT", "COL_WINDOW",
        "COL_EXPIRE", "COL_DIVIDER", "COL_PREV", "COL_AUX", "ALGO_SHIFT",
        "ALGO_DIV_MASK", "ALGO_FIXED_WINDOW", "ALGO_SLIDING_WINDOW",
        "ALGO_GCRA", "ALGO_CONCURRENCY", "ALGO_CONC_RELEASE", "ALGO_NAMES",
        "GCRA_TAT_CAP_MS", "GCRA_DIV_CAP_S", "DEFAULT_WAYS", "DEFAULT_WAYS_HOST",
        "HEALTH_EVICT_EXPIRED", "HEALTH_EVICT_WINDOW", "HEALTH_EVICT_LIVE",
        "HEALTH_DROPS", "HEALTH_ALGO_RESETS", "HEALTH_WIDTH",
        "SCORE_TIER_SHIFT", "TIER_DEAD", "TIER_WINDOW_ENDED", "TIER_LIVE",
        "EVICT_NONE", "EVICT_EXPIRED", "EVICT_WINDOW", "EVICT_LIVE",
        "ROW_FP_LO", "ROW_FP_HI", "ROW_HITS", "ROW_LIMIT", "ROW_DIVIDER",
        "ROW_JITTER", "ROW_SCALARS", "PACKED_IN_ROWS", "OUT_CODE",
        "OUT_REMAINING", "OUT_DURATION", "OUT_THROTTLE", "OUT_NEAR",
        "OUT_OVER", "OUT_BEFORE", "OUT_AFTER", "OUT_ORDER", "PACKED_OUT_ROWS",
    ]
    for name in names:
        assert getattr(port_slab, name) == getattr(ref_slab, name), name
    assert port_slab.default_ways("cuda") == 128
    assert port_slab.default_ways("cpu") == ref_slab.default_ways("cpu")
