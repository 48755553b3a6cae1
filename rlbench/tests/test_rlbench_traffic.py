"""The traffic pool: fixed by the seed, and the key draws it rests on."""

import numpy as np
import pytest

from rlbench import manifest as mf
from rlbench.keys import fingerprints, uniform_ranks, zeta, zipf_ranks, zipf_top_share
from rlbench.pool import DIVIDER, FP_LO, LIMIT, make_pool, rule_columns
from rlbench.reference import ALGO_SHIFT, RELEASE
from rlbench_helpers import ALGOS_CONFIG


def _algos():
    import json

    with open(ALGOS_CONFIG) as f:
        return json.load(f)

BIG_SEED = 2**31 + 12345


@pytest.mark.parametrize("traffic", ["zipf", "uniform"])
@pytest.mark.parametrize("config", ["owner_fixed", "algos.test"])
def test_pool_is_fixed_by_the_seed(config, traffic):
    cfg = _algos() if config == "algos.test" else mf.config(mf.load(), config)
    mix = mf.traffic(traffic)
    a = make_pool(cfg, mix, BIG_SEED, pool_rows=1 << 17)
    b = make_pool(cfg, mix, BIG_SEED, pool_rows=1 << 17)
    c = make_pool(cfg, mix, BIG_SEED + 1, pool_rows=1 << 17)
    assert np.array_equal(a.blocks, b.blocks) and np.array_equal(a.ids, b.ids)
    assert not np.array_equal(a.blocks, c.blocks)
    rows, frontends = mix["block_rows"], mix["frontends"]
    assert a.blocks.shape == ((1 << 17) // rows, 6, rows) and a.blocks.flags.c_contiguous
    assert a.frontends == frontends
    owned = [set(a.frontend_blocks(f)) for f in range(frontends)]
    assert set.union(*owned) == set(range(a.n_blocks)) and sum(map(len, owned)) == a.n_blocks


def test_zipf_top_share_matches_its_formula():
    n, theta, size = 10_000_000, 0.99, 1 << 22
    ranks = zipf_ranks(np.random.default_rng(1), n, theta, size)
    share0 = zipf_top_share(n, theta)
    # binomial standard error of the observed share, four of them
    for rank, p in ((0, share0), (1, share0 * 2 ** -theta)):
        observed = np.mean(ranks == rank)
        assert abs(observed - p) < 4 * np.sqrt(p * (1 - p) / size), (rank, observed, p)
    assert ranks.min() >= 0 and ranks.max() < n
    assert 0.054 < share0 < 0.057  # 1 / zeta(10^7, 0.99)


def test_zeta_by_direct_sum():
    assert zeta(1000, 0.5) == pytest.approx(float(np.sum(np.arange(1, 1001) ** -0.5)))


def test_uniform_and_fingerprints():
    ids = uniform_ranks(np.random.default_rng(2), 1000, 100_000)
    assert ids.min() == 0 and ids.max() == 999
    lo, hi = fingerprints(np.arange(1 << 16), 7)
    pairs = (hi.astype(np.uint64) << np.uint64(32)) | lo
    assert np.unique(pairs).size == 1 << 16
    lo2, _ = fingerprints(np.arange(1 << 16), 8)
    assert not np.array_equal(lo, lo2)


def test_rules_in_mixed_radix():
    cfg = _algos()
    ids = np.arange(36)
    limit, word, conc = rule_columns(cfg, ids)
    algo = word >> ALGO_SHIFT
    window = word & ((1 << ALGO_SHIFT) - 1)
    assert list(algo[:4]) == [0, 1, 2, 3]
    assert list(limit[[0, 4, 8]]) == [5, 100, 1000]
    assert list(window[[0, 12, 24]]) == [1, 60, 3600]
    assert all(window[conc] == 60)


def test_releases_only_on_concurrency_keys():
    cfg = _algos()
    pool = make_pool(cfg, mf.traffic("zipf"), 3, pool_rows=1 << 17)
    algo = pool.blocks[:, DIVIDER] >> ALGO_SHIFT
    release = algo == RELEASE
    assert release.any()
    assert np.all(pool.ids[release] % 4 == 3)
    share = release.sum() / np.sum(pool.ids % 4 == 3)
    assert 0.08 < share < 0.12
    fixed = make_pool(mf.config(mf.load(), "owner_fixed"), mf.traffic("zipf"), 3, pool_rows=1 << 17)
    assert np.all(fixed.blocks[:, LIMIT] == 10) and np.all(fixed.blocks[:, DIVIDER] == 1)
    assert fixed.blocks[:, FP_LO].dtype == np.uint32
