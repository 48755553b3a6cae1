"""The one traffic generator: a configuration and a traffic mix (both data
files) and a seed make a pool of wire blocks. NumPy only.

A pool is `uint32[n_blocks, 6, block_rows]`, each block the sidecar wire's
row block (fp_lo, fp_hi, hits, limit, divider word, expiry jitter), plus the
key id of every row. Frontend f owns blocks [f * n / F, (f + 1) * n / F) and
walks them in turn, so no block is in flight twice at once and nothing is
generated inside the measured window.

A key's rule comes from the configuration's `rules`, by its id in mixed
radix: algorithm `algorithms[id % A]`, limit `limits[(id // A) % L]`, window
`windows_s[(id // (A * L)) % Wn]`; a concurrency rule's window is its
`concurrency_ttl_s`. A share `release_share` of the concurrency rows are
releases. The divider word carries the window in bits 0-27 and the
algorithm id in bits 28-30, as the wire does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .keys import fingerprints, uniform_ranks, zipf_ranks
from .reference import ALGO_SHIFT, ALGORITHMS, CONCURRENCY, RELEASE

FP_LO, FP_HI, HITS, LIMIT, DIVIDER, JITTER = range(6)


@dataclass
class Pool:
    blocks: np.ndarray  # uint32[n_blocks, 6, block_rows]
    ids: np.ndarray  # int32[n_blocks, block_rows] key ids
    frontends: int

    @property
    def n_blocks(self) -> int:
        return self.blocks.shape[0]

    @property
    def block_rows(self) -> int:
        return self.blocks.shape[2]

    def frontend_blocks(self, f: int) -> range:
        per = self.n_blocks // self.frontends
        return range(f * per, (f + 1) * per)


def rule_columns(config: dict, ids: np.ndarray):
    """(limit, divider word, is concurrency) of each key id."""
    rules = config["rules"]
    algos = np.array([ALGORITHMS[a] for a in rules["algorithms"]], dtype=np.int64)
    limits = np.array(rules["limits"], dtype=np.int64)
    windows = np.array(rules["windows_s"], dtype=np.int64)
    a, l_ = algos.size, limits.size
    algo = algos[ids % a]
    limit = limits[(ids // a) % l_]
    window = windows[(ids // (a * l_)) % windows.size]
    window = np.where(algo == CONCURRENCY, int(rules["concurrency_ttl_s"]), window)
    return limit, window | (algo << ALGO_SHIFT), algo == CONCURRENCY


def make_pool(config: dict, traffic: dict, seed: int, pool_rows: int | None = None) -> Pool:
    """The pool of `pool_rows` rows (the mix's own by default) for `seed`."""
    rng = np.random.default_rng(seed)
    n = int(pool_rows or traffic["pool_rows"])
    rows = int(traffic["block_rows"])
    frontends = int(traffic["frontends"])
    if n % (rows * frontends):
        raise ValueError(f"pool_rows {n} is not a whole number of blocks for every frontend")
    keys = int(config["keys"])
    if traffic["keys"] == "zipf":
        ids = zipf_ranks(rng, keys, float(traffic["zipf_constant"]), n)
    elif traffic["keys"] == "uniform":
        ids = uniform_ranks(rng, keys, n)
    else:
        raise ValueError(f"unknown key draw {traffic['keys']!r}")
    salt = int(rng.integers(0, 1 << 63))
    fp_lo, fp_hi = fingerprints(ids, salt)
    limit, word, conc = rule_columns(config, ids)
    release = conc & (rng.random(n) < float(traffic.get("release_share", 0.0)))
    word = np.where(release, (word & ((1 << ALGO_SHIFT) - 1)) | (RELEASE << ALGO_SHIFT), word)
    jitter_max = int(config["settings"].get("EXPIRATION_JITTER_MAX_SECONDS", "0"))
    jitter = rng.integers(0, jitter_max, n) if jitter_max > 0 else np.zeros(n, np.int64)
    n_blocks = n // rows
    blocks = np.empty((n_blocks, 6, rows), dtype=np.uint32)
    for col, values in ((FP_LO, fp_lo), (FP_HI, fp_hi), (LIMIT, limit), (DIVIDER, word), (JITTER, jitter)):
        blocks[:, col] = values.reshape(n_blocks, rows)
    blocks[:, HITS] = int(traffic["hits"])
    return Pool(
        blocks=blocks,
        ids=ids.astype(np.int32).reshape(n_blocks, rows),
        frontends=frontends,
    )
