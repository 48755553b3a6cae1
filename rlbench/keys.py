"""Key draws and fingerprints of the benchmark's traffic: NumPy only.

zipf_ranks is YCSB's ZipfianGenerator (core/src/main/java/site/ycsb/
generator/ZipfianGenerator.java, after Gray et al., "Quickly generating
billion-record synthetic databases", SIGMOD 1994): a bounded Zipf over
exactly n items, rank 0 the most popular. Its rank 0 comes with probability
1 / zeta(n, theta) and its rank 1 with 2^-theta / zeta(n, theta), exactly;
the tail follows the generator's closed form.

fingerprints are the benchmark's own 64-bit hash of a key id (splitmix64's
finalizer over the id and a salt from the seed), split into the wire's two
uint32 words. The program never sees a key id, only these words.
"""

from __future__ import annotations

import numpy as np

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def zeta(n: int, theta: float) -> float:
    """sum_{i=1..n} i^-theta, in float64, summed a million terms at a time."""
    total = 0.0
    for start in range(1, n + 1, 1 << 20):
        i = np.arange(start, min(n, start + (1 << 20) - 1) + 1, dtype=np.float64)
        total += float(np.sum(i ** -theta))
    return total


def zipf_ranks(rng: np.random.Generator, n: int, theta: float, size: int) -> np.ndarray:
    """int64[size] ranks in [0, n), YCSB's zipfian draw with constant theta."""
    zetan = zeta(n, theta)
    zeta2 = 1.0 + 2.0 ** -theta
    alpha = 1.0 / (1.0 - theta)
    eta = (1.0 - (2.0 / n) ** (1.0 - theta)) / (1.0 - zeta2 / zetan)
    u = rng.random(size)
    uz = u * zetan
    ranks = (n * np.power(eta * u - eta + 1.0, alpha)).astype(np.int64)
    ranks = np.where(uz < 1.0 + 0.5 ** theta, 1, ranks)
    ranks = np.where(uz < 1.0, 0, ranks)
    return np.clip(ranks, 0, n - 1)


def zipf_top_share(n: int, theta: float) -> float:
    """The share of draws that rank 0 takes: 1 / zeta(n, theta)."""
    return 1.0 / zeta(n, theta)


def uniform_ranks(rng: np.random.Generator, n: int, size: int) -> np.ndarray:
    """int64[size] ids uniform over [0, n) (YCSB's `uniform`)."""
    return rng.integers(0, n, size=size, dtype=np.int64)


def fingerprints(ids: np.ndarray, salt: int) -> tuple[np.ndarray, np.ndarray]:
    """(fp_lo, fp_hi) uint32 words of each key id under `salt`."""
    with np.errstate(over="ignore"):
        z = np.asarray(ids, dtype=np.uint64) * _GOLDEN + np.uint64(salt)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    return (z & np.uint64(0xFFFFFFFF)).astype(np.uint32), (z >> np.uint64(32)).astype(np.uint32)
