"""Exact-oracle parity for the decided stream: a numpy-only copy of
api_ratelimit_tpu/testing/oracle.py occurrence_rank and parity_report.

The oracle is a single-window, uniform-limit stream: the k-th occurrence
of a key (k from 1) is over the limit exactly when k > limit. The slab's
losses (live evictions, in-batch contention drops) all fail open, so an
engine may answer OK where the oracle says OVER, never the reverse.
"""

from __future__ import annotations

import numpy as np


def occurrence_rank(ids: np.ndarray) -> np.ndarray:
    """rank[i] = how many earlier stream positions hold the same id.
    Vectorized (argsort + run detection); O(n log n)."""
    n = ids.shape[0]
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]
    starts = np.r_[0, np.flatnonzero(sorted_ids[1:] != sorted_ids[:-1]) + 1]
    run_marker = np.zeros(n, dtype=np.int64)
    run_marker[starts] = 1
    run_id = np.cumsum(run_marker) - 1
    rank_sorted = np.arange(n, dtype=np.int64) - starts[run_id]
    rank = np.empty(n, dtype=np.int64)
    rank[order] = rank_sorted
    return rank


def parity_report(
    ids: np.ndarray, got_codes: np.ndarray, limit: int, code_over: int = 2
) -> dict:
    """Compare engine codes against the exact oracle for a single-window
    uniform-limit stream. Returns the agreement rate and the one-sided
    error split: false_over (engine OVER where the oracle says OK) must be
    0; false_ok is the cost of the slab's fail-open losses."""
    want_over = occurrence_rank(ids) + 1 > limit
    got_over = np.asarray(got_codes) == code_over
    agree = got_over == want_over
    n = ids.shape[0]
    return {
        "decisions": int(n),
        "agreement": float(np.mean(agree)),
        "false_over": int(np.sum(got_over & ~want_over)),
        "false_ok": int(np.sum(~got_over & want_over)),
        "oracle_over_frac": float(np.mean(want_over)),
    }
