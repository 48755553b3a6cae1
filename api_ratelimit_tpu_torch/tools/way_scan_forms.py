"""Which form of the way scan is faster at which shape? Times the two forms
of ops/slab_kernels.py way_scan (per item and set-major) on one card over a
sweep of table sizes, ways and batch sizes, and checks them against each
other and the plain version.

    python -m api_ratelimit_tpu_torch.tools.way_scan_forms [--launches 30]

Traffic: the decided stream's, Zipf(1.1) ids over 10M keys
(numpy RandomState(0).zipf), each id's fingerprint two fmix32 bijections as
bench.py expands it; a batch of b items is the stream's first b ids. Tables:
random tags with half the batch's keys stored in a way of their set, mixed
liveness, window ends and counts. Both forms are held bit for bit to each
other at every shape and to the plain version up to b = 2^16.

Times are CUDA events around one call queued behind a spin kernel (~1 ms),
so the host's enqueue time stays out: the op's device span, every launch
and memset and the gaps between them, the median of --launches calls.
Prints one JSON line per shape (per_item_ms, set_major_ms, the form
way_scan_form ships there, the distinct sets the batch touches; at W =
128 and b = 2^20 each form's device activities apart, by torch.profiler) on
stderr
and one summary line with the card's name on stdout. Needs a CUDA device;
exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..ops import slab_kernels as K

NOW = 1_700_000_000
SPIN_CYCLES = 2_000_000  # ~1 ms: longer than the wrapper's host time
SLOTS = (1 << 22, 1 << 23)
WAYS = (4, 32, 128, 256)
BATCHES = tuple(1 << k for k in (12, 14, 16, 18, 20))
PLAIN_MAX_BATCH = 1 << 16  # the plain version gathers b x W rows


def fmix32(x: np.ndarray) -> np.ndarray:
    """The murmur3 finalizer, a bijection on uint32 (bench.py fmix32_np)."""
    x = np.asarray(x, dtype=np.uint32)
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def zipf_ids(n: int, n_keys: int, seed: int = 0) -> np.ndarray:
    """n Zipf(1.1) key ids over an n_keys universe (bench.py zipf_ids)."""
    return (np.random.RandomState(seed).zipf(1.1, size=n).astype(np.uint64) % n_keys).astype(np.uint32)


def zipf_fingerprints(n: int, n_keys: int = 10_000_000, seed: int = 0):
    ids = zipf_ids(n, n_keys, seed)
    return fmix32(ids), fmix32(ids ^ np.uint32(0x9E3779B9))


def table_rows(rng, n_slots: int, lo, hi, ways: int) -> np.ndarray:
    """Random rows around NOW (dead, never written, window-ended, live;
    30% of counts up to 2^32) with half the batch's keys stored."""
    t = np.empty((n_slots, 8), np.uint32)
    t[:, 0] = rng.integers(0, 1 << 32, n_slots, dtype=np.uint64)
    t[:, 1] = rng.integers(0, 1 << 32, n_slots, dtype=np.uint64)
    t[:, 2] = np.where(rng.random(n_slots) < 0.3, rng.integers(0, 1 << 32, n_slots, dtype=np.uint64), rng.integers(0, 50, n_slots))
    div = rng.choice(np.array([1, 60, 3600], np.int64), n_slots)
    t[:, 3] = (NOW // div) * div - div * rng.integers(0, 2, n_slots)
    t[:, 4] = NOW + rng.integers(-5, 100, n_slots)
    t[rng.random(n_slots) < 0.2, 4] = 0
    t[:, 5] = div
    t[:, 6:] = 0
    k = lo.size // 2
    idx = (lo[:k].astype(np.int64) & (n_slots // ways - 1)) * ways + rng.integers(0, ways, k)
    t[idx, 0], t[idx, 1] = lo[:k], hi[:k]
    return t


def span_ms(fn, launches: int) -> float:
    """Median CUDA-event time of one call of fn, queued behind a spin
    kernel (SPIN_CYCLES) so the host's enqueue time stays out of it."""
    fn()
    pairs = []
    for _ in range(launches):
        torch.cuda._sleep(SPIN_CYCLES)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def activities_us(fn, iters: int = 10) -> dict:
    """{device activity name: median microseconds} over `iters` synchronized
    calls of fn (torch.profiler): one call's launches and memset apart."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
            torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name.setdefault(e.name[:60], []).append(e.time_range.elapsed_us())
    return {name: float(np.median(us)) for name, us in by_name.items()}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--launches", type=int, default=30)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    dev = K.resolve_device("cuda")
    rng = np.random.default_rng(args.seed)
    lo_np, hi_np = zipf_fingerprints(BATCHES[-1], seed=args.seed)
    lo_all = torch.from_numpy(lo_np.view(np.int32)).to(dev)
    hi_all = torch.from_numpy(hi_np.view(np.int32)).to(dev)
    rows = []
    for n_slots in SLOTS:
        for ways in WAYS:
            table = torch.from_numpy(table_rows(rng, n_slots, lo_np, hi_np, ways).view(np.int32)).to(dev)
            n_sets = n_slots // ways
            for b in BATCHES:
                lo, hi = lo_all[:b], hi_all[:b]
                outs = {form: K.way_scan(table, lo, hi, NOW, ways, form=form) for form in K.WAY_SCAN_FORM_NAMES}
                want = K.way_scan_plain(table, lo, hi, NOW, ways) if b <= PLAIN_MAX_BATCH else outs["per_item"]
                for form, got in outs.items():
                    if not all(torch.equal(g, w) for g, w in zip(got, want)):
                        raise RuntimeError(f"way_scan {form} differs at slots={n_slots} W={ways} b={b}")
                del outs, want
                row = {
                    "slots": n_slots, "ways": ways, "n_sets": n_sets, "b": b,
                    "items_per_set": b / n_sets,
                    "distinct_sets": int(torch.unique(lo & (n_sets - 1)).numel()),
                    "shipped": K.way_scan_form(b, n_sets, ways),
                }
                for form in K.WAY_SCAN_FORM_NAMES:
                    row[f"{form}_ms"] = span_ms(lambda form=form: K.way_scan(table, lo, hi, NOW, ways, form=form), args.launches)
                row["set_major_over_per_item"] = row["set_major_ms"] / row["per_item_ms"]
                if b == BATCHES[-1] and ways == 128:
                    row["set_major_activities_us"] = activities_us(lambda: K.way_scan(table, lo, hi, NOW, ways, form="set_major"))
                    row["per_item_activities_us"] = activities_us(lambda: K.way_scan(table, lo, hi, NOW, ways, form="per_item"))
                print(json.dumps(row), file=sys.stderr, flush=True)
                rows.append(row)
            del table
            torch.cuda.empty_cache()
    faster = [r for r in rows if r["set_major_ms"] < r["per_item_ms"]]
    out = {
        "device": torch.cuda.get_device_name(0),
        "launches": args.launches,
        "shapes": len(rows),
        # the shapes where each form is faster, as (slots, W, b)
        "set_major_faster": [(r["slots"], r["ways"], r["b"]) for r in faster],
        "shipped_slower_by_over_5pct": [
            (r["slots"], r["ways"], r["b"], r["set_major_over_per_item"]) for r in rows
            if r[f"{r['shipped']}_ms"] > 1.05 * min(r["set_major_ms"], r["per_item_ms"])
        ],
        "rows": rows,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
