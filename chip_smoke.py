"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each of which must pass (nothing is caught):

1. build   nvcc-compiles every api_ratelimit_tpu_torch/csrc/*.cu source (one
           nvcc per source, all started together) into one library.
2. parity  each kernel against its plain PyTorch version on the card,
           bit-exact, at every bucket (128 ... 65536): the way scan and the
           apply at W in {4, 128} on adversarial inputs (segments across the
           apply kernel's 512-item tiles, window rollovers, all eviction
           tiers, one-set contention, padding lanes, counts >= 2^31); the
           sketch scan at sketch W in {4, 128} and lanes in {128, 1024} on
           adversarial planes (empty lanes, count ties, counts >= 2^31,
           fp-0 padding queries); the fused sketch update on the same
           geometries at b in {1, 1000, the buckets, 2^20} and at (8192
           lanes, W 4) and (4096 lanes, W 1) at the top bucket, with set 0
           forced (its victim lane matched, top-weight and fp_hi ties),
           wrapped-zero weights and runs without a candidate, its input
           planes unwritten; the decided apply (full and lean) and the
           standalone decide at near_ratio in {0.0, 0.8, 1.0}, with limits
           that put items under the near threshold, between it and the
           limit, crossing the limit, all over, at the f32 edge below 2^32,
           on counts >= 2^31 and padding. Then the apply's chained tile
           scan in every form (after, after with the sketch weight,
           decided, lean) at b in {1, 127, 1024, 65536, 2^20 - 37, 2^20},
           on one segment across every tile of 2^20 items, on a 2^20 batch
           whose sum wraps 2^32 ~8 times with segments starting right
           after each wrap, on all-zero hits, and the decided and lean
           forms on 20 fresh 2^20 seeds (a look-back race shows only now
           and then). The build's ptxas line for the apply prints first.
3. engine  SlabDeviceEngine at 2^22 slots (128 MiB), W=128, with the
           production sketch (HOTKEY_LANES=128, HOTKEY_K=16), Zipf(1.1) over
           2^20 keys: 32 launches at the 65536 bucket plus the smaller
           buckets, the clock crossing window edges, against an engine
           whose three kernels are swapped for their plain versions;
           afters, table bytes, health, sketch planes and every drained
           top-K must be identical, and a sketch-off engine (slice 1's
           step) must give the same afters and table. Each sketch-on
           submit launches the fused sketch update once and the standalone
           scan never. Prints the 65536-item submit_rows medians with the
           sketch on and off, and one profiled submit of each: the
           sketch-on one may run at most 8 device activities more, each
           named.
4. serve   two servers (device="cuda", 2^22 slots) with a two-rule config
           built from a mapping answer /json requests that cross a limit:
           200 then 429, bodies equal to the same stream served on the CPU.
           First slice 1's arm (sketch off, trie walk into do_limit): the
           slab kernels' launch counters must rise and the sketch scan's
           stay 0. Then the default-settings server (hotkeys on, host fast
           path), with the same bodies: way_scan, slab_apply and
           sketch_update must rise together, one each a launch. A
           stats flush drains the sketch, and GET /debug/hotkeys on the
           debug server must equal the CPU server's document and name the
           hot descriptor.
5. decided the engine benchmark's decided tier (bench.py bench_engine_zipf)
           on the port: a 2^23-slot table (256 MiB), W=128, 33 blocks of
           2^20 ids from its 10M-key Zipf(1.1) stream (seed 0), 1 hit, limit
           100, divider 1, one `now`, near_ratio 0.8. As the reference
           times it: the ids staged on the card as int32 before timing,
           expanded there to its murmur3 fingerprints (checked bit for bit
           against the host operand's), _slab_step_sorted with the lean
           fused apply, the codes unsorted and the OVER bits packed on the
           card; a warm-up step, then 32 timed to one synchronize
           (decisions/s), the bit readback timed apart. Beside it the host
           operand stream of slab_step_decided (each uint32[7, 2^20]
           operand uploaded inside the timed loop, readback included) with
           the same OVER bits and health. The 33 x 2^20 codes against the
           exact oracle: false_over must be 0 and false_ok at most drops +
           100 x live evictions. Beside it, a second table through the plain
           versions for the first 4 blocks: codes, health and table bytes
           identical. Then slab_step_packed on one 65536 block against the
           plain versions (all 9 rows, health, table), its decision rows
           against the standalone decide kernel, and slab_update_and_decide
           against the plain versions. Launch counters: each stream runs
           way_scan and slab_apply_lean once per step and no other apply;
           the packed step slab_apply_decide once. One profiled staged step
           gives the device-busy share and the top device items, and must
           hold no host-to-device copy.
6. compare the compare/select micro-benchmark's two kernels, sel and
   paths   chain, bit-exact against their plain versions at b = 2^20 (full
           range with INT_MIN, INT_MAX, 2^30 +- 1, 2^29 +- 1; the tool's own
           input), at b = 2^20 - 37 and on a buffer off 16-byte alignment;
           then the port's tool (api_ratelimit_tpu_torch/tools/
           microbench_compare_paths.py) in process at b = 2^20, which
           prints its JSON line: both kernels' launch counters must rise.
7. windowed the windowed serving path at the reference's default
           deployment (2^22 slots, W=128, the production sketch,
           TPU_BATCH_WINDOW=200us, max_batch 65536, buckets 128 ... 65536,
           precompiled) in three engines: the dispatch loop, leader-collects
           and direct. A serial stream (100 blocks of 1-64 Zipf(1.1) items,
           the clock crossing minutes) must give byte-identical results,
           tables, sketch planes and health in all three. Then, on fresh
           engines, 32 client threads submit single-descriptor blocks (2^13
           requests; 2^9 in direct mode, which serializes them): every
           key's count equals its hits (short keys at most drops + live
           evictions), decisions equal the requests, and each kernel's
           launch counter rises by the batches the arm reports. Prints
           requests/s, p50/p99 per request, the mean batch, the batches
           launched while another was in flight, and one profiled batch's
           device busy share.
8. report  per-kernel median device times (torch.profiler) and CUDA-event
           call times, bounds and launches as one JSON line (the sketch
           update over a real served step's candidates; the way scan also
           at the decided phase's b = 2^20 over its table; the three
           decision kernels at the decided phase's b = 2^20, sel and chain
           at the tool's); the standalone sketch scan, now on no path, on a
           line of its own, with the parent's two-kernel sketch update
           (scan kernel + torch phases) timed beside the fused kernel; the
           card's name and power limit, then the ok line.

Exits non-zero, printing no result, without a CUDA device. Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import http.client
import json
import os
import subprocess
import sys
import threading
import time
import types

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak
BUCKETS = (128, 1024, 8192, 65536)
N_SLOTS = 1 << 22  # the TPU_SLAB_SLOTS default: 128 MiB of rows
NOW0 = 1_700_000_000
HOTKEY_LANES, HOTKEY_K = 128, 16  # the settings defaults
SOURCES = {
    "way_scan": "api_ratelimit_tpu_torch/csrc/slab_kernels.cu",
    "slab_apply": "api_ratelimit_tpu_torch/csrc/slab_kernels.cu",
    "sketch_scan": "api_ratelimit_tpu_torch/csrc/sketch_kernels.cu",
    "sketch_update": "api_ratelimit_tpu_torch/csrc/sketch_kernels.cu",
    "slab_apply_decide": "api_ratelimit_tpu_torch/csrc/slab_kernels.cu",
    "slab_apply_lean": "api_ratelimit_tpu_torch/csrc/slab_kernels.cu",
    "decide": "api_ratelimit_tpu_torch/csrc/decide_kernels.cu",
    "sel": "api_ratelimit_tpu_torch/csrc/select_kernels.cu",
    "chain": "api_ratelimit_tpu_torch/csrc/select_kernels.cu",
}
REPLACES = {
    "way_scan": "api_ratelimit_tpu/ops/pallas_slab.py:312",
    "slab_apply": "api_ratelimit_tpu/ops/pallas_slab.py:371",
    "sketch_scan": "api_ratelimit_tpu/ops/sketch.py:148",
    "sketch_update": "api_ratelimit_tpu/ops/sketch.py:148",
    "slab_apply_decide": "api_ratelimit_tpu/ops/pallas_slab.py:371",
    "slab_apply_lean": "api_ratelimit_tpu/ops/pallas_slab.py:371",
    "decide": "api_ratelimit_tpu/ops/pallas_decide.py:120",
    "sel": "tools/microbench_compare_paths.py:83",
    "chain": "tools/microbench_compare_paths.py:110",
}
NEAR_RATIOS = (0.0, 0.8, 1.0)
# the apply kernel's tile-scan parity: sizes around its 512-item tiles and
# the two paths' buckets, and the fresh 2^20 seeds run in full and lean form
APPLY_SIZES = (1, 127, 1024, 65536, (1 << 20) - 37, 1 << 20)
APPLY_REPEATS = 20
APPLY_FORM_ARGS = {
    "after": ("slab_apply", {}),
    "after+weight": ("slab_apply", {"weight": True}),
    "decided": ("slab_apply_decide", {"decide": True, "near_ratio": 0.8}),
    "lean": ("slab_apply_lean", {"decide": True, "lean": True, "near_ratio": 0.8}),
}
APPLY_FORMS = tuple(APPLY_FORM_ARGS)
# the fused sketch update's parity: one item, a batch that is not a multiple
# of its 512-item blocks, the buckets and the decided batch
SKETCH_UPDATE_SIZES = (1, 1000, *BUCKETS, 1 << 20)
# (lanes, ways) beyond the served geometry, at the top bucket: planes too large
# to stage in shared memory, and 4096 one-way sets (shared memory by opt-in)
SKETCH_UPDATE_WIDE = ((8192, 4), (4096, 1))
# the decided phase: bench.py bench_engine_zipf's shapes on the card
DECIDED_SLOTS = 1 << 23  # 256 MiB of rows
DECIDED_BATCH = 1 << 20
DECIDED_KEYS = 10_000_000
DECIDED_BLOCKS = 33  # one warm-up launch + 32 timed
DECIDED_LIMIT = 100
DECIDED_WAYS = 128
PLAIN_TWIN_BLOCKS = 4  # the plain way scan gathers (2^20, 128, 8) int32 sets: 4 GiB
# the compare/select micro-benchmark: the tool's default batch
SELECT_BATCH = 1 << 20
INT_MIN, INT_MAX = -(1 << 31), (1 << 31) - 1
SELECT_EDGES = (
    INT_MIN, INT_MIN + 1, INT_MAX, INT_MAX - 1, 0, 1, -1, 3, -5,
    1 << 30, (1 << 30) + 1, (1 << 30) - 1, (1 << 30) + 3,
    1 << 29, (1 << 29) + 1, (1 << 29) - 1, (1 << 29) + 3, -(1 << 30),
)
# the windowed phase: the reference's default deployment with
# TPU_BATCH_WINDOW=200us (README.md's example value)
WINDOW_S = 0.0002
# request counts cut so the script keeps its ~1 minute of command time
SERIAL_SUBMITS = 100
CLIENT_THREADS = 32
WINDOWED_REQUESTS = 1 << 13
DIRECT_REQUESTS = 1 << 9  # direct mode serializes every request: fewer


def check(cond, message: str) -> None:
    if not cond:
        raise RuntimeError(message)


def log(*args) -> None:
    print(*args, flush=True)


def i32(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)


def fingerprints(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """splitmix64 of key ids -> (fp_lo, fp_hi) uint32 halves."""
    x = keys.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32), (x >> np.uint64(32)).astype(np.uint32)


def adversarial_table(rng, n_slots: int, now: int, lo, hi, ways: int = 1) -> np.ndarray:
    """Dead, never-written, window-ended and live rows; 30% of counts drawn
    up to 2^32; half the batch's own keys stored in a way of their set."""
    t = np.empty((n_slots, 8), np.uint32)
    t[:, 0] = rng.integers(0, 1 << 32, n_slots, dtype=np.uint64)
    t[:, 1] = rng.integers(0, 1 << 32, n_slots, dtype=np.uint64)
    big = rng.random(n_slots) < 0.3
    t[:, 2] = np.where(big, rng.integers(0, 1 << 32, n_slots, dtype=np.uint64), rng.integers(0, 50, n_slots))
    div = rng.choice(np.array([1, 60, 3600], np.int64), n_slots)
    t[:, 3] = (now // div) * div - div * rng.integers(0, 2, n_slots)
    t[:, 4] = now + rng.integers(-5, 100, n_slots)
    t[rng.random(n_slots) < 0.2, 4] = 0
    t[:, 5] = div
    t[:, 6:] = 0
    k = len(lo) // 2
    n_sets = n_slots // ways
    idx = (lo[:k].astype(np.int64) & (n_sets - 1)) * ways + rng.integers(0, ways, k)
    t[idx, 0], t[idx, 1] = lo[:k], hi[:k]
    return t


def scan_inputs(rng, b: int, n_slots: int, ways: int, now: int, dev):
    """A batch with its own keys in the table, a quarter of it contending
    for one set, and zero (padding) fingerprints at the tail."""
    lo, hi = fingerprints(rng.integers(0, 1 << 40, b))
    n_sets = n_slots // ways
    crowd = rng.random(b) < 0.25
    lo[crowd] = (lo[crowd] & ~np.uint32(n_sets - 1)) | np.uint32(7 % n_sets)
    lo[-b // 16 :] = 0
    hi[-b // 16 :] = 0
    table = adversarial_table(rng, n_slots, now, lo, hi, ways)
    return i32(table, dev), i32(lo, dev), i32(hi, dev)


def apply_inputs(rng, b: int, now: int, dev):
    """Slot-sorted apply operands: runs of one key up to 3000 long (so
    segments cross the kernel's 512-item tiles), hits up to 2^31 (sums
    wrap), stored rows that match in and out of the current window, and
    hits == 0 padding at the tail."""
    runs = rng.integers(1, 3000 if b > 1024 else 40, b)
    n_runs = int(np.searchsorted(np.cumsum(runs), b)) + 1  # the runs that fill b items
    keys = np.repeat(np.arange(n_runs), runs[:n_runs])[:b]
    hits = np.where(rng.random(b) < 0.05, rng.integers(0, 1 << 31, b), rng.integers(1, 4, b)).astype(np.uint32)
    hits[-b // 16 :] = 0
    return apply_batch(rng, keys, hits, now, dev)


def apply_batch(rng, keys: np.ndarray, hits: np.ndarray, now: int, dev):
    """The apply's operands for slot-sorted key ids (a segment starts where
    the id changes) and their hits: mixed dividers and jitter, stored rows
    that match in and out of the current window."""
    b = keys.size
    lo, hi = fingerprints(keys)
    div = rng.choice(np.array([0, 1, 60, 3600], np.int32), b)
    jit = rng.integers(0, 30, b).astype(np.int32)
    seg_start = np.concatenate([[True], (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])])
    st = adversarial_table(rng, b, now, lo, hi)
    same = rng.random(b) < 0.7
    st[same, 0], st[same, 1] = lo[same], hi[same]
    return (
        i32(lo, dev), i32(hi, dev), i32(hits, dev), i32(div, dev), i32(jit, dev),
        torch.from_numpy(seg_start).to(dev), i32(st, dev),
    )


def scan_edge_inputs(rng, kind: str, b: int, now: int, dev):
    """Batches aimed at the apply's chained tile scan. "one_key": a single
    segment across every tile, hits up to 2^31 (the sum wraps inside it);
    "wraps": hits up to 2^16, so 2^20 items wrap the running sum ~8 times,
    with a segment starting right after every wrap besides runs of up to
    3000; "zero_hits": runs of keys with no hits at all."""
    if kind == "one_key":
        keys = np.zeros(b, np.int64)
        hits = np.where(rng.random(b) < 0.05, rng.integers(0, 1 << 31, b), rng.integers(1, 4, b))
    elif kind == "wraps":
        hits = rng.integers(0, 1 << 16, b, dtype=np.uint64)
        incl = np.cumsum(hits)
        wrapped = np.concatenate([[False], (incl[:-1] >> np.uint64(32)) != ((incl[:-1] - hits[:-1]) >> np.uint64(32))])
        check(int(wrapped.sum()) >= 2, "the wrap batch does not wrap 2^32 twice")
        starts = wrapped | (rng.random(b) < 1 / 1500)
        starts[0] = True
        keys = np.cumsum(starts) - 1
    elif kind == "zero_hits":
        runs = rng.integers(1, 3000, b)
        n_runs = int(np.searchsorted(np.cumsum(runs), b)) + 1
        keys = np.repeat(np.arange(n_runs), runs[:n_runs])[:b]
        hits = np.zeros(b)
    else:
        raise ValueError(kind)
    return apply_batch(rng, keys, hits.astype(np.uint32), now, dev)


def decide_limits(rng, before: np.ndarray, after: np.ndarray) -> np.ndarray:
    """uint32 limits that put the items of an apply batch on every branch
    of the decision: under the near threshold, between it and the limit,
    crossing it within the item, all over (before >= limit), and every
    97th at the f32 edge, within 128 of 2^32, where the threshold's
    float-to-unsigned convert saturates."""
    b = before.size
    before, after = before.astype(np.uint64), after.astype(np.uint64)
    branch = rng.integers(0, 4, b)
    limit = np.select(
        [branch == 0, branch == 1, branch == 2],
        [after * 2 + 10, after + rng.integers(0, 4, b).astype(np.uint64), (before + after) // 2],
        before - np.minimum(before, rng.integers(0, 4, b).astype(np.uint64)),
    )
    limit = np.minimum(limit, (1 << 32) - 256)
    limit[::97] = (1 << 32) - rng.integers(1, 128, limit[::97].size).astype(np.uint64)
    return limit.astype(np.uint32)


def decide_inputs(M, rng, b: int, now: int, dev):
    """apply_inputs plus limits from decide_limits over the plain apply's
    before/after: (apply operands, int32 limits, (before, after, hits,
    limits, dividers) for the standalone decide)."""
    ops = apply_inputs(rng, b, now, dev)
    before, after = M.K.slab_apply_plain(*ops, now)[:2]
    host = lambda t: t.cpu().numpy().view(np.uint32)  # noqa: E731
    limit = i32(decide_limits(rng, host(before), host(after)), dev)
    return ops, limit, (before, after, ops[2], limit, ops[3])


def max_abs_err(got, want) -> int:
    err = 0
    for g, w in zip(got, want):
        check(g.dtype == w.dtype and g.shape == w.shape, "kernel output shape/dtype differs")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


PRIMER = "spin_kernel"  # torch.cuda._sleep's kernel


def prime_trace() -> None:
    """Open a trace with a few empty kernels and wait for them. The tracer
    has dropped the first activities of a trace on the card (the operand's
    H2D copy and the way scan of a profiled step; 1-2 of 20 launches in
    device_ms), so those are the primer's; device_activities leaves them
    out."""
    for _ in range(8):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def device_activities(prof) -> list:
    """(name, microseconds) of every kernel and copy the card ran inside a
    torch.profiler trace, in order of their start, without the primer's."""
    from torch.autograd import DeviceType

    events = sorted(
        (e for e in prof.events() if e.device_type == DeviceType.CUDA and PRIMER not in e.name),
        key=lambda e: e.time_range.start,
    )
    return [(e.name, e.time_range.elapsed_us()) for e in events]


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call: the kernels and copies it runs on the card,
    each at its median duration over `iters` synchronized calls after a
    warm-up (torch.profiler), summed. Every call runs the same activities,
    so an activity name seen n times in the trace runs round(n / iters)
    times a call, and a trace that drops a record (prime_trace) still gives
    the median. The host time of the Python wrapper around a launch is not
    in it: call_ms measures that."""
    return summed_ms(*traced_calls(fn, iters))


def summed_ms(per_call: dict, by_name: dict) -> float:
    """traced_calls' activities summed at their median durations, in ms."""
    return sum(n * float(np.median(by_name[name])) for name, n in per_call.items()) / 1e3


def activities_per_call(fn, iters: int = 20) -> int:
    """The device activities one call runs, counted as device_ms counts
    them, so a dropped record does not change the count."""
    return sum(traced_calls(fn, iters)[0].values())


def traced_calls(fn, iters: int) -> tuple[dict, dict]:
    """torch.profiler over `iters` synchronized calls of fn after a warm-up:
    ({activity name: runs a call}, {activity name: [microseconds]})."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            prime_trace()
            for _ in range(iters):
                fn()
                torch.cuda.synchronize()
        by_name: dict = {}
        for name, us in device_activities(prof):
            by_name.setdefault(name, []).append(us)
        per_call = {name: round(len(durations) / iters) for name, durations in by_name.items()}
        if any(per_call.values()):
            break
        # the tracer has come back empty now and then: trace again
        log(f"device_ms: trace {attempt} held no device activity that recurs in each of {iters} calls")
    check(any(per_call.values()), f"no device activity recurs in each of {iters} calls")
    for name, n in per_call.items():
        if len(by_name[name]) != n * iters:
            log(f"device_ms: {name[:60]} traced {len(by_name[name])} times in {iters} calls")
    return per_call, by_name


def call_ms(fn, iters: int = 20) -> float:
    """Median milliseconds of one call by a CUDA-event pair around it,
    after a warm-up: the device time plus whatever host time of the call
    (the Python wrapper, launch overhead) keeps the card waiting."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return float(np.median(samples))


@contextlib.contextmanager
def plain_kernels(M):
    """Route the slab step (ops/slab.py) and the sketch update
    (ops/sketch.py), which call the wrappers by the names they imported,
    through the plain versions even for CUDA tensors: the reference engine
    of the engine phase. Fails unless the block launched no kernel, so the
    reference can never be the kernels."""
    K, S, SKK, SKT = M.K, M.S, M.SKK, M.SKT
    saved = S.way_scan, S.slab_apply, SKT.sketch_update_fused
    before = dict(K.LAUNCHES)
    S.way_scan, S.slab_apply = K.way_scan_plain, K.slab_apply_plain
    SKT.sketch_update_fused = SKK.sketch_update_plain
    try:
        yield
    finally:
        S.way_scan, S.slab_apply, SKT.sketch_update_fused = saved
    check(K.LAUNCHES == before, f"the plain engine launched kernels: {before} -> {K.LAUNCHES}")


def sketch_planes(rng, lanes: int, ways: int) -> np.ndarray:
    """Adversarial sketch planes: empty lanes (count 0, fp 0/0), stale tags
    under count 0, an occupied 0/0 tag, count ties, counts >= 2^31
    (unoccupied when read signed) and random occupied rows."""
    p = np.zeros((3, lanes), np.uint32)
    # each lane's fp_lo names its own set, so resident keys can match
    n_sets = lanes // ways
    own_set = (np.arange(lanes) // ways).astype(np.uint64)
    p[0] = (rng.integers(0, 1 << 32, lanes, dtype=np.uint64) & ~np.uint64(n_sets - 1)) | own_set
    p[1] = rng.integers(0, 1 << 32, lanes, dtype=np.uint64)
    kind = rng.integers(0, 5, lanes)
    p[2] = np.select(
        [kind == 0, kind == 1, kind == 2, kind == 3],
        [0, rng.integers(1, 4, lanes), rng.integers(1 << 31, 1 << 32, lanes, dtype=np.uint64), 7],
        rng.integers(1, 1000, lanes),
    )
    empty = (kind == 0) & (rng.random(lanes) < 0.5)
    p[0][empty] = 0
    p[1][empty] = 0
    p[:2, lanes // 3] = 0
    p[2, lanes // 3] = 5
    return p


def sketch_queries(rng, planes: np.ndarray, b: int):
    """Half resident fingerprints, half misses, fp-0 padding at the tail."""
    pick = rng.integers(0, planes.shape[1], b)
    lo, hi = planes[0, pick].copy(), planes[1, pick].copy()
    miss = rng.random(b) < 0.5
    lo[miss] = rng.integers(0, 1 << 32, int(miss.sum()), dtype=np.uint64)
    lo[-b // 8 :] = 0
    hi[-b // 8 :] = 0
    return lo, hi


def sketch_update_inputs(rng, lanes: int, ways: int, b: int):
    """One launch's sketch update operands over the adversarial planes of
    sketch_planes: a batch of runs of distinct keys (resident fingerprints,
    occupied or not, and new ones), each run's last item the candidate (a
    tenth of the runs have none); weights small (ties), up to 2^32 - 1 and
    0 (a wrapped segment sum). From b >= 8 on, set 0 is forced: its lanes
    occupied, its victim lane holding the first candidate's key (the
    matched lane is the victim), and two new keys tied on the top weight
    and fp_hi. Returns (planes, fp_lo, fp_hi, weight) as uint32 numpy and
    cand as bool numpy."""
    planes = sketch_planes(rng, lanes, ways)
    n_keys = max(1, b // 3)
    pick = rng.integers(0, lanes, n_keys)
    lo, hi = planes[0, pick].copy(), planes[1, pick].copy()
    new = rng.random(n_keys) < 0.5
    lo[new] = rng.integers(0, 1 << 32, int(new.sum()), dtype=np.uint64)
    hi[new] = rng.integers(0, 1 << 32, int(new.sum()), dtype=np.uint64)
    _, first = np.unique((lo.astype(np.uint64) << np.uint64(32)) | hi, return_index=True)
    lo, hi = lo[np.sort(first)], hi[np.sort(first)]
    item_key = np.sort(rng.integers(0, lo.size, b))
    lo, hi = lo[item_key], hi[item_key]
    cand = np.r_[item_key[1:] != item_key[:-1], True] & (rng.random(b) < 0.9)
    weight = np.select(
        [rng.random(b) < 0.1, rng.random(b) < 0.2],
        [np.uint64(0), rng.integers(1 << 31, 1 << 32, b, dtype=np.uint64)],
        rng.integers(1, 4, b, dtype=np.uint64),
    ).astype(np.uint32)
    if b >= 8:
        n_sets = lanes // ways
        planes[2, :ways] = rng.integers(10, 1000, ways)
        victim = 1 % ways
        planes[2, victim] = 3
        new_lo = (rng.integers(1 << 20, 1 << 31, 2, dtype=np.uint64) * np.uint64(n_sets)) & np.uint64(0xFFFFFFFF)
        lo[:3] = [planes[0, victim], new_lo[0], new_lo[1]]
        hi[:3] = [planes[1, victim], 0xFFFFFFF0, 0xFFFFFFF0]
        weight[:3] = [7, 0xFFFFFFFF, 0xFFFFFFFF]
        cand[:3] = True
        cand[3:][(lo[3:] == lo[0]) & (hi[3:] == hi[0])] = False  # the keys stay distinct
    return planes, lo, hi, weight, cand


def phase_parity(M, dev) -> dict:
    K, SKK = M.K, M.SKK
    rng = np.random.default_rng(1)
    n_slots = N_SLOTS
    err = dict.fromkeys(SOURCES, 0)
    for ways in (4, 128):
        for b in BUCKETS:
            table, lo, hi = scan_inputs(rng, b, n_slots, ways, NOW0, dev)
            got = K.way_scan(table, lo, hi, NOW0, ways)
            want = K.way_scan_plain(table, lo, hi, NOW0, ways)
            torch.cuda.synchronize()
            e = max_abs_err(got, want)
            check(e == 0, f"way_scan differs from its plain version at b={b} W={ways}")
            check(bool(want[1].any()) and not bool(want[1].all()), "scan parity batch lacks matches or misses")
            err["way_scan"] = max(err["way_scan"], e)
    for b in BUCKETS:
        ops = apply_inputs(rng, b, NOW0, dev)
        got = K.slab_apply(*ops, NOW0)
        want = K.slab_apply_plain(*ops, NOW0)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        check(e == 0, f"slab_apply differs from its plain version at b={b}")
        err["slab_apply"] = max(err["slab_apply"], e)
    for lanes in (128, 1024):
        for ways in (4, 128):
            for b in BUCKETS:
                planes = sketch_planes(rng, lanes, ways)
                lo, hi = sketch_queries(rng, planes, b)
                args = (i32(planes, dev), i32(lo, dev), i32(hi, dev), ways)
                got = SKK.sketch_scan(*args)
                want = SKK.sketch_scan_plain(*args)
                torch.cuda.synchronize()
                e = max_abs_err(got, want)
                check(e == 0, f"sketch_scan differs from its plain version at b={b} W={ways} lanes={lanes}")
                check(bool(want[1].any()) and not bool(want[1].all()), "sketch parity batch lacks matches or misses")
                err["sketch_scan"] = max(err["sketch_scan"], e)
    sketch_cases = [(lanes, ways, b) for lanes in (128, 1024) for ways in (4, 128) for b in SKETCH_UPDATE_SIZES]
    sketch_cases += [(lanes, ways, BUCKETS[-1]) for lanes, ways in SKETCH_UPDATE_WIDE]
    for lanes, ways, b in sketch_cases:
        planes, lo, hi, weight, cand = sketch_update_inputs(rng, lanes, ways, b)
        args = (i32(planes, dev), i32(lo, dev), i32(hi, dev), i32(weight, dev), torch.from_numpy(cand).to(dev), ways)
        got = SKK.sketch_update_fused(*args)
        want = SKK.sketch_update_plain(*args)
        torch.cuda.synchronize()
        e = max_abs_err([got], [want])
        check(e == 0, f"sketch_update differs from its plain version at b={b} W={ways} lanes={lanes}")
        check(same(args[0], i32(planes, dev)), "sketch_update wrote its input planes")
        if b >= 8:
            victim = 1 % ways
            check(int(want[2, victim]) == 3 + 0xFFFFFFFF - (1 << 32), f"the forced victim lane was not taken at b={b} W={ways} lanes={lanes}")
        err["sketch_update"] = max(err["sketch_update"], e)
    D = M.D
    for b in BUCKETS:
        ops, limit, dec_ops = decide_inputs(M, rng, b, NOW0, dev)
        codes = K.slab_apply_plain(*ops, NOW0, s_limit=limit, decide=True, lean=True)[4]
        check(bool((codes == D.CODE_OK).any()) and bool((codes == D.CODE_OVER_LIMIT).any()), "decide parity batch lacks OK or OVER")
        for ratio in NEAR_RATIOS:
            for name, lean in (("slab_apply_decide", False), ("slab_apply_lean", True)):
                kw = {"s_limit": limit, "near_ratio": ratio, "decide": True, "lean": lean}
                got = K.slab_apply(*ops, NOW0, **kw)
                want = K.slab_apply_plain(*ops, NOW0, **kw)
                torch.cuda.synchronize()
                e = max_abs_err(got, want)
                check(e == 0, f"{name} differs from its plain version at b={b} near_ratio={ratio}")
                err[name] = max(err[name], e)
            got = D.decide(*dec_ops, NOW0, ratio)
            want = D.decide_plain(*dec_ops, NOW0, ratio)
            torch.cuda.synchronize()
            e = max_abs_err(got, want)
            check(e == 0, f"decide differs from its plain version at b={b} near_ratio={ratio}")
            check(bool((want.throttle_millis != 0).any()) or ratio == 1.0, "decide parity batch has no paced item")
            err["decide"] = max(err["decide"], e)
    apply_scan_parity(M, dev, err)
    log(
        f"parity: bit-exact at buckets {BUCKETS}, W in (4, 128); sketch scan and update also at lanes in (128, 1024),"
        f" the update at b in {SKETCH_UPDATE_SIZES};"
        f" decided apply (full, lean) and decide at near_ratio in {NEAR_RATIOS}"
    )
    return err


def apply_forms(M, ops, now: int, limit, label: str, err: dict, forms=APPLY_FORMS) -> None:
    """Each named form of the apply kernel against its plain version on the
    same operands, every output bit for bit; the errors go into `err`
    under the form's launch-counter name."""
    K = M.K
    for form in forms:
        name, kw = APPLY_FORM_ARGS[form]
        if "decide" in kw:
            kw = {**kw, "s_limit": limit}
        got = K.slab_apply(*ops, now, **kw)
        want = K.slab_apply_plain(*ops, now, **kw)
        torch.cuda.synchronize()
        check(len(got) == len(want), f"apply {form} returned {len(got)} planes, its plain version {len(want)}")
        e = max_abs_err(got, want)
        check(e == 0, f"apply {form} differs from its plain version on {label}")
        err[name] = max(err[name], e)


def apply_scan_parity(M, dev, err: dict) -> None:
    """The apply kernel's chained tile scan against the plain version in
    every form (after, after with the sketch weight, decided, lean): at the
    sizes of APPLY_SIZES, on one segment across every tile of 2^20 items,
    on a batch whose sum wraps 2^32 several times with segments starting
    right after each wrap, and on all-zero hits; then the 2^20 full and
    lean forms on APPLY_REPEATS fresh seeds, since a look-back race would
    show only now and then."""
    rng = np.random.default_rng(11)
    t0 = time.perf_counter()
    cases = [(f"b={b}", lambda b=b: apply_inputs(rng, b, NOW0, dev)) for b in APPLY_SIZES]
    cases += [
        (f"{kind} b=2^20", lambda kind=kind: scan_edge_inputs(rng, kind, DECIDED_BATCH, NOW0, dev))
        for kind in ("one_key", "wraps", "zero_hits")
    ]
    for label, make in cases:
        ops = make()
        before, after = (t.cpu().numpy().view(np.uint32) for t in M.K.slab_apply_plain(*ops, NOW0)[:2])
        limit = i32(decide_limits(rng, before, after), dev)
        apply_forms(M, ops, NOW0, limit, label, err)
    for seed in range(APPLY_REPEATS):
        r = np.random.default_rng(1000 + seed)
        ops, limit, _dec = decide_inputs(M, r, DECIDED_BATCH, NOW0, dev)
        apply_forms(M, ops, NOW0, limit, f"2^20 seed {1000 + seed}", err, forms=("decided", "lean"))
    log(
        f"apply scan parity: every form bit-exact at b in {APPLY_SIZES}, on {[c[0] for c in cases[len(APPLY_SIZES):]]},"
        f" and decided/lean on {APPLY_REPEATS} fresh 2^20 seeds ({time.perf_counter() - t0:.1f} s)"
    )


def zipf_keys(rng, n: int, n_keys: int = 1 << 20, s: float = 1.1) -> np.ndarray:
    cdf = np.cumsum(np.arange(1, n_keys + 1, dtype=np.float64) ** -s)
    return np.searchsorted(cdf, rng.random(n) * cdf[-1]).astype(np.int64)


def key_block(keys: np.ndarray) -> np.ndarray:
    """uint32[6, n] row block: fingerprint, 1 hit, per-key limit, divider
    (second/minute/hour by key id) and a small jitter."""
    block = np.empty((6, keys.size), np.uint32)
    block[0], block[1] = fingerprints(keys)
    block[2] = 1
    block[3] = np.array([5, 100, 1000], np.uint32)[keys % 3]
    block[4] = np.array([1, 60, 3600], np.uint32)[(keys // 3) % 3]
    block[5] = (keys % 7).astype(np.uint32)
    return block


def phase_engine(M, dev):
    """The kernel engine and the plain-kernel engine both carry the
    production sketch; a third, sketch-off engine (slice 1's step) shares
    their traffic and is timed against the kernel engine, alternating which
    goes first."""
    K, cuda_mod, utils = M.K, M.cuda_mod, M.utils
    rng = np.random.default_rng(2)
    clocks = [utils.FakeTimeSource(NOW0) for _ in range(3)]
    hot = {"hotkey_lanes": HOTKEY_LANES, "hotkey_k": HOTKEY_K}
    eng_k = cuda_mod.SlabDeviceEngine(clocks[0], n_slots=N_SLOTS, device=dev, **hot)
    eng_p = cuda_mod.SlabDeviceEngine(clocks[1], n_slots=N_SLOTS, device=dev, **hot)
    eng_off = cuda_mod.SlabDeviceEngine(clocks[2], n_slots=N_SLOTS, device=dev)
    check(eng_k.ways == 128, "engine did not default to 128 ways on cuda")
    check(eng_k.hotkeys_enabled and not eng_off.hotkeys_enabled, "sketch gate is off where it should be on")
    top = BUCKETS[-1]
    sizes = [top] * 32 + [b - b // 8 for b in BUCKETS[:-1]]
    launch_ms = {"sketch_on": [], "sketch_off": [], "plain": []}
    drained = []
    for i, n in enumerate(sizes):
        step = 61 if i % 8 == 7 else 1  # cross minute windows too
        for clock in clocks:
            clock.advance(step)
        block = key_block(zipf_keys(rng, n))
        timed = {}
        for name in (("sketch_on", "sketch_off") if i % 2 == 0 else ("sketch_off", "sketch_on")):
            eng = eng_k if name == "sketch_on" else eng_off
            torch.cuda.synchronize()
            before = dict(K.LAUNCHES)
            t0 = time.perf_counter()
            timed[name] = eng.submit_rows(block)
            t1 = time.perf_counter()
            ran = {k: K.LAUNCHES[k] - before[k] for k in before}
            want_ran = dict.fromkeys(before, 0) | {"way_scan": 1, "slab_apply": 1, "sketch_update": int(name == "sketch_on")}
            check(ran == want_ran, f"{name} engine launched {ran} at launch {i}, expected {want_ran}")
            if n == top:
                launch_ms[name].append((t1 - t0) * 1e3)
        t1 = time.perf_counter()
        with plain_kernels(M):
            want = eng_p.submit_rows(block)
        t2 = time.perf_counter()
        if n == top:
            launch_ms["plain"].append((t2 - t1) * 1e3)
        check(np.array_equal(timed["sketch_on"], want), f"engine afters differ at launch {i}")
        check(np.array_equal(timed["sketch_off"], want), f"sketch-off engine afters differ at launch {i}")
        check(np.array_equal(eng_k.export_sketch(), eng_p.export_sketch()), f"sketch planes differ at launch {i}")
        if i % 8 == 3:
            got_top = eng_k.drain_hotkeys()
            want_top = eng_p.drain_hotkeys()
            # one insert per sketch set per launch: at 128 lanes in one set
            # the sketch holds at most one new key per launch
            check(got_top == want_top and 0 < len(got_top) <= min(i + 1, HOTKEY_K), f"drained top-K differs at launch {i}")
            check(np.array_equal(eng_k.export_sketch(), eng_p.export_sketch()), "post-decay planes differ")
            drained.append(got_top[0][2])
    table = eng_k.export_tables()[0]
    check(np.array_equal(table, eng_p.export_tables()[0]), "engine tables differ")
    check(np.array_equal(table, eng_off.export_tables()[0]), "the sketch changed the slab")
    hk, hp, ho = eng_k.health_snapshot(), eng_p.health_snapshot(), eng_off.health_snapshot()
    check(hk == hp == ho, f"engine health differs: {hk} vs {hp} vs {ho}")
    check(hk["decisions"] == sum(sizes), "decision count is off")
    block = key_block(zipf_keys(rng, top))
    profiles = {name: profile_submit(eng, block) for name, eng in (("sketch_on", eng_k), ("sketch_off", eng_off))}
    sketch_share = sketch_activities(eng_k, eng_off, block)
    out = {
        "n_slots": N_SLOTS,
        "ways": eng_k.ways,
        "hotkey_lanes": HOTKEY_LANES,
        "launches": len(sizes),
        "step_ms_median_sketch_on": float(np.median(launch_ms["sketch_on"])),
        "step_ms_median_sketch_off": float(np.median(launch_ms["sketch_off"])),
        "step_ms_median_plain": float(np.median(launch_ms["plain"])),
        # device time of one profiled submit over the unprofiled median step
        "device_busy_share_sketch_on": profiles["sketch_on"]["device_ms"] / float(np.median(launch_ms["sketch_on"])),
        "device_busy_share_sketch_off": profiles["sketch_off"]["device_ms"] / float(np.median(launch_ms["sketch_off"])),
        "drained_top_counts": drained,
        "health": hk,
    }
    log("engine:", json.dumps(out))
    log("profile:", json.dumps(profiles))
    log("sketch share of a 65536-item submit (5 traced submits):", json.dumps(sketch_share))
    return eng_k


# the sketch's device activities in one served submit beyond the sketch-off
# step's: the fused kernel, its scratch memset and the few ops forming the
# candidate mask (ops/slab.py)
SKETCH_EXTRA_ACTIVITIES = 8


def sketch_activities(eng_on, eng_off, block: np.ndarray, iters: int = 5) -> dict:
    """The sketch's share of a 65536-item submit: the device activities a
    submit runs and their device ms (device_ms's counting over `iters`
    traced submits, so a dropped record changes nothing) with the sketch
    on and off, and the activities the sketch-on submit runs beyond the
    sketch-off one, by name. Fails if they are more than
    SKETCH_EXTRA_ACTIVITIES."""
    (on, on_us), (off, off_us) = (traced_calls(lambda e=e: e.submit_rows(block), iters) for e in (eng_on, eng_off))
    extra = collections.Counter(on) - collections.Counter(off)
    share = {
        "activities_on": sum(on.values()),
        "activities_off": sum(off.values()),
        "device_ms_on": summed_ms(on, on_us),
        "device_ms_off": summed_ms(off, off_us),
        "extra": sorted((name[:60], n) for name, n in extra.items()),
    }
    n_extra = sum(extra.values())
    check(n_extra <= SKETCH_EXTRA_ACTIVITIES, f"the sketch-on submit ran {n_extra} activities beyond the sketch-off one: {share['extra']}")
    return share


def profile_submit(engine, block: np.ndarray) -> dict:
    """profile_call over one warm submit_rows."""
    return profile_call(lambda: engine.submit_rows(block))


def profile_call(fn) -> dict:
    """torch.profiler over one warm call of fn: host wall time (synchronized,
    profiler overhead included), the summed device time of its kernels and
    copies and of its host-to-device copies alone, the device's busy share
    of that wall time, the count of device activities, and the kernels and
    host ops that take the most time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prime_trace()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        acts = device_activities(prof)
        if acts:
            break
        # the tracer has come back empty now and then: trace again
        log(f"profile_call: trace {attempt} held no device activity")
    check(bool(acts), "the profiler recorded no device activity")
    htod_ms = sum(us for name, us in acts if "HtoD" in name) / 1e3
    by_name: dict = {}
    for name, us in acts:
        ms, n = by_name.get(name[:60], (0.0, 0))
        by_name[name[:60]] = (ms + us / 1e3, n + 1)
    busy_ms = sum(us for _name, us in acts) / 1e3
    by_host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    return {
        "wall_ms": wall_ms,
        "device_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "device_activities": len(acts),
        "htod_ms": htod_ms,
        "top_device_ms": sorted(([k, ms, n] for k, (ms, n) in by_name.items()), key=lambda r: -r[1])[:10],
        "top_host_ms": [[e.key[:60], e.self_cpu_time_total / 1e3, e.count] for e in by_host],
    }


RULES = {
    "domain": "smoke",
    "descriptors": [
        {"key": "user", "rate_limit": {"unit": "minute", "requests_per_unit": 3}},
        {"key": "path", "value": "/login", "rate_limit": {"unit": "hour", "requests_per_unit": 100}},
    ],
}


class _Runtime:
    def snapshot(self):
        return self

    def keys(self):
        return ["config.smoke"]

    def get(self, key):
        return ""

    def add_update_callback(self, cb):
        pass


def http_call(port: int, method: str, path: str, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        headers = {"Content-Type": "application/json"} if body is not None else {}
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def serve(device: str, bodies, defaults: bool = True):
    """Start the port's server (W=128) and its debug server on ephemeral
    ports, POST `bodies`, flush the stats (the flush drains the sketch),
    GET /debug/hotkeys and /stats, stop both. defaults: the production
    settings (hotkeys on, host fast path); else slice 1's arm (sketch off,
    the trie walk into do_limit). Returns ([(status, body bytes)], hotkeys
    document bytes, stats document)."""
    from api_ratelimit_tpu_torch.backends.cuda import CudaRateLimitCache, HotkeyStats, SlabHealthStats
    from api_ratelimit_tpu_torch.config import ConfigDoc, build_config
    from api_ratelimit_tpu_torch.limiter import BaseRateLimiter
    from api_ratelimit_tpu_torch.server.http_server import HttpServer, new_debug_server
    from api_ratelimit_tpu_torch.service import RateLimitService
    from api_ratelimit_tpu_torch.stats import Store
    from api_ratelimit_tpu_torch.utils import FakeTimeSource

    clock = FakeTimeSource(NOW0)
    store = Store()
    root = store.scope("ratelimit")
    rules_scope = root.scope("rate_limit")
    cache = CudaRateLimitCache(
        BaseRateLimiter(clock), n_slots=N_SLOTS, ways=128, device=device,
        hotkey_lanes=HOTKEY_LANES if defaults else 0, hotkey_k=HOTKEY_K,
    )
    service = RateLimitService(
        _Runtime(), cache, root, clock,
        config_loader=lambda _files: build_config([ConfigDoc("smoke", RULES)], rules_scope),
        host_fast_path=defaults,
    )
    store.add_stat_generator(SlabHealthStats(cache.engine, root.scope("slab")))
    store.add_stat_generator(HotkeyStats(cache.engine, root.scope("hotkeys")))
    server = HttpServer(service)
    debug = new_debug_server(store)
    debug.add_debug_endpoint("/debug/hotkeys", lambda: json.dumps(cache.hotkeys_debug(), indent=2))
    server.serve_background()
    debug.serve_background()
    try:
        out = [http_call(server.port, "POST", "/json", body) for body in bodies]
        store.flush()
        status, hotkeys = http_call(debug.port, "GET", "/debug/hotkeys")
        check(status == 200, f"/debug/hotkeys answered {status}")
        status, stats = http_call(debug.port, "GET", "/stats")
        check(status == 200, f"/stats answered {status}")
    finally:
        server.shutdown()
        debug.shutdown()
    return out, hotkeys, json.loads(stats)


def phase_serve(K) -> dict:
    def req(*descs):
        return json.dumps({"domain": "smoke", "descriptors": [{"entries": [{"key": k, "value": v}]} for k, v in descs]}).encode()

    bodies = [req(("user", "alice"), ("path", "/login")) for _ in range(5)] + [req(("user", "bob"))]
    bodies += [req(("path", "/login")) for _ in range(10)]
    want_statuses = [200, 200, 200, 429, 429, 200] + [200] * 10

    # slice 1's arm (sketch off, trie walk into do_limit): both slab
    # kernels launch, the sketch's never do
    K.reset_launch_counts()
    got1, _, stats1 = serve("cuda", bodies, defaults=False)
    launches1 = dict(K.LAUNCHES)
    want1, _, _ = serve("cpu", bodies, defaults=False)
    check(
        launches1["way_scan"] > 0 and launches1["slab_apply"] > 0
        and launches1["sketch_update"] == 0 and launches1["sketch_scan"] == 0,
        f"slice 1's arm launched {launches1}",
    )
    check([s for s, _ in got1] == want_statuses, f"unexpected slice-1 statuses {[s for s, _ in got1]}")
    check(got1 == want1, "card and CPU responses of slice 1's arm differ")
    check(stats1["ratelimit.slab.decisions"] == 21, f"unexpected slice-1 /stats {stats1}")

    # the production defaults: the main path, the source of the kernels
    # line's launch counts
    K.reset_launch_counts()
    got, hot_doc, stats = serve("cuda", bodies)
    launches = dict(K.LAUNCHES)
    want, want_doc, _ = serve("cpu", bodies)
    check(all(launches[k] > 0 for k in ("way_scan", "slab_apply", "sketch_update")), f"main path skipped a kernel: {launches}")
    # one sketch update a launch, and the standalone scan never
    check(
        launches["sketch_update"] == launches["way_scan"] == launches["slab_apply"] and launches["sketch_scan"] == 0,
        f"the served launches do not run one sketch update each: {launches}",
    )
    statuses = [s for s, _ in got]
    check(statuses == want_statuses, f"unexpected statuses {statuses}")
    check(got == want, "card and CPU responses differ")
    check(got == got1, "the fast path and slice 1's trie arm answer differently")
    first, fourth = json.loads(got[0][1]), json.loads(got[3][1])
    reset = f"{60 - NOW0 % 60}s"
    check(
        first["statuses"][0] == {"code": "OK", "currentLimit": {"requestsPerUnit": 3, "unit": "MINUTE"}, "limitRemaining": 2, "durationUntilReset": reset},
        f"unexpected first body {first}",
    )
    check(fourth["overallCode"] == "OVER_LIMIT" and fourth["statuses"][1]["limitRemaining"] == 96, f"unexpected fourth body {fourth}")
    check(hot_doc == want_doc, f"card and CPU /debug/hotkeys differ:\n{hot_doc!r}\n{want_doc!r}")
    doc = json.loads(hot_doc)
    check(doc["enabled"] and doc["drains"] == 1 and doc["lanes"] == HOTKEY_LANES, f"unexpected hotkeys document {doc}")
    # one insert per sketch set per launch: the first launch's two new keys
    # contend, so the loser's first hit is not counted
    head = doc["top"][0]
    check(head["key"] == "smoke_path_/login_" and head["count"] in (14, 15), f"hot descriptor not first: {doc['top']}")
    check(stats["ratelimit.hotkeys.drains"] == 2 and stats["ratelimit.slab.decisions"] == 21, f"unexpected /stats {stats}")
    log(f"serve: statuses {statuses}, slice-1 arm launches {launches1}, default launches {launches}, /debug/hotkeys top {doc['top'][:3]}")
    return launches


def zipf_ids(n_keys: int, batch: int, n_batches: int, seed: int = 0) -> np.ndarray:
    """bench.py zipf_ids: Zipf(1.1)-distributed key ids over an n_keys
    universe, as uint32[n_batches, batch]."""
    rng = np.random.RandomState(seed)
    ids = rng.zipf(1.1, size=batch * n_batches).astype(np.uint64) % n_keys
    return ids.reshape(n_batches, batch).astype(np.uint32)


def fmix32(x: np.ndarray) -> np.ndarray:
    """bench.py fmix32_np: the murmur3 finalizer, a bijection on uint32."""
    x = np.asarray(x, dtype=np.uint32)
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def decided_operand(ids: np.ndarray, now: int) -> np.ndarray:
    """bench_engine_zipf's expand() as a host operand uint32[7, b]: two
    fmix32 bijections of the id as the fingerprint (distinct ids never
    collide), 1 hit, limit 100, divider 1 (SECOND), no jitter; `now` and
    near_ratio 0.8 in the scalar row."""
    p = np.zeros((7, ids.size), np.uint32)
    p[0] = fmix32(ids)
    p[1] = fmix32(ids ^ np.uint32(0x9E3779B9))
    p[2] = 1
    p[3] = DECIDED_LIMIT
    p[4] = 1
    p[6, 0] = now
    p[6, 1] = np.float32(0.8).view(np.uint32)
    return p


def fmix32_dev(x: torch.Tensor) -> torch.Tensor:
    """fmix32 on the card over int64 values in [0, 2^32). Each multiply by
    a 32-bit constant is split at bit 16, so no product exceeds 2^49 and
    nothing relies on how the card wraps an overflowing multiply; the
    result is masked to 32 bits."""

    def mul(v, c):
        return (v * (c & 0xFFFF) + (((v * (c >> 16)) & 0xFFFF) << 16)) & 0xFFFFFFFF

    x = x ^ (x >> 16)
    x = mul(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def expand_ids(S, ids: torch.Tensor):
    """bench_step's expand() on the card: staged int32 ids (uint32 bits) ->
    the device SlabBatch of decided_operand's rows 0-5: fp_lo = fmix32(id),
    fp_hi = fmix32(id ^ 0x9E3779B9), 1 hit, limit 100, divider 1 (SECOND),
    no jitter."""
    x = ids.long() & 0xFFFFFFFF

    def as_i32(v):
        return (((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)

    ones = torch.ones_like(ids)
    return S.SlabBatch(
        as_i32(fmix32_dev(x)), as_i32(fmix32_dev(x ^ 0x9E3779B9)), ones,
        torch.full_like(ids, DECIDED_LIMIT), ones, torch.zeros_like(ids),
    )


def staged_step(M, state, ids: torch.Tensor, now: int):
    """bench_step on the port: expand staged ids on the card, run
    _slab_step_sorted with the lean fused apply, unsort the codes and pack
    the OVER bits on the card. Returns (uint8[b / 8] bits, int64[5] health),
    both on the card."""
    S, D = M.S, M.D
    _before, _after, d, order, health = S._slab_step_sorted(
        state, expand_ids(S, ids), now, 0.8, DECIDED_WAYS, lean=True
    )
    return D.packbits(S._unsort(d.code, order) == D.CODE_OVER_LIMIT), health


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit equality of two tensors of one dtype and shape (uint32 through
    its int32 view, which torch compares everywhere)."""
    if a.dtype == torch.uint32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def phase_decided(M, dev) -> tuple[dict, dict, dict]:
    """The decided tier of bench_engine_zipf on the port (module docstring,
    phase 5). Returns (summary, launch counts for the kernels line: the
    lean apply's from the staged stream, the full apply's and decide's from
    the packed step; the way scan's operands at this shape: the stream's
    table, one staged block's fingerprints and its launches in the staged
    stream)."""
    K, S, D, O = M.K, M.S, M.D, M.O
    t_phase = time.perf_counter()
    ways, now, limit = DECIDED_WAYS, NOW0, DECIDED_LIMIT
    ids = zipf_ids(DECIDED_KEYS, DECIDED_BATCH, DECIDED_BLOCKS, seed=0)
    # bench_engine_zipf warms up on its last staged block, then replays the rest
    stream = np.concatenate([ids[-1:], ids[:-1]])
    ops = [decided_operand(block, now) for block in stream]
    t_gen = time.perf_counter() - t_phase

    def over_bits(codes):
        return D.packbits(codes == D.CODE_OVER_LIMIT)

    # a kernel table beside a plain-version table over the first blocks
    twin_k = S.make_slab(DECIDED_SLOTS, device=dev)
    twin_p = S.make_slab(DECIDED_SLOTS, device=dev)
    twin_bits = []
    for i in range(PLAIN_TWIN_BLOCKS):
        codes_k, health_k = S.slab_step_decided(twin_k, ops[i], ways=ways)
        with plain_kernels(M):
            codes_p, health_p = S.slab_step_decided(twin_p, ops[i], ways=ways)
        check(same(codes_k, codes_p), f"decided codes differ from the plain versions' at block {i}")
        check(same(health_k, health_p), f"decided health differs from the plain versions' at block {i}")
        twin_bits.append(over_bits(codes_k))
    check(same(twin_k.table, twin_p.table), "decided table differs from the plain versions' table")
    twin_bits = torch.cat(twin_bits).cpu().numpy()
    del twin_k, twin_p, codes_k, codes_p
    torch.cuda.empty_cache()
    t_twin = time.perf_counter() - t_phase - t_gen

    # the host-operand stream (slice 3's measure): one warm-up launch, then
    # 32 timed, each numpy operand uploaded inside the timed loop
    state_h = S.make_slab(DECIDED_SLOTS, device=dev)
    K.reset_launch_counts()
    codes, health = S.slab_step_decided(state_h, ops[0], ways=ways)
    healths_h, bits = [health], [over_bits(codes)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for op in ops[1:]:
        codes, health = S.slab_step_decided(state_h, op, ways=ways)
        healths_h.append(health)
        bits.append(over_bits(codes))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    host_bits = torch.cat(bits).cpu().numpy()
    t2 = time.perf_counter()
    host_launches = dict(K.LAUNCHES)
    n_launch = len(ops)
    want = dict.fromkeys(K.LAUNCHES, 0) | {"way_scan": n_launch, "slab_apply_lean": n_launch}
    check(host_launches == want, f"the host-operand stream launched {host_launches}, expected {want}")
    check(np.array_equal(host_bits[: twin_bits.size], twin_bits), "the stream's first blocks differ from the twin check's kernel table")
    del state_h, codes, bits
    torch.cuda.empty_cache()

    # the reference tier's quantity (bench.py bench_engine_zipf run_path):
    # the u32 ids staged on the card before timing and expanded there; the
    # launch chain timed to one synchronize, the bit readback apart
    staged = [torch.from_numpy(block.view(np.int32)).to(dev) for block in stream]
    first = expand_ids(S, staged[0])
    check(
        np.array_equal(first.fp_lo.cpu().numpy().view(np.uint32), ops[0][S.ROW_FP_LO])
        and np.array_equal(first.fp_hi.cpu().numpy().view(np.uint32), ops[0][S.ROW_FP_HI]),
        "the card's id expansion differs from decided_operand's fingerprints",
    )
    del first
    state = S.make_slab(DECIDED_SLOTS, device=dev)
    K.reset_launch_counts()
    bits_dev, health = staged_step(M, state, staged[0], now)
    healths, bits = [health], [bits_dev]
    torch.cuda.synchronize()
    s0 = time.perf_counter()
    for block in staged[1:]:
        bits_dev, health = staged_step(M, state, block, now)
        healths.append(health)
        bits.append(bits_dev)
    torch.cuda.synchronize()
    s1 = time.perf_counter()
    staged_bits = torch.cat(bits).cpu().numpy()
    s2 = time.perf_counter()
    decided_launches = dict(K.LAUNCHES)
    check(decided_launches == want, f"the staged stream launched {decided_launches}, expected {want}")
    check(np.array_equal(staged_bits, host_bits), "the staged stream's OVER bits differ from the host-operand stream's")
    del bits

    rep = O.parity_report(stream.reshape(-1), np.unpackbits(staged_bits), limit=limit, code_over=1)
    h = [int(v) for v in torch.stack(healths).sum(dim=0).tolist()]
    check(h == [int(v) for v in torch.stack(healths_h).sum(dim=0).tolist()], "the staged stream's health differs from the host-operand stream's")
    ev_live, drops = h[S.HEALTH_EVICT_LIVE], h[S.HEALTH_DROPS]
    explained = rep["false_ok"] <= drops + ev_live * limit
    check(rep["false_over"] == 0, f"decided stream false_over {rep['false_over']}")
    check(explained, f"decided stream false_ok {rep['false_ok']} exceeds drops {drops} + {limit} x live evictions {ev_live}")
    live = S.live_slot_count(state.table, now)

    # the full decision: slab_step_packed on one 65536 block, its decision
    # rows against the standalone decide kernel, then against the plain
    # versions from a copy of the same table
    blk = decided_operand(ids[0, : BUCKETS[-1]], now)
    plain = S.SlabState(DECIDED_SLOTS, dev)
    plain.rows.copy_(state.rows)
    K.reset_launch_counts()
    out_k, health_k = S.slab_step_packed(state, blk, ways=ways)
    rows = out_k.view(torch.int32)
    op_dev = torch.from_numpy(blk.view(np.int32)).to(dev)
    order = rows[S.OUT_ORDER].long()
    sorted_in = [op_dev[r][order] for r in (S.ROW_HITS, S.ROW_LIMIT, S.ROW_DIVIDER)]
    fused = D.decide(rows[S.OUT_BEFORE], rows[S.OUT_AFTER], *sorted_in, now, 0.8)
    torch.cuda.synchronize()
    packed_launches = dict(K.LAUNCHES)
    want = dict.fromkeys(K.LAUNCHES, 0) | {"way_scan": 1, "slab_apply_decide": 1, "decide": 1}
    check(packed_launches == want, f"the packed step launched {packed_launches}, expected {want}")
    check(same(torch.stack(list(fused)), rows[: S.OUT_BEFORE]), "the standalone decide disagrees with the fused apply")
    with plain_kernels(M):
        out_p, health_p = S.slab_step_packed(plain, blk, ways=ways)
    check(same(out_k, out_p) and same(health_k, health_p), "slab_step_packed differs from the plain versions")
    check(same(state.table, plain.table), "slab_step_packed's table differs from the plain versions'")
    codes = rows[S.OUT_CODE]
    check(bool((codes == D.CODE_OK).any()) and bool((codes == D.CODE_OVER_LIMIT).any()), "the packed block lacks OK or OVER")
    check(bool((rows[S.OUT_NEAR] != 0).any()), "the packed block has no near-limit item")

    blk = decided_operand(ids[1, : BUCKETS[-1]], now)
    res_k = S.slab_update_and_decide(state, blk, ways=ways)
    with plain_kernels(M):
        res_p = S.slab_update_and_decide(plain, blk, ways=ways)
    check(
        all(same(a, b) for a, b in zip((res_k.before, res_k.after, *res_k.decision, res_k.health),
                                      (res_p.before, res_p.after, *res_p.decision, res_p.health))),
        "slab_update_and_decide differs from the plain versions",
    )
    check(same(state.table, plain.table), "slab_update_and_decide's table differs from the plain versions'")
    del plain
    torch.cuda.empty_cache()

    # the staged step's profile: no operand upload, no host-to-device copy
    prof = profile_call(lambda: staged_step(M, state, staged[1], now))
    check(prof["htod_ms"] < 0.1, f"the staged step copied {prof['htod_ms']:.3f} ms host to device")
    timed = n_launch - 1
    out = {
        "n_slots": DECIDED_SLOTS,
        "ways": ways,
        "batch": DECIDED_BATCH,
        "launches_timed": timed,
        "decisions_per_s": timed * DECIDED_BATCH / (s1 - s0),
        "step_ms_mean": (s1 - s0) * 1e3 / timed,
        "readback_ms": (s2 - s1) * 1e3,
        "decisions_per_s_host_operand": timed * DECIDED_BATCH / (t2 - t0),
        "step_ms_mean_host_operand": (t1 - t0) * 1e3 / timed,
        "readback_ms_host_operand": (t2 - t1) * 1e3,
        "device_busy_share_profiled": prof["device_busy_share"],
        "device_busy_share_timed": timed * prof["device_ms"] / ((s1 - s0) * 1e3),
        "parity": {**rep, "explained": explained},
        "health": dict(zip(("evict_expired", "evict_window", "evict_live", "drops", "algo_resets"), h)),
        "live_slots": live,
        "occupancy": live / DECIDED_SLOTS,
        "plain_twin_blocks": PLAIN_TWIN_BLOCKS,
        "stream_s": t_gen,
        "twin_s": t_twin,
        "phase_s": time.perf_counter() - t_phase,
    }
    log(
        f"decided: false_over {rep['false_over']} explained {str(explained).lower()} agreement {rep['agreement']}"
        f" decisions/s {out['decisions_per_s']:.0f} (staged ids) {out['decisions_per_s_host_operand']:.0f} (host operands)"
        f" phase {out['phase_s']:.1f} s"
    )
    log("decided:", json.dumps(out))
    log("decided launches:", json.dumps({"staged_stream": decided_launches, "host_operand_stream": host_launches, "packed_step": packed_launches}))
    log("decided profile:", json.dumps(prof))
    launches = {
        "slab_apply_lean": decided_launches["slab_apply_lean"],
        "slab_apply_decide": packed_launches["slab_apply_decide"],
        "decide": packed_launches["decide"],
    }
    # the way scan at this shape: the stream's table and one staged block
    probe = expand_ids(S, staged[1])
    scan = {"table": state.table, "fp_lo": probe.fp_lo, "fp_hi": probe.fp_hi, "launches": decided_launches["way_scan"]}
    return out, launches, scan


def select_inputs(rng, n: int) -> np.ndarray:
    """Full-range int32 with every edge value (and its neighbours) first."""
    x = rng.integers(INT_MIN, INT_MAX, n, dtype=np.int64, endpoint=True).astype(np.int32)
    edges = np.array([e + d for e in SELECT_EDGES for d in (-1, 0, 1)], np.int64)
    edges = ((edges + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)
    x[: edges.size] = edges
    return x


def tool_input(n: int) -> np.ndarray:
    """The tool's first input: RandomState(0).randint(0, 2^31) as int32."""
    return np.random.RandomState(0).randint(0, 1 << 31, size=n).astype(np.int32)


def phase_compare_paths(M, dev) -> tuple[dict, dict]:
    """sel and chain against their plain versions, bit-exact: at b = 2^20
    (full range with the edges, and the tool's own input), at a length that
    is not a multiple of 128, and on a buffer off 16-byte alignment (the
    kernels' scalar path). Then the port's tool in process at its default
    b = 2^20 (its JSON line prints here): the main path of both kernels.
    Returns (max abs errors, the tool run's launch counts)."""
    K, SEL, CMP = M.K, M.SEL, M.CMP
    rng = np.random.default_rng(4)
    full = torch.from_numpy(select_inputs(rng, SELECT_BATCH + 1)).to(dev)
    cases = {
        "b=2^20 full range": full[:SELECT_BATCH],
        "b=2^20 tool input": torch.from_numpy(tool_input(SELECT_BATCH)).to(dev),
        "b=2^20-37": full[: SELECT_BATCH - 37].clone(),
        "unaligned b=2^20": full[1:],
    }
    err = {"sel": 0, "chain": 0}
    for label, x in cases.items():
        for name, kernel, plain in (("sel", SEL.sel, SEL.sel_plain), ("chain", SEL.chain, SEL.chain_plain)):
            got = kernel(x)
            want = plain(x)
            torch.cuda.synchronize()
            e = max_abs_err([got], [want])
            check(e == 0, f"{name} differs from its plain version on {label}")
            err[name] = max(err[name], e)
    edges = torch.tensor(SELECT_EDGES, dtype=torch.int32, device=dev)
    got = SEL.sel(edges).cpu().tolist()
    check(got[0] == INT_MIN and got[2] == INT_MAX, f"sel wraps wrongly at the int32 edges: {got}")
    check(SEL.chain(edges).cpu().tolist() == SEL.chain_plain(edges.cpu()).tolist(), "chain differs at the int32 edges")
    K.reset_launch_counts()
    results = CMP.main(["--batch", str(SELECT_BATCH)])
    launches = dict(K.LAUNCHES)
    want = dict.fromkeys(K.LAUNCHES, 0) | {"sel": launches["sel"], "chain": launches["chain"]}
    check(launches["sel"] > 0 and launches["chain"] > 0 and launches == want, f"the tool launched {launches}")
    check(results["platform"] == "cuda" and results["batch"] == SELECT_BATCH, f"unexpected tool header {results}")
    log(f"compare-paths: bit-exact on {list(cases)} and the int32 edges; tool launches {launches}")
    return err, {"sel": launches["sel"], "chain": launches["chain"]}


def windowed_engines(M, dev) -> tuple[dict, dict]:
    """The three arms at the reference's default deployment: 2^22 slots,
    W=128, the production sketch, max_batch 65536, buckets 128 ... 65536,
    precompiled; the windowed two at TPU_BATCH_WINDOW=200us."""
    common = {
        "n_slots": N_SLOTS, "ways": 128, "buckets": BUCKETS, "device": dev,
        "hotkey_lanes": HOTKEY_LANES, "hotkey_k": HOTKEY_K, "max_batch": BUCKETS[-1], "precompile": True,
    }
    arms = {
        "dispatch_loop": {"batch_window_seconds": WINDOW_S, "dispatch_loop": True},
        "leader_collects": {"batch_window_seconds": WINDOW_S, "dispatch_loop": False},
        "direct": {"batch_window_seconds": 0.0},
    }
    clocks = {name: M.utils.FakeTimeSource(NOW0) for name in arms}
    engines = {name: M.cuda_mod.SlabDeviceEngine(clocks[name], **common, **kw) for name, kw in arms.items()}
    for name, eng in engines.items():
        check(len(eng.precompiled) == 3 * len(BUCKETS), f"{name} engine did not warm every shape")
        check((eng.dispatch_loop is not None) == (name == "dispatch_loop"), f"{name} engine has the wrong arm")
    return engines, clocks


def arm_batches(name: str, engine) -> tuple[int, int]:
    """(batches launched, of which launched while another was in flight)
    as the arm itself counts them."""
    counter = engine.dispatch_loop if name == "dispatch_loop" else engine.batcher
    return counter.launches, counter.overlapped_launches


def concurrent_run(engine, blocks: list) -> tuple[float, np.ndarray]:
    """CLIENT_THREADS threads, each submitting its share of the
    single-descriptor blocks one at a time; returns (wall seconds,
    per-request latencies in ms)."""
    lat = [[] for _ in range(CLIENT_THREADS)]
    start = threading.Barrier(CLIENT_THREADS + 1)
    errors = []

    def client(k):
        mine = blocks[k::CLIENT_THREADS]
        out = lat[k]
        start.wait()
        try:
            for block in mine:
                t0 = time.perf_counter()
                engine.submit_rows(block)
                out.append((time.perf_counter() - t0) * 1e3)
        except BaseException as e:  # noqa: BLE001 - reported by the caller
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,), daemon=True) for k in range(CLIENT_THREADS)]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(600.0)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "a client thread hung")
    check(not errors, f"a client failed: {errors[:1]}")
    return wall, np.concatenate([np.asarray(x) for x in lat])


def check_counts(engine, block: np.ndarray, label: str) -> dict:
    """Every key's count in the table equals its total hits in `block`
    (1 per request), short only by what the lossy events explain: each
    drop or live eviction shortens at most one key. No key may exceed its
    hits."""
    table = engine.export_tables()[0]
    live = table[table[:, 4].astype(np.int64) > NOW0]
    check(live.shape[0] > 0, f"{label}: no live row after the run")
    fp = (live[:, 1].astype(np.uint64) << np.uint64(32)) | live[:, 0].astype(np.uint64)
    order = np.argsort(fp)
    fp, stored = fp[order], live[order, 2].astype(np.int64)
    req = (block[1].astype(np.uint64) << np.uint64(32)) | block[0].astype(np.uint64)
    keys, hits = np.unique(req, return_counts=True)
    pos = np.minimum(np.searchsorted(fp, keys), fp.size - 1)
    counts = np.where(fp[pos] == keys, stored[pos], 0)
    snap = engine.health_snapshot()
    short = int((counts < hits).sum())
    check(not (counts > hits).any(), f"{label}: a key counted more than its hits")
    check(short <= snap["drops"] + snap["evictions_live"], f"{label}: {short} keys short, {snap['drops']} drops, {snap['evictions_live']} live evictions")
    check(snap["decisions"] == block.shape[1], f"{label}: decisions {snap['decisions']} != {block.shape[1]} items")
    return {"keys": int(keys.size), "short_keys": short, "drops": snap["drops"], "evictions_live": snap["evictions_live"], "decisions": snap["decisions"]}


def phase_windowed(M, dev) -> dict:
    """The windowed serving path (module docstring, phase 7)."""
    K = M.K
    t_phase = time.perf_counter()
    rng = np.random.default_rng(6)
    sizes = rng.integers(1, 65, SERIAL_SUBMITS)
    serial = key_block(zipf_keys(rng, int(sizes.sum())))
    stream = key_block(zipf_keys(rng, WINDOWED_REQUESTS))
    engines, clocks = windowed_engines(M, dev)
    off = 0
    for i, n in enumerate(sizes):
        if i % 50 == 49:
            for clock in clocks.values():
                clock.advance(61)
        block = np.ascontiguousarray(serial[:, off : off + n])
        off += n
        # a copy: the loop's result is a view of the thread's ticket buffer
        outs = {name: eng.submit_rows(block).copy() for name, eng in engines.items()}
        want = outs["direct"].tobytes()
        check(all(o.tobytes() == want for o in outs.values()), f"windowed arms answer differently at serial submit {i}")
    tables = {name: eng.export_tables()[0] for name, eng in engines.items()}
    check(all(np.array_equal(t, tables["direct"]) for t in tables.values()), "windowed arms leave different tables")
    sketches = [eng.export_sketch() for eng in engines.values()]
    check(all(np.array_equal(s, sketches[0]) for s in sketches), "windowed arms leave different sketch planes")
    health = [eng.health_snapshot() for eng in engines.values()]
    check(all(h == health[0] for h in health), f"windowed arms report different health: {health}")
    t_serial = time.perf_counter() - t_phase
    for eng in engines.values():
        eng.close()
    del engines, tables
    torch.cuda.empty_cache()

    out = {"serial_submits": int(SERIAL_SUBMITS), "serial_items": int(sizes.sum()), "serial_s": t_serial, "window_s": WINDOW_S, "threads": CLIENT_THREADS}
    engines, _clocks = windowed_engines(M, dev)
    for name, eng in engines.items():
        n_req = DIRECT_REQUESTS if name == "direct" else WINDOWED_REQUESTS
        blocks = [np.ascontiguousarray(stream[:, i : i + 1]) for i in range(n_req)]
        batches0, overlapped0 = arm_batches(name, eng)
        K.reset_launch_counts()
        wall, lat = concurrent_run(eng, blocks)
        eng.flush()
        launches = dict(K.LAUNCHES)
        batches, overlapped = arm_batches(name, eng)
        batches -= batches0
        overlapped -= overlapped0
        want = dict.fromkeys(K.LAUNCHES, 0) | {"way_scan": batches, "slab_apply": batches, "sketch_update": batches}
        check(launches == want, f"{name}: launches {launches} against {batches} batches")
        counts = check_counts(eng, stream[:, :n_req], name)
        mean_batch = n_req / batches
        probe = np.ascontiguousarray(stream[:, : max(1, round(mean_batch))])
        prof = profile_call(lambda eng=eng, probe=probe: eng.submit_rows(probe))
        out[name] = {
            "requests": n_req,
            "requests_per_s": n_req / wall,
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "batches": batches,
            "mean_batch": mean_batch,
            "overlapped_launches": overlapped,
            "device_busy_share_profiled_batch": prof["device_busy_share"],
            "profiled_batch_items": int(probe.shape[1]),
            "profiled_batch_wall_ms": prof["wall_ms"],
            "profiled_batch_device_ms": prof["device_ms"],
            "wall_s": wall,
            "launches": launches,
            **counts,
        }
        log(
            f"windowed {name}: {n_req} requests from {CLIENT_THREADS} threads, {out[name]['requests_per_s']:.0f} req/s,"
            f" p50 {out[name]['p50_ms']:.3f} ms p99 {out[name]['p99_ms']:.3f} ms, {batches} batches (mean {mean_batch:.2f},"
            f" {overlapped} launched while another was in flight), busy {prof['device_busy_share']:.3f}"
        )
        eng.close()
    del engines
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log("windowed:", json.dumps(out))
    return out


def served_sketch_args(M, engine, rng) -> tuple:
    """The fused sketch update's operands in one real served step: one
    65536-item Zipf submit through the engine, its call recorded (the
    sorted fingerprints, the apply's segment weights, the candidate mask)."""
    SKT = M.SKT
    fused, seen = SKT.sketch_update_fused, []

    def record(*args):
        seen.append(args)
        return fused(*args)

    SKT.sketch_update_fused = record
    try:
        engine.submit_rows(key_block(zipf_keys(rng, BUCKETS[-1])))
    finally:
        SKT.sketch_update_fused = fused
    check(len(seen) == 1, f"one submit ran {len(seen)} sketch updates")
    return seen[0]


def kernel_report(M, engine, decided_scan: dict, dev, launches: dict, errs: dict) -> tuple[list, list]:
    """Times at each path's largest shape: the served path's b = 65536, W =
    128, over the engine phase's populated 2^22-slot table and 128-lane
    sketch (the sketch update over a real step's sorted candidates); the
    way scan also at the decided phase's b = 2^20 over its 2^23-slot table;
    the decision kernels at the decided phase's b = 2^20; sel and chain at
    the tool's b = 2^20 on its first input. ms, plain_ms and library_ms are
    median device times (device_ms); call_ms and plain_call_ms are
    CUDA-event medians around one call (call_ms). No single PyTorch call
    computes the way scan, the sketch's kernels, the decision, sel or chain
    (torch.where(x > NOW, x, -x) is three launches), so they have no
    library time; the applies' yardstick is the torch.cumsum of their
    hits, the first of their two scans, not the same function. Returns
    (the kernels line's rows, one per kernel of a path; the standalone
    sketch scan's row: off every path since the fused update took its
    place, it is timed at the served shape)."""
    K, SKK, D = M.K, M.SKK, M.D
    rng = np.random.default_rng(3)
    b, ways = BUCKETS[-1], 128
    table = engine._state.table
    lo, hi = (i32(a, dev) for a in fingerprints(zipf_keys(rng, b)))
    now = NOW0 + 200
    planes = engine._sketch
    ops = apply_inputs(rng, b, now, dev)
    sk = served_sketch_args(M, engine, rng)
    big_table, big_lo, big_hi = decided_scan["table"], decided_scan["fp_lo"], decided_scan["fp_hi"]
    big = big_lo.shape[0]
    # label -> (kernel call, plain call, plain iterations, library call)
    calls = {
        "way_scan": (
            lambda: K.way_scan(table, lo, hi, now, ways), lambda: K.way_scan_plain(table, lo, hi, now, ways), 5, None,
        ),
        "way_scan_decided": (
            lambda: K.way_scan(big_table, big_lo, big_hi, NOW0, DECIDED_WAYS),
            lambda: K.way_scan_plain(big_table, big_lo, big_hi, NOW0, DECIDED_WAYS), 3, None,
        ),
        "slab_apply": (
            lambda: K.slab_apply(*ops, now), lambda: K.slab_apply_plain(*ops, now), 20,
            lambda: torch.cumsum(ops[2], dim=0),
        ),
        "sketch_update": (lambda: SKK.sketch_update_fused(*sk), lambda: SKK.sketch_update_plain(*sk), 20, None),
    }
    big_ops, limit, dec_ops = decide_inputs(M, rng, big, now, dev)
    for name, lean in (("slab_apply_decide", False), ("slab_apply_lean", True)):
        kw = {"s_limit": limit, "near_ratio": 0.8, "decide": True, "lean": lean}
        calls[name] = (
            lambda kw=kw: K.slab_apply(*big_ops, now, **kw), lambda kw=kw: K.slab_apply_plain(*big_ops, now, **kw), 20,
            lambda: torch.cumsum(big_ops[2], dim=0),
        )
    calls["decide"] = (lambda: D.decide(*dec_ops, now, 0.8), lambda: D.decide_plain(*dec_ops, now, 0.8), 20, None)
    # the compare/select kernels on the tool's own first input
    x_sel = torch.from_numpy(tool_input(SELECT_BATCH)).to(dev)
    calls["sel"] = (lambda: M.SEL.sel(x_sel), lambda: M.SEL.sel_plain(x_sel), 20, None)
    calls["chain"] = (lambda: M.SEL.chain(x_sel), lambda: M.SEL.chain_plain(x_sel), 20, None)
    calls["sketch_scan"] = (
        lambda: SKK.sketch_scan(planes, lo, hi, ways), lambda: SKK.sketch_scan_plain(planes, lo, hi, ways), 20, None,
    )
    lanes = sk[0].shape[1]
    shape = {
        "way_scan": f"b={b}, W={ways}, {table.shape[0]}-slot table",
        "way_scan_decided": f"b={big}, W={DECIDED_WAYS}, {big_table.shape[0]}-slot table",
        "slab_apply": f"b={b}",
        "sketch_update": f"b={sk[1].shape[0]}, W={sk[5]}, {lanes} lanes, {int(sk[4].sum())} candidates",
        "slab_apply_decide": f"b={big}",
        "slab_apply_lean": f"b={big}",
        "decide": f"b={big}",
        "sel": f"b={SELECT_BATCH}",
        "chain": f"b={SELECT_BATCH}",
        "sketch_scan": f"b={b}, W={ways}, {planes.shape[1]} lanes",
    }

    def sets_read(tbl, fp_lo, w):
        return int(torch.unique(fp_lo & (tbl.shape[0] // w - 1)).numel())

    # way scan: each distinct set is read once (Zipf traffic repeats
    # sets), plus the per-item queries and outputs; sketch update: fp_lo,
    # fp_hi, weight and the cand byte per item, the planes read once and
    # written once; sketch scan: the 8-byte query in and 13 bytes out per
    # item, the planes read once; the applies: 5 (decided 6) int32 planes,
    # the seg_start byte and 5 stored-row words in, 4 (decided 10, lean 5)
    # planes out; decide: 5 planes in, 6 out
    nbytes = {
        "way_scan": sets_read(table, lo, ways) * ways * 32 + b * (8 + 4 + 1 + 32),
        "way_scan_decided": sets_read(big_table, big_lo, DECIDED_WAYS) * DECIDED_WAYS * 32 + big * (8 + 4 + 1 + 32),
        "slab_apply": b * (5 * 4 + 1 + 5 * 4 + 4 * 4),
        "sketch_update": sk[1].shape[0] * (4 + 4 + 4 + 1) + 2 * sk[0].numel() * 4,
        "slab_apply_decide": big * (6 * 4 + 1 + 5 * 4 + 10 * 4),
        "slab_apply_lean": big * (6 * 4 + 1 + 5 * 4 + 5 * 4),
        "decide": big * (5 * 4 + 6 * 4),
        "sel": SELECT_BATCH * (4 + 4),
        "chain": SELECT_BATCH * (4 + 4),
        "sketch_scan": b * (8 + 13) + planes.numel() * 4,
    }
    kernel_launches = launches | {"way_scan_decided": decided_scan["launches"]}
    rows = []
    for label, (kernel, plain, plain_iters, library) in calls.items():
        name = "way_scan" if label == "way_scan_decided" else label
        rows.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "shape": shape[label],
            "launches": kernel_launches[label],
            "max_abs_err": errs[name],
            "ms": device_ms(kernel),
            "plain_ms": device_ms(plain, iters=plain_iters),
            "bound_ms": nbytes[label] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": None if library is None else device_ms(library),
            "call_ms": call_ms(kernel),
            "plain_call_ms": call_ms(plain, iters=plain_iters),
        })
    log("sketch update, the parent's two-kernel form beside the fused kernel:", json.dumps(two_kernel_sketch(M, sk)))
    standalone = [row for row in rows if row["name"] == "sketch_scan"]
    return [row for row in rows if row["name"] != "sketch_scan"], standalone


def two_kernel_sketch(M, sk: tuple) -> dict:
    """The served sketch update as it ran before the fused kernel, on the
    same operands: the standalone scan kernel, then phases A and B as torch
    ops (sketch_update_plain with scan=sketch_scan). Its device ms and activities beside the fused kernel's, and its
    glue: its device ms less the scan's. It must give the fused planes."""
    SKK = M.SKK

    def two_kernel():
        return SKK.sketch_update_plain(*sk, scan=SKK.sketch_scan)

    check(same(two_kernel(), SKK.sketch_update_fused(*sk)), "the two-kernel sketch update differs from the fused kernel")
    planes, lo, hi, _weight, _cand, ways = sk
    out = {
        "two_kernel_ms": device_ms(two_kernel),
        "two_kernel_call_ms": call_ms(two_kernel),
        "two_kernel_activities": activities_per_call(two_kernel),
        "scan_ms": device_ms(lambda: SKK.sketch_scan(planes, lo, hi, ways)),
        "fused_ms": device_ms(lambda: SKK.sketch_update_fused(*sk)),
        "fused_call_ms": call_ms(lambda: SKK.sketch_update_fused(*sk)),
        "fused_activities": activities_per_call(lambda: SKK.sketch_update_fused(*sk)),
    }
    out["glue_ms"] = out["two_kernel_ms"] - out["scan_ms"]
    return out


def ptxas_entries(text: str, kernel: str) -> list:
    """`nvcc -Xptxas -v`'s report for each compiled entry whose mangled name
    holds `kernel`: registers, barriers, shared memory, stack and spills,
    one string an entry. Empty when the library came from an earlier
    build."""
    out, cur = [], None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            cur = [line.split("'")[1]] if kernel in line else None
            if cur is not None:
                out.append(cur)
        elif cur is not None and ("spill" in line or "Used" in line):
            cur.append(line.split(" : ", 1)[-1].strip())
    return [" | ".join(c) for c in out]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    from api_ratelimit_tpu_torch import utils
    from api_ratelimit_tpu_torch.backends import cuda as cuda_mod
    from api_ratelimit_tpu_torch.ops import decide as D
    from api_ratelimit_tpu_torch.ops import sketch as SKT
    from api_ratelimit_tpu_torch.ops import sketch_kernels as SKK
    from api_ratelimit_tpu_torch.ops import slab as S
    from api_ratelimit_tpu_torch.ops import slab_kernels as K
    from api_ratelimit_tpu_torch.ops import select_kernels as SEL
    from api_ratelimit_tpu_torch.testing import oracle as O
    from api_ratelimit_tpu_torch.tools import microbench_compare_paths as CMP

    M = types.SimpleNamespace(
        K=K, S=S, SKK=SKK, SKT=SKT, D=D, O=O, SEL=SEL, CMP=CMP, cuda_mod=cuda_mod, utils=utils
    )
    dev = torch.device("cuda")
    log("torch", torch.__version__, "cuda", torch.version.cuda, "device", torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    K.build()
    srcs = [os.path.basename(p) for p in K.sources()]
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {K.BUILD_LOG.get('seconds', 0.0):.1f} s) from {srcs}")
    log(K.BUILD_LOG.get("ptxas", "").strip())
    log("apply kernel ptxas:", json.dumps(ptxas_entries(K.BUILD_LOG.get("ptxas", ""), "slab_apply_kernel")))

    errs = phase_parity(M, dev)
    engine = phase_engine(M, dev)
    launches = phase_serve(K)
    _decided, decided_launches, decided_scan = phase_decided(M, dev)
    select_errs, select_launches = phase_compare_paths(M, dev)
    phase_windowed(M, dev)
    kernels, standalone = kernel_report(
        M, engine, decided_scan, dev, launches | decided_launches | select_launches, errs | select_errs
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    log(smi.stdout.strip())
    log("standalone kernels (off every path):", json.dumps({"kernels": standalone}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
