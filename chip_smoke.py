"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each of which must pass (nothing is caught):

1. build   nvcc-compiles api_ratelimit_tpu_torch/csrc/slab_kernels.cu.
2. parity  each kernel against its plain PyTorch version on the card,
           bit-exact, at every bucket (128 ... 65536) and W in {4, 128},
           on adversarial inputs (segments across the apply kernel's
           1024-item chunks, window rollovers, all eviction tiers, one-set
           contention, padding lanes, counts >= 2^31).
3. engine  SlabDeviceEngine at 2^22 slots (128 MiB), W=128, Zipf(1.1) over
           2^20 keys: 32 launches at the 65536 bucket plus the smaller
           buckets, the clock crossing window edges, against an engine
           whose kernels are swapped for their plain versions; afters,
           table bytes and health must be identical.
4. serve   the port's HTTP server (device="cuda", default 2^22 slots) with a
           two-rule config built from a mapping answers /json requests that
           cross a limit: 200 then 429, bodies equal to the same stream
           served on the CPU. Both kernels' launch counters must rise here.
5. report  per-kernel times (CUDA events), bounds and launches as one JSON
           line, the card's name and power limit, then the ok line.

Exits non-zero, printing no result, without a CUDA device. Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import http.client
import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak
BUCKETS = (128, 1024, 8192, 65536)
N_SLOTS = 1 << 22  # the TPU_SLAB_SLOTS default: 128 MiB of rows
NOW0 = 1_700_000_000
SOURCE = "api_ratelimit_tpu_torch/csrc/slab_kernels.cu"
REPLACES = {
    "way_scan": "api_ratelimit_tpu/ops/pallas_slab.py:312",
    "slab_apply": "api_ratelimit_tpu/ops/pallas_slab.py:371",
}


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
    segments cross the kernel's 1024-item chunks), hits up to 2^31 (sums
    wrap), stored rows that match in and out of the current window, and
    hits == 0 padding at the tail."""
    runs = rng.integers(1, 3000 if b > 1024 else 40, b)
    keys = np.repeat(np.arange(b), runs)[:b]
    lo, hi = fingerprints(keys)
    hits = np.where(rng.random(b) < 0.05, rng.integers(0, 1 << 31, b), rng.integers(1, 4, b)).astype(np.uint32)
    hits[-b // 16 :] = 0
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


def max_abs_err(got, want) -> int:
    err = 0
    for g, w in zip(got, want):
        check(g.dtype == w.dtype and g.shape == w.shape, "kernel output shape/dtype differs")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def time_ms(fn, iters: int = 20) -> float:
    """Median milliseconds of one call, by CUDA events, after a warm-up."""
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
def plain_kernels(K, S):
    """Route the slab step (ops/slab.py, which calls the wrappers by the
    names it imported) through the plain versions even for CUDA tensors:
    the reference engine of the engine phase. Fails unless the block
    launched no kernel, so the reference can never be the kernels."""
    saved = S.way_scan, S.slab_apply
    before = dict(K.LAUNCHES)
    S.way_scan, S.slab_apply = K.way_scan_plain, K.slab_apply_plain
    try:
        yield
    finally:
        S.way_scan, S.slab_apply = saved
    check(K.LAUNCHES == before, f"the plain engine launched kernels: {before} -> {K.LAUNCHES}")


def phase_parity(K, dev) -> dict:
    rng = np.random.default_rng(1)
    n_slots = N_SLOTS
    err = {"way_scan": 0, "slab_apply": 0}
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
    log(f"parity: bit-exact at buckets {BUCKETS}, W in (4, 128)")
    return err


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


def phase_engine(K, S, cuda_mod, utils, dev):
    rng = np.random.default_rng(2)
    clock_k, clock_p = utils.FakeTimeSource(NOW0), utils.FakeTimeSource(NOW0)
    eng_k = cuda_mod.SlabDeviceEngine(clock_k, n_slots=N_SLOTS, device=dev)
    eng_p = cuda_mod.SlabDeviceEngine(clock_p, n_slots=N_SLOTS, device=dev)
    check(eng_k.ways == 128, "engine did not default to 128 ways on cuda")
    top = BUCKETS[-1]
    sizes = [top] * 32 + [b - b // 8 for b in BUCKETS[:-1]]
    launch_ms = {"kernel": [], "plain": []}
    for i, n in enumerate(sizes):
        step = 61 if i % 8 == 7 else 1  # cross minute windows too
        clock_k.advance(step)
        clock_p.advance(step)
        block = key_block(zipf_keys(rng, n))
        torch.cuda.synchronize()
        before = dict(K.LAUNCHES)
        t0 = time.perf_counter()
        got = eng_k.submit_rows(block)
        t1 = time.perf_counter()
        check(all(K.LAUNCHES[k] > before[k] for k in before), f"the kernel engine skipped a kernel at launch {i}")
        with plain_kernels(K, S):
            want = eng_p.submit_rows(block)
        t2 = time.perf_counter()
        if n == top:
            launch_ms["kernel"].append((t1 - t0) * 1e3)
            launch_ms["plain"].append((t2 - t1) * 1e3)
        check(np.array_equal(got, want), f"engine afters differ at launch {i}")
    check(np.array_equal(eng_k.export_tables()[0], eng_p.export_tables()[0]), "engine tables differ")
    hk, hp = eng_k.health_snapshot(), eng_p.health_snapshot()
    check(hk == hp, f"engine health differs: {hk} vs {hp}")
    check(hk["decisions"] == sum(sizes), "decision count is off")
    out = {
        "n_slots": N_SLOTS,
        "ways": eng_k.ways,
        "launches": len(sizes),
        "step_ms_median_kernel": float(np.median(launch_ms["kernel"])),
        "step_ms_median_plain": float(np.median(launch_ms["plain"])),
        "health": hk,
    }
    log("engine:", json.dumps(out))
    return eng_k


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


def serve(device: str, bodies):
    """Start the port's server on an ephemeral port, POST `bodies`, stop it.
    Returns [(status, body bytes)]."""
    from api_ratelimit_tpu_torch.backends.cuda import CudaRateLimitCache
    from api_ratelimit_tpu_torch.config import ConfigDoc, build_config
    from api_ratelimit_tpu_torch.limiter import BaseRateLimiter
    from api_ratelimit_tpu_torch.server.http_server import HttpServer
    from api_ratelimit_tpu_torch.service import RateLimitService
    from api_ratelimit_tpu_torch.stats import Store
    from api_ratelimit_tpu_torch.utils import FakeTimeSource

    clock = FakeTimeSource(NOW0)
    store = Store()
    rules_scope = store.scope("ratelimit").scope("rate_limit")
    cache = CudaRateLimitCache(BaseRateLimiter(clock), n_slots=N_SLOTS, device=device)
    service = RateLimitService(
        _Runtime(), cache, store.scope("ratelimit"), clock,
        config_loader=lambda _files: build_config([ConfigDoc("smoke", RULES)], rules_scope),
    )
    server = HttpServer(service)
    server.serve_background()
    out = []
    try:
        for body in bodies:
            conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
            try:
                conn.request("POST", "/json", body=body, headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                out.append((resp.status, resp.read()))
            finally:
                conn.close()
    finally:
        server.shutdown()
    return out


def phase_serve(K) -> dict:
    def req(*descs):
        return json.dumps({"domain": "smoke", "descriptors": [{"entries": [{"key": k, "value": v}]} for k, v in descs]}).encode()

    bodies = [req(("user", "alice"), ("path", "/login")) for _ in range(5)] + [req(("user", "bob"))]
    K.reset_launch_counts()
    got = serve("cuda", bodies)
    launches = dict(K.LAUNCHES)
    want = serve("cpu", bodies)
    check(launches["way_scan"] > 0 and launches["slab_apply"] > 0, f"main path skipped a kernel: {launches}")
    statuses = [s for s, _ in got]
    check(statuses == [200, 200, 200, 429, 429, 200], f"unexpected statuses {statuses}")
    check(got == want, "card and CPU responses differ")
    first, fourth = json.loads(got[0][1]), json.loads(got[3][1])
    reset = f"{60 - NOW0 % 60}s"
    check(
        first["statuses"][0] == {"code": "OK", "currentLimit": {"requestsPerUnit": 3, "unit": "MINUTE"}, "limitRemaining": 2, "durationUntilReset": reset},
        f"unexpected first body {first}",
    )
    check(fourth["overallCode"] == "OVER_LIMIT" and fourth["statuses"][1]["limitRemaining"] == 96, f"unexpected fourth body {fourth}")
    log(f"serve: statuses {statuses}, launches {launches}")
    return launches


def kernel_report(K, engine, dev, launches: dict, errs: dict) -> list:
    """Times at the main path's largest shape: b = 65536, W = 128, over the
    engine phase's populated 2^22-slot table."""
    rng = np.random.default_rng(3)
    b, ways = BUCKETS[-1], 128
    table = engine._state.table
    lo, hi = (i32(a, dev) for a in fingerprints(zipf_keys(rng, b)))
    now = NOW0 + 200
    scan_ms = time_ms(lambda: K.way_scan(table, lo, hi, now, ways))
    scan_plain_ms = time_ms(lambda: K.way_scan_plain(table, lo, hi, now, ways), iters=5)
    # each distinct set is read once (Zipf traffic repeats sets), plus the
    # per-item queries and outputs
    n_sets = table.shape[0] // ways
    sets_read = int(torch.unique(lo & (n_sets - 1)).numel())
    scan_bytes = sets_read * ways * 32 + b * (8 + 4 + 1 + 32)
    ops = apply_inputs(rng, b, now, dev)
    apply_ms = time_ms(lambda: K.slab_apply(*ops, now))
    apply_plain_ms = time_ms(lambda: K.slab_apply_plain(*ops, now))
    cumsum_ms = time_ms(lambda: torch.cumsum(ops[2], dim=0))
    apply_bytes = b * (5 * 4 + 1 + 5 * 4 + 4 * 4)
    rows = []
    for name, ms, plain_ms, nbytes, lib_ms in (
        ("way_scan", scan_ms, scan_plain_ms, scan_bytes, None),
        ("slab_apply", apply_ms, apply_plain_ms, apply_bytes, cumsum_ms),
    ):
        rows.append({
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": lib_ms,
        })
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    from api_ratelimit_tpu_torch import utils
    from api_ratelimit_tpu_torch.backends import cuda as cuda_mod
    from api_ratelimit_tpu_torch.ops import slab as S
    from api_ratelimit_tpu_torch.ops import slab_kernels as K

    dev = torch.device("cuda")
    log("torch", torch.__version__, "cuda", torch.version.cuda, "device", torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    K.build()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {K.BUILD_LOG.get('seconds', 0.0):.1f} s)")
    log(K.BUILD_LOG.get("ptxas", "").strip())

    errs = phase_parity(K, dev)
    engine = phase_engine(K, S, cuda_mod, utils, dev)
    launches = phase_serve(K)
    kernels = kernel_report(K, engine, dev, launches, errs)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    log(smi.stdout.strip())
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
