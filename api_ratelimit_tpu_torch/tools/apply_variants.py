"""What holds the INCRBY apply kernel above its byte bound? Builds variants
of csrc/slab_kernels.cu, each a text edit of the shipped source, and times
every form of the apply against the shipped kernel on one card.

    python -m api_ratelimit_tpu_torch.tools.apply_variants [--batch 1048576]

Variants (VARIANTS): `shipped`; `release_acquire` (the look-back's status
words written with st.release and read with ld.acquire instead of relaxed);
`shared_lines` (the status words packed 16 to a 128-byte line instead of
one a line); `cached_planes` (the operand planes read and written through
the default cache policy instead of streaming); `tile_256` (256 threads a
block, 1024-item tiles); `no_look_back` (each tile takes a prefix of 0:
wrong results, timing only) and `no_look_back_no_rows` (also no stored-row
copy). Each variant builds into its own directory under the package's
build/variants/ (one nvcc per source, as ops/slab_kernels.py build() does),
removed at the end. Every variant but the last two is first held bit for
bit against the plain version in all four forms.

Times are CUDA events around one launch (the scratch memset included) after
a spin kernel that keeps the card busy while the host enqueues it: the
median of --launches launches, for after mode at 65536 and --batch items,
and the decided and lean forms at --batch. Beside them, `clone_ms`: a clone
of the lean form's real bytes (read and written once) by the same method,
the card's reachable copy rate. Prints one JSON line with the card's name.
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import numpy as np
import torch

from ..ops import slab_kernels as K

NOW = 1_700_000_000
SPIN_CYCLES = 2_000_000  # ~1 ms: longer than the wrapper's host time
NO_LOOK_BACK = ("for (int window = tile - 1;; window -= 32) {", "for (int window = tile - 1; false; window -= 32) {")
NO_ROWS = ("    if (warp_i0 + v / 2 >= b) continue;", "    continue;")
VARIANTS = {
    "shipped": [],
    "release_acquire": [
        ("st.relaxed.gpu.global.u64", "st.release.gpu.global.u64"),
        ("ld.relaxed.gpu.global.u64", "ld.acquire.gpu.global.u64"),
    ],
    "shared_lines": [("constexpr int kStatusStride = 16;", "constexpr int kStatusStride = 1;")],
    "cached_planes": [
        ("__ldcs(reinterpret_cast<const int4*>", "__ldg(reinterpret_cast<const int4*>"),
        ("__ldcs(reinterpret_cast<const uchar4*>", "__ldg(reinterpret_cast<const uchar4*>"),
        ("__stcs(reinterpret_cast<int4*>(p + i0) + q,", "__stwb(reinterpret_cast<int4*>(p + i0) + q,"),
    ],
    "tile_256": [("constexpr int kApplyThreads = 128;", "constexpr int kApplyThreads = 256;")],
    "no_look_back": [NO_LOOK_BACK],
    "no_look_back_no_rows": [NO_LOOK_BACK, NO_ROWS],
}
EXACT = ("shipped", "release_acquire", "shared_lines", "cached_planes", "tile_256")


def operands(rng, b: int, dev):
    """A slot-sorted batch: runs of one key up to 3000 long, 5% of hits up
    to 2^31, stored rows half live and matching, limits around the sums."""
    runs = rng.integers(1, 3000, b)
    n_runs = int(np.searchsorted(np.cumsum(runs), b)) + 1  # the runs that fill b items
    keys = np.repeat(np.arange(n_runs), runs[:n_runs])[:b].astype(np.uint32)
    hits = np.where(rng.random(b) < 0.05, rng.integers(0, 1 << 31, b), rng.integers(1, 4, b)).astype(np.uint32)
    st = rng.integers(0, 1 << 32, (b, 8), dtype=np.uint64).astype(np.uint32)
    st[:, 0], st[:, 1] = keys, keys ^ np.uint32(0x9E3779B9)
    st[:, 3] = NOW - NOW % 60
    st[:, 4] = np.where(rng.random(b) < 0.5, NOW + 100, 0)
    seg = np.concatenate([[True], keys[1:] != keys[:-1]])
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)  # noqa: E731
    ops = (
        i32(keys), i32(st[:, 1]), i32(hits), i32(np.full(b, 60, np.uint32)),
        i32(rng.integers(0, 30, b).astype(np.uint32)), torch.from_numpy(seg).to(dev), i32(st),
    )
    limit = i32(rng.integers(0, 1 << 32, b, dtype=np.uint64).astype(np.uint32))
    return ops, limit


def launch_ms(fn, launches: int) -> float:
    """Median CUDA-event time of one launch of fn, queued behind a spin
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


def build_variant(csrc: str, root: str, name: str, edits) -> None:
    """Point ops/slab_kernels.py at a copy of `csrc` with `edits` applied to
    slab_kernels.cu and build it."""
    src_dir = os.path.join(root, name, "csrc")
    shutil.copytree(csrc, src_dir)
    path = os.path.join(src_dir, "slab_kernels.cu")
    with open(path) as f:
        text = f.read()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} is not in the source")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    K.CSRC_DIR, K.BUILD_DIR, K._lib = src_dir, os.path.join(root, name, "build"), None
    K.build()


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=1 << 20)
    parser.add_argument("--launches", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    dev = K.resolve_device("cuda")
    rng = np.random.default_rng(args.seed)
    big, limit = operands(rng, args.batch, dev)
    small, _ = operands(rng, 65536, dev)
    forms = {
        "after_65536": lambda: K.slab_apply(*small, NOW),
        "after": lambda: K.slab_apply(*big, NOW),
        "decided": lambda: K.slab_apply(*big, NOW, s_limit=limit, decide=True),
        "lean": lambda: K.slab_apply(*big, NOW, s_limit=limit, decide=True, lean=True),
    }
    lean_bytes = args.batch * (6 * 4 + 1 + 32 + 5 * 4)  # a stored row is one 32-byte sector
    copy = torch.empty(lean_bytes // 4, dtype=torch.int32, device=dev)
    out = {"device": torch.cuda.get_device_name(0), "batch": args.batch, "launches": args.launches,
           "clone_ms": launch_ms(lambda: copy.clone(), args.launches), "clone_bytes": lean_bytes}
    csrc, build_dir = K.CSRC_DIR, K.BUILD_DIR
    root = os.path.join(build_dir, "variants")
    os.makedirs(root, exist_ok=True)
    try:
        for name, edits in VARIANTS.items():
            build_variant(csrc, root, name, edits)
            if name in EXACT:
                for kw in ({}, {"weight": True}, {"s_limit": limit, "decide": True}, {"s_limit": limit, "decide": True, "lean": True}):
                    got = K.slab_apply(*big, NOW, **kw)
                    want = K.slab_apply_plain(*big, NOW, **kw)
                    if not all(torch.equal(g, w) for g, w in zip(got, want)):
                        raise RuntimeError(f"variant {name} differs from the plain version ({kw})")
            out[name] = {form: launch_ms(fn, args.launches) for form, fn in forms.items()}
            print(name, json.dumps(out[name]), file=sys.stderr, flush=True)
    finally:
        K.CSRC_DIR, K.BUILD_DIR, K._lib = csrc, build_dir, None
        shutil.rmtree(root)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
