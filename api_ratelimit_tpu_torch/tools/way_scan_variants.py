"""What holds the set-major way scan above its byte bound? Builds variants of
csrc/slab_kernels.cu, each a text edit of the shipped source, and times the
set-major form of every variant, launch by launch, on one card.

    python -m api_ratelimit_tpu_torch.tools.way_scan_variants [--launches 30]

Variants (VARIANTS): `shipped`; `no_prefetch` (a warp copies a run's
set only once it is done with the one before, so nothing overlaps a set's
DRAM latency); `warp_count` (the histogram's first design: one atomic a
set a warp, no shared-memory count per block); `picked_streaming` (the
picked rows stored with st.global.cs); `scatter_streaming` (the scatter
reads fp_lo, fp_hi and the ranks with ld.global.cs); `records_32` (each
grouped record padded to a whole 32-byte sector); `grouped_unsort` (the
scan stores its outputs at the grouped positions, where a warp's stores
are contiguous, and a fifth kernel gathers them back to arrival order);
`count_512` and `count_2048` (the histogram's blocks take 512 or 2048
items instead of 1024); `match_early_exit` (the per-item tag match stops
at the first word of 32 ways that holds it); and, for timing only (wrong
results), `grouped_stores` (the scan's outputs at the grouped positions,
with no way back), `no_way_matched_stores`, `no_picked_stores` and
`no_set_loads` (no set is copied: the scan reads whatever its buffers
hold). Each variant
builds into its own directory under the package's build/variants/ (one
nvcc per source, as ops/slab_kernels.py build() does), removed at the end.
Every exact variant is first held bit for bit to the per-item kernel at the
decided shape and to the plain version at the served one.

Shapes: the decided stream's (a 2^23-slot table, W = 128, b = 2^20) and
the served batch's (2^22 slots, b = 65536), both over Zipf(1.1) traffic
and random tables as tools/way_scan_forms.py makes them. Per variant and
shape: `span_ms`, CUDA events around one call queued behind a spin kernel
(every launch, memset and gap); and `activities_us`, each device activity
of one call at its median over 10 calls (torch.profiler). Prints one JSON
line with the card's name. Needs a CUDA device; exits non-zero without one.
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
from .way_scan_forms import NOW, activities_us, span_ms, table_rows, zipf_fingerprints

WARP_COUNT_KERNEL = """// 1. Histogram, one atomic a set a warp.
__global__ void __launch_bounds__(kGroupThreads)
set_count_kernel(const int* __restrict__ fp_lo, int b, unsigned set_mask,
                 int* __restrict__ counts, int* __restrict__ rank) {
  const long long i = static_cast<long long>(blockIdx.x) * kGroupThreads + threadIdx.x;
  const unsigned active = __ballot_sync(kFullMask, i < b);
  if (i >= b) return;
  const int lane = threadIdx.x & 31;
  const unsigned set = static_cast<unsigned>(fp_lo[i]) & set_mask;
  const unsigned peers = __match_any_sync(active, set);
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(counts + set, __popc(peers));
  base = __shfl_sync(active, base, leader);
  rank[i] = base + __popc(peers & ((1u << lane) - 1u));
}

"""
NO_PREFETCH = [
    ("""    if (todo) {  // the next run's set, while this one is scanned
      stage_set(bufs + (buf ^ 1) * 2 * ways, table,
                __shfl_sync(kFullMask, set, __ffs(todo) - 1), ways, lane);
      copy_async_wait_group<1>();
    } else {
      copy_async_wait_group<0>();
    }
""", "    copy_async_wait_group<0>();\n"),
    ("    buf ^= 1;\n  }\n}\n",
     "    buf ^= 1;\n"
     "    if (todo) stage_set(bufs + buf * 2 * ways, table, __shfl_sync(kFullMask, set, __ffs(todo) - 1), ways, lane);\n"
     "  }\n}\n"),
]
PICKED_STORE = (
    """        picked_out[static_cast<long long>(item) * kRowWidth + (idx & (kRowWidth - 1))] =
            words[w * kRowWidth + (idx & (kRowWidth - 1))];""",
    """        __stcs(picked_out + static_cast<long long>(item) * kRowWidth + (idx & (kRowWidth - 1)),
               words[w * kRowWidth + (idx & (kRowWidth - 1))]);""",
)
RECORDS_32 = [
    ("return 20LL * b + 4LL", "return 36LL * b + 4LL"),
    ("int* rank = reinterpret_cast<int*>(base + 16LL * b);", "int* rank = reinterpret_cast<int*>(base + 32LL * b);"),
    ("records[offsets[set] + rank[i]] = make_int4(static_cast<int>(i), lo, fp_hi[i], 0);",
     "records[2LL * (offsets[set] + rank[i])] = make_int4(static_cast<int>(i), lo, fp_hi[i], 0);\n"
     "  records[2LL * (offsets[set] + rank[i]) + 1] = make_int4(0, 0, 0, 0);"),
    ("records[pos] : make_int4(0, 0, 0, 0);", "records[2 * pos] : make_int4(0, 0, 0, 0);"),
]
# the scan's outputs at the grouped position instead of the item's
GROUPED_STORES = [
    ("      way_out[rec.x] = my_way;\n      matched_out[rec.x] = my_match ? 1 : 0;\n",
     "      way_out[pos] = my_way;\n      matched_out[pos] = my_match ? 1 : 0;\n"),
    ("      const int item = __shfl_sync(kFullMask, rec.x, t);\n",
     "      const int item = static_cast<int>(pos - lane) + t;\n"),
]
UNSORT_KERNEL = """// the grouped outputs back to arrival order
__global__ void __launch_bounds__(kGroupThreads)
set_unsort_kernel(const int* __restrict__ fp_lo, int b, unsigned set_mask,
                  const int* __restrict__ offsets, const int* __restrict__ rank,
                  const int* __restrict__ way_g, const unsigned char* __restrict__ matched_g,
                  const int4* __restrict__ picked_g, int* __restrict__ way_out,
                  unsigned char* __restrict__ matched_out, int4* __restrict__ picked_out) {
  const long long i = static_cast<long long>(blockIdx.x) * kGroupThreads + threadIdx.x;
  if (i >= b) return;
  const long long p = offsets[static_cast<unsigned>(fp_lo[i]) & set_mask] + rank[i];
  way_out[i] = way_g[p];
  matched_out[i] = matched_g[p];
  picked_out[2 * i] = picked_g[2 * p];
  picked_out[2 * i + 1] = picked_g[2 * p + 1];
}

long long set_major_scratch_bytes("""
GROUPED_UNSORT = GROUPED_STORES + [
    ("long long set_major_scratch_bytes(", UNSORT_KERNEL),
    ("return 20LL * b + 4LL", "return 57LL * b + 4LL"),
    ("int* rank = reinterpret_cast<int*>(base + 16LL * b);",
     "int4* picked_g = reinterpret_cast<int4*>(base + 16LL * b);\n"
     "  int* way_g = reinterpret_cast<int*>(base + 48LL * b);\n"
     "  int* rank = way_g + b;"),
    ("  int* total = counts + n_sets;\n",
     "  int* total = counts + n_sets;\n  unsigned char* matched_g = reinterpret_cast<unsigned char*>(total + 4);\n"),
    ("table, records, b, set_mask, ways, way_bits, now, way_out, matched_out, picked_out);",
     "table, records, b, set_mask, ways, way_bits, now, way_g, matched_g, reinterpret_cast<int*>(picked_g));"),
    ("reinterpret_cast<int*>(picked_g));\n  }\n  return static_cast<int>(cudaGetLastError());\n",
     "reinterpret_cast<int*>(picked_g));\n  }\n"
     "  set_unsort_kernel<<<item_blocks, kGroupThreads, 0, s>>>(fp_lo, b, set_mask, counts, rank, way_g,\n"
     "      matched_g, picked_g, way_out, matched_out, reinterpret_cast<int4*>(picked_out));\n"
     "  return static_cast<int>(cudaGetLastError());\n"),
]
VARIANTS = {
    "shipped": [],
    "warp_count": [
        ("// 1. Histogram: counts[set] gains", "// 2. Offsets: counts[set] becomes", WARP_COUNT_KERNEL),
        ("static_cast<unsigned>((b + kCountItems - 1) / kCountItems)",
         "static_cast<unsigned>((b + kGroupThreads - 1) / kGroupThreads)"),
    ],
    "no_prefetch": NO_PREFETCH,
    "picked_streaming": [PICKED_STORE],
    "scatter_streaming": [
        ("  const int lo = fp_lo[i];\n", "  const int lo = __ldcs(fp_lo + i);\n"),
        ("records[offsets[set] + rank[i]] = make_int4(static_cast<int>(i), lo, fp_hi[i], 0);",
         "records[offsets[set] + __ldcs(rank + i)] = make_int4(static_cast<int>(i), lo, __ldcs(fp_hi + i), 0);"),
    ],
    "no_way_matched_stores": [
        ("      way_out[rec.x] = my_way;\n      matched_out[rec.x] = my_match ? 1 : 0;\n", ""),
    ],
    "no_picked_stores": [(PICKED_STORE[0], "        (void)words;")],
    "records_32": RECORDS_32,
    "grouped_unsort": GROUPED_UNSORT,
    "count_512": [("constexpr int kCountPerThread = 4;", "constexpr int kCountPerThread = 2;"),
                  ("constexpr int kCountSlotBits = 11;", "constexpr int kCountSlotBits = 10;")],
    "count_2048": [("constexpr int kCountPerThread = 4;", "constexpr int kCountPerThread = 8;"),
                   ("constexpr int kCountSlotBits = 11;", "constexpr int kCountSlotBits = 12;")],
    "match_early_exit": [
        ("      for (int k = NW - 1; k >= 0; --k) {", "      for (int k = 0; k < NW; ++k) {"),
        ("        if (hit) match = 32 * k + __ffs(hit) - 1;",
         "        if (hit) {\n          match = 32 * k + __ffs(hit) - 1;\n          break;\n        }"),
    ],
    "grouped_stores": GROUPED_STORES,
    "no_set_loads": [
        ("for (int v = lane; v < 2 * ways; v += 32) copy_async16(rows + v, src + v);", "(void)src;"),
    ],
}
EXACT = (
    "shipped", "no_prefetch", "warp_count", "picked_streaming", "scatter_streaming", "records_32",
    "grouped_unsort", "count_512", "count_2048", "match_early_exit",
)


def edit_source(text: str, name: str, edits) -> str:
    """Apply a variant's edits: (old, new) replaces text, (start, end, new)
    replaces everything from `start` up to `end`."""
    for edit in edits:
        if len(edit) == 3:
            start, end, new = edit
            if start not in text or end not in text:
                raise RuntimeError(f"variant {name}: a marker is not in the source")
            i, j = text.index(start), text.index(end)
            text = text[:i] + new + text[j:]
        else:
            old, new = edit
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
    return text


def build_variant(csrc: str, root: str, name: str, edits) -> None:
    """Point ops/slab_kernels.py at a copy of `csrc` with `edits` applied to
    slab_kernels.cu and build it."""
    src_dir = os.path.join(root, name, "csrc")
    shutil.copytree(csrc, src_dir)
    path = os.path.join(src_dir, "slab_kernels.cu")
    with open(path) as f:
        text = edit_source(f.read(), name, edits)
    with open(path, "w") as f:
        f.write(text)
    K.CSRC_DIR, K.BUILD_DIR, K._lib = src_dir, os.path.join(root, name, "build"), None
    K.build()


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--launches", type=int, default=30)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    dev = K.resolve_device("cuda")
    rng = np.random.default_rng(args.seed)
    lo_np, hi_np = zipf_fingerprints(1 << 20, seed=args.seed)
    lo = torch.from_numpy(lo_np.view(np.int32)).to(dev)
    hi = torch.from_numpy(hi_np.view(np.int32)).to(dev)
    ways = 128
    shapes = {
        "decided": (torch.from_numpy(table_rows(rng, 1 << 23, lo_np, hi_np, ways).view(np.int32)).to(dev), lo, hi),
        "served": (torch.from_numpy(table_rows(rng, 1 << 22, lo_np, hi_np, ways).view(np.int32)).to(dev), lo[:65536], hi[:65536]),
    }
    want = {
        "decided": K.way_scan(*shapes["decided"], NOW, ways, form="per_item"),
        "served": K.way_scan_plain(*shapes["served"], NOW, ways),
    }
    out = {"device": torch.cuda.get_device_name(0), "launches": args.launches}
    csrc, build_dir = K.CSRC_DIR, K.BUILD_DIR
    root = os.path.join(build_dir, "variants")
    os.makedirs(root, exist_ok=True)
    try:
        for name, edits in VARIANTS.items():
            build_variant(csrc, root, name, edits)
            res = {}
            for label, (table, q_lo, q_hi) in shapes.items():
                fn = lambda table=table, q_lo=q_lo, q_hi=q_hi: K.way_scan(table, q_lo, q_hi, NOW, ways, form="set_major")  # noqa: E731
                if name in EXACT and not all(torch.equal(g, w) for g, w in zip(fn(), want[label])):
                    raise RuntimeError(f"variant {name} differs from the reference at the {label} shape")
                res[label] = {"span_ms": span_ms(fn, args.launches), "activities_us": activities_us(fn)}
            out[name] = res
            print(name, json.dumps(res), file=sys.stderr, flush=True)
    finally:
        K.CSRC_DIR, K.BUILD_DIR, K._lib = csrc, build_dir, None
        shutil.rmtree(root)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
