"""Where are compares fast? Eager torch elementwise ops vs the hand-written
CUDA kernels (the port of tools/microbench_compare_paths.py).

    python -m api_ratelimit_tpu_torch.tools.microbench_compare_paths \
        [--batch 1048576] [--repeats 8] [--device cuda]

Times the JAX tool's op classes on the same inputs (RandomState(0),
randint(0, 2^31) as int32, a fresh tensor per repeat): torch_* labels are
eager torch, the counterparts of the tool's xla_* labels, and cuda_sel_out /
cuda_chain_out the kernels of ops/select_kernels.py (pallas_sel's and
pallas_chain's counterparts). On the card each label is the CUDA-event time
of the repeats over their count; `--device cpu` shrinks the batch to 8192
past 2^14, as the JAX tool does off the TPU, and times on the host clock
(there the cuda_* labels run the plain versions). Prints one JSON line with
`platform`, `device` and `batch`. A kernel failure raises: the tool exits
non-zero.

torch sums int32 into int64 where XLA's uint32 sum wraps; these are
timings, not outputs, so torch_sum_u32 is the int64 sum of the widened
values.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..ops.select_kernels import NOW, chain, sel
from ..ops.slab_kernels import resolve_device


def _chain_eager(x):
    m1 = x > NOW
    m2 = (x & 7) == 3
    m3 = x < (NOW >> 1)
    r = torch.where(m1, x, -x)
    r = torch.where(m2, r + 1, r)
    return torch.where(m3 & m1, r ^ 21, r)


def _arith_mask(x):
    m = (NOW - x) >> 31
    return (x & m) | (-x & ~m)


OPS = (
    ("torch_sum_u32", lambda x: x.long().sum()),
    ("torch_sum_i32", lambda x: x.sum()),
    ("torch_add_out", lambda x: x + 1),  # no compare
    ("torch_cmp_out", lambda x: (x > NOW).to(torch.int32)),
    ("torch_sel_out", lambda x: torch.where(x > NOW, x, -x)),
    ("torch_min_out", lambda x: torch.clamp_max(x, NOW)),
    # arithmetic-only mask blend (the compare-free alternative)
    ("torch_arith_mask_out", _arith_mask),
    ("cuda_sel_out", sel),
    ("cuda_chain_out", chain),
    ("torch_chain_out", _chain_eager),
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1 << 20)
    ap.add_argument("--repeats", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    b = args.batch
    if not cuda and b > (1 << 14):
        b = 1 << 13
    rng = np.random.RandomState(0)
    xs = [
        torch.from_numpy(rng.randint(0, 1 << 31, size=b).astype(np.int32)).to(device)
        for _ in range(args.repeats)
    ]
    results: dict = {
        "platform": device.type,
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "batch": b,
    }

    def timeit(label, f):
        f(xs[-1])
        if cuda:
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for x in xs:
                f(x)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / len(xs)
        else:
            t0 = time.perf_counter()
            for x in xs:
                f(x)
            ms = (time.perf_counter() - t0) / len(xs) * 1e3
        results[label] = ms
        print(f"[cmp-paths] {label}: {ms}ms", file=sys.stderr)

    for label, f in OPS:
        timeit(label, f)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
