"""Port of tools/microbench_compare_paths.py pallas_sel and pallas_chain: the
compare/select micro-benchmark's two kernels.

The kernels are CUDA C++ for sm_90a in csrc/select_kernels.cu, part of the
one library ops/slab_kernels.py builds. Beside each sits its plain PyTorch
version:

    sel    <- pallas_sel    where(x > NOW, x, -x)
    chain  <- pallas_chain  three compares and three selects (chain_plain)

over a flat int32 buffer of any length (the TPU kernels tile int32[b/128,
128] and need b to be a multiple of 128). Arithmetic wraps as JAX int32 does.
A wrapper runs the plain version only because the tensor it was given lies
on the CPU; for a CUDA tensor it launches the kernel or raises, and counts
the launch in slab_kernels.LAUNCHES["sel"] / ["chain"].
"""

from __future__ import annotations

import torch

from .slab_kernels import LAUNCHES, _check, _require, _wrap32, build

NOW = 1 << 30  # the JAX tool's NOW literal


def sel_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of sel: where(x > NOW, x, -x), -INT_MIN == INT_MIN."""
    x64 = x.long()
    return _wrap32(torch.where(x > NOW, x64, -x64)).to(torch.int32)


def chain_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of chain, the JAX chain_kernel body in int32 with
    wraparound: m1 = x > NOW, m2 = (x & 7) == 3, m3 = x < NOW >> 1;
    r = where(m1, x, -x); where(m2, r + 1, r); where(m3 & m1, r ^ 21, r)."""
    m1 = x > NOW
    m2 = (x & 7) == 3
    m3 = x < (NOW >> 1)
    x64 = x.long()
    r = _wrap32(torch.where(m1, x64, -x64))
    r = _wrap32(torch.where(m2, r + 1, r))
    r = torch.where(m3 & m1, r ^ 21, r)
    return r.to(torch.int32)


def _launch(name: str, x: torch.Tensor, plain) -> torch.Tensor:
    device = x.device
    _require(x, "x", torch.int32, 1, device)
    if device.type == "cpu":
        return plain(x)
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    out = torch.empty_like(x)
    n = x.shape[0]
    if n == 0:
        return out
    lib = build()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, f"rl_{name}")(x.data_ptr(), out.data_ptr(), n, stream)
    _check(name, err)
    LAUNCHES[name] += 1
    return out


def sel(x: torch.Tensor) -> torch.Tensor:
    """where(x > 2^30, x, -x) over a flat int32 tensor (signed compare,
    wrapping negate)."""
    return _launch("sel", x, sel_plain)


def chain(x: torch.Tensor) -> torch.Tensor:
    """The three-compare, three-select chain over a flat int32 tensor
    (chain_plain)."""
    return _launch("chain", x, chain_plain)
