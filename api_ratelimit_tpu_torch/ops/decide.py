"""Port of api_ratelimit_tpu/ops/decide.py and ops/pallas_decide.py: the
fixed-window decision, batched.

One item's decision mirrors src/limiter/base_limiter.go:
  * near threshold = floor(float32(limit) * near_ratio)      (:83-86)
  * OVER_LIMIT when after > limit                            (:88)
  * limit_remaining = limit - after on the OK branch         (:107-109)
  * stats attribution split across near/over by before/after (:129-145)
  * throttle pacing = millis left in the window / max(calls left, 1)
    whenever after > near threshold on the OK branch         (:154-165)
  * duration_until_reset = window end - now                  (utilities.go:34-38)

The semantics are the XLA twin's (`decide()`), in uint32: counters compare
unsigned and subtractions wrap; an item with hits == 0 (padding) is a plain
OK with every field 0. Tensors hold the uint32 bits as int32, as everywhere
in the port.

    decide  <- pallas_decide (csrc/decide_kernels.cu decide_kernel)

The kernel and the fused apply (ops/slab_kernels.py slab_apply with
decide=True) share one device function, csrc/decide.cuh. The twin divides
without hardware division (floor_div_exact_*), exact below 2^31; every unit
keeps its numerators there, and on the card integer `/` is exact, so plain
division is bit-exact to it.

Scope: shadow mode is a host-layer concept and never reaches the device
decision; raw codes are the enforced ones.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .slab_kernels import (
    _M32,
    LAUNCHES,
    _check,
    _check_int32,
    _require,
    _u32,
    _wrap32,
    build,
    f32,
)

# Codes match envoy RateLimitResponse.Code (models/response.py).
CODE_OK = 1
CODE_OVER_LIMIT = 2


class DecideResult(NamedTuple):
    """int32[b] each, holding the reference's dtypes' bits."""

    code: torch.Tensor  # 1=OK, 2=OVER_LIMIT
    limit_remaining: torch.Tensor  # uint32
    duration_until_reset: torch.Tensor  # int32 seconds
    throttle_millis: torch.Tensor  # uint32 per item (caller max-reduces)
    near_delta: torch.Tensor  # uint32: near_limit stats contribution
    over_delta: torch.Tensor  # uint32: over_limit stats contribution


def _near_threshold(limit: torch.Tensor, near_ratio: float) -> torch.Tensor:
    """floor(f32(limit) * near_ratio) as uint32 (in int64): one IEEE f32
    multiply, then floor; the convert saturates to [0, 2^32 - 1], as XLA's
    does."""
    ratio = torch.tensor(np.float32(near_ratio), device=limit.device)
    x = torch.floor(limit.to(torch.float32) * ratio)
    # saturate in f32 first: a product at or past 2^63 (or inf) would
    # wrap the int64 convert; NaN reads as 0, as the kernel's
    x = torch.where(x > 0, torch.clamp(x, max=4294967296.0), 0.0)
    return torch.clamp(x.to(torch.int64), max=_M32)


def decide_plain(before, after, hits, limit, divider, now: int, near_ratio) -> DecideResult:
    """Plain version of the decision (module docstring). before, after,
    hits and limit are int32[b] holding uint32 bits; divider int32[b]
    seconds per window (<= 0 reads as 1)."""
    before, after, hits, limit = (_u32(t) for t in (before, after, hits, limit))
    safe_div = torch.clamp(divider.long(), min=1)
    now_t = torch.full_like(safe_div, now)
    window_end = _wrap32(torch.div(now_t, safe_div, rounding_mode="floor") * safe_div + safe_div)
    duration = _wrap32(window_end - now)
    near = _near_threshold(limit, near_ratio)

    is_over = after > limit
    near_exceeded = after > near
    all_over = before >= limit
    over_delta_over = torch.where(all_over, hits, after - limit)
    near_delta_over = torch.where(all_over, 0, limit - torch.maximum(near, before))
    near_delta_ok = torch.where(
        near_exceeded, torch.where(before >= near, hits, after - near), 0
    )
    millis = (duration * 1000) & _M32
    calls = torch.clamp((limit - after) & _M32, min=1)
    throttle = torch.where(
        near_exceeded & ~is_over, torch.div(millis, calls, rounding_mode="floor"), 0
    )

    valid = hits != 0
    ok = valid & ~is_over
    as_i32 = lambda x: _wrap32(x & _M32).to(torch.int32)  # noqa: E731
    return DecideResult(
        code=torch.where(valid & is_over, CODE_OVER_LIMIT, CODE_OK).to(torch.int32),
        limit_remaining=as_i32(torch.where(ok, limit - after, 0)),
        duration_until_reset=as_i32(torch.where(valid, duration, 0)),
        throttle_millis=as_i32(torch.where(valid, throttle, 0)),
        near_delta=as_i32(
            torch.where(valid, torch.where(is_over, near_delta_over, near_delta_ok), 0)
        ),
        over_delta=as_i32(torch.where(valid & is_over, over_delta_over, 0)),
    )


def decide(before, after, hits, limit, divider, now: int, near_ratio) -> DecideResult:
    """The decision of every item (module docstring). On CUDA tensors it
    launches decide_kernel, counted in LAUNCHES["decide"]; on CPU tensors
    it runs decide_plain."""
    device = before.device
    named = (
        ("before", before), ("after", after), ("hits", hits),
        ("limit", limit), ("divider", divider),
    )
    for name, t in named:
        _require(t, name, torch.int32, 1, device)
    b = before.shape[0]
    if any(t.shape[0] != b for _name, t in named):
        raise ValueError("decide inputs must share the batch length")
    now = _check_int32("now", now)
    near_ratio = f32(near_ratio)
    if device.type == "cpu":
        return decide_plain(before, after, hits, limit, divider, now, near_ratio)
    if device.type != "cuda":
        raise ValueError(f"decide: unsupported device {device}")
    outs = [torch.empty(b, dtype=torch.int32, device=device) for _ in range(6)]
    if b == 0:
        return DecideResult(*outs)
    lib = build()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.rl_decide(
        *(t.data_ptr() for _name, t in named), b, now, near_ratio,
        *(o.data_ptr() for o in outs), stream,
    )
    _check("decide", err)
    LAUNCHES["decide"] += 1
    return DecideResult(*outs)


def packbits(mask: torch.Tensor) -> torch.Tensor:
    """numpy.packbits of a 1-D mask on its own device: uint8[b / 8], each
    byte big-endian (item 8k in bit 7). Any nonzero element is a set bit.
    Needs b % 8 == 0 (every launch bucket is a power of two >= 128). The
    bit weights are made on the device: a host tensor copied there would
    synchronize the stream on every call."""
    if mask.dim() != 1 or mask.shape[0] % 8:
        raise ValueError(f"packbits needs a 1-D mask with b % 8 == 0, got {tuple(mask.shape)}")
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=mask.device)
    bits = (mask != 0).view(-1, 8).to(torch.int32)
    return (bits << shifts).sum(dim=1).to(torch.uint8)
