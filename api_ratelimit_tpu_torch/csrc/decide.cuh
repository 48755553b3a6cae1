// The fixed-window decision of one item, shared by the fused INCRBY+decide
// apply (slab_kernels.cu slab_apply_kernel<true, *>) and the standalone
// decide kernel (decide_kernels.cu), so the two cannot drift apart.
//
// Semantics are the XLA twin's, api_ratelimit_tpu/ops/decide.py decide(),
// in uint32: every counter compare is unsigned, subtractions wrap, and an
// item with hits == 0 (padding) is a plain OK with every field 0. The
// Pallas kernels (pallas_decide, pallas_slab_apply(decide=True)) compute in
// int32 and agree with this only where every operand is below 2^31.
//
// Plain PyTorch version: api_ratelimit_tpu_torch/ops/decide.py decide_plain.

#pragma once

#include <cuda_runtime.h>

namespace rl {

constexpr int kCodeOk = 1;
constexpr int kCodeOverLimit = 2;

struct Decision {
  int code;
  unsigned remaining;
  int duration;
  unsigned throttle;
  unsigned near_delta;
  unsigned over_delta;
};

__device__ __forceinline__ int add_wrap(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// floor(now / safe_div) * safe_div in int32 wraparound, safe_div >= 1: the
// start of the fixed window holding `now` (floor, not truncation).
__device__ __forceinline__ int window_start(int now, int safe_div) {
  int q = now / safe_div;
  if (now < 0 && q * safe_div != now) q -= 1;
  return static_cast<int>(static_cast<unsigned>(q) *
                          static_cast<unsigned>(safe_div));
}

// floor(f32(limit) * near_ratio) as uint32: one IEEE f32 multiply, rounded
// to nearest with no contraction, then floor. The convert saturates to
// [0, 2^32 - 1], as XLA's float-to-unsigned convert does (a limit within
// 128 of 2^32 rounds to 2^32 in f32).
__device__ __forceinline__ unsigned near_threshold(unsigned limit,
                                                   float near_ratio) {
  const float x = floorf(__fmul_rn(__uint2float_rn(limit), near_ratio));
  if (!(x > 0.0f)) return 0u;
  return x >= 4294967296.0f ? 0xffffffffu : static_cast<unsigned>(x);
}

// The code alone: what the lean apply computes and stores.
__device__ __forceinline__ int decide_code(unsigned after, unsigned hits,
                                           unsigned limit) {
  return (hits != 0u && after > limit) ? kCodeOverLimit : kCodeOk;
}

// The whole decision. window_end = window_start + safe_div (int32 wrap).
__device__ __forceinline__ Decision decide_one(unsigned before, unsigned after,
                                               unsigned hits, unsigned limit,
                                               int window_end, int now,
                                               float near_ratio) {
  Decision d{kCodeOk, 0u, 0, 0u, 0u, 0u};
  if (hits == 0u) return d;
  const unsigned near = near_threshold(limit, near_ratio);
  d.duration = static_cast<int>(static_cast<unsigned>(window_end) -
                                static_cast<unsigned>(now));
  if (after > limit) {
    // over: the stats split of base_limiter.go:129-145
    const bool all_over = before >= limit;
    d.code = kCodeOverLimit;
    d.over_delta = all_over ? hits : after - limit;
    d.near_delta = all_over ? 0u : limit - max(near, before);
    return d;
  }
  d.remaining = limit - after;
  if (after > near) {
    d.near_delta = before >= near ? hits : after - near;
    // pacing: millis left in the window over the calls left. Every unit
    // (at most a day, 86 400 s) keeps the millis below 2^31, where the
    // twin's floor_div_exact_u32 is exact floor division, so plain
    // unsigned `/` is bit-exact to it.
    const unsigned millis = static_cast<unsigned>(d.duration) * 1000u;
    const unsigned calls = limit - after;
    d.throttle = millis / (calls > 1u ? calls : 1u);
  }
  return d;
}

}  // namespace rl
