// Hopper (sm_90a) standalone fixed-window decision. Replaces
// api_ratelimit_tpu/ops/pallas_decide.py pallas_decide (_decide_kernel).
// Plain C interface, loaded with ctypes by
// api_ratelimit_tpu_torch/ops/decide.py, which also holds its plain PyTorch
// version (decide_plain).
//
// Per item: code, remaining, duration, throttle and the near/over stats
// deltas from (before, after, hits, limit, divider) and the launch scalars
// now and near_ratio; the arithmetic is decide.cuh's, shared with the fused
// apply.
//
// Bound on this card: bytes. 5 int32 planes in and 6 out, 44 B per item
// (46 MB for 2^20 items, ~0.014 ms at the H100 SXM's published 3.35 TB/s,
// 700 W). The design is elementwise, one thread per item: neighbouring
// threads read and write neighbouring words, so every load and store is
// coalesced, and the few dozen integer operations per item hide under the
// memory traffic.

#include <cuda_runtime.h>

#include "decide.cuh"

namespace {

constexpr int kDecideThreads = 256;

__global__ void __launch_bounds__(kDecideThreads)
decide_kernel(const int* __restrict__ before, const int* __restrict__ after,
              const int* __restrict__ hits, const int* __restrict__ limit,
              const int* __restrict__ div, int b, int now, float near_ratio,
              int* __restrict__ code_out, int* __restrict__ remaining_out,
              int* __restrict__ duration_out, int* __restrict__ throttle_out,
              int* __restrict__ near_out, int* __restrict__ over_out) {
  const int i = blockIdx.x * kDecideThreads + threadIdx.x;
  if (i >= b) return;
  const int d = div[i];
  const int safe_div = d < 1 ? 1 : d;
  const int window_end = rl::add_wrap(rl::window_start(now, safe_div), safe_div);
  const rl::Decision r = rl::decide_one(
      static_cast<unsigned>(before[i]), static_cast<unsigned>(after[i]),
      static_cast<unsigned>(hits[i]), static_cast<unsigned>(limit[i]),
      window_end, now, near_ratio);
  code_out[i] = r.code;
  remaining_out[i] = static_cast<int>(r.remaining);
  duration_out[i] = r.duration;
  throttle_out[i] = static_cast<int>(r.throttle);
  near_out[i] = static_cast<int>(r.near_delta);
  over_out[i] = static_cast<int>(r.over_delta);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the cudaError_t of the launch (0 =
// success); the Python wrapper raises on anything else.
int rl_decide(const void* before, const void* after, const void* hits,
              const void* limit, const void* div, int b, int now,
              float near_ratio, void* code_out, void* remaining_out,
              void* duration_out, void* throttle_out, void* near_out,
              void* over_out, void* stream) {
  const int blocks = (b + kDecideThreads - 1) / kDecideThreads;
  decide_kernel<<<blocks, kDecideThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(before), static_cast<const int*>(after),
      static_cast<const int*>(hits), static_cast<const int*>(limit),
      static_cast<const int*>(div), b, now, near_ratio,
      static_cast<int*>(code_out), static_cast<int*>(remaining_out),
      static_cast<int*>(duration_out), static_cast<int*>(throttle_out),
      static_cast<int*>(near_out), static_cast<int*>(over_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
