// Hopper (sm_90a) kernels of the compare/select micro-benchmark
// (api_ratelimit_tpu_torch/tools/microbench_compare_paths.py). Plain C
// interface, loaded with ctypes by api_ratelimit_tpu_torch/ops/slab_kernels.py
// (one library built from every csrc/*.cu source); the wrappers and the plain
// PyTorch versions live in api_ratelimit_tpu_torch/ops/select_kernels.py.
//
// ---------------------------------------------------------------------------
// sel_kernel replaces tools/microbench_compare_paths.py pallas_sel
// (sel_kernel):    out = x > NOW ? x : -x
// chain_kernel replaces pallas_chain (chain_kernel): three compares and three
// selects,
//     m1 = x > NOW, m2 = (x & 7) == 3, m3 = x < NOW >> 1
//     r = m1 ? x : -x;  r = m2 ? r + 1 : r;  r = (m3 & m1) ? r ^ 21 : r
// with NOW = 2^30. Compares are signed int32, as in the JAX bodies; m3 & m1
// (x > 2^30 and x < 2^29) never holds, and the kernel keeps the select as
// written for the compiler to fold. JAX int32 arithmetic wraps (-INT_MIN is
// INT_MIN, INT_MAX + 1 is INT_MIN); signed overflow is undefined in C++, so
// the negate and the add run in uint32_t and cast back.
//
// The TPU kernels tile int32[b/128, 128] in (256, 128) blocks and need b to
// be a multiple of 128; these take a flat buffer of any length.
//
// Bound on this card: bytes. Each item reads 4 bytes and writes 4: 8 MB at
// b = 2^20, 2.5 us at 3.35 TB/s, about one launch's overhead. The design is
// one grid-stride pass with 16-byte (int4) loads and stores when both
// buffers are 16-byte aligned (a scalar pass otherwise, and for the tail),
// so each warp moves 512 contiguous bytes per step.
// ---------------------------------------------------------------------------

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNow = 1 << 30;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 blocks per SM cover the card

__device__ __forceinline__ int neg_wrap(int x) {
  return static_cast<int>(0u - static_cast<uint32_t>(x));
}

struct SelOp {
  __device__ __forceinline__ int operator()(int x) const {
    return x > kNow ? x : neg_wrap(x);
  }
};

struct ChainOp {
  __device__ __forceinline__ int operator()(int x) const {
    const bool m1 = x > kNow;
    const bool m2 = (x & 7) == 3;
    const bool m3 = x < (kNow >> 1);
    int r = m1 ? x : neg_wrap(x);
    r = m2 ? static_cast<int>(static_cast<uint32_t>(r) + 1u) : r;
    r = (m3 && m1) ? (r ^ 21) : r;
    return r;
  }
};

template <typename Op>
__device__ __forceinline__ void map_items(const int* __restrict__ x,
                                          int* __restrict__ out, long long n,
                                          bool vec) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const Op op{};
  long long done = 0;
  if (vec) {
    const long long n4 = n / 4;
    const int4* __restrict__ x4 = reinterpret_cast<const int4*>(x);
    int4* __restrict__ o4 = reinterpret_cast<int4*>(out);
    for (long long i = first; i < n4; i += stride) {
      int4 v = x4[i];
      v.x = op(v.x);
      v.y = op(v.y);
      v.z = op(v.z);
      v.w = op(v.w);
      o4[i] = v;
    }
    done = n4 * 4;
  }
  for (long long i = done + first; i < n; i += stride) {
    out[i] = op(x[i]);
  }
}

__global__ void __launch_bounds__(kThreads)
sel_kernel(const int* __restrict__ x, int* __restrict__ out, long long n,
           bool vec) {
  map_items<SelOp>(x, out, n, vec);
}

__global__ void __launch_bounds__(kThreads)
chain_kernel(const int* __restrict__ x, int* __restrict__ out, long long n,
             bool vec) {
  map_items<ChainOp>(x, out, n, vec);
}

// Grid for n items: enough blocks for one int4 per thread, at most
// kMaxBlocks (the loop strides over the rest).
int grid_for(long long n) {
  const long long per_block = 4LL * kThreads;
  const long long blocks = (n + per_block - 1) / per_block;
  return static_cast<int>(blocks < kMaxBlocks ? (blocks > 0 ? blocks : 1)
                                              : kMaxBlocks);
}

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15u) == 0;
}

}  // namespace

extern "C" {

// Each launches on `stream` and returns the cudaError_t of the launch (0 =
// success); the Python wrapper raises on anything else.
int rl_sel(const void* x, void* out, long long n, void* stream) {
  sel_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out), n,
      aligned16(x, out));
  return static_cast<int>(cudaGetLastError());
}

int rl_chain(const void* x, void* out, long long n, void* stream) {
  chain_kernel<<<grid_for(n), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out), n,
      aligned16(x, out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
