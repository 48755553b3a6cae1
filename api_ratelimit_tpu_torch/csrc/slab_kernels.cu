// Hopper (sm_90a) kernels of the slab step: the W-way set scan and the
// INCRBY apply (after mode, and with the decision fused in, full or lean).
// Plain C interface, loaded with ctypes by
// api_ratelimit_tpu_torch/ops/slab_kernels.py, which also holds the plain
// PyTorch version of each kernel (the CPU tests and chip_smoke.py hold the
// two to each other bit for bit).
//
// Build (ops/slab_kernels.py build(), one object per csrc/*.cu, one library):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC
//        -c -o slab_kernels.o slab_kernels.cu
//   nvcc -shared -o libkernels.so slab_kernels.o sketch_kernels.o
//
// Layout (api_ratelimit_tpu_torch/ops/slab_kernels.py): the table is int32[n_slots, 8]
// (the uint32 rows of the reference, same bits), viewed as n_sets sets of W
// contiguous rows. Columns: fp_lo, fp_hi, count, window, expire, divider,
// prev, aux. Counters are uint32 and wrap; window, expire and the divider
// are signed int32, as the reference's casts make them.

#include <climits>
#include <cuda_runtime.h>

#include "decide.cuh"

namespace {

constexpr int kRowWidth = 8;
constexpr int kColFpLo = 0;
constexpr int kColFpHi = 1;
constexpr int kColCount = 2;
constexpr int kColWindow = 3;
constexpr int kColExpire = 4;
constexpr int kAlgoDivMask = (1 << 28) - 1;
constexpr int kScoreTierShift = 28;
constexpr unsigned kFullMask = 0xffffffffu;

using rl::add_wrap;

// ---------------------------------------------------------------------------
// Way scan. Replaces api_ratelimit_tpu/ops/pallas_slab.py pallas_way_scan
// (_way_scan_kernel), and with it the XLA set gather and picked-row select
// around it (ops/slab.py _choose_ways).
//
// Per item: liveness (expire > now), the (fp_lo, fp_hi) tag match, the
// tiered eviction score (dead < window-ended < live by capped count, ties
// broken by the per-key rotation (way - pref) & (W-1), pref from fp_hi bits
// [way_bits, 2*way_bits)), the chosen way (first match, else argmin score),
// the matched flag, and the chosen way's stored row.
//
// Bound on this card: the set bytes read, W * 32 B per item (4 KiB at
// W=128, 268 MB for a 65536-item launch, ~80 us at 3.35 TB/s). The design
// reads each set straight from the table (set = fp_lo & (n_sets-1)), so the
// (b, W, 8) gathered intermediate of the reference never exists: one warp
// per item, lane l takes ways l, l+32, ...; a warp's 32 lanes read 32
// neighbouring 32-byte rows (1 KiB contiguous) per step; any-match,
// first-match way and argmin score reduce with warp shuffles. Works for
// any power-of-two W.
// ---------------------------------------------------------------------------

constexpr int kScanWarpsPerBlock = 8;

__global__ void __launch_bounds__(kScanWarpsPerBlock * 32)
way_scan_kernel(const int4* __restrict__ table, const int* __restrict__ fp_lo,
                const int* __restrict__ fp_hi, int b, unsigned set_mask,
                int ways, int way_bits, int now, int* __restrict__ way_out,
                unsigned char* __restrict__ matched_out,
                int* __restrict__ picked_out) {
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kScanWarpsPerBlock + (threadIdx.x >> 5);
  if (item >= b) return;  // uniform across the warp
  const unsigned q_lo = static_cast<unsigned>(fp_lo[item]);
  const unsigned q_hi = static_cast<unsigned>(fp_hi[item]);
  const long long set_row = static_cast<long long>(q_lo & set_mask) * ways;
  const int pref = static_cast<int>((q_hi >> way_bits) &
                                    static_cast<unsigned>(ways - 1));
  const unsigned count_cap = (1u << (kScoreTierShift - way_bits)) - 1u;

  int match_way = ways;  // ways = no match seen
  int best_score = INT_MAX;
  int best_way = ways;
  for (int w = lane; w < ways; w += 32) {
    const int4* row = table + (set_row + w) * 2;
    const int4 lo = row[0];  // fp_lo, fp_hi, count, window
    const int4 hi = row[1];  // expire, divider, prev, aux
    const bool live = hi.x > now;
    if (live && static_cast<unsigned>(lo.x) == q_lo &&
        static_cast<unsigned>(lo.y) == q_hi && w < match_way) {
      match_way = w;
    }
    const int div = hi.y & kAlgoDivMask;
    const bool ended = live && div > 0 && add_wrap(lo.w, div) <= now;
    const unsigned cnt = min(static_cast<unsigned>(lo.z), count_cap);
    const int rot = (w - pref) & (ways - 1);
    const int tier = live ? (ended ? 1 : 2) : 0;
    const int sub =
        live ? static_cast<int>((cnt << way_bits) | static_cast<unsigned>(rot))
             : rot;
    const int score = (tier << kScoreTierShift) | sub;
    if (score < best_score) {
      best_score = score;
      best_way = w;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    match_way = min(match_way, __shfl_xor_sync(kFullMask, match_way, off));
    const int other_score = __shfl_xor_sync(kFullMask, best_score, off);
    const int other_way = __shfl_xor_sync(kFullMask, best_way, off);
    if (other_score < best_score ||
        (other_score == best_score && other_way < best_way)) {
      best_score = other_score;
      best_way = other_way;
    }
  }
  const bool matched = match_way < ways;
  const int way = matched ? match_way : best_way;
  if (lane == 0) {
    way_out[item] = way;
    matched_out[item] = matched ? 1 : 0;
  }
  if (lane < kRowWidth) {
    const int* rows = reinterpret_cast<const int*>(table);
    picked_out[static_cast<long long>(item) * kRowWidth + lane] =
        rows[(set_row + way) * kRowWidth + lane];
  }
}

// ---------------------------------------------------------------------------
// INCRBY apply. Replaces api_ratelimit_tpu/ops/pallas_slab.py
// pallas_slab_apply (_slab_apply_kernel) in its three forms:
//   slab_apply_kernel<false, false>  decide=False (after mode), 4 outputs
//   slab_apply_kernel<true, false>   decide=True, 10 outputs
//   slab_apply_kernel<true, true>    decide=True, lean=True, 5 outputs
//
// Over the slot-sorted batch: the segmented exclusive prefix of hits
// (in-batch duplicate serialization), the window rollover against the
// stored row with the hits>0 gate, then before, after, cur_window and
// expire = now + div + jitter, in uint32 wrap-around arithmetic. With
// kDecide the fixed-window decision of decide.cuh follows per item (limit
// and near_ratio in): all six fields, or with kLean only the code (the
// decided mode reads nothing else, so the other five are neither computed
// nor stored).
//
// Bound on this card: bytes, ~57 B per item in after mode (5 int32 planes,
// the seg_start byte and 5 stored-row words in, 4 out), 85 B decided, 65 B
// lean; at the H100 SXM's published 3.35 TB/s (700 W) ~1.1 us for 65536
// items, ~0.027 ms decided at 2^20. The
// TPU kernel carried its scan totals across a sequential grid in SMEM;
// CUDA blocks have no order, so this first design is ONE block that walks
// the batch in chunks of its 1024 threads, carrying the running sum and
// the running segment-base max from chunk to chunk in shared memory,
// exactly like the sequential grid. Each chunk is two block-wide inclusive
// scans (warp shuffles, then a scan of the 32 warp totals). One block on
// one of 132 SMs leaves the kernel bound by the chunk loop's latency, far
// above its byte bound; the decision tail is elementwise after before and
// after and adds no barrier. A multi-block two-pass scan is later work.
// ---------------------------------------------------------------------------

constexpr int kApplyThreads = 1024;

struct AddOp {
  __device__ __forceinline__ unsigned operator()(unsigned a, unsigned b) const {
    return a + b;
  }
};

struct MaxOp {
  __device__ __forceinline__ unsigned operator()(unsigned a, unsigned b) const {
    return a > b ? a : b;
  }
};

// Inclusive scan of one value per thread across the block, in thread order.
// identity must be neutral for op. Ends with a barrier, so warp_buf may be
// reused by the next call.
template <typename Op>
__device__ unsigned block_inclusive_scan(unsigned v, Op op, unsigned identity,
                                         unsigned* warp_buf) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned t = __shfl_up_sync(kFullMask, v, off);
    if (lane >= off) v = op(v, t);
  }
  if (lane == 31) warp_buf[wid] = v;
  __syncthreads();
  if (wid == 0) {
    unsigned t = lane < n_warps ? warp_buf[lane] : identity;
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned u = __shfl_up_sync(kFullMask, t, off);
      if (lane >= off) t = op(t, u);
    }
    warp_buf[lane] = t;
  }
  __syncthreads();
  if (wid > 0) v = op(v, warp_buf[wid - 1]);
  __syncthreads();
  return v;
}

// The output planes come in the reference's order, each its own
// __restrict__ pointer, so the compiler may hoist every load of a chunk
// above its stores. The decision planes are null where the instantiation
// does not store them.
template <bool kDecide, bool kLean>
__global__ void __launch_bounds__(kApplyThreads)
slab_apply_kernel(const int* __restrict__ fp_lo, const int* __restrict__ fp_hi,
                  const int* __restrict__ hits, const int* __restrict__ limit,
                  const int* __restrict__ div, const int* __restrict__ jitter,
                  const unsigned char* __restrict__ seg_start,
                  const int* __restrict__ st_rows, int b, int now,
                  float near_ratio, int* __restrict__ before_out,
                  int* __restrict__ after_out, int* __restrict__ window_out,
                  int* __restrict__ expire_out, int* __restrict__ code_out,
                  int* __restrict__ remaining_out,
                  int* __restrict__ duration_out,
                  int* __restrict__ throttle_out, int* __restrict__ near_out,
                  int* __restrict__ over_out) {
  static_assert(kDecide || !kLean, "lean is a form of the decided apply");
  __shared__ unsigned warp_buf[32];
  __shared__ unsigned carry[2];  // running sum, running segment-base max
  if (threadIdx.x == 0) {
    carry[0] = 0u;
    carry[1] = 0u;
  }
  __syncthreads();
  for (int chunk = 0; chunk < b; chunk += blockDim.x) {
    const int i = chunk + threadIdx.x;
    const bool in = i < b;
    const unsigned carry_sum = carry[0];
    const unsigned carry_max = carry[1];
    const unsigned h = in ? static_cast<unsigned>(hits[i]) : 0u;
    const unsigned incl =
        block_inclusive_scan(h, AddOp(), 0u, warp_buf) + carry_sum;
    const unsigned excl = incl - h;
    const unsigned masked = (in && seg_start[i]) ? excl : 0u;
    const unsigned seg_base =
        max(block_inclusive_scan(masked, MaxOp(), 0u, warp_buf), carry_max);
    const unsigned prior = excl - seg_base;
    if (threadIdx.x == blockDim.x - 1) {
      carry[0] = incl;
      carry[1] = seg_base;
    }
    if (in) {
      const int d = div[i];
      const int safe_div = d < 1 ? 1 : d;
      const int cur_window = rl::window_start(now, safe_div);
      const int* st = st_rows + static_cast<long long>(i) * kRowWidth;
      const bool live = st[kColExpire] > now;
      const bool fp_match =
          live && st[kColFpLo] == fp_lo[i] && st[kColFpHi] == fp_hi[i];
      const bool same_window = st[kColWindow] == cur_window;
      const unsigned base = (h != 0u && fp_match && same_window)
                                ? static_cast<unsigned>(st[kColCount])
                                : 0u;
      const unsigned before = base + prior;
      const unsigned after = before + h;
      before_out[i] = static_cast<int>(before);
      after_out[i] = static_cast<int>(after);
      window_out[i] = cur_window;
      expire_out[i] = add_wrap(add_wrap(now, safe_div), jitter[i]);
      if constexpr (kDecide) {
        const unsigned lim = static_cast<unsigned>(limit[i]);
        if constexpr (kLean) {
          code_out[i] = rl::decide_code(after, h, lim);
        } else {
          const rl::Decision r =
              rl::decide_one(before, after, h, lim,
                             add_wrap(cur_window, safe_div), now, near_ratio);
          code_out[i] = r.code;
          remaining_out[i] = static_cast<int>(r.remaining);
          duration_out[i] = r.duration;
          throttle_out[i] = static_cast<int>(r.throttle);
          near_out[i] = static_cast<int>(r.near_delta);
          over_out[i] = static_cast<int>(r.over_delta);
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns the cudaError_t of the
// launch (0 = success); the Python wrapper raises on anything else.

int rl_way_scan(const void* table, const void* fp_lo, const void* fp_hi,
                int b, int n_sets, int ways, int way_bits, int now,
                void* way_out, void* matched_out, void* picked_out,
                void* stream) {
  const int blocks = (b + kScanWarpsPerBlock - 1) / kScanWarpsPerBlock;
  way_scan_kernel<<<blocks, kScanWarpsPerBlock * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(table), static_cast<const int*>(fp_lo),
      static_cast<const int*>(fp_hi), b, static_cast<unsigned>(n_sets - 1),
      ways, way_bits, now, static_cast<int*>(way_out),
      static_cast<unsigned char*>(matched_out), static_cast<int*>(picked_out));
  return static_cast<int>(cudaGetLastError());
}

int rl_slab_apply(const void* fp_lo, const void* fp_hi, const void* hits,
                  const void* div, const void* jitter, const void* seg_start,
                  const void* st_rows, int b, int now, void* before_out,
                  void* after_out, void* window_out, void* expire_out,
                  void* stream) {
  slab_apply_kernel<false, false><<<1, kApplyThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(fp_lo), static_cast<const int*>(fp_hi),
      static_cast<const int*>(hits), nullptr, static_cast<const int*>(div),
      static_cast<const int*>(jitter),
      static_cast<const unsigned char*>(seg_start),
      static_cast<const int*>(st_rows), b, now, 0.0f,
      static_cast<int*>(before_out), static_cast<int*>(after_out),
      static_cast<int*>(window_out), static_cast<int*>(expire_out), nullptr,
      nullptr, nullptr, nullptr, nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// The decided apply: outs[0..9] are before, after, window, expire, code,
// remaining, duration, throttle, near_delta, over_delta; with lean != 0
// only the first five are written (the rest may be null).
int rl_slab_apply_decide(const void* fp_lo, const void* fp_hi,
                         const void* hits, const void* limit, const void* div,
                         const void* jitter, const void* seg_start,
                         const void* st_rows, int b, int now, float near_ratio,
                         int lean, void* before_out, void* after_out,
                         void* window_out, void* expire_out, void* code_out,
                         void* remaining_out, void* duration_out,
                         void* throttle_out, void* near_out, void* over_out,
                         void* stream) {
  int* const out[10] = {
      static_cast<int*>(before_out),   static_cast<int*>(after_out),
      static_cast<int*>(window_out),   static_cast<int*>(expire_out),
      static_cast<int*>(code_out),     static_cast<int*>(remaining_out),
      static_cast<int*>(duration_out), static_cast<int*>(throttle_out),
      static_cast<int*>(near_out),     static_cast<int*>(over_out)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lo = static_cast<const int*>(fp_lo);
  const int* hi = static_cast<const int*>(fp_hi);
  const int* h = static_cast<const int*>(hits);
  const int* lim = static_cast<const int*>(limit);
  const int* d = static_cast<const int*>(div);
  const int* jit = static_cast<const int*>(jitter);
  const unsigned char* seg = static_cast<const unsigned char*>(seg_start);
  const int* st = static_cast<const int*>(st_rows);
  if (lean) {
    slab_apply_kernel<true, true><<<1, kApplyThreads, 0, s>>>(
        lo, hi, h, lim, d, jit, seg, st, b, now, near_ratio, out[0], out[1],
        out[2], out[3], out[4], out[5], out[6], out[7], out[8], out[9]);
  } else {
    slab_apply_kernel<true, false><<<1, kApplyThreads, 0, s>>>(
        lo, hi, h, lim, d, jit, seg, st, b, now, near_ratio, out[0], out[1],
        out[2], out[3], out[4], out[5], out[6], out[7], out[8], out[9]);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
