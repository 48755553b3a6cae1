// Hopper (sm_90a) kernel of the heavy-hitter sketch update: the sketch set
// scan. Plain C interface, loaded with ctypes by
// api_ratelimit_tpu_torch/ops/slab_kernels.py (one library built from every
// csrc/*.cu source); the wrapper and the plain PyTorch version live in
// api_ratelimit_tpu_torch/ops/sketch_kernels.py.
//
// Layout (api_ratelimit_tpu_torch/ops/sketch.py): the sketch is
// int32[3, lanes] holding uint32 bits, planes fp_lo, fp_hi, count, each
// viewed as n_sets = lanes / ways sets of `ways` contiguous lanes. A key
// lives only in set fp_lo & (n_sets - 1).
//
// ---------------------------------------------------------------------------
// Sketch scan. Replaces api_ratelimit_tpu/ops/sketch.py pallas_sketch_scan
// (_sketch_scan_kernel), and with it the XLA set gathers around it
// (sketch_update's rows_lo/rows_hi/rows_cnt) and the (b, 128) broadcasts of
// q_lo/q_hi the Mosaic tiling needed.
//
// Per item, over its set: the match way (lowest lane whose count is > 0 and
// whose fp_lo/fp_hi equal the query; 0 when none), match-any, the victim
// way (argmin count, lowest way on ties) and the victim count. Counts are
// read as SIGNED int32, as the reference reads them: a count with bit 31
// set is unoccupied and wins the argmin. The victim count returns as its
// raw bits.
//
// Bound on this card: bytes. Each item reads its 8-byte query and writes
// 13 bytes (4 + 1 + 4 + 4); the planes are 3 * lanes * 4 bytes read once
// (1.5 KiB at the default 128 lanes). At 65536 items that is ~1.4 MB,
// ~0.4 us at 3.35 TB/s, far below one launch's overhead: the kernel is
// launch-bound. The design reads each set straight from the planes, so the
// reference's gathered (b, W) planes never exist: one warp per item, lane l
// takes ways l, l+32, ...; the set's lanes are contiguous, so each step is
// one coalesced 128-byte read per plane, and at the default geometry every
// item reads the same single set, which stays in L1. First match and
// argmin reduce by warp shuffles. Any power-of-two ways <= lanes works.
// ---------------------------------------------------------------------------

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kSketchWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(kSketchWarpsPerBlock * 32)
sketch_scan_kernel(const int* __restrict__ planes, int lanes,
                   const int* __restrict__ q_lo, const int* __restrict__ q_hi,
                   int b, unsigned set_mask, int ways,
                   int* __restrict__ m_way_out,
                   unsigned char* __restrict__ m_any_out,
                   int* __restrict__ v_way_out, int* __restrict__ v_cnt_out) {
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kSketchWarpsPerBlock + (threadIdx.x >> 5);
  if (item >= b) return;  // uniform across the warp
  const int lo = q_lo[item];
  const int hi = q_hi[item];
  const long long base =
      static_cast<long long>(static_cast<unsigned>(lo) & set_mask) * ways;
  const int* plane_lo = planes + base;
  const int* plane_hi = planes + lanes + base;
  const int* plane_cnt = planes + 2LL * lanes + base;

  int match_way = ways;  // ways = no match seen
  int best_cnt = INT_MAX;
  int best_way = ways;
  for (int w = lane; w < ways; w += 32) {
    const int cnt = plane_cnt[w];
    if (cnt > 0 && plane_lo[w] == lo && plane_hi[w] == hi && w < match_way) {
      match_way = w;
    }
    if (cnt < best_cnt || (cnt == best_cnt && w < best_way)) {
      best_cnt = cnt;
      best_way = w;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    match_way = min(match_way, __shfl_xor_sync(kFullMask, match_way, off));
    const int other_cnt = __shfl_xor_sync(kFullMask, best_cnt, off);
    const int other_way = __shfl_xor_sync(kFullMask, best_way, off);
    if (other_cnt < best_cnt ||
        (other_cnt == best_cnt && other_way < best_way)) {
      best_cnt = other_cnt;
      best_way = other_way;
    }
  }
  if (lane == 0) {
    const bool matched = match_way < ways;
    m_way_out[item] = matched ? match_way : 0;
    m_any_out[item] = matched ? 1 : 0;
    v_way_out[item] = best_way;
    v_cnt_out[item] = best_cnt;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the cudaError_t of the launch (0 =
// success); the Python wrapper raises on anything else.
int rl_sketch_scan(const void* planes, int lanes, const void* q_lo,
                   const void* q_hi, int b, int n_sets, int ways,
                   void* m_way_out, void* m_any_out, void* v_way_out,
                   void* v_cnt_out, void* stream) {
  const int blocks = (b + kSketchWarpsPerBlock - 1) / kSketchWarpsPerBlock;
  sketch_scan_kernel<<<blocks, kSketchWarpsPerBlock * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(planes), lanes, static_cast<const int*>(q_lo),
      static_cast<const int*>(q_hi), b, static_cast<unsigned>(n_sets - 1),
      ways, static_cast<int*>(m_way_out),
      static_cast<unsigned char*>(m_any_out), static_cast<int*>(v_way_out),
      static_cast<int*>(v_cnt_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
