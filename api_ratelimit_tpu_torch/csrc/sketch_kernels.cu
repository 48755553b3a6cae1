// Hopper (sm_90a) kernels of the heavy-hitter sketch: the whole per-launch
// update (scan, phase A and phase B in one launch), and the standalone set
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

// ---------------------------------------------------------------------------
// Sketch update. Replaces api_ratelimit_tpu/ops/sketch.py sketch_update as
// the TPU ran it: pallas_sketch_scan (_sketch_scan_kernel) and the XLA
// phases around it (the set gathers, phase A's scatter-add, phase B's three
// dense masked segment maxima, the victim argmin and the plane rewrite).
// Bit for bit the same function:
//   scan     per candidate, over its set, the first way whose signed count
//            is > 0 and whose (fp_lo, fp_hi) equal the candidate's;
//   phase A  a matched candidate adds its weight to that lane (mod 2^32);
//   phase B  per set, the lexicographic maximum (weight, fp_hi, fp_lo),
//            unsigned, over {0} and the set's unmatched candidates; if its
//            weight is > 0 it replaces the victim lane (first way at the
//            minimum of the PRE-launch signed counts) with (fp_lo, fp_hi,
//            victim count + weight), over any phase-A add to that lane.
// The output is a fresh plane triple; the input planes are never written.
//
// Bound on this card: bytes. Each item reads fp_lo, fp_hi, weight and the
// cand byte (13 B); the planes are read once and written once (2 x 1.5 KiB
// at the default 128 lanes). At 65536 items that is ~0.86 MB, ~0.26 us at
// 3.35 TB/s: far below one launch's overhead, so the update is launch- and
// latency-bound. What the design does about that: one launch (and one
// memset of its scratch) in place of the scan kernel and ~60 small torch
// ops around it.
//
// Design. One item a thread, 512 items a block. Each block stages the
// planes in shared memory when they fit (lanes <= 4096; else candidates
// read their set from global memory). Non-candidates skip the scan; a
// candidate scans its set in shared memory, where at the default geometry
// (one set) a warp reads the same words at every step, a broadcast; it
// reads four ways a step as int4 and does not stop at the first match, so
// the loop carries no branch and its loads pipeline. Phase A
// is an atomicAdd into a zeroed delta plane (the lanes are unique, so the
// sum does not depend on order). Phase B is three rounds of a per-set
// maximum in shared memory (weight; then fp_hi among the items at the
// weight maximum; then fp_lo among those at both), which is exactly the
// lexicographic maximum; with one set a warp reduces each round with
// __reduce_max_sync first. The block writes its per-set triple to scratch,
// fences, and takes a ticket; the last block to arrive reduces the
// partials per set (the lexicographic maximum is associative, so the order
// in which blocks arrive does not matter), finds each set's victim in the
// pre-launch planes and writes the three output planes. The delta plane and
// the ticket are zeroed by the entry point on the launch stream; the
// partials are fully written by every block and need no zeroing.
// ---------------------------------------------------------------------------

constexpr int kUpdateThreads = 512;
constexpr int kUpdateWarps = kUpdateThreads / 32;
constexpr int kStageLanesMax = 4096;          // 48 KiB of staged planes
// a block's shared memory on sm_90 (232448 B), less room for the static arrays
constexpr int kUpdateSmemMax = 232448 - 1024;
constexpr int kUpdateSmemDefault = 48 * 1024;  // above this only by opt-in

struct Lex {
  unsigned w, h, l;
};

__device__ __forceinline__ bool lex_less(const Lex& a, const Lex& b) {
  if (a.w != b.w) return a.w < b.w;
  if (a.h != b.h) return a.h < b.h;
  return a.l < b.l;
}

// (signed count, way): the smaller count wins, the lower way on ties
__device__ __forceinline__ bool victim_less(int c, int w, int best_c,
                                            int best_w) {
  return c < best_c || (c == best_c && w < best_w);
}

// One round of phase B's per-set maximum: set_max[set] = max(set_max[set],
// v) over the threads with `take`. All threads of the block call it.
__device__ __forceinline__ void block_set_max(bool take, unsigned v, int set,
                                              unsigned* set_max,
                                              bool one_set) {
  if (one_set) {
    const unsigned m = __reduce_max_sync(kFullMask, take ? v : 0u);
    if ((threadIdx.x & 31) == 0 && m != 0u) atomicMax(set_max, m);
  } else if (take) {
    atomicMax(set_max + set, v);
  }
}

// Shared memory of one block: the staged planes (if staged), then five
// per-set words (weight, fp_hi, fp_lo maxima; victim way and count).
long long update_smem_bytes(int lanes, int n_sets) {
  const long long staged = lanes <= kStageLanesMax ? 3LL * lanes : 0LL;
  return 4LL * (staged + 5LL * n_sets);
}

__global__ void __launch_bounds__(kUpdateThreads)
sketch_update_kernel(const int* __restrict__ planes, int lanes,
                     const int* __restrict__ fp_lo,
                     const int* __restrict__ fp_hi,
                     const int* __restrict__ weight,
                     const unsigned char* __restrict__ cand, int b,
                     int n_sets, int ways, int way_shift, bool vec,
                     int* __restrict__ out, unsigned* __restrict__ ticket,
                     unsigned* __restrict__ delta,
                     unsigned* __restrict__ part) {
  extern __shared__ __align__(16) unsigned smem[];
  __shared__ unsigned red[5][kUpdateWarps];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const long long L = lanes;
  const bool staged = lanes <= kStageLanesMax;
  // the item's operands first, all at once, so their loads are in flight
  // with the staging of the planes
  const int item = blockIdx.x * kUpdateThreads + tid;
  bool is_cand = false;
  unsigned w = 0u, h = 0u, l = 0u;
  if (item < b) {
    is_cand = cand[item] != 0;
    l = static_cast<unsigned>(fp_lo[item]);
    h = static_cast<unsigned>(fp_hi[item]);
    w = static_cast<unsigned>(weight[item]);
  }
  const int* sp = planes;
  if (staged) {
    int* st = reinterpret_cast<int*>(smem);
    for (int i = tid; i < 3 * lanes; i += kUpdateThreads) st[i] = planes[i];
    sp = st;
  }
  unsigned* set_w = smem + (staged ? 3 * lanes : 0);
  unsigned* set_h = set_w + n_sets;
  unsigned* set_l = set_h + n_sets;
  for (int s = tid; s < n_sets; s += kUpdateThreads) {
    set_w[s] = 0u;
    set_h[s] = 0u;
    set_l[s] = 0u;
  }
  __syncthreads();

  // the scan and phase A
  bool unmatched = false;
  int set = 0;
  if (is_cand) {
    set = static_cast<int>(l & static_cast<unsigned>(n_sets - 1));
    const long long base = static_cast<long long>(set) << way_shift;
    const int* lo_p = sp + base;
    const int* hi_p = sp + L + base;
    const int* cnt_p = sp + 2 * L + base;
    int match = -1;
    if (vec) {
      // four ways a step, no early exit: the loads of later steps issue
      // while earlier compares run (the first match is kept)
      const int4* lo4 = reinterpret_cast<const int4*>(lo_p);
      const int4* hi4 = reinterpret_cast<const int4*>(hi_p);
      const int4* cnt4 = reinterpret_cast<const int4*>(cnt_p);
#pragma unroll 8
      for (int k4 = 0; k4 < (ways >> 2); ++k4) {
        const int4 c = cnt4[k4], a = lo4[k4], z = hi4[k4];
        const unsigned m =
            ((c.x > 0) & (static_cast<unsigned>(a.x) == l) & (static_cast<unsigned>(z.x) == h)) |
            (((c.y > 0) & (static_cast<unsigned>(a.y) == l) & (static_cast<unsigned>(z.y) == h)) << 1) |
            (((c.z > 0) & (static_cast<unsigned>(a.z) == l) & (static_cast<unsigned>(z.z) == h)) << 2) |
            (((c.w > 0) & (static_cast<unsigned>(a.w) == l) & (static_cast<unsigned>(z.w) == h)) << 3);
        if (m != 0u && match < 0) match = (k4 << 2) + __ffs(m) - 1;
      }
    } else {
      for (int k = 0; k < ways; ++k) {
        if (cnt_p[k] > 0 && static_cast<unsigned>(lo_p[k]) == l &&
            static_cast<unsigned>(hi_p[k]) == h) {
          match = k;
          break;
        }
      }
    }
    if (match >= 0) {
      atomicAdd(delta + base + match, w);
    } else {
      unmatched = true;
    }
  }

  // phase B in the block: the three rounds of the lexicographic maximum
  const bool one_set = n_sets == 1;
  block_set_max(unmatched, w, set, set_w, one_set);
  __syncthreads();
  bool ok = unmatched && w == set_w[set];
  block_set_max(ok, h, set, set_h, one_set);
  __syncthreads();
  ok = ok && h == set_h[set];
  block_set_max(ok, l, set, set_l, one_set);
  __syncthreads();

  const int n_blocks = gridDim.x;
  const long long plane = static_cast<long long>(n_sets) * n_blocks;
  for (int s = tid; s < n_sets; s += kUpdateThreads) {
    const long long at = static_cast<long long>(s) * n_blocks + blockIdx.x;
    part[at] = set_w[s];
    part[plane + at] = set_h[s];
    part[2 * plane + at] = set_l[s];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1u) == static_cast<unsigned>(n_blocks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block: per set, the maximum over the blocks' partials and the
  // victim, each by a group of `group` threads (a power of two; sets beyond
  // the block's threads take one thread each, in passes)
  unsigned* vic_way = set_l + n_sets;
  int* vic_cnt = reinterpret_cast<int*>(vic_way + n_sets);
  const int group = n_sets >= kUpdateThreads ? 1 : kUpdateThreads / n_sets;
  const int per_pass = kUpdateThreads / group;
  const int sub = tid & (group - 1);
  const int warp = tid >> 5;
  for (int s0 = 0; s0 < n_sets; s0 += per_pass) {
    const int s = s0 + tid / group;
    Lex best = {0u, 0u, 0u};
    for (int k = sub; k < n_blocks; k += group) {
      const long long at = static_cast<long long>(s) * n_blocks + k;
      const Lex c = {__ldcg(part + at), __ldcg(part + plane + at),
                     __ldcg(part + 2 * plane + at)};
      if (lex_less(best, c)) best = c;
    }
    int vc = INT_MAX, vw = ways;  // any way of the set beats this
    const int* cnt_p = sp + 2 * L + (static_cast<long long>(s) << way_shift);
    for (int k = sub; k < ways; k += group) {
      const int c = cnt_p[k];
      if (victim_less(c, k, vc, vw)) {
        vc = c;
        vw = k;
      }
    }
    for (int off = min(group, 32) >> 1; off > 0; off >>= 1) {
      const Lex o = {__shfl_xor_sync(kFullMask, best.w, off),
                     __shfl_xor_sync(kFullMask, best.h, off),
                     __shfl_xor_sync(kFullMask, best.l, off)};
      if (lex_less(best, o)) best = o;
      const int oc = __shfl_xor_sync(kFullMask, vc, off);
      const int ow = __shfl_xor_sync(kFullMask, vw, off);
      if (victim_less(oc, ow, vc, vw)) {
        vc = oc;
        vw = ow;
      }
    }
    if (group > 32) {  // one pass: the group spans group / 32 warps
      if ((tid & 31) == 0) {
        red[0][warp] = best.w;
        red[1][warp] = best.h;
        red[2][warp] = best.l;
        red[3][warp] = static_cast<unsigned>(vc);
        red[4][warp] = static_cast<unsigned>(vw);
      }
      __syncthreads();
      if (sub == 0) {
        for (int k = 1; k < group / 32; ++k) {
          const Lex o = {red[0][warp + k], red[1][warp + k], red[2][warp + k]};
          if (lex_less(best, o)) best = o;
          const int oc = static_cast<int>(red[3][warp + k]);
          const int ow = static_cast<int>(red[4][warp + k]);
          if (victim_less(oc, ow, vc, vw)) {
            vc = oc;
            vw = ow;
          }
        }
      }
    }
    if (sub == 0) {
      set_w[s] = best.w;
      set_h[s] = best.h;
      set_l[s] = best.l;
      vic_way[s] = static_cast<unsigned>(vw);
      vic_cnt[s] = vc;
    }
    __syncthreads();
  }

  // the output planes
  for (int lane = tid; lane < lanes; lane += kUpdateThreads) {
    const int s = lane >> way_shift;
    const bool win =
        set_w[s] != 0u && (lane & (ways - 1)) == static_cast<int>(vic_way[s]);
    const unsigned cnt = static_cast<unsigned>(sp[2 * L + lane]);
    out[lane] = win ? static_cast<int>(set_l[s]) : sp[lane];
    out[L + lane] = win ? static_cast<int>(set_h[s]) : sp[L + lane];
    out[2 * L + lane] = static_cast<int>(
        win ? static_cast<unsigned>(vic_cnt[s]) + set_w[s]
            : cnt + __ldcg(delta + lane));
  }
}

// Scratch of one update launch: the ticket (padded to 16 bytes) and the
// delta plane, which the entry point zeroes, then the per-block partials.
long long update_zeroed_bytes(int lanes) { return 16LL + 4LL * lanes; }

long long update_scratch_bytes(int b, int lanes, int n_sets) {
  const long long blocks = (static_cast<long long>(b) + kUpdateThreads - 1) / kUpdateThreads;
  return update_zeroed_bytes(lanes) + 12LL * n_sets * blocks;
}

}  // namespace

extern "C" {

long long rl_sketch_update_scratch_bytes(int b, int lanes, int n_sets) {
  return update_scratch_bytes(b, lanes, n_sets);
}

// Shared memory a block of the update needs, or -1 when the geometry does
// not fit a block (the wrapper refuses it first).
long long rl_sketch_update_smem_bytes(int lanes, int n_sets) {
  const long long bytes = update_smem_bytes(lanes, n_sets);
  return bytes <= kUpdateSmemMax ? bytes : -1;
}

// The whole sketch update over b >= 1 items: planes int32[3, lanes] in,
// out int32[3, lanes] (a different buffer), cand one byte an item; scratch
// holds rl_sketch_update_scratch_bytes(b, lanes, n_sets) bytes on the
// batch's device and is zeroed here, on `stream`, before the launch.
// Returns the first cudaError_t (0 = success).
int rl_sketch_update(const void* planes, int lanes, const void* fp_lo,
                     const void* fp_hi, const void* weight, const void* cand,
                     int b, int n_sets, int ways, void* out, void* scratch,
                     void* stream) {
  const long long smem = update_smem_bytes(lanes, n_sets);
  if (smem > kUpdateSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kUpdateSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        sketch_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(scratch, 0, update_zeroed_bytes(lanes), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int way_shift = 0;
  while ((1 << way_shift) < ways) ++way_shift;
  unsigned* words = static_cast<unsigned*>(scratch);
  const int blocks = (b + kUpdateThreads - 1) / kUpdateThreads;
  // int4 set reads: four ways a step, from 16-byte aligned set rows
  const bool vec = ways % 4 == 0 &&
                   (lanes <= kStageLanesMax ||
                    (reinterpret_cast<unsigned long long>(planes) & 15) == 0);
  sketch_update_kernel<<<blocks, kUpdateThreads, static_cast<size_t>(smem), s>>>(
      static_cast<const int*>(planes), lanes, static_cast<const int*>(fp_lo),
      static_cast<const int*>(fp_hi), static_cast<const int*>(weight),
      static_cast<const unsigned char*>(cand), b, n_sets, ways, way_shift, vec,
      static_cast<int*>(out), words, words + 4, words + 4 + lanes);
  return static_cast<int>(cudaGetLastError());
}

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
