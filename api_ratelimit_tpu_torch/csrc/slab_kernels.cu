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
constexpr int kAlgoShift = 28;
constexpr int kAlgoDivMask = (1 << kAlgoShift) - 1;
constexpr int kAlgoSliding = 1;  // ops/slab.py ALGO_SLIDING_WINDOW
constexpr int kScoreTierShift = 28;
constexpr unsigned kFullMask = 0xffffffffu;

using rl::add_wrap;

// 16 bytes global -> shared memory by cp.async (L2 only). A thread's copies
// land in groups: copy_async_commit closes one, copy_async_wait_group<N>
// waits until at most N of the thread's latest groups are in flight, and
// copy_async_wait commits and waits for all.
__device__ __forceinline__ void copy_async16(int4* smem, const int4* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_async_wait_group() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  copy_async_commit();
  copy_async_wait_group<0>();
}

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
// Bound on this card: bytes. Each distinct set the batch touches is read
// once (W * 32 B), and an item moves 45 B of its own (8 B of query in; the
// way, the flag and the 32-byte picked row out); chip_smoke.py
// kernel_report counts the same. Zipf traffic repeats sets: the decided
// stream's 2^20 items touch nearly all 65536 sets of its 2^23-slot table,
// so there the bound is close to reading the 268 MB table once (~0.094 ms
// at 3.35 TB/s).
//
// Two forms, one op. The wrapper (ops/slab_kernels.py way_scan_form) picks
// one by a rule on the shapes alone (b, n_sets, W), stated there and in
// PERF.md:
//  - per item (way_scan_kernel): one warp an item reads the item's set
//    straight from the table; lane l takes ways l, l+32, ..., a warp step
//    reads 1 KiB of neighbouring rows, and any-match, first-match way and
//    argmin score reduce with warp shuffles. It fetches a set once for
//    every item that maps to it: where the touched sets fit the 50 MB L2
//    (the served 65536-item batch) that costs little, but the decided
//    stream's items reach ~16 a set scattered through the batch over a
//    table five times the L2, ~4 GB of set traffic for ~0.3 GB of work.
//  - set-major (set_count_kernel, set_offset_kernel, set_scatter_kernel,
//    way_scan_set_kernel, after one memset): a counting sort on the card
//    groups the items by set, then each warp takes 32 consecutive grouped
//    items and reads each distinct set among them once into shared memory,
//    the next run's set by cp.async while it scans the current one. The
//    set's query-free part (liveness, tier, capped count) reduces once to
//    the mask of ways that attain the minimal (tier, count) key; an item
//    then takes its first live tag match (one ballot per 32 ways) or else
//    the first way of that mask at or after pref, cyclically, which is the
//    argmin since the rotation only breaks ties. A hot set spans many
//    warps, each re-reading the same rows from L2, so no warp serializes
//    the hot key's items. Every grid is sized from b and n_sets, and
//    nothing synchronizes with the host, so a CUDA graph can capture the
//    op.
//  Routing (way_scan_form): set-major where W <= 256 and either b >= 2^20,
//  or b >= 2^18 with b >= 4 x n_sets; per item elsewhere, as at the served
//  65536-item batch (tools/way_scan_forms.py's sweep, PERF.md).
//  What holds the set-major form above its bound (tools/way_scan_variants.py,
//  PERF.md): not the set bytes but the per-item memory operations at
//  random addresses that grouping costs: the histogram's atomics, the
//  scatter's record writes and the scan's way, flag and row stores in
//  arrival order, ~40 B an item in all.
//
// Both scans take kMulti, the reference's multi_algo (ops/slab.py
// _scan_ways): with it, a stored row whose divider word carries the
// sliding-window id (bits 28-30) stays out of the window-ended tier for one
// window past its own end (span = 2 x divider), since the next window's
// interpolation still reads its count. The tier is the stored row's, so
// one set tiers its sliding and fixed rows each by its own span. With
// kMulti false the source is the fixed-window scan's, line for line, so it
// compiles to the same code (an inlined helper here cost the per-item
// kernel 4 registers and ~7% at the served shape).
// ---------------------------------------------------------------------------

constexpr int kScanWarpsPerBlock = 8;

template <bool kMulti>
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
    int span = div;
    if constexpr (kMulti) {
      if (((hi.y >> kAlgoShift) & 7) == kAlgoSliding) span = div * 2;
    }
    const bool ended = live && div > 0 && add_wrap(lo.w, span) <= now;
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

// The set-major form. Its scratch (set_major_scratch_bytes): one record a
// grouped item (item index, fp_lo, fp_hi; 16 B), each item's rank within
// its set, a counter a set, and the running total the offsets claim.
constexpr int kGroupThreads = 256;  // the grouping kernels' blocks
// the scan stages a set in shared memory twice a warp: see set_scan_warps
constexpr int kSetMajorMaxWays = 256;

// 1. Histogram: counts[set] gains the items of each set, and each item
// gets its rank among them. A block takes kCountItems items and counts
// them per set in a shared-memory hash of the sets it holds (the lanes of
// a warp that share a set first add together, __match_any_sync), then adds
// each set's total to its counter with one atomic and hands its items
// ranks after the base that atomic returns. A Zipf batch puts ~9% of its
// items on one set: with one atomic a set a warp, that counter took ~3 x
// 10^4 serialized atomics at 2^20 items (PERF.md); here it takes one a
// block.
constexpr int kCountPerThread = 4;
constexpr int kCountItems = kGroupThreads * kCountPerThread;  // 1024 a block
constexpr int kCountSlotBits = 11;  // 2048 slots: at most half full
constexpr int kCountSlots = 1 << kCountSlotBits;
constexpr unsigned kEmptySlot = 0xffffffffu;  // no set id: n_sets <= 2^31

__global__ void __launch_bounds__(kGroupThreads)
set_count_kernel(const int* __restrict__ fp_lo, int b, unsigned set_mask,
                 int* __restrict__ counts, int* __restrict__ rank) {
  __shared__ unsigned slot_set[kCountSlots];
  __shared__ int slot_count[kCountSlots];  // the block's items of the set, then their base
  for (int j = threadIdx.x; j < kCountSlots; j += kGroupThreads) {
    slot_set[j] = kEmptySlot;
    slot_count[j] = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long i0 = static_cast<long long>(blockIdx.x) * kCountItems + threadIdx.x;
  int slot[kCountPerThread], local[kCountPerThread];
#pragma unroll
  for (int k = 0; k < kCountPerThread; ++k) {
    const long long i = i0 + k * kGroupThreads;
    const unsigned active = __ballot_sync(kFullMask, i < b);
    slot[k] = -1;
    if (i < b) {
      const unsigned set = static_cast<unsigned>(fp_lo[i]) & set_mask;
      const unsigned peers = __match_any_sync(active, set);
      const int leader = __ffs(peers) - 1;
      int h = 0;
      int base = 0;
      if (lane == leader) {
        h = static_cast<int>((set * 0x9E3779B1u) >> (32 - kCountSlotBits));
        for (;;) {  // linear probing; the block holds at most 1024 sets
          const unsigned old = atomicCAS(slot_set + h, kEmptySlot, set);
          if (old == kEmptySlot || old == set) break;
          h = (h + 1) & (kCountSlots - 1);
        }
        base = atomicAdd(slot_count + h, __popc(peers));
      }
      slot[k] = __shfl_sync(active, h, leader);
      local[k] = __shfl_sync(active, base, leader) + __popc(peers & ((1u << lane) - 1u));
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kCountSlots; j += kGroupThreads) {
    const unsigned set = slot_set[j];
    if (set != kEmptySlot) slot_count[j] = atomicAdd(counts + set, slot_count[j]);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kCountPerThread; ++k) {
    if (slot[k] >= 0) rank[i0 + k * kGroupThreads] = slot_count[slot[k]] + local[k];
  }
}

// 2. Offsets: counts[set] becomes the set's first position among the
// grouped items. A block scans its 256 counters and claims their span with
// one atomicAdd on `total`, so the sets' segments lie in the order the
// blocks claimed them: any order serves, since an item's answer depends
// only on its own set.
__global__ void __launch_bounds__(kGroupThreads)
set_offset_kernel(int* __restrict__ counts, int n_sets, int* __restrict__ total) {
  __shared__ int warp_sum[kGroupThreads / 32];
  __shared__ int block_base;
  const long long s = static_cast<long long>(blockIdx.x) * kGroupThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int c = s < n_sets ? counts[s] : 0;
  int incl = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) warp_sum[wid] = incl;
  __syncthreads();
  int before_warp = 0;
  int sum = 0;
#pragma unroll
  for (int w = 0; w < kGroupThreads / 32; ++w) {
    if (w < wid) before_warp += warp_sum[w];
    sum += warp_sum[w];
  }
  if (threadIdx.x == 0) block_base = atomicAdd(total, sum);
  __syncthreads();
  if (s < n_sets) counts[s] = block_base + before_warp + incl - c;
}

// 3. Scatter: item i's record to its place in its set's segment.
__global__ void __launch_bounds__(kGroupThreads)
set_scatter_kernel(const int* __restrict__ fp_lo, const int* __restrict__ fp_hi,
                   int b, unsigned set_mask, const int* __restrict__ offsets,
                   const int* __restrict__ rank, int4* __restrict__ records) {
  const long long i = static_cast<long long>(blockIdx.x) * kGroupThreads + threadIdx.x;
  if (i >= b) return;
  const int lo = fp_lo[i];
  const unsigned set = static_cast<unsigned>(lo) & set_mask;
  records[offsets[set] + rank[i]] = make_int4(static_cast<int>(i), lo, fp_hi[i], 0);
}

// The first way at or after `pref`, cyclically, whose bit is set in the
// W-bit mask held as NW words (W < 32: the low W bits of one word). The
// mask is never empty: some way attains the minimum.
template <int NW>
__device__ __forceinline__ int first_way_from(const unsigned (&mask)[NW], int pref) {
  const int pw = pref >> 5;
  const int pb = pref & 31;
#pragma unroll
  for (int c = 0; c <= NW; ++c) {
    const int q = (pw + c) & (NW - 1);
    unsigned word = 0u;
#pragma unroll
    for (int k = 0; k < NW; ++k) word = k == q ? mask[k] : word;
    if (c == 0) word &= ~0u << pb;        // pref's word from pref on
    if (c == NW) word &= (1u << pb) - 1u;  // and at last below pref
    if (word) return q * 32 + __ffs(word) - 1;
  }
  return 0;
}

// 4. The scan over the grouped items: warp j of block t takes items
// t * tile + 32 j ... + 31, one a lane. A run of lanes that share a set is
// scanned together: the set's W rows (NW = max(1, W / 32) ways a lane,
// lane l taking ways l, l + 32, ...) are read once into shared memory. A
// warp double-buffers them: while it scans one run, cp.async brings the
// next run's set, so a set's DRAM latency overlaps the previous run's work.

// warps a scan block: two W-row buffers a warp, 32 KiB a block at W = 128
// (4 warps) and at W = 256 (2 warps), under the 48 KiB a launch takes
// without opt-in
__host__ __device__ constexpr int set_scan_warps(int nw) { return nw >= 8 ? 2 : 4; }

// a warp's copy of one set's W rows (2W int4) into `rows`
__device__ __forceinline__ void stage_set(int4* rows, const int4* table, unsigned set,
                                          int ways, int lane) {
  const int4* src = table + static_cast<long long>(set) * ways * 2;
  for (int v = lane; v < 2 * ways; v += 32) copy_async16(rows + v, src + v);
  copy_async_commit();
}

template <int NW, bool kMulti>
__global__ void __launch_bounds__(set_scan_warps(NW) * 32)
way_scan_set_kernel(const int4* __restrict__ table, const int4* __restrict__ records,
                    int b, unsigned set_mask, int ways, int way_bits, int now,
                    int* __restrict__ way_out, unsigned char* __restrict__ matched_out,
                    int* __restrict__ picked_out) {
  constexpr int kTile = set_scan_warps(NW) * 32;
  extern __shared__ int4 set_rows[];  // a warp: two buffers of W rows, 2 int4 a row
  const int lane = threadIdx.x & 31;
  int4* const bufs = set_rows + (threadIdx.x >> 5) * 4 * ways;
  const long long pos = static_cast<long long>(blockIdx.x) * kTile + threadIdx.x;
  const unsigned valid = __ballot_sync(kFullMask, pos < b);
  if (valid == 0u) return;  // uniform: the warp lies past the batch
  const int4 rec = pos < b ? records[pos] : make_int4(0, 0, 0, 0);
  const unsigned set = static_cast<unsigned>(rec.y) & set_mask;
  const unsigned prev = __shfl_up_sync(kFullMask, set, 1);
  unsigned todo = __ballot_sync(kFullMask, pos < b && (lane == 0 || set != prev));
  const int n_valid = __popc(valid);  // the valid lanes are a prefix
  const int pref = static_cast<int>((static_cast<unsigned>(rec.z) >> way_bits) &
                                    static_cast<unsigned>(ways - 1));
  const unsigned count_cap = (1u << (kScoreTierShift - way_bits)) - 1u;
  int my_way = 0;
  bool my_match = false;
  int buf = 0;
  stage_set(bufs, table, __shfl_sync(kFullMask, set, __ffs(todo) - 1), ways, lane);
  while (todo) {
    const int a = __ffs(todo) - 1;  // the run is lanes [a, e)
    todo &= todo - 1u;
    const int e = todo ? __ffs(todo) - 1 : n_valid;
    if (todo) {  // the next run's set, while this one is scanned
      stage_set(bufs + (buf ^ 1) * 2 * ways, table,
                __shfl_sync(kFullMask, set, __ffs(todo) - 1), ways, lane);
      copy_async_wait_group<1>();
    } else {
      copy_async_wait_group<0>();
    }
    __syncwarp();  // every lane's copies of this run's set have landed
    const int4* rows = bufs + buf * 2 * ways;

    // the query-free part, once a set: each way's (tier, capped count) key
    int tag_lo[NW], tag_hi[NW], key[NW];
    unsigned live_bits = 0u;
    int key_min = INT_MAX;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      const int w = lane + 32 * k;
      key[k] = INT_MAX;
      tag_lo[k] = 0;
      tag_hi[k] = 0;
      if (w < ways) {
        const int4 lo = rows[2 * w];      // fp_lo, fp_hi, count, window
        const int4 hi = rows[2 * w + 1];  // expire, divider, prev, aux
        const bool live = hi.x > now;
        const int div = hi.y & kAlgoDivMask;
        int span = div;
        if constexpr (kMulti) {
          if (((hi.y >> kAlgoShift) & 7) == kAlgoSliding) span = div * 2;
        }
        const bool ended = live && div > 0 && add_wrap(lo.w, span) <= now;
        const unsigned cnt = min(static_cast<unsigned>(lo.z), count_cap);
        const int tier = live ? (ended ? 1 : 2) : 0;
        key[k] = (tier << kScoreTierShift) | (live ? static_cast<int>(cnt << way_bits) : 0);
        tag_lo[k] = lo.x;
        tag_hi[k] = lo.y;
        live_bits |= static_cast<unsigned>(live) << k;
        key_min = min(key_min, key[k]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      key_min = min(key_min, __shfl_xor_sync(kFullMask, key_min, off));
    }
    unsigned min_mask[NW];  // the ways that attain the minimal key
#pragma unroll
    for (int k = 0; k < NW; ++k) min_mask[k] = __ballot_sync(kFullMask, key[k] == key_min);

    // the run's items one at a time: the first live tag match, a ballot
    // per 32 ways
    for (int t = a; t < e; ++t) {
      const int q_lo = __shfl_sync(kFullMask, rec.y, t);
      const int q_hi = __shfl_sync(kFullMask, rec.z, t);
      int match = ways;
#pragma unroll
      for (int k = NW - 1; k >= 0; --k) {
        const unsigned hit = __ballot_sync(
            kFullMask, ((live_bits >> k) & 1u) && tag_lo[k] == q_lo && tag_hi[k] == q_hi);
        if (hit) match = 32 * k + __ffs(hit) - 1;
      }
      if (lane == t) {
        my_match = match < ways;
        my_way = match;
      }
    }
    if (lane >= a && lane < e) {
      if (!my_match) my_way = first_way_from<NW>(min_mask, pref);
      way_out[rec.x] = my_way;
      matched_out[rec.x] = my_match ? 1 : 0;
    }
    // the run's picked rows from shared memory, 8 words an item
    const int* words = reinterpret_cast<const int*>(rows);
    const int n_words = (e - a) * kRowWidth;
    for (int base = 0; base < n_words; base += 32) {
      const int idx = base + lane;
      const int t = a + min(idx, n_words - 1) / kRowWidth;
      const int w = __shfl_sync(kFullMask, my_way, t);
      const int item = __shfl_sync(kFullMask, rec.x, t);
      if (idx < n_words) {
        picked_out[static_cast<long long>(item) * kRowWidth + (idx & (kRowWidth - 1))] =
            words[w * kRowWidth + (idx & (kRowWidth - 1))];
      }
    }
    __syncwarp();  // every lane is done with this buffer before it is refilled
    buf ^= 1;
  }
}

long long set_major_scratch_bytes(int b, int n_sets) {
  return 20LL * b + 4LL * (static_cast<long long>(n_sets) + 4);
}

// Zeroes the counters on `s` and launches the four kernels over b >= 1
// items, the scan in its fixed-window (kMulti false) or multi-algorithm
// instantiation. Returns the first cudaError_t (0 = success).
template <bool kMulti>
int launch_way_scan_set_major(const int4* table, const int* fp_lo, const int* fp_hi,
                              int b, int n_sets, int ways, int way_bits, int now,
                              int* way_out, unsigned char* matched_out,
                              int* picked_out, void* scratch, cudaStream_t s) {
  if (ways > kSetMajorMaxWays) return static_cast<int>(cudaErrorInvalidValue);
  char* base = static_cast<char*>(scratch);
  int4* records = reinterpret_cast<int4*>(base);
  int* rank = reinterpret_cast<int*>(base + 16LL * b);
  int* counts = rank + b;
  int* total = counts + n_sets;
  const cudaError_t err = cudaMemsetAsync(
      counts, 0, (static_cast<size_t>(n_sets) + 1) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned set_mask = static_cast<unsigned>(n_sets - 1);
  const unsigned count_blocks = static_cast<unsigned>((b + kCountItems - 1) / kCountItems);
  const unsigned item_blocks = static_cast<unsigned>((b + kGroupThreads - 1) / kGroupThreads);
  const unsigned set_blocks =
      static_cast<unsigned>((static_cast<long long>(n_sets) + kGroupThreads - 1) / kGroupThreads);
  set_count_kernel<<<count_blocks, kGroupThreads, 0, s>>>(fp_lo, b, set_mask, counts, rank);
  set_offset_kernel<<<set_blocks, kGroupThreads, 0, s>>>(counts, n_sets, total);
  set_scatter_kernel<<<item_blocks, kGroupThreads, 0, s>>>(fp_lo, fp_hi, b, set_mask, counts,
                                                           rank, records);
  const int nw = ways <= 32 ? 1 : ways / 32;
  const unsigned tiles = static_cast<unsigned>(
      (static_cast<long long>(b) + set_scan_warps(nw) * 32 - 1) / (set_scan_warps(nw) * 32));
  const size_t smem = static_cast<size_t>(set_scan_warps(nw)) * 4 * ways * sizeof(int4);
  if (nw == 1) {
    way_scan_set_kernel<1, kMulti><<<tiles, set_scan_warps(1) * 32, smem, s>>>(
        table, records, b, set_mask, ways, way_bits, now, way_out, matched_out, picked_out);
  } else if (nw == 2) {
    way_scan_set_kernel<2, kMulti><<<tiles, set_scan_warps(2) * 32, smem, s>>>(
        table, records, b, set_mask, ways, way_bits, now, way_out, matched_out, picked_out);
  } else if (nw == 4) {
    way_scan_set_kernel<4, kMulti><<<tiles, set_scan_warps(4) * 32, smem, s>>>(
        table, records, b, set_mask, ways, way_bits, now, way_out, matched_out, picked_out);
  } else {
    way_scan_set_kernel<8, kMulti><<<tiles, set_scan_warps(8) * 32, smem, s>>>(
        table, records, b, set_mask, ways, way_bits, now, way_out, matched_out, picked_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// INCRBY apply. Replaces api_ratelimit_tpu/ops/pallas_slab.py
// pallas_slab_apply (_slab_apply_kernel) in its three forms:
//   slab_apply_kernel<false, false>  decide=False (after mode), 4 outputs
//   slab_apply_kernel<true, false>   decide=True, 10 outputs
//   slab_apply_kernel<true, true>    decide=True, lean=True, 5 outputs
// and, in every form, the sketch's optional segment weight (prior + hits,
// the incl - seg_base of ops/slab.py _segment_weights), stored only where
// its pointer is non-null.
//
// Over the slot-sorted batch, in uint32 wrap-around arithmetic:
// incl = cumsum(hits), excl = incl - hits, seg_base = cummax(seg_start ?
// excl : 0) (an unsigned max over the wrapped excl: the XLA twin's
// semantics), prior = excl - seg_base; then per item the window rollover
// against the stored row with the hits>0 gate, before, after, cur_window
// and expire = now + div + jitter. With kDecide the fixed-window decision
// of decide.cuh follows per item (limit and near_ratio in): all six
// fields, or with kLean only the code (the decided mode reads nothing
// else, so the other five are neither computed nor stored).
//
// Bound on this card: bytes, ~57 B per item in after mode (5 int32
// planes, the seg_start byte and 5 stored-row words in, 4 out), 85 B
// decided, 65 B lean; at the H100 SXM's published 3.35 TB/s (700 W)
// ~1.1 us for 65536 items, ~0.027 ms decided at 2^20. A stored row is one
// 32-byte sector of which 20 B are read, so the floor in sectors is ~12 B
// an item more.
//
// The TPU kernel carried its two scan totals across a sequential grid in
// SMEM. Here the batch is cut into tiles of 512 items, one block of 128
// threads each (65536 items fill 128 SMs; 2^20 items make 2048 tiles). It
// is a single-pass scan with decoupled look-back (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA
// 2016), run twice and chained:
//   1. a block takes its tile from an atomic ticket, not from blockIdx, so
//      it only ever waits on tiles that have already started;
//   2. it issues every load of its tile at once: thread t holds items
//      4t..4t+3, one int4 per int32 plane (neighbouring threads on
//      neighbouring 16 bytes) and seg_start as a uchar4; the stored rows
//      go to shared memory by cp.async, 512 contiguous bytes a warp step,
//      and are read only by the tail, so their copy overlaps both scans;
//      window and expire, which need no scan, are stored at once;
//   3. the sum: a block scan of the hits, the tile total published as an
//      aggregate, one warp looking back over 32 predecessors at a time
//      until it meets an inclusive prefix, then the tile's own inclusive
//      prefix published;
//   4. the max: with the sum prefix known the tile forms its realized excl
//      and the masked values, and only then publishes their max and looks
//      back the same way. The two scans are not fused into one (sum, max)
//      pair operator: max(carry + x) != carry + max(x) once the running
//      sum wraps 2^32, so the max runs over the values each item really
//      has, and both operators stay exactly associative;
//   5. the elementwise tail, and the other stores as int4 per plane.
// A status word packs its flag (invalid, aggregate, inclusive prefix) and
// its 32-bit value into one 64-bit word, so relaxed gpu-scope accesses
// suffice (release/acquire read 5-10% slower on the card), and each word
// has a 128-byte line of its own: polled words that shared a line cost
// ~12% (PERF.md). The operand planes stream past L2 (ld/st .cs). The
// wrapper allocates the status words and the ticket; the entry point
// zeroes them on the launch stream before each launch. What still holds
// the kernel above its bound (PERF.md): the two look-backs, during which
// a block moves no bytes, and the stored rows' 32-byte sectors.
// ---------------------------------------------------------------------------

constexpr int kApplyThreads = 128;
constexpr int kApplyWarps = kApplyThreads / 32;
constexpr int kApplyItems = 4;  // per thread: one int4 of every int32 plane
constexpr int kApplyTile = kApplyThreads * kApplyItems;
static_assert(kApplyItems % 4 == 0, "items move as int4 and uchar4");

// one status word per 128-byte line: words that share a line are polled by
// the warps of up to 32 later tiles at once, and their L2 traffic queues
// on that line
constexpr int kStatusStride = 16;

constexpr unsigned long long kFlagAggregate = 1ull << 32;
constexpr unsigned long long kFlagPrefix = 2ull << 32;
constexpr unsigned long long kFlagMask = 0xffffffffull << 32;

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

// The status words need no ordering against any other memory: the value
// travels in the word with its flag, and a 64-bit aligned access is
// single-copy atomic. Relaxed gpu-scope accesses are coherent in L2.
__device__ __forceinline__ void store_status(unsigned long long* status,
                                             int tile, unsigned long long v) {
  unsigned long long* p = status + static_cast<long long>(tile) * kStatusStride;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* status, int tile) {
  const unsigned long long* p =
      status + static_cast<long long>(tile) * kStatusStride;
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Exclusive scan of one value per thread across the block, in thread
// order; `total` gets the block's aggregate. 0 is neutral for both ops.
// One barrier; warp_buf is written once, so a block scans with it once.
template <typename Op>
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned v, Op op,
                                                         unsigned* warp_buf,
                                                         unsigned& total) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  unsigned incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned t = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl = op(incl, t);
  }
  if (lane == 31) warp_buf[wid] = incl;
  __syncthreads();
  unsigned before_warp = 0u;
  total = 0u;
#pragma unroll
  for (int w = 0; w < kApplyWarps; ++w) {
    const unsigned t = warp_buf[w];
    if (w < wid) before_warp = op(before_warp, t);
    total = op(total, t);
  }
  unsigned before_lane = __shfl_up_sync(kFullMask, incl, 1);
  if (lane == 0) before_lane = 0u;
  return op(before_warp, before_lane);
}

// Publishes `tile`'s aggregate, looks back for its exclusive prefix and
// publishes its inclusive prefix. Called by all 32 lanes of one warp;
// returns the exclusive prefix in every lane. Lane l reads tile
// (window - l), so the nearest predecessor is lane 0; tiles before 0 read
// as an inclusive prefix of 0.
template <typename Op>
__device__ unsigned look_back(unsigned long long* status, int tile,
                              unsigned aggregate, Op op) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) store_status(status, 0, kFlagPrefix | aggregate);
    return 0u;
  }
  if (lane == 0) store_status(status, tile, kFlagAggregate | aggregate);
  unsigned exclusive = 0u;
  for (int window = tile - 1;; window -= 32) {
    const int j = window - lane;
    unsigned long long w = j >= 0 ? load_status(status, j) : kFlagPrefix;
    unsigned sleep_ns = 32;
    while (__any_sync(kFullMask, (w & kFlagMask) == 0ull)) {
      __nanosleep(sleep_ns);
      sleep_ns = sleep_ns < 1024 ? sleep_ns * 2 : sleep_ns;
      if ((w & kFlagMask) == 0ull) w = load_status(status, j);
    }
    const unsigned prefixes =
        __ballot_sync(kFullMask, (w & kFlagMask) == kFlagPrefix);
    // the lanes up to the nearest inclusive prefix count; without one,
    // all 32 aggregates do and the window moves back
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    unsigned v = lane <= stop ? static_cast<unsigned>(w) : 0u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v = op(v, __shfl_xor_sync(kFullMask, v, off));
    }
    exclusive = op(exclusive, v);
    if (prefixes) break;
  }
  if (lane == 0) {
    store_status(status, tile, kFlagPrefix | op(exclusive, aggregate));
  }
  return exclusive;
}

// Items i0 .. i0+N-1 of an int32 plane: N/4 int4 where the whole group
// lies in the batch and the planes are 16-byte aligned, else masked
// scalars. Every plane is read once and written once, so the vector
// accesses are streaming (evict-first), which leaves L2 to the status
// words.
template <int N>
__device__ __forceinline__ void load_items(const int* __restrict__ p,
                                           long long i0, int b, bool vec,
                                           int (&v)[N]) {
  if (vec && i0 + N <= b) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const int4 x = __ldcs(reinterpret_cast<const int4*>(p + i0) + q);
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = i0 + k < b ? p[i0 + k] : 0;
  }
}

template <int N>
__device__ __forceinline__ void store_items(int* __restrict__ p, long long i0,
                                            int b, bool vec,
                                            const int (&v)[N]) {
  if (vec && i0 + N <= b) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      __stcs(reinterpret_cast<int4*>(p + i0) + q,
             make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (i0 + k < b) p[i0 + k] = v[k];
    }
  }
}

// A warp's stored rows in shared memory: its 32 * N rows as two int4
// each, one spare int4 after every thread's N rows, so that the tail's
// reads (lane l at int4 l * (2N + 1)) fall in distinct banks.
constexpr int kWarpRowSlots = 32 * (2 * kApplyItems + 1);

template <int N>
__device__ __forceinline__ int row_slot(int row) {
  return 2 * row + row / N;
}

// Copies the stored rows of the warp's items warp_i0 .. warp_i0 + 32N - 1
// (those below b) into `rows`: lane l moves int4 l, l + 32, ... of the
// warp's contiguous rows, so each step reads 512 contiguous bytes. Aligned
// rows go by cp.async (copy_async_wait before reading them), others by
// scalar loads.
template <int N>
__device__ __forceinline__ void stage_rows(const int* __restrict__ st_rows,
                                           long long warp_i0, int b, bool vec,
                                           int lane, int4* rows) {
  const int4* src = reinterpret_cast<const int4*>(st_rows + warp_i0 * kRowWidth);
#pragma unroll
  for (int m = 0; m < 2 * N; ++m) {
    const int v = lane + 32 * m;
    if (warp_i0 + v / 2 >= b) continue;
    int4* dst = rows + row_slot<N>(v / 2) + (v & 1);
    if (vec) {
      copy_async16(dst, src + v);
    } else {
      const int* p = st_rows + (warp_i0 * kRowWidth + 4 * v);
      *dst = make_int4(p[0], p[1], p[2], p[3]);
    }
  }
}

// The output planes come in the reference's order, each its own
// __restrict__ pointer, so the compiler may hoist every load above the
// stores. The decision planes are null where the instantiation does not
// store them; weight_out is null unless the caller asks for the weight.
// vec: every plane is 16-byte aligned and seg_start 4-byte aligned.
template <bool kDecide, bool kLean>
__global__ void __launch_bounds__(kApplyThreads)
slab_apply_kernel(const int* __restrict__ fp_lo, const int* __restrict__ fp_hi,
                  const int* __restrict__ hits, const int* __restrict__ limit,
                  const int* __restrict__ div, const int* __restrict__ jitter,
                  const unsigned char* __restrict__ seg_start,
                  const int* __restrict__ st_rows, int b, int now,
                  float near_ratio, bool vec, int* __restrict__ before_out,
                  int* __restrict__ after_out, int* __restrict__ window_out,
                  int* __restrict__ expire_out, int* __restrict__ code_out,
                  int* __restrict__ remaining_out,
                  int* __restrict__ duration_out,
                  int* __restrict__ throttle_out, int* __restrict__ near_out,
                  int* __restrict__ over_out, int* __restrict__ weight_out,
                  unsigned long long* __restrict__ sum_status,
                  unsigned long long* __restrict__ max_status,
                  unsigned* __restrict__ ticket) {
  static_assert(kDecide || !kLean, "lean is a form of the decided apply");
  constexpr int N = kApplyItems;
  __shared__ unsigned warp_sum[kApplyWarps];
  __shared__ unsigned warp_max[kApplyWarps];
  __shared__ int tile_slot;
  __shared__ unsigned sum_prefix;
  __shared__ unsigned max_prefix;
  __shared__ int4 row_buf[kApplyWarps * kWarpRowSlots];
  if (threadIdx.x == 0) tile_slot = static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  const int tile = tile_slot;
  const int lane = threadIdx.x & 31;
  const long long warp_i0 =
      static_cast<long long>(tile) * kApplyTile + (threadIdx.x >> 5) * 32 * N;
  const long long i0 = warp_i0 + lane * N;

  // the stored rows of the warp's items, copied into shared memory while
  // the scans run; they are read only by the elementwise tail
  int4* const rows = row_buf + (threadIdx.x >> 5) * kWarpRowSlots;
  stage_rows<N>(st_rows, warp_i0, b, vec, lane, rows);

  int h[N], lo[N], hi[N], dv[N], jit[N], lim[N];
  bool seg[N];
  load_items<N>(hits, i0, b, vec, h);
  load_items<N>(fp_lo, i0, b, vec, lo);
  load_items<N>(fp_hi, i0, b, vec, hi);
  load_items<N>(div, i0, b, vec, dv);
  load_items<N>(jitter, i0, b, vec, jit);
  if constexpr (kDecide) load_items<N>(limit, i0, b, vec, lim);
  if (vec && i0 + N <= b) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const uchar4 s = __ldcs(reinterpret_cast<const uchar4*>(seg_start + i0) + q);
      seg[4 * q] = s.x;
      seg[4 * q + 1] = s.y;
      seg[4 * q + 2] = s.z;
      seg[4 * q + 3] = s.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) seg[k] = i0 + k < b && seg_start[i0 + k];
  }

  // window and expire need no scan: they leave before the look-backs
  int window_v[N], expire_v[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int safe_div = dv[k] < 1 ? 1 : dv[k];
    window_v[k] = rl::window_start(now, safe_div);
    expire_v[k] = add_wrap(add_wrap(now, safe_div), jit[k]);
  }
  store_items<N>(window_out, i0, b, vec, window_v);
  store_items<N>(expire_out, i0, b, vec, expire_v);

  // the sum: this thread's items, the block, then the tiles before it
  unsigned incl_local[N];
  unsigned run = 0u;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    run += static_cast<unsigned>(h[k]);
    incl_local[k] = run;
  }
  unsigned tile_sum;
  const unsigned thread_sum = block_exclusive_scan(run, AddOp(), warp_sum, tile_sum);
  if (threadIdx.x < 32) {
    const unsigned p = look_back(sum_status, tile, tile_sum, AddOp());
    if (threadIdx.x == 0) sum_prefix = p;
  }
  __syncthreads();

  // the max, over the realized excl of the segment starts
  const unsigned carry = sum_prefix + thread_sum;
  unsigned excl[N], max_local[N];
  unsigned mrun = 0u;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    excl[k] = carry + incl_local[k] - static_cast<unsigned>(h[k]);
    mrun = max(mrun, seg[k] ? excl[k] : 0u);
    max_local[k] = mrun;
  }
  unsigned tile_max;
  const unsigned thread_max = block_exclusive_scan(mrun, MaxOp(), warp_max, tile_max);
  if (threadIdx.x < 32) {
    const unsigned p = look_back(max_status, tile, tile_max, MaxOp());
    if (threadIdx.x == 0) max_prefix = p;
  }
  copy_async_wait();
  __syncthreads();

  const unsigned mcarry = max(max_prefix, thread_max);
  int before_v[N], after_v[N], weight_v[N];
  int code_v[N], remaining_v[N], duration_v[N], throttle_v[N], near_v[N],
      over_v[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    // the stored row's fp_lo, fp_hi, count, window and expire
    const int slot = row_slot<N>(lane * N + k);
    const int4 st = rows[slot];
    const int st_expire = rows[slot + 1].x;
    const unsigned hk = static_cast<unsigned>(h[k]);
    const unsigned prior = excl[k] - max(mcarry, max_local[k]);
    const bool live = st_expire > now;
    const bool fp_match = live && st.x == lo[k] && st.y == hi[k];
    const bool same_window = st.w == window_v[k];
    const unsigned base = (hk != 0u && fp_match && same_window)
                              ? static_cast<unsigned>(st.z)
                              : 0u;
    const unsigned before = base + prior;
    const unsigned after = before + hk;
    before_v[k] = static_cast<int>(before);
    after_v[k] = static_cast<int>(after);
    weight_v[k] = static_cast<int>(prior + hk);
    if constexpr (kDecide) {
      const unsigned lk = static_cast<unsigned>(lim[k]);
      if constexpr (kLean) {
        code_v[k] = rl::decide_code(after, hk, lk);
      } else {
        const int safe_div = dv[k] < 1 ? 1 : dv[k];
        const rl::Decision r =
            rl::decide_one(before, after, hk, lk,
                           add_wrap(window_v[k], safe_div), now, near_ratio);
        code_v[k] = r.code;
        remaining_v[k] = static_cast<int>(r.remaining);
        duration_v[k] = r.duration;
        throttle_v[k] = static_cast<int>(r.throttle);
        near_v[k] = static_cast<int>(r.near_delta);
        over_v[k] = static_cast<int>(r.over_delta);
      }
    }
  }
  store_items<N>(before_out, i0, b, vec, before_v);
  store_items<N>(after_out, i0, b, vec, after_v);
  if (weight_out != nullptr) store_items<N>(weight_out, i0, b, vec, weight_v);
  if constexpr (kDecide) {
    store_items<N>(code_out, i0, b, vec, code_v);
    if constexpr (!kLean) {
      store_items<N>(remaining_out, i0, b, vec, remaining_v);
      store_items<N>(duration_out, i0, b, vec, duration_v);
      store_items<N>(throttle_out, i0, b, vec, throttle_v);
      store_items<N>(near_out, i0, b, vec, near_v);
      store_items<N>(over_out, i0, b, vec, over_v);
    }
  }
}

// Scratch of one apply launch over b items: a sum and a max status word
// per tile, each kStatusStride words apart, then the ticket.
long long apply_scratch_bytes(int b) {
  const long long tiles = (static_cast<long long>(b) + kApplyTile - 1) / kApplyTile;
  return (2 * tiles * kStatusStride + 1) *
         static_cast<long long>(sizeof(unsigned long long));
}

bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<unsigned long long>(p) & (bytes - 1)) == 0;
}

// Zeroes the scratch on `s`, then launches the form's kernel over b >= 1
// items. Returns the first cudaError_t (0 = success).
template <bool kDecide, bool kLean>
int launch_apply(const int* lo, const int* hi, const int* h, const int* lim,
                 const int* d, const int* jit, const unsigned char* seg,
                 const int* st, int b, int now, float near_ratio,
                 int* const (&out)[10], int* weight, void* scratch,
                 cudaStream_t s) {
  const long long tiles = (static_cast<long long>(b) + kApplyTile - 1) / kApplyTile;
  const cudaError_t err = cudaMemsetAsync(scratch, 0, apply_scratch_bytes(b), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* planes[] = {lo, hi, h, lim, d, jit, st, weight};
  bool vec = aligned(seg, 4);
  for (const void* p : planes) vec = vec && aligned(p, 16);
  for (const int* p : out) vec = vec && aligned(p, 16);
  unsigned long long* status = static_cast<unsigned long long*>(scratch);
  slab_apply_kernel<kDecide, kLean><<<static_cast<unsigned>(tiles), kApplyThreads, 0, s>>>(
      lo, hi, h, lim, d, jit, seg, st, b, now, near_ratio, vec, out[0],
      out[1], out[2], out[3], out[4], out[5], out[6], out[7], out[8], out[9],
      weight, status, status + tiles * kStatusStride,
      reinterpret_cast<unsigned*>(status + 2 * tiles * kStatusStride));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns the cudaError_t of the
// launch (0 = success); the Python wrapper raises on anything else.

// The per-item way scan; multi != 0 runs its multi-algorithm instantiation
// (the sliding grace, way_scan_kernel<true>).
int rl_way_scan(const void* table, const void* fp_lo, const void* fp_hi,
                int b, int n_sets, int ways, int way_bits, int now,
                void* way_out, void* matched_out, void* picked_out,
                int multi, void* stream) {
  const int blocks = (b + kScanWarpsPerBlock - 1) / kScanWarpsPerBlock;
  auto kernel = multi ? way_scan_kernel<true> : way_scan_kernel<false>;
  kernel<<<blocks, kScanWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(table), static_cast<const int*>(fp_lo),
      static_cast<const int*>(fp_hi), b, static_cast<unsigned>(n_sets - 1),
      ways, way_bits, now, static_cast<int*>(way_out),
      static_cast<unsigned char*>(matched_out), static_cast<int*>(picked_out));
  return static_cast<int>(cudaGetLastError());
}

long long rl_way_scan_scratch_bytes(int b, int n_sets) {
  return set_major_scratch_bytes(b, n_sets);
}

// The set-major form of rl_way_scan (ways <= 256): scratch holds
// rl_way_scan_scratch_bytes(b, n_sets) bytes on the batch's device, 16-byte
// aligned; its counters are zeroed here on `stream`. multi != 0 runs the
// multi-algorithm scan (the sliding grace), as in rl_way_scan.
int rl_way_scan_set_major(const void* table, const void* fp_lo, const void* fp_hi,
                          int b, int n_sets, int ways, int way_bits, int now,
                          void* way_out, void* matched_out, void* picked_out,
                          void* scratch, int multi, void* stream) {
  auto launch = multi ? launch_way_scan_set_major<true> : launch_way_scan_set_major<false>;
  return launch(
      static_cast<const int4*>(table), static_cast<const int*>(fp_lo),
      static_cast<const int*>(fp_hi), b, n_sets, ways, way_bits, now,
      static_cast<int*>(way_out), static_cast<unsigned char*>(matched_out),
      static_cast<int*>(picked_out), scratch, static_cast<cudaStream_t>(stream));
}

long long rl_slab_apply_scratch_bytes(int b) { return apply_scratch_bytes(b); }

// The after-mode apply. weight_out may be null; scratch holds
// rl_slab_apply_scratch_bytes(b) bytes on the batch's device and is zeroed
// here on `stream` before the launch.
int rl_slab_apply(const void* fp_lo, const void* fp_hi, const void* hits,
                  const void* div, const void* jitter, const void* seg_start,
                  const void* st_rows, int b, int now, void* before_out,
                  void* after_out, void* window_out, void* expire_out,
                  void* weight_out, void* scratch, void* stream) {
  int* const out[10] = {
      static_cast<int*>(before_out), static_cast<int*>(after_out),
      static_cast<int*>(window_out), static_cast<int*>(expire_out),
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  return launch_apply<false, false>(
      static_cast<const int*>(fp_lo), static_cast<const int*>(fp_hi),
      static_cast<const int*>(hits), nullptr, static_cast<const int*>(div),
      static_cast<const int*>(jitter),
      static_cast<const unsigned char*>(seg_start),
      static_cast<const int*>(st_rows), b, now, 0.0f, out,
      static_cast<int*>(weight_out), scratch,
      static_cast<cudaStream_t>(stream));
}

// The decided apply: outs[0..9] are before, after, window, expire, code,
// remaining, duration, throttle, near_delta, over_delta; with lean != 0
// only the first five are written (the rest may be null). weight_out and
// scratch as for rl_slab_apply.
int rl_slab_apply_decide(const void* fp_lo, const void* fp_hi,
                         const void* hits, const void* limit, const void* div,
                         const void* jitter, const void* seg_start,
                         const void* st_rows, int b, int now, float near_ratio,
                         int lean, void* before_out, void* after_out,
                         void* window_out, void* expire_out, void* code_out,
                         void* remaining_out, void* duration_out,
                         void* throttle_out, void* near_out, void* over_out,
                         void* weight_out, void* scratch, void* stream) {
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
  int* w = static_cast<int*>(weight_out);
  if (lean) {
    return launch_apply<true, true>(lo, hi, h, lim, d, jit, seg, st, b, now,
                                    near_ratio, out, w, scratch, s);
  }
  return launch_apply<true, false>(lo, hi, h, lim, d, jit, seg, st, b, now,
                                   near_ratio, out, w, scratch, s);
}

}  // extern "C"
