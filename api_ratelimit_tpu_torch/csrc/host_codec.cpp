// Native host-path codec of the PyTorch/CUDA port: a copy of the JAX
// package's native/host_codec.cpp, built by ops/native.py with g++ for the
// CPU (it holds no device code).
//
// The reference delegates its performance-critical native work to Redis's
// C execution engine over TCP (SURVEY.md §2.6); this library occupies the
// host-side native slot in front of the card: the per-descriptor work that
// runs before a batch ships to the device — 64-bit descriptor
// fingerprinting (the slab's key identity, ops/hashing.py), fixed-window
// cache-key composition (src/limiter/cache_key.go:43-73 semantics), the
// compiled matcher's flattened-trie walk, and the dispatch loop's row-block
// gather and verdict scatter.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
// All batch entry points take pre-flattened buffers + offset arrays so one
// library call amortizes the FFI cost across a whole micro-batch.
//
// The hash is XXH64, implemented from the public specification
// (github.com/Cyan4973/xxHash doc/xxhash_spec.md) so fingerprints match the
// Python xxh64 (ops/hashing.py) bit-for-bit — the slab must resolve
// identical slots whether the host path is native or pure Python.

#include <cstdint>
#include <cstring>

namespace {

constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t P3 = 0x165667B19E3779F9ULL;
constexpr uint64_t P4 = 0x85EBCA77C2B2AE63ULL;
constexpr uint64_t P5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

inline uint64_t read64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, sizeof v);  // little-endian hosts only (x86/ARM)
  return v;
}

inline uint64_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, sizeof v);
  return v;
}

inline uint64_t round64(uint64_t acc, uint64_t lane) {
  return rotl64(acc + lane * P2, 31) * P1;
}

inline uint64_t merge_round(uint64_t acc, uint64_t lane) {
  acc ^= round64(0, lane);
  return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* data, uint64_t len, uint64_t seed) {
  const uint8_t* p = data;
  const uint8_t* const end = data + len;
  uint64_t acc;

  if (len >= 32) {
    uint64_t a1 = seed + P1 + P2;
    uint64_t a2 = seed + P2;
    uint64_t a3 = seed;
    uint64_t a4 = seed - P1;
    const uint8_t* const limit = end - 32;
    do {
      a1 = round64(a1, read64(p));
      a2 = round64(a2, read64(p + 8));
      a3 = round64(a3, read64(p + 16));
      a4 = round64(a4, read64(p + 24));
      p += 32;
    } while (p <= limit);
    acc = rotl64(a1, 1) + rotl64(a2, 7) + rotl64(a3, 12) + rotl64(a4, 18);
    acc = merge_round(acc, a1);
    acc = merge_round(acc, a2);
    acc = merge_round(acc, a3);
    acc = merge_round(acc, a4);
  } else {
    acc = seed + P5;
  }

  acc += len;

  while (p + 8 <= end) {
    acc ^= round64(0, read64(p));
    acc = rotl64(acc, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    acc ^= read32(p) * P1;
    acc = rotl64(acc, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    acc ^= (*p) * P5;
    acc = rotl64(acc, 11) * P1;
    ++p;
  }

  acc ^= acc >> 33;
  acc *= P2;
  acc ^= acc >> 29;
  acc *= P3;
  acc ^= acc >> 32;
  return acc;
}

// Field serialization identical to ops/hashing.py fingerprint64: each field
// is a 4-byte little-endian length prefix followed by the raw bytes, so
// request-controlled strings cannot alias across field boundaries.
inline void hash_field(uint8_t* scratch, uint64_t& n, const uint8_t* s,
                       uint32_t len) {
  std::memcpy(scratch + n, &len, 4);
  n += 4;
  std::memcpy(scratch + n, s, len);
  n += len;
}

}  // namespace

extern "C" {

// One-shot hash of a pre-serialized record. Parity primitive for tests.
uint64_t rl_xxh64(const uint8_t* data, uint64_t len, uint64_t seed) {
  return xxh64(data, len, seed);
}

// Batched descriptor fingerprinting.
//
// Layout: `blob` holds every string back to back (UTF-8). `str_off` has
// n_strings+1 entries framing each string. Record i covers strings
// [rec_off[i], rec_off[i+1]) — its first string is the domain, followed by
// alternating entry key/value strings — and is hashed with seed `seeds[i]`
// (the window divider). Fingerprints land in `out[i]`.
//
// `scratch` must hold the largest serialized record
// (record bytes + 4 per string); the caller sizes it once per batch.
void rl_fingerprint_batch(const uint8_t* blob, const uint64_t* str_off,
                          const uint64_t* rec_off, const uint64_t* seeds,
                          uint64_t n_records, uint8_t* scratch,
                          uint64_t* out) {
  for (uint64_t i = 0; i < n_records; ++i) {
    uint64_t n = 0;
    for (uint64_t s = rec_off[i]; s < rec_off[i + 1]; ++s) {
      const uint64_t beg = str_off[s];
      hash_field(scratch, n, blob + beg,
                 static_cast<uint32_t>(str_off[s + 1] - beg));
    }
    out[i] = xxh64(scratch, n, seeds[i]);
  }
}

// Row-block gather: copy n_blocks uint32[6, counts[i]] column blocks side
// by side into the padded launch operand `dst` (the first 6 rows of the
// uint32[7, dst_cols] C-order device block; row 7 and the padding lanes
// are the caller's). Block i's row r starts at srcs[i] + r * strides[i]
// (in elements) — blocks may be column slices of a wider ring arena, so
// the row stride is per block, not counts[i]. One call replaces the
// per-block Python copy loop in front of every launch — the dispatch
// loop's pack stage.
void rl_pack_rows(const uint32_t* const* srcs, const uint64_t* counts,
                  const uint64_t* strides, uint64_t n_blocks, uint32_t* dst,
                  uint64_t dst_cols) {
  uint64_t off = 0;
  for (uint64_t i = 0; i < n_blocks; ++i) {
    const uint32_t* src = srcs[i];
    const uint64_t n = counts[i];
    const uint64_t stride = strides[i];
    for (uint64_t r = 0; r < 6; ++r)
      std::memcpy(dst + r * dst_cols + off, src + r * stride,
                  n * sizeof(uint32_t));
    off += n;
  }
}

// Verdict scatter: split one uint32[n] post-increment counter array back
// into per-ticket output buffers (dsts[i] receives counts[i] values).
// The inverse of rl_pack_rows on the readback path: one call per redeem
// instead of one numpy slice-copy per parked ticket.
void rl_scatter_rows(const uint32_t* src, const uint64_t* counts,
                     uint64_t n_out, uint32_t* const* dsts) {
  uint64_t off = 0;
  for (uint64_t i = 0; i < n_out; ++i) {
    const uint64_t n = counts[i];
    std::memcpy(dsts[i], src + off, n * sizeof(uint32_t));
    off += n;
  }
}

// Batched rule-tree matching over a flattened trie (the native half of
// config/compiled.py's CompiledMatcher — the memo-miss path).
//
// The loaded YAML rule trie is flattened at config load/hot-reload into:
//   * one open-addressed hash table `ht` (power-of-two, linear probing)
//     whose non-zero values are entry_index + 1;
//   * parallel entry arrays: e_parent (owning node id), e_node (child
//     node id), e_key_off/e_key_len into `key_blob` (the child's map key
//     bytes — "key" or "key_value", exactly the loader's composite);
//   * parallel node arrays: n_limit (rule index, -1 when the node holds
//     no rate_limit) and n_children (non-zero when the node has children).
// Node 0 is a virtual root whose children are the domains, so the domain
// lookup is just the first probe. Probes hash the key bytes with the
// parent node id as the xxh64 seed, then verify parent + full key bytes —
// hash collisions can slow a probe, never corrupt a match.
//
// Request records use the rl_fingerprint_batch framing: record i's first
// string is the domain, followed by alternating entry key/value strings.
// The walk mirrors config_impl.go:293-319 (and the Python tree walker)
// EXACTLY: at each level probe "key_value" first ("key" + '_' + value,
// composed into `scratch` — even for empty values, so the reference's
// underscore-aliasing quirk is reproduced), then the bare "key" wildcard;
// a limit only matches when config depth equals request depth; descent
// stops at the first level without children. out[i] is the matched rule
// index or -1.
//
// `scratch` must hold the longest composed key+value+1 of the batch (the
// caller sizes it from the flattened record bytes).
void rl_match_batch(const uint64_t* ht, uint64_t ht_mask,
                    const uint32_t* e_parent, const uint32_t* e_node,
                    const uint64_t* e_key_off, const uint32_t* e_key_len,
                    const uint8_t* key_blob, const int32_t* n_limit,
                    const uint8_t* n_children, const uint8_t* blob,
                    const uint64_t* str_off, const uint64_t* rec_off,
                    uint64_t n_records, uint8_t* scratch, int32_t* out) {
  auto probe = [&](uint32_t parent, const uint8_t* key,
                   uint64_t len) -> int64_t {
    uint64_t i = xxh64(key, len, parent) & ht_mask;
    for (;;) {
      const uint64_t v = ht[i];
      if (v == 0) return -1;
      const uint64_t e = v - 1;
      if (e_parent[e] == parent && e_key_len[e] == len &&
          std::memcmp(key_blob + e_key_off[e], key, len) == 0)
        return static_cast<int64_t>(e_node[e]);
      i = (i + 1) & ht_mask;
    }
  };
  for (uint64_t r = 0; r < n_records; ++r) {
    const uint64_t s0 = rec_off[r];
    const uint64_t s_end = rec_off[r + 1];
    int32_t found = -1;
    const int64_t dom = probe(0, blob + str_off[s0],
                              str_off[s0 + 1] - str_off[s0]);
    if (dom >= 0 && s_end > s0 + 1) {
      const uint64_t n_pairs = (s_end - s0 - 1) / 2;
      uint32_t parent = static_cast<uint32_t>(dom);
      for (uint64_t p = 0; p < n_pairs; ++p) {
        const uint64_t ks = s0 + 1 + 2 * p;
        const uint8_t* k = blob + str_off[ks];
        const uint64_t klen = str_off[ks + 1] - str_off[ks];
        const uint8_t* v = blob + str_off[ks + 1];
        const uint64_t vlen = str_off[ks + 2] - str_off[ks + 1];
        std::memcpy(scratch, k, klen);
        scratch[klen] = '_';
        std::memcpy(scratch + klen + 1, v, vlen);
        int64_t child = probe(parent, scratch, klen + 1 + vlen);
        if (child < 0) child = probe(parent, k, klen);
        if (child >= 0 && n_limit[child] >= 0 && p == n_pairs - 1)
          found = n_limit[child];
        if (child >= 0 && n_children[child])
          parent = static_cast<uint32_t>(child);
        else
          break;
      }
    }
    out[r] = found;
  }
}

// Batched fixed-window cache-key composition (cache_key.go:43-73 layout):
//   "<domain>_<k1>_<v1>_..._<window_start>"
// Same record framing as rl_fingerprint_batch; window_starts[i] is the
// already-snapped (now/divider)*divider value. Composed keys are written
// back to back into `out` (caller-sized), with out_off[i]..out_off[i+1]
// framing key i. Returns total bytes written, or -1 if `out_cap` is too
// small (caller retries with a bigger buffer).
int64_t rl_compose_keys(const uint8_t* blob, const uint64_t* str_off,
                        const uint64_t* rec_off, const int64_t* window_starts,
                        uint64_t n_records, uint8_t* out, uint64_t out_cap,
                        uint64_t* out_off) {
  uint64_t n = 0;
  for (uint64_t i = 0; i < n_records; ++i) {
    out_off[i] = n;
    // worst case: record strings + '_' separators + 20-digit window
    uint64_t need = 21;
    for (uint64_t s = rec_off[i]; s < rec_off[i + 1]; ++s)
      need += str_off[s + 1] - str_off[s] + 1;
    if (n + need > out_cap) return -1;
    for (uint64_t s = rec_off[i]; s < rec_off[i + 1]; ++s) {
      const uint64_t beg = str_off[s];
      const uint64_t len = str_off[s + 1] - beg;
      std::memcpy(out + n, blob + beg, len);
      n += len;
      out[n++] = '_';
    }
    // decimal window start; negatives (pre-epoch/skewed clocks) must render
    // exactly like Python's str() so keys stay byte-identical
    char digits[21];
    int nd = 0;
    int64_t w = window_starts[i];
    if (w < 0) {
      out[n++] = '-';
      while (w < 0) {
        digits[nd++] = static_cast<char>('0' - (w % 10));
        w /= 10;
      }
    } else if (w == 0) {
      digits[nd++] = '0';
    }
    while (w > 0) {
      digits[nd++] = static_cast<char>('0' + (w % 10));
      w /= 10;
    }
    while (nd > 0) out[n++] = digits[--nd];
  }
  out_off[n_records] = n;
  return static_cast<int64_t>(n);
}

}  // extern "C"
