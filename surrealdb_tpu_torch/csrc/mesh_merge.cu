// The two merges of mesh execution, on the device that gathers the
// shards' partials.
//
// merge_partials_topk replaces the all_gather + lax.top_k +
// take_along_axis merge of surrealdb_tpu/device/mesh.py:203-205
// (_vec_exact_jit), :254-256 (_vec_int8_jit), :481-483 (_ann_jit) and
// surrealdb_tpu/parallel/mesh.py:120-123 (_rank_rescore_shard, whose
// rescored partials are unsorted) and the cross-shard top_k that XLA
// inserts for parallel/mesh.py:62 _sharded_knn_impl. Each shard s
// hands a [B, w_s] tile of (dist, local id); the answer for row r is
// the k_out smallest of the S w entries by (order key of dist, position
// in the concatenation of the shards in ascending order) -- lax.top_k's
// tie rule over the all_gather -- with ids globalised as
// min(local + base_s, id_max). A shard with fewer rows than the local
// k (w_s < w) stands for the reference's padding rows: columns w_s..w-1
// are (+inf, local id = the column), as the reference's zero-padded
// slice ranks them. Any order of the partials is accepted.
//
// Bound on the H100: bytes (the B S w dists read once, the ids of the
// B k_out winners read, the B k_out pairs written); at the path's
// tiles that is a few microseconds, so latency and the sort's
// barriers decide the time.
// Design: select first, then sort only the winners.
// - Small tiles (S w <= 256, the exact and bf16 mesh merges at k = 10):
//   a warp per row, four rows a block; the S w (key, position) words sit
//   in registers (up to 8 a lane) and a bitonic network over shuffles
//   and register swaps sorts them, with no shared memory and no block
//   barrier.
// - Larger tiles (the int8 merge: 4 x 1280, k_out = 1280): a block per
//   row. The row's order keys are cached in shared memory (S w <= 16384;
//   past that each pass re-reads the partials); a radix select over
//   8-bit digits (a 256-bin shared histogram a pass, at most four
//   passes, stopping early once the threshold's bin is taken whole)
//   finds the k_out-th key T; one ordered compaction (warp ballots and
//   a prefix over warp counts) keeps every key < T and the
//   lowest-position keys == T, exactly k_out words; a bitonic sort of
//   those alone (2048 padded words at k_out = 1280, not the 8192 of
//   all S w) orders the answer. Past SURREAL_MERGE_SORT_KEYS winners
//   the sort runs in a device scratch slice of the row.
//
// mask_or_reduce replaces `psum(part, MESH_AXIS) > 0` of
// surrealdb_tpu/device/mesh.py:733-737 (_csr_jit): each shard's hop
// writes a [B, n] byte mask of the nodes its edge slice reaches, and
// the next frontier is their OR (the reference sums non-negative counts
// and tests > 0: the same bits). The union accumulator of a multi-hop
// (`layers.any(axis=0)`) is fused: acc |= next. A grid-stride pass over
// 16-byte words (uint4 loads of every mask) with a byte tail. Bound:
// bytes, S + 1 (+2 with acc) passes over B n bytes.
#include "kernels.h"

namespace {

constexpr int SMALL_MAX = 256;  // S w at most this: a warp per row
constexpr int SMALL_ROWS = 4;   // rows (warps) a block on that path
constexpr int BTHREADS = 512;   // a block per row past it
constexpr int KEY_CACHE = 16384;  // order keys cached in shared memory

struct MergeParts {
  const float* dist[SURREAL_MERGE_MAX_PARTS];
  const int32_t* ids[SURREAL_MERGE_MAX_PARTS];
  long long base[SURREAL_MERGE_MAX_PARTS];
  int width[SURREAL_MERGE_MAX_PARTS];
};

struct MaskParts {
  const uint8_t* mask[SURREAL_MERGE_MAX_PARTS];
};

__device__ __forceinline__ uint32_t order_key(float f) {
  if (f == 0.0f) f = 0.0f;  // -0.0 -> +0.0, as select_topk_rows keys it
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the order key of entry i of row r: part i / w, column i % w; a column
// past the part's width is padding (+inf)
__device__ __forceinline__ uint32_t entry_key(const MergeParts& p,
                                              long long r, int w, int i) {
  const int s = i / w, j = i - s * w;
  const int ws = p.width[s];
  return order_key(j < ws ? p.dist[s][r * ws + j] : INFINITY);
}

// the winner at position pos of row r -> (dist, globalised id)
__device__ __forceinline__ void write_winner(const MergeParts& p,
                                             long long r, int w, int pos,
                                             long long id_max, float* od,
                                             int32_t* oi) {
  const int s = pos / w, j = pos - s * w;
  const int ws = p.width[s];
  float v = INFINITY;
  long long loc = j;  // a padding column: its own position
  if (j < ws) {
    const long long at = r * ws + j;
    v = p.dist[s][at];
    loc = p.ids[s][at];
  }
  long long gid = loc + p.base[s];
  if (gid > id_max) gid = id_max;
  *od = v;
  *oi = (int32_t)gid;
}

__device__ __forceinline__ unsigned long long word_of(uint32_t key, int i) {
  return ((unsigned long long)key << 32) | (unsigned int)i;
}

// a warp per row: all S w <= 32 E words of the row sorted in registers;
// word i of the network is v[i / 32] of lane i % 32
template <int E>
__global__ void __launch_bounds__(SMALL_ROWS * 32)
    merge_small_kernel(const __grid_constant__ MergeParts parts, int b,
                       int w, int total, int k_out, long long id_max,
                       float* __restrict__ out_dist,
                       int32_t* __restrict__ out_ids) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * SMALL_ROWS + (threadIdx.x >> 5);
  if (r >= b) return;
  unsigned long long v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * 32 + lane;
    v[e] = i < total ? word_of(entry_key(parts, r, w, i), i) : ~0ull;
  }
#pragma unroll
  for (int size = 2; size <= 32 * E; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {
        // partners in the same lane: registers e and e ^ (stride / 32)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int f = e ^ (stride >> 5);
          if (f > e) {
            const bool up = ((e * 32 + lane) & size) == 0;
            const unsigned long long x = v[e], y = v[f];
            if ((x > y) == up) {
              v[e] = y;
              v[f] = x;
            }
          }
        }
      } else {
        // partners in lanes lane ^ stride: the lower word of an
        // ascending pair keeps the smaller
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const unsigned long long o =
              __shfl_xor_sync(0xffffffffu, v[e], stride);
          const bool up = ((e * 32 + lane) & size) == 0;
          const bool lower = (lane & stride) == 0;
          const bool keep_min = lower == up;
          v[e] = keep_min ? (o < v[e] ? o : v[e]) : (o > v[e] ? o : v[e]);
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * 32 + lane;
    if (i < k_out)
      write_winner(parts, r, w, (int)(v[e] & 0xffffffffu), id_max,
                   out_dist + r * k_out + i, out_ids + r * k_out + i);
  }
}

// bitonic sort of buf[0:m] ascending (m a power of two), one
// compare-exchange a pair, in shared or device memory (__syncthreads
// orders the block's global accesses too)
__device__ __forceinline__ void bitonic_sort(unsigned long long* buf,
                                             int m) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  for (int size = 2; size <= m; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = tid; p < (m >> 1); p += nthreads) {
        const int i = 2 * p - (p & (stride - 1));
        const int j = i + stride;
        const unsigned long long x = buf[i], y = buf[j];
        if ((x > y) == ((i & size) == 0)) {
          buf[i] = y;
          buf[j] = x;
        }
      }
      __syncthreads();
    }
  }
}

// a block per row: radix select of the k_out-th key, ordered compaction
// of the k_out winners, a sort of those alone. kCached: the row's keys
// in shared memory; kSharedSort: the winners sort in shared memory (else
// in scratch[r, 0:m]).
template <bool kCached, bool kSharedSort>
__global__ void __launch_bounds__(BTHREADS)
    merge_block_kernel(const __grid_constant__ MergeParts parts, int w,
                       int total, int m, int k_out, long long id_max,
                       float* __restrict__ out_dist,
                       int32_t* __restrict__ out_ids,
                       unsigned long long* __restrict__ scratch,
                       long long scratch_ld) {
  extern __shared__ __align__(16) unsigned long long smem[];
  __shared__ unsigned int hist[256];
  __shared__ unsigned int warp_less[BTHREADS / 32], warp_eq[BTHREADS / 32];
  __shared__ unsigned int s_bin, s_before, s_whole;
  const long long r = blockIdx.x;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  unsigned long long* buf = kSharedSort ? smem : scratch + r * scratch_ld;
  unsigned int* keys =
      reinterpret_cast<unsigned int*>(smem + (kSharedSort ? m : 0));
  if (kCached)
    for (int i = tid; i < total; i += nthreads)
      keys[i] = entry_key(parts, r, w, i);
  auto key_at = [&](int i) -> uint32_t {
    return kCached ? keys[i] : entry_key(parts, r, w, i);
  };

  // radix select, most significant digit first: after the loop the
  // keys whose top (32 - shift) bits equal prefix's hold the k_out-th
  // smallest, and `need` of them (lowest positions first) are taken
  uint32_t prefix = 0, need = (uint32_t)k_out;
  int shift = 32;
  for (int pass = 0; pass < 4; ++pass) {
    const int hi = shift;  // the bits above `hi` are fixed
    shift -= 8;
    for (int i = tid; i < 256; i += nthreads) hist[i] = 0u;
    __syncthreads();  // (also orders the key cache before its reads)
    for (int i = tid; i < total; i += nthreads) {
      const uint32_t key = key_at(i);
      if (hi == 32 || (key >> hi) == (prefix >> hi))
        atomicAdd(&hist[(key >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (warp == 0) {
      // lane l scans bins 8l..8l+7; the first lane whose inclusive
      // count reaches `need` holds the bin
      unsigned int sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += hist[lane * 8 + j];
      unsigned int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned int t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      const unsigned int hit = __ballot_sync(0xffffffffu, incl >= need);
      if (lane == __ffs(hit) - 1) {
        unsigned int cum = incl - sum;
        for (int j = 0; j < 8; ++j) {
          const unsigned int h = hist[lane * 8 + j];
          if (cum + h >= need) {
            s_bin = (unsigned int)(lane * 8 + j);
            s_before = cum;
            s_whole = h == need - cum;
            break;
          }
          cum += h;
        }
      }
    }
    __syncthreads();
    prefix |= s_bin << shift;
    need -= s_before;
    if (s_whole) break;  // the bin is taken whole: no tie to split
  }
  const unsigned int n_less = (unsigned int)k_out - need;
  const uint32_t top = prefix >> shift;

  // ordered compaction: every key below the threshold class, and the
  // first `need` keys of the class by position
  const unsigned int lt_mask = (1u << lane) - 1u;
  unsigned int base_less = 0, base_eq = 0;
  for (int start = 0; start < total; start += nthreads) {
    const int i = start + tid;
    const bool in = i < total;
    const uint32_t key = in ? key_at(i) : 0xffffffffu;
    const bool is_less = in && (key >> shift) < top;
    const bool is_eq = in && (key >> shift) == top;
    const unsigned int lm = __ballot_sync(0xffffffffu, is_less);
    const unsigned int em = __ballot_sync(0xffffffffu, is_eq);
    if (lane == 0) {
      warp_less[warp] = __popc(lm);
      warp_eq[warp] = __popc(em);
    }
    __syncthreads();
    unsigned int off_less = 0, off_eq = 0, tot_less = 0, tot_eq = 0;
    for (int v = 0; v < nwarps; ++v) {
      const unsigned int cl = warp_less[v], ce = warp_eq[v];
      if (v < warp) {
        off_less += cl;
        off_eq += ce;
      }
      tot_less += cl;
      tot_eq += ce;
    }
    if (is_less)
      buf[base_less + off_less + __popc(lm & lt_mask)] = word_of(key, i);
    if (is_eq) {
      const unsigned int pos = base_eq + off_eq + __popc(em & lt_mask);
      if (pos < need) buf[n_less + pos] = word_of(key, i);
    }
    base_less += tot_less;
    base_eq += tot_eq;
    __syncthreads();  // warp counts are rewritten next round
    if (base_less >= n_less && base_eq >= need) break;
  }
  for (int i = k_out + tid; i < m; i += nthreads) buf[i] = ~0ull;
  __syncthreads();
  bitonic_sort(buf, m);
  for (int t = tid; t < k_out; t += nthreads)
    write_winner(parts, r, w, (int)(buf[t] & 0xffffffffu), id_max,
                 out_dist + r * k_out + t, out_ids + r * k_out + t);
}

template <bool kVec>
__global__ void mask_or_kernel(MaskParts parts, int nparts, long long nbytes,
                               uint8_t* __restrict__ out,
                               uint8_t* __restrict__ acc) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (kVec) {
    const long long words = nbytes >> 4;
    for (long long i = start; i < words; i += stride) {
      uint4 v = reinterpret_cast<const uint4*>(parts.mask[0])[i];
      for (int s = 1; s < nparts; ++s) {
        const uint4 u = reinterpret_cast<const uint4*>(parts.mask[s])[i];
        v.x |= u.x;
        v.y |= u.y;
        v.z |= u.z;
        v.w |= u.w;
      }
      reinterpret_cast<uint4*>(out)[i] = v;
      if (acc != nullptr) {
        uint4 a = reinterpret_cast<uint4*>(acc)[i];
        a.x |= v.x;
        a.y |= v.y;
        a.z |= v.z;
        a.w |= v.w;
        reinterpret_cast<uint4*>(acc)[i] = a;
      }
    }
    done = words << 4;
  }
  for (long long i = done + start; i < nbytes; i += stride) {
    uint8_t v = 0;
    for (int s = 0; s < nparts; ++s) v |= parts.mask[s][i];
    out[i] = v;
    if (acc != nullptr) acc[i] |= v;
  }
}

template <int E>
cudaError_t launch_small(const MergeParts& mp, int b, int w, int total,
                         int k_out, long long id_max, float* out_dist,
                         int32_t* out_ids, cudaStream_t st) {
  const unsigned blocks = (unsigned)((b + SMALL_ROWS - 1) / SMALL_ROWS);
  merge_small_kernel<E><<<blocks, SMALL_ROWS * 32, 0, st>>>(
      mp, b, w, total, k_out, id_max, out_dist, out_ids);
  return cudaGetLastError();
}

template <bool kCached, bool kSharedSort>
cudaError_t launch_block(const MergeParts& mp, int b, int w, int total,
                         int m, int k_out, long long id_max,
                         float* out_dist, int32_t* out_ids,
                         unsigned long long* scratch, long long scratch_ld,
                         cudaStream_t st) {
  const int smem = (kSharedSort ? m * 8 : 0) + (kCached ? total * 4 : 0);
  static SurrealSmemDone smem_done;
  auto* kernel = merge_block_kernel<kCached, kSharedSort>;
  const cudaError_t attr = surreal_smem_limit(kernel, smem, &smem_done);
  if (attr != cudaSuccess) return attr;
  kernel<<<(unsigned)b, BTHREADS, (size_t)smem, st>>>(
      mp, w, total, m, k_out, id_max, out_dist, out_ids, scratch,
      scratch_ld);
  return cudaGetLastError();
}

}  // namespace

SURREAL_API int merge_partials_topk(const long long* table, int parts,
                                    int b, int w, int k_out,
                                    long long id_max, float* out_dist,
                                    int32_t* out_ids,
                                    unsigned long long* scratch,
                                    long long scratch_ld, void* stream) {
  if (b <= 0) return (int)cudaSuccess;
  if (parts <= 0 || parts > SURREAL_MERGE_MAX_PARTS || w <= 0 ||
      k_out <= 0 || (long long)parts * w < k_out ||
      (long long)parts * w > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  MergeParts mp = {};
  for (int s = 0; s < parts; ++s) {
    const long long ws = table[3 * parts + s];
    if (ws < 0 || ws > w ||
        (ws > 0 && (table[s] == 0 || table[parts + s] == 0)))
      return (int)cudaErrorInvalidValue;
    mp.dist[s] = reinterpret_cast<const float*>(table[s]);
    mp.ids[s] = reinterpret_cast<const int32_t*>(table[parts + s]);
    mp.base[s] = table[2 * parts + s];
    mp.width[s] = (int)ws;
  }
  const int total = parts * w;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (total <= SMALL_MAX) {
    const int lanes = (total + 31) / 32;  // words a lane, rounded to 2^k
    err = lanes <= 1   ? launch_small<1>(mp, b, w, total, k_out, id_max,
                                         out_dist, out_ids, st)
          : lanes <= 2 ? launch_small<2>(mp, b, w, total, k_out, id_max,
                                         out_dist, out_ids, st)
          : lanes <= 4 ? launch_small<4>(mp, b, w, total, k_out, id_max,
                                         out_dist, out_ids, st)
                       : launch_small<8>(mp, b, w, total, k_out, id_max,
                                         out_dist, out_ids, st);
    return (int)err;
  }
  int m = 1;
  while (m < k_out) m <<= 1;
  const bool cached = total <= KEY_CACHE;
  if (m <= SURREAL_MERGE_SORT_KEYS) {
    err = cached ? launch_block<true, true>(mp, b, w, total, m, k_out,
                                            id_max, out_dist, out_ids,
                                            nullptr, 0, st)
                 : launch_block<false, true>(mp, b, w, total, m, k_out,
                                             id_max, out_dist, out_ids,
                                             nullptr, 0, st);
  } else {
    if (scratch == nullptr || scratch_ld < m)
      return (int)cudaErrorInvalidValue;
    err = cached ? launch_block<true, false>(mp, b, w, total, m, k_out,
                                             id_max, out_dist, out_ids,
                                             scratch, scratch_ld, st)
                 : launch_block<false, false>(mp, b, w, total, m, k_out,
                                              id_max, out_dist, out_ids,
                                              scratch, scratch_ld, st);
  }
  return (int)err;
}

SURREAL_API int mask_or_reduce(const uint8_t* const* masks, int parts,
                               long long nbytes, uint8_t* out,
                               uint8_t* acc, void* stream) {
  if (nbytes <= 0) return (int)cudaSuccess;
  if (parts <= 0 || parts > SURREAL_MERGE_MAX_PARTS || out == nullptr)
    return (int)cudaErrorInvalidValue;
  MaskParts mp = {};
  bool aligned =
      (reinterpret_cast<uintptr_t>(out) & 15) == 0 &&
      (acc == nullptr || (reinterpret_cast<uintptr_t>(acc) & 15) == 0);
  for (int s = 0; s < parts; ++s) {
    if (masks[s] == nullptr) return (int)cudaErrorInvalidValue;
    mp.mask[s] = masks[s];
    aligned = aligned && (reinterpret_cast<uintptr_t>(masks[s]) & 15) == 0;
  }
  const int threads = 256;
  long long blocks = ((nbytes >> 4) + threads - 1) / threads;
  const long long cap = 8LL * surreal_sm_count();
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (aligned)
    mask_or_kernel<true><<<(unsigned)blocks, threads, 0, st>>>(
        mp, parts, nbytes, out, acc);
  else
    mask_or_kernel<false><<<(unsigned)blocks, threads, 0, st>>>(
        mp, parts, nbytes, out, acc);
  return (int)cudaGetLastError();
}
