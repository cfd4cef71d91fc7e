// select_topk_rows: exact per-row k smallest, in ascending (value, index)
// order, so ties go to the lower index as jax.lax.top_k breaks them.
// select_topk_pairs: the same over packed (order key << 32 | id) pairs
// with a per-row count, ascending by (value, id).
//
// Replaces surrealdb_tpu/ops/topk.py:13 top_k_smallest (lax.top_k), and
// the approx_max_k candidate stage of ops/topk.py:78 knn_rank_rescore
// and :145 knn_rank_int8, whose TPU PartialReduce has no CUDA
// counterpart: selecting the candidates exactly gives the reference's
// answer wherever the approximate stage was exact. It also serves the
// running merge of knn_search_blocked (selection over [best, block] with
// an id map: ties go by column there, which is id order, since the best
// ids precede the block's) and, in pair mode, the final select of the
// int8 store's candidate pass (rank_int8.cu), whose survivors arrive in
// no order: ties there go by id.
//
// Every entry is a 64-bit key: (order-preserving uint32 of the value,
// -0.0 and +0.0 sharing one) << 32 | (its column, or the pair's id). The
// keys are distinct, so "the k smallest" is one exact set, found by a
// radix select over the 64 bits in digits of 11, 11, 10 (the value) and
// 11, 11, 10 (the column or id) bits. After each digit, when every key
// at or below the digit's bin fits the sort buffer, one more read
// gathers those keys (in any order) and a bitonic sort of them finishes:
// for KNN scores (k small, the smallest values in a sparse tail) that is
// after the first digit, two reads of the row. The sort buffer is 8192
// entries of shared memory, or for k > SURREAL_SELECT_MAX_K a per-row
// slice of the caller's device scratch.
//
// Few rows over many entries (rows below the SM count, e.g. a query
// batch of 1 or 16 over millions of scores): each row is split over G
// blocks. Every block adds its slice's histogram of a digit into the
// row's histogram in the caller's workspace (one launch per value
// digit, each block walking the histograms before it to find the bin,
// and returning at once when an earlier digit already fits the gather
// buffer); then all G blocks gather the keys at or below the found bin
// into the row's gather buffer through a warp-aggregated atomic count;
// then one block a row selects the k smallest of the gathered keys as
// above. A row whose ties at one value outnumber the gather buffer falls
// back to one block over the whole row. Both paths sort the same keys,
// so they give the same (value, index) output bit for bit.
//
// Bound on the H100: bytes, one read of the [rows, n] f32 input; the
// usual case reads it twice.
//
// select_topk_pairs has its own kernel (select_pairs_kernel), one block
// of 256 threads a row at every row count, a key buffer sized to k (a
// power of two >= 1.25 k: 2048 keys, 16 KB, at knn10m's k = 1280, so
// four rows fit an SM and a 512-row frame takes one wave). Its rows
// (~24k survivors of the int8 candidates pass at B = 512) hold values
// within a binade or two, which a fixed top digit would not separate.
// Bound: bytes, one read of the pairs' [0, count) prefixes (0.031 ms at
// 512 x 24k). So the design reads a row once in the usual case:
// 1. a sample of 4096 keys in 16 chunks spread over the row gives the
//    first range [lo, hi] and a guess g, the sample's key at the share of
//    sqrt(k buffer) keys (a histogram of 256 bins kept per warp, so only
//    a warp's lanes contend for a bin);
// 2. one read with 16-byte streaming loads appends every key <= g to the
//    buffer (a warp's keys of a step placed by ballots, one shared atomic
//    a warp and step);
// 3. when k <= appended <= buffer (every row of a knn10m frame in the
//    runs measured, PERF.md) those keys hold the k smallest: a bucket
//    sort finishes (a histogram of the keys over their own range, a
//    scatter into the buckets, each key ranked within its bucket; a
//    bucket of more than 32 keys sends them to sort.cuh's bitonic sort);
// 4. else levels of 2048-bin histograms narrow the range that holds the
//    k-th key, one read each (lanes of one bin add once, through
//    __match_any_sync, so ties do not serialise a warp; a bin of one key
//    value that overflows the buffer ends with that key repeated), then
//    one more read gathers the keys up to it.
#include "sort.cuh"

namespace {

constexpr int NBINS = 2048;               // widest digit: 11 bits
constexpr int CAP = 8192;                 // shared sort buffer
constexpr int SMEM_BYTES = CAP * 8 + NBINS * 4;
constexpr int NLEVELS = 6;                // digits over the 64-bit key
constexpr int KEY_LEVELS = 3;             // digits over the value
// the multi-block workspace of a row: the value digits' histograms
// (2048, 2048 and 1024 bins) and the gather count
constexpr int WS_COUNT = 5120;
constexpr int WS_U32 = SURREAL_SELECT_WORK_U32;
constexpr int MB_THREADS = 512;
constexpr unsigned FULL = 0xFFFFFFFFu;

typedef unsigned long long u64;

__device__ __forceinline__ int level_width(int lv) {
  return lv % 3 == 2 ? 10 : 11;
}

__device__ __forceinline__ int level_offset(int lv) {
  return lv == 0 ? 0 : (lv == 1 ? 2048 : 4096);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// bitonic sort of sbuf[0:m] ascending (m a power of two); sbuf lies in
// shared memory, or in device memory for a large k (__syncthreads orders
// the block's global accesses as well)
__device__ __forceinline__ void bitonic_sort(u64* sbuf, int m) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  for (int size = 2; size <= m; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < m; i += nthreads) {
        const int j = i ^ stride;
        if (j > i) {
          const u64 a = sbuf[i], b = sbuf[j];
          const bool up = (i & size) == 0;
          if ((a > b) == up) {
            sbuf[i] = b;
            sbuf[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// one full warp: the bin of hist[0:nb] (shared or global) holding the
// need-th key (1-based) and how many keys precede it, written by one
// lane to *bin / *before
__device__ __forceinline__ void find_bin_warp(const unsigned int* hist,
                                              int nb, unsigned int need,
                                              unsigned int* bin,
                                              unsigned int* before) {
  const int lane = threadIdx.x & 31;
  const int per = nb >> 5;
  unsigned int s = 0;
  for (int i = 0; i < per; ++i) s += hist[lane * per + i];
  unsigned int inc = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned int t = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += t;
  }
  const unsigned int ball = __ballot_sync(FULL, inc >= need);
  const int hit = ball ? __ffs(ball) - 1 : 31;
  if (lane == hit) {
    unsigned int cum = inc - s;
    int b = lane * per;
    const int last = b + per - 1;
    for (; b < last; ++b) {
      if (cum + hist[b] >= need) break;
      cum += hist[b];
    }
    *bin = (unsigned int)b;
    *before = cum;
  }
  __syncwarp();
}

// f(hk, lk, in) over entries [lo, hi) of a row of f32 values, the key's
// high word hk = order_key(v[i]) and low word lk = i (the digits over
// the value read the high word alone: 32-bit work, as one block a row is
// bound by its ALU); every thread of the block calls f the same number
// of times (`in` is false past the slice), so f may use warp votes.
// float4 pairs where the slice is 16-byte aligned, scalars else.
struct FloatRow {
  const float* v;
  template <typename F>
  __device__ __forceinline__ void scan(long long lo, long long hi,
                                       F f) const {
    const int tid = threadIdx.x, nt = blockDim.x;
    const long long mis = (reinterpret_cast<uintptr_t>(v + lo) & 15) >> 2;
    long long a = lo + (mis ? 4 - mis : 0);
    if (a > hi) a = hi;
    for (long long s = lo; s < a; s += nt) {
      const long long i = s + tid;
      const bool p = i < a;
      f(p ? order_key(v[i]) : ~0u, (uint32_t)i, p);
    }
    const float4* v4 = reinterpret_cast<const float4*>(v + a);
    const long long n4 = (hi - a) >> 2;
    for (long long base = 0; base < n4; base += 2LL * nt) {
      const long long j0 = base + tid, j1 = j0 + nt;
      const bool p0 = j0 < n4, p1 = j1 < n4;
      const float4 x = p0 ? v4[j0] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 y = p1 ? v4[j1] : make_float4(0.f, 0.f, 0.f, 0.f);
      const uint32_t i0 = (uint32_t)(a + 4 * j0), i1 = (uint32_t)(a + 4 * j1);
      f(order_key(x.x), i0, p0);
      f(order_key(x.y), i0 + 1, p0);
      f(order_key(x.z), i0 + 2, p0);
      f(order_key(x.w), i0 + 3, p0);
      f(order_key(y.x), i1, p1);
      f(order_key(y.y), i1 + 1, p1);
      f(order_key(y.z), i1 + 2, p1);
      f(order_key(y.w), i1 + 3, p1);
    }
    for (long long s = a + 4 * n4; s < hi; s += nt) {
      const long long i = s + tid;
      const bool p = i < hi;
      f(p ? order_key(v[i]) : ~0u, (uint32_t)i, p);
    }
  }
};

// the same over packed keys (a pair row, or a row's gathered keys)
struct KeyRow {
  const u64* p;
  template <typename F>
  __device__ __forceinline__ void scan(long long lo, long long hi,
                                       F f) const {
    const int tid = threadIdx.x, nt = blockDim.x;
    long long a = lo + ((reinterpret_cast<uintptr_t>(p + lo) & 15) ? 1 : 0);
    if (a > hi) a = hi;
    for (long long s = lo; s < a; s += nt) {
      const long long i = s + tid;
      const bool q = i < a;
      const u64 x = q ? p[i] : ~0ull;
      f((uint32_t)(x >> 32), (uint32_t)x, q);
    }
    const ulonglong2* p2 = reinterpret_cast<const ulonglong2*>(p + a);
    const long long n2 = (hi - a) >> 1;
    for (long long base = 0; base < n2; base += nt) {
      const long long j = base + tid;
      const bool q = j < n2;
      const ulonglong2 x = q ? p2[j] : make_ulonglong2(~0ull, ~0ull);
      f((uint32_t)(x.x >> 32), (uint32_t)x.x, q);
      f((uint32_t)(x.y >> 32), (uint32_t)x.y, q);
    }
    for (long long s = a + 2 * n2; s < hi; s += nt) {
      const long long i = s + tid;
      const bool q = i < hi;
      const u64 x = q ? p[i] : ~0ull;
      f((uint32_t)(x >> 32), (uint32_t)x, q);
    }
  }
};

// output of a float row: the value read back (so -0.0 stays -0.0) and
// the column, mapped through ids when given
struct FloatOut {
  const float* v;
  const int32_t* ids;  // this row's id map, or null
  float* ov;           // this row's outputs
  int32_t* oi;
  __device__ __forceinline__ void operator()(int i, u64 key) const {
    const uint32_t idx = (uint32_t)key;
    ov[i] = v[idx];
    oi[i] = ids != nullptr ? ids[idx] : (int32_t)idx;
  }
};

// one block: the k smallest keys of row[0:n] (k <= n), sorted, to out.
// sbuf holds `cap` keys (a power of two >= k); hist 2048 shared bins.
template <typename Row, typename Out>
__device__ void block_select(const Row& row, long long n, int k, u64* sbuf,
                             long long cap, unsigned int* hist,
                             const Out& out) {
  __shared__ unsigned int s_bin, s_before, s_count;
  const int tid = threadIdx.x, nt = blockDim.x;
  u64 prefix = 0ull;
  int shift = 64;
  unsigned int need = (unsigned int)k, less = 0;
  for (int lv = 0; lv < NLEVELS; ++lv) {
    const int w = level_width(lv), nb = 1 << w;
    const u64 hmask = shift == 64 ? 0ull : ~0ull << shift;
    shift -= w;
    for (int i = tid; i < nb; i += nt) hist[i] = 0u;
    __syncthreads();
    if (shift >= 32) {  // a digit of the value: the high word alone
      const uint32_t mh = (uint32_t)(hmask >> 32), ph = (uint32_t)(prefix >> 32);
      const int sh = shift - 32;
      row.scan(0, n, [&](uint32_t hk, uint32_t, bool in) {
        if (in && (hk & mh) == ph)
          atomicAdd(&hist[(hk >> sh) & (unsigned int)(nb - 1)], 1u);
      });
    } else {
      row.scan(0, n, [&](uint32_t hk, uint32_t lk, bool in) {
        const u64 key = ((u64)hk << 32) | lk;
        if (in && (key & hmask) == prefix)
          atomicAdd(&hist[(unsigned int)(key >> shift) & (nb - 1)], 1u);
      });
    }
    __syncthreads();
    if (tid < 32) find_bin_warp(hist, nb, need, &s_bin, &s_before);
    __syncthreads();
    const unsigned int bin = s_bin, before = s_before;
    const u64 le = (u64)less + before + hist[bin];  // keys <= the bin
    prefix |= (u64)bin << shift;
    less += before;
    need -= before;
    if (le <= (u64)cap || lv == NLEVELS - 1) {
      // gather every key at or below the bin (in any order), sort
      const int cnt = (int)(le < (u64)cap ? le : (u64)cap);
      if (tid == 0) s_count = 0u;
      __syncthreads();
      const u64 top = prefix >> shift;
      auto take = [&](uint32_t hk, uint32_t lk) {
        const unsigned int pos = atomicAdd(&s_count, 1u);
        if (pos < (unsigned int)cnt) sbuf[pos] = ((u64)hk << 32) | lk;
      };
      if (shift >= 32) {
        const int sh = shift - 32;
        const uint32_t top32 = (uint32_t)top;
        row.scan(0, n, [&](uint32_t hk, uint32_t lk, bool in) {
          if (in && (hk >> sh) <= top32) take(hk, lk);
        });
      } else {
        row.scan(0, n, [&](uint32_t hk, uint32_t lk, bool in) {
          if (in && ((((u64)hk << 32) | lk) >> shift) <= top) take(hk, lk);
        });
      }
      int m = 1;
      while (m < cnt) m <<= 1;
      __syncthreads();
      for (int i = cnt + tid; i < m; i += nt) sbuf[i] = ~0ull;
      __syncthreads();
      bitonic_sort(sbuf, m);
      for (int i = tid; i < k; i += nt) out(i, sbuf[i]);
      return;
    }
    __syncthreads();  // every thread has read hist[bin]
  }
}

__global__ void __launch_bounds__(1024)
    select_rows_kernel(const float* __restrict__ in, long long ld,
                       const int32_t* __restrict__ ids, long long ids_ld,
                       long long n, int k, float* __restrict__ out_vals,
                       int32_t* __restrict__ out_idx,
                       u64* __restrict__ scratch, long long scratch_ld) {
  extern __shared__ __align__(16) u64 smem[];
  unsigned int* hist = reinterpret_cast<unsigned int*>(smem + CAP);
  const long long r = blockIdx.x;
  const bool large = k > SURREAL_SELECT_MAX_K;
  u64* sbuf = large ? scratch + r * scratch_ld : smem;
  const long long cap = large ? scratch_ld : CAP;
  const float* v = in + r * ld;
  block_select(FloatRow{v}, n, k, sbuf, cap, hist,
               FloatOut{v, ids != nullptr ? ids + r * ids_ld : nullptr,
                        out_vals + r * k, out_idx + r * k});
}

// -- few rows: G blocks a row ---------------------------------------------

struct Walk {
  int stop;  // first value digit whose keys <= its bin fit the gather
             // buffer, or -1
  int shift;
  u64 prefix;
  unsigned int le;
};

// warp 0: walk the row's digit histograms (workspace ws) through at most
// `upto` digits, stopping at the first whose keys <= its bin fit gcap
__device__ void walk_levels(const unsigned int* ws, unsigned int k,
                            int upto, long long gcap, Walk* out) {
  __shared__ unsigned int w_bin, w_before;
  u64 prefix = 0ull;
  int shift = 64, stop = -1;
  unsigned int need = k, less = 0, le = 0;
  for (int lv = 0; lv < upto; ++lv) {
    shift -= level_width(lv);
    const unsigned int* h = ws + level_offset(lv);
    find_bin_warp(h, 1 << level_width(lv), need, &w_bin, &w_before);
    const unsigned int bin = w_bin, before = w_before;
    le = less + before + h[bin];
    prefix |= (u64)bin << shift;
    less += before;
    need -= before;
    __syncwarp();
    if ((long long)le <= gcap) {
      stop = lv;
      break;
    }
  }
  if ((threadIdx.x & 31) == 0) *out = Walk{stop, shift, prefix, le};
}

// this block's slice of a row of len entries, in multiples of 1024
__device__ __forceinline__ void slice(long long len, long long* lo,
                                      long long* hi) {
  long long per = (len + gridDim.x - 1) / gridDim.x;
  per = (per + 1023) & ~1023LL;
  *lo = (long long)blockIdx.x * per;
  *hi = *lo + per < len ? *lo + per : len;
  if (*lo > len) *lo = len;
}

// a value digit (shift >= 32): the high word alone
template <typename Row>
__device__ void hist_slice(const Row& row, long long lo, long long hi,
                           int lv, u64 prefix, u64 hmask, int shift,
                           unsigned int* sh, unsigned int* ws) {
  const int nb = 1 << level_width(lv);
  const uint32_t mh = (uint32_t)(hmask >> 32), ph = (uint32_t)(prefix >> 32);
  const int s32 = shift - 32;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) sh[i] = 0u;
  __syncthreads();
  row.scan(lo, hi, [&](uint32_t hk, uint32_t, bool in) {
    if (in && (hk & mh) == ph)
      atomicAdd(&sh[(hk >> s32) & (unsigned int)(nb - 1)], 1u);
  });
  __syncthreads();
  unsigned int* g = ws + level_offset(lv);
  for (int i = threadIdx.x; i < nb; i += blockDim.x)
    if (sh[i]) atomicAdd(&g[i], sh[i]);
}

// digit lv of every row's slices into the row's workspace histogram
__global__ void __launch_bounds__(MB_THREADS)
    select_hist_kernel(const float* __restrict__ in, long long ld,
                       long long n, int k, unsigned int* __restrict__ work,
                       long long gcap, int lv) {
  __shared__ unsigned int sh[NBINS];
  __shared__ Walk s_w;
  const long long r = blockIdx.y;
  unsigned int* ws = work + r * WS_U32;
  u64 prefix = 0ull, hmask = 0ull;
  int shift = 64 - level_width(0);
  if (lv > 0) {
    if (threadIdx.x < 32) walk_levels(ws, (unsigned int)k, lv, gcap, &s_w);
    __syncthreads();
    if (s_w.stop >= 0) return;  // an earlier digit already fits
    prefix = s_w.prefix;
    hmask = ~0ull << s_w.shift;
    shift = s_w.shift - level_width(lv);
  }
  long long lo, hi;
  slice(n, &lo, &hi);
  hist_slice(FloatRow{in + r * ld}, lo, hi, lv, prefix, hmask, shift, sh,
             ws);
}

// keys at or below the digit's bin (a value digit: shift >= 32)
template <typename Row>
__device__ void gather_slice(const Row& row, long long lo, long long hi,
                             u64 top, int shift, unsigned int* count,
                             u64* gbuf, long long gcap) {
  const int lane = threadIdx.x & 31;
  const uint32_t top32 = (uint32_t)top;
  const int s32 = shift - 32;
  row.scan(lo, hi, [&](uint32_t hk, uint32_t lk, bool in) {
    const bool take = in && (hk >> s32) <= top32;
    const unsigned int b = __ballot_sync(FULL, take);
    if (b == 0u) return;
    const int leader = __ffs(b) - 1;
    unsigned int base = 0;
    if (lane == leader) base = atomicAdd(count, (unsigned int)__popc(b));
    base = __shfl_sync(FULL, base, leader);
    if (take) {
      const unsigned int pos = base + __popc(b & ((1u << lane) - 1u));
      if ((long long)pos < gcap) gbuf[pos] = ((u64)hk << 32) | lk;
    }
  });
}

// every key at or below the found bin into the row's gather buffer
__global__ void __launch_bounds__(MB_THREADS)
    select_gather_kernel(const float* __restrict__ in, long long ld,
                         long long n, int k, unsigned int* __restrict__ work,
                         u64* __restrict__ gather, long long gcap) {
  __shared__ Walk s_w;
  const long long r = blockIdx.y;
  unsigned int* ws = work + r * WS_U32;
  if (threadIdx.x < 32)
    walk_levels(ws, (unsigned int)k, KEY_LEVELS, gcap, &s_w);
  __syncthreads();
  if (s_w.stop < 0) return;  // ties overflow: the finish reads the row
  long long lo, hi;
  slice(n, &lo, &hi);
  const u64 top = s_w.prefix >> s_w.shift;
  gather_slice(FloatRow{in + r * ld}, lo, hi, top, s_w.shift, ws + WS_COUNT,
               gather + r * gcap, gcap);
}

// one block a row: the k smallest of the gathered keys (or, where ties
// overflowed the gather buffer, of the whole row)
__global__ void __launch_bounds__(1024)
    select_finish_kernel(const float* __restrict__ in, long long ld,
                         const int32_t* __restrict__ ids, long long ids_ld,
                         long long n, int k, float* __restrict__ out_vals,
                         int32_t* __restrict__ out_idx,
                         u64* __restrict__ scratch, long long scratch_ld,
                         const unsigned int* __restrict__ work,
                         const u64* __restrict__ gather, long long gcap) {
  extern __shared__ __align__(16) u64 smem[];
  __shared__ Walk s_w;
  unsigned int* hist = reinterpret_cast<unsigned int*>(smem + CAP);
  const long long r = blockIdx.x;
  if (threadIdx.x < 32)
    walk_levels(work + r * WS_U32, (unsigned int)k, KEY_LEVELS, gcap, &s_w);
  __syncthreads();
  const bool large = k > SURREAL_SELECT_MAX_K;
  u64* sbuf = large ? scratch + r * scratch_ld : smem;
  const long long cap = large ? scratch_ld : CAP;
  const KeyRow gathered{gather + r * gcap};
  const float* v = in + r * ld;
  const FloatOut out{v, ids != nullptr ? ids + r * ids_ld : nullptr,
                     out_vals + r * k, out_idx + r * k};
  if (s_w.stop >= 0)
    block_select(gathered, (long long)s_w.le, k, sbuf, cap, hist, out);
  else
    block_select(FloatRow{v}, n, k, sbuf, cap, hist, out);
}

int launch_select(const float* in, long long ld, const int32_t* ids,
                  long long ids_ld, int rows, long long n,
                  int k, float* out_vals, int32_t* out_idx, u64* scratch,
                  long long scratch_ld, int blocks_per_row,
                  unsigned int* work, u64* gather, long long gather_cap,
                  cudaStream_t st) {
  if (k > SURREAL_SELECT_MAX_K) {
    long long m = 1;
    while (m < k) m <<= 1;
    if (scratch == nullptr || scratch_ld < m)
      return (int)cudaErrorInvalidValue;
  }
  static SurrealSmemDone done_rows, done_finish;
  if (blocks_per_row <= 1) {
    long long t = ((n + 31) / 32) * 32;
    if (t < 64) t = 64;
    if (t > 1024) t = 1024;
    cudaError_t err =
        surreal_smem_limit(select_rows_kernel, SMEM_BYTES, &done_rows);
    if (err != cudaSuccess) return (int)err;
    select_rows_kernel<<<(unsigned)rows, (unsigned)t, SMEM_BYTES, st>>>(
        in, ld, ids, ids_ld, n, k, out_vals, out_idx, scratch, scratch_ld);
    return (int)cudaGetLastError();
  }
  if (work == nullptr || gather == nullptr || gather_cap < k ||
      blocks_per_row > 65535 || rows > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      work, 0, (size_t)rows * WS_U32 * sizeof(unsigned int), st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)blocks_per_row, (unsigned)rows);
  for (int lv = 0; lv < KEY_LEVELS; ++lv) {
    select_hist_kernel<<<grid, MB_THREADS, 0, st>>>(in, ld, n, k, work,
                                                    gather_cap, lv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  select_gather_kernel<<<grid, MB_THREADS, 0, st>>>(in, ld, n, k, work,
                                                    gather, gather_cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = surreal_smem_limit(select_finish_kernel, SMEM_BYTES, &done_finish);
  if (err != cudaSuccess) return (int)err;
  select_finish_kernel<<<(unsigned)rows, 1024, SMEM_BYTES, st>>>(
      in, ld, ids, ids_ld, n, k, out_vals, out_idx, scratch, scratch_ld,
      work, gather, gather_cap);
  return (int)cudaGetLastError();
}

// -- select_topk_pairs: one block a row, sized to the row -------------------

constexpr int PT = 256;          // threads a pair block
constexpr int PNB = 2048;        // histogram bins
constexpr int PSAMPLE = 4096;    // keys sampled at most
constexpr int PCHUNKS = 16;      // in this many contiguous chunks
constexpr int PBUCKET = 8 * PT;  // at most this many keys bucket-sorted
constexpr int PBUF_SMEM = 8192;  // larger buffers live in device scratch
constexpr u64 NONE64 = ~0ull;

// 16 bytes read once: a streaming load (evict-first in L1 and L2)
__device__ __forceinline__ ulonglong2 ld_stream(const u64* p) {
  ulonglong2 v;
  asm("ld.global.cs.v2.u64 {%0, %1}, [%2];\n"
      : "=l"(v.x), "=l"(v.y)
      : "l"(p));
  return v;
}

// f(x[2U], in[2U]) over row[0:len), 2U keys a thread a call, U 16-byte
// loads in flight; every thread of the block calls f the same number of
// times (`in` is false past the row), so f may use warp votes
template <int U, typename F>
__device__ __forceinline__ void pair_scan(const u64* row, long long len,
                                          F f) {
  const int tid = threadIdx.x;
  u64 x[2 * U];
  bool in[2 * U];
  long long a = (reinterpret_cast<uintptr_t>(row) & 15) ? 1 : 0;
  if (a > len) a = len;
  // the odd ends (a misaligned first key, a last key alone) first
  const bool tail = ((len - a) & 1) != 0;
  if (a || tail) {
#pragma unroll
    for (int u = 0; u < 2 * U; ++u) {
      x[u] = NONE64;
      in[u] = false;
    }
    if (tid == 0 && a) {
      x[0] = row[0];
      in[0] = true;
    }
    if (tid == 1 && tail) {
      x[0] = row[len - 1];
      in[0] = true;
    }
    f(x, in);
  }
  const u64* body = row + a;
  const long long n2 = (len - a) >> 1;
  for (long long j0 = 0; j0 < n2; j0 += (long long)U * PT) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long j = j0 + u * PT + tid;
      const ulonglong2 v =
          j < n2 ? ld_stream(body + 2 * j) : make_ulonglong2(NONE64, NONE64);
      x[2 * u] = v.x;
      x[2 * u + 1] = v.y;
      in[2 * u] = in[2 * u + 1] = j < n2;
    }
    f(x, in);
  }
}

// the bin width (2^shift keys) that cuts [lo, hi] into at most PNB bins
__device__ __forceinline__ int range_shift(u64 lo, u64 hi) {
  const u64 span = hi - lo;
  const int bits = span ? 64 - __clzll((long long)span) : 0;
  return bits > 11 ? bits - 11 : 0;
}

// the last key of bin b of [lo, hi]
__device__ __forceinline__ u64 bin_top(u64 lo, u64 hi, int shift,
                                       unsigned int b) {
  const u64 off = ((u64)(b + 1) << shift) - 1;  // mod 2^64: b + 1 = 2^11
  return off > hi - lo ? hi : lo + off;
}

// one key into a histogram of [lo, hi] (lanes with one bin add once, so
// a bin shared by many keys does not serialise the warp) or into the
// thread's count of keys below lo
__device__ __forceinline__ void hist_key(u64 x, bool in, u64 lo, u64 hi,
                                         int shift, unsigned int* hist,
                                         unsigned int* below) {
  const bool inr = in && x >= lo && x <= hi;
  *below += (in && x < lo) ? 1u : 0u;
  const unsigned int bin = inr ? (unsigned int)((x - lo) >> shift) : ~0u;
  const unsigned int peers = __match_any_sync(FULL, bin);
  if (inr && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&hist[bin], (unsigned int)__popc(peers));
}

// the warp's taken keys of one scan step to buf[count...]: one atomic a
// warp and step (positions past cap are counted, not stored)
template <int M>
__device__ __forceinline__ void append(const u64 (&x)[M],
                                       const bool (&take)[M], u64* buf,
                                       int cap, unsigned int* count) {
  const int lane = threadIdx.x & 31;
  const unsigned int below_me = (1u << lane) - 1u;
  unsigned int ball[M], total = 0;
#pragma unroll
  for (int u = 0; u < M; ++u) {
    ball[u] = __ballot_sync(FULL, take[u]);
    total += __popc(ball[u]);
  }
  if (total == 0u) return;
  unsigned int base = 0;
  if (lane == 0) base = atomicAdd(count, total);
  base = __shfl_sync(FULL, base, 0);
#pragma unroll
  for (int u = 0; u < M; ++u) {
    if (take[u]) {
      const unsigned int pos = base + __popc(ball[u] & below_me);
      if (pos < (unsigned int)cap) buf[pos] = x[u];
    }
    base += __popc(ball[u]);
  }
}

// the u64 minimum and maximum over the block (red: 2 PT / 32 entries)
__device__ __forceinline__ void block_min_max(u64* lo, u64* hi, u64* red) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const u64 a = __shfl_xor_sync(FULL, *lo, o);
    const u64 b = __shfl_xor_sync(FULL, *hi, o);
    *lo = a < *lo ? a : *lo;
    *hi = b > *hi ? b : *hi;
  }
  if ((threadIdx.x & 31) == 0) {
    red[warp] = *lo;
    red[PT / 32 + warp] = *hi;
  }
  __syncthreads();
  for (int w = 0; w < PT / 32; ++w) {
    *lo = red[w] < *lo ? red[w] : *lo;
    *hi = red[PT / 32 + w] > *hi ? red[PT / 32 + w] : *hi;
  }
  __syncthreads();
}

// the exclusive scan of PNB bins, PNB / PT consecutive ones a thread:
// the count before the thread's first bin (its counts to c), and in
// *big the block's largest bin (scan: 2 PT / 32 u32; syncs once)
constexpr int BPT = PNB / PT;
__device__ __forceinline__ unsigned int block_scan_bins(
    const unsigned int* hist, unsigned int (&c)[BPT], unsigned int* scan,
    unsigned int* big) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned int sum = 0, mx = 0;
#pragma unroll
  for (int i = 0; i < BPT; ++i) {
    c[i] = hist[tid * BPT + i];
    mx = c[i] > mx ? c[i] : mx;
    sum += c[i];
  }
  unsigned int inc = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned int t = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += t;
  }
  mx = __reduce_max_sync(FULL, mx);
  if (lane == 31) scan[warp] = inc;
  if (lane == 0) scan[PT / 32 + warp] = mx;
  __syncthreads();
  unsigned int run = inc - sum;
  for (int w = 0; w < PT / 32; ++w) {
    if (w < warp) run += scan[w];
    mx = scan[PT / 32 + w] > mx ? scan[PT / 32 + w] : mx;
  }
  *big = mx;
  return run;
}

// the bin of hist[0:PNB] holding the need-th key (1-based) and the keys
// before it, to *bin / *before (as find_bin_warp: the last bin when the
// bins hold fewer); every thread calls it, a __syncthreads must follow
__device__ __forceinline__ void find_bin_block(const unsigned int* hist,
                                               unsigned int need,
                                               unsigned int* bin,
                                               unsigned int* before,
                                               unsigned int* scan) {
  unsigned int c[BPT], big;
  unsigned int run = block_scan_bins(hist, c, scan, &big);
  const int tid = threadIdx.x;
  unsigned int sum = 0;
#pragma unroll
  for (int i = 0; i < BPT; ++i) sum += c[i];
  if (run < need && need <= run + sum) {
#pragma unroll
    for (int i = 0; i < BPT; ++i) {
      if (run + c[i] >= need) {
        *bin = (unsigned int)(tid * BPT + i);
        *before = run;
        break;
      }
      run += c[i];
    }
  } else if (tid == PT - 1 && run + sum < need) {
    *bin = PNB - 1;
    *before = run + sum - c[BPT - 1];
  }
}

// buf[0:got] (got <= PBUCKET, distinct or not) ascending: a histogram of
// the keys over their own range, its exclusive scan, a scatter into the
// buckets (the keys held in registers meanwhile), then each key's rank
// within its bucket (keys equal to it count by their slot); a bucket of
// more than 32 keys (ties packed tight) sends the whole buffer to the
// bitonic sort instead
__device__ void bucket_sort(u64* buf, int got, unsigned int* hist, u64* red,
                            unsigned int* scan) {
  const int tid = threadIdx.x;
  constexpr int PER = PBUCKET / PT;
  u64 v[PER];
  u64 lo = NONE64, hi = 0;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = u * PT + tid;
    v[u] = i < got ? buf[i] : NONE64;
    if (i < got) {
      lo = v[u] < lo ? v[u] : lo;
      hi = v[u] > hi ? v[u] : hi;
    }
  }
  for (int i = tid; i < PNB; i += PT) hist[i] = 0u;
  block_min_max(&lo, &hi, red);  // syncs: hist is zero after it
  const int shift = range_shift(lo, hi);
  unsigned int bin[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    bin[u] = (unsigned int)((v[u] - lo) >> shift);
    if (u * PT + tid < got) atomicAdd(&hist[bin[u]], 1u);
  }
  __syncthreads();
  unsigned int c[BPT], big;
  unsigned int run = block_scan_bins(hist, c, scan, &big);
  if (big > 32u) {  // tied keys packed tight: sort it all
    int m = 32;
    while (m < got) m <<= 1;
    for (int i = got + tid; i < m; i += PT) buf[i] = NONE64;
    __syncthreads();
    block_sort(buf, m);
    return;
  }
#pragma unroll
  for (int i = 0; i < BPT; ++i) {
    hist[tid * BPT + i] = run;  // the bucket's start, then its cursor
    run += c[i];
  }
  __syncthreads();
  unsigned int slot[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    if (u * PT + tid < got) {
      slot[u] = atomicAdd(&hist[bin[u]], 1u);
      buf[slot[u]] = v[u];
    }
  }
  __syncthreads();
  // hist[b] is now the end of bucket b (the start of b + 1)
  unsigned int pos[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    if (u * PT + tid < got) {
      const unsigned int s0 = bin[u] ? hist[bin[u] - 1] : 0u, e = hist[bin[u]];
      unsigned int r = s0;
      for (unsigned int q = s0; q < e; ++q) {
        const u64 o = buf[q];
        r += (o < v[u] || (o == v[u] && q < slot[u])) ? 1u : 0u;
      }
      pos[u] = r;
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < PER; ++u)
    if (u * PT + tid < got) buf[pos[u]] = v[u];
  __syncthreads();
}

// per row r: the k smallest of pairs[r, 0:min(counts[r], ld)] ascending
// by (value, id), or (+inf, -1) when the row holds fewer than k. The
// buffer holds sb keys (a power of two >= 64 and >= k): the dynamic
// shared memory, or this row's slice of scratch when sb > PBUF_SMEM;
// then PNB u32 bins.
__global__ void __launch_bounds__(PT, 4)
    select_pairs_kernel(const u64* __restrict__ pairs, long long ld,
                        const unsigned int* __restrict__ counts, int k,
                        int sb, float* __restrict__ out_vals,
                        int32_t* __restrict__ out_idx,
                        u64* __restrict__ scratch) {
  extern __shared__ __align__(16) u64 psm[];
  __shared__ u64 s_red[2 * (PT / 32)];
  __shared__ unsigned int s_scan[2 * (PT / 32)];
  __shared__ unsigned int s_cnt, s_below, s_bin, s_before;
  const int tid = threadIdx.x;
  const long long r = blockIdx.x;
  const long long cnt = counts[r];
  const long long len = cnt < ld ? cnt : ld;
  float* ov = out_vals + r * k;
  int32_t* oi = out_idx + r * k;
  if (len < k) {
    for (int i = tid; i < k; i += PT) {
      ov[i] = INFINITY;
      oi[i] = -1;
    }
    return;
  }
  const bool in_smem = sb <= PBUF_SMEM;
  u64* buf = in_smem ? psm : scratch + r * sb;
  unsigned int* hist =
      reinterpret_cast<unsigned int*>(in_smem ? psm + sb : psm);
  const u64* row = pairs + r * ld;
  // buf[0:got] (any order) sorted; out: its first k, then `fill`
  auto finish = [&](int got, u64 fill) {
    if (got <= PBUCKET) {
      bucket_sort(buf, got, hist, s_red, s_scan);
    } else {
      int m = 32;
      while (m < got) m <<= 1;
      for (int i = got + tid; i < m; i += PT) buf[i] = NONE64;
      __syncthreads();
      block_sort(buf, m);
    }
    for (int i = tid; i < k; i += PT) {
      const u64 key = i < got ? buf[i] : fill;
      ov[i] = key_value((uint32_t)(key >> 32));
      oi[i] = (int32_t)(uint32_t)key;
    }
  };
  if (len <= sb) {  // the whole row fits the buffer
    for (long long i = tid; i < len; i += PT) buf[i] = row[i];
    __syncthreads();
    finish((int)len, NONE64);
    return;
  }
  // 1. a sample of ns keys in PCHUNKS chunks spread over the row: its
  // range [lo, hi] is the first level's, and its key at the share of
  // sqrt(k sb) keys (the middle, in ratio, of k..sb) the guess g, from a
  // histogram of PT bins kept per warp (a warp's lanes are all that
  // contend for a bin)
  const int ns = len >= PSAMPLE ? PSAMPLE : (int)(len / PCHUNKS) * PCHUNKS;
  const int chunk = ns / PCHUNKS;
  const long long stride = len / PCHUNKS;
  u64 lo = NONE64, hi = 0;
  int sshift;
  {
    u64 v[PSAMPLE / PT];
#pragma unroll
    for (int u = 0; u < PSAMPLE / PT; ++u) {
      const int i = u * PT + tid;
      v[u] = i < ns ? row[(long long)(i / chunk) * stride + i % chunk]
                    : NONE64;
      if (i < ns) {
        lo = v[u] < lo ? v[u] : lo;
        hi = v[u] > hi ? v[u] : hi;
      }
    }
    for (int i = tid; i < PNB; i += PT) hist[i] = 0u;
    block_min_max(&lo, &hi, s_red);
    sshift = range_shift(lo, hi) + 3;  // PT = PNB / 8 bins
    unsigned int* wh = hist + (tid >> 5) * PT;
#pragma unroll
    for (int u = 0; u < PSAMPLE / PT; ++u)
      if (u * PT + tid < ns)
        atomicAdd(&wh[(unsigned int)((v[u] - lo) >> sshift)], 1u);
  }
  __syncthreads();
  long long j = (long long)ceil(sqrt((double)k * sb) * ns / (double)len);
  j = j < 1 ? 1 : (j > ns ? ns : j);
  {
    // bin tid over the warps, its exclusive scan, the bin of the j-th
    unsigned int c = 0;
    for (int w = 0; w < PT / 32; ++w) c += hist[w * PT + tid];
    unsigned int inc = c;
    const int lane = tid & 31;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned int t = __shfl_up_sync(FULL, inc, o);
      if (lane >= o) inc += t;
    }
    if (lane == 31) s_scan[tid >> 5] = inc;
    if (tid == 0) s_cnt = 0u;
    __syncthreads();
    unsigned int run = inc - c;
    for (int w = 0; w < (tid >> 5); ++w) run += s_scan[w];
    if (run < (unsigned int)j && (unsigned int)j <= run + c) s_bin = tid;
  }
  __syncthreads();
  int shift = range_shift(lo, hi);
  const u64 g = bin_top(lo, hi, sshift, s_bin);
  // 2. one read of the row: every key <= g appended to the buffer
  pair_scan<8>(row, len, [&](const u64 (&x)[16], const bool (&in)[16]) {
    bool take[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) take[u] = in[u] && x[u] <= g;
    append(x, take, buf, sb, &s_cnt);
  });
  __syncthreads();
  const unsigned int got = s_cnt;
  if (got >= (unsigned int)k && got <= (unsigned int)sb) {
    finish((int)got, NONE64);
    return;
  }
  // 3. the guess missed: levels of histograms, each one more read, the
  // first over the sample's range [lo, hi]: the bin holding the k-th key.
  // Once the keys up to it fit the buffer, one more read gathers them (a
  // bin of one key value that does not fit: the keys below it, then that
  // key repeated); else that bin's range is the next level
  for (;;) {
    for (int i = tid; i < PNB; i += PT) hist[i] = 0u;
    if (tid == 0) s_below = 0u;
    __syncthreads();
    unsigned int below = 0;
    pair_scan<4>(row, len, [&](const u64 (&x)[8], const bool (&in)[8]) {
#pragma unroll
      for (int u = 0; u < 8; ++u)
        hist_key(x[u], in[u], lo, hi, shift, hist, &below);
    });
    below = __reduce_add_sync(FULL, below);
    if ((tid & 31) == 0) atomicAdd(&s_below, below);
    __syncthreads();
    const unsigned int below_t = s_below;
    u64 nlo, nhi;
    if (below_t >= (unsigned int)k) {  // below the range (lo > 0)
      nlo = 0;
      nhi = lo - 1;
    } else {
      find_bin_block(hist, (unsigned int)k - below_t, &s_bin, &s_before,
                     s_scan);
      __syncthreads();
      const unsigned int b = s_bin;
      const unsigned int lt = below_t + s_before;  // keys below the bin
      const unsigned int le = lt + hist[b];
      if (le < (unsigned int)k) {  // above the range (hi < NONE64)
        nlo = hi + 1;
        nhi = NONE64;
      } else {
        nlo = lo + ((u64)b << shift);
        nhi = bin_top(lo, hi, shift, b);
        if (le <= (unsigned int)sb || nlo == nhi) {
          const bool strict = le > (unsigned int)sb;
          __syncthreads();
          if (tid == 0) s_cnt = 0u;
          __syncthreads();
          pair_scan<4>(row, len, [&](const u64 (&x)[8],
                                     const bool (&in)[8]) {
            bool take[8];
#pragma unroll
            for (int u = 0; u < 8; ++u)
              take[u] = in[u] && (strict ? x[u] < nlo : x[u] <= nhi);
            append(x, take, buf, sb, &s_cnt);
          });
          __syncthreads();
          finish(strict ? (int)lt : (int)le, nlo);
          return;
        }
      }
    }
    __syncthreads();  // every thread has read the histogram
    lo = nlo;
    hi = nhi;
    shift = range_shift(lo, hi);
  }
}

}  // namespace

SURREAL_API int select_topk_rows(const float* vals, long long ld,
                                 const int32_t* ids, long long ids_ld,
                                 int rows, long long n, int k,
                                 float* out_vals, int32_t* out_idx,
                                 unsigned long long* scratch,
                                 long long scratch_ld, int blocks_per_row,
                                 unsigned int* work,
                                 unsigned long long* gather,
                                 long long gather_cap, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (k < 1 || (long long)k > n || n > 0x7FFFFFFFLL || ld < n)
    return (int)cudaErrorInvalidValue;
  return launch_select(vals, ld, ids, ids_ld, rows, n, k, out_vals, out_idx,
                       scratch, scratch_ld, blocks_per_row, work, gather,
                       gather_cap, static_cast<cudaStream_t>(stream));
}

SURREAL_API int select_topk_pairs(const unsigned long long* pairs,
                                  long long ld, const unsigned int* counts,
                                  int rows, int k, int sb, float* out_vals,
                                  int32_t* out_idx,
                                  unsigned long long* scratch, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (k < 1 || counts == nullptr || ld < k || ld > 0x7FFFFFFFLL ||
      (reinterpret_cast<uintptr_t>(pairs) & 7) != 0 || sb < 64 ||
      (sb & (sb - 1)) != 0 || sb < k || (sb > PBUF_SMEM && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const int smem = (sb <= PBUF_SMEM ? sb * 8 : 0) + PNB * 4;
  static SurrealSmemDone done;
  const cudaError_t err = surreal_smem_limit(select_pairs_kernel, smem, &done);
  if (err != cudaSuccess) return (int)err;
  select_pairs_kernel<<<(unsigned)rows, PT, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      pairs, ld, counts, k, sb, out_vals, out_idx, scratch);
  return (int)cudaGetLastError();
}
