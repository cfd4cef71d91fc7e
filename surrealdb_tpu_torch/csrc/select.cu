// select_topk_rows: exact per-row k smallest, in ascending (value, index)
// order, so ties go to the lower index as jax.lax.top_k breaks them.
//
// Replaces surrealdb_tpu/ops/topk.py:13 top_k_smallest (lax.top_k), and
// the approx_max_k candidate stage of ops/topk.py:78 knn_rank_rescore
// and :145 knn_rank_int8, whose TPU PartialReduce has no CUDA
// counterpart: selecting the candidates exactly gives the reference's
// answer wherever the approximate stage was exact. It also serves the
// running merge of knn_search_blocked (selection over [best, block] with
// an id map).
//
// Design: one block per row, over order-preserving uint32 keys (-0.0
// and +0.0 share a key, as they compare equal). Every pass streams the
// row as float4 pairs where it is 16-byte aligned (32 bytes in flight a
// thread), else scalar. Pass 1 builds a 2048-bin shared-memory histogram
// of the top 11 key bits and finds the bin that holds the k-th smallest.
// When every key in that bin and below fits the 8192-entry shared buffer
// (the usual case for KNN scores: k is small and the smallest values sit
// in a sparse tail), pass 2 gathers those (key, index) pairs and a
// bitonic sort of them orders the answer: two reads of the row.
// Otherwise two more radix digits (11 and 10 bits) find the key T of the
// k-th smallest and how many keys equal it; when the keys <= T fit the
// buffer, one more read gathers them (in any order: the sort by (key,
// index) puts the lowest-index ties first): five reads. Only when ties
// at T overflow it does a compaction pass in index order (warp ballots +
// a block prefix over warp counts, two barriers per 1024 keys) take
// every key < T and the lowest-index keys == T.
//
// Large k (k > SURREAL_SELECT_MAX_K, e.g. the int8 store's kc = 128 k
// candidates for k >= 33): the (key, index) buffer is a per-row slice of
// device memory that the wrapper allocates ([rows, m] u64, m the power
// of two >= k); the radix passes, gathers and the sort run there.
//
// Bound on the H100: bytes, one read of the [rows, n] f32 input; this
// design reads it two to five times. A row is one block: few rows over
// many keys (16 x 10M at the int8 store's chunk) use 16 of 132 SMs.
#include "kernels.h"

namespace {

constexpr int TOP_BITS = 11;               // first radix digit
constexpr int NBINS = 1 << TOP_BITS;       // 2048 histogram bins
constexpr int TOP_SHIFT = 32 - TOP_BITS;   // 21
constexpr int CAP = 8192;                  // shared (key, index) buffer
constexpr int SMEM_BYTES = CAP * 8 + NBINS * 4;

__device__ __forceinline__ uint32_t order_key(float f) {
  if (f == 0.0f) f = 0.0f;  // -0.0 -> +0.0
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// bitonic sort of sbuf[0:m] ascending (m a power of two); sbuf lies in
// shared memory, or in device memory for k > CAP (__syncthreads orders
// the block's global accesses as well)
__device__ __forceinline__ void bitonic_sort(unsigned long long* sbuf,
                                             int m) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  for (int size = 2; size <= m; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < m; i += nthreads) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long a = sbuf[i], b = sbuf[j];
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

// thread 0: the bin of hist[0:nbins] holding the need-th key (1-based);
// writes the bin and how many keys precede it
__device__ __forceinline__ void find_bin(const unsigned int* hist,
                                         int nbins, unsigned int need,
                                         unsigned int* s_bin,
                                         unsigned int* s_before) {
  unsigned int cum = 0;
  int bin = 0;
  for (; bin < nbins - 1; ++bin) {
    if (cum + hist[bin] >= need) break;
    cum += hist[bin];
  }
  *s_bin = (unsigned int)bin;
  *s_before = cum;
}

// f(index, value, in) over row v[0:n], in no particular index order
// (every thread calls f the same number of times; `in` is false past
// the row): float4 pairs where v is 16-byte aligned, then a scalar tail
template <typename F>
__device__ __forceinline__ void for_each_value(const float* v, long long n,
                                               F f) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  long long done = 0;
  if ((reinterpret_cast<uintptr_t>(v) & 15) == 0) {
    const float4* v4 = reinterpret_cast<const float4*>(v);
    const long long n4 = n >> 2;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (long long base = 0; base < n4; base += 2LL * nthreads) {
      const long long j0 = base + tid, j1 = j0 + nthreads;
      const bool p0 = j0 < n4, p1 = j1 < n4;
      const float4 a = p0 ? v4[j0] : z;
      const float4 b = p1 ? v4[j1] : z;
      f(4 * j0, a.x, p0);
      f(4 * j0 + 1, a.y, p0);
      f(4 * j0 + 2, a.z, p0);
      f(4 * j0 + 3, a.w, p0);
      f(4 * j1, b.x, p1);
      f(4 * j1 + 1, b.y, p1);
      f(4 * j1 + 2, b.z, p1);
      f(4 * j1 + 3, b.w, p1);
    }
    done = n4 * 4;
  }
  for (long long start = done; start < n; start += nthreads) {
    const long long i = start + tid;
    const bool p = i < n;
    f(i, p ? v[i] : 0.f, p);
  }
}

// the first k sorted pairs -> values and (mapped) indices
__device__ __forceinline__ void write_out(
    const float* v, const unsigned long long* sbuf, const int32_t* ids,
    long long ids_ld, long long row, int k, float* out_vals,
    int32_t* out_idx) {
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const uint32_t idx = (uint32_t)(sbuf[i] & 0xFFFFFFFFull);
    out_vals[row * k + i] = v[idx];
    out_idx[row * k + i] =
        ids != nullptr ? ids[row * ids_ld + idx] : (int32_t)idx;
  }
}

// LARGE: k > SURREAL_SELECT_MAX_K, the (key, index) buffer is this
// row's slice of the device scratch instead of shared memory
template <bool LARGE>
__global__ void __launch_bounds__(1024)
    select_topk_kernel(const float* __restrict__ vals, long long ld,
                       const int32_t* __restrict__ ids, long long ids_ld,
                       long long n, int k, float* __restrict__ out_vals,
                       int32_t* __restrict__ out_idx,
                       unsigned long long* __restrict__ scratch,
                       long long scratch_ld) {
  extern __shared__ __align__(16) unsigned long long smem[];
  unsigned long long* s_pairs = smem;                    // (key << 32 | i)
  unsigned int* hist = reinterpret_cast<unsigned int*>(smem + CAP);
  __shared__ unsigned int s_bin, s_before, s_count, s_eq;
  __shared__ unsigned int warp_less[32], warp_eq[32];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5;
  const long long row = blockIdx.x;
  const float* v = vals + row * ld;
  unsigned long long* sbuf = LARGE ? scratch + row * scratch_ld : s_pairs;
  const long long cap = LARGE ? scratch_ld : CAP;

  // pass 1: histogram of the top 11 key bits over the whole row
  for (int i = tid; i < NBINS; i += nthreads) hist[i] = 0u;
  __syncthreads();
  for_each_value(v, n, [&](long long, float x, bool in) {
    if (in) atomicAdd(&hist[order_key(x) >> TOP_SHIFT], 1u);
  });
  __syncthreads();
  if (tid == 0) {
    find_bin(hist, NBINS, (unsigned int)k, &s_bin, &s_before);
    s_count = 0u;
  }
  __syncthreads();
  const unsigned int top = s_bin;
  const unsigned int total = s_before + hist[top];  // keys in bins <= top

  int m = 1;
  if (!LARGE && total <= (unsigned int)CAP) {
    // fast path: every key in bins <= top fits the buffer. One more read
    // gathers them (in any order) and a sort by (key, index) finishes
    // the selection exactly.
    for_each_value(v, n, [&](long long i, float x, bool in) {
      if (!in) return;
      const uint32_t key = order_key(x);
      if ((key >> TOP_SHIFT) <= top) {
        const unsigned int pos = atomicAdd(&s_count, 1u);
        sbuf[pos] = ((unsigned long long)key << 32) |
                    (unsigned long long)(uint32_t)i;
      }
    });
    while (m < (int)total) m <<= 1;
    __syncthreads();
    for (int i = (int)total + tid; i < m; i += nthreads) sbuf[i] = ~0ull;
    __syncthreads();
  } else {
    // general path: two more radix digits (11 and 10 bits) over the
    // whole row find the key T of the k-th smallest and the count of
    // keys equal to it
    unsigned int prefix = top << TOP_SHIFT;
    unsigned int need = (unsigned int)k - s_before;
    const int widths[2] = {11, 10};
    int shift = TOP_SHIFT;
    for (int pass = 0; pass < 2; ++pass) {
      const unsigned int hi = 0xFFFFFFFFu << shift;
      shift -= widths[pass];
      const int nb = 1 << widths[pass];
      __syncthreads();
      for (int i = tid; i < nb; i += nthreads) hist[i] = 0u;
      __syncthreads();
      for_each_value(v, n, [&](long long, float x, bool in) {
        const uint32_t key = order_key(x);
        if (in && (key & hi) == prefix)
          atomicAdd(&hist[(key >> shift) & (unsigned int)(nb - 1)], 1u);
      });
      __syncthreads();
      if (tid == 0) {
        find_bin(hist, nb, need, &s_bin, &s_before);
        s_eq = hist[s_bin];  // after the last digit: the keys == T
      }
      __syncthreads();
      prefix |= s_bin << shift;
      need -= s_before;
    }
    const unsigned int thr = prefix;
    const unsigned int n_eq = need;                     // taken == thr
    const unsigned int n_less = (unsigned int)k - need;  // all keys < thr
    const unsigned int n_le = n_less + s_eq;            // all keys <= thr
    if ((long long)n_le <= cap) {
      // the keys <= T fit: gather them in any order; the sort puts the
      // lowest-index keys == T first
      if (tid == 0) s_count = 0u;
      __syncthreads();
      for_each_value(v, n, [&](long long i, float x, bool in) {
        if (!in) return;
        const uint32_t key = order_key(x);
        if (key <= thr) {
          const unsigned int pos = atomicAdd(&s_count, 1u);
          sbuf[pos] = ((unsigned long long)key << 32) |
                      (unsigned long long)(uint32_t)i;
        }
      });
      while (m < (int)n_le) m <<= 1;
      __syncthreads();
      for (int i = (int)n_le + tid; i < m; i += nthreads) sbuf[i] = ~0ull;
      __syncthreads();
      bitonic_sort(sbuf, m);
      write_out(v, sbuf, ids, ids_ld, row, k, out_vals, out_idx);
      return;
    }
    // ties at T overflow the buffer: a compaction in index order takes
    // every key < T and the lowest-index keys == T
    const int lane = tid & 31;
    const int nwarps = nthreads >> 5;
    const unsigned int lt_mask = (1u << lane) - 1u;
    unsigned int base_less = 0, base_eq = 0;
    for (long long start = 0; start < n; start += nthreads) {
      const long long i = start + tid;
      const bool in = i < n;
      const uint32_t key = in ? order_key(v[i]) : 0xFFFFFFFFu;
      const bool is_less = in && key < thr;
      const bool is_eq = in && key == thr;
      const unsigned int lm = __ballot_sync(0xFFFFFFFFu, is_less);
      const unsigned int em = __ballot_sync(0xFFFFFFFFu, is_eq);
      if (lane == 0) {
        warp_less[warp] = __popc(lm);
        warp_eq[warp] = __popc(em);
      }
      __syncthreads();
      unsigned int off_less = 0, off_eq = 0, tot_less = 0, tot_eq = 0;
      for (int w = 0; w < nwarps; ++w) {
        const unsigned int cl = warp_less[w], ce = warp_eq[w];
        if (w < warp) {
          off_less += cl;
          off_eq += ce;
        }
        tot_less += cl;
        tot_eq += ce;
      }
      const unsigned long long packed =
          ((unsigned long long)key << 32) | (unsigned long long)(uint32_t)i;
      if (is_less) {
        sbuf[base_less + off_less + __popc(lm & lt_mask)] = packed;
      }
      if (is_eq) {
        const unsigned int pos = base_eq + off_eq + __popc(em & lt_mask);
        if (pos < n_eq) sbuf[n_less + pos] = packed;
      }
      base_less += tot_less;
      base_eq += tot_eq;
      __syncthreads();  // warp counts are rewritten next round
      if (base_less >= n_less && base_eq >= n_eq) break;
    }
    while (m < k) m <<= 1;
    for (int i = k + tid; i < m; i += nthreads) sbuf[i] = ~0ull;
    __syncthreads();
  }
  bitonic_sort(sbuf, m);
  write_out(v, sbuf, ids, ids_ld, row, k, out_vals, out_idx);
}

}  // namespace

SURREAL_API int select_topk_rows(const float* vals, long long ld,
                                 const int32_t* ids, long long ids_ld,
                                 int rows, long long n, int k,
                                 float* out_vals, int32_t* out_idx,
                                 unsigned long long* scratch,
                                 long long scratch_ld, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (k < 1 || (long long)k > n || n > 0x7FFFFFFFLL || ld < n)
    return (int)cudaErrorInvalidValue;
  const bool large = k > SURREAL_SELECT_MAX_K;
  if (large) {
    long long m = 1;
    while (m < k) m <<= 1;
    if (scratch == nullptr || scratch_ld < m)
      return (int)cudaErrorInvalidValue;
  }
  long long t = ((n + 31) / 32) * 32;
  if (t < 64) t = 64;
  if (t > 1024) t = 1024;
  auto kernel = large ? select_topk_kernel<true> : select_topk_kernel<false>;
  static SurrealSmemDone smem_done[2];
  const cudaError_t attr =
      surreal_smem_limit(kernel, SMEM_BYTES, &smem_done[large ? 1 : 0]);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<(unsigned)rows, (unsigned)t, SMEM_BYTES,
           static_cast<cudaStream_t>(stream)>>>(
      vals, ld, ids, ids_ld, n, k, out_vals, out_idx, scratch, scratch_ld);
  return (int)cudaGetLastError();
}
