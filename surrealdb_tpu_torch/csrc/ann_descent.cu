// ann_descent: the fixed-iteration greedy graph descent of the CAGRA-style
// ANN store, one query per block, the whole loop in one launch.
//
// Replaces the loop of surrealdb_tpu/device/annstore.py:29
// _descent_scored (and :102 _descent_impl, which drops the scores): from
// a seeded frontier of W (id, dist) pairs, `iters` rounds of
//   1. take the E best unexpanded entries by (key, position), key = +inf
//      where expanded (lax.top_k(-key, E): when fewer than E are
//      unexpanded the +inf entries follow, lowest position first), and
//      mark them expanded;
//   2. gather their E * d_out graph rows (e-major, best first);
//   3. mark each neighbour equal to a frontier id, or to an earlier
//      neighbour of the same list (the reference's tril(k=-1) rule):
//      dist = +inf, expanded = true;
//   4. score the others against the int8 store with the query quantised
//      as the probe quantised it: x2q - 2 dots * (arow * inv_sq), or
//      -dots * (arow * inv_sq), dots the exact int32 product;
//   5. keep the best W of [frontier || new] by (dist, position): a
//      stable merge like lax.top_k, so the frontier stays sorted;
// then the first kc entries (ids and dists). The seed (the probe's
// scores through rank_scores_int8 and its top W through
// select_topk_rows) comes from the wrapper.
//
// Design: the frontier (ids, dists, expanded flags), the E * d_out new
// entries, the packed (key, position) merge keys and the quantised
// query live in shared memory (a few KB). Steps 1 and 5 rank every
// entry by counting the entries below it (W or W + E d_out threads, no
// sort network: exact and branch-free at these sizes); step 3 compares
// each new id against the frontier and its predecessors; step 4 gives
// one warp to a row: 16-byte loads, __dp4a, a warp sum of int32. Row
// ids are clamped to [0, n) for the gathers, as the reference's gathers
// clamp. Float operations use round-to-nearest intrinsics, never
// contracted, so the scores are the reference's bit for bit.
// Bound on the H100: bytes of the rows it gathers (E d_out rows of D
// bytes a round and query, ~1.2 MB a query at W = 64, E = 2, d_out = 32,
// iters = 24, D = 768), which are random: latency, not bandwidth,
// limits one block, so the batch (B blocks) must fill the card.
#include "kernels.h"

namespace {

constexpr int DTHREADS = 256;

__device__ __forceinline__ uint32_t order_key(float f) {
  if (f == 0.0f) f = 0.0f;  // -0.0 -> +0.0
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long pack(float v, int pos) {
  return ((unsigned long long)order_key(v) << 32) | (unsigned int)pos;
}

__device__ __forceinline__ int warp_isum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_fmax(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(DTHREADS)
    ann_descent_kernel(const int32_t* __restrict__ graph,
                       const int8_t* __restrict__ x8,
                       const float* __restrict__ arow,
                       const float* __restrict__ x2q,
                       const float* __restrict__ qs,
                       const int32_t* __restrict__ init_ids,
                       const float* __restrict__ init_dist,
                       int32_t* __restrict__ out_ids,
                       float* __restrict__ out_dist, long long n, int d_out,
                       int d, int width, int expand, int iters, int kc,
                       int euclid) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nnew = expand * d_out;
  const int total = width + nnew;
  int8_t* q8 = reinterpret_cast<int8_t*>(smem);                   // [d]
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(smem + d);            // [total]
  int32_t* c_ids = reinterpret_cast<int32_t*>(keys + total);      // [total]
  float* c_dist = reinterpret_cast<float*>(c_ids + total);        // [total]
  int32_t* n_ids = reinterpret_cast<int32_t*>(c_dist + total);    // [width]
  float* n_dist = reinterpret_cast<float*>(n_ids + width);        // [width]
  int32_t* esel = reinterpret_cast<int32_t*>(n_dist + width);     // [expand]
  uint8_t* c_exp = reinterpret_cast<uint8_t*>(esel + expand);     // [total]
  uint8_t* n_exp = c_exp + total;                                 // [width]
  __shared__ float s_inv_sq;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = DTHREADS >> 5;
  const long long q = blockIdx.x;

  // the probe's quantisation of this query: sq = 127 / max(|q|, 1e-30)
  if (warp == 0) {
    const float* qr = qs + q * d;
    float m = 0.f;
    for (int i = lane; i < d; i += 32) m = fmaxf(m, fabsf(qr[i]));
    m = warp_fmax(m);
    const float sq = __fdiv_rn(127.0f, fmaxf(m, 1e-30f));
    for (int i = lane; i < d; i += 32)
      q8[i] = (int8_t)__float2int_rn(__fmul_rn(qr[i], sq));
    if (lane == 0) s_inv_sq = __fdiv_rn(1.0f, sq);
  }
  for (int i = tid; i < width; i += DTHREADS) {
    c_ids[i] = init_ids[q * width + i];
    c_dist[i] = init_dist[q * width + i];
    c_exp[i] = 0;
  }
  __syncthreads();
  const float inv_sq = s_inv_sq;

  for (int it = 0; it < iters; ++it) {
    // 1. the E best unexpanded entries, by (key, position)
    for (int i = tid; i < width; i += DTHREADS)
      keys[i] = pack(c_exp[i] ? INFINITY : c_dist[i], i);
    __syncthreads();
    for (int i = tid; i < width; i += DTHREADS) {
      const unsigned long long ki = keys[i];
      int rank = 0;
      for (int j = 0; j < width; ++j) rank += keys[j] < ki;
      if (rank < expand) esel[rank] = i;
    }
    __syncthreads();
    // 2. gather their neighbour lists (the marks land after the reads)
    for (int t = tid; t < nnew; t += DTHREADS) {
      const int e = t / d_out, j = t - e * d_out;
      long long src = c_ids[esel[e]];
      src = src < 0 ? 0 : (src >= n ? n - 1 : src);
      c_ids[width + t] = graph[src * d_out + j];
    }
    __syncthreads();
    if (tid < expand) c_exp[esel[tid]] = 1;
    // 3. duplicates: of a frontier id, or of an earlier neighbour
    for (int t = tid; t < nnew; t += DTHREADS) {
      const int id = c_ids[width + t];
      bool dup = false;
      for (int j = 0; j < width && !dup; ++j) dup = c_ids[j] == id;
      for (int j = 0; j < t && !dup; ++j) dup = c_ids[width + j] == id;
      c_exp[width + t] = dup ? 1 : 0;
      c_dist[width + t] = INFINITY;
    }
    __syncthreads();
    // 4. int8 scores of the rest, one warp a row
    for (int t = warp; t < nnew; t += nwarps) {
      if (c_exp[width + t]) continue;  // uniform per warp
      long long id = c_ids[width + t];
      id = id < 0 ? 0 : (id >= n ? n - 1 : id);
      const int4* row = reinterpret_cast<const int4*>(x8 + id * d);
      const int4* qq = reinterpret_cast<const int4*>(q8);
      int acc = 0;
      for (int c = lane; c < (d >> 4); c += 32) {
        const int4 r = row[c];
        const int4 v = qq[c];
        acc = __dp4a(r.x, v.x, acc);
        acc = __dp4a(r.y, v.y, acc);
        acc = __dp4a(r.z, v.z, acc);
        acc = __dp4a(r.w, v.w, acc);
      }
      acc = warp_isum(acc);
      if (lane == 0) {
        const float dots =
            __fmul_rn(__int2float_rn(acc), __fmul_rn(arow[id], inv_sq));
        c_dist[width + t] =
            euclid ? __fsub_rn(x2q[id], __fmul_rn(2.0f, dots)) : -dots;
      }
    }
    __syncthreads();
    // 5. the best W of [frontier || new] by (dist, position)
    for (int i = tid; i < total; i += DTHREADS) keys[i] = pack(c_dist[i], i);
    __syncthreads();
    for (int i = tid; i < total; i += DTHREADS) {
      const unsigned long long ki = keys[i];
      int rank = 0;
      for (int j = 0; j < total; ++j) rank += keys[j] < ki;
      if (rank < width) {
        n_ids[rank] = c_ids[i];
        n_dist[rank] = c_dist[i];
        n_exp[rank] = c_exp[i];
      }
    }
    __syncthreads();
    for (int i = tid; i < width; i += DTHREADS) {
      c_ids[i] = n_ids[i];
      c_dist[i] = n_dist[i];
      c_exp[i] = n_exp[i];
    }
    __syncthreads();
  }
  // the frontier is sorted by (dist, position): its first kc entries
  for (int i = tid; i < kc; i += DTHREADS) {
    out_ids[q * kc + i] = c_ids[i];
    out_dist[q * kc + i] = c_dist[i];
  }
}

}  // namespace

SURREAL_API int ann_descent(const int32_t* graph, const int8_t* x8,
                            const float* arow, const float* x2q,
                            const float* qs, const int32_t* init_ids,
                            const float* init_dist, int32_t* out_ids,
                            float* out_dist, long long n, int d_out, int d,
                            int b, int width, int expand, int iters, int kc,
                            int euclid, void* stream) {
  if (b <= 0) return (int)cudaSuccess;
  if (n <= 0 || d_out <= 0 || d <= 0 || d % 16 != 0 || width <= 0 ||
      expand <= 0 || expand > width || iters < 0 || kc <= 0 || kc > width ||
      (euclid && x2q == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)width + (long long)expand * d_out;
  // q8, keys, ids/dists (+ the merged copy), esel, expanded flags
  const long long smem = d + 8 * total + 8 * total + 8LL * width +
                         4LL * expand + total + width + 16;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  static SurrealSmemDone smem_done;
  const cudaError_t attr =
      surreal_smem_limit(ann_descent_kernel, (int)smem, &smem_done);
  if (attr != cudaSuccess) return (int)attr;
  ann_descent_kernel<<<(unsigned)b, DTHREADS, (size_t)smem,
                       static_cast<cudaStream_t>(stream)>>>(
      graph, x8, arow, x2q, qs, init_ids, init_dist, out_ids, out_dist, n,
      d_out, d, width, expand, iters, kc, euclid);
  return (int)cudaGetLastError();
}
