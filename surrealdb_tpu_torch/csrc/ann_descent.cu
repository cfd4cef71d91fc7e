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
// Bound on the H100: bytes of the rows it gathers (E d_out rows of D
// bytes a round and query, ~1.2 MB a query at W = 64, E = 2, d_out = 32,
// iters = 24, D = 768), which are random. A round's rows depend on the
// graph lists, which depend on the round before: one block is held by
// memory latency, not bandwidth, so the design cuts the round trips a
// round to two (the graph lists, then the rows) and fits four blocks on
// an SM (a B = 512 batch in one wave):
// - the frontier is kept sorted by (dist, position) (the seed is sorted
//   once, stably, which changes no result), so step 1 is a warp's
//   ballot over it: the unexpanded entries in position order, then the
//   rest. It also names the next E unexpanded entries, whose graph lists
//   are prefetched into L2 for the next round;
// - step 3 gives four threads to each new id;
// - step 4 fetches every live row of the round at once (cp.async, a
//   warp a row and 16 bytes a lane, with the row's arow / x2q beside it)
//   into shared memory (rows of 48 KB at a time), then eight threads
//   score a row from there with __dp4a;
// - step 5 ranks the new entries among themselves (four threads each)
//   and merges them into the sorted frontier by binary search: a new
//   entry goes after every frontier entry of equal or smaller key, a
//   frontier entry after every new entry of smaller key.
// The gathers index rows by JAX's rule (an id in [-n, 0) wraps to
// id + n, the rest is clamped to [0, n)); the frontier, the duplicate
// tests and the output keep the raw ids, as the reference keeps them.
// Float operations use round-to-nearest intrinsics, never contracted, so
// the scores are the reference's bit for bit.
#include "kernels.h"

namespace {

constexpr int DTHREADS = 256;
constexpr int ROW_BUF = 48 * 1024;  // bytes of gathered rows held at once

__device__ __forceinline__ uint32_t order_key(float f) {
  if (f == 0.0f) f = 0.0f;  // -0.0 -> +0.0
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long pack(uint32_t key, int pos) {
  return ((unsigned long long)key << 32) | (unsigned int)pos;
}

__device__ __forceinline__ float warp_fmax(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `bytes` (4 or 16) global -> shared without registers
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(BYTES)
               : "memory");
}

// entries of a sorted key array at or below (upper) / below (lower) k
__device__ __forceinline__ int count_le(const uint32_t* a, int len,
                                        uint32_t k) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= k) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int count_lt(const uint32_t* a, int len,
                                        uint32_t k) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < k) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// the shared-memory layout of one block (all offsets 16-byte aligned)
struct Layout {
  int q8, rows, ids, dist, fkey, exp, n_ids, n_dist, n_key, n_sorted,
      n_rank, n_a, n_x2, n_exp, esel, bytes;
};

__host__ __device__ inline int align16(int v) { return (v + 15) & ~15; }

__host__ __device__ inline Layout layout(int d, int width, int nnew,
                                         int expand, int rb) {
  Layout l;
  int o = 0;
  l.q8 = o;
  o += align16(d);
  l.rows = o;  // also the seed's sort keys
  const int rbytes = rb * d > 8 * width ? rb * d : 8 * width;
  o += align16(rbytes);
  l.ids = o;
  o += align16(8 * width);  // two frontiers
  l.dist = o;
  o += align16(8 * width);
  l.fkey = o;
  o += align16(8 * width);
  l.exp = o;
  o += align16(2 * width);
  l.n_ids = o;
  o += align16(4 * nnew);
  l.n_dist = o;
  o += align16(4 * nnew);
  l.n_key = o;
  o += align16(8 * nnew);
  l.n_sorted = o;
  o += align16(4 * nnew);
  l.n_rank = o;
  o += align16(4 * nnew);
  l.n_a = o;
  o += align16(4 * nnew);
  l.n_x2 = o;
  o += align16(4 * nnew);
  l.n_exp = o;
  o += align16(nnew);
  l.esel = o;
  o += align16(8 * expand);  // this round's picks, then the next E
  l.bytes = o;
  return l;
}

__global__ void __launch_bounds__(DTHREADS, 4)
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
                       int euclid, int rb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nnew = expand * d_out;
  const Layout L = layout(d, width, nnew, expand, rb);
  int8_t* q8 = reinterpret_cast<int8_t*>(smem + L.q8);
  int8_t* rows = reinterpret_cast<int8_t*>(smem + L.rows);
  int32_t* ids = reinterpret_cast<int32_t*>(smem + L.ids);   // [2][W]
  float* dist = reinterpret_cast<float*>(smem + L.dist);     // [2][W]
  uint32_t* fkey = reinterpret_cast<uint32_t*>(smem + L.fkey);  // [2][W]
  uint8_t* fexp = smem + L.exp;                              // [2][W]
  int32_t* n_ids = reinterpret_cast<int32_t*>(smem + L.n_ids);
  float* n_dist = reinterpret_cast<float*>(smem + L.n_dist);
  unsigned long long* n_key =
      reinterpret_cast<unsigned long long*>(smem + L.n_key);
  uint32_t* n_sorted = reinterpret_cast<uint32_t*>(smem + L.n_sorted);
  int* n_rank = reinterpret_cast<int*>(smem + L.n_rank);
  float* n_a = reinterpret_cast<float*>(smem + L.n_a);
  float* n_x2 = reinterpret_cast<float*>(smem + L.n_x2);
  uint8_t* n_exp = smem + L.n_exp;
  int* esel = reinterpret_cast<int*>(smem + L.esel);
  __shared__ float s_inv_sq;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long q = blockIdx.x;
  const uint32_t kinf = order_key(INFINITY);

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
  // the seed, sorted stably by dist (a rank count, once)
  unsigned long long* skey = reinterpret_cast<unsigned long long*>(rows);
  for (int i = tid; i < width; i += DTHREADS)
    skey[i] = pack(order_key(init_dist[q * width + i]), i);
  __syncthreads();
  for (int i = tid; i < width; i += DTHREADS) {
    const unsigned long long ki = skey[i];
    int r = 0;
    for (int j = 0; j < width; ++j) r += skey[j] < ki;
    ids[r] = init_ids[q * width + i];
    dist[r] = init_dist[q * width + i];
    fkey[r] = (uint32_t)(ki >> 32);
    fexp[r] = 0;
  }
  __syncthreads();
  const float inv_sq = s_inv_sq;
  const int per = d >> 4;  // 16-byte pieces a row
  int cur = 0;

  for (int it = 0; it < iters; ++it) {
    const int32_t* c_ids = ids + cur * width;
    const float* c_dist = dist + cur * width;
    const uint32_t* c_key = fkey + cur * width;
    uint8_t* c_exp = fexp + cur * width;
    // 1. the E best unexpanded entries by (key, position): over the
    // sorted frontier, the unexpanded finite ones in position order, then
    // the +inf keys (expanded, or dist +inf), then NaN; 2E picks, the
    // second E the next round's likely ones
    if (warp == 0) {
      int got = 0;
      for (int grp = 0; grp < 3 && got < 2 * expand; ++grp) {
        for (int b = 0; b < width && got < 2 * expand; b += 32) {
          const int i = b + lane;
          bool m = false;
          if (i < width) {
            const uint32_t k = c_exp[i] ? kinf : c_key[i];
            m = (k < kinf ? 0 : (k == kinf ? 1 : 2)) == grp;
          }
          const unsigned int bal = __ballot_sync(0xffffffffu, m);
          const int r = got + __popc(bal & ((1u << lane) - 1u));
          if (m && r < 2 * expand) esel[r] = i;
          got += __popc(bal);
        }
      }
      for (int r = got + lane; r < 2 * expand; r += 32) esel[r] = -1;
    }
    __syncthreads();
    // 2. their neighbour lists; the next round's likely lists into L2
    for (int t = tid; t < nnew; t += DTHREADS) {
      const int e = t / d_out, j = t - e * d_out;
      const long long src = surreal_jax_row(c_ids[esel[e]], n);
      n_ids[t] = __ldg(graph + src * d_out + j);
    }
    for (int e = tid; e < expand; e += DTHREADS) {
      const int nx = esel[expand + e];
      if (nx >= 0 && !c_exp[nx]) {
        const int32_t* p = graph + surreal_jax_row(c_ids[nx], n) * d_out;
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
      }
    }
    __syncthreads();
    for (int e = tid; e < expand; e += DTHREADS) c_exp[esel[e]] = 1;
    // 3. duplicates: of a frontier id, or of an earlier neighbour (four
    // threads a new id)
    for (int t0 = 0; t0 < nnew; t0 += DTHREADS / 4) {
      const int t = t0 + (tid >> 2), s = tid & 3;
      int dup = 0;
      if (t < nnew) {
        const int id = n_ids[t];
#pragma unroll 4
        for (int j = s; j < width; j += 4) dup |= c_ids[j] == id;
#pragma unroll 4
        for (int j = s; j < t; j += 4) dup |= n_ids[j] == id;
      }
      dup |= __shfl_xor_sync(0xffffffffu, dup, 1);
      dup |= __shfl_xor_sync(0xffffffffu, dup, 2);
      if (t < nnew && s == 0) n_exp[t] = (uint8_t)dup;
    }
    __syncthreads();
    // 4. the live rows, rb at a time: every piece in flight at once (a
    // warp a row, 16 bytes a lane), then eight threads a row
    for (int c0 = 0; c0 < nnew; c0 += rb) {
      const int cn = nnew - c0 < rb ? nnew - c0 : rb;
      for (int r = warp; r < cn; r += DTHREADS / 32) {
        if (n_exp[c0 + r]) continue;  // uniform over the warp
        const long long id = surreal_jax_row(n_ids[c0 + r], n);
        const int8_t* src = x8 + id * d;
        int8_t* dst = rows + r * d;
        for (int k = lane; k < per; k += 32)
          cp_async<16>(dst + 16 * k, src + 16 * k);
        if (lane == 0) cp_async<4>(n_a + c0 + r, arow + id);
        if (lane == 1 && euclid) cp_async<4>(n_x2 + c0 + r, x2q + id);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      for (int r0 = 0; r0 < cn; r0 += DTHREADS / 8) {
        const int r = r0 + (tid >> 3), s = tid & 7;
        const bool live = r < cn && !n_exp[c0 + r];
        int acc = 0;
        if (live) {
          const int4* row = reinterpret_cast<const int4*>(rows + r * d);
          const int4* qq = reinterpret_cast<const int4*>(q8);
          for (int k = s; k < per; k += 8) {
            const int4 a = row[k];
            const int4 v = qq[k];
            acc = __dp4a(a.x, v.x, acc);
            acc = __dp4a(a.y, v.y, acc);
            acc = __dp4a(a.z, v.z, acc);
            acc = __dp4a(a.w, v.w, acc);
          }
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 4);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        if (s == 0 && r < cn) {
          const int t = c0 + r;
          float dv = INFINITY;
          if (live) {
            const float dots =
                __fmul_rn(__int2float_rn(acc), __fmul_rn(n_a[t], inv_sq));
            dv = euclid ? __fsub_rn(n_x2[t], __fmul_rn(2.0f, dots)) : -dots;
          }
          n_dist[t] = dv;
          n_key[t] = pack(order_key(dv), width + t);
        }
      }
      __syncthreads();  // the rows are read: the next chunk's land
    }
    // 5. the new entries' ranks among themselves (four threads each)
    for (int t0 = 0; t0 < nnew; t0 += DTHREADS / 4) {
      const int t = t0 + (tid >> 2), s = tid & 3;
      int r = 0;
      unsigned long long k = 0;
      if (t < nnew) {
        k = n_key[t];
#pragma unroll 4
        for (int u = s; u < nnew; u += 4) r += n_key[u] < k;
      }
      r += __shfl_xor_sync(0xffffffffu, r, 1);
      r += __shfl_xor_sync(0xffffffffu, r, 2);
      if (t < nnew && s == 0) {
        n_rank[t] = r;
        n_sorted[r] = (uint32_t)(k >> 32);
      }
    }
    __syncthreads();
    // ... merged into the sorted frontier: the best W by (dist, position)
    const int nxt = cur ^ 1;
    int32_t* o_ids = ids + nxt * width;
    float* o_dist = dist + nxt * width;
    uint32_t* o_key = fkey + nxt * width;
    uint8_t* o_exp = fexp + nxt * width;
    for (int i = tid; i < width + nnew; i += DTHREADS) {
      if (i < width) {
        const int pos = i + count_lt(n_sorted, nnew, c_key[i]);
        if (pos < width) {
          o_ids[pos] = c_ids[i];
          o_dist[pos] = c_dist[i];
          o_key[pos] = c_key[i];
          o_exp[pos] = c_exp[i];
        }
      } else {
        const int t = i - width;
        const uint32_t k = (uint32_t)(n_key[t] >> 32);
        const int pos = n_rank[t] + count_le(c_key, width, k);
        if (pos < width) {
          o_ids[pos] = n_ids[t];
          o_dist[pos] = n_dist[t];
          o_key[pos] = k;
          o_exp[pos] = n_exp[t];
        }
      }
    }
    __syncthreads();
    cur = nxt;
  }
  // the frontier is sorted by (dist, position): its first kc entries
  for (int i = tid; i < kc; i += DTHREADS) {
    out_ids[q * kc + i] = ids[cur * width + i];
    out_dist[q * kc + i] = dist[cur * width + i];
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
      (euclid && x2q == nullptr) ||
      (long long)expand * d_out > 65536 || width > 65536)
    return (int)cudaErrorInvalidValue;
  const int nnew = expand * d_out;
  int rb = ROW_BUF / d;
  if (rb > nnew) rb = nnew;
  if (rb < 1) rb = 1;
  const Layout L = layout(d, width, nnew, expand, rb);
  if (L.bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  static SurrealSmemDone smem_done;
  const cudaError_t attr =
      surreal_smem_limit(ann_descent_kernel, L.bytes, &smem_done);
  if (attr != cudaSuccess) return (int)attr;
  ann_descent_kernel<<<(unsigned)b, DTHREADS, (size_t)L.bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      graph, x8, arow, x2q, qs, init_ids, init_dist, out_ids, out_dist, n,
      d_out, d, width, expand, iters, kc, euclid, rb);
  return (int)cudaGetLastError();
}
