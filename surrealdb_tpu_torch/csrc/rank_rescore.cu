// The two kernels of the bf16 rank + f32 rescore KNN store.
//
// Replaces surrealdb_tpu/ops/topk.py:78 knn_rank_rescore, which per query
// chunk (1) ranks the whole store with one bf16 einsum (f32
// accumulation), scoring |x|^2 - 2 x.q (euclidean) or -x.q (cosine on
// pre-normalised rows, dot), masked to +inf; (2) keeps kc candidates
// with approx_max_k; (3) gathers their f32 rows and rescores them
// exactly; (4) takes the exact top k. Here (1) is rank_scores_bf16, (2)
// and (4) are select_topk_rows (select.cu) and (3) is gather_rescore.
//
// rank_scores_bf16 -- a tiled bf16 x bf16 -> f32 product on the tensor
// cores through the WMMA interface (mma.sync m16n8k16 underneath). A
// 256-thread block computes a 128-query x 128-row score tile; each of
// its 8 warps owns a 64 x 32 sub-tile (4 x 2 fragments). Tiles of 32
// dimensions stream into a 3-stage shared-memory ring with cp.async
// (16 bytes a thread, zero-filled past the edges), so the copy of step
// t+2 overlaps the products of step t. The wrapper rounds the queries
// to bf16 first (the reference's qs.astype(bfloat16)); the store width
// must be a multiple of 8 (the vector store pads its bf16 rows with
// zero columns). The score epilogue (|x|^2 - 2 dot, or -dot) and the
// validity mask are fused into the store of the [C, N] score matrix.
// Blocks walk the query tiles fastest, so the tiles of one query chunk
// that read the same store rows run together and those rows come from
// L2 after the first read.
// Bound on the H100: at C = 512, N = 1M, D = 768 the product is
// 2*C*N*D = 0.81 TFLOP (0.81 ms at 989 TFLOP/s bf16) and the bytes are
// the 1.5 GB bf16 store read plus the 2.1 GB f32 score write (1.1 ms at
// 3.35 TB/s), so bytes bound it; mma.sync without wgmma/TMA reaches
// only part of the tensor-core rate.
//
// gather_rescore -- one block per query; the query sits in shared
// memory, each warp takes candidates in turn, reads the candidate's f32
// row (coalesced) and reduces. Euclidean uses the direct form
// sqrt(sum (r - q)^2) as the reference's rescore does, cosine
// 1 - r.q / max(norm_r * max(|q|, 1e-30), 1e-30), dot -r.q; a masked
// candidate scores +inf. Bound: the C*kc*D*4 bytes of gathered rows.
#include "kernels.h"

#include <cuda_bf16.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int RM = 128;        // queries per tile
constexpr int RN = 128;        // store rows per tile
constexpr int RK = 32;         // dimensions per step
constexpr int STAGES = 3;      // cp.async ring depth
constexpr int RLD = RK + 8;    // staged row pitch (bf16), a multiple of 8
constexpr int CLD = RN + 4;    // score tile pitch (f32), a multiple of 4
constexpr int RTHREADS = 256;  // 8 warps: 2 (queries) x 4 (rows)
constexpr int STAGE_ELEMS = (RM + RN) * RLD;
constexpr int RING_BYTES = STAGES * STAGE_ELEMS * 2;
constexpr int SCORE_BYTES = RM * CLD * 4;
constexpr int SMEM_BYTES = RING_BYTES > SCORE_BYTES ? RING_BYTES : SCORE_BYTES;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned int s =
      static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;  // 0 = zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// two blocks an SM: caps the kernel at 128 registers a thread
__global__ void __launch_bounds__(RTHREADS, 2)
    rank_scores_kernel(const __nv_bfloat16* __restrict__ xs,
                       const __nv_bfloat16* __restrict__ qb,
                       const float* __restrict__ x2,
                       const uint8_t* __restrict__ valid,
                       float* __restrict__ out, long long n, int c, int d,
                       int euclid, int mtiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the k loop

  const long long bid = blockIdx.x;
  const int m0 = (int)(bid % mtiles) * RM;
  const long long n0 = (bid / mtiles) * RN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // 0..1: 64 query rows each
  const int wn = warp & 3;   // 0..3: 32 store rows each
  const int ktiles = (d + RK - 1) / RK;

  // stage one 32-wide step: 128 query rows and 128 store rows, four
  // 16-byte chunks each
  auto load_stage = [&](int slot, int kt) {
    __nv_bfloat16* As = ring + slot * STAGE_ELEMS;
    __nv_bfloat16* Bs = As + RM * RLD;
    const int k0 = kt * RK;
    for (int i = tid; i < RM * (RK / 8); i += RTHREADS) {
      const int r = i / (RK / 8), seg = i % (RK / 8);
      const int gq = m0 + r, gk = k0 + seg * 8;
      const bool p = gq < c && gk < d;
      cp_async16(As + r * RLD + seg * 8,
                 p ? qb + (long long)gq * d + gk : qb, p);
    }
    for (int i = tid; i < RN * (RK / 8); i += RTHREADS) {
      const int r = i / (RK / 8), seg = i % (RK / 8);
      const long long gr = n0 + r;
      const int gk = k0 + seg * 8;
      const bool p = gr < n && gk < d;
      cp_async16(Bs + r * RLD + seg * 8, p ? xs + gr * d + gk : xs, p);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // step kt has landed
    __syncthreads();              // ...for every thread; slot kt-1 is free
    const int nk = kt + STAGES - 1;
    if (nk < ktiles) load_stage(nk % STAGES, nk);
    cp_async_commit();
    const __nv_bfloat16* As = ring + (kt % STAGES) * STAGE_ELEMS;
    const __nv_bfloat16* Bs = As + RM * RLD;
#pragma unroll
    for (int kk = 0; kk < RK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> b[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + (wn * 32 + j * 16) * RLD + kk, RLD);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // fragments past the last query (a small batch) do no work:
        // the condition is uniform over the warp, as WMMA requires
        if (m0 + wm * 64 + i * 16 >= c) continue;
        wmma::load_matrix_sync(a[i], As + (wm * 64 + i * 16) * RLD + kk, RLD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 64 + i * 16) * CLD + wn * 32 + j * 16,
                              acc[i][j], CLD, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < RM * RN; i += RTHREADS) {
    const int r = i / RN, col = i % RN;
    const int gq = m0 + r;
    const long long gn = n0 + col;
    if (gq < c && gn < n) {
      const float dot = Cs[r * CLD + col];
      float s = euclid ? (x2[gn] - 2.f * dot) : -dot;
      if (valid != nullptr && valid[gn] == 0) s = INFINITY;
      out[(long long)gq * n + gn] = s;
    }
  }
}

__global__ void gather_rescore_kernel(const float* __restrict__ xs,
                                      const float* __restrict__ qs,
                                      const int32_t* __restrict__ cand,
                                      const float* __restrict__ norms,
                                      const uint8_t* __restrict__ valid,
                                      float* __restrict__ out, long long n,
                                      int kc, int d, int metric) {
  extern __shared__ float sq[];  // the query row, d floats
  __shared__ float s_qn;
  const long long row = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const float* q = qs + row * d;
  for (int i = tid; i < d; i += blockDim.x) sq[i] = q[i];
  __syncthreads();
  if (warp == 0) {
    float s = 0.f;
    for (int i = lane; i < d; i += 32) s += sq[i] * sq[i];
    s = surreal_warp_sum(s);
    if (lane == 0) s_qn = fmaxf(sqrtf(s), 1e-30f);
  }
  __syncthreads();
  for (int j = warp; j < kc; j += nwarps) {
    const int ci = cand[row * kc + j];
    float dist = INFINITY;
    if (ci >= 0 && (long long)ci < n) {
      const float* r = xs + (long long)ci * d;
      float acc = 0.f;
      if (metric == M_EUCLIDEAN) {
        for (int i = lane; i < d; i += 32) {
          const float df = r[i] - sq[i];
          acc = fmaf(df, df, acc);
        }
      } else {
        for (int i = lane; i < d; i += 32) acc = fmaf(r[i], sq[i], acc);
      }
      acc = surreal_warp_sum(acc);
      if (metric == M_EUCLIDEAN) {
        dist = sqrtf(fmaxf(acc, 0.f));
      } else if (metric == M_COSINE) {
        dist = 1.f - acc / fmaxf(norms[ci] * s_qn, 1e-30f);
      } else {
        dist = -acc;
      }
      if (valid != nullptr && valid[ci] == 0) dist = INFINITY;
    }
    if (lane == 0) out[row * kc + j] = dist;
  }
}

}  // namespace

SURREAL_API int rank_scores_bf16(const void* xs_rank, const void* qs_bf16,
                                 const float* x2, const uint8_t* valid,
                                 float* out, long long n, int c, int d,
                                 int euclid, void* stream) {
  if (n <= 0 || c <= 0) return (int)cudaSuccess;
  if (d <= 0 || d % 8 != 0 || (euclid && x2 == nullptr))
    return (int)cudaErrorInvalidValue;
  const int mtiles = (c + RM - 1) / RM;
  const long long blocks = (long long)mtiles * ((n + RN - 1) / RN);
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  static SurrealSmemDone smem_done;
  const cudaError_t attr =
      surreal_smem_limit(rank_scores_kernel, SMEM_BYTES, &smem_done);
  if (attr != cudaSuccess) return (int)attr;
  rank_scores_kernel<<<(unsigned)blocks, RTHREADS, SMEM_BYTES,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(xs_rank),
      static_cast<const __nv_bfloat16*>(qs_bf16), x2, valid, out, n, c, d,
      euclid, mtiles);
  return (int)cudaGetLastError();
}

SURREAL_API int gather_rescore(const float* xs_full, const float* qs,
                               const int32_t* cand, const float* norms,
                               const uint8_t* valid, float* out,
                               long long n, int c, int kc, int d,
                               int metric, void* stream) {
  if (c <= 0 || kc <= 0) return (int)cudaSuccess;
  if (d <= 0 || d > 12288 ||
      (metric != M_EUCLIDEAN && metric != M_COSINE && metric != M_DOT) ||
      (metric == M_COSINE && norms == nullptr))
    return (int)cudaErrorInvalidValue;
  gather_rescore_kernel<<<(unsigned)c, 256, (size_t)d * sizeof(float),
                          static_cast<cudaStream_t>(stream)>>>(
      xs_full, qs, cand, norms, valid, out, n, kc, d, metric);
  return (int)cudaGetLastError();
}
