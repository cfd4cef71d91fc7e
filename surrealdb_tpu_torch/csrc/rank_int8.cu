// The kernels of the int8 ranking store and of the graph-ANN probe.
//
// rank_scores_int8 replaces the scoring half of
// surrealdb_tpu/ops/topk.py:145 knn_rank_int8, which per query chunk
// (1) quantises each query row, sq = 127 / max(|q|, 1e-30) and
// q8 = round-half-even(q * sq); (2) takes the int8 x int8 -> int32
// product with the per-row-scaled int8 store; (3) dequantises and
// scores, |x|^2 - 2 approx (euclidean) or -approx (cosine on
// pre-normalised rows, dot), masked to +inf; (4) keeps kc candidates
// with approx_max_k. (4) is select_topk_rows (select.cu). The same
// kernel scores the routing probe of the graph-ANN descent
// (surrealdb_tpu/device/annstore.py:29 _descent_scored), which
// dequantises in another float order: knn_rank_int8 computes
// dots * (arow / sq), the probe dots * (arow * (1 / sq)). The flag
// `probe_order` picks the one to reproduce; each is computed with
// round-to-nearest intrinsics, never contracted, so the scores are the
// reference's bit for bit.
//
// Design: a first small kernel quantises the C queries once into the
// wrapper's scratch (q8 [C, D] int8, the per-query scale [C]). Then a
// block owns a tile of 64 queries and walks store tiles of 128 rows (a
// persistent loop over blockIdx.y). The block's int8 query tile sits in
// shared memory for one width chunk of at most 2048 columns: a store up
// to 2048 wide loads it once in the prologue; a wider one (3072-d
// embeddings) reloads each chunk from the (L2-resident) scratch as the
// k loop crosses into it, and the int32 accumulators run on across the
// chunks, so the product stays exact int32 at any width. Store rows
// stream through a 4-stage cp.async ring in steps of 64 bytes; the
// product runs on the int8 tensor cores through WMMA (16x16x16 s8
// fragments, s32 accumulators): 8 warps as 2 (queries) x 4 (rows), each
// 32 x 32. WMMA wants fragment pointers 32-byte aligned, which 16-byte
// k-steps of a row-major tile are not, so both operands sit in shared
// memory chunk-major: [k/16][row][16]. Fragments past the last query (a
// 16-query chunk at N = 10M) are skipped, uniform over the warp. The
// int32 tile goes through shared memory (aliasing the ring) to the
// epilogue, which dequantises, scores, masks and writes the [C, N] f32
// scores coalesced. The store width must be a multiple of 16 (the
// stores pad rows with zero columns).
// Bound on the H100: bytes. At C = 16, N = 10M, D = 768 the store read
// is 7.7 GB and the score write 0.64 GB (2.5 ms at 3.35 TB/s); the
// 0.25 TOP of int8 products are 0.12 ms at 1,979 TOP/s. The persistent
// blocks keep up to 3 steps (24 KB) of each of 2 blocks an SM in flight.
//
// quantize_rows_int8 replaces the int8 quantisation of
// surrealdb_tpu/device/vecstore.py:150-173 (host numpy in the
// reference): per row, x2 = f32(sum in f64 of x^2) (euclidean);
// cosine divides the f32 row by f32(max(sqrt(sum in f64), 1e-30));
// m = max(max |row|, 1e-30), x8 = rint(row * (127 / m)), arow = m / 127.
// One warp a row, the row read three times (the second and third from
// L1/L2). f64 or f32 input rows. Bound: bytes (N D itemsize read,
// N D' + 8 N written).
#include "kernels.h"

#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int IM = 64;           // queries per tile
constexpr int IN = 128;          // store rows per tile
constexpr int IK = 64;           // int8 dimensions per ring step
constexpr int ICH = IK / 16;     // 16-byte chunks per row and step
constexpr int ISTAGES = 4;       // cp.async ring depth
constexpr int ITHREADS = 256;    // 8 warps: 2 (queries) x 4 (rows)
constexpr int STAGE_BYTES = IN * IK;
constexpr int RING_BYTES = ISTAGES * STAGE_BYTES;
constexpr int CLD = IN + 4;      // int32 tile pitch
constexpr int TILE_BYTES = IM * CLD * 4;
constexpr int WORK_BYTES = RING_BYTES > TILE_BYTES ? RING_BYTES : TILE_BYTES;
constexpr int KW = 2048;         // query columns held in shared memory
constexpr int KSPC = KW / IK;    // ring steps per width chunk

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void quantize_queries_kernel(const float* __restrict__ qs, int c,
                                        int d, int probe_order,
                                        int8_t* __restrict__ q8,
                                        float* __restrict__ qscale) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= c) return;
  const float* q = qs + (long long)r * d;
  float m = 0.f;
  for (int i = lane; i < d; i += 32) m = fmaxf(m, fabsf(q[i]));
  m = warp_max(m);
  const float sq = __fdiv_rn(127.0f, fmaxf(m, 1e-30f));
  for (int i = lane; i < d; i += 32)
    q8[(long long)r * d + i] = (int8_t)__float2int_rn(__fmul_rn(q[i], sq));
  if (lane == 0) qscale[r] = probe_order ? __fdiv_rn(1.0f, sq) : sq;
}

__global__ void __launch_bounds__(ITHREADS, 2)
    rank_int8_kernel(const int8_t* __restrict__ xs,
                     const int8_t* __restrict__ q8,
                     const float* __restrict__ qscale,
                     const float* __restrict__ arow,
                     const float* __restrict__ x2,
                     const uint8_t* __restrict__ valid,
                     float* __restrict__ out, long long n, int c, int d,
                     int euclid, int probe_order) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* work = smem;                          // ring / int32 tile
  const int qw = d < KW ? d : KW;  // query columns a chunk holds
  // one width chunk of the quantised query tile, chunk-major
  // [qw/16][IM][16]
  int8_t* q8s = reinterpret_cast<int8_t*>(smem + WORK_BYTES);
  float* s_scale = reinterpret_cast<float*>(smem + WORK_BYTES +
                                            (size_t)IM * qw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2;  // 0..1: 32 queries each
  const int wn = warp & 3;   // 0..3: 32 store rows each
  const int m0 = blockIdx.x * IM;
  const int nq = min(IM, c - m0);
  const int kchunks = d >> 4;
  const int ksteps = (d + IK - 1) / IK;
  const int nwchunks = (d + KW - 1) / KW;

  // copy width chunk `wc` of the tile's quantised queries into q8s, 16
  // bytes a thread; rows past the batch are zeros
  auto load_queries = [&](int wc) {
    const int k0 = wc * KW;
    const int c16 = (min(KW, d - k0)) >> 4;
    for (int i = tid; i < IM * c16; i += ITHREADS) {
      const int r = i / c16, j = i % c16;
      int4 v = make_int4(0, 0, 0, 0);
      if (r < nq)
        v = *reinterpret_cast<const int4*>(q8 + (long long)(m0 + r) * d +
                                           k0 + j * 16);
      *reinterpret_cast<int4*>(q8s + j * (IM * 16) + r * 16) = v;
    }
  };

  for (int r = tid; r < IM; r += ITHREADS)
    s_scale[r] = r < nq ? qscale[m0 + r] : 1.0f;
  if (nwchunks == 1) load_queries(0);
  __syncthreads();

  const long long ntiles = (n + IN - 1) / IN;
  for (long long t = blockIdx.y; t < ntiles; t += gridDim.y) {
    const long long n0 = t * IN;
    // stage one 64-byte step of 128 store rows, chunk-major
    auto load_stage = [&](int slot, int ks) {
      int8_t* Bs = reinterpret_cast<int8_t*>(work) + slot * STAGE_BYTES;
      const int k0 = ks * IK;
      for (int i = tid; i < IN * ICH; i += ITHREADS) {
        const int r = i / ICH, ch = i % ICH;
        const long long gr = n0 + r;
        const int gk = k0 + ch * 16;
        const bool p = gr < n && gk < d;
        cp_async16(Bs + ch * (IN * 16) + r * 16, p ? xs + gr * d + gk : xs,
                   p);
      }
    };

    wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

    for (int s = 0; s < ISTAGES - 1; ++s) {
      if (s < ksteps) load_stage(s, s);
      cp_async_commit();
    }
    for (int ks = 0; ks < ksteps; ++ks) {
      cp_async_wait<ISTAGES - 2>();  // step ks has landed
      __syncthreads();               // ...for all; slot ks-1 is free
      if (nwchunks > 1 && ks % KSPC == 0) {
        // every warp is past step ks-1: the next width chunk may land
        load_queries(ks / KSPC);
        __syncthreads();
      }
      const int nk = ks + ISTAGES - 1;
      if (nk < ksteps) load_stage(nk % ISTAGES, nk);
      cp_async_commit();
      const int8_t* Bs =
          reinterpret_cast<const int8_t*>(work) + (ks % ISTAGES) * STAGE_BYTES;
#pragma unroll
      for (int kk = 0; kk < ICH; ++kk) {
        const int kc = ks * ICH + kk;
        if (kc >= kchunks) break;  // a partial last step
        const int kl = (ks % KSPC) * ICH + kk;  // within the width chunk
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                       wmma::col_major> b[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(
              b[j], Bs + kk * (IN * 16) + (wn * 32 + j * 16) * 16, 16);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (m0 + wm * 32 + i * 16 >= c) continue;  // uniform per warp
          wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                         wmma::row_major> a;
          wmma::load_matrix_sync(
              a, q8s + kl * (IM * 16) + (wm * 32 + i * 16) * 16, 16);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free: reuse it for the int32 tile
    int* Cs = reinterpret_cast<int*>(work);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (m0 + wm * 32 + i * 16 >= c) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(
            Cs + (wm * 32 + i * 16) * CLD + wn * 32 + j * 16, acc[i][j], CLD,
            wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = tid; i < nq * IN; i += ITHREADS) {
      const int r = i / IN, col = i % IN;
      const long long gn = n0 + col;
      if (gn >= n) continue;
      const float dot = __int2float_rn(Cs[r * CLD + col]);
      // knn_rank_int8: dots * (arow / sq); probe: dots * (arow * inv_sq)
      const float scale = probe_order ? __fmul_rn(arow[gn], s_scale[r])
                                      : __fdiv_rn(arow[gn], s_scale[r]);
      const float approx = __fmul_rn(dot, scale);
      float s = euclid ? __fsub_rn(x2[gn], __fmul_rn(2.0f, approx)) : -approx;
      if (valid != nullptr && valid[gn] == 0) s = INFINITY;
      out[(long long)(m0 + r) * n + gn] = s;
    }
    __syncthreads();  // the tile is read: the next tile's loads may land
  }
}

template <typename T>
__global__ void quantize_rows_kernel(const T* __restrict__ rows, long long n,
                                     int d, int width, int metric,
                                     int8_t* __restrict__ x8,
                                     float* __restrict__ arow,
                                     float* __restrict__ x2) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= n) return;
  const T* x = rows + row * d;
  double ss = 0.0;
  for (int i = lane; i < d; i += 32) {
    const double v = (double)x[i];
    ss += v * v;
  }
  ss = warp_sum_f64(ss);
  float norm = 1.f;  // cosine: the f32 row norm the row is divided by
  if (metric == M_EUCLIDEAN && lane == 0) x2[row] = __double2float_rn(ss);
  if (metric == M_COSINE) norm = __double2float_rn(fmax(sqrt(ss), 1e-30));
  float m = 0.f;
  for (int i = lane; i < d; i += 32) {
    float b = (float)x[i];
    if (metric == M_COSINE) b = __fdiv_rn(b, norm);
    m = fmaxf(m, fabsf(b));
  }
  m = fmaxf(warp_max(m), 1e-30f);
  const float s = __fdiv_rn(127.0f, m);
  int8_t* out = x8 + row * width;
  for (int i = lane; i < width; i += 32) {
    int8_t q = 0;
    if (i < d) {
      float b = (float)x[i];
      if (metric == M_COSINE) b = __fdiv_rn(b, norm);
      q = (int8_t)__float2int_rn(__fmul_rn(b, s));
    }
    out[i] = q;
  }
  if (lane == 0) arow[row] = __fdiv_rn(m, 127.0f);
}

}  // namespace

SURREAL_API int rank_scores_int8(const int8_t* xs, const float* qs,
                                 const float* arow, const float* x2,
                                 const uint8_t* valid, float* out,
                                 int8_t* q8, float* qscale, long long n,
                                 int c, int d, int euclid, int probe_order,
                                 void* stream) {
  if (n <= 0 || c <= 0) return (int)cudaSuccess;
  if (d <= 0 || d % 16 != 0 || arow == nullptr || q8 == nullptr ||
      qscale == nullptr || (euclid && x2 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  quantize_queries_kernel<<<(unsigned)((c + 7) / 8), 256, 0, st>>>(
      qs, c, d, probe_order, q8, qscale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int mtiles = (c + IM - 1) / IM;
  const long long ntiles = (n + IN - 1) / IN;
  // two persistent blocks an SM over all query tiles
  long long per = (2LL * surreal_sm_count() + mtiles - 1) / mtiles;
  if (per > ntiles) per = ntiles;
  if (per > 65535) per = 65535;
  const int qw = d < KW ? d : KW;
  const size_t smem =
      (size_t)WORK_BYTES + (size_t)IM * qw + IM * sizeof(float);
  static SurrealSmemDone smem_done;
  err = surreal_smem_limit(rank_int8_kernel, (int)smem, &smem_done);
  if (err != cudaSuccess) return (int)err;
  rank_int8_kernel<<<dim3((unsigned)mtiles, (unsigned)per), ITHREADS, smem,
                     st>>>(xs, q8, qscale, arow, x2, valid, out, n, c, d,
                           euclid, probe_order);
  return (int)cudaGetLastError();
}

SURREAL_API int quantize_rows_int8(const void* rows, int is_f64, long long n,
                                   int d, int width, int metric, int8_t* x8,
                                   float* arow, float* x2, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (d <= 0 || width < d ||
      (metric != M_EUCLIDEAN && metric != M_COSINE && metric != M_DOT) ||
      (metric == M_EUCLIDEAN && x2 == nullptr))
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (n + threads / 32 - 1) / (threads / 32);
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64)
    quantize_rows_kernel<double><<<(unsigned)blocks, threads, 0, st>>>(
        static_cast<const double*>(rows), n, d, width, metric, x8, arow, x2);
  else
    quantize_rows_kernel<float><<<(unsigned)blocks, threads, 0, st>>>(
        static_cast<const float*>(rows), n, d, width, metric, x8, arow, x2);
  return (int)cudaGetLastError();
}
