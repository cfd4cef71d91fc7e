// distance_tile<metric>: [B, N] distances between query rows and stored
// rows for the nine catalog metrics.
//
// Replaces surrealdb_tpu/ops/distance.py:35 distance_matrix (a jax.jit
// einsum for euclidean/cosine/dot/pearson, a broadcast elementwise
// reduction for the rest). The formulas are the reference's, so results
// agree within f32 summation-order tolerance: euclidean in the
// expansion form sqrt(max(|x|^2 + |q|^2 - 2 x.q, 0)), cosine and pearson
// normalise (pearson centres first) and then take 1 - dot, minkowski
// takes its order p at run time, jaccard is 1 - sum(min)/max(sum(max),
// 1e-30), hamming counts unequal coordinates.
//
// Design: a row_stats pass (one warp per row) computes |x|^2 for
// euclidean, or the (shift, divisor) that normalises a row for cosine
// and pearson. The tile kernel then computes a 32-query x 64-row output
// tile per 256-thread block: each step stages 32 dimensions of the
// query and stored rows in shared memory (normalised as they are
// staged) and every thread accumulates 2 x 4 outputs in registers. The
// validity mask is applied in the store (+inf), so knn_search needs no
// separate masking pass.
//
// Bound on the H100: with the serving batch (B of 1..a few hundred)
// each stored row is read once per 32 queries and the work is 2*B*N*D
// f32 operations on the CUDA cores (no tensor cores: the same kernel
// serves the elementwise metrics). At small B the [N, D] read (bytes)
// bounds it; at large B the f32 rate does.
#include "kernels.h"

#include <math.h>

namespace {

constexpr int TQ = 32;   // queries per tile
constexpr int TX = 64;   // stored rows per tile
constexpr int KD = 32;   // dimensions staged per step
constexpr int THREADS = 256;

// stats[row] = (a, b): euclidean (|x|^2, -), cosine (0, max(|x|, 1e-30)),
// pearson (mean, max(|x - mean|, 1e-30)); unused by other metrics
__global__ void row_stats_kernel(const float* __restrict__ x, long long rows,
                                 int d, int metric,
                                 float* __restrict__ stats) {
  const long long row =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* r = x + row * d;
  float s = 0.f, s2 = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = r[i];
    s += v;
    s2 += v * v;
  }
  s = surreal_warp_sum(s);
  s2 = surreal_warp_sum(s2);
  float a = 0.f, b = 1.f;
  if (metric == M_EUCLIDEAN) {
    a = s2;
  } else if (metric == M_COSINE) {
    b = fmaxf(sqrtf(s2), 1e-30f);
  } else if (metric == M_PEARSON) {
    a = s / (float)d;
    float c2 = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float v = r[i] - a;
      c2 += v * v;
    }
    c2 = surreal_warp_sum(c2);
    b = fmaxf(sqrtf(c2), 1e-30f);
  }
  if (lane == 0) {
    stats[row * 2] = a;
    stats[row * 2 + 1] = b;
  }
}

template <int METRIC>
__device__ __forceinline__ void combine(float& acc, float& acc2, float q,
                                        float x, float p) {
  if constexpr (METRIC == M_EUCLIDEAN || METRIC == M_COSINE ||
                METRIC == M_DOT || METRIC == M_PEARSON) {
    acc = fmaf(q, x, acc);
  } else if constexpr (METRIC == M_MANHATTAN) {
    acc += fabsf(q - x);
  } else if constexpr (METRIC == M_CHEBYSHEV) {
    acc = fmaxf(acc, fabsf(q - x));
  } else if constexpr (METRIC == M_HAMMING) {
    acc += (q != x) ? 1.f : 0.f;
  } else if constexpr (METRIC == M_MINKOWSKI) {
    acc += powf(fabsf(q - x), p);
  } else {  // jaccard
    acc += fminf(q, x);
    acc2 += fmaxf(q, x);
  }
}

template <int METRIC>
__device__ __forceinline__ float finish(float acc, float acc2, float x2,
                                        float q2, float p) {
  if constexpr (METRIC == M_EUCLIDEAN) {
    return sqrtf(fmaxf(x2 + q2 - 2.f * acc, 0.f));
  } else if constexpr (METRIC == M_COSINE || METRIC == M_PEARSON) {
    return 1.f - acc;
  } else if constexpr (METRIC == M_DOT) {
    return -acc;
  } else if constexpr (METRIC == M_MINKOWSKI) {
    return powf(acc, 1.f / p);
  } else if constexpr (METRIC == M_JACCARD) {
    return 1.f - acc / fmaxf(acc2, 1e-30f);
  } else {
    return acc;
  }
}

template <int METRIC>
__global__ void __launch_bounds__(THREADS)
    distance_tile_kernel(const float* __restrict__ xs,
                         const float* __restrict__ qs,
                         const float* __restrict__ xstats,
                         const float* __restrict__ qstats,
                         const uint8_t* __restrict__ valid,
                         float* __restrict__ out, long long n, int b, int d,
                         float p) {
  constexpr bool NORM = METRIC == M_COSINE || METRIC == M_PEARSON;
  __shared__ float sq[KD][TQ + 1];  // [dim][query]
  __shared__ float sx[KD][TX + 1];  // [dim][stored row]
  const long long row0 = (long long)blockIdx.x * TX;
  const int q0 = blockIdx.y * TQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // stored rows tx, tx+16, tx+32, tx+48
  const int ty = tid / 16;  // queries ty, ty+16
  float acc[2][4], acc2[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j] = 0.f;
      acc2[i][j] = 0.f;
    }
  for (int k0 = 0; k0 < d; k0 += KD) {
    for (int i = tid; i < TQ * KD; i += THREADS) {
      const int qi = i / KD, kk = i % KD;
      const int gq = q0 + qi, gk = k0 + kk;
      float v = 0.f;
      if (gq < b && gk < d) {
        v = qs[(long long)gq * d + gk];
        if (NORM) v = (v - qstats[gq * 2]) / qstats[gq * 2 + 1];
      }
      sq[kk][qi] = v;
    }
    for (int i = tid; i < TX * KD; i += THREADS) {
      const int xi = i / KD, kk = i % KD;
      const long long gx = row0 + xi;
      const int gk = k0 + kk;
      float v = 0.f;
      if (gx < n && gk < d) {
        v = xs[gx * d + gk];
        if (NORM) v = (v - xstats[gx * 2]) / xstats[gx * 2 + 1];
      }
      sx[kk][xi] = v;
    }
    __syncthreads();
    const int kmax = min(KD, d - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      const float qv[2] = {sq[kk][ty], sq[kk][ty + 16]};
      const float xv[4] = {sx[kk][tx], sx[kk][tx + 16], sx[kk][tx + 32],
                           sx[kk][tx + 48]};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          combine<METRIC>(acc[i][j], acc2[i][j], qv[i], xv[j], p);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gq = q0 + ty + 16 * i;
    if (gq >= b) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long gx = row0 + tx + 16 * j;
      if (gx >= n) continue;
      float v;
      if (valid != nullptr && valid[gx] == 0) {
        v = INFINITY;
      } else {
        const float x2 = METRIC == M_EUCLIDEAN ? xstats[gx * 2] : 0.f;
        const float q2 = METRIC == M_EUCLIDEAN ? qstats[gq * 2] : 0.f;
        v = finish<METRIC>(acc[i][j], acc2[i][j], x2, q2, p);
      }
      out[(long long)gq * n + gx] = v;
    }
  }
}

template <int METRIC>
void launch_tile(const float* xs, const float* qs, const float* xstats,
                 const float* qstats, const uint8_t* valid, float* out,
                 long long n, int b, int d, float p, cudaStream_t s) {
  const dim3 grid((unsigned)((n + TX - 1) / TX), (unsigned)((b + TQ - 1) / TQ));
  distance_tile_kernel<METRIC><<<grid, THREADS, 0, s>>>(
      xs, qs, xstats, qstats, valid, out, n, b, d, p);
}

}  // namespace

SURREAL_API int distance_tile(const float* xs, const float* qs,
                              const uint8_t* valid, float* out,
                              float* xstats, float* qstats, long long n,
                              int b, int d, int metric, float p,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || b <= 0) return (int)cudaSuccess;
  if (d <= 0 || metric < 0 || metric > M_JACCARD)
    return (int)cudaErrorInvalidValue;
  if (metric == M_EUCLIDEAN || metric == M_COSINE || metric == M_PEARSON) {
    const int per_block = 256 / 32;
    row_stats_kernel<<<(unsigned)((n + per_block - 1) / per_block), 256, 0,
                       s>>>(xs, n, d, metric, xstats);
    row_stats_kernel<<<(unsigned)((b + per_block - 1) / per_block), 256, 0,
                       s>>>(qs, b, d, metric, qstats);
  }
  switch (metric) {
    case M_EUCLIDEAN:
      launch_tile<M_EUCLIDEAN>(xs, qs, xstats, qstats, valid, out, n, b, d, p, s);
      break;
    case M_COSINE:
      launch_tile<M_COSINE>(xs, qs, xstats, qstats, valid, out, n, b, d, p, s);
      break;
    case M_DOT:
      launch_tile<M_DOT>(xs, qs, xstats, qstats, valid, out, n, b, d, p, s);
      break;
    case M_MANHATTAN:
      launch_tile<M_MANHATTAN>(xs, qs, xstats, qstats, valid, out, n, b, d, p, s);
      break;
    case M_CHEBYSHEV:
      launch_tile<M_CHEBYSHEV>(xs, qs, xstats, qstats, valid, out, n, b, d, p, s);
      break;
    case M_HAMMING:
      launch_tile<M_HAMMING>(xs, qs, xstats, qstats, valid, out, n, b, d, p, s);
      break;
    case M_MINKOWSKI:
      launch_tile<M_MINKOWSKI>(xs, qs, xstats, qstats, valid, out, n, b, d, p, s);
      break;
    case M_PEARSON:
      launch_tile<M_PEARSON>(xs, qs, xstats, qstats, valid, out, n, b, d, p, s);
      break;
    default:
      launch_tile<M_JACCARD>(xs, qs, xstats, qstats, valid, out, n, b, d, p, s);
      break;
  }
  return (int)cudaGetLastError();
}
