// C interface of the port's hand-written Hopper kernels (sm_90a).
//
// Each source file in this directory builds into its own shared library
// (device/compile_cache.py) and is loaded with ctypes. Every exported
// entry launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() as an int; the Python
// wrapper raises when it is not 0. Pointers are device pointers; a
// `valid` mask is one byte per row (0 = masked) and may be null.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define SURREAL_API extern "C" __attribute__((visibility("default")))

// metric codes: surrealdb_tpu_torch/ops/metrics.py METRIC_CODE
enum Metric {
  M_EUCLIDEAN = 0,
  M_COSINE = 1,
  M_DOT = 2,
  M_MANHATTAN = 3,
  M_CHEBYSHEV = 4,
  M_HAMMING = 5,
  M_MINKOWSKI = 6,
  M_PEARSON = 7,
  M_JACCARD = 8,
};

// largest k select_topk_rows takes (its sort buffer lives in shared memory)
#define SURREAL_SELECT_MAX_K 4096

__device__ __forceinline__ float surreal_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// distance.cu: out[b, n] = distance(qs[b], xs[n]) for one metric, +inf
// where valid[n] == 0. xstats/qstats are scratch of 2 floats per row.
SURREAL_API int distance_tile(const float* xs, const float* qs,
                              const uint8_t* valid, float* out,
                              float* xstats, float* qstats, long long n,
                              int b, int d, int metric, float p,
                              void* stream);

// select.cu: per row r, the k smallest of vals[r, 0:n] (row stride ld)
// in ascending (value, index) order -- ties go to the lower index.
// out_idx holds the position, or ids[r, position] when ids is not null.
SURREAL_API int select_topk_rows(const float* vals, long long ld,
                                 const int32_t* ids, long long ids_ld,
                                 int rows, long long n, int k,
                                 float* out_vals, int32_t* out_idx,
                                 void* stream);

// rank_rescore.cu: out[c, n] = x2[n] - 2 dot(qs_bf16[c], xs_rank[n])
// (euclid != 0) or -dot, f32 accumulation, +inf where valid[n] == 0.
// Both operands are bf16 [rows, d] with d a multiple of 8.
SURREAL_API int rank_scores_bf16(const void* xs_rank, const void* qs_bf16,
                                 const float* x2, const uint8_t* valid,
                                 float* out, long long n, int c, int d,
                                 int euclid, void* stream);

// rank_rescore.cu: out[c, j] = exact f32 distance of qs[c] to
// xs_full[cand[c, j]] (euclidean direct form, cosine with norms, dot),
// +inf where valid[cand] == 0.
SURREAL_API int gather_rescore(const float* xs_full, const float* qs,
                               const int32_t* cand, const float* norms,
                               const uint8_t* valid, float* out,
                               long long n, int c, int kc, int d,
                               int metric, void* stream);

// csr_hop.cu: for every edge e and batch row b, if frontier[b, rows[e]]
// then next[b, cols[e]] = 1 (and acc[b, cols[e]] = 1 when acc is not
// null). next must be zeroed by the caller.
SURREAL_API int csr_hop_step(const int32_t* rows, const int32_t* cols,
                             long long e, const uint8_t* frontier,
                             uint8_t* next, uint8_t* acc, int b,
                             long long n, void* stream);
