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

// largest k whose select_topk_rows sort buffer lives in shared memory;
// a larger k sorts in the caller's device scratch
#define SURREAL_SELECT_MAX_K 4096

// Raise a kernel's dynamic shared-memory limit to `bytes` on the current
// device unless an earlier launch there already did (the attribute call
// costs host time on every launch otherwise; each device holds its own
// copy of the kernel, so the record is kept per device). `done` is the
// launch site's record, a zero-initialised static.
#define SURREAL_MAX_DEVICES 64
struct SurrealSmemDone {
  int bytes[SURREAL_MAX_DEVICES];
};

template <typename K>
inline cudaError_t surreal_smem_limit(K* kernel, int bytes,
                                      SurrealSmemDone* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int* rec = dev < SURREAL_MAX_DEVICES ? &done->bytes[dev] : nullptr;
  if (rec != nullptr && bytes <= *rec) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && rec != nullptr) *rec = bytes;
  return err;
}

// the current device's SM count (recorded per device; 132 when the
// runtime cannot say)
inline int surreal_sm_count() {
  static int count[SURREAL_MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  int* rec = dev < SURREAL_MAX_DEVICES ? &count[dev] : nullptr;
  if (rec != nullptr && *rec > 0) return *rec;
  int c = 0;
  if (cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      c <= 0)
    c = 132;
  if (rec != nullptr) *rec = c;
  return c;
}

// a row index by JAX's gather rule: an id in [-n, 0) wraps to id + n,
// then the result is clamped to [0, n - 1] (ops/topk.py jax_rows)
__device__ __forceinline__ long long surreal_jax_row(long long id,
                                                     long long n) {
  if (id < 0) id += n;
  return id < 0 ? 0 : (id >= n ? n - 1 : id);
}

__device__ __forceinline__ float surreal_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// distance.cu: stats[r] = the per-row statistics of x[r] that
// euclidean (|x|^2, 1), cosine (0, max(|x|, 1e-30)) and pearson (mean,
// max(|x - mean|, 1e-30)) take; [rows, 2] f32.
SURREAL_API int distance_row_stats(const float* x, long long rows, int d,
                                   int metric, float* stats, void* stream);

// distance.cu: out[b, n] = distance(qs[b], xs[n]) for one metric, +inf
// where valid[n] == 0. xstats holds the rows' statistics when
// xstats_ready (else it is [n, 2] scratch they are computed into);
// qstats is [b, 2] scratch. distance_tile_tf32 (euclidean, cosine, dot,
// pearson; d % 4 == 0, 16-byte aligned xs, n < 2^31) runs on the tensor
// cores in 3xTF32; qhi and qlo are [b, d rounded up to 32] scratch (16-
// byte aligned). distance_tile_simt takes every metric and shape.
SURREAL_API int distance_tile_tf32(const float* xs, const float* qs,
                                   const uint8_t* valid, float* out,
                                   float* xstats, int xstats_ready,
                                   float* qstats, float* qhi, float* qlo,
                                   long long n, int b, int d, int metric,
                                   void* stream);
SURREAL_API int distance_tile_simt(const float* xs, const float* qs,
                                   const uint8_t* valid, float* out,
                                   float* xstats, int xstats_ready,
                                   float* qstats, long long n, int b, int d,
                                   int metric, float p, void* stream);

// select.cu: per row r, the k smallest of vals[r, 0:n] (row stride ld)
// in ascending (value, index) order -- ties go to the lower index.
// out_idx holds the position, or ids[r, position] when ids is not null.
// For k > SURREAL_SELECT_MAX_K, scratch is a [rows, scratch_ld] u64
// buffer with scratch_ld >= the power of two >= k (else it may be null).
// blocks_per_row > 1 splits each row over that many blocks: then work
// is a [rows, SURREAL_SELECT_WORK_U32] u32 workspace and gather a
// [rows, gather_cap] u64 buffer (gather_cap >= k); else both may be
// null.
#define SURREAL_SELECT_WORK_U32 5124
SURREAL_API int select_topk_rows(const float* vals, long long ld,
                                 const int32_t* ids, long long ids_ld,
                                 int rows, long long n, int k,
                                 float* out_vals, int32_t* out_idx,
                                 unsigned long long* scratch,
                                 long long scratch_ld, int blocks_per_row,
                                 unsigned int* work,
                                 unsigned long long* gather,
                                 long long gather_cap, void* stream);

// select.cu: per row r, the k smallest of the packed pairs
// pairs[r, 0:min(counts[r], ld)] ((order key of the value) << 32 | id),
// ascending by (value, id): out_vals the value, out_idx the id; a row
// with fewer than k pairs gives (+inf, -1). sb is the block's key buffer
// (ops/topk.py pair_select_plan: a power of two >= 64 and >= k); past
// 8192 keys it is scratch, a [rows, sb] u64 buffer (else null).
SURREAL_API int select_topk_pairs(const unsigned long long* pairs,
                                  long long ld, const unsigned int* counts,
                                  int rows, int k, int sb, float* out_vals,
                                  int32_t* out_idx,
                                  unsigned long long* scratch, void* stream);

// rank_rescore.cu: out[c, n] = x2[n] - 2 dot(qs_bf16[c], xs_rank[n])
// (euclid != 0) or -dot, f32 accumulation, +inf where valid[n] == 0.
// Both operands are bf16 [rows, d] with d a multiple of 8.
SURREAL_API int rank_scores_bf16(const void* xs_rank, const void* qs_bf16,
                                 const float* x2, const uint8_t* valid,
                                 float* out, long long n, int c, int d,
                                 int euclid, void* stream);

// rank_rescore.cu: with k == 0, out[c, j] = exact f32 distance of
// qs[c] to xs_full[cand[c, j]] (euclidean direct form, cosine with
// norms, dot), +inf where valid[cand] == 0; rows indexed by JAX's rule
// (surreal_jax_row). With 0 < k <= kc <= 2048, instead the k smallest
// of each query's kc distances by (value, column): out_vals[c, k] the
// distances, out_ids[c, k] cand at their columns. cluster: blocks a
// query (1..8, ops/topk.py rescore_plan).
SURREAL_API int gather_rescore(const float* xs_full, const float* qs,
                               const int32_t* cand, const float* norms,
                               const uint8_t* valid, float* out,
                               float* out_vals, int32_t* out_ids,
                               long long n, int c, int kc, int d, int k,
                               int metric, int cluster, void* stream);

// rank_int8.cu: out[c, j] = score of the int8 row xs[j] (width d, any
// multiple of 16) against query c quantised first (sq = 127 / max|q|,
// q8 = rint(q sq), into the caller's scratch q8[c, d] and qscale[c];
// qs null: q8 and qscale already hold them): approx = dots * (arow / sq)
// (probe_order 0, knn_rank_int8) or dots * (arow * (1 / sq))
// (probe_order 1, the ANN probe), dots the exact int32 product;
// x2 - 2 approx (euclid) or -approx; +inf where valid == 0. With
// tile_step 1, j runs over the n store rows (n_out == n); with
// tile_step s > 1 over a sample of n_out rows (a multiple of 256):
// output tile t (256 rows) is store tile t * s.
SURREAL_API int rank_scores_int8(const int8_t* xs, const float* qs,
                                 const float* arow, const float* x2,
                                 const uint8_t* valid, float* out,
                                 int8_t* q8, float* qscale, long long n,
                                 long long n_out, int tile_step, int c,
                                 int d, int euclid, int probe_order,
                                 void* stream);

// rank_int8.cu: the same scores (probe_order 0) of all n store rows,
// filtered: every row j whose score's order key is at or below thr[c]'s
// is appended to pairs[c, 0:cap] as (order key << 32 | j); counts[c]
// (zeroed here) counts every survivor, also past cap. tile_x2min
// (euclidean): the least x2 of each 256-row tile of the store (of the
// last tile's rows that exist). cluster, halves, stages: the launch
// plan (ops/topk.py candidates_plan; stages 0 takes the streamed route).
SURREAL_API int rank_candidates_int8(const int8_t* xs, const float* qs,
                                     const float* arow, const float* x2,
                                     const uint8_t* valid, const float* thr,
                                     unsigned long long* pairs,
                                     unsigned int* counts, long long cap,
                                     const float* tile_x2min,
                                     int8_t* q8, float* qscale, long long n,
                                     int c, int d, int euclid, int cluster,
                                     int halves, int stages, void* stream);

// rank_int8.cu: the int8 store of [n, d] rows (f32, or f64 when is_f64):
// x8[n, width] (zero columns past d), arow[n], x2[n] (euclidean only).
SURREAL_API int quantize_rows_int8(const void* rows, int is_f64, long long n,
                                   int d, int width, int metric, int8_t* x8,
                                   float* arow, float* x2, void* stream);

// ann_descent.cu: per query b, `iters` rounds of the greedy graph descent
// from the frontier (init_ids, init_dist)[b, width]; writes the kc best
// (ids, int8 scores). d is the int8 row width (a multiple of 16).
SURREAL_API int ann_descent(const int32_t* graph, const int8_t* x8,
                            const float* arow, const float* x2q,
                            const float* qs, const int32_t* init_ids,
                            const float* init_dist, int32_t* out_ids,
                            float* out_dist, long long n, int d_out, int d,
                            int b, int width, int expand, int iters, int kc,
                            int euclid, void* stream);

// csr_hop.cu: for every edge e and batch row b, if frontier[b, rows[e]]
// then next[b, cols[e]] = 1 (and acc[b, cols[e]] = 1 when acc is not
// null). next must be zeroed by the caller; words is 2 n ceil(b / 32)
// u32 of scratch (the packed frontier and next frontier).
SURREAL_API int csr_hop_step(const int32_t* rows, const int32_t* cols,
                             long long e, const uint8_t* frontier,
                             uint8_t* next, uint8_t* acc, int b,
                             long long n, uint32_t* words, void* stream);

// mesh_merge.cu: the merge of per-shard partial top-k tiles. Part s
// holds [b, widths[s]] (dist, local id) pairs (widths[s] <= w); its
// columns widths[s]..w-1 stand for padding rows: (+inf, local id = the
// column). Row r's answer is the k_out smallest of the parts * w entries
// by (dist, position in the concatenation of the parts in order), with
// ids min(local + bases[s], id_max). `table` is a host array of
// 4 * parts entries (parts at most SURREAL_MERGE_MAX_PARTS): the parts'
// dist pointers, their id pointers (device pointers; 0 where
// widths[s] == 0), bases[s], widths[s]. When k_out exceeds
// SURREAL_MERGE_SORT_KEYS, scratch is a [b, scratch_ld] u64 buffer with
// scratch_ld >= the power of two >= k_out (else it may be null).
#define SURREAL_MERGE_MAX_PARTS 32
#define SURREAL_MERGE_SORT_KEYS 4096
SURREAL_API int merge_partials_topk(const long long* table, int parts,
                                    int b, int w, int k_out,
                                    long long id_max, float* out_dist,
                                    int32_t* out_ids,
                                    unsigned long long* scratch,
                                    long long scratch_ld, void* stream);

// mesh_merge.cu: out = OR of the `parts` uint8 masks of nbytes each
// (host array of device pointers, at most SURREAL_MERGE_MAX_PARTS), and
// acc |= out when acc is not null.
SURREAL_API int mask_or_reduce(const uint8_t* const* masks, int parts,
                               long long nbytes, uint8_t* out,
                               uint8_t* acc, void* stream);
