// distance_tile: [B, N] distances between query rows and stored rows for
// the nine catalog metrics, on two routes chosen by shape.
//
// Replaces surrealdb_tpu/ops/distance.py:35 distance_matrix (a jax.jit
// einsum for euclidean/cosine/dot/pearson, a broadcast elementwise
// reduction for the rest). The formulas are the reference's: euclidean
// in the expansion form sqrt(max(|x|^2 + |q|^2 - 2 x.q, 0)), cosine and
// pearson normalise both operands first (pearson centres, then divides
// by the clamped norm) and take 1 - dot, dot is -x.q, minkowski takes
// its order p at run time, jaccard is 1 - sum(min)/max(sum(max), 1e-30),
// hamming counts unequal coordinates.
//
// Row statistics (distance_row_stats, one warp a row): (|x|^2, 1) for
// euclidean, (0, max(|x|, 1e-30)) for cosine, (mean, max(|x - mean|,
// 1e-30)) for pearson. A store computes its rows' statistics once, when
// it is placed on the card, and hands them to every call
// (xstats_ready = 1); a call without them computes them first. The
// queries' statistics are computed on every call.
//
// Route 1, distance_tile_tf32 -- euclidean, cosine, dot and pearson on
// the tensor cores, for rows whose pitch TMA can take (D % 4 == 0, a
// 16-byte aligned base, N < 2^31); the wrapper (ops/distance.py) picks
// it by shape alone.
// - Numerics: one TF32 product keeps 10 mantissa bits and misses the
//   port's f32 tolerance (atol 1e-4, rtol 1e-5) for euclidean at D =
//   768. So every operand is split, v = hi + lo with hi =
//   cvt.rna.tf32(v) and lo = v - hi (exact in f32; the tensor core reads
//   lo with its low 13 bits dropped), and the product is lo.hi + hi.lo +
//   hi.hi into f32 accumulators (3xTF32: within the f32 tolerance,
//   tests/test_torch_distance.py models it). Operands are normalised
//   before the split, as the reference normalises before its product:
//   the queries by a prologue kernel (split_queries_kernel: q / b, or
//   (q - mean) / b, then the split, once a call, into hi/lo [B, Dp]
//   arrays, Dp = D rounded up to 32); the store rows in registers, x *
//   (1 / b) or (x - mean) * (1 / b) with one reciprocal a row (within an
//   ulp of the division; pearson is never rewritten as x.q - D mean_x
//   mean_q, which cancels).
// - Shape: store rows are the wgmma A operand (M = 64), read from
//   registers: each consumer warpgroup owns 64 rows of a 128-row tile
//   and loads its fragments from the f32 tile in shared memory,
//   normalises and splits them there, so the split costs no
//   shared-memory traffic. Queries are the N operand, Q = 8..128 wide
//   (the least of 8/16/32/64/128 that holds B, tiles of 128 past it),
//   so B = 1 pads to 8 queries. The [128 x 32] store tile and the
//   [Q x 32] hi and lo query tiles arrive by TMA (128-byte swizzle, zero
//   fill past N, B and D) in a ring of 4 (Q = 128) to 6 stages, fed by
//   one producer thread; persistent blocks (one an SM) walk the output
//   tiles, the query tiles of one store tile on neighbouring blocks, so
//   a store tile comes from HBM about once. With Q = 128 a k-step moves
//   48 KB from L2 for 24 m64n128k8 products.
// - Accumulation: the tensor cores truncate as they add into an f32
//   accumulator, and over a whole 768-deep dot of magnitude ~30 that
//   bias reached 7e-4 (3xTF32 dot at D = 768 on the H100), past the
//   tolerance. So each k-step (32 columns, 12 products of 8) sums into
//   a fresh accumulator, which joins a second, the total, by an f32
//   add that rounds to nearest: the truncation only ever sees a
//   k-step's partial sum. Two accumulator sets are why a warpgroup owns
//   64 rows, not 128.
// - k order: the products' k index is a fixed permutation of the 32
//   columns of a k-step (perm_col): the query prologue writes each
//   column where the permutation puts it, so a thread's A fragments for
//   the four k8 slices are eight neighbouring floats of its rows: one
//   conflict-free 16-byte shared load a row per two slices.
// - Each output comes from one fixed k order (no split-K), and a row's
//   normalisation is its own, so a distance does not depend on N, the
//   shard or the tile position: distance_tile(xs[a:b], q) equals
//   distance_tile(xs, q)[:, a:b] bit for bit.
// - Epilogue: straight from the accumulators, without shared-memory
//   staging: for one accumulator register a warp's lanes hold 8
//   neighbouring rows of 4 queries, so every store instruction writes 4
//   whole 32-byte sectors of the [B, N] row-major output, and no block
//   barrier sits between a tile's epilogue and the next tile's products,
//   whose first k-steps the producer has already loaded.
// - Bound on the H100: the work is 3 x 2BND TF32 operations (495
//   TFLOP/s) against the 4(ND + BD + BN) bytes (3.35 TB/s): bytes below
//   B ~ 90 (the store read), operations above.
//
// Route 2, distance_tile_simt -- the elementwise metrics (manhattan,
// chebyshev, hamming, minkowski, jaccard) on the CUDA cores, and the
// product metrics on shapes TMA cannot take (D % 4 != 0, e.g. D = 37):
// a 256-row x (8 or 32)-query output tile per 256-thread block, each
// thread 8 rows x 4 queries (1 query when B <= 8) in registers, fed from
// shared memory by 16-byte loads (its rows 4t..4t+3 and 128+4t..+3, the
// warp's lanes on neighbouring addresses); 16 dimensions a step, staged
// transposed into a double buffer while the previous step computes (one
// barrier a step), each thread's 16 loads a step off one pointer. At
// most 128 registers a thread, so two blocks share an SM (with 202-238
// registers and one block an SM, manhattan B=128 N=262,144 D=128 took
// 0.67 ms on the H100; with two, 0.51). Bound: 2-3 f32 operations an
// element on 67 TFLOP/s.
//
// Both routes apply the validity mask in the store (+inf).
#include "hopper.cuh"

#include <math.h>

namespace {

// ---------------------------------------------------------------- stats

// stats[row] = (a, b): euclidean (|x|^2, 1), cosine (0, max(|x|, 1e-30)),
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

bool needs_stats(int metric) {
  return metric == M_EUCLIDEAN || metric == M_COSINE || metric == M_PEARSON;
}

void launch_row_stats(const float* x, long long rows, int d, int metric,
                      float* stats, cudaStream_t s) {
  const int per_block = 256 / 32;
  row_stats_kernel<<<(unsigned)((rows + per_block - 1) / per_block), 256, 0,
                     s>>>(x, rows, d, metric, stats);
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

// ---------------------------------------------------------------- TF32

constexpr int TBM = 128;                 // store rows a tile
constexpr int TBK = 32;                  // f32 columns a k-step (128 bytes)
constexpr int X_BYTES = TBM * TBK * 4;   // the store tile of a stage
constexpr int TTHREADS = 384;            // producer + two consumers
constexpr int SMEM_LIMIT = 232448;       // 227 KB a block
constexpr int MAX_STAGES = 6;

template <int Q>
struct TfShape {
  static constexpr int Q_BYTES = Q * TBK * 4;  // one of the hi / lo tiles
  static constexpr int STAGE = X_BYTES + 2 * Q_BYTES;
  static constexpr int FIT = (SMEM_LIMIT - 1024) / STAGE;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int SMEM = 1024 + STAGES * STAGE;
};

// the products' column k (0..31) of a k-step reads the row's column
// perm_col(k): k = 8 kk + 4 h + t (k8 slice kk, fragment half h, lane
// t = lane % 4) -> 8 t + 2 kk + h, so lane t's fragments over the four
// slices are the row's columns 8t..8t+7
__host__ __device__ __forceinline__ int perm_col(int k) {
  return 8 * (k & 3) + 2 * (k >> 3) + ((k >> 2) & 1);
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// queries -> (hi, lo) [b, dp]: normalised as the metric asks, column
// kpos of each 32-column block holding the row's column perm_col(kpos),
// zero past d
__global__ void split_queries_kernel(const float* __restrict__ qs,
                                     const float* __restrict__ qstats,
                                     int b, int d, int dp, int metric,
                                     float* __restrict__ qhi,
                                     float* __restrict__ qlo) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)b * dp) return;
  const int row = (int)(i / dp), kpos = (int)(i % dp);
  const int col = (kpos & ~31) + perm_col(kpos & 31);
  float v = 0.f;
  if (col < d) {
    v = qs[(long long)row * d + col];
    if (metric == M_COSINE)
      v = v / qstats[row * 2 + 1];
    else if (metric == M_PEARSON)
      v = (v - qstats[row * 2]) / qstats[row * 2 + 1];
  }
  const float hi = tf32_rna(v);
  qhi[i] = hi;
  qlo[i] = v - hi;
}

template <int Q>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a,
                                           uint64_t db, int accum);

template <>
__device__ __forceinline__ void wgmma_tf32<8>(float* d, const uint32_t* a,
                                               uint64_t db, int accum) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accum));
}

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float* d, const uint32_t* a,
                                               uint64_t db, int accum) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accum));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float* d, const uint32_t* a,
                                               uint64_t db, int accum) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accum));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float* d, const uint32_t* a,
                                               uint64_t db, int accum) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accum));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float* d, const uint32_t* a,
                                               uint64_t db, int accum) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accum));
}

// keep the compiler from moving register accesses across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_acc(float* r) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_frag(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int Q, int METRIC>
__global__ void __launch_bounds__(TTHREADS, 1)
    tf32_tile_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_qhi,
                     const __grid_constant__ CUtensorMap tm_qlo,
                     const float* __restrict__ xstats,
                     const float* __restrict__ qstats,
                     const uint8_t* __restrict__ valid,
                     float* __restrict__ out, int n, int b, int ktiles,
                     int qtiles, long long tiles) {
  using S = TfShape<Q>;
  constexpr bool NORM = METRIC == M_COSINE || METRIC == M_PEARSON;
  constexpr int NA = Q / 2;  // accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[S::STAGES];
  __shared__ __align__(8) uint64_t empty_bar[S::STAGES];
  // the 128-byte swizzle needs 1024-byte aligned tiles
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // the warpgroup index, broadcast from lane 0 so that ptxas sees a
  // warp-uniform value and does not serialise the products
  const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
  const int tid = threadIdx.x & 127;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(&full_bar[s], 1);   // the producer's expect_tx arrival
      mbar_init(&empty_bar[s], 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int q0 = (int)(t % qtiles) * Q;
        const int r0 = (int)(t / qtiles) * TBM;
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(&empty_bar[stage], phase ^ 1u);  // slot free
          mbar_expect_tx(&full_bar[stage], S::STAGE);
          const uint32_t slot = ring + stage * S::STAGE;
          tma_load_2d(slot, &tm_x, &full_bar[stage], kt * TBK, r0);
          tma_load_2d(slot + X_BYTES, &tm_qhi, &full_bar[stage], kt * TBK,
                      q0);
          tma_load_2d(slot + X_BYTES + S::Q_BYTES, &tm_qlo, &full_bar[stage],
                      kt * TBK, q0);
          if (++stage == S::STAGES) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // this thread's rows of a tile: trow + 8h (h = 0, 1); their 16-byte
  // chunks of a k-step (columns 8 tig .. 8 tig + 7: chunks 2 tig and
  // 2 tig + 1) sit at (row, chunk ^ (row & 7)) under the swizzle, and
  // row & 7 == gid
  const int trow = cw * 64 + warp * 16 + gid;
  const uint32_t a_row = (uint32_t)trow * 128;
  const uint32_t a_chunk[2] = {(uint32_t)(((2 * tig) ^ gid) << 4),
                               (uint32_t)(((2 * tig + 1) ^ gid) << 4)};
  float acc[NA];  // one k-step's products (the tensor cores' sum)
  float tot[NA];  // the sum over k-steps, in round-to-nearest f32 adds
  uint32_t frag[2][2][4];  // [buffer][hi, lo][a0..a3]
  int stage = 0;
  uint32_t phase = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int q0 = (int)(t % qtiles) * Q;
    const int r0 = (int)(t / qtiles) * TBM;
    // the rows' normalisation: v' = (v - shift) * scale
    float shift[2], scale[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + trow + 8 * h;
      shift[h] = 0.f;
      scale[h] = 1.f;
      if (NORM && row < n) {
        if (METRIC == M_PEARSON) shift[h] = xstats[2 * (long long)row];
        scale[h] = 1.f / xstats[2 * (long long)row + 1];
      }
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) tot[i] = 0.f;
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(&full_bar[stage], phase);
      const uint32_t slot = ring + stage * S::STAGE;
      const uint64_t dhi = sw128_desc(slot + X_BYTES);
      const uint64_t dlo = sw128_desc(slot + X_BYTES + S::Q_BYTES);
      float4 raw[2];  // [h]: the chunk of the current slice pair
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int buf = kk & 1;
        if ((kk & 1) == 0) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float4 v;
            asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                         : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                         : "r"(slot + a_row + 8 * h * 128 +
                               a_chunk[kk >> 1]));
            if (NORM) {
              v.x = (v.x - shift[h]) * scale[h];
              v.y = (v.y - shift[h]) * scale[h];
              v.z = (v.z - shift[h]) * scale[h];
              v.w = (v.w - shift[h]) * scale[h];
            }
            raw[h] = v;
          }
        }
        // slice kk: columns 8 tig + 2 kk (a0: row, a1: row + 8) and
        // + 1 (a2, a3), i.e. elements (x, y) of the chunk for even kk,
        // (z, w) for odd
        const float vs[4] = {(kk & 1) ? raw[0].z : raw[0].x,
                             (kk & 1) ? raw[1].z : raw[1].x,
                             (kk & 1) ? raw[0].w : raw[0].y,
                             (kk & 1) ? raw[1].w : raw[1].y};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float hi = tf32_rna(vs[i]);
          frag[buf][0][i] = __float_as_uint(hi);
          frag[buf][1][i] = __float_as_uint(vs[i] - hi);
        }
        fence_frag<8>(&frag[buf][0][0]);
        wgmma_fence();
        // the small terms first; the first product of a k-step starts
        // the step's sum afresh
        wgmma_tf32<Q>(acc, frag[buf][1], dhi + 2 * kk, kk != 0);
        wgmma_tf32<Q>(acc, frag[buf][0], dlo + 2 * kk, 1);
        wgmma_tf32<Q>(acc, frag[buf][0], dhi + 2 * kk, 1);
        wgmma_commit();
        // the group before this one has retired: its fragment buffer
        // is free again
        wgmma_wait<1>();
        fence_frag<8>(&frag[buf][0][0]);
      }
      // the tensor cores truncate as they accumulate: a k-step's sum
      // (12 products of 8) joins the total by a rounded add, so the
      // truncation never sees the whole dot's magnitude
      wgmma_wait<0>();
      fence_acc<NA>(acc);
#pragma unroll
      for (int i = 0; i < NA; ++i) tot[i] += acc[i];
      fence_acc<NA>(acc);
      if (tid == 0) mbar_arrive(&empty_bar[stage]);
      if (++stage == S::STAGES) {
        stage = 0;
        phase ^= 1u;
      }
    }
    // epilogue: total 4j + 2h + e is (tile row trow + 8h, query
    // q0 + 8j + 2 tig + e)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + trow + 8 * h;
      if (row >= n) continue;
      const bool ok = valid == nullptr || valid[row] != 0;
      const float x2 =
          METRIC == M_EUCLIDEAN ? xstats[2 * (long long)row] : 0.f;
#pragma unroll
      for (int j = 0; j < Q / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = q0 + 8 * j + 2 * tig + e;
          if (q >= b) continue;
          float v = INFINITY;
          if (ok) {
            const float q2 = METRIC == M_EUCLIDEAN ? qstats[2 * q] : 0.f;
            v = finish<METRIC>(tot[4 * j + 2 * h + e], 0.f, x2, q2, 0.f);
          }
          __stcs(out + (long long)q * n + row, v);
        }
    }
  }
}

template <int Q, int METRIC>
int launch_tf32_q(const CUtensorMap& tmx, const CUtensorMap& tmh,
                  const CUtensorMap& tml, const float* xstats,
                  const float* qstats, const uint8_t* valid, float* out,
                  int n, int b, int ktiles, cudaStream_t st) {
  using S = TfShape<Q>;
  const int qtiles = (b + Q - 1) / Q;
  const long long tiles = (long long)qtiles * ((n + TBM - 1) / TBM);
  const int sms = surreal_sm_count();
  const long long grid = tiles < sms ? tiles : sms;
  static SurrealSmemDone smem_done;
  const cudaError_t attr = surreal_smem_limit(tf32_tile_kernel<Q, METRIC>,
                                              S::SMEM, &smem_done);
  if (attr != cudaSuccess) return (int)attr;
  tf32_tile_kernel<Q, METRIC><<<(unsigned)grid, TTHREADS, S::SMEM, st>>>(
      tmx, tmh, tml, xstats, qstats, valid, out, n, b, ktiles, qtiles,
      tiles);
  return (int)cudaGetLastError();
}

// the query tile width of a batch of b: the least of 8/16/32/64/128
// that holds it, 128 past that
int tf32_q(int b) {
  int q = 8;
  while (q < b && q < 128) q *= 2;
  return q;
}

template <int METRIC>
int launch_tf32(const CUtensorMap& tmx, const float* qhi, const float* qlo,
                const float* xstats, const float* qstats,
                const uint8_t* valid, float* out, int n, int b, int dp,
                cudaStream_t st) {
  const int q = tf32_q(b);
  CUtensorMap tmh, tml;
  if (!tensor_map_2d(qhi, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, b, dp, q,
                     &tmh) ||
      !tensor_map_2d(qlo, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, b, dp, q, &tml))
    return (int)cudaErrorInvalidValue;
  const int kt = dp / TBK;
  switch (q) {
    case 8:
      return launch_tf32_q<8, METRIC>(tmx, tmh, tml, xstats, qstats, valid,
                                      out, n, b, kt, st);
    case 16:
      return launch_tf32_q<16, METRIC>(tmx, tmh, tml, xstats, qstats, valid,
                                       out, n, b, kt, st);
    case 32:
      return launch_tf32_q<32, METRIC>(tmx, tmh, tml, xstats, qstats, valid,
                                       out, n, b, kt, st);
    case 64:
      return launch_tf32_q<64, METRIC>(tmx, tmh, tml, xstats, qstats, valid,
                                       out, n, b, kt, st);
    default:
      return launch_tf32_q<128, METRIC>(tmx, tmh, tml, xstats, qstats,
                                        valid, out, n, b, kt, st);
  }
}

// ---------------------------------------------------------------- SIMT

constexpr int SX = 256;        // stored rows a tile
constexpr int SK = 16;         // dimensions staged a step
constexpr int SXP = SX + 4;    // a staged dimension's row, 16-byte aligned
constexpr int STHREADS = 256;

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

constexpr int XPER = SX * SK / STHREADS;  // staged row values a thread

template <int TQ>
__host__ __device__ constexpr int qper() {  // staged query values a thread
  return (TQ * SK + STHREADS - 1) / STHREADS;
}

// global -> registers: value r of a thread is dimension k0 + tid % SK
// of tile row (query) tid / SK + r * (STHREADS / SK), from one pointer
// a step; normalised for cosine and pearson, zero past the edges
template <bool NORM, int TQ>
__device__ __forceinline__ void simt_fetch(
    float (&rx)[XPER], float (&rq)[qper<TQ>()], const float* __restrict__ xs,
    const float* __restrict__ qs, const float* __restrict__ xstats,
    const float* __restrict__ qstats, long long n, int b, int d,
    long long row0, int q0, int k0) {
  constexpr int RSTEP = STHREADS / SK;  // tile rows a pass of the block
  const int tid = threadIdx.x;
  const int gk = k0 + tid % SK;
  const bool kin = gk < d;
  const long long gx0 = row0 + tid / SK;
  const float* px = xs + gx0 * d + gk;
  const long long pstep = (long long)RSTEP * d;
#pragma unroll
  for (int r = 0; r < XPER; ++r) {
    const long long gx = gx0 + r * RSTEP;
    float v = 0.f;
    if (kin && gx < n) {
      v = px[r * pstep];
      if (NORM) v = (v - xstats[gx * 2]) / xstats[gx * 2 + 1];
    }
    rx[r] = v;
  }
#pragma unroll
  for (int r = 0; r < qper<TQ>(); ++r) {
    const int i = tid + r * STHREADS;
    const int gq = q0 + i / SK;
    float v = 0.f;
    if (i < TQ * SK && gq < b && kin) {
      v = qs[(long long)gq * d + gk];
      if (NORM) v = (v - qstats[gq * 2]) / qstats[gq * 2 + 1];
    }
    rq[r] = v;
  }
}

// registers -> one buffer of the transposed shared tiles
template <int TQ>
__device__ __forceinline__ void simt_stage(float (*sx)[SXP], float (*sq)[TQ],
                                           const float (&rx)[XPER],
                                           const float (&rq)[qper<TQ>()]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int r = 0; r < XPER; ++r) {
    const int i = tid + r * STHREADS;
    sx[i % SK][i / SK] = rx[r];
  }
#pragma unroll
  for (int r = 0; r < qper<TQ>(); ++r) {
    const int i = tid + r * STHREADS;
    if (i < TQ * SK) sq[i % SK][i / SK] = rq[r];
  }
}

// QPT queries a thread (1 or 4): a tile of 8 QPT queries x 256 rows
template <int METRIC, int QPT>
__global__ void __launch_bounds__(STHREADS, 2)
    simt_tile_kernel(const float* __restrict__ xs,
                     const float* __restrict__ qs,
                     const float* __restrict__ xstats,
                     const float* __restrict__ qstats,
                     const uint8_t* __restrict__ valid,
                     float* __restrict__ out, long long n, int b, int d,
                     float p) {
  constexpr bool NORM = METRIC == M_COSINE || METRIC == M_PEARSON;
  constexpr bool TWO = METRIC == M_JACCARD;
  constexpr int TQ = 8 * QPT;
  constexpr int QPER = qper<TQ>();
  __shared__ __align__(16) float sx[2][SK][SXP];  // [buf][dim][row]
  __shared__ __align__(16) float sq[2][SK][TQ];   // [buf][dim][query]
  const long long row0 = (long long)blockIdx.x * SX;
  const int q0 = blockIdx.y * TQ;
  const int tid = threadIdx.x;
  const int tx = tid & 31;  // rows 4tx..4tx+3 and 128+4tx..128+4tx+3
  const int ty = tid >> 5;  // queries ty*QPT .. ty*QPT + QPT - 1
  float rx[XPER], rq[QPER];
  float acc[QPT][8], acc2[QPT][8];
#pragma unroll
  for (int i = 0; i < QPT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[i][j] = 0.f;
      acc2[i][j] = 0.f;
    }
  const int steps = (d + SK - 1) / SK;
  simt_fetch<NORM, TQ>(rx, rq, xs, qs, xstats, qstats, n, b, d, row0, q0,
                       0);
  simt_stage<TQ>(sx[0], sq[0], rx, rq);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps)  // in flight while this step computes
      simt_fetch<NORM, TQ>(rx, rq, xs, qs, xstats, qstats, n, b, d, row0,
                           q0, (s + 1) * SK);
    const int kmax = min(SK, d - s * SK);
    for (int kk = 0; kk < kmax; ++kk) {
      float qv[QPT];
      if constexpr (QPT == 4) {
        const float4 t = *reinterpret_cast<const float4*>(&sq[buf][kk][ty * 4]);
        qv[0] = t.x;
        qv[1] = t.y;
        qv[2] = t.z;
        qv[3] = t.w;
      } else {
        qv[0] = sq[buf][kk][ty];
      }
      const float4 xa = *reinterpret_cast<const float4*>(&sx[buf][kk][4 * tx]);
      const float4 xb =
          *reinterpret_cast<const float4*>(&sx[buf][kk][128 + 4 * tx]);
      const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int i = 0; i < QPT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          combine<METRIC>(acc[i][j], acc2[i][j], qv[i], xv[j], p);
    }
    if (s + 1 < steps) simt_stage<TQ>(sx[buf ^ 1], sq[buf ^ 1], rx, rq);
    __syncthreads();
  }
  const bool vec = (n & 3) == 0;
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int gq = q0 + ty * QPT + i;
    if (gq >= b) continue;
    const float q2 = METRIC == M_EUCLIDEAN ? qstats[gq * 2] : 0.f;
    float* orow = out + (long long)gq * n;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long gx0 = row0 + 128 * half + 4 * tx;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long gx = gx0 + j;
        v[j] = INFINITY;
        if (gx < n && (valid == nullptr || valid[gx] != 0)) {
          const float x2 = METRIC == M_EUCLIDEAN ? xstats[gx * 2] : 0.f;
          v[j] = finish<METRIC>(acc[i][4 * half + j],
                                TWO ? acc2[i][4 * half + j] : 0.f, x2, q2,
                                p);
        }
      }
      if (vec && gx0 + 3 < n) {
        __stcs(reinterpret_cast<float4*>(orow + gx0),
               make_float4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gx0 + j < n) __stcs(orow + gx0 + j, v[j]);
      }
    }
  }
}

template <int METRIC>
void launch_simt(const float* xs, const float* qs, const float* xstats,
                 const float* qstats, const uint8_t* valid, float* out,
                 long long n, int b, int d, float p, cudaStream_t s) {
  const unsigned gx = (unsigned)((n + SX - 1) / SX);
  if (b <= 8) {
    simt_tile_kernel<METRIC, 1><<<dim3(gx, (unsigned)((b + 7) / 8)),
                                  STHREADS, 0, s>>>(xs, qs, xstats, qstats,
                                                    valid, out, n, b, d, p);
  } else {
    simt_tile_kernel<METRIC, 4><<<dim3(gx, (unsigned)((b + 31) / 32)),
                                  STHREADS, 0, s>>>(xs, qs, xstats, qstats,
                                                    valid, out, n, b, d, p);
  }
}

}  // namespace

SURREAL_API int distance_row_stats(const float* x, long long rows, int d,
                                   int metric, float* stats, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (d <= 0 || !needs_stats(metric)) return (int)cudaErrorInvalidValue;
  launch_row_stats(x, rows, d, metric, stats,
                   static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

SURREAL_API int distance_tile_tf32(const float* xs, const float* qs,
                                   const uint8_t* valid, float* out,
                                   float* xstats, int xstats_ready,
                                   float* qstats, float* qhi, float* qlo,
                                   long long n, int b, int d, int metric,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || b <= 0) return (int)cudaSuccess;
  // TMA: a 16-byte row pitch and 16-byte aligned bases; int32 coordinates
  if (d <= 0 || d % 4 != 0 || n > 0x7FFFFFFFLL ||
      (metric != M_EUCLIDEAN && metric != M_COSINE && metric != M_DOT &&
       metric != M_PEARSON) ||
      (reinterpret_cast<uintptr_t>(xs) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(qhi) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(qlo) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (needs_stats(metric)) {
    if (!xstats_ready) launch_row_stats(xs, n, d, metric, xstats, s);
    launch_row_stats(qs, b, d, metric, qstats, s);
  }
  const int dp = (d + TBK - 1) / TBK * TBK;
  const long long elems = (long long)b * dp;
  split_queries_kernel<<<(unsigned)((elems + 255) / 256), 256, 0, s>>>(
      qs, qstats, b, d, dp, metric, qhi, qlo);
  CUtensorMap tmx;
  if (!tensor_map_2d(xs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, n, d, TBM, &tmx))
    return (int)cudaErrorInvalidValue;
  const int ni = (int)n;
  switch (metric) {
    case M_EUCLIDEAN:
      return launch_tf32<M_EUCLIDEAN>(tmx, qhi, qlo, xstats, qstats, valid,
                                      out, ni, b, dp, s);
    case M_COSINE:
      return launch_tf32<M_COSINE>(tmx, qhi, qlo, xstats, qstats, valid, out,
                                   ni, b, dp, s);
    case M_DOT:
      return launch_tf32<M_DOT>(tmx, qhi, qlo, xstats, qstats, valid, out,
                                ni, b, dp, s);
    default:
      return launch_tf32<M_PEARSON>(tmx, qhi, qlo, xstats, qstats, valid,
                                    out, ni, b, dp, s);
  }
}

SURREAL_API int distance_tile_simt(const float* xs, const float* qs,
                                   const uint8_t* valid, float* out,
                                   float* xstats, int xstats_ready,
                                   float* qstats, long long n, int b, int d,
                                   int metric, float p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || b <= 0) return (int)cudaSuccess;
  if (d <= 0 || metric < 0 || metric > M_JACCARD)
    return (int)cudaErrorInvalidValue;
  if (needs_stats(metric)) {
    if (!xstats_ready) launch_row_stats(xs, n, d, metric, xstats, s);
    launch_row_stats(qs, b, d, metric, qstats, s);
  }
  switch (metric) {
    case M_EUCLIDEAN:
      launch_simt<M_EUCLIDEAN>(xs, qs, xstats, qstats, valid, out, n, b, d, p, s);
      break;
    case M_COSINE:
      launch_simt<M_COSINE>(xs, qs, xstats, qstats, valid, out, n, b, d, p, s);
      break;
    case M_DOT:
      launch_simt<M_DOT>(xs, qs, xstats, qstats, valid, out, n, b, d, p, s);
      break;
    case M_MANHATTAN:
      launch_simt<M_MANHATTAN>(xs, qs, xstats, qstats, valid, out, n, b, d, p, s);
      break;
    case M_CHEBYSHEV:
      launch_simt<M_CHEBYSHEV>(xs, qs, xstats, qstats, valid, out, n, b, d, p, s);
      break;
    case M_HAMMING:
      launch_simt<M_HAMMING>(xs, qs, xstats, qstats, valid, out, n, b, d, p, s);
      break;
    case M_MINKOWSKI:
      launch_simt<M_MINKOWSKI>(xs, qs, xstats, qstats, valid, out, n, b, d, p, s);
      break;
    case M_PEARSON:
      launch_simt<M_PEARSON>(xs, qs, xstats, qstats, valid, out, n, b, d, p, s);
      break;
    default:
      launch_simt<M_JACCARD>(xs, qs, xstats, qstats, valid, out, n, b, d, p, s);
      break;
  }
  return (int)cudaGetLastError();
}
