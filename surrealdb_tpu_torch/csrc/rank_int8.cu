// The kernels of the int8 ranking store and of the graph-ANN probe.
//
// rank_scores_int8 replaces the scoring half of
// surrealdb_tpu/ops/topk.py:145 knn_rank_int8, which per query chunk
// (1) quantises each query row, sq = 127 / max(|q|, 1e-30) and
// q8 = round-half-even(q * sq); (2) takes the int8 x int8 -> int32
// product with the per-row-scaled int8 store; (3) dequantises and
// scores, |x|^2 - 2 approx (euclidean) or -approx (cosine on
// pre-normalised rows, dot), masked to +inf; (4) keeps kc candidates
// with approx_max_k. The same kernel scores the routing probe of the
// graph-ANN descent (surrealdb_tpu/device/annstore.py:29
// _descent_scored), which dequantises in another float order:
// knn_rank_int8 computes dots * (arow / sq), the probe
// dots * (arow * (1 / sq)). The flag `probe_order` picks the one to
// reproduce; each is computed with round-to-nearest intrinsics, never
// contracted, so the scores are the reference's bit for bit.
//
// One main loop, two epilogues:
// - scores (rank_scores_int8): out[c, n] f32, for the ANN probe, the
//   int8 store's threshold sample and the exact chunked path. With
//   tile_step > 1 it scores a strided sample of whole store tiles (tile
//   t of the output is store tile t * tile_step) without copying it.
// - candidates (rank_candidates_int8): (1)-(4) for a whole query frame
//   in one pass over the store, never writing [C, N]. Each query has a
//   threshold T[q] (the kc-th smallest score of a sample of the store,
//   ops/topk.py int8_candidates); every score whose order key is at or
//   below T[q]'s is appended to the query's row of a [C, cap] buffer of
//   (order key << 32 | store row) pairs through an atomic count (which
//   keeps counting past cap, so the caller sees an overflow). Masked
//   rows score +inf and so append only when T[q] is +inf. The exact
//   score is costly (an int-to-float conversion, which runs at a
//   quarter of the float rate, and an IEEE division per element), so
//   three tests run in turn, each ruling out only what is above T for
//   certain: an integer floor of the dot (a multiply and a compare), a
//   cheap float score dots * (arow * rcp(sq)) with a margin, then the
//   exact score's order key. The values past the floor go to a short
//   per-thread list in shared memory, tested by one rolled loop: the
//   rare code stays small, so it stays in the instruction cache.
//   Survivors are rare (about kc N / S of N per query), so an atomic
//   per survivor is cheap.
//
// Design (Hopper: TMA + wgmma, warp-specialised, persistent), the
// machinery of rank_rescore.cu's rank_scores_bf16 at 8 bits:
// - a quantisation kernel writes the queries once into the caller's
//   scratch (q8 [C, D] int8, sq [C]; or 1 / sq for the probe order);
// - one persistent block per SM owns a contiguous stripe of output
//   tiles of 64*WGM queries x 256 store rows, ordered store tile major,
//   query tile minor: the block walks every query tile of the frame
//   over each of its store tiles, so a store tile comes from HBM once
//   and from L2 for the other query tiles (the 393 KB of a 512-query
//   frame's q8 stay in L2);
// - warpgroup 0 is the producer: one thread keeps a 3-stage ring of
//   128-byte k-steps (128 int8 columns) of both operands in flight with
//   TMA (both K-major, as wgmma takes 8-bit operands only; 128-byte
//   swizzle matched by the descriptors; the tensor maps hold the true
//   width, so a k-step past a width that is 16 mod 32 reads TMA's zero
//   fill on both operands), each stage completing on an mbarrier, and
//   gives its registers to the consumers (setmaxnreg);
// - warpgroups 1 and 2 consume: wgmma.mma_async m64nNk32 s8 x s8 -> s32
//   from shared memory, queries on the M side, one group in flight,
//   each stage released once its products retire. With C > 64 (WGM = 2)
//   each consumer owns 64 queries x 256 rows (n256); with C <= 64
//   (WGM = 1) both share 64 queries and take 128 rows each (n128). Any
//   width streams through the ring in k-slices: 3072-d rows need no
//   column chunking, and the int32 products stay exact;
// - the epilogue works on the fragments in registers: a fragment holds
//   neighbouring store rows, whose arow / x2 the consumer fetched into
//   shared memory (cp.async) while the tile's products ran, and scores
//   leave as evict-first 8-byte stores.
// Bound on the H100: the candidates pass at C = 512, N = 10M, D = 768
// does 7.86 TOP of int8 products (3.97 ms at 1,979 TOP/s) and reads the
// 7.7 GB store (2.29 ms at 3.35 TB/s): operations. The scores epilogue
// at C = 16 writes [16, 10M] f32 beside the store read: bytes.
// The store width must be a multiple of 16 (the stores pad rows with
// zero columns): a 16-byte row pitch for TMA.
//
// quantize_rows_int8 replaces the int8 quantisation of
// surrealdb_tpu/device/vecstore.py:150-173 (host numpy in the
// reference): per row, x2 = f32(sum in f64 of x^2) (euclidean);
// cosine divides the f32 row by f32(max(sqrt(sum in f64), 1e-30));
// m = max(max |row|, 1e-30), x8 = rint(row * (127 / m)), arow = m / 127.
// One warp a row, the row read three times (the second and third from
// L1/L2). f64 or f32 input rows. Bound: bytes (N D itemsize read,
// N D' + 8 N written).
#include "hopper.cuh"

#include <climits>

namespace {

constexpr int BK = 128;        // int8 columns a k-step: one 128-byte row
constexpr int BN = 256;        // store rows a tile
constexpr int STAGES = 3;      // TMA ring depth
constexpr int A_BYTES = 128 * BK;   // query slot (WGM = 2 fills it)
constexpr int B_BYTES = BN * BK;    // store slot
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int COLS_BYTES = 2 * 3 * BN * 4;  // per consumer: arow, x2, ia
constexpr int RTHREADS = 384;  // producer warpgroup + two consumers
constexpr int EPI_SCORES = 0;
constexpr int EPI_CANDIDATES = 1;

typedef unsigned long long u64;

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

// the order-preserving uint32 of select.cu (-0.0 and +0.0 share one)
__device__ __forceinline__ uint32_t order_key(float f) {
  if (f == 0.0f) f = 0.0f;
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
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

// keeps the compiler from moving accumulator accesses across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(int* acc) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(acc[i])::"memory");
}

// 16 bytes global -> shared without registers; bytes < 16 zero-fills the
// rest (0: nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// one m64n256k32 s8 x s8 -> s32 product, both operands K-major in
// shared memory; acc[128] is this thread's accumulator fragment
__device__ __forceinline__ void wgmma_s8_m64n256(int* acc, uint64_t da,
                                                 uint64_t db, int accum) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]),
        "+r"(acc[4]), "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]),
        "+r"(acc[8]), "+r"(acc[9]), "+r"(acc[10]), "+r"(acc[11]),
        "+r"(acc[12]), "+r"(acc[13]), "+r"(acc[14]), "+r"(acc[15]),
        "+r"(acc[16]), "+r"(acc[17]), "+r"(acc[18]), "+r"(acc[19]),
        "+r"(acc[20]), "+r"(acc[21]), "+r"(acc[22]), "+r"(acc[23]),
        "+r"(acc[24]), "+r"(acc[25]), "+r"(acc[26]), "+r"(acc[27]),
        "+r"(acc[28]), "+r"(acc[29]), "+r"(acc[30]), "+r"(acc[31]),
        "+r"(acc[32]), "+r"(acc[33]), "+r"(acc[34]), "+r"(acc[35]),
        "+r"(acc[36]), "+r"(acc[37]), "+r"(acc[38]), "+r"(acc[39]),
        "+r"(acc[40]), "+r"(acc[41]), "+r"(acc[42]), "+r"(acc[43]),
        "+r"(acc[44]), "+r"(acc[45]), "+r"(acc[46]), "+r"(acc[47]),
        "+r"(acc[48]), "+r"(acc[49]), "+r"(acc[50]), "+r"(acc[51]),
        "+r"(acc[52]), "+r"(acc[53]), "+r"(acc[54]), "+r"(acc[55]),
        "+r"(acc[56]), "+r"(acc[57]), "+r"(acc[58]), "+r"(acc[59]),
        "+r"(acc[60]), "+r"(acc[61]), "+r"(acc[62]), "+r"(acc[63]),
        "+r"(acc[64]), "+r"(acc[65]), "+r"(acc[66]), "+r"(acc[67]),
        "+r"(acc[68]), "+r"(acc[69]), "+r"(acc[70]), "+r"(acc[71]),
        "+r"(acc[72]), "+r"(acc[73]), "+r"(acc[74]), "+r"(acc[75]),
        "+r"(acc[76]), "+r"(acc[77]), "+r"(acc[78]), "+r"(acc[79]),
        "+r"(acc[80]), "+r"(acc[81]), "+r"(acc[82]), "+r"(acc[83]),
        "+r"(acc[84]), "+r"(acc[85]), "+r"(acc[86]), "+r"(acc[87]),
        "+r"(acc[88]), "+r"(acc[89]), "+r"(acc[90]), "+r"(acc[91]),
        "+r"(acc[92]), "+r"(acc[93]), "+r"(acc[94]), "+r"(acc[95]),
        "+r"(acc[96]), "+r"(acc[97]), "+r"(acc[98]), "+r"(acc[99]),
        "+r"(acc[100]), "+r"(acc[101]), "+r"(acc[102]), "+r"(acc[103]),
        "+r"(acc[104]), "+r"(acc[105]), "+r"(acc[106]), "+r"(acc[107]),
        "+r"(acc[108]), "+r"(acc[109]), "+r"(acc[110]), "+r"(acc[111]),
        "+r"(acc[112]), "+r"(acc[113]), "+r"(acc[114]), "+r"(acc[115]),
        "+r"(acc[116]), "+r"(acc[117]), "+r"(acc[118]), "+r"(acc[119]),
        "+r"(acc[120]), "+r"(acc[121]), "+r"(acc[122]), "+r"(acc[123]),
        "+r"(acc[124]), "+r"(acc[125]), "+r"(acc[126]), "+r"(acc[127])
      : "l"(da), "l"(db), "r"(accum));
}

// one m64n128k32 s8 x s8 -> s32 product, both operands K-major in
// shared memory; acc[64] is this thread's accumulator fragment
__device__ __forceinline__ void wgmma_s8_m64n128(int* acc, uint64_t da,
                                                 uint64_t db, int accum) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]),
        "+r"(acc[4]), "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]),
        "+r"(acc[8]), "+r"(acc[9]), "+r"(acc[10]), "+r"(acc[11]),
        "+r"(acc[12]), "+r"(acc[13]), "+r"(acc[14]), "+r"(acc[15]),
        "+r"(acc[16]), "+r"(acc[17]), "+r"(acc[18]), "+r"(acc[19]),
        "+r"(acc[20]), "+r"(acc[21]), "+r"(acc[22]), "+r"(acc[23]),
        "+r"(acc[24]), "+r"(acc[25]), "+r"(acc[26]), "+r"(acc[27]),
        "+r"(acc[28]), "+r"(acc[29]), "+r"(acc[30]), "+r"(acc[31]),
        "+r"(acc[32]), "+r"(acc[33]), "+r"(acc[34]), "+r"(acc[35]),
        "+r"(acc[36]), "+r"(acc[37]), "+r"(acc[38]), "+r"(acc[39]),
        "+r"(acc[40]), "+r"(acc[41]), "+r"(acc[42]), "+r"(acc[43]),
        "+r"(acc[44]), "+r"(acc[45]), "+r"(acc[46]), "+r"(acc[47]),
        "+r"(acc[48]), "+r"(acc[49]), "+r"(acc[50]), "+r"(acc[51]),
        "+r"(acc[52]), "+r"(acc[53]), "+r"(acc[54]), "+r"(acc[55]),
        "+r"(acc[56]), "+r"(acc[57]), "+r"(acc[58]), "+r"(acc[59]),
        "+r"(acc[60]), "+r"(acc[61]), "+r"(acc[62]), "+r"(acc[63])
      : "l"(da), "l"(db), "r"(accum));
}

// what one launch of the rank kernel reads and writes
struct RankArgs {
  const float* qscale;      // sq (or 1 / sq for the probe order) [c]
  const float* arow;        // [n]
  const float* x2;          // [n], euclidean only
  const uint8_t* valid;     // [n] or null
  float* out;               // scores: [c, n_out]
  const float* thr;         // candidates: T [c]
  u64* pairs;               // candidates: [c, cap]
  unsigned int* counts;     // candidates: [c]
  const float* tile_x2min;  // candidates: min x2 of each tile (euclidean)
  long long cap;
  long long n;              // store rows
  long long n_out;          // output columns (n, or the sample's rows)
  int step;                 // store tiles between two output tiles
  int c, d, ktiles, euclid, probe_order, mtiles;
  long long tiles;          // mtiles x output store tiles
};

// the reference's score of one product, bit for bit
__device__ __forceinline__ float int8_score(int dot, float a, float x2v,
                                            float qs, int euclid,
                                            int probe_order) {
  const float d = __int2float_rn(dot);
  // knn_rank_int8: dots * (arow / sq); probe: dots * (arow * inv_sq)
  const float scale = probe_order ? __fmul_rn(a, qs) : __fdiv_rn(a, qs);
  const float approx = __fmul_rn(d, scale);
  return euclid ? __fsub_rn(x2v, __fmul_rn(2.0f, approx)) : -approx;
}

// what a consumer thread's two query rows need in the epilogue (sq; for
// the candidates T and the store tile's bounds), loaded before the
// tile's products so the loads' latency hides behind them
struct RowsIn {
  float t[2], sq[2], x2min;
};

__device__ __forceinline__ RowsIn rows_in(const RankArgs& p, int r0,
                                          long long st, bool cand) {
  RowsIn v = {};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = r0 + 8 * h < p.c;
    v.sq[h] = ok ? p.qscale[r0 + 8 * h] : 1.f;
    if (cand) v.t[h] = ok ? p.thr[r0 + 8 * h] : -INFINITY;
  }
  if (cand && p.euclid) v.x2min = p.tile_x2min[st];
  return v;
}

// scores epilogue: one consumer's 64 x (8 NJ) fragment -> out rows
// q0 + warp*16 + lane/4 (+8), output columns col0 + 8j + 2(lane%4) (+1),
// which are store rows row0 + the same offsets
template <int NJ>
__device__ __forceinline__ void epi_scores(const int* acc, const RankArgs& p,
                                           int r0, long long col0,
                                           long long row0, const RowsIn& in,
                                           const float* sa,
                                           const float* sx) {
  const int lane = threadIdx.x & 31;
  const bool ok0 = r0 < p.c, ok1 = r0 + 8 < p.c;
  if (!ok0 && !ok1) return;  // uniform over a warp past the last query
  const float s0 = in.sq[0], s1 = in.sq[1];
  float* o0 = p.out + (long long)r0 * p.n_out;
  float* o1 = o0 + 8LL * p.n_out;
  const int cb = 2 * (lane & 3);
  const bool pairs = (p.n_out & 1) == 0;  // 8-byte aligned column pairs
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int cl = cb + 8 * j;
    const long long col = col0 + cl;
    if (col >= p.n_out) continue;
    const bool two = col + 1 < p.n_out;
    const long long gn = row0 + cl;
    const float a0 = sa[cl], a1 = sa[cl + 1];
    const float x0 = sx[cl], x1 = sx[cl + 1];
    float s00 = int8_score(acc[4 * j], a0, x0, s0, p.euclid, p.probe_order);
    float s10 =
        int8_score(acc[4 * j + 2], a0, x0, s1, p.euclid, p.probe_order);
    float s01 = 0.f, s11 = 0.f;
    if (two) {
      s01 = int8_score(acc[4 * j + 1], a1, x1, s0, p.euclid, p.probe_order);
      s11 = int8_score(acc[4 * j + 3], a1, x1, s1, p.euclid, p.probe_order);
    }
    if (p.valid != nullptr) {
      if (p.valid[gn] == 0) s00 = s10 = INFINITY;
      if (two && p.valid[gn + 1] == 0) s01 = s11 = INFINITY;
    }
    if (pairs && two) {
      if (ok0) __stcs(reinterpret_cast<float2*>(o0 + col),
                      make_float2(s00, s01));
      if (ok1) __stcs(reinterpret_cast<float2*>(o1 + col),
                      make_float2(s10, s11));
    } else {
      if (ok0) {
        __stcs(o0 + col, s00);
        if (two) __stcs(o0 + col + 1, s01);
      }
      if (ok1) {
        __stcs(o1 + col, s10);
        if (two) __stcs(o1 + col + 1, s11);
      }
    }
  }
}

// the cheap score's test: false only when the exact score is above T
// for certain. The cheap score differs from the exact one by under 2^-21
// of |approx| (four roundings against three), plus for euclidean the
// subtraction's two roundings; the margin is 2^-19 of the magnitudes,
// and 1e-30 for underflow. NaN goes on to the exact test.
__device__ __forceinline__ bool maybe_below(float ac, float xv, float t,
                                            int euclid) {
  float sc, mg;
  if (euclid) {
    sc = xv - 2.f * ac;
    mg = fmaf(fabsf(xv) + 2.f * fabsf(ac), 0x1p-19f, 1e-30f);
  } else {
    sc = -ac;
    mg = fmaf(fabsf(ac), 0x1p-19f, 1e-30f);
  }
  return !(sc - mg > t);
}

// the exact test of one value kept by the cheap one: its score's order
// key against T's; a survivor is appended to its query's buffer
__device__ __forceinline__ void exact_candidate(const RankArgs& p, int dot,
                                                float a, float xv, float sq,
                                                uint32_t kt, long long row,
                                                long long r) {
  float sc = int8_score(dot, a, xv, sq, p.euclid, 0);
  if (p.valid != nullptr && p.valid[row] == 0) sc = INFINITY;
  const uint32_t key = order_key(sc);
  if (key > kt) return;
  const unsigned int pos = atomicAdd(&p.counts[r], 1u);
  if ((long long)pos < p.cap)
    p.pairs[r * p.cap + pos] = ((u64)key << 32) | (u64)(uint32_t)row;
}

// values a consumer thread keeps for the exact test per tile; more
// send that thread down the slow path for the tile
constexpr int LCAP = 8;

// The integer floor of a query row's dot products at a store row: a dot
// below it scores above T, exactly. With s = arow / sq the row's scale,
// a dot d >= 0 scores -d s (cosine, dot) or x2 - 2 d s (euclidean), so d
// below R / s, R = -T or (x2min - T) / 2 (x2min the store tile's least
// x2, and R shrunk by 2^-20 of the magnitudes, which covers the final
// rounding), scores above T; a d < 0 then scores at or above 0 or x2, so
// above T too. No floor when R <= 0 (or T is +inf or NaN). R sq per
// query row and ia = (1 - 2^-10) / (arow (1 + 2^-10)) per store row (in
// shared memory, one division per row and tile) give the floor as
// R sq ia: 2^-9 under R / s, which absorbs every rounding on the way.
// It is made an integer at full rate, clamped to [0, 2^22) and one under
// the nearest integer: lower, so it only lets more values through.
__device__ __forceinline__ float row_reach(float t, float sq, float x2min,
                                          int euclid) {
  const float r = euclid ? 0.5f * ((x2min - t) -
                                   0x1p-20f * (fabsf(x2min) + fabsf(t)))
                         : -t;
  return r > 0.f ? r * sq : -1.f;  // -1: no floor
}

__device__ __forceinline__ int dot_floor(float reach, float ia) {
  const float f = fminf(reach * ia, 4194303.f);  // >= 0, or +inf -> cap
  return __float_as_int(f + 12582912.f) - 0x4B400000 - 1;
}

// candidates epilogue: the same fragment (output columns are store
// rows) tested against T of its two query rows. A hot pass rejects most
// values with the integer floor (a multiply and a compare each) and
// notes the rest in the thread's list (shared memory, [LCAP][256
// threads]); one rolled loop then takes the cheap float test and, for
// the few it keeps, the exact one, so the rare code is small and stays
// warm. A thread whose list overflows (T = +inf, or a loose T) tests
// all its values exactly inline instead.
template <int NJ>
__device__ __forceinline__ void epi_candidates(const int* acc,
                                               const RankArgs& p, int r0,
                                               long long col0,
                                               const RowsIn& in,
                                               const float* sa,
                                               const float* sx,
                                               const float* sia, u64* list) {
  const int lane = threadIdx.x & 31;
  const bool ok0 = r0 < p.c, ok1 = r0 + 8 < p.c;
  if (!ok0 && !ok1) return;  // uniform over a warp past the last query
  const long long left = p.n - col0;  // store rows from col0 on
  const int cols = left < BN ? (int)left : BN;
  const int cb = 2 * (lane & 3);
  const float re0 = row_reach(in.t[0], in.sq[0], in.x2min, p.euclid);
  const float re1 = row_reach(in.t[1], in.sq[1], in.x2min, p.euclid);
  // a row past the batch takes nothing; a row with no floor, everything
  const int fix0 = ok0 ? INT_MIN : INT_MAX, fix1 = ok1 ? INT_MIN : INT_MAX;
  const bool fl0 = ok0 && re0 >= 0.f, fl1 = ok1 && re1 >= 0.f;
  u64* mine = list + (threadIdx.x - 128);
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int cl = cb + 8 * j;
    const float2 ia2 = *reinterpret_cast<const float2*>(sia + cl);
    const float ia = fminf(ia2.x, ia2.y);  // the lower floor of the two
    const int l0 = fl0 ? dot_floor(re0, ia) : fix0;
    const int l1 = fl1 ? dot_floor(re1, ia) : fix1;
    // most values fall below the floor
    if (cl >= cols ||
        (acc[4 * j] < l0 && acc[4 * j + 1] < l0 && acc[4 * j + 2] < l1 &&
         acc[4 * j + 3] < l1))
      continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (acc[4 * j + e] >= (e < 2 ? l0 : l1)) {
        if (cnt < LCAP)
          mine[cnt * 256] = (u64)(uint32_t)acc[4 * j + e] |
                            ((u64)(cl + (e & 1)) << 32) |
                            ((u64)(e >> 1) << 40);
        ++cnt;
      }
    }
  }
  if (cnt == 0) return;
  const float i0 = __frcp_rn(in.sq[0]), i1 = __frcp_rn(in.sq[1]);
  const uint32_t k0 = order_key(in.t[0]), k1 = order_key(in.t[1]);
  if (cnt <= LCAP) {
#pragma unroll 1
    for (int i = 0; i < cnt; ++i) {
      const u64 v = mine[i * 256];
      const int c = (int)((v >> 32) & 0xFF);
      const int h = (int)((v >> 40) & 1);
      const int dot = (int)(uint32_t)v;
      if (c >= cols || !(h ? ok1 : ok0)) continue;
      const float a = sa[c], xv = sx[c];
      if (!maybe_below(__int2float_rn(dot) * (a * (h ? i1 : i0)), xv,
                       in.t[h], p.euclid))
        continue;
      exact_candidate(p, dot, a, xv, in.sq[h], h ? k1 : k0, col0 + c,
                      r0 + 8 * h);
    }
    return;
  }
  // the list overflowed: every value of this thread, exactly
  const unsigned int rows_ok = (ok0 ? 3u : 0u) | (ok1 ? 12u : 0u);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int cl = cb + 8 * j;
    if (cl >= cols) continue;
    const bool two = cl + 1 < cols;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!(rows_ok & (1u << e)) || (!two && (e & 1))) continue;
      const int c = cl + (e & 1);
      const int h = e >> 1;
      exact_candidate(p, acc[4 * j + e], sa[c], sx[c], in.sq[h],
                      h ? k1 : k0, col0 + c, r0 + 8 * h);
    }
  }
}

// the 128 threads of one consumer warpgroup meet (named barrier 1 + cw)
__device__ __forceinline__ void consumer_sync(int cw) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
}

// WGM query slabs of 64 a tile (1 when C <= 64, else 2); EPI picks the
// epilogue
template <int WGM, int EPI>
__global__ void __launch_bounds__(RTHREADS, 1)
    rank_int8_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_x,
                     const RankArgs p) {
  constexpr int NACC = WGM == 2 ? 128 : 64;  // s32 accumulators a thread
  constexpr bool CAND = EPI == EPI_CANDIDATES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ __align__(8) uint64_t empty_bar[STAGES];
  // the 128-byte swizzle needs 1024-byte aligned tiles
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // past the ring: each consumer's columns' arow, x2 (fetched while its
  // products run; zeros past the store) and dot-floor factors for the
  // tile in hand; then (candidates) the consumer threads' lists of values
  // for the exact test
  unsigned char* extra = smem_raw + (ring - smem_u32(smem_raw)) + RING_BYTES;
  float(*tile_cols)[3][BN] = reinterpret_cast<float(*)[3][BN]>(extra);
  u64* exact_list = reinterpret_cast<u64*>(extra + COLS_BYTES);
  // broadcast, so the compiler sees the warpgroup index (and all that
  // follows from it) as uniform: wgmma in a branch it takes as divergent
  // is serialised
  const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
  const int tid = threadIdx.x & 127;
  // this block's contiguous stripe of tiles (store tile major)
  const long long t_begin = p.tiles * blockIdx.x / gridDim.x;
  const long long t_end = p.tiles * (blockIdx.x + 1) / gridDim.x;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_bar[s], 1);   // the producer's expect_tx arrival
      mbar_init(&empty_bar[s], 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      // producer: one thread issues every TMA load
      const uint32_t bytes = WGM * 64 * BK + B_BYTES;
      int stage = 0;
      uint32_t phase = 0;
      for (long long t = t_begin; t < t_end; ++t) {
        const int m0 = (int)(t % p.mtiles) * 64 * WGM;
        const int row = (int)((t / p.mtiles) * p.step * BN);
        for (int kt = 0; kt < p.ktiles; ++kt) {
          mbar_wait(&empty_bar[stage], phase ^ 1u);  // slot free
          mbar_expect_tx(&full_bar[stage], bytes);
          const uint32_t slot = ring + stage * STAGE_BYTES;
          tma_load_2d(slot, &tm_q, &full_bar[stage], kt * BK, m0);
          tma_load_2d(slot + A_BYTES, &tm_x, &full_bar[stage], kt * BK, row);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    // this consumer's query rows and store rows inside a tile
    const uint32_t a_off = WGM == 2 ? cw * 64 * BK : 0;
    const uint32_t b_off = A_BYTES + (WGM == 2 ? 0 : cw * 128 * BK);
    const int sub = WGM == 2 ? 0 : cw * 128;
    int acc[NACC];
    int stage = 0;
    uint32_t phase = 0;
    for (long long t = t_begin; t < t_end; ++t) {
      const int q0 = (int)(t % p.mtiles) * 64 * WGM + (WGM == 2 ? cw * 64 : 0);
      const long long st = t / p.mtiles;
      const long long col0 = st * BN + sub;
      const long long row0 = st * p.step * BN + sub;
      // a slab wholly past the last query (C = 65..127) does no products
      // but still takes part in the ring (uniform over the warpgroup)
      const bool active = q0 < p.c;
      // the thread's first fragment row, and (candidates) its rows' T,
      // sq and the tile's bounds, in flight during the products
      const int r0 = q0 + (tid >> 5) * 16 + ((tid & 31) >> 2);
      RowsIn rin = {};
      if (active) rin = rows_in(p, r0, st, CAND);
      float* sa = tile_cols[cw][0];
      float* sx = tile_cols[cw][1];
      float* sia = tile_cols[cw][2];
      if (active) {
        // threads 0-63 fetch arow, 64-127 x2 (euclidean), 16 bytes each
        const int q4 = (tid & 63) * 4;
        const bool is_x2 = tid >= 64;
        if (q4 < NACC * 2 && (!is_x2 || p.euclid)) {
          const long long left = p.n - (row0 + q4);
          const int bytes = left >= 4 ? 16 : (left > 0 ? (int)left * 4 : 0);
          const float* src = is_x2 ? p.x2 : p.arow;
          cp_async16((is_x2 ? sx : sa) + q4,
                     bytes > 0 ? src + row0 + q4 : src, bytes);
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      }
      int prev = 0;
      fence_regs<NACC>(acc);
      for (int kt = 0; kt < p.ktiles; ++kt) {
        mbar_wait(&full_bar[stage], phase);
        if (active) {
          const uint32_t slot = ring + stage * STAGE_BYTES;
          const uint64_t da = sw128_desc(slot + a_off);
          const uint64_t db = sw128_desc(slot + b_off);
          // four k32 slices; past the width they read TMA's zero fill
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 32; ++kk) {
            if constexpr (WGM == 2)
              wgmma_s8_m64n256(acc, da + 2 * kk, db + 2 * kk, kt | kk);
            else
              wgmma_s8_m64n128(acc, da + 2 * kk, db + 2 * kk, kt | kk);
          }
          wgmma_commit();
          // one group stays in flight; the one before it has retired,
          // so its stage goes back to the producer
          wgmma_wait<1>();
          if (kt > 0 && tid == 0) mbar_arrive(&empty_bar[prev]);
        } else if (tid == 0) {
          mbar_arrive(&empty_bar[stage]);
        }
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1u;
        }
      }
      if (active) {
        wgmma_wait<0>();
        fence_regs<NACC>(acc);
        if (tid == 0) mbar_arrive(&empty_bar[prev]);
        asm volatile("cp.async.wait_all;\n" ::: "memory");
      }
      consumer_sync(cw);  // every thread's columns have landed
      if (active) {
        if constexpr (CAND) {
          // each column's factor of the dot floor
          for (int c = tid; c < NACC * 2; c += 128)
            sia[c] = __fdividef(1.f - 0x1p-10f, sa[c] * (1.f + 0x1p-10f));
          consumer_sync(cw);
          epi_candidates<NACC / 4>(acc, p, r0, col0, rin, sa, sx, sia,
                                   exact_list);
        } else {
          epi_scores<NACC / 4>(acc, p, r0, col0, row0, rin, sa, sx);
        }
      }
      consumer_sync(cw);  // the columns are read: the next tile's land
    }
  }
}

template <int WGM, int EPI>
int launch_rank(const CUtensorMap& tmq, const CUtensorMap& tmx,
                const RankArgs& p, cudaStream_t st) {
  const int sms = surreal_sm_count();
  const long long grid = p.tiles < sms ? p.tiles : sms;
  // alignment slack + ring + columns (+ the exact lists)
  constexpr int smem =
      1024 + RING_BYTES + COLS_BYTES +
      (EPI == EPI_CANDIDATES ? LCAP * 256 * (int)sizeof(u64) : 0);
  static SurrealSmemDone smem_done;
  const cudaError_t attr =
      surreal_smem_limit(rank_int8_kernel<WGM, EPI>, smem, &smem_done);
  if (attr != cudaSuccess) return (int)attr;
  rank_int8_kernel<WGM, EPI><<<(unsigned)grid, RTHREADS, smem, st>>>(
      tmq, tmx, p);
  return (int)cudaGetLastError();
}

// quantise the queries (unless qs is null: q8 / qscale already hold
// them), build the tensor maps and launch the epilogue EPI
template <int EPI>
int rank_launch(const int8_t* xs, const float* qs, RankArgs& p, int8_t* q8,
                float* qscale, cudaStream_t st) {
  if (qs != nullptr) {
    quantize_queries_kernel<<<(unsigned)((p.c + 7) / 8), 256, 0, st>>>(
        qs, p.c, p.d, p.probe_order, q8, qscale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int wgm = p.c <= 64 ? 1 : 2;
  CUtensorMap tmq, tmx;
  if (!tensor_map_2d(q8, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.c, p.d,
                     64 * wgm, &tmq) ||
      !tensor_map_2d(xs, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.n, p.d, BN,
                     &tmx))
    return (int)cudaErrorInvalidValue;
  p.qscale = qscale;
  p.ktiles = (p.d + BK - 1) / BK;
  p.mtiles = (p.c + 64 * wgm - 1) / (64 * wgm);
  p.tiles = (long long)p.mtiles * ((p.n_out + BN - 1) / BN);
  return wgm == 1 ? launch_rank<1, EPI>(tmq, tmx, p, st)
                  : launch_rank<2, EPI>(tmq, tmx, p, st);
}

// the shape checks both entries share: TMA takes a 16-byte row pitch,
// 16-byte aligned bases and int32 coordinates; the per-row scales are
// fetched 16 bytes at a time
bool rank_shape_ok(const int8_t* xs, const int8_t* q8, const float* qscale,
                   const float* arow, const float* x2, long long n, int d,
                   int euclid) {
  return d > 0 && d % 16 == 0 && n <= 0x7FFFFFFFLL && arow != nullptr &&
         q8 != nullptr && qscale != nullptr && (!euclid || x2 != nullptr) &&
         (reinterpret_cast<uintptr_t>(xs) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(q8) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(arow) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(x2) & 15) == 0;
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
                                 long long n_out, int tile_step, int c,
                                 int d, int euclid, int probe_order,
                                 void* stream) {
  if (n <= 0 || c <= 0 || n_out <= 0) return (int)cudaSuccess;
  if (!rank_shape_ok(xs, q8, qscale, arow, x2, n, d, euclid) || tile_step < 1)
    return (int)cudaErrorInvalidValue;
  // a strided sample takes whole store tiles inside the store
  if (tile_step == 1 ? n_out != n
                     : (n_out % BN != 0 ||
                        (n_out / BN - 1) * tile_step * BN + BN > n))
    return (int)cudaErrorInvalidValue;
  RankArgs p = {};
  p.arow = arow;
  p.x2 = x2;
  p.valid = valid;
  p.out = out;
  p.n = n;
  p.n_out = n_out;
  p.step = tile_step;
  p.c = c;
  p.d = d;
  p.euclid = euclid;
  p.probe_order = probe_order;
  return rank_launch<EPI_SCORES>(xs, qs, p, q8, qscale,
                                 static_cast<cudaStream_t>(stream));
}

SURREAL_API int rank_candidates_int8(const int8_t* xs, const float* qs,
                                     const float* arow, const float* x2,
                                     const uint8_t* valid, const float* thr,
                                     unsigned long long* pairs,
                                     unsigned int* counts, long long cap,
                                     const float* tile_x2min,
                                     int8_t* q8,
                                     float* qscale, long long n, int c,
                                     int d, int euclid, void* stream) {
  if (n <= 0 || c <= 0) return (int)cudaSuccess;
  if (!rank_shape_ok(xs, q8, qscale, arow, x2, n, d, euclid) ||
      thr == nullptr || pairs == nullptr || counts == nullptr || cap < 1 ||
      (euclid && tile_x2min == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemsetAsync(counts, 0, (size_t)c * sizeof(unsigned int), st);
  if (err != cudaSuccess) return (int)err;
  RankArgs p = {};
  p.arow = arow;
  p.x2 = x2;
  p.valid = valid;
  p.thr = thr;
  p.pairs = pairs;
  p.counts = counts;
  p.tile_x2min = tile_x2min;
  p.cap = cap;
  p.n = n;
  p.n_out = n;
  p.step = 1;
  p.c = c;
  p.d = d;
  p.euclid = euclid;
  p.probe_order = 0;
  return rank_launch<EPI_CANDIDATES>(xs, qs, p, q8, qscale, st);
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
