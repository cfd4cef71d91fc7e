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
// Two epilogues:
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
//
// The candidates pass has its own kernel where a block can hold its
// queries (cand_int8_kernel, the resident route: rows up to 1024 int8
// columns at 128 queries a block; ops/topk.py candidates_plan sizes
// it). Bound on the H100 at C = 512, N = 10M, D = 768: 7.86 TOP of int8
// products (3.97 ms at 1,979 TOP/s) against the 7.7 GB store read (2.29
// ms at 3.35 TB/s): operations. What it does about that:
// - the queries stay in shared memory for the whole pass (128 x D
//   bytes a block, loaded once by TMA in the swizzled K-major layout
//   the wgmma descriptors read), so only store tiles stream;
// - a frame of C > 128 queries runs as clusters of ceil(C / 128) <= 4
//   blocks, one 128-query slab each; a cluster walks a contiguous stripe
//   of 128-row store tiles, every block in the same order, and each
//   16 KB k-step of a tile reaches all of them from one read of L2 (TMA
//   multicast: each block issues a share of its four 32-row boxes). A
//   ring stage is free again only when the consumer of it in every block
//   of the cluster has released it (the empty barriers count one
//   arrival per block, arriving remotely);
// - the two consumer warpgroups take the store tiles in turn, each
//   tile all of the block's queries x 128 rows (two m64n128k32 products
//   a k-slice), and pass the tensor cores to each other through named
//   barriers as soon as their products are issued: one consumer's
//   epilogue runs beside the other's products. While those int8
//   products run, the epilogue's instruction count sets its pace, so it
//   is lean: one compare a value against its row's floor over the
//   thread's columns (no branches), then only the groups of eight values
//   with a value past it leave the registers, by predicated stores at
//   places found by popcounts, into the warp's queue, where the warp
//   tests them together (the cheap float test, then the exact key);
// - survivors take positions from a shared-memory count per query and
//   tile; one global atomicAdd per (query, tile) that has any reserves
//   them in the query's buffer, issued at the end of the tile and used
//   at the consumer's next one, so its latency is hidden (a survivor
//   past the warp's list, the rare loose-T case, takes its own atomic).
// Rows wider than that (the streamed route) take the scores kernel's
// main loop with a candidates epilogue.
//
// Design of the scores kernel (Hopper: TMA + wgmma, warp-specialised,
// persistent), the machinery of rank_rescore.cu's rank_scores_bf16 at 8
// bits:
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
// Bound on the H100: the scores epilogue at C = 16 writes [16, 10M] f32
// beside the store read: bytes.
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

// -- the candidates pass, queries resident ------------------------------------

constexpr int CT_ROWS = 128;              // store rows a consumer tile
constexpr int CT_STAGE = CT_ROWS * BK;    // a k-step of a store tile: 16 KB
constexpr int CT_BOX = 32;                // store rows a TMA box
constexpr int CT_SLAB = 128;              // queries a block holds
constexpr int CT_CLUSTER_MAX = 4;         // blocks a cluster: 512 queries
constexpr int CT_MAX_STAGES = 8;
// a consumer warp's area: its queue of value groups (CT_WQ groups of
// eight values a round), their tags, its survivor list and count
constexpr int CT_WQ = 128;
constexpr int CT_GV = CT_WQ * 32;
constexpr int CT_GM = CT_WQ * 4;
constexpr int CT_SURV = 64;
constexpr int CT_WAREA = CT_GV + CT_GM + CT_SURV * 8 + 16;
// dynamic shared memory besides the queries and the ring: alignment
// slack; per consumer its tile's arow, x2 and mask bytes; the eight
// consumer warps' areas; per query of the slab T, sq, 1 / sq and T's
// key; per consumer and query the tile's survivor count and its
// reserved base in the query's buffer
constexpr int CT_COLS = 3 * CT_ROWS * 4;  // a consumer's columns
constexpr int CT_FIXED = 1024 + 2 * CT_COLS + 8 * CT_WAREA +
                         4 * CT_SLAB * 4 + 2 * 2 * CT_SLAB * 4;
constexpr int CT_SMEM_MAX = 227 * 1024;

struct CandArgs {
  const float* qscale;      // sq [c]
  const float* arow;        // [n]
  const float* x2;          // [n], euclidean only
  const uint8_t* valid;     // [n] or null
  const float* thr;         // T [c]
  u64* pairs;               // [c, cap]
  unsigned int* counts;     // [c]
  const float* tile_x2min;  // least x2 of each 256-row store tile
  long long cap;
  long long n;
  int c, ktiles, euclid, cluster, stages;
  int tiles;                // 128-row store tiles
};

// a value's exact order key (the reference's score, +inf where masked:
// sv holds the tile's mask bytes when the store has a mask)
__device__ __forceinline__ uint32_t cand_key(const CandArgs& p, int dot,
                                             float a, float xv, float sq,
                                             const uint8_t* sv, int c) {
  float sc = int8_score(dot, a, xv, sq, p.euclid, 0);
  if (p.valid != nullptr && sv[c] == 0) sc = INFINITY;
  return order_key(sc);
}

__device__ __forceinline__ void put_pair(const CandArgs& p, long long q,
                                         unsigned int pos, uint32_t key,
                                         long long row) {
  if ((long long)pos < p.cap)
    p.pairs[q * p.cap + pos] = ((u64)key << 32) | (u64)(uint32_t)row;
}

// a warp's survivors of a tile, at their query's reserved base (s_base)
// plus their position among its survivors; the list is emptied
__device__ __forceinline__ void write_survivors(const CandArgs& p,
                                               const u64* surv, int* nsurv,
                                               const unsigned int* s_base,
                                               int slab0, long long row0,
                                               int lane) {
  const int ns = min(*nsurv, CT_SURV);
  for (int x = lane; x < ns; x += 32) {
    const u64 v = surv[x];
    const int ql = (int)(v & 0x7F);
    put_pair(p, slab0 + ql, s_base[ql] + (unsigned int)((v >> 16) & 0xFF),
             (uint32_t)(v >> 32), row0 + (int)((v >> 8) & 0xFF));
  }
  __syncwarp();
  if (lane == 0) *nsurv = 0;
  __syncwarp();
}

// the two consumers' turns at the tensor cores (named barriers 3 and 4;
// 1 and 2 are consumer_sync's)
__device__ __forceinline__ void turn_wait(int cw) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(3 + cw) : "memory");
}

__device__ __forceinline__ void turn_pass(int cw) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - cw) : "memory");
}

// The candidates pass with the queries resident (see the design notes at
// the top). MH query halves of 64 a block (1 when C <= 64). Each block of
// a cluster holds its own 128-query slab in shared memory for the whole
// pass; the cluster walks one contiguous stripe of 128-row store tiles,
// every block in the same order, and each stage of a tile is one TMA
// multicast to all of them (each block issues a share of the stage's four
// 32-row boxes). The two consumer warpgroups take the tiles in turn: a
// consumer's tile is all MH x 64 queries x 128 rows, and the tensor
// cores run one consumer's products while the other runs its epilogue.
template <int MH>
__global__ void __launch_bounds__(RTHREADS, 1)
    cand_int8_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_x,
                     const CandArgs p) {
  constexpr int NACC = 64 * MH;             // s32 accumulators a thread
  constexpr int QSTEP = MH * 64 * BK;       // a k-step of the slab
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[CT_MAX_STAGES];
  __shared__ __align__(8) uint64_t empty_bar[CT_MAX_STAGES];
  __shared__ __align__(8) uint64_t q_bar;
  const uint32_t qres = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = qres + p.ktiles * QSTEP;
  unsigned char* extra =
      smem_raw + (ring - smem_u32(smem_raw)) + p.stages * CT_STAGE;
  float(*tile_cols)[3][CT_ROWS] =
      reinterpret_cast<float(*)[3][CT_ROWS]>(extra);
  unsigned char* warp_area = extra + 2 * CT_COLS;
  float* row_t = reinterpret_cast<float*>(warp_area + 8 * CT_WAREA);
  float* row_sq = row_t + CT_SLAB;
  float* row_inv = row_sq + CT_SLAB;
  uint32_t* row_key = reinterpret_cast<uint32_t*>(row_inv + CT_SLAB);
  unsigned int(*tile_cnt)[2][CT_SLAB] =
      reinterpret_cast<unsigned int(*)[2][CT_SLAB]>(row_key + CT_SLAB);
  // broadcast: the warpgroup index and all that follows are uniform
  const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
  const int tid = threadIdx.x & 127;
  // (also broadcast: values read by asm look divergent to the compiler)
  const int rank = __shfl_sync(0xffffffffu, (int)cluster_rank(), 0);
  const int slab0 = rank * CT_SLAB;  // the block's first query
  // the cluster's stripe of store tiles
  const long long g = cluster_id(), ng = cluster_count();
  const int u_begin =
      __shfl_sync(0xffffffffu, (int)(p.tiles * g / ng), 0);
  const int len = __shfl_sync(
      0xffffffffu, (int)(p.tiles * (g + 1) / ng) - u_begin, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full_bar[s], 1);  // this block's expect_tx arrival
      // the consumer of the stage in every block of the cluster
      mbar_init(&empty_bar[s], p.cluster);
    }
    mbar_init(&q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x < CT_SLAB) {
    const int i = threadIdx.x;
    const bool ok = slab0 + i < p.c;
    const float t = ok ? p.thr[slab0 + i] : -INFINITY;
    const float sq = ok ? p.qscale[slab0 + i] : 1.f;
    row_t[i] = t;
    row_sq[i] = sq;
    row_inv[i] = __frcp_rn(sq);
    row_key[i] = order_key(t);
    tile_cnt[0][0][i] = tile_cnt[1][0][i] = 0;
  }
  // every block's barriers exist before any block signals them
  cluster_sync();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      // producer: the slab once, then every stage of the stripe
      mbar_expect_tx(&q_bar, (uint32_t)(p.ktiles * QSTEP));
      for (int kt = 0; kt < p.ktiles; ++kt)
        tma_load_2d(qres + kt * QSTEP, &tm_q, &q_bar, kt * BK, slab0);
      const uint16_t mask = (uint16_t)((1u << p.cluster) - 1u);
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < len; ++i) {
        const int row = (u_begin + i) * CT_ROWS;
        for (int kt = 0; kt < p.ktiles; ++kt) {
          // free in every block of the cluster
          mbar_wait(&empty_bar[stage], phase ^ 1u);
          mbar_expect_tx(&full_bar[stage], CT_STAGE);
          const uint32_t slot = ring + stage * CT_STAGE;
          for (int b = rank; b < CT_ROWS / CT_BOX; b += p.cluster) {
            if (p.cluster == 1)
              tma_load_2d(slot + b * CT_BOX * BK, &tm_x, &full_bar[stage],
                          kt * BK, row + b * CT_BOX);
            else
              tma_load_2d_mc(slot + b * CT_BOX * BK, &tm_x, &full_bar[stage],
                             kt * BK, row + b * CT_BOX, mask);
          }
          if (++stage == p.stages) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    const int lane = tid & 31;
    // the thread's fragment rows: local query qrow + 64 h + 8 i for its
    // rows e = 2 h + i, and fragment columns cb + 8 j (+1)
    const int qrow = 16 * (tid >> 5) + (lane >> 2);
    const int cb = 2 * (lane & 3);
    float* sa = tile_cols[cw][0];
    float* sx = tile_cols[cw][1];
    const uint8_t* sv = reinterpret_cast<const uint8_t*>(tile_cols[cw][2]);
    unsigned int* s_cnt = tile_cnt[cw][0];
    unsigned int* s_base = tile_cnt[cw][1];
    float t_e[2 * MH], sq_e[2 * MH];
    bool ok_e[2 * MH];
#pragma unroll
    for (int e = 0; e < 2 * MH; ++e) {
      const int ql = qrow + 64 * (e >> 1) + 8 * (e & 1);
      t_e[e] = row_t[ql];
      sq_e[e] = row_sq[ql];
      ok_e[e] = slab0 + ql < p.c;
    }
    // the warp's area: its group queue and tags, survivor list and count
    unsigned char* wa = warp_area + ((threadIdx.x >> 5) - 4) * CT_WAREA;
    int4* gv = reinterpret_cast<int4*>(wa);
    int* gm = reinterpret_cast<int*>(wa + CT_GV);
    u64* surv = reinterpret_cast<u64*>(wa + CT_GV + CT_GM);
    int* nsurv = reinterpret_cast<int*>(wa + CT_GV + CT_GM + CT_SURV * 8);
    if (lane == 0) *nsurv = 0;
    // the reservation in flight: this thread's query's survivor count of
    // the consumer's last tile, its base, and that tile's first row
    unsigned int held = 0, held_base = 0;
    long long held_row0 = 0;
    int acc[NACC];
    mbar_wait(&q_bar, 0);
    for (int i = cw; i < len; i += 2) {
      const long long row0 = (long long)(u_begin + i) * CT_ROWS;
      const long long left = p.n - row0;
      const int cols = left < CT_ROWS ? (int)left : CT_ROWS;
      // the tile's arow (threads 0-31), x2 (32-63) and mask bytes
      // (64-71), 16 bytes each, in flight during the products; zeros
      // past the store
      if (tid < 64 && (tid < 32 || p.euclid)) {
        const int q4 = (tid & 31) * 4;
        const long long l4 = left - q4;
        const int bytes = l4 >= 4 ? 16 : (l4 > 0 ? (int)l4 * 4 : 0);
        const float* src = tid < 32 ? p.arow : p.x2;
        cp_async16((tid < 32 ? sa : sx) + q4,
                   bytes > 0 ? src + row0 + q4 : src, bytes);
      } else if (tid >= 64 && tid < 72 && p.valid != nullptr) {
        const int q16 = (tid - 64) * 16;
        const long long l16 = left - q16;
        const int bytes = l16 >= 16 ? 16 : (l16 > 0 ? (int)l16 : 0);
        cp_async16(tile_cols[cw][2] + q16 / 4,
                   bytes > 0 ? p.valid + row0 + q16 : p.valid, bytes);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      const float x2min = p.euclid ? p.tile_x2min[row0 >> 8] : 0.f;
      // the consumers take the tensor cores in tile order
      if (i > 0) turn_wait(cw);
      const int seq = i * p.ktiles;
      int stage = seq % p.stages;
      uint32_t phase = (uint32_t)(seq / p.stages) & 1u;
      int prev = stage;
      fence_regs<NACC>(acc);
      for (int kt = 0; kt < p.ktiles; ++kt) {
        mbar_wait(&full_bar[stage], phase);
        const uint64_t da = sw128_desc(qres + kt * QSTEP);
        const uint64_t db = sw128_desc(ring + stage * CT_STAGE);
        // four k32 slices; past the width they read TMA's zero fill
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) {
          wgmma_s8_m64n128(acc, da + 2 * kk, db + 2 * kk, kt | kk);
          if constexpr (MH == 2)
            wgmma_s8_m64n128(acc + 64, da + ((64 * BK) >> 4) + 2 * kk,
                             db + 2 * kk, kt | kk);
        }
        wgmma_commit();
        // one group stays in flight; the one before it has retired, so
        // its stage goes back to every block's producer
        wgmma_wait<1>();
        if (kt > 0 && tid < p.cluster) mbar_arrive_cta(&empty_bar[prev], tid);
        prev = stage;
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1u;
        }
      }
      // the other consumer's products queue behind these
      if (i + 1 < len) turn_pass(cw);
      wgmma_wait<0>();
      fence_regs<NACC>(acc);
      if (tid < p.cluster) mbar_arrive_cta(&empty_bar[prev], tid);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      // the previous tile's reservation (issued at its end, long back)
      if (tid < 64 * MH && held > 0) s_base[tid] = held_base;
      consumer_sync(cw);  // every thread's columns have landed
      // ... whose survivors this consumer writes now
      write_survivors(p, surv, nsurv, s_base, slab0, held_row0, lane);

      
      // the hot pass: each value against its row's floor over the
      // thread's 32 columns (from the largest arow among them, so at or
      // below each column's own floor), a compare each, no branches:
      // a bit per value past it (acc index 64h + 4j + e4: bit 2j +
      // (e4 & 1) of word 2h + (e4 >> 1))
      float amax = 0.f;  // the largest arow among the thread's columns
#pragma unroll
      for (int j = 0; j < CT_ROWS / 8; ++j) {
        const float2 a2 = *reinterpret_cast<const float2*>(sa + cb + 8 * j);
        amax = fmaxf(amax, fmaxf(a2.x, a2.y));
      }
      const float iamin =
          __fdividef(1.f - 0x1p-10f, amax * (1.f + 0x1p-10f));
      uint32_t bits[2 * MH];
#pragma unroll
      for (int w = 0; w < 2 * MH; ++w) {
        const float r = row_reach(t_e[w], sq_e[w], x2min, p.euclid);
        // a row past the batch takes nothing; a row with no floor all
        const int lmin = !ok_e[w] ? INT_MAX
                                  : (r >= 0.f ? dot_floor(r, iamin) : INT_MIN);
        const int* a = acc + 64 * (w >> 1) + 2 * (w & 1);
        uint32_t m0 = 0, m1 = 0;  // two chains, for the issue rate
#pragma unroll
        for (int j = 0; j < CT_ROWS / 8; j += 2) {
          m0 |= ((uint32_t)(a[4 * j] >= lmin) << (2 * j)) |
                ((uint32_t)(a[4 * j + 1] >= lmin) << (2 * j + 1));
          m1 |= ((uint32_t)(a[4 * j + 4] >= lmin) << (2 * j + 2)) |
                ((uint32_t)(a[4 * j + 5] >= lmin) << (2 * j + 3));
        }
        bits[w] = m0 | m1;
      }
      
      // The values move out of registers in groups of eight (a 64-query
      // half h and two column pairs: acc[64h + 8jj .. +7], rows +0 / +8
      // x columns 16jj + {0, 1, 8, 9}) with any value past the floor,
      // into the warp's queue in lane order: a group's place is its
      // lane's prefix plus a popcount, so the stores do not wait on each
      // other (each is predicated, not a branch). Rounds of CT_WQ
      // groups; the warp then tests each round's groups together: the
      // cheap float test (tighter than any floor), then the exact key. A
      // survivor takes a position among its query's survivors of this
      // tile (a shared-memory count) and a place in the warp's survivor
      // list.
      uint32_t nz[MH];  // bit 4jj: group (h, jj) has a value past it
      int lane_groups = 0;
#pragma unroll
      for (int h = 0; h < MH; ++h) {
        uint32_t x = bits[2 * h] | bits[2 * h + 1];
        x |= x >> 2;
        x |= x >> 1;
        nz[h] = x & 0x11111111u;
        lane_groups += __popc(nz[h]);
      }
      int pre = lane_groups;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, pre, o);
        if (lane >= o) pre += v;
      }
      const int total = __shfl_sync(0xffffffffu, pre, 31);
      pre -= lane_groups;
      const int wig = tid >> 5;  // the warp in its warpgroup
      for (int done = 0; done < total; done += CT_WQ) {
#pragma unroll
        for (int h = 0; h < MH; ++h) {
          const int base = pre - done + (h == 1 ? __popc(nz[0]) : 0);
#pragma unroll
          for (int jj = 0; jj < CT_ROWS / 16; ++jj) {
            // value bit 4 (j & 1) + 2 (row + 8) + (column + 1)
            const uint32_t lo = bits[2 * h] >> (4 * jj);
            const uint32_t hi = bits[2 * h + 1] >> (4 * jj);
            const uint32_t g = (lo & 3u) | ((hi & 3u) << 2) |
                               ((lo & 12u) << 2) | ((hi & 12u) << 4);
            const int r = base + __popc(nz[h] & ((1u << (4 * jj)) - 1u));
            const int* a = acc + 64 * h + 8 * jj;
            if (g != 0 && (unsigned)r < (unsigned)CT_WQ) {  // predicated
              gv[2 * r] = make_int4(a[0], a[1], a[2], a[3]);
              gv[2 * r + 1] = make_int4(a[4], a[5], a[6], a[7]);
              gm[r] = (lane << 12) | (h << 11) | (jj << 8) | (int)g;
            }
          }
        }
        __syncwarp();
        const int n = min(total - done, CT_WQ);
        for (int x = lane; x < n; x += 32) {
          const int4 v0 = gv[2 * x], v1 = gv[2 * x + 1];
          const int meta = gm[x];
          const int l = meta >> 12;
          const int hq = 16 * wig + (l >> 2) + 64 * ((meta >> 11) & 1);
          const int cl = 2 * (l & 3) + 16 * ((meta >> 8) & 7);
          for (uint32_t g = meta & 255; g != 0; g &= g - 1) {
            const int e8 = __ffs(g) - 1;
            const int4 vv = e8 < 4 ? v0 : v1;
            const int e4 = e8 & 3;
            const int dot =
                e4 == 0 ? vv.x : (e4 == 1 ? vv.y : (e4 == 2 ? vv.z : vv.w));
            const int c = cl + 8 * (e8 >> 2) + (e4 & 1);
            const int ql = hq + 8 * (e4 >> 1);
            if (c >= cols) continue;
            const float a = sa[c], xv = sx[c];
            if (!maybe_below(__int2float_rn(dot) * (a * row_inv[ql]), xv,
                             row_t[ql], p.euclid))
              continue;
            const uint32_t key = cand_key(p, dot, a, xv, row_sq[ql], sv, c);
            if (key > row_key[ql]) continue;
            const int ns = atomicAdd(nsurv, 1);
            if (ns < CT_SURV) {
              const unsigned int pos = atomicAdd(&s_cnt[ql], 1u);
              surv[ns] = ((u64)key << 32) | ((u64)pos << 16) |
                         ((u64)c << 8) | (u64)ql;
            } else {  // the list is full (a loose T): its own atomic
              put_pair(p, slab0 + ql, atomicAdd(&p.counts[slab0 + ql], 1u),
                       key, row0 + c);
            }
          }
        }
        __syncwarp();  // the round's groups are read: the next round's land
      }
      
      
      consumer_sync(cw);
      // one reservation in the query's buffer for the tile's survivors,
      // not waited for: the bases are used at this consumer's next tile
      if (tid < 64 * MH) {
        held = s_cnt[tid];
        s_cnt[tid] = 0;
        if (held > 0) held_base = atomicAdd(&p.counts[slab0 + tid], held);
      }
      held_row0 = row0;
      
      consumer_sync(cw);  // the columns are read: the next tile's land
    }
    // the last tile's survivors
    if (tid < 64 * MH && held > 0) s_base[tid] = held_base;
    consumer_sync(cw);
    write_survivors(p, surv, nsurv, s_base, slab0, held_row0, lane);
  }
  // no block leaves while the cluster's others may still signal its
  // barriers
  cluster_sync();
}

// the cluster count of each (device, kernel, cluster size, shared memory)
// the card can hold at once, asked once
struct ClusterFit {
  int dev, mh, cluster, smem, count;
};

template <int MH>
cudaError_t cand_clusters(cudaLaunchConfig_t* cfg, int cluster, int smem,
                          int* count) {
  static std::mutex mu;
  static ClusterFit fits[32];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const ClusterFit& f = fits[i];
    if (f.dev == dev && f.mh == MH && f.cluster == cluster && f.smem == smem) {
      *count = f.count;
      return cudaSuccess;
    }
  }
  err = cudaOccupancyMaxActiveClusters(
      count, (const void*)cand_int8_kernel<MH>, cfg);
  if (err != cudaSuccess) return err;
  if (*count < 1) return cudaErrorInvalidConfiguration;
  if (used < 32) fits[used++] = {dev, MH, cluster, smem, *count};
  return cudaSuccess;
}

template <int MH>
int launch_cand(const CUtensorMap& tmq, const CUtensorMap& tmx,
                const CandArgs& p, cudaStream_t st) {
  const int smem = CT_FIXED + p.ktiles * MH * 64 * BK + p.stages * CT_STAGE;
  if (smem > CT_SMEM_MAX) return (int)cudaErrorInvalidValue;
  static SurrealSmemDone smem_done;
  cudaError_t err = surreal_smem_limit(cand_int8_kernel<MH>, smem, &smem_done);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(p.cluster * surreal_sm_count()));
  cfg.blockDim = dim3(RTHREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cand_clusters<MH>(&cfg, p.cluster, smem, &clusters);
  if (err != cudaSuccess) return (int)err;
  if (clusters > p.tiles) clusters = p.tiles;
  cfg.gridDim = dim3((unsigned)(clusters * p.cluster));
  CUtensorMap a = tmq, b = tmx;
  CandArgs q = p;
  void* args[] = {&a, &b, &q};
  err = cudaLaunchKernelExC(&cfg, (const void*)cand_int8_kernel<MH>, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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
                                     int d, int euclid, int cluster,
                                     int halves, int stages, void* stream) {
  if (n <= 0 || c <= 0) return (int)cudaSuccess;
  if (!rank_shape_ok(xs, q8, qscale, arow, x2, n, d, euclid) ||
      thr == nullptr || pairs == nullptr || counts == nullptr || cap < 1 ||
      (euclid && tile_x2min == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemsetAsync(counts, 0, (size_t)c * sizeof(unsigned int), st);
  if (err != cudaSuccess) return (int)err;
  if (stages > 0) {
    // the resident route, as ops/topk.py candidates_plan sized it: a
    // cluster of `cluster` blocks of 128 queries (64 when halves = 1)
    if (cluster < 1 || cluster > CT_CLUSTER_MAX || halves < 1 ||
        halves > 2 || (cluster > 1 && halves != 2) ||
        c <= (cluster - 1) * CT_SLAB ||
        c > (cluster - 1) * CT_SLAB + halves * 64 ||
        (reinterpret_cast<uintptr_t>(valid) & 15) != 0 ||
        stages < 2 || stages > CT_MAX_STAGES)
      return (int)cudaErrorInvalidValue;
    CUtensorMap tmq, tmx;
    if (!tensor_map_2d(q8, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, c, d,
                       64 * halves, &tmq) ||
        !tensor_map_2d(xs, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, n, d, CT_BOX,
                       &tmx))
      return (int)cudaErrorInvalidValue;
    CandArgs a = {};
    a.qscale = qscale;
    a.arow = arow;
    a.x2 = x2;
    a.valid = valid;
    a.thr = thr;
    a.pairs = pairs;
    a.counts = counts;
    a.tile_x2min = tile_x2min;
    a.cap = cap;
    a.n = n;
    a.c = c;
    a.ktiles = (d + BK - 1) / BK;
    a.euclid = euclid;
    a.cluster = cluster;
    a.stages = stages;
    a.tiles = (int)((n + CT_ROWS - 1) / CT_ROWS);
    return halves == 1 ? launch_cand<1>(tmq, tmx, a, st)
                       : launch_cand<2>(tmq, tmx, a, st);
  }
  // the streamed route (rows too wide for a block to hold its queries):
  // the scores kernel's main loop with the candidates epilogue
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
