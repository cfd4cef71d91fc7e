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
// rank_scores_bf16 -- out[c, n] = x2[n] - 2 dot (euclidean) or -dot,
// dot = bf16(q_c) . x_n in f32, +inf where valid[n] == 0.
// Bound on the H100: at C = 512, N = 1M, D = 768 the product is
// 2 C N D = 0.81 TFLOP (0.82 ms at 989 TFLOP/s bf16) and the bytes are
// the 1.5 GB bf16 store read plus the 2.1 GB f32 score write (1.07 ms at
// 3.35 TB/s): bytes bound it, and the score write is most of them. At
// C = 1 and 128 the store read alone bounds it (0.46 ms).
// Design (Hopper: TMA + wgmma, warp-specialised, persistent):
// - one persistent block per SM walks output tiles of 64*WGM queries x
//   256 store rows, the query tiles of one 256-row store stripe one after
//   another on neighbouring blocks, so a stripe comes from HBM about once
//   per query chunk and from L2 for the other query tiles;
// - warpgroup 0 is the producer: one thread keeps a 4-stage ring of
//   64-wide k-steps in flight with TMA (both operands K-major, no
//   transpose; 128-byte swizzle, matched by the wgmma descriptors; the
//   tensor maps zero-fill rows past C and N and columns past D, so ragged
//   shapes need no predicated loads), each stage completing on an
//   mbarrier, and gives its registers to the consumers (setmaxnreg);
// - warpgroups 1 and 2 consume: wgmma.mma_async m64nNk16 from shared
//   memory into f32 registers, one group kept in flight, each stage
//   released as soon as its products retire. Queries sit on the wgmma M
//   side and store rows on N, so an accumulator fragment holds pairs of
//   neighbouring store rows, i.e. neighbouring output columns. With
//   C > 64 (WGM = 2) each consumer owns 64 queries x 256 rows (n256);
//   with C <= 64 (WGM = 1) both share the 64 queries and take 128 rows
//   each (n128), so a small batch does not idle half the tensor cores;
// - epilogue: the score and the mask are applied to the fragments in
//   registers and written straight out with evict-first 8-byte stores
//   (a quad of lanes writes one full 32-byte sector of a row, scalar
//   stores where N is odd): no shared-memory staging and no barrier
//   sits between a tile's epilogue and the next tile, whose first
//   k-steps the producer has already loaded. On the H100 the score
//   write still costs about as much again as the products (PERF.md).
// The wrapper rounds the queries to bf16 (the reference's
// qs.astype(bfloat16)); the store width must be a multiple of 8 (a
// 16-byte row pitch for TMA; the vector store pads with zero columns).
// TMA descriptors come from cuTensorMapEncodeTiled through the runtime's
// driver entry point (no -lcuda) and are cached per (pointer, rows,
// width, box); these Hopper pieces are shared with rank_int8.cu
// (hopper.cuh).
//
// gather_rescore -- the exact f32 distance of each query to its kc
// candidate rows, rows indexed by JAX's rule (kernels.h
// surreal_jax_row). Euclidean uses the direct form sqrt(sum (r - q)^2)
// as the reference's rescore does, cosine
// 1 - r.q / max(norm_r * max(|q|, 1e-30), 1e-30), dot -r.q; a masked
// candidate scores +inf. Two outputs from one main loop: the [C, kc]
// distances, or (k > 0) the reference's final lax.top_k fused in: the k
// smallest of a query's kc distances by (value, column), [C, k] values
// (the distance itself, so -0.0 stays -0.0) and ids (cand at the column).
// Bound on the H100: bytes, the C kc D 4 of gathered rows, which are
// not reused (0.0127 ms at C = 512, kc = 26, D = 768).
// Design (a memory-parallel gather):
// - a query's columns are spread over a cluster of G blocks (G from
//   ops/topk.py rescore_plan: several blocks a query when C is small, so
//   a C = 1 frame still has every row in flight at once);
// - a warp scores four rows at a time: every 16-byte piece of those rows
//   is issued at once (cp.async.cg into the lane's own slots of shared
//   memory, L2 only: a row is read once) before the first FMA, so the
//   rows in flight are bounded by shared memory (64 a SM at D = 768),
//   not by the registers that loads in flight would hold (32 a SM when
//   the rows went to registers: 1.37x the bound at C = 512, PERF.md);
//   the ids, norms and masks of the warp's next eight rounds are loaded
//   together; the width is NCH float4 a lane at compile time (wider rows
//   in segments of that), a row not 16-byte aligned (D % 4 != 0) is
//   copied by scalars; the query's slice sits in registers;
// - fused, every block writes its distances into the shared memory of
//   the cluster's first block (st.shared::cluster), which after the
//   cluster barrier sorts (order key << 32 | column) keys (sort.cuh) and
//   writes the first k. Every block computes a column's distance with
//   the same instructions, so both outputs agree bit for bit.
#include "hopper.cuh"
#include "sort.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int BK = 64;        // bf16 columns a k-step: one 128-byte row
constexpr int BN = 256;       // store rows a tile
constexpr int STAGES = 4;     // TMA ring depth
constexpr int A_BYTES = 128 * BK * 2;   // query slot (WGM = 2 fills it)
constexpr int B_BYTES = BN * BK * 2;    // store slot
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int RANK_SMEM = 1024 + STAGES * STAGE_BYTES;  // + alignment
constexpr int RTHREADS = 384;  // producer warpgroup + two consumers

// keeps the compiler from moving accumulator accesses across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(float* acc) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// one m64n256k16 bf16 x bf16 -> f32 product, both operands K-major in
// shared memory; acc[128] is this thread's accumulator fragment
__device__ __forceinline__ void wgmma_m64n256(float* acc, uint64_t da,
                                              uint64_t db, int accum) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
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
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3]),
        "+f"(acc[4]), "+f"(acc[5]), "+f"(acc[6]), "+f"(acc[7]),
        "+f"(acc[8]), "+f"(acc[9]), "+f"(acc[10]), "+f"(acc[11]),
        "+f"(acc[12]), "+f"(acc[13]), "+f"(acc[14]), "+f"(acc[15]),
        "+f"(acc[16]), "+f"(acc[17]), "+f"(acc[18]), "+f"(acc[19]),
        "+f"(acc[20]), "+f"(acc[21]), "+f"(acc[22]), "+f"(acc[23]),
        "+f"(acc[24]), "+f"(acc[25]), "+f"(acc[26]), "+f"(acc[27]),
        "+f"(acc[28]), "+f"(acc[29]), "+f"(acc[30]), "+f"(acc[31]),
        "+f"(acc[32]), "+f"(acc[33]), "+f"(acc[34]), "+f"(acc[35]),
        "+f"(acc[36]), "+f"(acc[37]), "+f"(acc[38]), "+f"(acc[39]),
        "+f"(acc[40]), "+f"(acc[41]), "+f"(acc[42]), "+f"(acc[43]),
        "+f"(acc[44]), "+f"(acc[45]), "+f"(acc[46]), "+f"(acc[47]),
        "+f"(acc[48]), "+f"(acc[49]), "+f"(acc[50]), "+f"(acc[51]),
        "+f"(acc[52]), "+f"(acc[53]), "+f"(acc[54]), "+f"(acc[55]),
        "+f"(acc[56]), "+f"(acc[57]), "+f"(acc[58]), "+f"(acc[59]),
        "+f"(acc[60]), "+f"(acc[61]), "+f"(acc[62]), "+f"(acc[63]),
        "+f"(acc[64]), "+f"(acc[65]), "+f"(acc[66]), "+f"(acc[67]),
        "+f"(acc[68]), "+f"(acc[69]), "+f"(acc[70]), "+f"(acc[71]),
        "+f"(acc[72]), "+f"(acc[73]), "+f"(acc[74]), "+f"(acc[75]),
        "+f"(acc[76]), "+f"(acc[77]), "+f"(acc[78]), "+f"(acc[79]),
        "+f"(acc[80]), "+f"(acc[81]), "+f"(acc[82]), "+f"(acc[83]),
        "+f"(acc[84]), "+f"(acc[85]), "+f"(acc[86]), "+f"(acc[87]),
        "+f"(acc[88]), "+f"(acc[89]), "+f"(acc[90]), "+f"(acc[91]),
        "+f"(acc[92]), "+f"(acc[93]), "+f"(acc[94]), "+f"(acc[95]),
        "+f"(acc[96]), "+f"(acc[97]), "+f"(acc[98]), "+f"(acc[99]),
        "+f"(acc[100]), "+f"(acc[101]), "+f"(acc[102]), "+f"(acc[103]),
        "+f"(acc[104]), "+f"(acc[105]), "+f"(acc[106]), "+f"(acc[107]),
        "+f"(acc[108]), "+f"(acc[109]), "+f"(acc[110]), "+f"(acc[111]),
        "+f"(acc[112]), "+f"(acc[113]), "+f"(acc[114]), "+f"(acc[115]),
        "+f"(acc[116]), "+f"(acc[117]), "+f"(acc[118]), "+f"(acc[119]),
        "+f"(acc[120]), "+f"(acc[121]), "+f"(acc[122]), "+f"(acc[123]),
        "+f"(acc[124]), "+f"(acc[125]), "+f"(acc[126]), "+f"(acc[127])
      : "l"(da), "l"(db), "r"(accum));
}

// one m64n128k16 bf16 x bf16 -> f32 product, both operands K-major in
// shared memory; acc[64] is this thread's accumulator fragment
__device__ __forceinline__ void wgmma_m64n128(float* acc, uint64_t da,
                                              uint64_t db, int accum) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3]),
        "+f"(acc[4]), "+f"(acc[5]), "+f"(acc[6]), "+f"(acc[7]),
        "+f"(acc[8]), "+f"(acc[9]), "+f"(acc[10]), "+f"(acc[11]),
        "+f"(acc[12]), "+f"(acc[13]), "+f"(acc[14]), "+f"(acc[15]),
        "+f"(acc[16]), "+f"(acc[17]), "+f"(acc[18]), "+f"(acc[19]),
        "+f"(acc[20]), "+f"(acc[21]), "+f"(acc[22]), "+f"(acc[23]),
        "+f"(acc[24]), "+f"(acc[25]), "+f"(acc[26]), "+f"(acc[27]),
        "+f"(acc[28]), "+f"(acc[29]), "+f"(acc[30]), "+f"(acc[31]),
        "+f"(acc[32]), "+f"(acc[33]), "+f"(acc[34]), "+f"(acc[35]),
        "+f"(acc[36]), "+f"(acc[37]), "+f"(acc[38]), "+f"(acc[39]),
        "+f"(acc[40]), "+f"(acc[41]), "+f"(acc[42]), "+f"(acc[43]),
        "+f"(acc[44]), "+f"(acc[45]), "+f"(acc[46]), "+f"(acc[47]),
        "+f"(acc[48]), "+f"(acc[49]), "+f"(acc[50]), "+f"(acc[51]),
        "+f"(acc[52]), "+f"(acc[53]), "+f"(acc[54]), "+f"(acc[55]),
        "+f"(acc[56]), "+f"(acc[57]), "+f"(acc[58]), "+f"(acc[59]),
        "+f"(acc[60]), "+f"(acc[61]), "+f"(acc[62]), "+f"(acc[63])
      : "l"(da), "l"(db), "r"(accum));
}

__device__ __forceinline__ float rank_score(float dot, const float* x2,
                                            const uint8_t* valid, int col,
                                            int euclid) {
  float s = euclid ? x2[col] - 2.f * dot : -dot;
  if (valid != nullptr && valid[col] == 0) s = INFINITY;
  return s;
}

// one consumer's 64 x (8 NJ) fragment -> out rows q0 + warp*16 + lane/4
// (+8), columns col0 + 8j + 2(lane%4) (+1)
template <int NJ>
__device__ __forceinline__ void store_tile(const float* acc,
                                           const float* __restrict__ x2,
                                           const uint8_t* __restrict__ valid,
                                           float* __restrict__ out, int n,
                                           int c, int q0, int col0,
                                           int euclid) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int r0 = q0 + warp * 16 + (lane >> 2);
  const bool ok0 = r0 < c, ok1 = r0 + 8 < c;
  float* o0 = out + (long long)r0 * n;
  float* o1 = o0 + 8LL * n;
  const int cb = col0 + 2 * (lane & 3);
  const bool pairs = (n & 1) == 0;  // 8-byte aligned column pairs
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = cb + 8 * j;
    if (col >= n) continue;
    const bool two = col + 1 < n;
    const float s00 = rank_score(acc[4 * j], x2, valid, col, euclid);
    const float s10 = rank_score(acc[4 * j + 2], x2, valid, col, euclid);
    float s01 = 0.f, s11 = 0.f;
    if (two) {
      s01 = rank_score(acc[4 * j + 1], x2, valid, col + 1, euclid);
      s11 = rank_score(acc[4 * j + 3], x2, valid, col + 1, euclid);
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

// WGM query slabs of 64 a tile (1 when C <= 64, else 2)
template <int WGM>
__global__ void __launch_bounds__(RTHREADS, 1)
    rank_scores_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_x,
                       const float* __restrict__ x2,
                       const uint8_t* __restrict__ valid,
                       float* __restrict__ out, int n, int c, int ktiles,
                       int euclid, int mtiles, long long tiles) {
  constexpr int NACC = WGM == 2 ? 128 : 64;  // f32 accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ __align__(8) uint64_t empty_bar[STAGES];
  // the 128-byte swizzle needs 1024-byte aligned tiles
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
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
      const uint32_t bytes = WGM * 64 * BK * 2 + B_BYTES;
      int stage = 0;
      uint32_t phase = 0;
      for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (int)(t % mtiles) * 64 * WGM;
        const int n0 = (int)(t / mtiles) * BN;
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(&empty_bar[stage], phase ^ 1u);  // slot free
          mbar_expect_tx(&full_bar[stage], bytes);
          const uint32_t slot = ring + stage * STAGE_BYTES;
          tma_load_2d(slot, &tm_q, &full_bar[stage], kt * BK, m0);
          tma_load_2d(slot + A_BYTES, &tm_x, &full_bar[stage], kt * BK, n0);
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
    const uint32_t a_off = WGM == 2 ? cw * 64 * BK * 2 : 0;
    const uint32_t b_off = A_BYTES + (WGM == 2 ? 0 : cw * 128 * BK * 2);
    float acc[NACC];
    int stage = 0;
    uint32_t phase = 0;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int q0 = (int)(t % mtiles) * 64 * WGM + (WGM == 2 ? cw * 64 : 0);
      const int col0 = (int)(t / mtiles) * BN + (WGM == 2 ? 0 : cw * 128);
      // a slab wholly past the last query (C = 65..127) does no products
      // but still takes part in the ring (uniform over the warpgroup)
      const bool active = q0 < c;
      int prev = 0;
      fence_regs<NACC>(acc);
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(&full_bar[stage], phase);
        if (active) {
          const uint32_t slot = ring + stage * STAGE_BYTES;
          const uint64_t da = sw128_desc(slot + a_off);
          const uint64_t db = sw128_desc(slot + b_off);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            if constexpr (WGM == 2)
              wgmma_m64n256(acc, da + 2 * kk, db + 2 * kk, kt | kk);
            else
              wgmma_m64n128(acc, da + 2 * kk, db + 2 * kk, kt | kk);
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
      if (!active) continue;
      wgmma_wait<0>();
      fence_regs<NACC>(acc);
      if (tid == 0) mbar_arrive(&empty_bar[prev]);
      store_tile<NACC / 4>(acc, x2, valid, out, n, c, q0, col0, euclid);
    }
  }
}

// gather_rescore's launch: the fused epilogue takes kc <= GR_MAX_KC
constexpr int GR_WARPS = 4;
constexpr int GR_THREADS = 32 * GR_WARPS;
constexpr int GR_ROWS = 4;  // rows a warp stages at once
constexpr int GR_MAX_CLUSTER = 8;
constexpr int GR_MAX_KC = 2048;

struct RescoreArgs {
  const float* xs;
  const float* qs;
  const int32_t* cand;
  const float* norms;
  const uint8_t* valid;
  float* out;        // [c, kc] (k == 0)
  float* out_vals;   // [c, k] (k > 0)
  int32_t* out_ids;  // [c, k]
  long long n;
  int kc, d, metric, k;
};

// the shared-memory float at p, in block `cta` of the cluster
__device__ __forceinline__ void st_cluster_f32(float* p, uint32_t cta,
                                               float v) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "st.shared::cluster.f32 [ra], %2;\n}\n" ::"r"(smem_u32(p)),
      "r"(cta), "f"(v)
      : "memory");
}

// a split cluster barrier: the arrival (no ordering) early, the wait
// once this block is about to write into another block's shared memory
// (every block of the cluster has started by then)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// a lane's piece of a row: float4 (VEC4) or float elements
template <bool VEC4>
struct Piece;
template <>
struct Piece<true> {
  static constexpr int FLOATS = 4;
  float4 v;
  // piece e of a row into shared memory at dst: cp.async, L2 only
  static __device__ __forceinline__ void stage(float* dst, const float* row,
                                               int e) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(row + 4 * e)
                 : "memory");
  }
  __device__ __forceinline__ void staged(const float* p) {
    v = *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ void zero() { v = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ void query(const float* q, int e) {
    v = *reinterpret_cast<const float4*>(q + 4 * e);
  }
  __device__ __forceinline__ float dot(const Piece& q, float acc) const {
    acc = fmaf(v.x, q.v.x, acc);
    acc = fmaf(v.y, q.v.y, acc);
    acc = fmaf(v.z, q.v.z, acc);
    return fmaf(v.w, q.v.w, acc);
  }
  __device__ __forceinline__ float sqdiff(const Piece& q, float acc) const {
    float t = v.x - q.v.x;
    acc = fmaf(t, t, acc);
    t = v.y - q.v.y;
    acc = fmaf(t, t, acc);
    t = v.z - q.v.z;
    acc = fmaf(t, t, acc);
    t = v.w - q.v.w;
    return fmaf(t, t, acc);
  }
};
template <>
struct Piece<false> {
  static constexpr int FLOATS = 1;
  float v;
  static __device__ __forceinline__ void stage(float* dst, const float* row,
                                               int e) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(row + e)
                 : "memory");
  }
  __device__ __forceinline__ void staged(const float* p) { v = *p; }
  __device__ __forceinline__ void zero() { v = 0.f; }
  __device__ __forceinline__ void query(const float* q, int e) { v = q[e]; }
  __device__ __forceinline__ float dot(const Piece& q, float acc) const {
    return fmaf(v, q.v, acc);
  }
  __device__ __forceinline__ float sqdiff(const Piece& q, float acc) const {
    const float t = v - q.v;
    return fmaf(t, t, acc);
  }
};

// the bytes of the fused top k's shared memory (the kc distances, then
// the sort buffer), where the rows' staging begins
__host__ __device__ inline int fused_bytes(int kc, int k) {
  if (k == 0) return 0;
  int m = 32;
  while (m < kc) m <<= 1;
  return ((4 * kc + 15) & ~15) + 8 * m;
}

// grid (G, queries), clusters of G blocks along x: block `rank` of
// query c takes the columns rank, rank + G, ...; a warp GR_ROWS of those
// at a time, every piece of them staged at once by cp.async into the
// warp's slots of shared memory (a lane reads back only what it copied),
// so the rows in flight are bounded by shared memory, not by registers.
// NCH pieces a lane cover 32 NCH pieces of a row a segment.
template <int NCH, bool VEC4>
__global__ void __launch_bounds__(GR_THREADS)
    gather_rescore_kernel(const RescoreArgs a) {
  using P = Piece<VEC4>;
  extern __shared__ __align__(16) unsigned char gsm[];
  float* sd = reinterpret_cast<float*>(gsm);  // fused: the kc distances
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* stage = reinterpret_cast<float*>(gsm + fused_bytes(a.kc, a.k)) +
                 warp * GR_ROWS * 32 * NCH * P::FLOATS;
  const int g = gridDim.x, rank = blockIdx.x;
  const long long c = blockIdx.y;
  const int kc = a.kc, d = a.d;
  const int pieces = VEC4 ? d >> 2 : d;  // a row's pieces
  const int nseg = (pieces + 32 * NCH - 1) / (32 * NCH);
  const float* q = a.qs + c * d;
  const int32_t* cand = a.cand + c * kc;
  if (a.k > 0) cluster_arrive_relaxed();
  P qv[NCH];
  auto load_q = [&](int seg) {
#pragma unroll
    for (int h = 0; h < NCH; ++h) {
      const int e = (seg * NCH + h) * 32 + lane;
      if (e < pieces) qv[h].query(q, e);
      else qv[h].zero();
    }
  };
  // |q| for cosine: every warp the same sum
  float qn = 1.f;
  if (a.metric == M_COSINE) {
    float ss = 0.f;
    for (int seg = 0; seg < nseg; ++seg) {
      load_q(seg);
#pragma unroll
      for (int h = 0; h < NCH; ++h) ss = qv[h].dot(qv[h], ss);
    }
    qn = fmaxf(sqrtf(surreal_warp_sum(ss)), 1e-30f);
  }
  if (nseg == 1) load_q(0);
  if (a.k > 0) cluster_wait();
  const int mine = (kc - rank + g - 1) / g;  // this block's columns
  // the ids, norms and masks of the warp's next 32 / GR_ROWS rounds,
  // one row a lane, loaded together
  long long pid = 0;
  float pnrm = 1.f;
  bool pok = true;
  for (int t0 = warp * GR_ROWS, it = 0; t0 < mine;
       t0 += GR_WARPS * GR_ROWS, ++it) {
    const int sl = (it % (32 / GR_ROWS)) * GR_ROWS;
    if (sl == 0) {
      const int tl = t0 + (lane / GR_ROWS) * GR_WARPS * GR_ROWS +
                     lane % GR_ROWS;
      const bool lv = tl < mine;
      pid = lv ? surreal_jax_row(cand[rank + g * tl], a.n) : 0;
      pnrm = a.metric == M_COSINE && lv ? a.norms[pid] : 1.f;
      pok = a.valid == nullptr || !lv || a.valid[pid] != 0;
    }
    long long row[GR_ROWS];
    float acc[GR_ROWS], nrm[GR_ROWS];
    bool live[GR_ROWS], ok[GR_ROWS];
#pragma unroll
    for (int r = 0; r < GR_ROWS; ++r) {
      live[r] = t0 + r < mine;
      row[r] = __shfl_sync(0xffffffffu, pid, sl + r);
      nrm[r] = __shfl_sync(0xffffffffu, pnrm, sl + r);
      ok[r] = __shfl_sync(0xffffffffu, (int)pok, sl + r) != 0;
      acc[r] = 0.f;
    }
    for (int seg = 0; seg < nseg; ++seg) {
      if (nseg > 1) load_q(seg);
#pragma unroll
      for (int r = 0; r < GR_ROWS; ++r) {
        const float* rp = a.xs + row[r] * d;
#pragma unroll
        for (int h = 0; h < NCH; ++h) {
          const int e = (seg * NCH + h) * 32 + lane;
          if (live[r] && e < pieces)
            P::stage(stage + ((r * NCH + h) * 32 + lane) * P::FLOATS, rp, e);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#pragma unroll
      for (int r = 0; r < GR_ROWS; ++r) {
#pragma unroll
        for (int h = 0; h < NCH; ++h) {
          const int e = (seg * NCH + h) * 32 + lane;
          P x;
          if (live[r] && e < pieces)
            x.staged(stage + ((r * NCH + h) * 32 + lane) * P::FLOATS);
          else
            x.zero();
          acc[r] = a.metric == M_EUCLIDEAN ? x.sqdiff(qv[h], acc[r])
                                           : x.dot(qv[h], acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < GR_ROWS; ++r) {
      const float s = surreal_warp_sum(acc[r]);
      if (!live[r] || lane != 0) continue;
      float dist;
      if (a.metric == M_EUCLIDEAN)
        dist = sqrtf(fmaxf(s, 0.f));
      else if (a.metric == M_COSINE)
        dist = 1.f - s / fmaxf(nrm[r] * qn, 1e-30f);
      else
        dist = -s;
      if (!ok[r]) dist = INFINITY;
      const int col = rank + g * (t0 + r);
      if (a.k == 0) a.out[c * kc + col] = dist;
      else st_cluster_f32(sd + col, 0u, dist);
    }
  }
  if (a.k == 0) return;
  // fused: the cluster's first block holds all kc distances
  cluster_sync();
  if (rank != 0) return;
  const int m0 = kc < 32 ? 32 : kc;
  int m = 32;
  while (m < m0) m <<= 1;
  unsigned long long* buf =
      reinterpret_cast<unsigned long long*>(gsm + ((4 * kc + 15) & ~15));
  for (int j = threadIdx.x; j < m; j += GR_THREADS)
    buf[j] = j < kc ? ((unsigned long long)order_key(sd[j]) << 32) |
                          (unsigned int)j
                    : ~0ull;
  __syncthreads();
  block_sort(buf, m);
  for (int i = threadIdx.x; i < a.k; i += GR_THREADS) {
    const int col = (int)(unsigned int)buf[i];
    a.out_vals[c * a.k + i] = sd[col];
    a.out_ids[c * a.k + i] = cand[col];
  }
}

template <int NCH, bool VEC4>
cudaError_t launch_rescore(const RescoreArgs& a, int c, int g,
                           cudaStream_t st) {
  const int smem = fused_bytes(a.kc, a.k) +
                   GR_WARPS * GR_ROWS * 32 * NCH * Piece<VEC4>::FLOATS * 4;
  static SurrealSmemDone done;
  cudaError_t err =
      surreal_smem_limit(gather_rescore_kernel<NCH, VEC4>, smem, &done);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)g;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(GR_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // grid.y holds at most 65535 queries a launch
  for (int c0 = 0; c0 < c; c0 += 65535) {
    const int cn = c - c0 < 65535 ? c - c0 : 65535;
    RescoreArgs p = a;
    p.qs += (long long)c0 * a.d;
    p.cand += (long long)c0 * a.kc;
    if (a.k == 0) p.out += (long long)c0 * a.kc;
    else {
      p.out_vals += (long long)c0 * a.k;
      p.out_ids += (long long)c0 * a.k;
    }
    cfg.gridDim = dim3((unsigned)g, (unsigned)cn);
    void* args[] = {&p};
    err = cudaLaunchKernelExC(
        &cfg, (const void*)gather_rescore_kernel<NCH, VEC4>, args);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

template <int WGM>
int launch_rank(const CUtensorMap& tmq, const CUtensorMap& tmx,
                const float* x2, const uint8_t* valid, float* out, int n,
                int c, int d, int euclid, cudaStream_t st) {
  const int mtiles = (c + 64 * WGM - 1) / (64 * WGM);
  const long long tiles = (long long)mtiles * ((n + BN - 1) / BN);
  const int sms = surreal_sm_count();
  const long long grid = tiles < sms ? tiles : sms;
  static SurrealSmemDone smem_done;
  const cudaError_t attr =
      surreal_smem_limit(rank_scores_kernel<WGM>, RANK_SMEM, &smem_done);
  if (attr != cudaSuccess) return (int)attr;
  rank_scores_kernel<WGM><<<(unsigned)grid, RTHREADS, RANK_SMEM, st>>>(
      tmq, tmx, x2, valid, out, n, c, (d + BK - 1) / BK, euclid, mtiles,
      tiles);
  return (int)cudaGetLastError();
}

}  // namespace

SURREAL_API int rank_scores_bf16(const void* xs_rank, const void* qs_bf16,
                                 const float* x2, const uint8_t* valid,
                                 float* out, long long n, int c, int d,
                                 int euclid, void* stream) {
  if (n <= 0 || c <= 0) return (int)cudaSuccess;
  // TMA: a 16-byte row pitch and 16-byte aligned bases; int32 coordinates
  if (d <= 0 || d % 8 != 0 || (euclid && x2 == nullptr) ||
      n > 0x7FFFFFFFLL ||
      (reinterpret_cast<uintptr_t>(xs_rank) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(qs_bf16) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int wgm = c <= 64 ? 1 : 2;
  CUtensorMap tmq, tmx;
  if (!tensor_map_2d(qs_bf16, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, c, d,
                     64 * wgm, &tmq) ||
      !tensor_map_2d(xs_rank, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, n, d, BN,
                     &tmx))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return wgm == 1 ? launch_rank<1>(tmq, tmx, x2, valid, out, (int)n, c, d,
                                   euclid, st)
                  : launch_rank<2>(tmq, tmx, x2, valid, out, (int)n, c, d,
                                   euclid, st);
}

SURREAL_API int gather_rescore(const float* xs_full, const float* qs,
                               const int32_t* cand, const float* norms,
                               const uint8_t* valid, float* out,
                               float* out_vals, int32_t* out_ids,
                               long long n, int c, int kc, int d, int k,
                               int metric, int cluster, void* stream) {
  if (c <= 0 || kc <= 0) return (int)cudaSuccess;
  if (n <= 0 || d <= 0 || d > 12288 || cluster < 1 ||
      cluster > GR_MAX_CLUSTER ||
      (metric != M_EUCLIDEAN && metric != M_COSINE && metric != M_DOT) ||
      (metric == M_COSINE && norms == nullptr) || k < 0 ||
      (k == 0 && out == nullptr) ||
      (k > 0 && (k > kc || kc > GR_MAX_KC || out_vals == nullptr ||
                 out_ids == nullptr)))
    return (int)cudaErrorInvalidValue;
  const RescoreArgs a{xs_full, qs, cand, norms, valid, out, out_vals,
                      out_ids, n, kc, d, metric, k};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte rows: float4 pieces, NCH of them a lane for rows up to
  // 1024 wide (wider: segments of 1024); else scalar pieces
  const bool vec4 = d % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(xs_full) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(qs) & 15) == 0;
  cudaError_t err;
  if (!vec4) {
    err = launch_rescore<8, false>(a, c, cluster, st);
  } else {
    switch ((d / 4 + 31) / 32) {
      case 1: err = launch_rescore<1, true>(a, c, cluster, st); break;
      case 2: err = launch_rescore<2, true>(a, c, cluster, st); break;
      case 3: err = launch_rescore<3, true>(a, c, cluster, st); break;
      case 4: err = launch_rescore<4, true>(a, c, cluster, st); break;
      case 5: err = launch_rescore<5, true>(a, c, cluster, st); break;
      case 6: err = launch_rescore<6, true>(a, c, cluster, st); break;
      case 7: err = launch_rescore<7, true>(a, c, cluster, st); break;
      default: err = launch_rescore<8, true>(a, c, cluster, st); break;
    }
  }
  return (int)err;
}
