// Hopper building blocks shared by the TMA + wgmma kernels
// (rank_rescore.cu, rank_int8.cu): mbarriers, 2-D TMA loads (multicast
// across a thread block cluster too), the cluster's rank, barrier and
// remote arrivals, the 128-byte-swizzle wgmma descriptor, wgmma fences,
// and tensor maps from
// cuTensorMapEncodeTiled through the runtime's driver entry point (no
// -lcuda), cached per (pointer, type, shape, box).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)

#include <mutex>

#include "kernels.h"

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// TMA: the box at (column c0, row c1) of `map` into shared memory at
// `dst`, completing its bytes on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// -- thread block clusters (rank_int8.cu's candidates pass) ----------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster meets (and sees the others'
// shared-memory writes before it, barrier initialisations included)
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

// one arrival on the barrier at `bar`'s offset in block `cta` of the
// cluster (this block's own included). It publishes no data, only that
// this block's wgmma reads of a stage are done, so it keeps the default
// CTA-scope release: a cluster-scope release waits for the thread's
// outstanding memory operations.
__device__ __forceinline__ void mbar_arrive_cta(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(cta)
      : "memory");
}

// TMA multicast: the box at (c0, c1) into shared memory at `dst` of every
// block in `mask`, completing its bytes on the barrier at `bar`'s offset
// in each of them
__device__ __forceinline__ void tma_load_2d_mc(uint32_t dst,
                                               const CUtensorMap* map,
                                               uint64_t* bar, int c0, int c1,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "h"(mask)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile whose 128-byte rows
// TMA wrote with the 128-byte swizzle: 8-row groups 1024 bytes apart
// (stride byte offset), leading byte offset unused by this layout (1),
// layout type 1 = SWIZZLE_128B. The tile base is 1024-byte aligned; a
// 32-byte k-slice inside the row (16 bf16 or 32 int8 columns) starts 32
// bytes further (+2 in the address field).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  });
  return fn;
}

// a row-major [rows, cols] tensor of `dtype` (elem_bytes each) in boxes
// of 128 bytes of columns x box_rows, 128-byte swizzle, zero fill past
// the edges; cached (a map holds only the pointer, the shape and the
// box, so a cached map is always right)
struct MapEntry {
  const void* ptr;
  int dtype;
  long long rows;
  int cols;
  int box_rows;
  CUtensorMap map;
};

inline bool tensor_map_2d(const void* ptr, CUtensorMapDataType dtype,
                          int elem_bytes, long long rows, int cols,
                          int box_rows, CUtensorMap* out) {
  static std::mutex mu;
  static MapEntry cache[32];
  static int used = 0, next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const MapEntry& e = cache[i];
    if (e.ptr == ptr && e.dtype == (int)dtype && e.rows == rows &&
        e.cols == cols && e.box_rows == box_rows) {
      *out = e.map;
      return true;
    }
  }
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  MapEntry e = {ptr, (int)dtype, rows, cols, box_rows, {}};
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem_bytes),
                             (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  if (fn(&e.map, dtype, 2, const_cast<void*>(ptr), dims, strides, box, estr,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  cache[next] = e;
  next = (next + 1) % 32;
  if (used < 32) ++used;
  *out = e.map;
  return true;
}

}  // namespace
