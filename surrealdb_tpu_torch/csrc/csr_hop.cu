// csr_hop_step: one hop of batched frontier expansion over an edge list.
//
// Replaces surrealdb_tpu/device/csrstore.py:14 _multi_hop_impl (jit at
// :37), whose lax.scan step gathers frontier[:, rows], scatter-adds the
// gathered bits into cols and keeps > 0. The host loops the hops
// (device/csrstore.py), zeroing `next` between them; the interface is
// the [B, n] u8 masks, so every caller (multi_hop_masks, the mesh's
// per-slice hop and mask_or_reduce) is unchanged.
//
// Design: one launch sequence on the stream, over a bit-packed frontier
// of W = ceil(B / 32) u32 words a node (bit b % 32 of word b / 32 is
// batch row b):
// 1. pack: one thread a node reads its B frontier bytes (neighbouring
//    threads on neighbouring bytes of each batch row) and writes its W
//    words of the packed frontier, zeroing its W words of the packed
//    next frontier;
// 2. edges: one thread an edge (grid-stride) loads the W words of
//    rows[e] once -- one random 4-byte gather an edge for B <= 32, from
//    a 4 MB array at 1M nodes that stays in L2 -- skips the edge when
//    they are zero, and otherwise ORs them into cols[e]'s words, with an
//    atomic only where the L2 copy of the word lacks a bit (bits are
//    only ever set during the pass, so a word that already holds them
//    needs nothing);
// 3. unpack: one thread a node turns its next words into bytes: a set
//    bit stores 1 to next[b, node] and, when acc is given, to acc[b,
//    node] (the union of all hop layers, the reference's OR over the
//    scan's stacked layers). `next` arrives zeroed, so only set bits are
//    written.
// OR is order-independent, so the masks equal the reference's add > 0
// bit for bit whatever order the atomics run in. The caller hands over
// the 2 n W words of scratch; nothing is allocated here.
//
// Bound on the H100: bytes. A hop reads the two int32 edge arrays once
// (8 bytes an edge: 80 MB at 10M edges, 24 us at 3.35 TB/s) plus the B
// frontier bytes a node and writes the next frontier; the packed words
// (8 n W bytes) and the gathers stay in L2.
#include "kernels.h"

namespace {

__global__ void pack_frontier_kernel(const uint8_t* __restrict__ frontier,
                                     int b, long long n, int w,
                                     uint32_t* __restrict__ fw,
                                     uint32_t* __restrict__ nw) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < n; r += stride) {
    for (int wi = 0; wi < w; ++wi) {
      const int b0 = wi * 32;
      const int b1 = b0 + 32 < b ? b0 + 32 : b;
      uint32_t word = 0;
      for (int bb = b0; bb < b1; ++bb)
        word |= (uint32_t)(frontier[(long long)bb * n + r] != 0) << (bb - b0);
      fw[r * w + wi] = word;
      nw[r * w + wi] = 0u;
    }
  }
}

__global__ void edge_or_kernel(const int32_t* __restrict__ rows,
                               const int32_t* __restrict__ cols, long long e,
                               int w, const uint32_t* __restrict__ fw,
                               uint32_t* __restrict__ nw) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < e;
       i += stride) {
    const long long r = rows[i];
    if (w == 1) {
      const uint32_t f = __ldg(fw + r);
      if (f == 0u) continue;
      uint32_t* dst = nw + cols[i];
      if (f & ~__ldcg(dst)) atomicOr(dst, f);
      continue;
    }
    const long long c = cols[i];
    for (int wi = 0; wi < w; ++wi) {
      const uint32_t f = __ldg(fw + r * w + wi);
      if (f == 0u) continue;
      uint32_t* dst = nw + c * w + wi;
      if (f & ~__ldcg(dst)) atomicOr(dst, f);
    }
  }
}

__global__ void unpack_frontier_kernel(const uint32_t* __restrict__ nw,
                                       int b, long long n, int w,
                                       uint8_t* __restrict__ next,
                                       uint8_t* __restrict__ acc) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < n; r += stride) {
    for (int wi = 0; wi < w; ++wi) {
      uint32_t word = nw[r * w + wi];
      while (word != 0u) {
        const int bb = wi * 32 + __ffs((int)word) - 1;
        word &= word - 1u;
        if (bb >= b) break;
        next[(long long)bb * n + r] = 1;
        if (acc != nullptr) acc[(long long)bb * n + r] = 1;
      }
    }
  }
}

unsigned grid_for(long long items) {
  long long blocks = (items + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

}  // namespace

SURREAL_API int csr_hop_step(const int32_t* rows, const int32_t* cols,
                             long long e, const uint8_t* frontier,
                             uint8_t* next, uint8_t* acc, int b,
                             long long n, uint32_t* words, void* stream) {
  if (b <= 0 || n <= 0) return b <= 0 ? (int)cudaSuccess
                                      : (int)cudaErrorInvalidValue;
  if (words == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = (b + 31) / 32;
  uint32_t* fw = words;
  uint32_t* nw = words + n * w;
  pack_frontier_kernel<<<grid_for(n), 256, 0, s>>>(frontier, b, n, w, fw,
                                                    nw);
  if (e > 0)
    edge_or_kernel<<<grid_for(e), 256, 0, s>>>(rows, cols, e, w, fw, nw);
  unpack_frontier_kernel<<<grid_for(n), 256, 0, s>>>(nw, b, n, w, next,
                                                      acc);
  return (int)cudaGetLastError();
}
