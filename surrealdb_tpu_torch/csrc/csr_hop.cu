// csr_hop_step: one hop of batched frontier expansion over an edge list.
//
// Replaces surrealdb_tpu/device/csrstore.py:14 _multi_hop_impl (jit at
// :37), whose lax.scan step gathers frontier[:, rows], scatter-adds the
// gathered bits into cols and keeps > 0. Here each thread takes edges
// (grid-stride) and, for every batch row whose frontier holds the
// edge's source, stores 1 to the destination byte of the next frontier.
// A byte store of 1 is idempotent, so concurrent stores to one
// destination need no atomics and the result equals the reference's
// add > 0 bit for bit. When `acc` is given, the same store also marks
// the union of all hop layers, which replaces the reference's OR over
// the scan's stacked layers without a separate pass. The host loops the
// hops (device/csrstore.py), zeroing `next` between them.
//
// Bound on the H100: bytes. A hop reads the two int32 edge arrays once
// (8 bytes an edge: 80 MB at 10M edges, 24 us at 3.35 TB/s) plus the
// frontier bytes it gathers at random and the next-frontier bytes it
// writes; at 1M nodes a batch row's frontier (1 MB) stays in L2.
#include "kernels.h"

namespace {

__global__ void csr_hop_kernel(const int32_t* __restrict__ rows,
                               const int32_t* __restrict__ cols, long long e,
                               const uint8_t* __restrict__ frontier,
                               uint8_t* __restrict__ next,
                               uint8_t* __restrict__ acc, int b,
                               long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < e;
       i += stride) {
    const long long r = rows[i];
    const long long c = cols[i];
    for (int bb = 0; bb < b; ++bb) {
      const long long base = (long long)bb * n;
      if (frontier[base + r]) {
        next[base + c] = 1;
        if (acc != nullptr) acc[base + c] = 1;
      }
    }
  }
}

}  // namespace

SURREAL_API int csr_hop_step(const int32_t* rows, const int32_t* cols,
                             long long e, const uint8_t* frontier,
                             uint8_t* next, uint8_t* acc, int b,
                             long long n, void* stream) {
  if (e <= 0 || b <= 0) return (int)cudaSuccess;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  long long blocks = (e + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;
  csr_hop_kernel<<<(unsigned)blocks, 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(rows, cols, e,
                                                        frontier, next, acc,
                                                        b, n);
  return (int)cudaGetLastError();
}
