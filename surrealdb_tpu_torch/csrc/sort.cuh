// A block's ascending sort of 64-bit keys and the order key of an f32
// value, shared by select.cu and rank_rescore.cu's fused top k. The sort
// is a bitonic network whose stages of stride below 32 run in registers
// within a warp (one key a lane, exchanged by shuffles), so shared memory
// and a __syncthreads are needed only at strides of 32 and up: for 2048
// keys, 21 shared stages and 7 register passes instead of 66 shared
// stages.
#pragma once

#include "kernels.h"

namespace {

// the key a lane keeps after the compare-exchange at `stride` (< 32) of
// a network whose pair is ascending when `up`
__device__ __forceinline__ unsigned long long sort_exchange(
    unsigned long long x, int lane, int stride, bool up) {
  const unsigned long long y = __shfl_xor_sync(0xffffffffu, x, stride);
  const bool low = (lane & stride) == 0;
  const unsigned long long lo = x < y ? x : y, hi = x < y ? y : x;
  return low == up ? lo : hi;
}

// buf[0:m] ascending, m a power of two >= 32; buf in shared memory, or a
// block's own slice of device memory (__syncthreads orders the block's
// global accesses as well). Every thread of the block calls it.
__device__ void block_sort(unsigned long long* buf, int m) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int warps = nt >> 5;
  // sizes 2..32: each 32-key group in one warp's registers
  for (int base = (tid >> 5) << 5; base < m; base += warps << 5) {
    const int i = base + lane;
    unsigned long long x = buf[i];
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
      const bool up = (i & size) == 0;
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1)
        x = sort_exchange(x, lane, stride, up);
    }
    buf[i] = x;
  }
  __syncthreads();
  for (int size = 64; size <= m; size <<= 1) {
    // strides of 32 and up: through memory, one pair a thread at a time
    for (int stride = size >> 1; stride >= 32; stride >>= 1) {
      for (int p = tid; p < (m >> 1); p += nt) {
        const int i = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
        const int j = i + stride;
        const unsigned long long a = buf[i], b = buf[j];
        if ((a > b) == ((i & size) == 0)) {
          buf[i] = b;
          buf[j] = a;
        }
      }
      __syncthreads();
    }
    // strides 16..1: each 32-key group in registers again
    for (int base = (tid >> 5) << 5; base < m; base += warps << 5) {
      const int i = base + lane;
      const bool up = (i & size) == 0;
      unsigned long long x = buf[i];
#pragma unroll
      for (int stride = 16; stride > 0; stride >>= 1)
        x = sort_exchange(x, lane, stride, up);
      buf[i] = x;
    }
    __syncthreads();
  }
}

// the order-preserving uint32 of an f32 value (-0.0 and +0.0 share one;
// NaN after +inf)
__device__ __forceinline__ uint32_t order_key(float f) {
  if (f == 0.0f) f = 0.0f;  // -0.0 -> +0.0
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

}  // namespace
