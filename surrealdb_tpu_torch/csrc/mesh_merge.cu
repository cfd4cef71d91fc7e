// The two merges of mesh execution, on the device that gathers the
// shards' partials.
//
// merge_partials_topk replaces the all_gather + lax.top_k +
// take_along_axis merge of surrealdb_tpu/device/mesh.py:203-205
// (_vec_exact_jit), :254-256 (_vec_int8_jit), :481-483 (_ann_jit) and
// surrealdb_tpu/parallel/mesh.py:120-123 (_rank_rescore_shard, whose
// rescored partials are unsorted) and the cross-shard top_k that XLA
// inserts for parallel/mesh.py:62 _sharded_knn_impl. Each shard s
// hands a [B, w_s] tile of (dist, local id); the answer for row r is
// the k_out smallest of the S w entries by (order key of dist, position
// in the concatenation of the shards in ascending order) -- lax.top_k's
// tie rule over the all_gather -- with ids globalised as
// min(local + base_s, id_max). A shard with fewer rows than the local
// k (w_s < w) stands for the reference's padding rows: columns w_s..w-1
// are (+inf, local id = the column), as the reference's zero-padded
// slice ranks them.
//
// Design: one block per row. The S w (key, position) pairs are packed
// into u64 words and sorted by a bitonic network in shared memory
// (S w <= 16384: 128 KB, inside Hopper's 227 KB; the path's largest
// tile is 4 x 1280), or in a device scratch slice the wrapper allocates
// past that; the first k_out words name the winners, read back from the
// partials. Any order of the partials is accepted.
// Bound on the H100: bytes (the B S w dists read once, the ids of the
// B k_out winners read, the B k_out pairs written); the tiles are
// small, so one launch is mostly latency.
//
// mask_or_reduce replaces `psum(part, MESH_AXIS) > 0` of
// surrealdb_tpu/device/mesh.py:733-737 (_csr_jit): each shard's hop
// writes a [B, n] byte mask of the nodes its edge slice reaches, and
// the next frontier is their OR (the reference sums non-negative counts
// and tests > 0: the same bits). The union accumulator of a multi-hop
// (`layers.any(axis=0)`) is fused: acc |= next. A grid-stride pass over
// 16-byte words (uint4 loads of every mask) with a byte tail. Bound:
// bytes, S + 1 (+2 with acc) passes over B n bytes.
#include "kernels.h"

namespace {

constexpr int MTHREADS = 512;

struct MergeParts {
  const float* dist[SURREAL_MERGE_MAX_PARTS];
  const int32_t* ids[SURREAL_MERGE_MAX_PARTS];
  long long base[SURREAL_MERGE_MAX_PARTS];
  int width[SURREAL_MERGE_MAX_PARTS];
};

struct MaskParts {
  const uint8_t* mask[SURREAL_MERGE_MAX_PARTS];
};

__device__ __forceinline__ uint32_t order_key(float f) {
  if (f == 0.0f) f = 0.0f;  // -0.0 -> +0.0, as select_topk_rows keys it
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// bitonic sort of buf[0:m] ascending (m a power of two) in shared or
// device memory (__syncthreads orders the block's global accesses too)
template <typename P>
__device__ __forceinline__ void bitonic_sort(P buf, int m) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  for (int size = 2; size <= m; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < m; i += nthreads) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long a = buf[i], b = buf[j];
          const bool up = (i & size) == 0;
          if ((a > b) == up) {
            buf[i] = b;
            buf[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

template <bool kShared>
__global__ void __launch_bounds__(MTHREADS)
    merge_kernel(MergeParts parts, int nparts, int w, int m, int k_out,
                 long long id_max, float* __restrict__ out_dist,
                 int32_t* __restrict__ out_ids,
                 unsigned long long* __restrict__ scratch,
                 long long scratch_ld) {
  extern __shared__ __align__(16) unsigned long long sbuf[];
  const int r = blockIdx.x;
  unsigned long long* buf =
      kShared ? sbuf : scratch + (long long)r * scratch_ld;
  const int total = nparts * w;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    unsigned long long word = ~0ull;  // past the entries: sorts last
    if (i < total) {
      const int s = i / w, j = i % w;
      const int ws = parts.width[s];
      const float v =
          j < ws ? parts.dist[s][(long long)r * ws + j] : INFINITY;
      word = ((unsigned long long)order_key(v) << 32) | (unsigned int)i;
    }
    buf[i] = word;
  }
  __syncthreads();
  bitonic_sort(buf, m);
  for (int t = threadIdx.x; t < k_out; t += blockDim.x) {
    const int pos = (int)(buf[t] & 0xffffffffu);
    const int s = pos / w, j = pos % w;
    const int ws = parts.width[s];
    float v = INFINITY;
    long long loc = j;  // a padding column: its own position
    if (j < ws) {
      const long long at = (long long)r * ws + j;
      v = parts.dist[s][at];
      loc = parts.ids[s][at];
    }
    long long gid = loc + parts.base[s];
    if (gid > id_max) gid = id_max;
    out_dist[(long long)r * k_out + t] = v;
    out_ids[(long long)r * k_out + t] = (int32_t)gid;
  }
}

template <bool kVec>
__global__ void mask_or_kernel(MaskParts parts, int nparts, long long nbytes,
                               uint8_t* __restrict__ out,
                               uint8_t* __restrict__ acc) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (kVec) {
    const long long words = nbytes >> 4;
    for (long long i = start; i < words; i += stride) {
      uint4 v = reinterpret_cast<const uint4*>(parts.mask[0])[i];
      for (int s = 1; s < nparts; ++s) {
        const uint4 u = reinterpret_cast<const uint4*>(parts.mask[s])[i];
        v.x |= u.x;
        v.y |= u.y;
        v.z |= u.z;
        v.w |= u.w;
      }
      reinterpret_cast<uint4*>(out)[i] = v;
      if (acc != nullptr) {
        uint4 a = reinterpret_cast<uint4*>(acc)[i];
        a.x |= v.x;
        a.y |= v.y;
        a.z |= v.z;
        a.w |= v.w;
        reinterpret_cast<uint4*>(acc)[i] = a;
      }
    }
    done = words << 4;
  }
  for (long long i = done + start; i < nbytes; i += stride) {
    uint8_t v = 0;
    for (int s = 0; s < nparts; ++s) v |= parts.mask[s][i];
    out[i] = v;
    if (acc != nullptr) acc[i] |= v;
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      count = 132;
  }
  return count;
}

}  // namespace

SURREAL_API int merge_partials_topk(const float* const* dists,
                                    const int32_t* const* ids,
                                    const long long* bases,
                                    const int* widths, int parts, int b,
                                    int w, int k_out, long long id_max,
                                    float* out_dist, int32_t* out_ids,
                                    unsigned long long* scratch,
                                    long long scratch_ld, void* stream) {
  if (b <= 0) return (int)cudaSuccess;
  if (parts <= 0 || parts > SURREAL_MERGE_MAX_PARTS || w <= 0 ||
      k_out <= 0 || (long long)parts * w < k_out ||
      (long long)parts * w > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  MergeParts mp = {};
  for (int s = 0; s < parts; ++s) {
    if (widths[s] < 0 || widths[s] > w ||
        (widths[s] > 0 && (dists[s] == nullptr || ids[s] == nullptr)))
      return (int)cudaErrorInvalidValue;
    mp.dist[s] = dists[s];
    mp.ids[s] = ids[s];
    mp.base[s] = bases[s];
    mp.width[s] = widths[s];
  }
  const int total = parts * w;
  int m = 1;
  while (m < total) m <<= 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= SURREAL_MERGE_SMEM_KEYS) {
    const int smem = m * (int)sizeof(unsigned long long);
    static SurrealSmemDone smem_done;
    auto* kernel = merge_kernel<true>;
    const cudaError_t attr = surreal_smem_limit(kernel, smem, &smem_done);
    if (attr != cudaSuccess) return (int)attr;
    merge_kernel<true><<<(unsigned)b, MTHREADS, (size_t)smem, st>>>(
        mp, parts, w, m, k_out, id_max, out_dist, out_ids, nullptr, 0);
  } else {
    if (scratch == nullptr || scratch_ld < m)
      return (int)cudaErrorInvalidValue;
    merge_kernel<false><<<(unsigned)b, MTHREADS, 0, st>>>(
        mp, parts, w, m, k_out, id_max, out_dist, out_ids, scratch,
        scratch_ld);
  }
  return (int)cudaGetLastError();
}

SURREAL_API int mask_or_reduce(const uint8_t* const* masks, int parts,
                               long long nbytes, uint8_t* out,
                               uint8_t* acc, void* stream) {
  if (nbytes <= 0) return (int)cudaSuccess;
  if (parts <= 0 || parts > SURREAL_MERGE_MAX_PARTS || out == nullptr)
    return (int)cudaErrorInvalidValue;
  MaskParts mp = {};
  bool aligned =
      (reinterpret_cast<uintptr_t>(out) & 15) == 0 &&
      (acc == nullptr || (reinterpret_cast<uintptr_t>(acc) & 15) == 0);
  for (int s = 0; s < parts; ++s) {
    if (masks[s] == nullptr) return (int)cudaErrorInvalidValue;
    mp.mask[s] = masks[s];
    aligned = aligned && (reinterpret_cast<uintptr_t>(masks[s]) & 15) == 0;
  }
  const int threads = 256;
  long long blocks = ((nbytes >> 4) + threads - 1) / threads;
  const long long cap = 8LL * sm_count();
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (aligned)
    mask_or_kernel<true><<<(unsigned)blocks, threads, 0, st>>>(
        mp, parts, nbytes, out, acc);
  else
    mask_or_kernel<false><<<(unsigned)blocks, threads, 0, st>>>(
        mp, parts, nbytes, out, acc);
  return (int)cudaGetLastError();
}
