// Shared pieces of the exact top-k scan kernels (topk_scan.cu).
//
// Selection keeps, per query, a candidate list in shared memory together
// with a threshold: the k-th best (score, id) pair seen at the last
// compaction.  A scored row enters the list only if it beats the
// threshold; when the list could overflow, one block-wide bitonic sort
// keeps its best k and raises the threshold.  After the first few tiles
// almost no row beats it, so selection costs one compare per scored row
// instead of the K rounds of max/argmax per tile that the TPU kernel runs.
//
// Order everywhere is (score descending, id ascending): ties break toward
// the lower corpus row id, as lax.top_k does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace topk {

constexpr int kThreads = 256;      // threads per block
constexpr int kRows = 256;         // corpus rows per tile
constexpr int kDenseChunk = 32;    // dense columns staged in shared memory per pass
constexpr int kSparseChunk = 8;    // COO slots staged in shared memory per pass

// Position of corpus value (column c, row r) in the transposed dense chunk
// [kDenseChunk][kRows].  Groups of 4 rows stay contiguous (one 16-byte
// read gives a thread its 4 rows); the group index is XORed with the
// column's quad so that the transposing stores hit 32 distinct banks.
__device__ __forceinline__ int swizzle(int c, int r) {
  return c * kRows + 4 * ((r >> 2) ^ ((c >> 2) & 7)) + (r & 3);
}
constexpr float kNeg = -3.402823466e+38f;   // f32 min: the mask for rows >= n_valid
constexpr int kSentinelId = 0x7fffffff;     // empty slot: (-inf, kSentinelId)

__device__ __forceinline__ bool better(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Block-wide bitonic sort of s/id[0, size), best first; size is a power of
// two.  Every thread of the block must call it.
__device__ inline void sort_best_first(float* s, int* id, int size) {
  for (int len = 2; len <= size; len <<= 1) {
    for (int stride = len >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < size / 2; p += blockDim.x) {
        const int lo = 2 * stride * (p / stride) + (p % stride);
        const int hi = lo + stride;
        const bool best_first = (lo & len) == 0;
        const float s_lo = s[lo], s_hi = s[hi];
        const int i_lo = id[lo], i_hi = id[hi];
        if (better(s_hi, i_hi, s_lo, i_lo) == best_first) {
          s[lo] = s_hi; s[hi] = s_lo;
          id[lo] = i_hi; id[hi] = i_lo;
        }
      }
      __syncthreads();
    }
  }
}

// One query's candidate list: buf slots, cnt of them in use, and the
// threshold a new candidate must beat.
struct Cands {
  float* s;
  int* id;
  int* cnt;
  float* th_s;
  int* th_i;
};

__device__ inline void init_cands(const Cands& c) {
  *c.cnt = 0;
  *c.th_s = -INFINITY;
  *c.th_i = kSentinelId;
}

// Sort the list, keep its best k (empty slots sort last as sentinels) and
// raise the threshold to the k-th.  Block-wide; call with the block in step.
__device__ inline void compact(const Cands& c, int buf, int k) {
  const int used = *c.cnt;
  for (int p = used + threadIdx.x; p < buf; p += blockDim.x) {
    c.s[p] = -INFINITY;
    c.id[p] = kSentinelId;
  }
  __syncthreads();
  sort_best_first(c.s, c.id, buf);
  if (threadIdx.x == 0) {
    *c.cnt = k;
    *c.th_s = c.s[k - 1];
    *c.th_i = c.id[k - 1];
  }
  __syncthreads();
}

__device__ __forceinline__ void offer(const Cands& c, float score, int row) {
  if (better(score, row, *c.th_s, *c.th_i)) {
    const int p = atomicAdd(c.cnt, 1);
    c.s[p] = score;
    c.id[p] = row;
  }
}

}  // namespace topk
