// Shared pieces of the exact top-k scan kernels (topk_scan.cu).
//
// Selection keeps, per query, a candidate list in shared memory together
// with a threshold: the k-th best (key, id) pair seen at the last
// compaction.  A scored row enters the list only if it beats the
// threshold; when the list could overflow, one block-wide bitonic sort
// keeps its best k and raises the threshold.  After the first few tiles
// almost no row beats it, so selection costs one compare per scored row
// instead of the K rounds of max/argmax per tile that the TPU kernel runs.
//
// Order everywhere is lax.top_k's (order_key below, then id ascending):
// ties break toward the lower corpus row id.  The lists hold each score's
// order key, so that a step of the threshold test or of the sort is one
// integer compare.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace topk {

constexpr int kThreads = 256;      // threads per block
constexpr int kRows = 256;         // corpus rows per tile
constexpr int kDenseChunk = 32;    // dense columns staged in shared memory per pass
constexpr int kSparseChunk = 16;   // COO slots staged in shared memory per pass

// Position of corpus value (column c, row r) in the transposed dense chunk
// [kDenseChunk][ROWS].  Groups of 4 rows stay contiguous (one 16-byte
// read gives a thread its 4 rows); the group index is XORed with the
// column's quad so that the transposing stores hit 32 distinct banks.
template <int ROWS = kRows>
__device__ __forceinline__ int swizzle(int c, int r) {
  static_assert(ROWS % 32 == 0, "the XOR stays inside a row");
  return c * ROWS + 4 * ((r >> 2) ^ ((c >> 2) & 7)) + (r & 3);
}

constexpr float kNeg = -3.402823466e+38f;   // f32 min: the mask for rows >= n_valid
constexpr int kSentinelId = 0x7fffffff;     // empty slot: (key 0, kSentinelId)

// The order of scores on every exact path, lax.top_k's: the total order
// of the f32 bit patterns, so +0 ranks above -0, a NaN with the sign bit
// clear above +inf and one with it set below -inf, NaNs by their bits
// (the card's arithmetic makes NaN 0x7fffffff; negated, 0xffffffff).
// order_key maps a score to an unsigned integer in that order.
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ unsigned order_key(unsigned key) { return key; }   // already a key
// order_key's inverse
__device__ __forceinline__ float from_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The score with order_key 0 (the NaN of all bits set), below every
// other: it fills empty slots.
__device__ __forceinline__ float lowest() { return __uint_as_float(0xffffffffu); }

// (key descending, id ascending): ties break toward the lower corpus row id.
__device__ __forceinline__ bool ahead(unsigned ka, int ia, unsigned kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// COO slots [j, j + 4) of one row: ids, and values as f32, read once
// (streaming loads).  `vec`: 16-byte id and 16- (f32) or 8-byte (bf16)
// value alignment with nnz % 4 == 0; otherwise scalar loads of the slots
// below nnz (the others read as id 0, value 0).
__device__ __forceinline__ float4 stream4(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 stream4(const __nv_bfloat16* p) {
  const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
template <typename TV>
__device__ __forceinline__ void load_slots4(const int* idx, const TV* val, int j, int nnz, bool vec,
                                            int4& id, float4& v) {
  if (vec) {
    id = __ldcs(reinterpret_cast<const int4*>(idx + j));
    v = stream4(val + j);
    return;
  }
  id = make_int4(0, 0, 0, 0);
  v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (j < nnz) { id.x = idx[j]; v.x = to_f32(val[j]); }
  if (j + 1 < nnz) { id.y = idx[j + 1]; v.y = to_f32(val[j + 1]); }
  if (j + 2 < nnz) { id.z = idx[j + 2]; v.z = to_f32(val[j + 2]); }
  if (j + 3 < nnz) { id.w = idx[j + 3]; v.w = to_f32(val[j + 3]); }
}

// The query-term index of one group of queries (built by index_kernel_bits
// and index_kernel_rows below, which kernels/query_index.py launches): one 8-byte word
// per 32 term ids, x the presence bits (a term is present when any query of
// the group holds a nonzero or non-finite value for it), y the compact
// table row of the word's first present term (1 + the present terms before
// it).  The compact table [vocab + 2, group] holds the present columns in
// term order from row 1; row 0 stands for every absent term, whose column
// is zero for every query of the group.
constexpr int kWordsSmemCap = 32768;   // bytes of index words a block stages in shared memory

// Compact-table row of term `id` for one group, 0 when the group does not
// hold it.  Ids outside [0, vocab] index as repro's qdensified[:, c_idx]:
// a negative id counts from the end of the vocab + 1 columns once, then
// ids clamp to [0, vocab].  `words` may point to shared or to global
// memory.
__device__ __forceinline__ int index_row(const uint2* words, int vocab, int id) {
  if (id < 0) id += vocab + 1;
  const unsigned u = static_cast<unsigned>(min(max(id, 0), vocab));
  const uint2 w = words[u >> 5];
  const unsigned bit = 1u << (u & 31);
  return (w.x & bit) ? static_cast<int>(w.y) + __popc(w.x & (bit - 1)) : 0;
}

// Stage four consecutive slots [c, c + 4) of one tile row, real of them
// below nnz, as the row's hit lists for NG query groups (group h's index
// words at words + h * nw, its list at rows / vals + h * list_stride).
// The slots that need a multiply-add go, in slot order, to rows[0, n)
// (compact-table rows) and vals[0, n): the hits, and the misses whose
// value is not finite (0 * inf and 0 * NaN are NaN; row 0 of the compact
// table is zero).  A skipped miss adds fmaf(0, v, acc) = acc, so sums over
// the list equal the sums over every slot bit for bit (an accumulator that
// starts at +0 never becomes -0).  rows[kSparseChunk] receives n.  The
// row's four threads are consecutive lanes, lane % 4 giving c / 4; they
// scan their counts, all groups' packed in one word, together, so every
// lane of the warp calls this at once.
template <int NG>
__device__ __forceinline__ void stage_hits(const uint2* words, int nw, int vocab, const int4& id,
                                           const float4& v, int real, int* rows, float* vals,
                                           int list_stride) {
  static_assert(kSparseChunk == 16 && NG <= 4, "four lanes stage a row's chunk; 8-bit counts");
  const int ids[4] = {id.x, id.y, id.z, id.w};
  const float vs[4] = {v.x, v.y, v.z, v.w};
  int row[NG][4];
  unsigned mask[NG];
#pragma unroll
  for (int h = 0; h < NG; ++h) mask[h] = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool poison = !isfinite(vs[k]);
#pragma unroll
    for (int h = 0; h < NG; ++h) {
      row[h][k] = index_row(words + h * nw, vocab, ids[k]);
      if (k < real && (row[h][k] != 0 || poison)) mask[h] |= 1u << k;
    }
  }
  unsigned n = 0;
#pragma unroll
  for (int h = 0; h < NG; ++h) n |= static_cast<unsigned>(__popc(mask[h])) << (8 * h);
  const int sub = threadIdx.x & 3;
  unsigned upto = n;   // hits of this lane and the lanes before it in the row, per group
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, upto, off, 4);
    if (sub >= off) upto += y;
  }
#pragma unroll
  for (int h = 0; h < NG; ++h) {
    const int end = (upto >> (8 * h)) & 255;
    int pos = end - __popc(mask[h]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (mask[h] >> k & 1) {
        rows[h * list_stride + pos] = row[h][k];
        vals[h * list_stride + pos] = vs[k];
        ++pos;
      }
    }
    if (sub == 3) rows[h * list_stride + kSparseChunk] = end;
  }
}

// Index words per group: ceil((vocab + 1) / 32).
__host__ __device__ inline int index_words(int vocab) { return vocab / 32 + 1; }

constexpr int kIndexThreads = 512;
constexpr int kIndexWords = kIndexThreads / 32;   // index words per block, one warp each

// The query-term index of one group of `group` queries per grid row y from
// the densified table qd [b, vocab + 1] (groups past b are empty): words
// [groups, index_words(vocab)] and the compact tables [groups, vocab + 2,
// group] (rows past the group's present terms are left as they are; no
// kernel reads them).  Two launches over the same grid, block x handling
// words [x * kIndexWords, +kIndexWords) of group y, so that every SM reads
// the table (one block per group was bound by one SM's loads).
//
// 1. presence bits.  A term is present when a value is nonzero: NaN and
// inf compare unequal to zero.
template <typename T>
__global__ void __launch_bounds__(kIndexThreads)
index_kernel_bits(const T* qd, int b, int vocab, int group, uint2* words) {
  const int q0 = blockIdx.y * group, qn = min(group, b - q0);
  const int nw = index_words(vocab), v1 = vocab + 1;
  const int i = blockIdx.x * kIndexWords + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (i >= nw) return;   // whole warps
  const int c = i * 32 + lane;
  bool held = false;
  if (c < v1) {
    for (int q = 0; q < qn; ++q) held |= to_f32(qd[size_t(q0 + q) * v1 + c]) != 0.f;
  }
  const unsigned bits = __ballot_sync(0xffffffffu, held);
  if (lane == 0) words[size_t(blockIdx.y) * nw + i].x = bits;
}

// 2. ranks and the compact table: the block counts the present terms of
// the words before its own, then each present term's values go to its row.
template <typename T>
__global__ void __launch_bounds__(kIndexThreads)
index_kernel_rows(const T* qd, int b, int vocab, int group, uint2* words, float* table) {
  __shared__ int before[kIndexWords], own[kIndexWords];
  const int q0 = blockIdx.y * group, qn = min(group, b - q0);
  const int nw = index_words(vocab), v1 = vocab + 1;
  uint2* w = words + size_t(blockIdx.y) * nw;
  float* tab = table + size_t(blockIdx.y) * (vocab + 2) * group;
  const int w0 = blockIdx.x * kIndexWords, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int n = 0;
  for (int j = threadIdx.x; j < w0; j += kIndexThreads) n += __popc(w[j].x);
  for (int off = 16; off > 0; off >>= 1) n += __shfl_down_sync(0xffffffffu, n, off);
  const int i = w0 + warp;
  const unsigned bits = i < nw ? w[i].x : 0u;
  if (lane == 0) {
    before[warp] = n;
    own[warp] = __popc(bits);
  }
  __syncthreads();
  if (i >= nw) return;   // whole warps
  int first = 1;
  for (int j = 0; j < kIndexWords; ++j) first += before[j] + (j < warp ? own[j] : 0);
  if (lane == 0) w[i].y = static_cast<unsigned>(first);
  if (i == 0) {
    for (int q = lane; q < group; q += 32) tab[q] = 0.f;   // row 0, the misses'
  }
  const unsigned bit = 1u << lane;
  if (bits & bit) {
    const int row = first + __popc(bits & (bit - 1));
    const int c = i * 32 + lane;
    for (int q = 0; q < group; ++q)
      tab[size_t(row) * group + q] = q < qn ? to_f32(qd[size_t(q0 + q) * v1 + c]) : 0.f;
  }
}

// Block-wide bitonic sort of s/id[0, size), best first; size is a power
// of two; s holds scores (float) or their order keys (unsigned).  Every
// thread of the block must call it.
template <typename S>
__device__ inline void sort_best_first(S* s, int* id, int size) {
  for (int len = 2; len <= size; len <<= 1) {
    for (int stride = len >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < size / 2; p += blockDim.x) {
        const int lo = 2 * stride * (p / stride) + (p % stride);
        const int hi = lo + stride;
        const bool best_first = (lo & len) == 0;
        const S s_lo = s[lo], s_hi = s[hi];
        const int i_lo = id[lo], i_hi = id[hi];
        if (ahead(order_key(s_hi), i_hi, order_key(s_lo), i_lo) == best_first) {
          s[lo] = s_hi; s[hi] = s_lo;
          id[lo] = i_hi; id[hi] = i_lo;
        }
      }
      __syncthreads();
    }
  }
}

// One query's candidate list: buf slots of (order key, id), cnt of them
// in use, and the threshold a new candidate must beat.
struct Cands {
  unsigned* key;
  int* id;
  int* cnt;
  unsigned* th_key;
  int* th_i;
};

__device__ inline void init_cands(const Cands& c) {
  *c.cnt = 0;
  *c.th_key = 0;
  *c.th_i = kSentinelId;
}

// Sort the list, keep its best k (empty slots sort last as sentinels) and
// raise the threshold to the k-th.  Block-wide; call with the block in step.
__device__ inline void compact(const Cands& c, int buf, int k) {
  const int used = *c.cnt;
  for (int p = used + threadIdx.x; p < buf; p += blockDim.x) {
    c.key[p] = 0;
    c.id[p] = kSentinelId;
  }
  __syncthreads();
  sort_best_first(c.key, c.id, buf);
  if (threadIdx.x == 0) {
    *c.cnt = k;
    *c.th_key = c.key[k - 1];
    *c.th_i = c.id[k - 1];
  }
  __syncthreads();
}

__device__ __forceinline__ void offer(const Cands& c, unsigned key, int row) {
  if (ahead(key, row, *c.th_key, *c.th_i)) {
    const int p = atomicAdd(c.cnt, 1);
    c.key[p] = key;
    c.id[p] = row;
  }
}

}  // namespace topk
