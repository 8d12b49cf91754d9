// The selection passes of topk_large.cu, shared with mips_topk.cu (B1
// takes the top k of its sample's scores through them): the top k of each
// row of a [B, n] f32 score buffer in lax.top_k's order (topk_scan.cuh:
// order_key, then the lower column), spread over every SM.  topk_large.cu's
// header comment describes the passes.
#pragma once

#include "topk_scan.cuh"

namespace large {

constexpr int kThreads = 256;      // pass kernels (and topk_large.cu's row kernel)

// ---- 2. selection ------------------------------------------------------

constexpr int kPer = 8;                           // scores a pass thread loads before using them
constexpr int kPassRows = kThreads * kPer;        // a chunk is a multiple of this
constexpr int kSelThreads = 1024;                 // thresh and finish kernels
constexpr int kLevels = 3;
__host__ __device__ constexpr int level_shift(int l) { return l == 0 ? 20 : l == 1 ? 10 : 0; }
__host__ __device__ constexpr int level_bits(int l) { return l == 0 ? 12 : 10; }
constexpr int kHistInts = (1 << 12) + 2 * (1 << 10);   // a query's three histograms
constexpr int kSortSmem = 16384;                  // list entries the finish sorts in shared memory

// A query's selection state (global; zeroed before hist<0>).
struct State {
  unsigned prefix;   // the resolved top bits of the k-th key
  int shift;         // 32 - (bits resolved)
  int need;          // rank of the k-th key among the rows matching the prefix
  int above;         // rows whose key is above the prefix
  int count;         // rows matching the prefix
  int mode;          // 0: refine; 1: collect the rows matching the prefix; 2: fill the first `need` of them
  int list_n;        // entries appended to the list
  int pad;
};
static_assert(sizeof(State) == 32, "State is 8 ints");

struct SelArgs {
  const float* scores;   // [B, n_valid]
  int b, n_valid, k, cap, chunk_rows, chunks;
  long long list_cap;    // list entries a query (a power of two >= k + cap)
  State* state;          // [B]
  int* hist;             // [B, kHistInts]
  int* ties;             // [B, chunks] rows of the k-th key per chunk (mode 2)
  float* list_s;         // [B, list_cap]
  int* list_i;
  float* out_s;          // [B, k]
  int* out_i;
};

__host__ __device__ constexpr int hist_offset(int l) { return l == 0 ? 0 : l == 1 ? (1 << 12) : (1 << 12) + (1 << 10); }

template <int LEVEL>
__global__ void __launch_bounds__(kThreads) hist_kernel(SelArgs a) {
  constexpr int kBins = 1 << level_bits(LEVEL);
  __shared__ int h[kBins];
  const int q = blockIdx.y, tid = threadIdx.x, lane = tid & 31;
  unsigned prefix = 0;
  if (LEVEL > 0) {
    const State st = a.state[q];
    if (st.mode != 0) return;   // resolved at an earlier level
    prefix = st.prefix;
  }
  for (int i = tid; i < kBins; i += kThreads) h[i] = 0;
  __syncthreads();
  const float* s = a.scores + size_t(q) * a.n_valid;
  const long long r0 = (long long)blockIdx.x * a.chunk_rows;
  const long long r1 = min((long long)a.n_valid, r0 + a.chunk_rows);
  for (long long base = r0; base < r1; base += kPassRows) {
    float x[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const long long i = base + u * kThreads + tid;
      x[u] = i < r1 ? __ldcg(s + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const unsigned key = topk::order_key(x[u]);
      const bool take = base + u * kThreads + tid < r1 &&
                        (LEVEL == 0 || (key >> level_shift(LEVEL - 1)) == prefix);
      // a warp whose rows all fall in one bin adds once (a crowded bin,
      // all-equal scores); otherwise each row adds its own
      const int bin = (key >> level_shift(LEVEL)) & (kBins - 1);
      const int bin0 = __shfl_sync(0xffffffffu, bin, 0);
      if (__all_sync(0xffffffffu, take && bin == bin0)) {
        if (lane == 0) atomicAdd(&h[bin0], 32);
      } else if (take) {
        atomicAdd(&h[bin], 1);
      }
    }
  }
  __syncthreads();
  int* g = a.hist + size_t(q) * kHistInts + hist_offset(LEVEL);
  for (int i = tid; i < kBins; i += kThreads) {
    if (h[i]) atomicAdd(g + i, h[i]);
  }
}

// Exclusive block-wide prefix sum of v over kSelThreads threads; `total`
// receives the sum.
__device__ __forceinline__ long long block_scan(long long v, long long* warp_sums, long long& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  long long before = 0;
  total = 0;
  for (int i = 0; i < int(blockDim.x) / 32; ++i) {
    const long long s = warp_sums[i];
    before += i < warp ? s : 0;
    total += s;
  }
  __syncthreads();   // warp_sums is reused by the next call
  return before + x - v;
}

// One block a query: the bin of the k-th key among the rows matching the
// prefix, the rows above it, and whether to refine.
template <int LEVEL>
__global__ void __launch_bounds__(kSelThreads) thresh_kernel(SelArgs a) {
  constexpr int kBins = 1 << level_bits(LEVEL);
  constexpr int kEach = kBins / kSelThreads;
  __shared__ long long warp_sums[kSelThreads / 32];
  const int q = blockIdx.x, tid = threadIdx.x;
  State* st = a.state + q;
  if (LEVEL > 0 && st->mode != 0) return;
  const long long need = LEVEL == 0 ? a.k : st->need;
  const int* h = a.hist + size_t(q) * kHistInts + hist_offset(LEVEL);
  // thread t holds bins [kBins - (t + 1) * kEach, kBins - t * kEach): the
  // top bins first, so the scan counts the rows in higher bins
  const int hi = kBins - tid * kEach;
  long long mine = 0;
#pragma unroll
  for (int i = 1; i <= kEach; ++i) mine += h[hi - i];
  long long total;
  const long long higher = block_scan(mine, warp_sums, total);
  if (higher < need && need <= higher + mine) {
    long long above = higher;
    int bin = hi - 1;
    for (; above + h[bin] < need; --bin) above += h[bin];
    const int count = h[bin];
    st->prefix = LEVEL == 0 ? unsigned(bin) : (st->prefix << level_bits(LEVEL)) | unsigned(bin);
    st->shift = level_shift(LEVEL);
    st->need = int(need - above);
    st->above = (LEVEL == 0 ? 0 : st->above) + int(above);
    st->count = count;
    st->mode = count <= a.cap ? 1 : LEVEL == kLevels - 1 ? 2 : 0;
  }
}

// Appends the rows above the prefix, and in mode 1 those matching it, to
// the query's list (warp-aggregated atomics); in mode 2 counts the rows
// of the k-th key in the chunk.
__global__ void __launch_bounds__(kThreads) collect_kernel(SelArgs a) {
  __shared__ int tied;
  const int q = blockIdx.y, tid = threadIdx.x, lane = tid & 31;
  State* stp = a.state + q;
  const State st = *stp;
  if (tid == 0) tied = 0;
  __syncthreads();
  const float* s = a.scores + size_t(q) * a.n_valid;
  float* ls = a.list_s + size_t(q) * a.list_cap;
  int* li = a.list_i + size_t(q) * a.list_cap;
  const long long r0 = (long long)blockIdx.x * a.chunk_rows;
  const long long r1 = min((long long)a.n_valid, r0 + a.chunk_rows);
  int my_ties = 0;
  for (long long base = r0; base < r1; base += kPassRows) {
    float x[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const long long i = base + u * kThreads + tid;
      x[u] = i < r1 ? __ldcg(s + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const long long i = base + u * kThreads + tid;
      const unsigned top = topk::order_key(x[u]) >> st.shift;
      const bool in = i < r1;
      const bool take = in && (top > st.prefix || (st.mode == 1 && top == st.prefix));
      my_ties += in && st.mode == 2 && top == st.prefix;
      const unsigned m = __ballot_sync(0xffffffffu, take);
      if (m) {
        int p0 = 0;
        if (lane == __ffs(m) - 1) p0 = atomicAdd(&stp->list_n, __popc(m));
        p0 = __shfl_sync(0xffffffffu, p0, __ffs(m) - 1);
        if (take) {
          const int p = p0 + __popc(m & ((1u << lane) - 1u));
          ls[p] = x[u];
          li[p] = int(i);
        }
      }
    }
  }
  if (st.mode == 2) {
    my_ties = __reduce_add_sync(0xffffffffu, my_ties);
    if (lane == 0 && my_ties) atomicAdd(&tied, my_ties);
    __syncthreads();
    if (tid == 0) a.ties[size_t(q) * a.chunks + blockIdx.x] = tied;
  }
}

// Mode 2: the first `need` rows of the k-th key, in row order, after the
// `above` rows collect wrote.  A chunk's offset is the count of tied rows
// in the chunks before it; within a chunk thread t takes rows base +
// kPer*t .. + kPer - 1 and a block scan orders the threads.
__global__ void __launch_bounds__(kSelThreads) fill_kernel(SelArgs a) {
  __shared__ long long warp_sums[kSelThreads / 32];
  const int q = blockIdx.y, tid = threadIdx.x;
  const State st = a.state[q];
  if (st.mode != 2) return;
  const int* t = a.ties + size_t(q) * a.chunks;
  long long before = 0;
  for (int c = tid; c < int(blockIdx.x); c += kSelThreads) before += t[c];
  long long offset;
  block_scan(before, warp_sums, offset);
  if (offset >= st.need) return;
  const unsigned kth = st.prefix;   // all 32 bits
  const float* s = a.scores + size_t(q) * a.n_valid;
  float* ls = a.list_s + size_t(q) * a.list_cap + st.above;
  int* li = a.list_i + size_t(q) * a.list_cap + st.above;
  const long long r0 = (long long)blockIdx.x * a.chunk_rows;
  const long long r1 = min((long long)a.n_valid, r0 + a.chunk_rows);
  long long taken = offset;
  for (long long base = r0; base < r1 && taken < st.need; base += kSelThreads * kPer) {
    const long long i0 = base + (long long)tid * kPer;
    float x[kPer];
    int cnt = 0;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      x[u] = i0 + u < r1 ? __ldcg(s + i0 + u) : 0.f;
      cnt += i0 + u < r1 && topk::order_key(x[u]) == kth;
    }
    long long total;
    long long p = taken + block_scan(cnt, warp_sums, total);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if (i0 + u < r1 && topk::order_key(x[u]) == kth) {
        if (p < st.need) {
          ls[p] = x[u];
          li[p] = int(i0 + u);
        }
        ++p;
      }
    }
    taken += total;
  }
}

// One block a query: sort the list best first and write its first k.  In
// shared memory an entry is one integer, (order key << 32) | ~row, so a
// step of the sort is one compare.
__global__ void __launch_bounds__(kSelThreads) finish_kernel(SelArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = blockIdx.x, tid = threadIdx.x;
  const State st = a.state[q];
  const long long m = st.mode == 2 ? (long long)a.k : (long long)st.list_n;
  long long size = 1;
  while (size < m) size <<= 1;
  float* ls = a.list_s + size_t(q) * a.list_cap;
  int* li = a.list_i + size_t(q) * a.list_cap;
  float* out_s = a.out_s + size_t(q) * a.k;
  int* out_i = a.out_i + size_t(q) * a.k;
  if (size > kSortSmem) {   // in global memory, in place
    for (long long j = m + tid; j < size; j += kSelThreads) {
      ls[j] = topk::lowest();
      li[j] = topk::kSentinelId;
    }
    __syncthreads();
    topk::sort_best_first(ls, li, int(size));
    for (int j = tid; j < a.k; j += kSelThreads) {
      out_s[j] = ls[j];
      out_i[j] = li[j];
    }
    return;
  }
  unsigned long long* key = reinterpret_cast<unsigned long long*>(smem);
  for (int j = tid; j < int(size); j += kSelThreads)
    key[j] = j < m ? (static_cast<unsigned long long>(topk::order_key(ls[j])) << 32) | unsigned(~li[j]) : 0ull;
  __syncthreads();
  const int half = int(size) / 2;
  for (int len = 2; len <= size; len <<= 1) {
    for (int stride = len >> 1; stride > 0; stride >>= 1) {
      for (int p = tid; p < half; p += kSelThreads) {
        const int lo = 2 * stride * (p / stride) + (p % stride), hi = lo + stride;
        const unsigned long long x = key[lo], y = key[hi];
        if ((x < y) == ((lo & len) == 0)) {
          key[lo] = y;
          key[hi] = x;
        }
      }
      __syncthreads();
    }
  }
  for (int j = tid; j < a.k; j += kSelThreads) {
    const unsigned long long x = key[j];
    const unsigned ok = unsigned(x >> 32);
    out_s[j] = __uint_as_float((ok & 0x80000000u) ? (ok & 0x7fffffffu) : ~ok);   // order_key's inverse
    out_i[j] = int(~unsigned(x));
  }
}

cudaError_t run_select(const SelArgs& a, cudaStream_t st) {
  if (a.b < 1 || a.n_valid < 1 || a.k < 1 || a.k > a.n_valid || a.cap < 1 || a.chunk_rows < kPassRows ||
      a.chunk_rows % kPassRows || (long long)a.chunks * a.chunk_rows < a.n_valid || a.b > 65535 || a.list_cap < (long long)a.k + a.cap || (a.list_cap & (a.list_cap - 1)) ||
      a.list_cap > 0x7fffffffll || !a.scores || !a.state || !a.hist || !a.ties || !a.list_s || !a.list_i ||
      !a.out_s || !a.out_i)
    return cudaErrorInvalidValue;
  // state, histograms and tie counts are one zeroed workspace
  cudaError_t err = cudaMemsetAsync(a.state, 0,
                                    size_t(a.b) * (sizeof(State) + kHistInts * 4 + size_t(a.chunks) * 4), st);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.chunks, a.b);
  hist_kernel<0><<<grid, kThreads, 0, st>>>(a);
  thresh_kernel<0><<<a.b, kSelThreads, 0, st>>>(a);
  hist_kernel<1><<<grid, kThreads, 0, st>>>(a);
  thresh_kernel<1><<<a.b, kSelThreads, 0, st>>>(a);
  hist_kernel<2><<<grid, kThreads, 0, st>>>(a);
  thresh_kernel<2><<<a.b, kSelThreads, 0, st>>>(a);
  collect_kernel<<<grid, kThreads, 0, st>>>(a);
  fill_kernel<<<grid, kSelThreads, 0, st>>>(a);
  const int smem = kSortSmem * 8;
  err = cudaFuncSetAttribute(finish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  finish_kernel<<<a.b, kSelThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace large
