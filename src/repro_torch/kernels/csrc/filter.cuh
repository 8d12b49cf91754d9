// The selection of B1 (mips_topk.cu) and of B2's ring route (fused_topk.cu):
// the epilogues that the ring (ring.cuh) runs at the end of each scored tile,
// and the merge.  See mips_topk.cu's header for the four passes:
//
//   SampleTiles   a sample of tiles scored into a [B, cols] buffer;
//   (select)      large_select.cuh takes each query's top k of the sample;
//   FilterTiles   every other tile, its rows compared with the block's
//                 per-query threshold, the few ahead of it appended to the
//                 block's lists in global memory (sorted in place when one
//                 could overflow);
//   merge_kernel  one block a query: the top k of the sample's top k, the
//                 lists and the masked rows.
//
// An epilogue reads a finished tile's scores from the ring's accumulators:
// B1's dense_kernel hands it the dot products (and |c|^2 for l2) and the
// epilogue forms the score (ring::dense_score); B2's fused_kernel forms the
// fused score itself and hands over the finished scores as an ip tile (the
// score policy of ring.cuh: FusedArgs), so that one filter and one merge
// serve both.
#pragma once

#include "large_select.cuh"
#include "ring.cuh"

namespace b1 {

using ring::kQB;
using ring::kTileRows;

constexpr int kStats = 2;               // per query: list sorts in the filter, candidates merged
constexpr int kMergeThreads = 1024;
constexpr int kMergeSort = 16384;       // pairs the merge sorts in shared memory (128 KB)
constexpr int kMergeBits = 12;          // bits of the pairs a merge pass resolves
constexpr int kMaxBlocks = 1024;        // filter blocks the merge's offsets hold

// (order key, row) as one integer whose order is lax.top_k's: a higher key
// first, then the lower row.  0 lies below every real pair (a row's ~row is
// at least 2^31).
__device__ __forceinline__ unsigned long long pair_of(unsigned key, long long row) {
  return (static_cast<unsigned long long>(key) << 32) | static_cast<unsigned>(~static_cast<unsigned>(row));
}

// The corpus row of position p of the sample's buffer: tile p / 256 of the
// sample is the corpus's tile (p / 256) * stride.
__device__ __forceinline__ long long sample_row(int stride, int p) {
  return static_cast<long long>(p >> 8) * stride * kTileRows + (p & (kTileRows - 1));
}

struct SampleArgs {
  const float* q;     // [ceil(B / 16), D rounded up to 32, 16] f32 (mips_topk.py: query_groups)
  const void* c;      // [N, D] f32/bf16, 16-byte aligned; D a multiple of 16 bytes' worth, or at most 32
  int d, b, n_valid;
  int stride;         // the sample: tiles 0, stride, 2 * stride, ...
  int cols;           // its rows below n_valid, the buffer's width
  float* scores;      // [B, cols]
};

struct SampleTiles {
  using Args = SampleArgs;
  struct Shared {};
  __device__ static long long units(const Args& a) {
    const long long tiles = (a.n_valid + kTileRows - 1) / kTileRows;
    return (tiles + a.stride - 1) / a.stride;
  }
  __device__ static long long first_row(const Args& a, long long u) { return u * a.stride * kTileRows; }
  __device__ static void init(const Args&, Shared&, int, int, int) {}
  template <bool L2, int R>
  __device__ static void tile(const Args& a, Shared&, long long u, long long tile_row0, int row_in,
                              const float (&acc)[R][4], const float (&c2)[R], const float* q2s, int q0, int qn,
                              int lane) {
    const int qgi = lane & 3;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int in = row_in + 8 * r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = 4 * qgi + j;
        const float v = ring::dense_score<L2>(acc[r][j], c2[r], q2s[q]);
        if (tile_row0 + in < a.n_valid && q < qn) a.scores[size_t(q0 + q) * a.cols + u * kTileRows + in] = v;
      }
    }
  }
  template <int R = 4>
  __device__ static void finish(const Args&, Shared&, int, int) {}
};

struct FilterArgs {
  const float* q;
  const void* c;
  int d, b, n_valid;
  int stride;                   // every tile but the sample's
  int k, slots;                 // slots: a power of two >= k + 256
  int k_sample;                 // entries of the sample's top list (min(k, cols))
  const float* sample_s;        // [B, k_sample] the sample's top scores, best first
  const int* sample_pos;        // [B, k_sample] their positions in the sample's buffer
  unsigned long long* lists;    // [B, gridDim.x, slots] pairs
  int* counts;                  // [B, gridDim.x] entries of each list
  int* stats;                   // [B, kStats]
};

struct FilterTiles {
  using Args = FilterArgs;
  struct Shared {
    unsigned long long th[kQB];   // a row must be at or ahead of this pair
    int cnt[kQB];                 // entries of the block's list, per query
  };
  __device__ static long long units(const Args& a) {
    const long long tiles = (a.n_valid + kTileRows - 1) / kTileRows;
    return tiles - (tiles + a.stride - 1) / a.stride;
  }
  // unit u: the u-th tile that is not the sample's (stride >= 2)
  __device__ static long long first_row(const Args& a, long long u) {
    const int ui = int(u);   // below 2^24 (n_valid is an int): a 32-bit division
    return static_cast<long long>(ui + ui / (a.stride - 1) + 1) * kTileRows;
  }
  __device__ static void init(const Args& a, Shared& sh, int t, int q0, int qn) {
    sh.cnt[t] = 0;
    unsigned long long th = 0;   // too few sampled rows: every row passes
    if (t < qn && a.k_sample >= a.k) {
      const size_t i = size_t(q0 + t) * a.k_sample + a.k - 1;
      th = pair_of(topk::order_key(a.sample_s[i]), sample_row(a.stride, a.sample_pos[i]));
    }
    sh.th[t] = th;
  }
  // Sort query q's list of this block, best first (empty slots as 0), keep
  // its best k and raise the threshold to the k-th.  The NT multiplying
  // threads together.
  template <int NT>
  __device__ static void compact(const Args& a, Shared& sh, int q0, int q) {
    unsigned long long* l = a.lists + (size_t(q0 + q) * gridDim.x + blockIdx.x) * a.slots;
    const int tid = threadIdx.x, used = sh.cnt[q];
    for (int p = used + tid; p < a.slots; p += NT) l[p] = 0ull;
    ring::consumers_sync<NT>();
    for (int len = 2; len <= a.slots; len <<= 1) {
      for (int stride = len >> 1; stride > 0; stride >>= 1) {
        for (int p = tid; p < a.slots / 2; p += NT) {
          const int lo = 2 * stride * (p / stride) + (p % stride), hi = lo + stride;
          const unsigned long long x = l[lo], y = l[hi];
          if ((x < y) == ((lo & len) == 0)) {
            l[lo] = y;
            l[hi] = x;
          }
        }
        ring::consumers_sync<NT>();
      }
    }
    if (tid == 0) {
      sh.cnt[q] = a.k;
      sh.th[q] = l[a.k - 1];
      atomicAdd(a.stats + size_t(q0 + q) * kStats, 1);
    }
    ring::consumers_sync<NT>();
  }
  // Sort the lists of the queries in `crowded` (a bit a query), in order.  Out of line: it is rare, and
  // inlined, its barriers cost every tile's epilogue more than its sorts cost (measured, PERF.md).
  template <int NT>
  __device__ __noinline__ static void compact_all(const Args& a, Shared& sh, int q0, unsigned crowded) {
    for (; crowded; crowded &= crowded - 1) compact<NT>(a, sh, q0, __ffs(crowded) - 1);
  }
  // R: the rows a thread holds (ring.cuh consumer_threads: the block's multiplying threads)
  template <bool L2, int R>
  __device__ static void tile(const Args& a, Shared& sh, long long, long long tile_row0, int row_in,
                              const float (&acc)[R][4], const float (&c2)[R], const float* q2s, int q0, int qn,
                              int lane) {
    constexpr int NT = ring::consumer_threads<R>();
    ring::consumers_sync<NT>();   // the last tile's appends are in: every thread reads the same counts
    const unsigned crowded = __ballot_sync(0xffffffffu, lane < qn && sh.cnt[lane] > a.slots - kTileRows);
    ring::consumers_sync<NT>();   // and no append starts before the last thread has read them
    if (crowded) compact_all<NT>(a, sh, q0, crowded);
    // A row passes only if its score is not below the threshold's as floats (or either is a NaN): order_key
    // keeps the order of the floats.  On most tiles no row of the warp does, and the pairs are not formed.
    const int qgi = lane & 3;
    float t[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) t[j] = topk::from_key(unsigned(sh.th[4 * qgi + j] >> 32));
    bool maybe = false;
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = 4 * qgi + j;
        maybe |= q < qn && !(ring::dense_score<L2>(acc[r][j], c2[r], q2s[q]) < t[j]);
      }
    }
    if (!__any_sync(0xffffffffu, maybe)) return;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = tile_row0 + row_in + 8 * r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = 4 * qgi + j;
        const float v = ring::dense_score<L2>(acc[r][j], c2[r], q2s[q]);
        const unsigned long long p = pair_of(topk::order_key(v), row);
        const bool pass = row < a.n_valid && q < qn && p >= sh.th[q];
        const unsigned m = __ballot_sync(0xffffffffu, pass);
        if (m == 0) continue;
        // lanes l, l + 4, ... hold the same query: one atomic for them
        const unsigned group = m & (0x11111111u << qgi);
        const int leader = group ? __ffs(group) - 1 : 0;
        int base = 0;
        if (pass && lane == leader) base = atomicAdd(&sh.cnt[q], __popc(group));
        base = __shfl_sync(0xffffffffu, base, leader);
        if (pass) {
          const int at = base + __popc(group & ((1u << lane) - 1u));
          a.lists[(size_t(q0 + q) * gridDim.x + blockIdx.x) * a.slots + at] = p;
        }
      }
    }
  }
  template <int R = 4>
  __device__ static void finish(const Args& a, Shared& sh, int q0, int qn) {
    ring::consumers_sync<ring::consumer_threads<R>()>();
    const int t = threadIdx.x;
    if (t < qn) a.counts[size_t(q0 + t) * gridDim.x + blockIdx.x] = sh.cnt[t];
  }
};

struct MergeArgs {
  int k, n_valid, stride, k_sample, blocks, slots, masked;
  const float* sample_s;        // [B, k_sample]: the sample's top list, or (stride 1) its scores
  const int* sample_pos;        // their positions in the sample, or null (stride 1: position = index)
  const unsigned long long* lists;
  const int* counts;
  int* stats;
  float* out_s;   // [B, k]
  int* out_i;
};

// One block a query: the top k of its candidates (see the header comment),
// best first.
__global__ void __launch_bounds__(kMergeThreads) merge_kernel(MergeArgs a) {
  extern __shared__ __align__(16) unsigned long long sorted[];   // kMergeSort
  __shared__ int hist[1 << kMergeBits];
  __shared__ int offs[kMaxBlocks + 1];
  __shared__ long long warp_sums[kMergeThreads / 32];
  __shared__ unsigned long long s_prefix;
  __shared__ int s_shift, s_n;
  __shared__ long long s_need, s_above, s_match;
  const int q = blockIdx.x, tid = threadIdx.x, lane = tid & 31;

  long long listed;
  const long long own = tid < a.blocks ? a.counts[size_t(q) * a.blocks + tid] : 0;
  const long long before = large::block_scan(own, warp_sums, listed);
  if (tid < a.blocks) offs[tid] = int(before);
  if (tid == 0) offs[a.blocks] = int(listed);
  __syncthreads();
  const long long m = a.k_sample + listed + a.masked;
  auto fetch = [&](long long e) -> unsigned long long {
    if (e < a.k_sample) {
      const size_t i = size_t(q) * a.k_sample + e;
      return pair_of(topk::order_key(a.sample_s[i]), sample_row(a.stride, a.sample_pos ? a.sample_pos[i] : int(e)));
    }
    e -= a.k_sample;
    if (e < listed) {   // the list holding e: offs[lo] <= e < offs[lo + 1]
      int lo = 0, hi = a.blocks;
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (offs[mid] <= e) lo = mid; else hi = mid;
      }
      return a.lists[(size_t(q) * a.blocks + lo) * a.slots + (e - offs[lo])];
    }
    return pair_of(topk::order_key(topk::kNeg), a.n_valid + (e - listed));
  };

  // Radix passes: the region is the pairs whose bits above `shift` equal
  // `prefix` (all of them at shift 64); `above` pairs lie ahead of it and
  // the k-th lies in it.  Stop once the region and what lies ahead fit the
  // sort's target.
  int kp = 1;
  while (kp < a.k) kp <<= 1;
  const long long target = min(kMergeSort, max(1024, 2 * kp));
  if (tid == 0) {
    s_prefix = 0;
    s_shift = 64;
    s_need = a.k;
    s_above = 0;
    s_match = m;
  }
  __syncthreads();
  while (s_above + s_match > target) {
    const int shift = s_shift;
    const unsigned long long prefix = s_prefix;
    const long long need = s_need;
    const int bits = min(kMergeBits, shift), nshift = shift - bits, nb = 1 << bits;
    for (int i = tid; i < nb; i += kMergeThreads) hist[i] = 0;
    __syncthreads();
    for (long long base = 0; base < m; base += kMergeThreads) {
      const long long e = base + tid;
      bool take = false;
      int bin = 0;
      if (e < m) {
        const unsigned long long v = fetch(e);
        take = shift == 64 || (v >> shift) == prefix;
        bin = int((v >> nshift) & unsigned(nb - 1));
      }
      // a warp whose pairs all fall in one bin adds once (all-equal keys)
      const int bin0 = __shfl_sync(0xffffffffu, bin, 0);
      if (__all_sync(0xffffffffu, take && bin == bin0)) {
        if (lane == 0) atomicAdd(&hist[bin0], 32);
      } else if (take) {
        atomicAdd(&hist[bin], 1);
      }
    }
    __syncthreads();
    // thread t holds bins [hi - each, hi), the top bins first
    const int each = (nb + kMergeThreads - 1) / kMergeThreads;
    const int hi = nb - tid * each;
    long long mine = 0;
    for (int i = 1; i <= each; ++i) {
      if (hi - i >= 0) mine += hist[hi - i];
    }
    long long total;
    const long long higher = large::block_scan(mine, warp_sums, total);
    if (hi > 0 && higher < need && need <= higher + mine) {
      long long ahead = higher;
      int bin = hi - 1;
      for (; ahead + hist[bin] < need; --bin) ahead += hist[bin];
      s_prefix = shift == 64 ? static_cast<unsigned long long>(bin) : (prefix << bits) | unsigned(bin);
      s_shift = nshift;
      s_need = need - ahead;
      s_above += ahead;
      s_match = hist[bin];
    }
    __syncthreads();
  }

  // the region and what lies ahead of it, into shared memory
  const int shift = s_shift;
  const unsigned long long prefix = s_prefix;
  if (tid == 0) s_n = 0;
  __syncthreads();
  for (long long base = 0; base < m; base += kMergeThreads) {
    const long long e = base + tid;
    unsigned long long v = 0;
    bool take = false;
    if (e < m) {
      v = fetch(e);
      take = shift == 64 || (v >> shift) >= prefix;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, take);
    if (mask == 0) continue;
    int at = 0;
    if (lane == __ffs(mask) - 1) at = atomicAdd(&s_n, __popc(mask));
    at = __shfl_sync(0xffffffffu, at, __ffs(mask) - 1);
    if (take) sorted[at + __popc(mask & ((1u << lane) - 1u))] = v;
  }
  __syncthreads();
  const int n = s_n;
  int size = 1;
  while (size < n) size <<= 1;
  for (int j = n + tid; j < size; j += kMergeThreads) sorted[j] = 0ull;
  __syncthreads();
  for (int len = 2; len <= size; len <<= 1) {
    for (int stride = len >> 1; stride > 0; stride >>= 1) {
      for (int p = tid; p < size / 2; p += kMergeThreads) {
        const int lo = 2 * stride * (p / stride) + (p % stride), hi = lo + stride;
        const unsigned long long x = sorted[lo], y = sorted[hi];
        if ((x < y) == ((lo & len) == 0)) {
          sorted[lo] = y;
          sorted[hi] = x;
        }
      }
      __syncthreads();
    }
  }
  for (int j = tid; j < a.k; j += kMergeThreads) {
    const unsigned long long v = sorted[j];
    a.out_s[size_t(q) * a.k + j] = topk::from_key(unsigned(v >> 32));
    a.out_i[size_t(q) * a.k + j] = int(~unsigned(v));
  }
  if (tid == 0) a.stats[size_t(q) * kStats + 1] = int(m);
}

struct Plan {
  int stride, cols, k_sample, sample_blocks, blocks, slots, masked;
};

// The passes of one call: the sample (sample(), which returns a
// cudaError_t) and its selection when n_valid > 0, the filter (filter())
// when the plan has filter blocks, and the merge.
template <typename SampleFn, typename FilterFn>
cudaError_t run_passes(const SampleArgs& sa, const large::SelArgs& sel, const FilterArgs& fa, const MergeArgs& ma,
                       const Plan& p, SampleFn sample, FilterFn filter, cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(fa.stats, 0, size_t(sa.b) * kStats * sizeof(int), st);
  if (err != cudaSuccess) return err;
  if (sa.n_valid > 0) {
    err = sample();
    if (err != cudaSuccess) return err;
    if (p.stride > 1) err = large::run_select(sel, st);
    if (err != cudaSuccess) return err;
  }
  if (p.blocks > 0) {
    err = filter();
    if (err != cudaSuccess) return err;
  }
  const int smem = kMergeSort * 8;
  err = cudaFuncSetAttribute(merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  merge_kernel<<<sa.b, kMergeThreads, smem, st>>>(ma);
  return cudaGetLastError();
}

// The selection's arguments from the entry points' buffers (mips_topk.py:
// filter_buffers).
inline large::SelArgs sel_args(float* sample_scores, int b, int cols, int k_sample, int* sel_ws, int sel_cap,
                               int sel_chunk_rows, int sel_chunks, long long sel_list_cap, float* sel_list_s,
                               int* sel_list_i, float* sample_s, int* sample_pos) {
  large::SelArgs sel{};
  sel.scores = sample_scores; sel.b = b; sel.n_valid = cols; sel.k = k_sample; sel.cap = sel_cap;
  sel.chunk_rows = sel_chunk_rows; sel.chunks = sel_chunks; sel.list_cap = sel_list_cap;
  sel.state = reinterpret_cast<large::State*>(sel_ws);
  sel.hist = sel_ws + size_t(b) * 8;
  sel.ties = sel.hist + size_t(b) * large::kHistInts;
  sel.list_s = sel_list_s; sel.list_i = sel_list_i; sel.out_s = sample_s; sel.out_i = sample_pos;
  return sel;
}

// Whether a plan's shapes hold together (both entry points check them).
inline bool plan_ok(int b, int n, int n_valid, int k, int stride, int cols, int k_sample, int sample_blocks,
                    const float* sample_scores, const float* sample_s, const int* sample_pos, int blocks, int slots,
                    const unsigned long long* lists, const int* counts, const int* stats, const float* out_s,
                    const int* out_i) {
  const long long tiles = (static_cast<long long>(n_valid) + kTileRows - 1) / kTileRows;
  const long long sampled = stride >= 1 ? (tiles + stride - 1) / stride : 0;
  const int masked = n - n_valid < k ? n - n_valid : k;
  return !(!stats || !out_s || !out_i || b < 1 || n_valid < 0 || n_valid > n || k < 1 || k > n || stride < 1 ||
           (b + kQB - 1) / kQB > 65535 || b > 65535 || k_sample != (stride == 1 ? cols : cols < k ? cols : k) ||
           (n_valid > 0 && (sample_blocks < 1 || !sample_scores || cols < 1 || (stride > 1 && (!sample_s || !sample_pos)))) ||
           blocks < 0 || blocks > kMaxBlocks || blocks > tiles - sampled || (blocks > 0 && stride < 2) ||
           (blocks > 0 && (!lists || !counts || slots < k + kTileRows || (slots & (slots - 1)))) ||
           k_sample + static_cast<long long>(tiles - sampled) * kTileRows + masked < k);
}

}  // namespace b1
