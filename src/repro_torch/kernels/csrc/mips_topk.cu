// B1: exact dense ip or negated-l2 top-k (k <= 2048) in one scan of the
// corpus, for sm_90a.  Replaces src/repro/kernels/mips_topk.py
// mips_topk_pallas (with _kernel and _fold_topk): scores [B, D] x [N, D]^T,
// rows at or past n_valid scoring f32-min (NEG), the top k of every query
// by (order_key descending, row ascending), lax.top_k's order
// (topk_scan.cuh: order_key).
//
// What bounds it on an H100 SXM (80 GB at 3.35 TB/s, 67 TFLOP/s f32 on CUDA
// cores): the corpus read, 27.16 GB = 8.1 ms for 8.84M x 768 f32, against
// 3.2 ms of FMAs at B = 16.  At DIN's 100M x 18 the read is 7.2 GB (2.15 ms)
// in f32 and 3.6 GB in bf16, and what bounds the row layout is the
// consumers' instructions a tile (the FMAs, the reads, the epilogue), not
// the bytes.  The TPU kernel carries a running top-k from
// grid step to grid step; PR 12's port (topk_scan.cu) kept a candidate list
// per query in shared memory and sorted it whenever it filled, which above
// k = 256 cut the queries a block to 4 (the corpus read four times at
// B = 16) and put a bitonic sort of up to 4,096 entries in lockstep with the
// multiply.  Here selection leaves the scan's way:
//
// 1. sample   the ring of ring.cuh (persistent blocks, eight
//             multiplying warps fed by a ninth through a ring of copies:
//             tensor-map boxes, or whole rows of D <= 32 by one bulk copy a
//             tile) scores the tiles 0, stride, 2*stride, ... into a
//             [B, cols] buffer (SampleTiles);
// 2. select   large_select.cuh (topk_large's radix passes over every SM)
//             takes each query's top k of the sample.  Its k-th (key, row)
//             is a threshold no row of the top k lies behind: the k-th of
//             a subset of the rows is never ahead of the k-th of all rows.
//             A small corpus is all sample (stride 1): no selection and no
//             filter, the merge reads the sample's scores;
// 3. filter   the same ring scores every other tile once (FilterTiles).  A
//             finished tile's 16 (row, query) keys are compared with the
//             block's per-query threshold in shared memory, as one 64-bit
//             pair (order_key << 32 | ~row), so that ties at the threshold
//             are decided by the row as lax.top_k decides them (a float
//             compare with the threshold's score first: a warp none of
//             whose rows reaches it forms no pair); the few
//             rows ahead of it are appended, with warp-aggregated atomics on
//             a counter in shared memory, to the block's own list of the
//             query in global memory ([B, blocks, slots]).  A list that
//             could overflow within the next tile (more than slots - 256
//             entries) is sorted in place by the block's eight warps; its
//             best k stay, and its k-th becomes the block's threshold for
//             that query: a row behind it has k rows of its own block ahead
//             of it.  Memory stays bounded and the answer exact whatever
//             the data; a sorted or all-equal corpus, or one whose sample
//             misses the best rows, only costs sorts (counted in stats);
// 4. merge    one block a query takes the top k of the sample's top k (at
//             stride 1 all its scores), the blocks' lists and the rows past
//             n_valid (the lowest min(k, N - n_valid) of them, scoring
//             NEG): radix passes of 12 bits
//             over the 64-bit pairs in shared memory until at most a few k
//             remain ahead of the region, then a bitonic sort of those.
//
// So the corpus is read once (the sample's tiles are not read again), every
// query group of 16 shares each read, and no [B, n_valid] buffer is made:
// the sample holds about n_valid / stride scores a query, the lists about
// k * (stride - 1) survivors a query on exchangeable data.
//
// Two stage layouts feed the ring (ring.cuh), chosen before the launch
// from the shape: rows of a multiple of 16 bytes go through a tensor map
// (Stage: D = 768, 64 ...); rows of at most 32 columns that no tensor map
// can describe (RowStage: DIN's and DIEN's D = 18, 72 bytes in f32 and 36
// in bf16) go whole, one bulk copy of a tile's contiguous bytes, so the
// next tiles' loads are in flight while one is scored and the consumers
// multiply the D real columns only; two blocks an SM (the wrapper plans
// twice the blocks).  The sample, the filter and the merge are the same
// for both.  Any other corpus (D > 32 not a multiple of 16
// bytes, a base not 16-byte aligned) takes topk_scan.cu's
// mips_topk_launch instead.
//
// Numerics: the ring's (fmaf in column order from +0, l2 as
// -((|q|^2 + |c|^2) - 2 s)), so scores are bit for bit topk_large's and
// topk_scan.cu's.
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
  template <bool L2>
  __device__ static void tile(const Args& a, Shared&, long long u, long long tile_row0, int row_in,
                              const float (&acc)[4][4], const float (&c2)[4], const float* q2s, int q0, int qn,
                              int lane) {
    const int qgi = lane & 3;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int in = row_in + 8 * r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = 4 * qgi + j;
        const float v = ring::dense_score<L2>(acc[r][j], c2[r], q2s[q]);
        if (tile_row0 + in < a.n_valid && q < qn) a.scores[size_t(q0 + q) * a.cols + u * kTileRows + in] = v;
      }
    }
  }
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
  // its best k and raise the threshold to the k-th.  The eight multiplying
  // warps together.
  __device__ static void compact(const Args& a, Shared& sh, int q0, int q) {
    unsigned long long* l = a.lists + (size_t(q0 + q) * gridDim.x + blockIdx.x) * a.slots;
    const int tid = threadIdx.x, used = sh.cnt[q];
    for (int p = used + tid; p < a.slots; p += ring::kConsumers * 32) l[p] = 0ull;
    ring::consumers_sync();
    for (int len = 2; len <= a.slots; len <<= 1) {
      for (int stride = len >> 1; stride > 0; stride >>= 1) {
        for (int p = tid; p < a.slots / 2; p += ring::kConsumers * 32) {
          const int lo = 2 * stride * (p / stride) + (p % stride), hi = lo + stride;
          const unsigned long long x = l[lo], y = l[hi];
          if ((x < y) == ((lo & len) == 0)) {
            l[lo] = y;
            l[hi] = x;
          }
        }
        ring::consumers_sync();
      }
    }
    if (tid == 0) {
      sh.cnt[q] = a.k;
      sh.th[q] = l[a.k - 1];
      atomicAdd(a.stats + size_t(q0 + q) * kStats, 1);
    }
    ring::consumers_sync();
  }
  // Sort the lists of the queries in `crowded` (a bit a query), in order.  Out of line: it is rare, and
  // inlined, its barriers cost every tile's epilogue more than its sorts cost (measured, PERF.md).
  __device__ __noinline__ static void compact_all(const Args& a, Shared& sh, int q0, unsigned crowded) {
    for (; crowded; crowded &= crowded - 1) compact(a, sh, q0, __ffs(crowded) - 1);
  }
  template <bool L2>
  __device__ static void tile(const Args& a, Shared& sh, long long, long long tile_row0, int row_in,
                              const float (&acc)[4][4], const float (&c2)[4], const float* q2s, int q0, int qn,
                              int lane) {
    ring::consumers_sync();   // the last tile's appends are in: every thread reads the same counts
    const unsigned crowded = __ballot_sync(0xffffffffu, lane < qn && sh.cnt[lane] > a.slots - kTileRows);
    ring::consumers_sync();   // and no append starts before the last thread has read them
    if (crowded) compact_all(a, sh, q0, crowded);
    // A row passes only if its score is not below the threshold's as floats (or either is a NaN): order_key
    // keeps the order of the floats.  On most tiles no row of the warp does, and the pairs are not formed.
    const int qgi = lane & 3;
    float t[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) t[j] = topk::from_key(unsigned(sh.th[4 * qgi + j] >> 32));
    bool maybe = false;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = 4 * qgi + j;
        maybe |= q < qn && !(ring::dense_score<L2>(acc[r][j], c2[r], q2s[q]) < t[j]);
      }
    }
    if (!__any_sync(0xffffffffu, maybe)) return;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
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
  __device__ static void finish(const Args& a, Shared& sh, int q0, int qn) {
    ring::consumers_sync();
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

// Whether the corpus's rows go through a tensor map (a multiple of 16
// bytes) or whole, by bulk copies (RowStage: at most kChunk columns).
template <typename TD>
bool box_rows(int d) { return d * sizeof(TD) % 16 == 0; }

template <typename TD, typename E, typename S>
cudaError_t launch_layout(const typename E::Args& a, const CUtensorMap& map, int l2, int blocks, cudaStream_t st) {
  return l2 ? ring::launch_dense<TD, true, E, S>(a, map, blocks, st)
            : ring::launch_dense<TD, false, E, S>(a, map, blocks, st);
}

template <typename TD, typename E>
cudaError_t launch_ring(const typename E::Args& a, const CUtensorMap& map, int l2, int blocks, cudaStream_t st) {
  if (box_rows<TD>(a.d)) return launch_layout<TD, E, ring::Stage<TD>>(a, map, l2, blocks, st);
  if (a.d % 2 == 0) return launch_layout<TD, E, ring::RowStage<TD, true>>(a, map, l2, blocks, st);
  return launch_layout<TD, E, ring::RowStage<TD, false>>(a, map, l2, blocks, st);
}

struct Plan {
  int stride, cols, k_sample, sample_blocks, blocks, slots, masked;
};

template <typename TD>
cudaError_t run(const SampleArgs& sa, const large::SelArgs& sel, const FilterArgs& fa, const MergeArgs& ma,
                const Plan& p, int l2, cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(fa.stats, 0, size_t(sa.b) * kStats * sizeof(int), st);
  if (err != cudaSuccess) return err;
  CUtensorMap map{};   // unused by the row layout
  if (sa.n_valid > 0) {
    if (box_rows<TD>(sa.d)) err = ring::tensor_map<TD>(sa.c, sa.d, sa.n_valid, &map);
    if (err != cudaSuccess) return err;
    err = launch_ring<TD, SampleTiles>(sa, map, l2, p.sample_blocks, st);
    if (err != cudaSuccess) return err;
    if (p.stride > 1) err = large::run_select(sel, st);
    if (err != cudaSuccess) return err;
  }
  if (p.blocks > 0) {
    err = launch_ring<TD, FilterTiles>(fa, map, l2, p.blocks, st);
    if (err != cudaSuccess) return err;
  }
  const int smem = kMergeSort * 8;
  err = cudaFuncSetAttribute(merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  merge_kernel<<<sa.b, kMergeThreads, smem, st>>>(ma);
  return cudaGetLastError();
}

}  // namespace b1

extern "C" {

// Dense ip (l2 = 0) or negated-l2 (l2 = 1) top k of n rows, rows at or
// past n_valid scoring f32-min, into out_s / out_i [b, k].  c is f32
// (c_bf16 = 0) or bf16, 16-byte aligned, with d a multiple of 4 (f32) or 8
// (bf16) values (the tensor-map layout) or d <= 32 (the row layout: whole
// rows by bulk copies, DIN's d = 18); q is the queries grouped as the ring reads them
// (mips_topk.py: query_groups).  The plan and every buffer come from
// mips_topk.py (filter_plan): the sample's scores [b, cols], the
// selection's workspace, lists and top list [b, k_sample] (topk_large.py:
// select_large's shapes; unused at stride 1, where k_sample = cols), the
// filter's lists [b, blocks, slots] and counts [b, blocks], stats [b, 2]
// (list sorts, candidates merged).  Returns a cudaError_t.
int mips_filter_launch(const float* q, const void* c, int c_bf16, int d, int b, int n, int n_valid, int k,
                       int l2, int stride, int cols, int k_sample, int sample_blocks, float* sample_scores,
                       int* sel_ws, int sel_cap, int sel_chunk_rows, int sel_chunks, long long sel_list_cap,
                       float* sel_list_s, int* sel_list_i, float* sample_s, int* sample_pos, int blocks,
                       int slots, unsigned long long* lists, int* counts, int* stats, float* out_s, int* out_i,
                       void* stream) {
  const int elems = c_bf16 ? 8 : 4;
  const long long tiles = (static_cast<long long>(n_valid) + b1::kTileRows - 1) / b1::kTileRows;
  const long long sampled = stride >= 1 ? (tiles + stride - 1) / stride : 0;
  const int masked = n - n_valid < k ? n - n_valid : k;
  if (!q || !c || !stats || !out_s || !out_i || b < 1 || d < 1 || (d % elems && d > ring::kChunk) ||
      reinterpret_cast<uintptr_t>(c) % 16 || n_valid < 0 || n_valid > n || k < 1 || k > n ||
      stride < 1 || (b + b1::kQB - 1) / b1::kQB > 65535 || b > 65535 ||
      k_sample != (stride == 1 ? cols : cols < k ? cols : k) ||
      (n_valid > 0 && (sample_blocks < 1 || !sample_scores || cols < 1 || (stride > 1 && (!sample_s || !sample_pos)))) ||
      blocks < 0 || blocks > b1::kMaxBlocks || blocks > tiles - sampled || (blocks > 0 && stride < 2) ||
      (blocks > 0 && (!lists || !counts || slots < k + b1::kTileRows || (slots & (slots - 1)))) ||
      k_sample + static_cast<long long>(tiles - sampled) * b1::kTileRows + masked < k)
    return int(cudaErrorInvalidValue);
  const b1::Plan p{stride, cols, k_sample, sample_blocks, blocks, slots, masked};
  const b1::SampleArgs sa{q, c, d, b, n_valid, stride, cols, sample_scores};
  large::SelArgs sel{};
  sel.scores = sample_scores; sel.b = b; sel.n_valid = cols; sel.k = k_sample; sel.cap = sel_cap;
  sel.chunk_rows = sel_chunk_rows; sel.chunks = sel_chunks; sel.list_cap = sel_list_cap;
  sel.state = reinterpret_cast<large::State*>(sel_ws);
  sel.hist = sel_ws + size_t(b) * 8;
  sel.ties = sel.hist + size_t(b) * large::kHistInts;
  sel.list_s = sel_list_s; sel.list_i = sel_list_i; sel.out_s = sample_s; sel.out_i = sample_pos;
  const b1::FilterArgs fa{q, c, d, b, n_valid, stride, k, slots, k_sample, sample_s, sample_pos, lists, counts, stats};
  const bool direct = stride == 1;   // the merge reads the sample's scores
  const b1::MergeArgs ma{k, n_valid, stride, k_sample, blocks, slots, masked, direct ? sample_scores : sample_s,
                         direct ? nullptr : sample_pos, lists, counts, stats, out_s, out_i};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(c_bf16 ? b1::run<__nv_bfloat16>(sa, sel, fa, ma, p, l2, st) : b1::run<float>(sa, sel, fa, ma, p, l2, st));
}

}  // extern "C"
