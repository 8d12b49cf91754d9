// Exact top-k for k beyond the scan kernels' candidate lists (k > MAX_K =
// 2048), for sm_90a.  repro's kernel backend serves any k through
// src/repro/kernels/mips_topk.py mips_topk_pallas and
// src/repro/kernels/fused_topk.py fused_topk_pallas, whose running top-k
// lives in VMEM whatever k is; topk_scan.cu keeps its lists in shared
// memory and stops at 2048.  topk_large_launch serves the same spaces
// (dense ip / l2, sparse, fused ip) at any k <= n_valid:
//
//   score[b, n] = w_d*dense(q_b, c_n) + w_s*sum_j qd[b, idx[n,j]]*val[n,j]   n < n_valid
//   out[b]      = top k of score[b] by (score descending, row ascending),
//                 NaN above +inf (the order of lax.top_k), -0 equal to +0.
//
// Design.  Two kernels, one after the other on the stream:
//   1. score_kernel: one warp per corpus row (grid-stride), the row's
//      score for every query with the graph hop's per-row arithmetic
//      (score_row.cuh), written to a [B, n_valid] f32 buffer.
//   2. select_kernel: one block per query.  A radix select over the row's
//      order keys (4 passes of 8 bits, a 256-bin histogram in shared
//      memory) finds the k-th key T; the rows with a key above T go to a
//      scratch list through an atomic counter, then the lowest-numbered
//      rows with key T fill it up to k (an ordered block scan that stops
//      once enough are taken); a block-wide bitonic sort of the list
//      (next power of two above k, in global scratch) puts it in order.
// Rows at or past n_valid are not scored: with k <= n_valid they never
// reach the top k of the reference backend, where they score -inf and
// lose every tie to a lower row.
//
// What bounds it: the corpus read, as for the scan kernels, plus the
// score buffer (B x n_valid x 4 bytes) written once and read five or six
// times (four radix passes, the collection, the tie fill) by B blocks.
// The path exists so that any k is served on the card; a k this large is
// rare, and it is not tuned (PERF.md has its time on an H100).
#include "score_row.cuh"
#include "topk_scan.cuh"

namespace large {

constexpr int kScoreThreads = 256;
constexpr int kSelectThreads = 1024;
constexpr int kBins = 256;
constexpr int kPer = 8;   // scores a select thread loads before using them

struct LargeArgs {
  const float* qd;          // [B, V+1] f32 densified queries (zero trash column), or null
  int vp1;
  const float* q_dense;     // [B, D] f32, or null
  int d;
  const int* c_idx;         // [N, NNZ], or null
  const void* c_val;        // [N, NNZ] f32/bf16
  int nnz;
  const void* c_dense;      // [N, D] f32/bf16, or null
  int l2, weighted;
  float w_dense, w_sparse;
  int b, n_valid, k, pow2;
  float* scores;            // [B, n_valid]
  float* sort_s;            // [B, pow2] scratch
  int* sort_i;
  float* out_s;             // [B, k]
  int* out_i;
};

template <bool DENSE, bool SPARSE, typename TD, typename TV>
__global__ void __launch_bounds__(kScoreThreads) score_kernel(LargeArgs a) {
  extern __shared__ float q2[];   // [B] |q|^2 for l2
  const int lane = threadIdx.x & 31;
  if (DENSE && a.l2) {
    for (int q = threadIdx.x >> 5; q < a.b; q += kScoreThreads / 32) {
      const float* qrow = a.q_dense + size_t(q) * a.d;
      float acc = 0.f;
      for (int j = lane; j < a.d; j += 32) acc = fmaf(qrow[j], qrow[j], acc);
      acc = rows::warp_sum(acc);
      if (lane == 0) q2[q] = acc;
    }
    __syncthreads();
  }
  const bool vec = DENSE && a.d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(a.c_dense) % (4 * sizeof(TD)) == 0 &&
                   reinterpret_cast<uintptr_t>(a.q_dense) % 16 == 0;
  const size_t warps = size_t(gridDim.x) * (kScoreThreads / 32);
  for (size_t row = size_t(blockIdx.x) * (kScoreThreads / 32) + (threadIdx.x >> 5); row < size_t(a.n_valid);
       row += warps) {
    for (int q = 0; q < a.b; ++q) {
      const float s = rows::score_row<DENSE, SPARSE, TD, TV>(a, q, row, (DENSE && a.l2) ? q2[q] : 0.f, vec, lane);
      if (lane == 0) a.scores[size_t(q) * a.n_valid + row] = s;
    }
  }
}

// Exclusive block-wide prefix sum of v; `total` receives the sum.
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int i = 0; i < kSelectThreads / 32; ++i) {
    const int s = warp_sums[i];
    before += i < warp ? s : 0;
    total += s;
  }
  __syncthreads();   // warp_sums is reused by the next call
  return before + x - v;
}

__global__ void __launch_bounds__(kSelectThreads) select_kernel(LargeArgs a) {
  __shared__ int hist[kBins];
  __shared__ int warp_sums[kSelectThreads / 32];
  __shared__ unsigned prefix_s;
  __shared__ int need_s, count_s;
  const int q = blockIdx.x, tid = threadIdx.x;
  const int n = a.n_valid;
  const float* s = a.scores + size_t(q) * n;
  float* ls = a.sort_s + size_t(q) * a.pow2;
  int* li = a.sort_i + size_t(q) * a.pow2;
  // each thread's kPer scores of a round are loaded before they are used
  auto load = [&](int base, float* x) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = base + u * kSelectThreads;
      x[u] = i < n ? __ldcg(s + i) : 0.f;
    }
  };

  // 1. the k-th largest key, 8 bits a pass from the top
  if (tid == 0) {
    prefix_s = 0;
    need_s = a.k;   // rank of the wanted key among those matching the prefix
  }
  unsigned mask = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < kBins; i += kSelectThreads) hist[i] = 0;
    __syncthreads();
    const unsigned prefix = prefix_s;
    for (int base = tid; base < n; base += kSelectThreads * kPer) {
      float x[kPer];
      load(base, x);
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const unsigned key = topk::order_key(x[u]);
        if (base + u * kSelectThreads < n && (key & mask) == prefix)
          atomicAdd(&hist[(key >> shift) & (kBins - 1)], 1);
      }
    }
    __syncthreads();
    if (tid == 0) {
      int need = need_s, bin = kBins - 1;
      for (; bin > 0 && hist[bin] < need; --bin) need -= hist[bin];
      need_s = need;
      prefix_s = prefix | (unsigned(bin) << shift);
    }
    mask |= unsigned(kBins - 1) << shift;
    __syncthreads();
  }
  const unsigned kth = prefix_s;
  const int ties = need_s;          // rows with key kth that belong to the top k
  const int above = a.k - ties;     // rows with a larger key

  // 2. the rows above the k-th key, in any order
  if (tid == 0) count_s = 0;
  __syncthreads();
  for (int base = tid; base < n; base += kSelectThreads * kPer) {
    float x[kPer];
    load(base, x);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = base + u * kSelectThreads;
      if (i < n && topk::order_key(x[u]) > kth) {
        const int p = atomicAdd(&count_s, 1);
        ls[p] = x[u];
        li[p] = i;
      }
    }
  }
  // then the first `ties` rows at it, in row order: thread t takes rows
  // base + kPer*t .. + kPer-1, a block scan orders the threads
  int taken = 0;
  for (int base = 0; base < n && taken < ties; base += kSelectThreads * kPer) {
    const int i0 = base + tid * kPer;
    float x[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) x[u] = i0 + u < n ? __ldcg(s + i0 + u) : 0.f;
    int cnt = 0;
#pragma unroll
    for (int u = 0; u < kPer; ++u) cnt += i0 + u < n && topk::order_key(x[u]) == kth;
    int total;
    int p = taken + block_scan(cnt, warp_sums, total);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if (i0 + u < n && topk::order_key(x[u]) == kth) {
        if (p < ties) {
          ls[above + p] = x[u];
          li[above + p] = i0 + u;
        }
        ++p;
      }
    }
    taken += total;
  }
  for (int p = a.k + tid; p < a.pow2; p += kSelectThreads) {
    ls[p] = -INFINITY;
    li[p] = 0x7fffffff;
  }
  __syncthreads();

  // 3. order the k rows: (score descending, row ascending), NaN first
  topk::sort_best_first(ls, li, a.pow2, topk::BetterNan());
  for (int j = tid; j < a.k; j += kSelectThreads) {
    a.out_s[size_t(q) * a.k + j] = ls[j];
    a.out_i[size_t(q) * a.k + j] = li[j];
  }
}

template <bool DENSE, bool SPARSE, typename TD, typename TV>
cudaError_t launch(const LargeArgs& a, int blocks, cudaStream_t st) {
  const size_t smem = (DENSE && a.l2) ? size_t(a.b) * sizeof(float) : 0;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  score_kernel<DENSE, SPARSE, TD, TV><<<blocks, kScoreThreads, smem, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  select_kernel<<<a.b, kSelectThreads, 0, st>>>(a);
  return cudaGetLastError();
}

cudaError_t run(const LargeArgs& a, int blocks, bool dense_bf16, bool val_bf16, cudaStream_t st) {
  using bf = __nv_bfloat16;
  const bool dense = a.c_dense != nullptr, sparse = a.c_idx != nullptr;
  if (!(dense || sparse) || a.b < 1 || a.n_valid < 1 || a.k < 1 || a.k > a.n_valid || a.pow2 < a.k ||
      (a.pow2 & (a.pow2 - 1)) != 0 || blocks < 1 || (dense && (a.q_dense == nullptr || a.d < 1)) ||
      (sparse && (a.qd == nullptr || a.vp1 < 1 || a.nnz < 0)) || (sparse && a.l2) ||
      (dense && sparse && !a.weighted) || a.scores == nullptr || a.sort_s == nullptr ||
      a.sort_i == nullptr || a.out_s == nullptr || a.out_i == nullptr)
    return cudaErrorInvalidValue;
  if (dense && sparse) {
    if (dense_bf16) return val_bf16 ? launch<true, true, bf, bf>(a, blocks, st)
                                    : launch<true, true, bf, float>(a, blocks, st);
    return val_bf16 ? launch<true, true, float, bf>(a, blocks, st)
                    : launch<true, true, float, float>(a, blocks, st);
  }
  if (dense) return dense_bf16 ? launch<true, false, bf, float>(a, blocks, st)
                               : launch<true, false, float, float>(a, blocks, st);
  return val_bf16 ? launch<false, true, float, bf>(a, blocks, st)
                  : launch<false, true, float, float>(a, blocks, st);
}

}  // namespace large

extern "C" {

// The top k (k <= n_valid) of the first n_valid corpus rows for each of b
// queries; see the comment at the top.  A null c_dense (or c_idx) drops
// that part; weighted = 0 leaves a single part unscaled.  scores is [b,
// n_valid] f32, sort_s/sort_i [b, pow2] (pow2 a power of two >= k),
// out_s/out_i [b, k].  `blocks` is the score kernel's grid.  Returns a
// cudaError_t.
int topk_large_launch(const float* qd, int vp1, const float* q_dense, int d, const int* c_idx,
                      const void* c_val, int val_bf16, int nnz, const void* c_dense, int dense_bf16,
                      int l2, int weighted, float w_dense, float w_sparse, int b, int n_valid, int k,
                      int pow2, int blocks, float* scores, float* sort_s, int* sort_i, float* out_s,
                      int* out_i, void* stream) {
  large::LargeArgs a{};
  a.qd = qd; a.vp1 = vp1; a.q_dense = q_dense; a.d = d;
  a.c_idx = c_idx; a.c_val = c_val; a.nnz = nnz; a.c_dense = c_dense;
  a.l2 = l2; a.weighted = weighted; a.w_dense = w_dense; a.w_sparse = w_sparse;
  a.b = b; a.n_valid = n_valid; a.k = k; a.pow2 = pow2;
  a.scores = scores; a.sort_s = sort_s; a.sort_i = sort_i; a.out_s = out_s; a.out_i = out_i;
  return int(large::run(a, blocks, dense_bf16 != 0, val_bf16 != 0, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
