// Exact top-k for k beyond the scan kernels' candidate lists (k > MAX_K =
// 2048), for sm_90a.  repro's kernel backend serves any k through
// src/repro/kernels/mips_topk.py mips_topk_pallas and
// src/repro/kernels/fused_topk.py fused_topk_pallas, whose running top-k
// lives in VMEM whatever k is; topk_scan.cu keeps its lists in shared
// memory and stops at 2048.  This file serves the same spaces (dense ip /
// l2, sparse, fused ip) at any k <= n_valid, in two steps on the stream:
//
//   score[b, n] = w_d*dense(q_b, c_n) + w_s*sum_j qd[b, idx[n,j]]*val[n,j]   n < n_valid
//   out[b]      = top k of score[b] by (order_key descending, row ascending),
//                 lax.top_k's order (topk_scan.cuh: order_key).
//
// 1. Scores into a [B, n_valid] f32 buffer.  A dense corpus whose rows
//    allow 16-byte copies takes the ring of ring.cuh (two persistent
//    blocks an SM, four multiplying warps each fed a ring of tensor-map
//    copies by a fifth; above 16 queries clusters that read the corpus once
//    for up to 128; B1's arithmetic) with the StoreAll epilogue (ring.cuh):
//    every row's score leaves as 32-byte sectors.  A fused corpus takes the
//    fused ring with the same epilogue (B4, fused_score.cu: sparse_dense.py
//    routes it), or row_kernel where no ring layout takes it.  Other
//    corpora take row_kernel (one warp a row, the graph hop's arithmetic,
//    score_row.cuh).
// 2. Selection, spread over every SM (large_select.cuh: run_select):
//    hist<0>    every (query, row chunk) block histograms the top 12 bits
//               of the order keys in shared memory (a warp whose rows share
//               a bin adds once, so that all-equal scores do not
//               serialise) and adds them to a global [B, 4096];
//    thresh<0>  one block a query finds the bin of the k-th key: the rows
//               above it, and the rows in it (`count`);
//    hist/thresh<1>, <2>  the next 10 and the last 10 bits, among the rows
//               in that bin, only for queries whose bin holds more than
//               `cap` rows (each returns at once for the others);
//    collect    appends, with warp-aggregated atomics, the rows above the
//               bin and (when the bin holds at most cap rows) the rows in
//               it to the query's list, whose length is known on the
//               device; when all 32 bits are resolved and more than cap
//               rows share the k-th key, it counts them per chunk instead,
//    fill       and the chunks before the k-th tied row write the lowest-
//               numbered tied rows in row order (an ordered block scan per
//               chunk, the chunk's offset from the counts before it);
//    finish     one block a query sorts its list, at most k - 1 + cap
//               entries (or exactly k), by (order key descending, row
//               ascending) with a bitonic sort, in shared memory as one
//               64-bit integer an entry up to kSortSmem entries, and
//               writes the first k.
// Rows at or past n_valid are not scored: with k <= n_valid they never
// reach the top k of the reference backend, where they score -inf and lose
// every tie to a lower row (unless valid rows score a NaN with the sign bit
// set, which ranks below -inf).
//
// What bounds it on an H100 SXM (3.35 TB/s): the corpus read, 8.1 ms for
// 8.84M x 768 f32, as for the scan kernels; the scores add B x n_valid x 4
// bytes written once and read two or three times (hist<0>, collect, a
// refinement when the first bin is crowded): 0.57 GB at B = 16, 0.17 ms a
// read.  Each block's ring keeps three stages of loads in flight; with the
// copies taken off the multiplying warps the score pass runs close to the
// corpus read at B <= 16, and above it, read once for each cluster, at
// the consumers' issue rate over the FMAs (12.97 ms at B = 64).  PERF.md
// has the times on an H100.
#include "large_select.cuh"
#include "ring.cuh"
#include "score_row.cuh"

namespace large {

using ring::kQB;
using ring::kTileRows;

// ---- 1. scores ---------------------------------------------------------

// The dense pass's arguments (ring.cuh StoreArgs): q the queries grouped as
// dense_kernel reads them (mips_topk.py: query_groups), c [N, D] f32/bf16,
// 16-byte aligned with D a multiple of 16 bytes' worth.
using DenseArgs = ring::StoreArgs;
using ring::StoreAll;

template <typename TD>
cudaError_t launch_dense(const DenseArgs& a, const ring::Grid& g, cudaStream_t st) {
  CUtensorMap map;
  cudaError_t err = ring::tensor_map<TD>(a.c, a.d, a.n_valid, &map);
  if (err != cudaSuccess) return err;
  return a.l2 ? ring::launch_dense<TD, true, StoreAll>(a, map, g, st)
              : ring::launch_dense<TD, false, StoreAll>(a, map, g, st);
}

template <typename TD>
cudaError_t dense_fit(const DenseArgs& a, int width, int* fit) {
  return a.l2 ? ring::cluster_fit<TD, true, StoreAll>(a, width, fit) : ring::cluster_fit<TD, false, StoreAll>(a, width, fit);
}

// Any space, one warp a row (grid-stride), every query's score with the
// graph hop's per-row arithmetic.
struct RowArgs {
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
  int b, n_valid;
  float* scores;            // [B, n_valid]
};

template <bool DENSE, bool SPARSE, typename TD, typename TV>
__global__ void __launch_bounds__(kThreads) row_kernel(RowArgs a) {
  extern __shared__ float q2[];   // [B] |q|^2 for l2
  const int lane = threadIdx.x & 31;
  if (DENSE && a.l2) {
    for (int q = threadIdx.x >> 5; q < a.b; q += kThreads / 32) {
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
  const size_t warps = size_t(gridDim.x) * (kThreads / 32);
  for (size_t row = size_t(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5); row < size_t(a.n_valid);
       row += warps) {
    for (int q = 0; q < a.b; ++q) {
      const float s = rows::score_row<DENSE, SPARSE, TD, TV>(a, q, row, (DENSE && a.l2) ? q2[q] : 0.f, vec, lane);
      if (lane == 0) a.scores[size_t(q) * a.n_valid + row] = s;
    }
  }
}

template <bool DENSE, bool SPARSE, typename TD, typename TV>
cudaError_t launch_rows(const RowArgs& a, int blocks, cudaStream_t st) {
  const size_t smem = (DENSE && a.l2) ? size_t(a.b) * sizeof(float) : 0;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  row_kernel<DENSE, SPARSE, TD, TV><<<blocks, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

cudaError_t run_rows(const RowArgs& a, int blocks, bool dense_bf16, bool val_bf16, cudaStream_t st) {
  using bf = __nv_bfloat16;
  const bool dense = a.c_dense != nullptr, sparse = a.c_idx != nullptr;
  if (!(dense || sparse) || a.b < 1 || a.n_valid < 1 || blocks < 1 ||
      (dense && (a.q_dense == nullptr || a.d < 1)) || (sparse && (a.qd == nullptr || a.vp1 < 1 || a.nnz < 0)) ||
      (sparse && a.l2) || (dense && sparse && !a.weighted) || a.scores == nullptr)
    return cudaErrorInvalidValue;
  if (dense && sparse) {
    if (dense_bf16) return val_bf16 ? launch_rows<true, true, bf, bf>(a, blocks, st)
                                    : launch_rows<true, true, bf, float>(a, blocks, st);
    return val_bf16 ? launch_rows<true, true, float, bf>(a, blocks, st)
                    : launch_rows<true, true, float, float>(a, blocks, st);
  }
  if (dense) return dense_bf16 ? launch_rows<true, false, bf, float>(a, blocks, st)
                               : launch_rows<true, false, float, float>(a, blocks, st);
  return val_bf16 ? launch_rows<false, true, float, bf>(a, blocks, st)
                  : launch_rows<false, true, float, float>(a, blocks, st);
}


}  // namespace large

extern "C" {

// Dense ip (l2 = 0) or negated-l2 scores [b, n_valid] of the first n_valid
// rows through dense_kernel, times w when weighted.  c is f32 (c_bf16 = 0)
// or bf16, 16-byte aligned with d a multiple of 4 (f32) or 8 (bf16) values;
// q is the queries grouped as dense_kernel reads them (DenseArgs), rows x
// width groups.  The grid (ring.cuh Grid): `blocks` along x, rows x width
// groups along y in clusters of width blocks that read each corpus stage
// once (width 1: no cluster).  Returns a cudaError_t.
int topk_large_dense_launch(const float* q, const void* c, int c_bf16, int d, int b, int n_valid,
                            int l2, int weighted, float w, int blocks, int width, int rows, float* scores,
                            void* stream) {
  const int elems = c_bf16 ? 8 : 4;
  const ring::Grid g{blocks, width, rows};
  if (!q || !c || !scores || b < 1 || n_valid < 1 || d < 1 || d % elems ||
      reinterpret_cast<uintptr_t>(c) % 16 || !ring::grid_ok(g, b))
    return int(cudaErrorInvalidValue);
  large::DenseArgs a{q, c, d, b, n_valid, l2, weighted, w, scores};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(c_bf16 ? large::launch_dense<__nv_bfloat16>(a, g, st) : large::launch_dense<float>(a, g, st));
}

// Clusters of `width` (2 to 8) blocks of the dense score pass that fit the
// card at once, into *fit (topk_large.py's blocks along x).  Returns a
// cudaError_t.
int topk_large_dense_clusters(int c_bf16, int d, int l2, int width, int* fit) {
  if (!fit || d < 1 || width < 2 || width > ring::kMaxCluster) return int(cudaErrorInvalidValue);
  large::DenseArgs a{};
  a.d = d;
  a.l2 = l2;
  return int(c_bf16 ? large::dense_fit<__nv_bfloat16>(a, width, fit) : large::dense_fit<float>(a, width, fit));
}

// Scores [b, n_valid] of any space through row_kernel, one warp a row.  A
// null c_dense (or c_idx) drops that part; weighted = 0 leaves a single
// part unscaled.  Returns a cudaError_t.
int topk_large_rows_launch(const float* qd, int vp1, const float* q_dense, int d, const int* c_idx,
                           const void* c_val, int val_bf16, int nnz, const void* c_dense, int dense_bf16,
                           int l2, int weighted, float w_dense, float w_sparse, int b, int n_valid,
                           int blocks, float* scores, void* stream) {
  large::RowArgs a{};
  a.qd = qd; a.vp1 = vp1; a.q_dense = q_dense; a.d = d;
  a.c_idx = c_idx; a.c_val = c_val; a.nnz = nnz; a.c_dense = c_dense;
  a.l2 = l2; a.weighted = weighted; a.w_dense = w_dense; a.w_sparse = w_sparse;
  a.b = b; a.n_valid = n_valid; a.scores = scores;
  return int(large::run_rows(a, blocks, dense_bf16 != 0, val_bf16 != 0, static_cast<cudaStream_t>(stream)));
}

// The top k (k <= n_valid) of each row of scores [b, n_valid], in
// lax.top_k's order, into out_s/out_i [b, k].  `ws` is a workspace of
// b * (8 + 6144 + chunks) ints, list_s/list_i [b, list_cap] (a power of
// two >= k + cap); chunk_rows (a multiple of 2048) rows a pass block,
// chunks = ceil(n_valid / chunk_rows).  Returns a cudaError_t.
int topk_large_select_launch(const float* scores, int b, int n_valid, int k, int cap, int chunk_rows,
                             int chunks, long long list_cap, int* ws, float* list_s, int* list_i,
                             float* out_s, int* out_i, void* stream) {
  large::SelArgs a{};
  a.scores = scores; a.b = b; a.n_valid = n_valid; a.k = k; a.cap = cap;
  a.chunk_rows = chunk_rows; a.chunks = chunks; a.list_cap = list_cap;
  a.state = reinterpret_cast<large::State*>(ws);
  a.hist = ws + size_t(b) * 8;
  a.ties = a.hist + size_t(b) * large::kHistInts;
  a.list_s = list_s; a.list_i = list_i; a.out_s = out_s; a.out_i = out_i;
  return int(large::run_select(a, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
