// Fused dense+sparse scores for sm_90a, no selection (B4).  Replaces
// src/repro/kernels/sparse_dense.py fused_score_pallas (with _kernel):
//
//   score[b, n] = w_d*<q_d[b], c_d[n]> + w_s*sum_j qd[b, idx[n,j]]*val[n,j]
//
// written as f32 [B, N]; both weights always apply (weight 0 still
// multiplies), as in the TPU kernel; an id at V reads the table's column V,
// ids below -1 wrap once, then clamp (topk_scan.cuh index_row).
//
// Design.  B2's fused ring (ring.cuh fused_kernel) with the StoreAll
// epilogue, which topk_large.cu's dense pass also runs: every finished
// tile's mixed scores leave as 32-byte sectors.  The persistent blocks
// walk the corpus's tiles, a copying warp feeding the multiplying warps a
// ring of stages, a block a group of 16 queries at every B: in the box
// layout (ring.cuh BoxOne: rows of a multiple of 16 bytes in each array,
// MS MARCO's D = 768 and nnz = 128) tensor-map boxes of the dense rows and
// of the COO ids and values; in the row layout (RowTile: D <= 32 even,
// nnz <= 32, DIN's items) whole rows by bulk copies.  Clusters (BoxCluster)
// are B2's only: on the NAPP build's 128 pivots (128 terms each) they were
// slower than a block a group (PERF.md).  The sparse part reads the
// query-term index of each block's 16 queries (kernels/query_index.py),
// its lookups in the consumers' registers.  What no layout takes (D above
// 32 off 16 bytes, odd D, unaligned bases, two dtypes) the wrapper sends
// to topk_large.cu's row_kernel (kernels/sparse_dense.py: route).
//
// What bounds it on an H100 SXM (80 GB at 3.35 TB/s, 67 TFLOP/s f32 on
// CUDA cores), at MS MARCO passage scale (8,841,823 x 768 f32 dense,
// 128-nnz COO over 30,522 terms): at B = 16 the 36.2 GB corpus and the
// 0.57 GB output, 10.98 ms by bytes; at B = 128 the 1.74 TFLOP of dense
// products, about 26 ms by operations were the corpus read once (a block
// a group reads it 8 times; the 4.53 GB output 1.35 ms).  PERF.md holds what was measured.
//
// Numerics.  The ring's: dense sums fmaf in column order from +0, sparse
// sums fmaf in slot order from +0 over the hits and the non-finite
// misses, the mix __fadd_rn(__fmul_rn(w_d, dense), __fmul_rn(w_s, sparse));
// so a score equals B2's for the same row and query bit for bit.
#include "ring.cuh"

namespace fscore {

template <typename TD, template <typename, typename, bool, bool> class L>
cudaError_t launch(const ring::FusedArgs<ring::StoreArgs>& fa, const ring::Grid& g, cudaStream_t st) {
  using T = L<TD, TD, true, true>;
  CUtensorMap maps[3] = {};   // dense, ids, values: the box layout's
  if (T::kBox) {
    const cudaError_t err = ring::box_maps<TD, TD, true, true>(fa.e.c, fa.e.d, fa.s, fa.e.n_valid, maps);
    if (err != cudaSuccess) return err;
  }
  return ring::launch_fused<TD, TD, true, true, false, ring::StoreAll, T>(fa, maps, g, st);
}

}  // namespace fscore

extern "C" {

// Fused scores [b, n] into out through the fused ring.  q the dense queries
// grouped as the ring reads them (mips_topk.py: query_groups, `groups`
// groups of 16), c_dense [n, d]; words / table the query-term index of
// those groups (query_index.py: build_index(qdensified, 16)), c_idx
// [n, nnz] i32, c_val [n, nnz]; dense and values f32 (bf16 = 0) or both
// bf16, every array 16-byte aligned.  rows_layout = 0 takes the box
// layout, 1 the row layout (fused_topk.py: ring_layout).  The grid
// (ring.cuh Grid): `blocks` along x, a block a group along y.  Returns a
// cudaError_t.
int fused_score_launch(const float* q, const void* c_dense, int d, const void* words, const float* table,
                       const int* c_idx, const void* c_val, int nnz, int vocab, int bf16, int rows_layout, int b,
                       int n, float w_dense, float w_sparse, int blocks, int groups, float* out, void* stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const ring::SparseArgs sp = ring::sparse_args(true, words, table, c_idx, c_val, nnz, vocab, 1, w_dense, w_sparse);
  const ring::Grid g{blocks, 1, groups};
  const int elem = bf16 ? 2 : 4;
  if (!q || !c_dense || !words || !table || !c_idx || !c_val || !out || d < 1 || nnz < 1 || n < 1 || vocab < 0 ||
      vocab > 0x7ffffffd || !aligned(c_dense) || !aligned(c_idx) || !aligned(c_val) || !ring::grid_ok(g, b) ||
      !ring::layout_ok(rows_layout != 0, true, true, d, elem, nnz, elem, sp.stage_words, sp.nw))
    return int(cudaErrorInvalidValue);
  const ring::FusedArgs<ring::StoreArgs> fa{ring::StoreArgs{q, c_dense, d, b, n, 0, 0, 0.f, out}, sp};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (rows_layout)
    return int(bf16 ? fscore::launch<bf, ring::RowTile>(fa, g, st) : fscore::launch<float, ring::RowTile>(fa, g, st));
  return int(bf16 ? fscore::launch<bf, ring::BoxOne>(fa, g, st) : fscore::launch<float, ring::BoxOne>(fa, g, st));
}

}  // extern "C"
