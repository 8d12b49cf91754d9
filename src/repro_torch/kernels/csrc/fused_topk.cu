// B2's ring route: exact fused dense+sparse top-k (k <= 2048) in one scan
// of the corpus, for sm_90a.  Replaces src/repro/kernels/fused_topk.py
// fused_topk_pallas (with _kernel): scores
//   w_d * dense(q, c) + w_s * sum_j qd[b, idx[n, j]] * val[n, j]
// (dense ip or negated l2; either part may be absent; a single part is
// weighted or not), rows at or past n_valid scoring f32-min, the top k of
// every query by (order_key descending, row ascending), lax.top_k's order.
//
// It is B1's route (mips_topk.cu's header: sample, select, filter, merge)
// on the fused ring of ring.cuh (fused_kernel): the epilogues, the
// selection and the merge are filter.cuh's, the same code as B1's.  A tile
// is scored by the ring's persistent blocks, multiplying warps fed by one
// more that copies, 16 queries a block at every k:
//
//   box layout   (BoxTile: a block a group, one an SM of eight
//                multiplying warps, 4 rows x 4 queries a thread; in
//                clusters two an SM of four, 8 x 4): the dense rows in
//                ceil(D / 32) tensor-map boxes of 256 rows (Stage<TD>,
//                B1's), then the COO slots in ceil(nnz / 16) stages, each
//                a [256, 16] box of the ids and one of the values; for
//                arrays whose rows are multiples of 16 bytes (MS MARCO's
//                D = 768 and nnz = 128, f32 and bf16).  Above 16 queries
//                the blocks of up to 8 groups run as a thread-block
//                cluster (ring.cuh Grid, as B1's): every stage lands in all
//                of them from one multicast copy, so the corpus is read
//                once for up to 128 queries; each block keeps its own
//                queries, query-term index, lookups and epilogue;
//   row layout   (RowTile, two blocks an SM of eight warps, a block a
//                group): one stage a tile, its dense rows (D <= 32, even),
//                ids and values (nnz <= 32) each by one bulk copy of their
//                contiguous bytes; for rows no tensor map describes (DIN's
//                items, D = 18, with one tag).
//
// The consumers turn a sparse stage's slots into hits through the
// query-term index of the block's 16 queries in their own registers and
// pass a row's hits round its four lanes by shuffles (ring.cuh:
// sparse_box, rows_round); the fused score is formed at the end of the tile and
// handed to the epilogue.  Any other input (D above 32 and not a multiple
// of 16 bytes, such as d = 61; an odd D of the row layout; nnz above 32
// and not a multiple of 16 bytes' worth; a base off 16 bytes, such as a
// shard view at an odd row of D = 18 f32; a dense and a value array of
// two dtypes) takes topk_scan.cu's fused_topk_launch, the scan route.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 on CUDA cores):
// at MS MARCO passage scale the bytes, 8.84M x (768 x 4 + 128 x 8) = 36.2
// GB = 10.8 ms at B = 16, against 3.2 ms of dense FMAs; the consumers'
// per-slot work (a lookup and a vote per slot, a table read and four FMAs
// per hit) comes on top of the dense multiply in the same warps; above 16
// queries, read once a cluster, the FMAs (12.97 ms at B = 64) and each
// group's lookups.  At
// DIN's 100M items of 18 f32 with one tag the read is 8.0 GB (2.39 ms),
// and, as for B1's row layout, what bounds it is the consumers'
// instructions a tile.  PERF.md holds what was measured.
//
// Numerics: the scan's (topk_scan.cu): dense sums fmaf in column order
// from +0, l2 as -((|q|^2 + |c|^2) - 2 s), sparse sums fmaf in slot order
// from +0 over the hits and the non-finite misses, the mix
// __fadd_rn(__fmul_rn(w_d, dense), __fmul_rn(w_s, sparse)); so the ring's
// scores and answers equal the scan route's bit for bit, in a cluster or a
// block a group.
#include "filter.cuh"

namespace b2 {

using b1::FilterTiles;
using b1::SampleTiles;

template <typename P, typename E, typename T>
cudaError_t launch_l2(const ring::FusedArgs<typename E::Args>& fa, const CUtensorMap (&maps)[3], int l2,
                      const ring::Grid& g, cudaStream_t st) {
  if constexpr (P::DENSE) {
    if (l2) return ring::launch_fused<typename P::TD, typename P::TV, true, P::SPARSE, true, E, T>(fa, maps, g, st);
  }
  return ring::launch_fused<typename P::TD, typename P::TV, P::DENSE, P::SPARSE, false, E, T>(fa, maps, g, st);
}

// The passes of one call for one combination of parts and dtypes (P, ring.cuh Parts) and a layout; g the
// query groups' grid (its blocks are the filter's; the sample's are p.sample_blocks).
template <typename P, template <typename, typename, bool, bool> class L>
cudaError_t run(const b1::SampleArgs& sa, const large::SelArgs& sel, const b1::FilterArgs& fa,
                const b1::MergeArgs& ma, const ring::SparseArgs& sp, const b1::Plan& p, int l2, const ring::Grid& g,
                cudaStream_t st) {
  using T = L<typename P::TD, typename P::TV, P::DENSE, P::SPARSE>;
  CUtensorMap maps[3] = {};   // dense, ids, values: the box layout's
  if (T::kBox && sa.n_valid > 0) {
    const cudaError_t err =
        ring::box_maps<typename P::TD, typename P::TV, P::DENSE, P::SPARSE>(sa.c, sa.d, sp, sa.n_valid, maps);
    if (err != cudaSuccess) return err;
  }
  const ring::FusedArgs<b1::SampleArgs> fs{sa, sp};
  const ring::FusedArgs<b1::FilterArgs> ff{fa, sp};
  const ring::Grid gs{p.sample_blocks, g.width, g.rows}, gf{p.blocks, g.width, g.rows};
  return b1::run_passes(
      sa, sel, fa, ma, p, [&] { return launch_l2<P, SampleTiles, T>(fs, maps, l2, gs, st); },
      [&] { return launch_l2<P, FilterTiles, T>(ff, maps, l2, gf, st); }, st);
}

}  // namespace b2

extern "C" {

// Fused top k of n rows (B2's ring route), rows at or past n_valid scoring
// f32-min, into out_s / out_i [b, k].  The dense part: q the queries
// grouped as the ring reads them (mips_topk.py: query_groups, rows x width
// groups) and c_dense [n, d] f32 (dense_bf16 = 0) or bf16, or both null;
// the sparse part: words / table the query-term index of rows x width
// groups of 16 queries (query_index.py: build_index(qdensified, 16,
// 16 * width)), c_idx [n, nnz] i32 and c_val [n, nnz] f32 (val_bf16 = 0) or
// bf16, or null.  Two parts share one dtype and are always weighted; one
// part is scaled when weighted = 1.  rows_layout = 0 takes the box layout,
// 1 the row layout (fused_topk.py: ring_layout); every array 16-byte
// aligned.  The plan and the other buffers are mips_filter_launch's
// (mips_topk.py: filter_plan, filter_buffers).  The grid along y (ring.cuh
// Grid): rows x width query groups, in clusters of width blocks that read
// each stage once (width 1: no cluster; the box layout only).  Returns a
// cudaError_t.
int fused_filter_launch(const float* q, const void* c_dense, int dense_bf16, int d, const void* words,
                        const float* table, const int* c_idx, const void* c_val, int val_bf16, int nnz, int vocab,
                        int rows_layout, int b, int n, int n_valid, int k, int l2, int weighted, float w_dense,
                        float w_sparse, int stride, int cols, int k_sample, int sample_blocks, float* sample_scores,
                        int* sel_ws, int sel_cap, int sel_chunk_rows, int sel_chunks, long long sel_list_cap,
                        float* sel_list_s, int* sel_list_i, float* sample_s, int* sample_pos, int blocks,
                        int slots, unsigned long long* lists, int* counts, int* stats, float* out_s, int* out_i,
                        int width, int rows, void* stream) {
  const bool dense = c_dense != nullptr, sparse = c_idx != nullptr;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const ring::SparseArgs sp =
      ring::sparse_args(sparse, words, table, c_idx, c_val, nnz, vocab, weighted, w_dense, w_sparse);
  const ring::Grid g{blocks > 0 ? blocks : 1, width, rows};
  if (!(dense || sparse) || (dense && (!q || d < 1 || !aligned(c_dense))) ||
      (sparse && (!words || !table || !c_val || nnz < 1 || vocab < 0 || vocab > 0x7ffffffd || !aligned(c_idx) ||
                  !aligned(c_val))) ||
      (dense && sparse && (!weighted || dense_bf16 != val_bf16)) ||
      !ring::layout_ok(rows_layout != 0, dense, sparse, d, dense_bf16 ? 2 : 4, nnz, val_bf16 ? 2 : 4, sp.stage_words,
                     sp.nw) ||
      !ring::grid_ok(g, b) || (rows_layout && width > 1) ||
      !b1::plan_ok(b, n, n_valid, k, stride, cols, k_sample, sample_blocks, sample_scores, sample_s, sample_pos,
                   blocks, slots, lists, counts, stats, out_s, out_i))
    return int(cudaErrorInvalidValue);
  const int masked = n - n_valid < k ? n - n_valid : k;
  const b1::Plan p{stride, cols, k_sample, sample_blocks, blocks, slots, masked};
  const b1::SampleArgs sa{q, c_dense, dense ? d : 0, b, n_valid, stride, cols, sample_scores};
  const large::SelArgs sel = b1::sel_args(sample_scores, b, cols, k_sample, sel_ws, sel_cap, sel_chunk_rows,
                                          sel_chunks, sel_list_cap, sel_list_s, sel_list_i, sample_s, sample_pos);
  const b1::FilterArgs fa{q, c_dense, dense ? d : 0, b, n_valid, stride, k, slots, k_sample, sample_s, sample_pos,
                          lists, counts, stats};
  const bool direct = stride == 1;   // the merge reads the sample's scores
  const b1::MergeArgs ma{k, n_valid, stride, k_sample, blocks, slots, masked, direct ? sample_scores : sample_s,
                         direct ? nullptr : sample_pos, lists, counts, stats, out_s, out_i};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(ring::by_parts(dense, sparse, dense ? dense_bf16 != 0 : val_bf16 != 0, [&](auto parts) {
    using P = decltype(parts);
    if (rows_layout) return b2::run<P, ring::RowTile>(sa, sel, fa, ma, sp, p, l2, g, st);
    return g.width > 1 ? b2::run<P, ring::BoxCluster>(sa, sel, fa, ma, sp, p, l2, g, st)
                       : b2::run<P, ring::BoxOne>(sa, sel, fa, ma, sp, p, l2, g, st);
  }));
}

// Clusters of `width` (2 to 8) blocks of the filter pass on the box layout
// that fit the card at once, into *fit: the filter's blocks along x
// (mips_topk.py ring_grid).  dense / sparse name the parts present, bf16
// their dtype; d, nnz and vocab their shapes (the index words are staged
// in shared memory up to kWordsSmemCap).  Returns a cudaError_t.
int fused_ring_clusters(int dense, int sparse, int bf16, int d, int nnz, int vocab, int l2, int width, int* fit) {
  if (!fit || !(dense || sparse) || (dense && d < 1) || (sparse && (nnz < 1 || vocab < 0)) || width < 2 ||
      width > ring::kMaxCluster || (l2 && !dense))
    return int(cudaErrorInvalidValue);
  b1::FilterArgs fa{};
  fa.d = dense ? d : 0;
  const ring::SparseArgs sp =
      ring::sparse_args(sparse != 0, nullptr, nullptr, nullptr, nullptr, nnz, vocab, 1, 0.f, 0.f);
  const ring::FusedArgs<b1::FilterArgs> ff{fa, sp};
  return int(ring::by_parts(dense, sparse, bf16 != 0, [&](auto parts) {
    using P = decltype(parts);
    using T = ring::BoxCluster<typename P::TD, typename P::TV, P::DENSE, P::SPARSE>;
    if constexpr (P::DENSE) {
      if (l2) return ring::fused_cluster_fit<typename P::TD, typename P::TV, true, P::SPARSE, true, b1::FilterTiles, T>(
          ff, width, fit);
    }
    return ring::fused_cluster_fit<typename P::TD, typename P::TV, P::DENSE, P::SPARSE, false, b1::FilterTiles, T>(
        ff, width, fit);
  }));
}

}  // extern "C"
