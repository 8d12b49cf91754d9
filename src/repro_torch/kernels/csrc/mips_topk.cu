// B1: exact dense ip or negated-l2 top-k (k <= 2048) in one scan of the
// corpus, for sm_90a.  Replaces src/repro/kernels/mips_topk.py
// mips_topk_pallas (with _kernel and _fold_topk): scores [B, D] x [N, D]^T,
// rows at or past n_valid scoring f32-min (NEG), the top k of every query
// by (order_key descending, row ascending), lax.top_k's order
// (topk_scan.cuh: order_key).
//
// What bounds it on an H100 SXM (80 GB at 3.35 TB/s, 67 TFLOP/s f32 on CUDA
// cores): the corpus read, 27.16 GB = 8.1 ms for 8.84M x 768 f32, against
// 3.2 ms of FMAs at B = 16; above 16 queries the ring's clusters read the
// corpus once for up to 128 (ring.cuh Grid), and the FMAs bound it (12.97
// ms at B = 64) with the consumers' issue rate.  At DIN's 100M x 18 the
// read is 7.2 GB (2.15 ms) in f32 and 3.6 GB in bf16, and what bounds the
// row layout is the consumers' instructions a tile (the FMAs, the reads,
// the epilogue), not the bytes.  The TPU kernel carries a running top-k
// from grid step to grid step; the first port (topk_scan.cu) kept a candidate list
// per query in shared memory and sorted it whenever it filled, which above
// k = 256 cut the queries a block to 4 (the corpus read four times at
// B = 16) and put a bitonic sort of up to 4,096 entries in lockstep with the
// multiply.  Here selection leaves the scan's way:
//
// 1. sample   the ring of ring.cuh (persistent blocks, multiplying warps
//             fed by one more through a ring of copies: tensor-map boxes,
//             or whole rows of D <= 32 by one bulk copy a tile) scores the
//             tiles 0, stride, 2*stride, ... into a [B, cols] buffer
//             (SampleTiles);
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
//             entries) is sorted in place by the block's multiplying warps; its
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
//
// B2 runs this route too (fused_topk.cu, fused_filter_launch): the sample,
// the selection, the filter and the merge are one code, filter.cuh's,
// which both entry points include.  B2's tiles carry sparse stages beside
// the dense ones (ring.cuh fused_kernel: the COO ids and values of a tile
// as tensor-map boxes of 16 slots, or whole by bulk copies in the row
// layout), and a score policy forms the fused score at the end of a tile
// (w_d * dense + w_s * sparse, either part absent) and hands the epilogue
// finished scores, as an ip tile's.  What bounds B2 at MS MARCO scale is
// the bytes (36.2 GB = 10.8 ms at B = 16) and the consumers' per-slot work
// beside the dense FMAs; on DIN's items with one tag, as for B1's row
// layout, the consumers' instructions a tile (PERF.md).
#include "filter.cuh"

namespace b1 {

// Whether the corpus's rows go through a tensor map (a multiple of 16
// bytes) or whole, by bulk copies (RowStage: at most kChunk columns).
template <typename TD>
bool box_rows(int d) { return d * sizeof(TD) % 16 == 0; }

template <typename TD, typename E, typename S>
cudaError_t launch_layout(const typename E::Args& a, const CUtensorMap& map, int l2, const ring::Grid& g,
                          cudaStream_t st) {
  return l2 ? ring::launch_dense<TD, true, E, S>(a, map, g, st) : ring::launch_dense<TD, false, E, S>(a, map, g, st);
}

template <typename TD, typename E>
cudaError_t launch_ring(const typename E::Args& a, const CUtensorMap& map, int l2, const ring::Grid& g,
                        cudaStream_t st) {
  if (box_rows<TD>(a.d)) return launch_layout<TD, E, ring::Stage<TD>>(a, map, l2, g, st);
  if (a.d % 2 == 0) return launch_layout<TD, E, ring::RowStage<TD, true>>(a, map, l2, g, st);
  return launch_layout<TD, E, ring::RowStage<TD, false>>(a, map, l2, g, st);
}

// The clusters of `width` filter blocks (the pass with the lists) that fit the card at once; only the
// tensor-map layout launches clusters.
template <typename TD>
cudaError_t cluster_fit(const FilterArgs& a, int l2, int width, int* fit) {
  return l2 ? ring::cluster_fit<TD, true, FilterTiles>(a, width, fit)
            : ring::cluster_fit<TD, false, FilterTiles>(a, width, fit);
}

// g: the query groups' grid (its blocks are the filter's; the sample's are p.sample_blocks).
template <typename TD>
cudaError_t run(const SampleArgs& sa, const large::SelArgs& sel, const FilterArgs& fa, const MergeArgs& ma,
                const Plan& p, int l2, const ring::Grid& g, cudaStream_t st) {
  CUtensorMap map{};   // unused by the row layout
  if (sa.n_valid > 0 && box_rows<TD>(sa.d)) {
    const cudaError_t err = ring::tensor_map<TD>(sa.c, sa.d, sa.n_valid, &map);
    if (err != cudaSuccess) return err;
  }
  const ring::Grid gs{p.sample_blocks, g.width, g.rows}, gf{p.blocks, g.width, g.rows};
  return run_passes(
      sa, sel, fa, ma, p, [&] { return launch_ring<TD, SampleTiles>(sa, map, l2, gs, st); },
      [&] { return launch_ring<TD, FilterTiles>(fa, map, l2, gf, st); }, st);
}

}  // namespace b1

extern "C" {

// Dense ip (l2 = 0) or negated-l2 (l2 = 1) top k of n rows, rows at or
// past n_valid scoring f32-min, into out_s / out_i [b, k].  c is f32
// (c_bf16 = 0) or bf16, 16-byte aligned, with d a multiple of 4 (f32) or 8
// (bf16) values (the tensor-map layout) or d <= 32 (the row layout: whole
// rows by bulk copies, DIN's d = 18); q is the queries grouped as the ring reads them
// (mips_topk.py: query_groups).  The plan and every buffer come from
// mips_topk.py (filter_plan, filter_buffers): the sample's scores [b, cols], the
// selection's workspace, lists and top list [b, k_sample] (topk_large.py:
// select_large's shapes; unused at stride 1, where k_sample = cols), the
// filter's lists [b, blocks, slots] and counts [b, blocks], stats [b, 2]
// (list sorts, candidates merged).  The grid along y (ring.cuh Grid):
// rows x width query groups (q holds that many), in clusters of width
// blocks that read each corpus stage once (width 1: no cluster; the
// tensor-map layout only).  Returns a cudaError_t.
int mips_filter_launch(const float* q, const void* c, int c_bf16, int d, int b, int n, int n_valid, int k,
                       int l2, int stride, int cols, int k_sample, int sample_blocks, float* sample_scores,
                       int* sel_ws, int sel_cap, int sel_chunk_rows, int sel_chunks, long long sel_list_cap,
                       float* sel_list_s, int* sel_list_i, float* sample_s, int* sample_pos, int blocks,
                       int slots, unsigned long long* lists, int* counts, int* stats, float* out_s, int* out_i,
                       int width, int rows, void* stream) {
  const int elems = c_bf16 ? 8 : 4;
  const ring::Grid g{blocks > 0 ? blocks : 1, width, rows};
  if (!q || !c || d < 1 || (d % elems && d > ring::kChunk) || reinterpret_cast<uintptr_t>(c) % 16 ||
      !ring::grid_ok(g, b) || (width > 1 && d % elems) ||
      !b1::plan_ok(b, n, n_valid, k, stride, cols, k_sample, sample_blocks, sample_scores, sample_s, sample_pos,
                   blocks, slots, lists, counts, stats, out_s, out_i))
    return int(cudaErrorInvalidValue);
  const int masked = n - n_valid < k ? n - n_valid : k;
  const b1::Plan p{stride, cols, k_sample, sample_blocks, blocks, slots, masked};
  const b1::SampleArgs sa{q, c, d, b, n_valid, stride, cols, sample_scores};
  const large::SelArgs sel = b1::sel_args(sample_scores, b, cols, k_sample, sel_ws, sel_cap, sel_chunk_rows,
                                          sel_chunks, sel_list_cap, sel_list_s, sel_list_i, sample_s, sample_pos);
  const b1::FilterArgs fa{q, c, d, b, n_valid, stride, k, slots, k_sample, sample_s, sample_pos, lists, counts, stats};
  const bool direct = stride == 1;   // the merge reads the sample's scores
  const b1::MergeArgs ma{k, n_valid, stride, k_sample, blocks, slots, masked, direct ? sample_scores : sample_s,
                         direct ? nullptr : sample_pos, lists, counts, stats, out_s, out_i};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(c_bf16 ? b1::run<__nv_bfloat16>(sa, sel, fa, ma, p, l2, g, st)
                    : b1::run<float>(sa, sel, fa, ma, p, l2, g, st));
}

// Clusters of `width` (2 to 8) blocks of the filter pass on a corpus of d
// columns (f32, or bf16 when c_bf16; the tensor-map layout: d a multiple
// of 4 or 8) that fit the card at once, into *fit: the filter's blocks
// along x (mips_topk.py ring_grid).  Returns a cudaError_t.
int mips_ring_clusters(int c_bf16, int d, int l2, int width, int* fit) {
  const int elems = c_bf16 ? 8 : 4;
  if (!fit || d < 1 || d % elems || width < 2 || width > ring::kMaxCluster)
    return int(cudaErrorInvalidValue);
  b1::FilterArgs a{};
  a.d = d;
  return int(c_bf16 ? b1::cluster_fit<__nv_bfloat16>(a, l2, width, fit) : b1::cluster_fit<float>(a, l2, width, fit));
}

}  // extern "C"
