// The dense score ring shared by topk_large.cu (every row's score into a
// [B, n_valid] buffer) and mips_topk.cu (B1: a sample of tiles scored into
// a small buffer, then a scan that keeps only the rows above a threshold).
//
// Persistent blocks (two an SM) score tiles of kTileRows rows for kQB
// queries.  The multiplying warps hold an R-row x 4-query register tile
// per thread (fmaf in column order, |c|^2 in the same pass for l2); one
// more warp feeds them a ring of shared-memory stages, each handed over on
// an mbarrier, so that the next stages' loads are in flight while one is
// multiplied and no barrier holds the whole block.  Two stage layouts,
// chosen by template parameter:
//   Stage<TD>      rows of a multiple of 16 bytes (D = 768, 64, 16 ...):
//                  kChunk columns of a tile as one tensor-map box, and the
//                  queries' kChunk columns; a tile is ceil(D / kChunk)
//                  stages; two blocks an SM of four multiplying warps,
//                  each thread 8 rows x 4 queries;
//   RowStage<TD>   rows of at most kChunk columns that no tensor map can
//                  describe (DIN's D = 18: 72 bytes in f32, 36 in bf16):
//                  a whole tile, its rows row-major and unswizzled, by one
//                  bulk copy of contiguous bytes; one stage a tile, the
//                  queries read once into shared memory; two blocks an SM,
//                  since at such D a tile's fixed costs (the epilogue, the
//                  hand-overs) weigh as much as its FMAs and eight warps
//                  an SM leave their latencies exposed (PERF.md).
// What a finished tile's scores become is the epilogue's business: a
// policy type E gives the tiles a launch walks and what happens at the end
// of each (see dense_kernel).
//
// A batch of more than kQB queries (G = ceil(B / 16) groups) runs as
// thread-block clusters of the groups' blocks along y (Grid: at most
// kMaxCluster a cluster, so up to 128 queries share a read).  The blocks
// of a cluster share blockIdx.x, so they walk the same tiles, and each
// corpus stage lands in all of them from the first block's one multicast
// copy, so that the corpus is read once for the cluster instead of once a
// group.  Each block keeps its 16 queries, its consumers and its epilogue;
// a slot is refilled only when every block of the cluster has released it
// (the consumers arrive on the first block's empty barriers across the
// cluster).  A launch of one group a cluster (width 1) is the launch
// without clusters: a grid of G rows of blocks, each reading the whole
// corpus.  Only the tensor-map layouts (Stage<TD>, BoxTile) launch
// clusters.
//
// The second half of the file is the fused ring (fused_kernel: B2's, and
// B4's with the StoreAll epilogue): the same blocks, warps, hand-overs and
// clusters over tiles that carry sparse stages beside the dense ones.  In
// the tensor-map layout (BoxTile) a tile's COO ids and values follow its
// dense stages as [kTileRows, kSlotChunk] boxes, copied by the copy warp
// (in a cluster, each stage by the first block's one multicast copy); in
// the row layout (RowTile) a tile is one stage of its dense rows, ids and
// values, each by one bulk copy.  The consumers turn slots into hits
// through the query-term index of their block's group in registers, a
// row's hits passed round its four lanes by shuffles (sparse_box,
// rows_round), and a score policy (SparseArgs: parts, weights; l2 as
// dense_score) forms the fused score at the end of the tile, which the
// epilogue takes as an ip tile's finished scores.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include <type_traits>

#include "topk_scan.cuh"

namespace ring {

constexpr int kTileRows = 256;     // rows of a tile
constexpr int kQB = 16;            // queries of a block
constexpr int kChunk = 32;         // columns of a ring stage
constexpr int kStages = 4;         // ring depth of the tensor-map layout
constexpr int kQStage = kChunk * kQB * 4;   // query bytes of a stage
constexpr int kConsumers = 8;      // warps that multiply, by default (consumers_sync)
// The multiplying threads of a block whose threads hold R rows x 4 queries of a tile each.
template <int R>
__host__ __device__ constexpr int consumer_threads() { return kTileRows * kQB / (4 * R); }
constexpr int kMaxCluster = 8;     // query groups a cluster: the portable cluster size

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* b, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(smem_u32(b)), "r"(parity) : "memory");
}
// bytes (a multiple of 16) from global to shared memory by the copy engine
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, unsigned long long* b) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(b)) : "memory");
}
// a [kTileRows, kChunk] box of the corpus at (row, col) by the tensor map;
// rows and columns outside the corpus read as zero
__device__ __forceinline__ void tile_copy(void* dst, const CUtensorMap* map, int col, int row, unsigned long long* b) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
               ::"r"(smem_u32(dst)), "l"(map), "r"(col), "r"(row), "r"(smem_u32(b)) : "memory");
}
// The box copy multicast: the bytes land at the same offset in the shared memory of every block of the
// cluster in `mask`, each completing on its own barrier at the offset of `b`.
__device__ __forceinline__ void tile_copy_mc(void* dst, const CUtensorMap* map, int col, int row, unsigned long long* b,
                                             unsigned short mask) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n"
               ::"r"(smem_u32(dst)), "l"(map), "r"(col), "r"(row), "r"(smem_u32(b)), "h"(mask) : "memory");
}
__device__ __forceinline__ unsigned cluster_blocks() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Every live thread of the cluster, with release and acquire: what a block wrote to shared memory before
// (its barriers' initialisation) is seen by its peers after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
// An arrive on the barrier at b's offset in block `rank` of the cluster (CUTLASS's ClusterBarrier::arrive:
// the default semantics; release at cluster scope fences every arrive, and measured three times slower).
__device__ __forceinline__ void mbar_arrive_at(unsigned long long* b, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(b)), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
}

// Named barrier 1 of the NT multiplying threads; the copy warp, which
// returns once its copies are issued, takes no part.
template <int NT = kConsumers * 32>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");
}

// Stage<TD>: a stage holds a tile's rows for kChunk columns, row-major, as
// the tensor map's 128-byte (f32) or 64-byte (bf16) swizzle lays them out:
// the 16-byte pieces of a row XORed with its index, so that the eight rows
// a warp reads at once (rows x..x+7, the same columns) hit distinct banks;
// then the block's 16 queries' values of those columns, column-major.
// In dense_kernel a thread holds 8 rows x 4 queries of a tile (four
// multiplying warps a block) and two blocks share an SM, each a ring of
// three stages: once the corpus is read once for several groups, the
// consumers bound the ring, and one block of eight warps of 4 x 4 left
// about 40% of their issue slots stalled; more FMAs a shared-memory read
// and two blocks' warps to hide each other's latency took B = 64 from 32
// to 26 ms (PERF.md).  The fused ring's tensor-map layout (BoxTile)
// multiplies its dense stages at 4 x 4 for one group, 8 x 4 in clusters.
template <typename TD>
struct Stage {
  static constexpr int kMaxStages = 3;
  static constexpr int kBlocksPerSM = 2;
  static constexpr int kRows = 8;                                    // rows of a thread
  static constexpr int kConsumers = consumer_threads<kRows>() / 32;  // 4 multiplying warps
  static constexpr int kThreads = (kConsumers + 1) * 32;
  static constexpr int kRowBytes = kChunk * int(sizeof(TD));   // 128 (f32) or 64 (bf16)
  static constexpr int kPieces = kRowBytes / 16;
  static constexpr int kTile = kTileRows * kRowBytes;
  static constexpr int kBytes = kTile + kQStage;
  static constexpr unsigned kAlign = 1024;   // the swizzled boxes
  static constexpr int kHead = 0;            // shared bytes ahead of the ring
  static constexpr bool kSets = false;       // multiply adds to acc and c2 (a tile is several stages)
  __host__ __device__ static int chunks(int d) { return (d + kChunk - 1) / kChunk; }
  __host__ __device__ static int bytes(int) { return kBytes; }
  __host__ __device__ static int stages(int) { return kMaxStages; }
  __device__ static const float* queries(const unsigned char*, const unsigned char* st) {
    return reinterpret_cast<const float*>(st + kTile);
  }
  __device__ static int piece(int row, int j) { return j ^ ((row / (8 / kPieces)) & (kPieces - 1)); }
  // columns [4 * c4, +4) of tile row `row` as f32
  __device__ static float4 read4(const unsigned char* st, int row, int c4) {
    if constexpr (sizeof(TD) == 4) {
      return *reinterpret_cast<const float4*>(st + row * kRowBytes + 16 * piece(row, c4));
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(st + row * kRowBytes + 16 * piece(row, c4 >> 1) + 8 * (c4 & 1));
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      return make_float4(lo.x, lo.y, hi.x, hi.y);
    }
  }
  // by the copying thread, the slot free: the box at (row0, col0) through
  // the tensor map (rows past n_valid read as zero) and the queries' columns
  __device__ static void copy(unsigned char* st, const CUtensorMap* map, const void*, int, long long,
                              long long row0, int col0, const float* qg, unsigned long long* full) {
    mbar_expect_tx(full, kBytes);
    tile_copy(st, map, col0, int(row0), full);
    bulk_copy(st + kTile, qg + size_t(col0) * kQB, kQStage, full);
  }
  // The same in a cluster of `cs` blocks: the box lands in every block from the first block's one
  // multicast copy.  Each block copies its own queries and expects the whole stage on its own barrier (the
  // first block's bytes may land before this arrive: the barrier's transaction count runs below zero
  // until it comes).
  static constexpr bool kCluster = true;
  __device__ static void copy_cluster(unsigned char* st, const CUtensorMap* map, long long row0, int col0,
                                      const float* qg, unsigned long long* full, unsigned rank, unsigned cs) {
    mbar_expect_tx(full, kBytes);
    if (rank == 0) tile_copy_mc(st, map, col0, int(row0), full, static_cast<unsigned short>((1u << cs) - 1u));
    bulk_copy(st + kTile, qg + size_t(col0) * kQB, kQStage, full);
  }
  template <bool L2, int R>
  __device__ static void multiply(const unsigned char* st, const float* qs, int, int row_in, int qgi,
                                  float (&acc)[R][4], float (&c2)[R]);
};

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <typename TD>
template <bool L2, int R>
__device__ __forceinline__ void Stage<TD>::multiply(const unsigned char* st, const float* qs, int, int row_in,
                                                    int qgi, float (&acc)[R][4], float (&c2)[R]) {
#pragma unroll
  for (int c4 = 0; c4 < kChunk / 4; ++c4) {
    float4 x[R];
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] = read4(st, row_in + 8 * r, c4);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float4 qv = *reinterpret_cast<const float4*>(qs + (4 * c4 + cc) * kQB + 4 * qgi);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float xv = comp(x[r], cc);
        if (L2) c2[r] = fmaf(xv, xv, c2[r]);
        acc[r][0] = fmaf(qv.x, xv, acc[r][0]);
        acc[r][1] = fmaf(qv.y, xv, acc[r][1]);
        acc[r][2] = fmaf(qv.z, xv, acc[r][2]);
        acc[r][3] = fmaf(qv.w, xv, acc[r][3]);
      }
    }
  }
}

// One column of a thread's four rows into its 4 x 4 accumulators (kFirst:
// onto +0, whatever they held).
template <bool L2, bool kFirst>
__device__ __forceinline__ void fma_column(const float (&xv)[4], const float4& qv, float (&acc)[4][4],
                                           float (&c2)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (L2) c2[r] = fmaf(xv[r], xv[r], kFirst ? 0.f : c2[r]);
    acc[r][0] = fmaf(qv.x, xv[r], kFirst ? 0.f : acc[r][0]);
    acc[r][1] = fmaf(qv.y, xv[r], kFirst ? 0.f : acc[r][1]);
    acc[r][2] = fmaf(qv.z, xv[r], kFirst ? 0.f : acc[r][2]);
    acc[r][3] = fmaf(qv.w, xv[r], kFirst ? 0.f : acc[r][3]);
  }
}

// RowStage<TD, kPair>: a stage holds one tile's rows of d <= kChunk
// columns as they lie in the corpus, row-major and unswizzled, rows x d x
// sizeof(TD) bytes, copied by one cp.async.bulk of the tile's contiguous
// bytes.  The tile starts 16-byte aligned when the corpus does (kTileRows
// x d x sizeof(TD) is a multiple of 16); a ragged last tile copies its
// largest multiple of 16 bytes in bulk, and the copying thread stores the
// few bytes left and zeroes the rows past n_valid (their scores are
// f32-min by index in the epilogues; zero keeps a stale NaN out of the
// sums), so that no read passes the corpus.  The block's queries are read
// into shared memory once, ahead of the ring (a launch has one chunk).
// Two blocks share an SM, each in at most kSmem of shared memory: the ring
// is as deep as fits (6 stages at d = 18 in f32, 3 at d = 31, at most
// kMaxStages).  The consumers read their rows with aligned reads: pairs
// of columns (8 bytes in f32, 4 in bf16) where d is even (kPair), else one
// column at a time; they loop over the d real columns only, and set their
// sums at the first column (fmaf onto +0) rather than clear them after the
// tile's epilogue, since a tile is one stage.  Banks: the eight rows
// a warp reads at once lie d x sizeof(TD) bytes apart; at 72 bytes (d =
// 18, f32) their words start at banks 0, 18, 4, 22, 8, 26, 12, 30, and an
// 8-byte pair takes each its next bank too: no conflict.  The same holds
// for every d of the layout whose row is a whole number of words (a
// stride of s words, s odd or twice an odd number, puts eight rows on
// eight distinct banks, or pairs of banks); an odd d in bf16 may meet a
// two-way conflict.
template <typename TD, bool kPair>
struct RowStage {
  static constexpr int kMaxStages = 8;
  static constexpr int kBlocksPerSM = 2;    // two blocks an SM: sixteen multiplying warps
  static constexpr int kRows = 4;           // rows of a thread: 4 x 4, eight multiplying warps
  static constexpr int kConsumers = consumer_threads<kRows>() / 32;
  static constexpr int kThreads = (kConsumers + 1) * 32;
  static constexpr int kSmem = 112 * 1024;  // shared memory of a block, so that two fit an SM's 228 KB
  static constexpr unsigned kAlign = 16;
  static constexpr int kHead = kQStage;     // the block's queries, kChunk columns
  static constexpr bool kSets = true;       // multiply sets acc and c2: a stage is the whole tile
  static constexpr bool kCluster = false;   // a block a group: the consumers bound it, not the bytes (PERF.md)
  __host__ __device__ static int chunks(int) { return 1; }
  __host__ __device__ static int bytes(int d) { return kTileRows * d * int(sizeof(TD)); }
  // stages in flight: as many as fit kSmem (3 at d = 31 in f32, 6 at d = 18), at most kMaxStages
  __host__ __device__ static int stages(int d) {
    const int fit = (kSmem - kHead - int(kAlign)) / bytes(d);
    return fit < kMaxStages ? fit : kMaxStages;
  }
  __device__ static const float* queries(const unsigned char* smem, const unsigned char*) {
    return reinterpret_cast<const float*>(smem);
  }
  __device__ static void copy(unsigned char* st, const CUtensorMap*, const void* c, int d, long long n_valid,
                              long long row0, int, const float*, unsigned long long* full) {
    const long long rows = n_valid - row0 < kTileRows ? n_valid - row0 : kTileRows;
    const unsigned size = unsigned(rows) * unsigned(d) * sizeof(TD);
    const unsigned bulk = size & ~15u;
    const unsigned char* src = static_cast<const unsigned char*>(c) + size_t(row0) * d * sizeof(TD);
    if (bulk < unsigned(bytes(d))) {   // the corpus's ragged end: the tail by plain loads, then zeros
      const unsigned up = (size + 15u) & ~15u;
      using W = std::conditional_t<sizeof(TD) == 4, unsigned, unsigned short>;   // a value's bits
      for (unsigned i = bulk; i < up; i += sizeof(TD))
        *reinterpret_cast<W*>(st + i) = i < size ? *reinterpret_cast<const W*>(src + i) : W(0);
      for (unsigned i = up; i < unsigned(bytes(d)); i += 16) *reinterpret_cast<uint4*>(st + i) = make_uint4(0, 0, 0, 0);
      // these stores are the generic proxy's; order them before any later copy-engine write of the slot
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    mbar_expect_tx(full, bulk);   // an arrive, with the bytes the copy engine moves
    if (bulk > 0) bulk_copy(st, src, bulk, full);
  }
  template <bool L2>
  __device__ static void multiply(const unsigned char* st, const float* qs, int d, int row_in, int qgi,
                                  float (&acc)[4][4], float (&c2)[4]) {
    const TD* x0 = reinterpret_cast<const TD*>(st) + row_in * d;   // row row_in; row row_in + 8r at + 8rd
    const int step = 8 * d;
    const float* q = qs + 4 * qgi;
    if constexpr (kPair) {
      float lo[4], hi[4];
      pair(x0, step, 0, lo, hi);
      fma_column<L2, true>(lo, *reinterpret_cast<const float4*>(q), acc, c2);
      fma_column<L2, false>(hi, *reinterpret_cast<const float4*>(q + kQB), acc, c2);
#pragma unroll 4
      for (int c = 2; c < d; c += 2) {
        pair(x0, step, c, lo, hi);
        fma_column<L2, false>(lo, *reinterpret_cast<const float4*>(q + c * kQB), acc, c2);
        fma_column<L2, false>(hi, *reinterpret_cast<const float4*>(q + (c + 1) * kQB), acc, c2);
      }
    } else {
      float xv[4];
      column(x0, step, 0, xv);
      fma_column<L2, true>(xv, *reinterpret_cast<const float4*>(q), acc, c2);
#pragma unroll 3
      for (int c = 1; c < d; ++c) {
        column(x0, step, c, xv);
        fma_column<L2, false>(xv, *reinterpret_cast<const float4*>(q + c * kQB), acc, c2);
      }
    }
  }
  // columns c and c + 1 (c even, d even: aligned pairs) of the thread's four rows
  __device__ static void pair(const TD* x0, int step, int c, float (&lo)[4], float (&hi)[4]) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float2 x;
      if constexpr (sizeof(TD) == 4) {
        x = *reinterpret_cast<const float2*>(x0 + r * step + c);
      } else {
        x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x0 + r * step + c));
      }
      lo[r] = x.x;
      hi[r] = x.y;
    }
  }
  // column c of the thread's four rows
  __device__ static void column(const TD* x0, int step, int c, float (&xv)[4]) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if constexpr (sizeof(TD) == 4) {
        xv[r] = x0[r * step + c];
      } else {
        xv[r] = __bfloat162float(x0[r * step + c]);
      }
    }
  }
};

// The score of a finished accumulator: the inner product, or l2's
// -((|q|^2 + |c|^2) - 2 s), the grouping of spaces.dense_scores.
template <bool L2>
__device__ __forceinline__ float dense_score(float acc, float c2, float q2) {
  return L2 ? -__fsub_rn(__fadd_rn(q2, c2), __fmul_rn(2.f, acc)) : acc;
}

struct StoreArgs {
  const float* q;     // [groups, D rounded up to kChunk, 16] f32 (mips_topk.py: query_groups), or null
  const void* c;      // [N, D] f32/bf16, or null
  int d, b, n_valid, l2, weighted;
  float w;
  float* scores;      // [B, n_valid]
};

// The epilogue that keeps every score (topk_large.cu's dense pass; B4,
// fused_score.cu, on the fused ring): every tile, every row below n_valid,
// stores its score (times w when weighted) as 32-byte sectors.  The fused
// ring hands it finished scores (weighted = 0: its score policy has mixed
// them).
struct StoreAll {
  using Args = StoreArgs;
  struct Shared {};
  __device__ static long long units(const Args& a) { return (a.n_valid + kTileRows - 1) / kTileRows; }
  __device__ static long long first_row(const Args&, long long u) { return u * kTileRows; }
  __device__ static void init(const Args&, Shared&, int, int, int) {}
  template <bool L2, int R>
  __device__ static void tile(const Args& a, Shared&, long long, long long tile_row0, int row_in,
                              const float (&acc)[R][4], const float (&c2)[R], const float* q2s, int q0, int qn,
                              int lane) {
    const int qgi = lane & 3;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = tile_row0 + row_in + 8 * r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = 4 * qgi + j;
        float v = dense_score<L2>(acc[r][j], c2[r], q2s[q]);
        if (a.weighted) v = __fmul_rn(a.w, v);
        if (row < a.n_valid && q < qn) a.scores[size_t(q0 + q) * a.n_valid + row] = v;
      }
    }
  }
  template <int R = 4>
  __device__ static void finish(const Args&, Shared&, int, int) {}
};

// Warps 0 .. S::kConsumers - 1 multiply: thread (warp w, lane l) holds
// rows (256 / kConsumers) w + l/4 + 8r (r < S::kRows) of a tile and
// queries 4(l%4) .. +3 of the block's 16 (Stage: 4 warps of 8 rows;
// RowStage: 8 warps of 4).  The next warp copies: for each stage it waits
// until the multiplying warps have released the ring slot, then one
// thread copies the stage (S::copy), completing on the slot's `full`
// barrier.  In a cluster (launch_dense, Grid; Stage<TD> only) each
// block's copying thread copies its queries and the first block's the box
// for the whole cluster (S::copy_cluster), once every block has released
// the slot: the first block's `empty` barrier counts the warps of all.
//
// E::Args carries q (the queries as [groups, d_pad, 16], d_pad = d rounded
// up to kChunk, zero-padded: mips_topk.py query_groups), c, d, b and
// n_valid.  The policy E gives
//   units(a)                 the tiles of the launch (block x takes units
//                            x, x + gridDim.x, ...),
//   first_row(a, u)          the first corpus row of unit u,
//   Shared, init(a, sh, t, q0, qn)
//                            state in shared memory, set by threads t < kQB
//                            before the ring starts,
//   tile<L2>(a, sh, u, tile_row0, row_in, acc, c2, q2s, q0, qn, lane)
//                            called by every multiplying thread when its
//                            tile is scored (acc[R][4]: its rows tile_row0
//                            + row_in + 8r), before acc and c2 are cleared,
//   finish<R>(a, sh, q0, qn) called by every multiplying thread at the end.
// The stage layout S (Stage<TD> by default, or RowStage<TD, pair>) gives
// how a stage is copied and multiplied; the map is unused by RowStage.
template <typename TD, bool L2, typename E, typename S = Stage<TD>>
__global__ void __launch_bounds__(S::kThreads, S::kBlocksPerSM)
    dense_kernel(typename E::Args a, const __grid_constant__ CUtensorMap map) {
  constexpr int R = S::kRows, NC = S::kConsumers;
  extern __shared__ __align__(16) unsigned char ring_raw[];
  unsigned char* smem = ring_raw + ((S::kAlign - (smem_u32(ring_raw) & (S::kAlign - 1))) & (S::kAlign - 1));
  unsigned char* slots = smem + S::kHead;   // the ring's stages
  __shared__ __align__(8) unsigned long long full[S::kMaxStages], empty[S::kMaxStages];
  __shared__ long long row0s[S::kMaxStages];   // each stage's first corpus row, from the copying thread
  __shared__ float q2s[kQB];
  __shared__ typename E::Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.y * kQB, qn = min(kQB, a.b - q0);
  const int cpt = S::chunks(a.d);   // stages a tile
  const int stage_bytes = S::bytes(a.d);
  const int nst = S::stages(a.d);   // the ring's depth
  const float* qg = a.q + size_t(blockIdx.y) * ((a.d + kChunk - 1) / kChunk) * kChunk * kQB;
  const long long n_units = E::units(a);
  const long long mine = blockIdx.x < n_units ? (n_units - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long total = mine * cpt;
  const unsigned cs = S::kCluster ? cluster_blocks() : 1;   // 1: no cluster
  const unsigned rank = cs > 1 ? cluster_rank() : 0;

  if (tid == 0) {
    for (int i = 0; i < nst; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], rank == 0 ? NC * cs : NC);   // the first block's copies land in every block
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (L2 && tid < kQB) {
    float acc = 0.f;
    for (int j = 0; j < a.d; ++j) acc = fmaf(qg[j * kQB + tid], qg[j * kQB + tid], acc);
    q2s[tid] = acc;
  }
  if constexpr (S::kHead > 0) {   // the queries' kChunk columns, once
    float* qh = reinterpret_cast<float*>(smem);
    for (int i = tid; i < kChunk * kQB; i += S::kThreads) qh[i] = qg[i];
  }
  if (tid < kQB) E::init(a, sh, tid, q0, qn);
  if (cs > 1) {
    cluster_sync();   // every peer's barriers are initialised before a copy can complete on them
  } else {
    __syncthreads();
  }

  if (warp == NC) {   // the copying warp
    if (lane == 0) {
      int slot = 0;
      unsigned ph = 0;   // the parity of the ring's round
      for (long long s = 0; s < total; ++s) {
        // the last round's stage in this slot is released (in the first block of a cluster: by every block)
        if (s >= nst) mbar_wait(&empty[slot], ph ^ 1u);
        const long long row0 = E::first_row(a, blockIdx.x + (s / cpt) * gridDim.x);
        row0s[slot] = row0;   // before the copy's arrive on `full` releases it
        unsigned char* st = slots + size_t(slot) * stage_bytes;
        const int col0 = int(s % cpt) * kChunk;
        if constexpr (S::kCluster) {
          if (cs > 1) {
            S::copy_cluster(st, &map, row0, col0, qg, &full[slot], rank, cs);
          } else {
            S::copy(st, &map, a.c, a.d, a.n_valid, row0, col0, qg, &full[slot]);
          }
        } else {
          S::copy(st, &map, a.c, a.d, a.n_valid, row0, col0, qg, &full[slot]);
        }
        if (++slot == nst) {
          slot = 0;
          ph ^= 1u;
        }
      }
    }
    if (cs > 1) {   // the kernel's last barrier, below
      __syncwarp();
      cluster_sync();
    }
    return;
  }

  const int qgi = lane & 3, rg = lane >> 2;
  const int row_in = kTileRows / NC * warp + rg;
  float acc[R][4], c2[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    c2[r] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  }
  int slot = 0;
  unsigned ph = 0;
  for (long long s = 0; s < total; ++s) {
    mbar_wait(&full[slot], ph);
    const unsigned char* st = slots + size_t(slot) * stage_bytes;
    S::template multiply<L2>(st, S::queries(smem, st), a.d, row_in, qgi, acc, c2);
    const long long row0 = row0s[slot];
    __syncwarp();
    if (lane == 0) {   // this warp is done with the slot: tell its block, and the first block of a cluster
      if (cs == 1) {
        mbar_arrive(&empty[slot]);
      } else {
        mbar_arrive_at(&empty[slot], rank);
        if (rank != 0) mbar_arrive_at(&empty[slot], 0);
      }
    }
    if (++slot == nst) {
      slot = 0;
      ph ^= 1u;
    }
    if (s % cpt == cpt - 1) {   // the tile is scored: hand it over, start the next
      const long long unit = blockIdx.x + (s / cpt) * gridDim.x;
      E::template tile<L2>(a, sh, unit, row0, row_in, acc, c2, q2s, q0, qn, lane);
      if constexpr (!S::kSets) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          c2[r] = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
        }
      }
    }
  }
  E::template finish<R>(a, sh, q0, qn);
  // no block leaves while a peer may still arrive on its barriers (the copies into it have all landed:
  // its consumers waited for every stage)
  if (cs > 1) cluster_sync();
}

// cuTensorMapEncodeTiled, looked up once (cudaGetDriverEntryPoint).
inline cudaError_t map_encoder(PFN_cuTensorMapEncodeTiled_v12000* out) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
                                              cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || encode == nullptr) return cudaErrorNotSupported;
  }
  *out = encode;
  return cudaSuccess;
}

// The corpus's tensor map: rows [0, rows) x columns [0, d), a box of
// kTileRows x kChunk, swizzled as Stage<TD> reads it.
template <typename TD>
cudaError_t tensor_map(const void* c, int d, long long rows, CUtensorMap* map) {
  PFN_cuTensorMapEncodeTiled_v12000 encode;
  const cudaError_t err = map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {cuuint64_t(d), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(d) * sizeof(TD)};
  const cuuint32_t box[2] = {cuuint32_t(kChunk), cuuint32_t(kTileRows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, sizeof(TD) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            2, const_cast<void*>(c), dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            sizeof(TD) == 4 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The dense ring's launch shape: `blocks` along x (the persistent blocks,
// or with clusters the clusters of a row that fit the card at once) by
// rows x width query groups along y, in clusters of `width` blocks (1: no
// cluster).  The queries' groups (mips_topk.py query_groups) number rows x
// width, those past the batch zero; a launch reads the corpus `rows` times.
struct Grid {
  int blocks, width, rows;
};

// Whether a grid holds b queries as the launch needs them.
inline bool grid_ok(const Grid& g, int b) {
  const long long groups = static_cast<long long>(g.rows) * g.width;
  return g.blocks >= 1 && g.width >= 1 && g.width <= kMaxCluster && g.rows >= 1 && groups <= 65535 &&
         groups * kQB >= b && (groups - g.width) * kQB < b;
}

template <typename TD, bool L2, typename E, typename S>
size_t dense_smem(const typename E::Args& a) {
  return size_t(S::kHead) + size_t(S::stages(a.d)) * S::bytes(a.d) + S::kAlign;   // room to align
}

// The launch shape of `width` blocks a cluster along y: grid (x, y), `threads` a block, `smem` bytes.
inline cudaLaunchConfig_t cluster_config(unsigned x, unsigned y, int width, int threads, size_t smem,
                                         cudaStream_t st, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(x, y);
  cfg.blockDim = dim3(unsigned(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = unsigned(width);
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// One launch of a ring kernel over Grid g (`smem` bytes of dynamic shared
// memory): <<<>>> at width 1, else cudaLaunchKernelEx in clusters of
// g.width blocks along y.  A cluster that cannot launch returns its error:
// nothing falls back to a launch without clusters.
template <typename... P, typename... A>
cudaError_t launch_grid(void (*kernel)(P...), const Grid& g, int threads, size_t smem, cudaStream_t st,
                        const A&... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  if (g.width == 1) {
    kernel<<<dim3(g.blocks, g.rows), threads, smem, st>>>(args...);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(unsigned(g.blocks), unsigned(g.rows * g.width), g.width, threads,
                                                smem, st, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Clusters of `width` blocks of a ring kernel that fit the card at once
// (cudaOccupancyMaxActiveClusters), into *fit.
template <typename... P>
cudaError_t fit_clusters(void (*kernel)(P...), int width, int threads, size_t smem, int* fit) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(1, unsigned(width), width, threads, smem, nullptr, attr);
  return cudaOccupancyMaxActiveClusters(fit, kernel, &cfg);
}

// One launch of dense_kernel<TD, L2, E, S> over Grid g, on corpus rows
// [0, a.n_valid) (Stage<TD>: through the tensor map of those rows); a
// layout that launches no cluster refuses a width above 1.
template <typename TD, bool L2, typename E, typename S = Stage<TD>>
cudaError_t launch_dense(const typename E::Args& a, const CUtensorMap& map, const Grid& g, cudaStream_t st) {
  if (g.width > 1 && !S::kCluster) return cudaErrorInvalidValue;
  auto kernel = dense_kernel<TD, L2, E, S>;
  return launch_grid(kernel, g, S::kThreads, dense_smem<TD, L2, E, S>(a), st, a, map);
}

// Clusters of `width` blocks of dense_kernel<TD, L2, E, S> that fit the card at once, into *fit.
template <typename TD, bool L2, typename E, typename S = Stage<TD>>
cudaError_t cluster_fit(const typename E::Args& a, int width, int* fit) {
  auto kernel = dense_kernel<TD, L2, E, S>;
  return fit_clusters(kernel, width, S::kThreads, dense_smem<TD, L2, E, S>(a), fit);
}

// ---------------------------------------------------------------------------
// The fused ring (B2's ring route, fused_topk.cu): the same persistent
// blocks, warps and hand-overs, over tiles whose stages carry the dense
// part, the sparse part (COO slots) or both, and a score policy that mixes
// them: w_d * dense + w_s * sum_j qd[b, idx[n, j]] * val[n, j], either part
// absent, each present part weighted or not (SparseArgs).
//
// The sparse part reads the query-term index of the block's 16 queries
// (topk_scan.cuh: index_row; kernels/query_index.py build_index with
// group kQB): its words in shared memory up to kWordsSmemCap bytes, else
// in global memory through the same code, and its compact table in global
// memory (L2).  A stage's COO slots become hits in the consumers' own
// registers: the four lanes that hold a row (lane >> 2 equal) hold its 16
// queries, so they look up its slots (in the box layout four slots each,
// sparse_box; in the row layout each lane its own row's, rows_round) and
// the row's hits go round those four lanes by shuffles, in slot order: no
// shared list, no block barrier a sparse stage.
// ---------------------------------------------------------------------------

constexpr int kSlotChunk = 16;   // COO slots of a box stage (topk_scan.cuh's kSparseChunk)
constexpr int kRowSlots = 32;    // the row layout's widest COO row

struct SparseArgs {
  const uint2* words;    // [groups, nw] the query-term index words of each group of kQB queries
  const float* table;    // [groups, vocab + 2, kQB] their compact tables
  const int* idx;        // [N, nnz] i32
  const void* val;       // [N, nnz] f32/bf16
  int nnz, vocab, nw;    // nw = index_words(vocab)
  int stage_words;       // the words fit kWordsSmemCap: copied to shared memory
  int weighted;          // one part: scale it (two parts are always weighted)
  float w_dense, w_sparse;
  int table_smem;        // shared bytes for the group's compact table (launch_fused sets it; 0: read from L2)
};

// The arguments of fused_kernel: the epilogue's (q, c, d, b, n_valid ...;
// q and c unused without a dense part) and the sparse part's.
template <typename EA>
struct FusedArgs {
  EA e;
  SparseArgs s;
};

// The slot's value of the four k, picked by a lane-varying k (a select chain, not local memory).
template <typename T>
__device__ __forceinline__ T pick(const T (&x)[4], int k) {
  return k == 0 ? x[0] : k == 1 ? x[1] : k == 2 ? x[2] : x[3];
}

// Four COO slots of a row as f32, read from shared memory: ids at `ids`, values at `vals`, the first
// `real` of them (0 to 4) real; a slot needs a multiply-add when it hits the query-term index (row != 0:
// its compact-table row) or its value is not finite (0 * inf and 0 * NaN are NaN: topk_scan.cuh
// stage_hits).  Returns the mask of such slots.
template <typename TV, bool kVec>
__device__ __forceinline__ unsigned look_up(const int* ids, const TV* vals, int real, const uint2* words,
                                            int vocab, int (&row)[4], float (&v)[4]) {
  int id[4];
  if constexpr (kVec) {   // four slots, 16-byte aligned ids
    const int4 i4 = *reinterpret_cast<const int4*>(ids);
    id[0] = i4.x; id[1] = i4.y; id[2] = i4.z; id[3] = i4.w;
    if constexpr (sizeof(TV) == 4) {
      const float4 f = *reinterpret_cast<const float4*>(vals);
      v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(vals);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      id[k] = k < real ? ids[k] : 0;
      v[k] = k < real ? topk::to_f32(vals[k]) : 0.f;
    }
  }
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // kVec (a box stage, nearly every slot real): every slot looked up, as the scan does; else the real ones
    row[k] = kVec || k < real ? topk::index_row(words, vocab, id[k]) : 0;
    if (k < real && (row[k] != 0 || !isfinite(v[k]))) m |= 1u << k;
  }
  return m;
}

// table[hr][the thread's four queries] x hv onto a row's four sums (fmaf, as the scan); kAnywhere: the table
// in shared or global memory, through a generic load (else global, through the read-only path)
template <bool kAnywhere>
__device__ __forceinline__ void add_hit(const float* tq, int hr, float hv, float (&s)[4]) {
  const float4* p = reinterpret_cast<const float4*>(tq + size_t(hr) * kQB);
  const float4 t = kAnywhere ? *p : __ldg(p);
  s[0] = fmaf(t.x, hv, s[0]);
  s[1] = fmaf(t.y, hv, s[1]);
  s[2] = fmaf(t.z, hv, s[2]);
  s[3] = fmaf(t.w, hv, s[3]);
}

// The sparse sums of a box stage: 16 slots a row (ids and values row-major in shared memory, 16-byte
// aligned), [0, real) of them real, for the thread's four rows (row_in + 8r).  Lane l looks up slots
// 4 (l % 4) .. +3 of each of its rows (a warp's eight rows of a column of lanes read 512 contiguous
// bytes); each row's 16-bit hit mask is gathered in the row's four lanes (lane >> 2 equal), and the
// four lanes take the row's hits in slot order, each hit's (compact row, value) shuffled from the lane
// that looked it up, and add table[row][their four queries] x value to the row's sums, which start at
// +0: the scan's sums bit for bit.  The four rows go round together, their lookups, shuffles and
// table reads independent of each other, as many rounds as the warp's busiest row needs.  No shared
// list, no barrier.
template <typename TV>
__device__ __forceinline__ void sparse_box(const int* ids, const TV* vals, int real, int row_in,
                                           const uint2* words, int vocab, const float* tq, int lane,
                                           float (&sp)[4][4]) {
  const int sub = lane & 3, base = lane & ~3;
  const int mine = min(4, max(0, real - 4 * sub));   // this lane's real slots
  int row[4][4];
  float v[4][4];
  unsigned hits[4];
  int n[4], most = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int at = (row_in + 8 * r) * kSlotChunk + 4 * sub;
    hits[r] = look_up<TV, true>(ids + at, vals + at, mine, words, vocab, row[r], v[r]) << (4 * sub);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {   // bit s: slot s of row r
    hits[r] |= __shfl_xor_sync(0xffffffffu, hits[r], 1);
    hits[r] |= __shfl_xor_sync(0xffffffffu, hits[r], 2);
    n[r] = __popc(hits[r]);
    most = max(most, n[r]);
  }
  most = int(__reduce_max_sync(0xffffffffu, unsigned(most)));
  for (int h = 0; h < most; ++h) {
    int hr[4];
    float hv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = __ffs(hits[r]) - 1;   // row r's next hit (-1: its hits are done)
      hits[r] &= hits[r] - 1;
      const int k = p & 3, src = base | ((p >> 2) & 3);
      hr[r] = __shfl_sync(0xffffffffu, pick(row[r], k), src);
      hv[r] = __shfl_sync(0xffffffffu, pick(v[r], k), src);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (h < n[r]) add_hit<true>(tq, hr[r], hv[r], sp[r]);
  }
}

// One round of a row stage's sparse sums: four slots of each of the thread's four rows, looked up by
// the row's own lane (look_up: `own` the mask of its row's slots that need a multiply-add, `row` and
// `v` their compact-table rows and values).  The round's four 4-bit masks are gathered in the row's
// four lanes; each lane offers its row's next hit, in slot order, and takes the four rows' by
// shuffles, four table reads in flight.
__device__ __forceinline__ void rows_round(unsigned own, const int (&row)[4], const float (&v)[4], int lane,
                                           const float* tq, float (&sp)[4][4]) {
  const int sub = lane & 3, base = lane & ~3;
  unsigned all = own << (4 * sub);   // bits 4r .. 4r + 3: row r's four slots
  all |= __shfl_xor_sync(0xffffffffu, all, 1);
  all |= __shfl_xor_sync(0xffffffffu, all, 2);
  int n[4], most = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    n[r] = __popc((all >> (4 * r)) & 15u);
    most = max(most, n[r]);
  }
  most = int(__reduce_max_sync(0xffffffffu, unsigned(most)));
  for (int h = 0; h < most; ++h) {
    const int k = (__ffs(own) - 1) & 3;   // this lane's row's next hit
    own &= own - 1;
    const int mr = pick(row, k);
    const float mv = pick(v, k);
    int hr[4];
    float hv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      hr[r] = __shfl_sync(0xffffffffu, mr, base | r);
      hv[r] = __shfl_sync(0xffffffffu, mv, base | r);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (h < n[r]) add_hit<false>(tq, hr[r], hv[r], sp[r]);
  }
}

// BoxTile: the tensor-map layout of the fused ring.  A tile is
// ceil(D / kChunk) dense stages, each a Stage<TD> (a swizzled
// [kTileRows, kChunk] box of the corpus and the queries' columns), then
// ceil(nnz / kSlotChunk) sparse stages, each a [kTileRows, kSlotChunk] box
// of the ids and one of the values (no swizzle: a row's 16 slots are 64
// bytes of ids, read as four 16-byte pieces by its four lanes, eight rows
// a warp over 512 contiguous bytes); slots past nnz and rows past n_valid
// read as zero, and the slots past nnz are not looked up.  A slot holds
// the larger of the two stages.  Needs rows of a multiple of 16 bytes in
// each array: D x sizeof(TD), nnz x 4 and nnz x sizeof(TV).  The budget a
// block leaves beside its ring and index words holds its group's compact
// table (fused_kernel).  Two consumer shapes, R rows x 4 queries a
// thread, the sparse lookups four lanes a row at either, four of the
// thread's rows a pass (sparse_box; PERF.md holds the shapes measured):
//   R = 4  (BoxOne, a block a group): eight multiplying warps, one block
//          an SM, a ring of kStages slots; one group reads the corpus
//          alone, and the deeper ring keeps the read going;
//   R = 8  (BoxCluster, B2's clusters above 16 queries): B1's Stage shape, four
//          multiplying warps and two blocks an SM, each a ring of two
//          slots (the table's room beside them: 36 KB in f32 at
//          V = 30,522); read once for the cluster, the corpus no longer
//          bounds it, the consumers' FMAs do, and 8 x 4 issues more of
//          them a shared-memory read.  In a cluster every stage, dense or
//          sparse, lands in all the cluster's blocks from the first block's
//          one multicast copy, and each block copies its own queries'
//          columns.
template <typename TD, typename TV, bool DENSE, bool SPARSE, int R>
struct BoxTile {
  using DS = Stage<TD>;
  static constexpr int kRows = R;
  static constexpr int kConsumers = consumer_threads<R>() / 32;
  static constexpr int kThreads = (kConsumers + 1) * 32;
  static constexpr int kMaxStages = R == 8 ? 2 : kStages;
  static constexpr int kBlocksPerSM = R == 8 ? 2 : 1;
  static constexpr int kSmem = R == 8 ? 112 * 1024 : 224 * 1024;   // a block's shared memory budget
  static constexpr bool kCluster = R == 8;
  static constexpr bool kBox = true;   // tensor maps; the compact table in shared memory where it fits
  static constexpr unsigned kAlign = 1024;
  static constexpr int kHead = 0;
  static constexpr int kIdxBytes = kTileRows * kSlotChunk * 4;
  static constexpr int kSparseBytes = kIdxBytes + kTileRows * kSlotChunk * int(sizeof(TV));
  static constexpr int kBytes = !SPARSE ? DS::kBytes
                                : !DENSE ? kSparseBytes
                                         : (DS::kBytes > kSparseBytes ? DS::kBytes : kSparseBytes);
  __host__ __device__ static int dense_chunks(int d) { return DENSE ? (d + kChunk - 1) / kChunk : 0; }
  __host__ __device__ static int chunks(int d, int nnz) {
    return dense_chunks(d) + (SPARSE ? (nnz + kSlotChunk - 1) / kSlotChunk : 0);
  }
  // Stage s of a tile: dense chunk s, or sparse chunk s - dense_chunks(d) after the dense ones.  (The
  // sparse stages spread evenly among the dense ones were slower: PERF.md.)
  __device__ static bool sparse_at(int s, int d, int& chunk) {
    const int dc = dense_chunks(d);
    const bool sparse = SPARSE && s >= dc;
    chunk = sparse ? s - dc : s;
    return sparse;
  }
  __host__ __device__ static int bytes(int, int) { return kBytes; }
  __host__ __device__ static int stages(int, int, int) { return kMaxStages; }
  // the budget's bytes left beside the ring and `words` bytes of index words: the compact table's room
  __host__ __device__ static int table_room(int, int, int words) {
    const int room = kSmem - kHead - kMaxStages * kBytes - words - int(kAlign);
    return room > 0 ? room & ~15 : 0;
  }
  // by the copying thread, the slot free: stage s of the tile at row0 (the queries' columns with a dense
  // stage); in a cluster of cs blocks (cs > 1) the first block multicasts the boxes to every block
  __device__ static void copy(unsigned char* st, const CUtensorMap* dmap, const CUtensorMap* imap,
                              const CUtensorMap* vmap, const void*, const SparseArgs&, int d, long long,
                              long long row0, int s, const float* qg, unsigned long long* full, unsigned rank,
                              unsigned cs) {
    int c;
    const bool sparse = sparse_at(s, d, c);
    if constexpr (DENSE) {
      if (!sparse) {
        if (cs > 1) {
          DS::copy_cluster(st, dmap, row0, c * kChunk, qg, full, rank, cs);
        } else {
          DS::copy(st, dmap, nullptr, 0, 0, row0, c * kChunk, qg, full);
        }
        return;
      }
    }
    if constexpr (SPARSE) {
      const int j0 = c * kSlotChunk;
      mbar_expect_tx(full, kSparseBytes);   // the whole stage, wherever it was copied from
      if (cs > 1) {
        if (rank == 0) {
          const unsigned short mask = static_cast<unsigned short>((1u << cs) - 1u);
          tile_copy_mc(st, imap, j0, int(row0), full, mask);
          tile_copy_mc(st + kIdxBytes, vmap, j0, int(row0), full, mask);
        }
      } else {
        tile_copy(st, imap, j0, int(row0), full);
        tile_copy(st + kIdxBytes, vmap, j0, int(row0), full);
      }
    }
  }
  template <bool L2>
  __device__ static void consume(const unsigned char* st, const unsigned char* smem, const SparseArgs& sa, int d,
                                 int s, int row_in, int qgi, int lane, const uint2* words, const float* tq,
                                 float (&acc)[kRows][4], float (&c2)[kRows], float (&sp)[kRows][4]) {
    int c;
    const bool sparse = sparse_at(s, d, c);
    if constexpr (DENSE) {
      if (!sparse) {
        DS::template multiply<L2, kRows>(st, DS::queries(smem, st), d, row_in, qgi, acc, c2);
        return;
      }
    }
    if constexpr (SPARSE) {
      const int j0 = c * kSlotChunk;
#pragma unroll
      for (int h = 0; h < kRows / 4; ++h)   // the thread's rows row_in + 32 h + 8 r, r < 4
        sparse_box<TV>(reinterpret_cast<const int*>(st), reinterpret_cast<const TV*>(st + kIdxBytes),
                       min(kSlotChunk, sa.nnz - j0), row_in + 32 * h, words, sa.vocab, tq, lane,
                       *reinterpret_cast<float(*)[4][4]>(&sp[4 * h]));
    }
  }
};

// rows [row0, row0 + rows) of a row-major array into a stage region of
// `region` bytes: returns the largest multiple of 16 bytes (for the copy
// engine, which the caller starts); the few bytes left go by plain stores
// (W: a value's bits), zeros after them to the region's end, so that no
// read passes the array and no stale NaN enters a sum (RowStage::copy).
template <typename W>
__device__ __forceinline__ unsigned rows_tail(unsigned char* dst, const unsigned char* src, unsigned size,
                                              unsigned region) {
  const unsigned bulk = size & ~15u;
  if (bulk < region) {
    const unsigned up = (size + 15u) & ~15u;
    for (unsigned i = bulk; i < up; i += sizeof(W))
      *reinterpret_cast<W*>(dst + i) = i < size ? *reinterpret_cast<const W*>(src + i) : W(0);
    for (unsigned i = up; i < region; i += 16) *reinterpret_cast<uint4*>(dst + i) = make_uint4(0, 0, 0, 0);
  }
  return bulk;
}

template <typename T>
using bits_of = std::conditional_t<sizeof(T) == 4, unsigned, unsigned short>;

// RowTile: the row layout of the fused ring (two blocks an SM, as
// RowStage), for arrays whose rows no tensor map describes: a tile is one
// stage, the tile's dense rows (D <= kChunk, D even: RowStage<TD, true>'s
// column pairs), its ids and its values (nnz <= kRowSlots), each as it lies
// in its array, by one bulk copy a region, all three on the stage's
// barrier (DIN's items with one tag: 18 KB + 1 KB + 1 KB a tile).  The
// queries are read once into shared memory ahead of the ring.  The ring is
// as deep as fits kSmem beside the index words, at most kMaxStages.
template <typename TD, typename TV, bool DENSE, bool SPARSE>
struct RowTile {
  using DS = RowStage<TD, true>;
  static constexpr int kRows = 4;
  static constexpr int kConsumers = consumer_threads<kRows>() / 32;   // eight multiplying warps
  static constexpr int kThreads = (kConsumers + 1) * 32;
  static constexpr int kMaxStages = DS::kMaxStages;
  static constexpr int kBlocksPerSM = DS::kBlocksPerSM;
  static constexpr bool kCluster = false;   // a block a group, as B1's row layout (PERF.md)
  static constexpr bool kBox = false;
  static constexpr unsigned kAlign = 16;
  static constexpr int kHead = DENSE ? kQStage : 0;
  __host__ __device__ static int dense_bytes(int d) { return DENSE ? kTileRows * d * int(sizeof(TD)) : 0; }
  __host__ __device__ static int idx_bytes(int nnz) { return SPARSE ? kTileRows * nnz * 4 : 0; }
  __host__ __device__ static int val_bytes(int nnz) { return SPARSE ? kTileRows * nnz * int(sizeof(TV)) : 0; }
  __host__ __device__ static int chunks(int, int) { return 1; }
  __host__ __device__ static int bytes(int d, int nnz) { return dense_bytes(d) + idx_bytes(nnz) + val_bytes(nnz); }
  // stages in flight beside `words` bytes of index words, at most kMaxStages
  __host__ __device__ static int stages(int d, int nnz, int words) {
    const int fit = (DS::kSmem - kHead - words - int(kAlign)) / bytes(d, nnz);
    return fit < kMaxStages ? fit : kMaxStages;
  }
  __device__ static void copy(unsigned char* st, const CUtensorMap*, const CUtensorMap*, const CUtensorMap*,
                              const void* c, const SparseArgs& sa, int d, long long n_valid, long long row0, int,
                              const float*, unsigned long long* full, unsigned, unsigned) {
    const unsigned rows = unsigned(n_valid - row0 < kTileRows ? n_valid - row0 : kTileRows);
    const unsigned char* src[3] = {nullptr, nullptr, nullptr};
    unsigned bulk[3] = {0, 0, 0}, region[3] = {0, 0, 0};
    bool stored = false;
    unsigned char* at = st;
    if constexpr (DENSE) {
      region[0] = unsigned(dense_bytes(d));
      src[0] = static_cast<const unsigned char*>(c) + size_t(row0) * d * sizeof(TD);
      bulk[0] = rows_tail<bits_of<TD>>(at, src[0], rows * d * unsigned(sizeof(TD)), region[0]);
    }
    if constexpr (SPARSE) {
      region[1] = unsigned(idx_bytes(sa.nnz));
      region[2] = unsigned(val_bytes(sa.nnz));
      src[1] = reinterpret_cast<const unsigned char*>(sa.idx + size_t(row0) * sa.nnz);
      src[2] = static_cast<const unsigned char*>(sa.val) + size_t(row0) * sa.nnz * sizeof(TV);
      bulk[1] = rows_tail<unsigned>(at + region[0], src[1], rows * sa.nnz * 4u, region[1]);
      bulk[2] = rows_tail<bits_of<TV>>(at + region[0] + region[1], src[2], rows * sa.nnz * unsigned(sizeof(TV)),
                                       region[2]);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) stored |= bulk[i] < region[i];
    // the tails' stores are the generic proxy's: order them before any later copy-engine write of the slot
    if (stored) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(full, bulk[0] + bulk[1] + bulk[2]);   // an arrive, with the bytes the copy engine moves
    unsigned off = 0;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (bulk[i] > 0) bulk_copy(at + off, src[i], bulk[i], full);
      off += region[i];
    }
  }
  // Here a lane looks up its own row (lane l takes row row_in + 8 (l % 4) of the four that its row's
  // lanes share), four slots a round (rows_round): with DIN's one tag a row, one lookup a lane and not
  // sixteen.  (Issuing the first round's lookups before the dense multiply, to hide their latency, held
  // more registers and was slower: PERF.md.)
  template <bool L2>
  __device__ static void consume(const unsigned char* st, const unsigned char* smem, const SparseArgs& sa, int d, int,
                                 int row_in, int qgi, int lane, const uint2* words, const float* tq,
                                 float (&acc)[4][4], float (&c2)[4], float (&sp)[4][4]) {
    if constexpr (DENSE) DS::template multiply<L2>(st, reinterpret_cast<const float*>(smem), d, row_in, qgi, acc, c2);
    if constexpr (SPARSE) {
      const int nnz = sa.nnz, at = (row_in + 8 * (lane & 3)) * nnz;
      const int* ids = reinterpret_cast<const int*>(st + dense_bytes(d)) + at;
      const TV* vals = reinterpret_cast<const TV*>(st + dense_bytes(d) + idx_bytes(nnz)) + at;
      for (int j0 = 0; j0 < nnz; j0 += 4) {
        int row[4];
        float v[4];
        const unsigned own = look_up<TV, false>(ids + j0, vals + j0, min(4, nnz - j0), words, sa.vocab, row, v);
        rows_round(own, row, v, lane, tq, sp);
      }
    }
  }
};

template <typename TD, typename TV, bool DENSE, bool SPARSE>
using BoxOne = BoxTile<TD, TV, DENSE, SPARSE, 4>;
template <typename TD, typename TV, bool DENSE, bool SPARSE>
using BoxCluster = BoxTile<TD, TV, DENSE, SPARSE, 8>;

// The fused ring: dense_kernel's blocks, warps, ring and clusters over the
// stages of the tile layout T (BoxTile or RowTile); at the end of each
// tile, the score policy turns the sums into the fused score (the scan's
// arithmetic, topk_scan.cu: __fadd_rn(__fmul_rn(w_d, dense),
// __fmul_rn(w_s, sparse)), l2's dense part as dense_score), and the
// epilogue E (filter.cuh: SampleTiles or FilterTiles; StoreAll) takes them
// as an ip tile's finished scores.  Block y holds query group y: its
// queries' columns (a.q), its query-term index words and compact table
// (sa.words, sa.table), both laid out for the grid's rows x width groups;
// the words follow the ring in shared memory when they fit, and the
// group's compact table after them when it fits the room that the launch
// left (the box layout's).  In a cluster (Grid width > 1, BoxCluster
// only) the first block copies each stage's boxes
// into every block of the cluster (T::copy), each block its own queries'
// columns, and a slot is refilled once every block of the cluster has
// released it, as in dense_kernel.
template <typename TD, typename TV, bool DENSE, bool SPARSE, bool L2, typename E, typename T>
__global__ void __launch_bounds__(T::kThreads, T::kBlocksPerSM)
    fused_kernel(FusedArgs<typename E::Args> fa, const __grid_constant__ CUtensorMap dmap,
                 const __grid_constant__ CUtensorMap imap, const __grid_constant__ CUtensorMap vmap) {
  static_assert(DENSE || SPARSE, "a part to score");
  constexpr int R = T::kRows, NC = T::kConsumers;
  const typename E::Args& a = fa.e;
  const SparseArgs& sa = fa.s;
  extern __shared__ __align__(16) unsigned char ring_raw[];
  unsigned char* smem = ring_raw + ((T::kAlign - (smem_u32(ring_raw) & (T::kAlign - 1))) & (T::kAlign - 1));
  unsigned char* slots = smem + T::kHead;
  __shared__ __align__(8) unsigned long long full[T::kMaxStages], empty[T::kMaxStages];
  __shared__ long long row0s[T::kMaxStages];
  __shared__ float q2s[kQB];
  __shared__ typename E::Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.y * kQB, qn = min(kQB, a.b - q0);
  const int cpt = T::chunks(a.d, sa.nnz);   // stages a tile
  const int stage_bytes = T::bytes(a.d, sa.nnz);
  const int nst = T::stages(a.d, sa.nnz, SPARSE && sa.stage_words ? (sa.nw * 8 + 15) & ~15 : 0);
  const float* qg = DENSE ? a.q + size_t(blockIdx.y) * ((a.d + kChunk - 1) / kChunk) * kChunk * kQB : nullptr;
  const long long n_units = E::units(a);
  const long long mine = blockIdx.x < n_units ? (n_units - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long total = mine * cpt;
  const unsigned cs = T::kCluster ? cluster_blocks() : 1;   // 1: no cluster
  const unsigned rank = cs > 1 ? cluster_rank() : 0;

  if (tid == 0) {
    for (int i = 0; i < nst; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], rank == 0 ? NC * cs : NC);   // the first block's copies land in every block
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (DENSE && L2 && tid < kQB) {
    float acc = 0.f;
    for (int j = 0; j < a.d; ++j) acc = fmaf(qg[j * kQB + tid], qg[j * kQB + tid], acc);
    q2s[tid] = acc;
  }
  if constexpr (T::kHead > 0) {   // the queries' kChunk columns, once
    float* qh = reinterpret_cast<float*>(smem);
    for (int i = tid; i < kChunk * kQB; i += T::kThreads) qh[i] = qg[i];
  }
  const uint2* words = nullptr;
  const float* tq = nullptr;
  if constexpr (SPARSE) {
    words = sa.words + size_t(blockIdx.y) * sa.nw;
    const float* table = sa.table + size_t(blockIdx.y) * (sa.vocab + 2) * kQB;
    unsigned char* after = slots + size_t(nst) * stage_bytes;   // past the ring
    if constexpr (T::kBox) {
      // the group's compact table in shared memory when its rows 0 .. S fit the room the launch left (S:
      // the group's present terms, from its last index word): a hit's read then waits for no L2 round trip
      const uint2 last = words[sa.nw - 1];
      const int rows = int(last.y) + __popc(last.x);
      if (rows * kQB * 4 <= sa.table_smem) {
        float4* st = reinterpret_cast<float4*>(after + (sa.stage_words ? (sa.nw * 8 + 15) & ~15 : 0));
        for (int i = tid; i < rows * (kQB / 4); i += T::kThreads) st[i] = reinterpret_cast<const float4*>(table)[i];
        table = reinterpret_cast<const float*>(st);
      }
    }
    if (sa.stage_words) {
      uint2* sw = reinterpret_cast<uint2*>(after);
      for (int i = tid; i < sa.nw; i += T::kThreads) sw[i] = words[i];
      words = sw;
    }
    tq = table + 4 * (lane & 3);
  }
  if (tid < kQB) E::init(a, sh, tid, q0, qn);
  if (cs > 1) {
    cluster_sync();   // every peer's barriers are initialised before a copy can complete on them
  } else {
    __syncthreads();
  }

  if (warp == NC) {   // the copying warp
    if (lane == 0) {
      int slot = 0;
      unsigned ph = 0;
      for (long long s = 0; s < total; ++s) {
        // the last round's stage in this slot is released (in the first block of a cluster: by every block)
        if (s >= nst) mbar_wait(&empty[slot], ph ^ 1u);
        const long long row0 = E::first_row(a, blockIdx.x + (s / cpt) * gridDim.x);
        row0s[slot] = row0;
        T::copy(slots + size_t(slot) * stage_bytes, &dmap, &imap, &vmap, a.c, sa, a.d, a.n_valid, row0,
                int(s % cpt), qg, &full[slot], rank, cs);
        if (++slot == nst) {
          slot = 0;
          ph ^= 1u;
        }
      }
    }
    if (cs > 1) {   // the kernel's last barrier, below
      __syncwarp();
      cluster_sync();
    }
    return;
  }

  const int qgi = lane & 3, rg = lane >> 2;
  const int row_in = kTileRows / NC * warp + rg;
  const bool idle = qn <= 0;   // a group wholly past the batch (a cluster's padding): it only hands slots back
  float acc[R][4], c2[R], sp[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    c2[r] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = sp[r][j] = 0.f;
  }
  int slot = 0;
  unsigned ph = 0;
  for (long long s = 0; s < total; ++s) {
    mbar_wait(&full[slot], ph);
    const int in_tile = int(s % cpt);
    if (!idle)
      T::template consume<L2>(slots + size_t(slot) * stage_bytes, smem, sa, a.d, in_tile, row_in, qgi, lane,
                              words, tq, acc, c2, sp);
    const long long row0 = row0s[slot];
    __syncwarp();
    if (lane == 0) {   // this warp is done with the slot: tell its block, and the first block of a cluster
      if (cs == 1) {
        mbar_arrive(&empty[slot]);
      } else {
        mbar_arrive_at(&empty[slot], rank);
        if (rank != 0) mbar_arrive_at(&empty[slot], 0);
      }
    }
    if (++slot == nst) {
      slot = 0;
      ph ^= 1u;
    }
    if (in_tile == cpt - 1) {   // the tile is scored: its fused scores to the epilogue, start the next
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v;
          if constexpr (DENSE) {
            const float dv = dense_score<L2>(acc[r][j], c2[r], q2s[4 * qgi + j]);
            if constexpr (SPARSE) {
              v = __fadd_rn(__fmul_rn(sa.w_dense, dv), __fmul_rn(sa.w_sparse, sp[r][j]));
            } else {
              v = sa.weighted ? __fmul_rn(sa.w_dense, dv) : dv;
            }
          } else {
            v = sa.weighted ? __fmul_rn(sa.w_sparse, sp[r][j]) : sp[r][j];
          }
          acc[r][j] = v;
        }
      }
      const long long unit = blockIdx.x + (s / cpt) * gridDim.x;
      E::template tile<false, R>(a, sh, unit, row0, row_in, acc, c2, q2s, q0, qn, lane);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        c2[r] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = sp[r][j] = 0.f;
      }
    }
  }
  E::template finish<R>(a, sh, q0, qn);
  // no block leaves while a peer may still arrive on its barriers (the copies into it have all landed:
  // its consumers waited for every stage)
  if (cs > 1) cluster_sync();
}

// A tensor map of an [rows, nnz] COO array (ids: i32, values: f32/bf16),
// a box of kTileRows x kSlotChunk, no swizzle, as BoxTile reads it.
inline cudaError_t slot_map(const void* p, CUtensorMapDataType type, int elem, int nnz, long long rows,
                            CUtensorMap* map) {
  PFN_cuTensorMapEncodeTiled_v12000 encode;
  const cudaError_t err = map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {cuuint64_t(nnz), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(nnz) * elem};
  const cuuint32_t box[2] = {cuuint32_t(kSlotChunk), cuuint32_t(kTileRows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(p), dims, strides, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The box layout's three tensor maps over rows [0, rows): the dense part
// (maps[0]) and the COO ids and values (maps[1], maps[2]), each where its
// part is present.
template <typename TD, typename TV, bool DENSE, bool SPARSE>
cudaError_t box_maps(const void* c, int d, const SparseArgs& sp, long long rows, CUtensorMap (&maps)[3]) {
  cudaError_t err = cudaSuccess;
  if (DENSE) err = tensor_map<TD>(c, d, rows, &maps[0]);
  if (err == cudaSuccess && SPARSE) err = slot_map(sp.idx, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, sp.nnz, rows, &maps[1]);
  if (err == cudaSuccess && SPARSE)
    err = slot_map(sp.val, sizeof(TV) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                   int(sizeof(TV)), sp.nnz, rows, &maps[2]);
  return err;
}

// The dynamic shared memory of fused_kernel over layout T: the ring (and
// the queries ahead of it in the row layout), the index words after it
// when they fit, the room for the compact table (*table, the box layout's
// budget left), room to align; 0 when the ring holds fewer than two
// stages.
template <bool SPARSE, typename T>
size_t fused_smem(const SparseArgs& s, int d, int* table) {
  const int words = SPARSE && s.stage_words ? (s.nw * 8 + 15) & ~15 : 0;
  const int nst = T::stages(d, s.nnz, words);
  if constexpr (SPARSE && T::kBox) {
    *table = T::table_room(d, s.nnz, words);
  } else {
    *table = 0;
  }
  return nst < 2 ? 0 : size_t(T::kHead) + size_t(nst) * T::bytes(d, s.nnz) + words + *table + T::kAlign;
}

// One launch of fused_kernel over Grid g (ring.cuh launch_grid: clusters
// of g.width blocks along y above width 1; the box layout only).
template <typename TD, typename TV, bool DENSE, bool SPARSE, bool L2, typename E, typename T>
cudaError_t launch_fused(const FusedArgs<typename E::Args>& fa, const CUtensorMap (&maps)[3], const Grid& g,
                         cudaStream_t st) {
  FusedArgs<typename E::Args> f = fa;
  const size_t smem = fused_smem<SPARSE, T>(f.s, f.e.d, &f.s.table_smem);
  if (smem == 0 || (g.width > 1 && !T::kCluster)) return cudaErrorInvalidValue;
  auto kernel = fused_kernel<TD, TV, DENSE, SPARSE, L2, E, T>;
  return launch_grid(kernel, g, T::kThreads, smem, st, f, maps[0], maps[1], maps[2]);
}

// Clusters of `width` blocks of fused_kernel that fit the card at once, into *fit.
template <typename TD, typename TV, bool DENSE, bool SPARSE, bool L2, typename E, typename T>
cudaError_t fused_cluster_fit(const FusedArgs<typename E::Args>& fa, int width, int* fit) {
  int table;
  const size_t smem = fused_smem<SPARSE, T>(fa.s, fa.e.d, &table);
  if (smem == 0) return cudaErrorInvalidValue;
  auto kernel = fused_kernel<TD, TV, DENSE, SPARSE, L2, E, T>;
  return fit_clusters(kernel, width, T::kThreads, smem, fit);
}

// The combinations of parts and dtypes the fused ring is built for, as a
// tag: both parts in one dtype, the dense part alone, the sparse part
// alone.
template <typename D, typename V, bool kDense, bool kSparse>
struct Parts {
  using TD = D;
  using TV = V;
  static constexpr bool DENSE = kDense, SPARSE = kSparse;
};

// f(Parts<...>{}) for the combination that the flags name (bf16: the dtype of the present parts).
template <typename F>
cudaError_t by_parts(bool dense, bool sparse, bool bf16, F&& f) {
  using bf = __nv_bfloat16;
  if (dense && sparse) return bf16 ? f(Parts<bf, bf, true, true>{}) : f(Parts<float, float, true, true>{});
  if (dense) return bf16 ? f(Parts<bf, float, true, false>{}) : f(Parts<float, float, true, false>{});
  return bf16 ? f(Parts<float, bf, false, true>{}) : f(Parts<float, float, false, true>{});
}

// Whether the fused ring's layout (rows: RowTile, else BoxTile) takes the
// parts (kernels/fused_topk.py: ring_layout gives the same answer from
// shapes, dtypes and alignment).
inline bool layout_ok(bool rows, bool dense, bool sparse, int d, int dense_elem, int nnz, int val_elem,
                      bool stage_words, int nw) {
  if (!rows)
    return (!dense || d * dense_elem % 16 == 0) && (!sparse || (nnz * 4 % 16 == 0 && nnz * val_elem % 16 == 0));
  if ((dense && (d > kChunk || d % 2)) || (sparse && nnz > kRowSlots)) return false;
  const int bytes = kTileRows * ((dense ? d * dense_elem : 0) + (sparse ? nnz * (4 + val_elem) : 0));
  const int words = stage_words ? (nw * 8 + 15) & ~15 : 0;   // as fused_smem counts them
  const int fit = (RowStage<float, true>::kSmem - (dense ? kQStage : 0) - words - 16) / bytes;
  return fit >= 2;
}

// The sparse part's arguments: its query-term index words staged in shared memory when they fit.
inline SparseArgs sparse_args(bool sparse, const void* words, const float* table, const int* c_idx,
                              const void* c_val, int nnz, int vocab, int weighted, float w_dense, float w_sparse) {
  const int nw = sparse ? topk::index_words(vocab) : 0;
  return SparseArgs{static_cast<const uint2*>(words), table, c_idx, c_val, sparse ? nnz : 0, vocab, nw,
                    int(sparse && nw * 8 <= topk::kWordsSmemCap), weighted, w_dense, w_sparse};
}

}  // namespace ring
