// The dense score ring shared by topk_large.cu (every row's score into a
// [B, n_valid] buffer) and mips_topk.cu (B1: a sample of tiles scored into
// a small buffer, then a scan that keeps only the rows above a threshold).
//
// Persistent blocks (one or two an SM) score tiles of kTileRows rows for
// kQB queries.  Eight warps hold a 4-row x 4-query register tile per
// thread (fmaf in column order, |c|^2 in the same pass for l2); a ninth
// warp feeds them a ring of shared-memory stages, each handed over on an
// mbarrier, so that the next stages' loads are in flight while one is
// multiplied and no barrier holds the whole block.  Two stage layouts,
// chosen by template parameter:
//   Stage<TD>      rows of a multiple of 16 bytes (D = 768, 64, 16 ...):
//                  kChunk columns of a tile as one tensor-map box, and the
//                  queries' kChunk columns; a tile is ceil(D / kChunk)
//                  stages; one block an SM;
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
constexpr int kConsumers = 8;                          // warps that multiply
constexpr int kDenseThreads = (kConsumers + 1) * 32;   // and one that copies

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
// Named barrier 1 of the eight multiplying warps; the copy warp, which
// returns once its copies are issued, takes no part.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 32) : "memory");
}

// Stage<TD>: a stage holds a tile's rows for kChunk columns, row-major, as
// the tensor map's 128-byte (f32) or 64-byte (bf16) swizzle lays them out:
// the 16-byte pieces of a row XORed with its index, so that the eight rows
// a warp reads at once (rows x..x+7, the same columns) hit distinct banks;
// then the block's 16 queries' values of those columns, column-major.
template <typename TD>
struct Stage {
  static constexpr int kMaxStages = kStages;
  static constexpr int kBlocksPerSM = 1;
  static constexpr int kRowBytes = kChunk * int(sizeof(TD));   // 128 (f32) or 64 (bf16)
  static constexpr int kPieces = kRowBytes / 16;
  static constexpr int kTile = kTileRows * kRowBytes;
  static constexpr int kBytes = kTile + kQStage;
  static constexpr unsigned kAlign = 1024;   // the swizzled boxes
  static constexpr int kHead = 0;            // shared bytes ahead of the ring
  static constexpr bool kSets = false;       // multiply adds to acc and c2 (a tile is several stages)
  __host__ __device__ static int chunks(int d) { return (d + kChunk - 1) / kChunk; }
  __host__ __device__ static int bytes(int) { return kBytes; }
  __host__ __device__ static int stages(int) { return kStages; }
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
  template <bool L2>
  __device__ static void multiply(const unsigned char* st, const float* qs, int, int row_in, int qgi,
                                  float (&acc)[4][4], float (&c2)[4]);
};

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <typename TD>
template <bool L2>
__device__ __forceinline__ void Stage<TD>::multiply(const unsigned char* st, const float* qs, int, int row_in,
                                                    int qgi, float (&acc)[4][4], float (&c2)[4]) {
#pragma unroll
  for (int c4 = 0; c4 < kChunk / 4; ++c4) {
    float4 x[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = read4(st, row_in + 8 * r, c4);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float4 qv = *reinterpret_cast<const float4*>(qs + (4 * c4 + cc) * kQB + 4 * qgi);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
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
  static constexpr int kSmem = 112 * 1024;  // shared memory of a block, so that two fit an SM's 228 KB
  static constexpr unsigned kAlign = 16;
  static constexpr int kHead = kQStage;     // the block's queries, kChunk columns
  static constexpr bool kSets = true;       // multiply sets acc and c2: a stage is the whole tile
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

// Warps 0-7 multiply: thread (warp w, lane l) holds rows 32w + l/4 + 8r
// (r < 4) of a tile and queries 4(l%4) .. +3 of the block's 16.  Warp 8
// copies: for each stage it waits until the eight warps have released the
// ring slot, then one thread copies the stage (S::copy), completing on the
// slot's `full` barrier.
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
//                            tile is scored (its rows tile_row0 + row_in +
//                            8r), before acc and c2 are cleared,
//   finish(a, sh, q0, qn)    called by every multiplying thread at the end.
// The stage layout S (Stage<TD> by default, or RowStage<TD, pair>) gives
// how a stage is copied and multiplied; the map is unused by RowStage.
template <typename TD, bool L2, typename E, typename S = Stage<TD>>
__global__ void __launch_bounds__(kDenseThreads, S::kBlocksPerSM) dense_kernel(typename E::Args a, const __grid_constant__ CUtensorMap map) {
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

  if (tid == 0) {
    for (int i = 0; i < nst; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers);
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
    for (int i = tid; i < kChunk * kQB; i += kDenseThreads) qh[i] = qg[i];
  }
  if (tid < kQB) E::init(a, sh, tid, q0, qn);
  __syncthreads();

  if (warp == kConsumers) {   // the copying warp
    if (lane == 0) {
      int slot = 0;
      unsigned ph = 0;   // the parity of the ring's round
      for (long long s = 0; s < total; ++s) {
        if (s >= nst) mbar_wait(&empty[slot], ph ^ 1u);   // the last round's stage in this slot is released
        const long long row0 = E::first_row(a, blockIdx.x + (s / cpt) * gridDim.x);
        row0s[slot] = row0;   // before the copy's arrive on `full` releases it
        S::copy(slots + size_t(slot) * stage_bytes, &map, a.c, a.d, a.n_valid, row0, int(s % cpt) * kChunk, qg,
                &full[slot]);
        if (++slot == nst) {
          slot = 0;
          ph ^= 1u;
        }
      }
    }
    return;
  }

  const int qgi = lane & 3, rg = lane >> 2;
  const int row_in = 32 * warp + rg;
  float acc[4][4], c2[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
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
    if (lane == 0) mbar_arrive(&empty[slot]);   // this warp is done with the slot
    if (++slot == nst) {
      slot = 0;
      ph ^= 1u;
    }
    if (s % cpt == cpt - 1) {   // the tile is scored: hand it over, start the next
      const long long unit = blockIdx.x + (s / cpt) * gridDim.x;
      E::template tile<L2>(a, sh, unit, row0, row_in, acc, c2, q2s, q0, qn, lane);
      if constexpr (!S::kSets) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          c2[r] = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
        }
      }
    }
  }
  E::finish(a, sh, q0, qn);
}

// The corpus's tensor map: rows [0, rows) x columns [0, d), a box of
// kTileRows x kChunk, swizzled as Stage<TD> reads it.
template <typename TD>
cudaError_t tensor_map(const void* c, int d, long long rows, CUtensorMap* map) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
                                              cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || encode == nullptr) return cudaErrorNotSupported;
  }
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

// One launch of dense_kernel<TD, L2, E, S> over a grid of `blocks` x the
// query groups, on corpus rows [0, a.n_valid) (Stage<TD>: through the
// tensor map of those rows).
template <typename TD, bool L2, typename E, typename S = Stage<TD>>
cudaError_t launch_dense(const typename E::Args& a, const CUtensorMap& map, int blocks, cudaStream_t st) {
  const size_t smem = size_t(S::kHead) + size_t(S::stages(a.d)) * S::bytes(a.d) + S::kAlign;   // room to align
  auto kernel = dense_kernel<TD, L2, E, S>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(blocks, (a.b + kQB - 1) / kQB), kDenseThreads, smem, st>>>(a, map);
  return cudaGetLastError();
}

}  // namespace ring
