// The dense score ring shared by topk_large.cu (every row's score into a
// [B, n_valid] buffer) and mips_topk.cu (B1: a sample of tiles scored into
// a small buffer, then a scan that keeps only the rows above a threshold).
//
// One persistent block an SM scores tiles of kTileRows rows for kQB queries.
// Eight warps hold a 4-row x 4-query register tile per thread (fmaf in
// column order, |c|^2 in the same pass for l2); a ninth warp feeds them a
// ring of kStages shared-memory stages (kChunk columns of a tile, as one
// tensor-map box copied by the copy engine, and the queries' kChunk
// columns), each stage handed over on an mbarrier, so three stages of loads
// are in flight while one is multiplied and no barrier holds the whole
// block.  What a finished tile's scores become is the epilogue's business:
// a policy type E gives the tiles a launch walks and what happens at the
// end of each (see dense_kernel).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "topk_scan.cuh"

namespace ring {

constexpr int kTileRows = 256;     // rows of a tile
constexpr int kQB = 16;            // queries of a block
constexpr int kChunk = 32;         // columns of a ring stage
constexpr int kStages = 4;         // ring depth
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

// A stage holds a tile's rows for kChunk columns, row-major, as the tensor
// map's 128-byte (f32) or 64-byte (bf16) swizzle lays them out: the 16-byte
// pieces of a row XORed with its index, so that the eight rows a warp reads
// at once (rows x..x+7, the same columns) hit distinct banks; then the
// block's 16 queries' values of those columns, column-major.
template <typename TD>
struct Stage {
  static constexpr int kRowBytes = kChunk * int(sizeof(TD));   // 128 (f32) or 64 (bf16)
  static constexpr int kPieces = kRowBytes / 16;
  static constexpr int kTile = kTileRows * kRowBytes;
  static constexpr int kBytes = kTile + kQStage;
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
};

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The score of a finished accumulator: the inner product, or l2's
// -((|q|^2 + |c|^2) - 2 s), the grouping of spaces.dense_scores.
template <bool L2>
__device__ __forceinline__ float dense_score(float acc, float c2, float q2) {
  return L2 ? -__fsub_rn(__fadd_rn(q2, c2), __fmul_rn(2.f, acc)) : acc;
}

// Warps 0-7 multiply: thread (warp w, lane l) holds rows 32w + l/4 + 8r
// (r < 4) of a tile and queries 4(l%4) .. +3 of the block's 16.  Warp 8
// copies: for each stage it waits until the eight warps have released the
// ring slot, then one thread copies the tile's box through the tensor map
// and the queries' columns, completing on the slot's `full` barrier.
//
// E::Args carries q (the queries as [groups, d_pad, 16], d_pad = d rounded
// up to kChunk, zero-padded: mips_topk.py query_groups), d, b and n_valid.
// The policy E gives
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
template <typename TD, bool L2, typename E>
__global__ void __launch_bounds__(kDenseThreads, 1) dense_kernel(typename E::Args a, const __grid_constant__ CUtensorMap map) {
  using S = Stage<TD>;
  extern __shared__ __align__(16) unsigned char ring_raw[];
  // the swizzled boxes need 1024-byte alignment
  unsigned char* smem = ring_raw + ((1024u - (smem_u32(ring_raw) & 1023u)) & 1023u);
  __shared__ __align__(8) unsigned long long full[kStages], empty[kStages];
  __shared__ float q2s[kQB];
  __shared__ typename E::Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.y * kQB, qn = min(kQB, a.b - q0);
  const int cpt = (a.d + kChunk - 1) / kChunk;   // stages a tile
  const float* qg = a.q + size_t(blockIdx.y) * cpt * kChunk * kQB;
  const long long n_units = E::units(a);
  const long long mine = blockIdx.x < n_units ? (n_units - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long total = mine * cpt;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
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
  if (tid < kQB) E::init(a, sh, tid, q0, qn);
  __syncthreads();

  if (warp == kConsumers) {   // the copying warp
    if (lane == 0) {
      for (long long s = 0; s < total; ++s) {
        const int slot = int(s % kStages);
        const long long round = s / kStages;
        if (round > 0) mbar_wait(&empty[slot], unsigned(round - 1) & 1u);
        const long long row0 = E::first_row(a, blockIdx.x + (s / cpt) * gridDim.x);
        const int col0 = int(s % cpt) * kChunk;
        unsigned char* st = smem + slot * S::kBytes;
        mbar_expect_tx(&full[slot], S::kBytes);
        tile_copy(st, &map, col0, int(row0), &full[slot]);
        bulk_copy(st + S::kTile, qg + size_t(col0) * kQB, kQStage, &full[slot]);
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
  for (long long s = 0; s < total; ++s) {
    const int slot = int(s % kStages);
    mbar_wait(&full[slot], unsigned(s / kStages) & 1u);
    const unsigned char* st = smem + slot * S::kBytes;
    const float* qs = reinterpret_cast<const float*>(st + S::kTile);
#pragma unroll
    for (int c4 = 0; c4 < kChunk / 4; ++c4) {
      float4 x[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) x[r] = S::read4(st, row_in + 8 * r, c4);
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
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);   // this warp is done with the slot
    if (s % cpt == cpt - 1) {   // the tile is scored: hand it over, start the next
      const long long unit = blockIdx.x + (s / cpt) * gridDim.x;
      E::template tile<L2>(a, sh, unit, E::first_row(a, unit), row_in, acc, c2, q2s, q0, qn, lane);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        c2[r] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
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

// One launch of dense_kernel<TD, L2, E> over a grid of `blocks` x the query
// groups, on the tensor map of corpus rows [0, a.n_valid).
template <typename TD, bool L2, typename E>
cudaError_t launch_dense(const typename E::Args& a, const CUtensorMap& map, int blocks, cudaStream_t st) {
  const size_t smem = size_t(kStages) * Stage<TD>::kBytes + 1024;   // room to align the ring to 1024 bytes
  auto kernel = dense_kernel<TD, L2, E>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(blocks, (a.b + kQB - 1) / kQB), kDenseThreads, smem, st>>>(a, map);
  return cudaGetLastError();
}

}  // namespace ring
