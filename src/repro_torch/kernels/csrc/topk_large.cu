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
//    allow 16-byte copies takes dense_kernel: one persistent block an SM
//    scores tiles of 256 rows for 16 queries.  Eight warps hold a 4-row x
//    4-query register tile per thread (B1's arithmetic: fmaf in column
//    order, |c|^2 in the same pass for l2); a ninth warp feeds them a ring
//    of kStages shared-memory stages (32 columns of a tile, as one
//    tensor-map box copied by the copy engine, and the queries' 32
//    columns), each stage handed over on an mbarrier, so three stages of
//    loads are in flight while one is multiplied and no barrier holds the
//    whole block; scores leave as 32-byte sectors.  Other corpora take
//    row_kernel (one warp a row, the graph hop's arithmetic,
//    score_row.cuh); the wrapper scores a fused corpus through
//    fused_score.cu.
// 2. Selection, spread over every SM (select_launch):
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
// read.  B1 keeps its next chunk in flight through registers and reaches
// 55% of HBM; the ring keeps three.  With the copies taken off the
// multiplying warps the score pass runs close to its arithmetic's own time
// (the shared-memory reads of the register tiles), which sits a little
// above the corpus read.  PERF.md has the times on an H100.
#include <cuda.h>
#include <cudaTypedefs.h>

#include "score_row.cuh"
#include "topk_scan.cuh"

namespace large {

constexpr int kThreads = 256;      // row and pass kernels
constexpr int kTileRows = 256;     // rows of a dense tile
constexpr int kQB = 16;            // queries of a dense block
constexpr int kChunk = 32;         // columns of a ring stage
constexpr int kStages = 4;         // ring depth
constexpr int kQStage = kChunk * kQB * 4;   // query bytes of a stage

// ---- 1. scores ---------------------------------------------------------

struct DenseArgs {
  const float* q;     // [ceil(B / 16), D rounded up to kChunk, 16] f32 (topk_large.py: query_groups)
  const void* c;      // [N, D] f32/bf16, 16-byte aligned, D a multiple of 16 bytes' worth
  int d, b, n_valid, l2, weighted;
  float w;
  float* scores;      // [B, n_valid]
};

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

constexpr int kConsumers = 8;                          // warps that multiply
constexpr int kDenseThreads = (kConsumers + 1) * 32;   // and one that copies

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

// Warps 0-7 multiply: thread (warp w, lane l) holds rows 32w + l/4 + 8r
// (r < 4) of a tile and queries 4(l%4) .. +3 of the block's 16.  Warp 8
// copies: for each stage it waits until the eight warps have released the
// ring slot, then one thread copies the tile's box through the tensor map
// and the queries' columns, completing on the slot's `full` barrier.  a.q
// is the queries as [groups, d_pad, 16] (d_pad = d rounded up to kChunk,
// zero-padded).
template <typename TD, bool L2>
__global__ void __launch_bounds__(kDenseThreads, 1) dense_kernel(DenseArgs a, const __grid_constant__ CUtensorMap map) {
  using S = Stage<TD>;
  extern __shared__ __align__(16) unsigned char ring_raw[];
  // the swizzled boxes need 1024-byte alignment
  unsigned char* smem = ring_raw + ((1024u - (smem_u32(ring_raw) & 1023u)) & 1023u);
  __shared__ __align__(8) unsigned long long full[kStages], empty[kStages];
  __shared__ float q2s[kQB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.y * kQB, qn = min(kQB, a.b - q0);
  const int cpt = (a.d + kChunk - 1) / kChunk;   // stages a tile
  const float* qg = a.q + size_t(blockIdx.y) * cpt * kChunk * kQB;
  const long long n_tiles = (a.n_valid + kTileRows - 1) / kTileRows;
  const long long mine = blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
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
  __syncthreads();

  if (warp == kConsumers) {   // the copying warp
    if (lane == 0) {
      for (long long s = 0; s < total; ++s) {
        const int slot = int(s % kStages);
        const long long round = s / kStages;
        if (round > 0) mbar_wait(&empty[slot], unsigned(round - 1) & 1u);
        const long long row0 = (blockIdx.x + (s / cpt) * gridDim.x) * kTileRows;
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
    if (s % cpt == cpt - 1) {   // the tile is scored: store, start the next
      const long long row0 = (blockIdx.x + (s / cpt) * gridDim.x) * kTileRows + row_in;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const long long row = row0 + 8 * r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = 4 * qgi + j;
          float v = acc[r][j];
          if (L2) v = -__fsub_rn(__fadd_rn(q2s[q], c2[r]), __fmul_rn(2.f, v));
          if (a.weighted) v = __fmul_rn(a.w, v);
          if (row < a.n_valid && q < qn) a.scores[size_t(q0 + q) * a.n_valid + row] = v;
          acc[r][j] = 0.f;
        }
        c2[r] = 0.f;
      }
    }
  }
}

// The corpus's tensor map: rows [0, n_valid) x columns [0, d), a box of
// kTileRows x kChunk, swizzled as Stage<TD> reads it.
template <typename TD>
cudaError_t tensor_map(const DenseArgs& a, CUtensorMap* map) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
                                              cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || encode == nullptr) return cudaErrorNotSupported;
  }
  const cuuint64_t dims[2] = {cuuint64_t(a.d), cuuint64_t(a.n_valid)};
  const cuuint64_t strides[1] = {cuuint64_t(a.d) * sizeof(TD)};
  const cuuint32_t box[2] = {cuuint32_t(kChunk), cuuint32_t(kTileRows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, sizeof(TD) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            2, const_cast<void*>(a.c), dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            sizeof(TD) == 4 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename TD>
cudaError_t launch_dense(const DenseArgs& a, int blocks, cudaStream_t st) {
  CUtensorMap map;
  cudaError_t err = tensor_map<TD>(a, &map);
  if (err != cudaSuccess) return err;
  const size_t smem = size_t(kStages) * Stage<TD>::kBytes + 1024;   // room to align the ring to 1024 bytes
  auto kernel = a.l2 ? dense_kernel<TD, true> : dense_kernel<TD, false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(blocks, (a.b + kQB - 1) / kQB), kDenseThreads, smem, st>>>(a, map);
  return cudaGetLastError();
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

// ---- 2. selection ------------------------------------------------------

constexpr int kPer = 8;                           // scores a pass thread loads before using them
constexpr int kPassRows = kThreads * kPer;        // a chunk is a multiple of this
constexpr int kSelThreads = 1024;                 // thresh and finish kernels
constexpr int kLevels = 3;
__host__ __device__ constexpr int level_shift(int l) { return l == 0 ? 20 : l == 1 ? 10 : 0; }
__host__ __device__ constexpr int level_bits(int l) { return l == 0 ? 12 : 10; }
constexpr int kHistInts = (1 << 12) + 2 * (1 << 10);   // a query's three histograms
constexpr int kSortSmem = 16384;                  // list entries the finish sorts in shared memory

// A query's selection state (global; zeroed before hist<0>).
struct State {
  unsigned prefix;   // the resolved top bits of the k-th key
  int shift;         // 32 - (bits resolved)
  int need;          // rank of the k-th key among the rows matching the prefix
  int above;         // rows whose key is above the prefix
  int count;         // rows matching the prefix
  int mode;          // 0: refine; 1: collect the rows matching the prefix; 2: fill the first `need` of them
  int list_n;        // entries appended to the list
  int pad;
};
static_assert(sizeof(State) == 32, "State is 8 ints");

struct SelArgs {
  const float* scores;   // [B, n_valid]
  int b, n_valid, k, cap, chunk_rows, chunks;
  long long list_cap;    // list entries a query (a power of two >= k + cap)
  State* state;          // [B]
  int* hist;             // [B, kHistInts]
  int* ties;             // [B, chunks] rows of the k-th key per chunk (mode 2)
  float* list_s;         // [B, list_cap]
  int* list_i;
  float* out_s;          // [B, k]
  int* out_i;
};

__host__ __device__ constexpr int hist_offset(int l) { return l == 0 ? 0 : l == 1 ? (1 << 12) : (1 << 12) + (1 << 10); }

template <int LEVEL>
__global__ void __launch_bounds__(kThreads) hist_kernel(SelArgs a) {
  constexpr int kBins = 1 << level_bits(LEVEL);
  __shared__ int h[kBins];
  const int q = blockIdx.y, tid = threadIdx.x, lane = tid & 31;
  unsigned prefix = 0;
  if (LEVEL > 0) {
    const State st = a.state[q];
    if (st.mode != 0) return;   // resolved at an earlier level
    prefix = st.prefix;
  }
  for (int i = tid; i < kBins; i += kThreads) h[i] = 0;
  __syncthreads();
  const float* s = a.scores + size_t(q) * a.n_valid;
  const long long r0 = (long long)blockIdx.x * a.chunk_rows;
  const long long r1 = min((long long)a.n_valid, r0 + a.chunk_rows);
  for (long long base = r0; base < r1; base += kPassRows) {
    float x[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const long long i = base + u * kThreads + tid;
      x[u] = i < r1 ? __ldcg(s + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const unsigned key = topk::order_key(x[u]);
      const bool take = base + u * kThreads + tid < r1 &&
                        (LEVEL == 0 || (key >> level_shift(LEVEL - 1)) == prefix);
      // a warp whose rows all fall in one bin adds once (a crowded bin,
      // all-equal scores); otherwise each row adds its own
      const int bin = (key >> level_shift(LEVEL)) & (kBins - 1);
      const int bin0 = __shfl_sync(0xffffffffu, bin, 0);
      if (__all_sync(0xffffffffu, take && bin == bin0)) {
        if (lane == 0) atomicAdd(&h[bin0], 32);
      } else if (take) {
        atomicAdd(&h[bin], 1);
      }
    }
  }
  __syncthreads();
  int* g = a.hist + size_t(q) * kHistInts + hist_offset(LEVEL);
  for (int i = tid; i < kBins; i += kThreads) {
    if (h[i]) atomicAdd(g + i, h[i]);
  }
}

// Exclusive block-wide prefix sum of v over kSelThreads threads; `total`
// receives the sum.
__device__ __forceinline__ long long block_scan(long long v, long long* warp_sums, long long& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  long long before = 0;
  total = 0;
  for (int i = 0; i < int(blockDim.x) / 32; ++i) {
    const long long s = warp_sums[i];
    before += i < warp ? s : 0;
    total += s;
  }
  __syncthreads();   // warp_sums is reused by the next call
  return before + x - v;
}

// One block a query: the bin of the k-th key among the rows matching the
// prefix, the rows above it, and whether to refine.
template <int LEVEL>
__global__ void __launch_bounds__(kSelThreads) thresh_kernel(SelArgs a) {
  constexpr int kBins = 1 << level_bits(LEVEL);
  constexpr int kEach = kBins / kSelThreads;
  __shared__ long long warp_sums[kSelThreads / 32];
  const int q = blockIdx.x, tid = threadIdx.x;
  State* st = a.state + q;
  if (LEVEL > 0 && st->mode != 0) return;
  const long long need = LEVEL == 0 ? a.k : st->need;
  const int* h = a.hist + size_t(q) * kHistInts + hist_offset(LEVEL);
  // thread t holds bins [kBins - (t + 1) * kEach, kBins - t * kEach): the
  // top bins first, so the scan counts the rows in higher bins
  const int hi = kBins - tid * kEach;
  long long mine = 0;
#pragma unroll
  for (int i = 1; i <= kEach; ++i) mine += h[hi - i];
  long long total;
  const long long higher = block_scan(mine, warp_sums, total);
  if (higher < need && need <= higher + mine) {
    long long above = higher;
    int bin = hi - 1;
    for (; above + h[bin] < need; --bin) above += h[bin];
    const int count = h[bin];
    st->prefix = LEVEL == 0 ? unsigned(bin) : (st->prefix << level_bits(LEVEL)) | unsigned(bin);
    st->shift = level_shift(LEVEL);
    st->need = int(need - above);
    st->above = (LEVEL == 0 ? 0 : st->above) + int(above);
    st->count = count;
    st->mode = count <= a.cap ? 1 : LEVEL == kLevels - 1 ? 2 : 0;
  }
}

// Appends the rows above the prefix, and in mode 1 those matching it, to
// the query's list (warp-aggregated atomics); in mode 2 counts the rows
// of the k-th key in the chunk.
__global__ void __launch_bounds__(kThreads) collect_kernel(SelArgs a) {
  __shared__ int tied;
  const int q = blockIdx.y, tid = threadIdx.x, lane = tid & 31;
  State* stp = a.state + q;
  const State st = *stp;
  if (tid == 0) tied = 0;
  __syncthreads();
  const float* s = a.scores + size_t(q) * a.n_valid;
  float* ls = a.list_s + size_t(q) * a.list_cap;
  int* li = a.list_i + size_t(q) * a.list_cap;
  const long long r0 = (long long)blockIdx.x * a.chunk_rows;
  const long long r1 = min((long long)a.n_valid, r0 + a.chunk_rows);
  int my_ties = 0;
  for (long long base = r0; base < r1; base += kPassRows) {
    float x[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const long long i = base + u * kThreads + tid;
      x[u] = i < r1 ? __ldcg(s + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const long long i = base + u * kThreads + tid;
      const unsigned top = topk::order_key(x[u]) >> st.shift;
      const bool in = i < r1;
      const bool take = in && (top > st.prefix || (st.mode == 1 && top == st.prefix));
      my_ties += in && st.mode == 2 && top == st.prefix;
      const unsigned m = __ballot_sync(0xffffffffu, take);
      if (m) {
        int p0 = 0;
        if (lane == __ffs(m) - 1) p0 = atomicAdd(&stp->list_n, __popc(m));
        p0 = __shfl_sync(0xffffffffu, p0, __ffs(m) - 1);
        if (take) {
          const int p = p0 + __popc(m & ((1u << lane) - 1u));
          ls[p] = x[u];
          li[p] = int(i);
        }
      }
    }
  }
  if (st.mode == 2) {
    my_ties = __reduce_add_sync(0xffffffffu, my_ties);
    if (lane == 0 && my_ties) atomicAdd(&tied, my_ties);
    __syncthreads();
    if (tid == 0) a.ties[size_t(q) * a.chunks + blockIdx.x] = tied;
  }
}

// Mode 2: the first `need` rows of the k-th key, in row order, after the
// `above` rows collect wrote.  A chunk's offset is the count of tied rows
// in the chunks before it; within a chunk thread t takes rows base +
// kPer*t .. + kPer - 1 and a block scan orders the threads.
__global__ void __launch_bounds__(kSelThreads) fill_kernel(SelArgs a) {
  __shared__ long long warp_sums[kSelThreads / 32];
  const int q = blockIdx.y, tid = threadIdx.x;
  const State st = a.state[q];
  if (st.mode != 2) return;
  const int* t = a.ties + size_t(q) * a.chunks;
  long long before = 0;
  for (int c = tid; c < int(blockIdx.x); c += kSelThreads) before += t[c];
  long long offset;
  block_scan(before, warp_sums, offset);
  if (offset >= st.need) return;
  const unsigned kth = st.prefix;   // all 32 bits
  const float* s = a.scores + size_t(q) * a.n_valid;
  float* ls = a.list_s + size_t(q) * a.list_cap + st.above;
  int* li = a.list_i + size_t(q) * a.list_cap + st.above;
  const long long r0 = (long long)blockIdx.x * a.chunk_rows;
  const long long r1 = min((long long)a.n_valid, r0 + a.chunk_rows);
  long long taken = offset;
  for (long long base = r0; base < r1 && taken < st.need; base += kSelThreads * kPer) {
    const long long i0 = base + (long long)tid * kPer;
    float x[kPer];
    int cnt = 0;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      x[u] = i0 + u < r1 ? __ldcg(s + i0 + u) : 0.f;
      cnt += i0 + u < r1 && topk::order_key(x[u]) == kth;
    }
    long long total;
    long long p = taken + block_scan(cnt, warp_sums, total);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if (i0 + u < r1 && topk::order_key(x[u]) == kth) {
        if (p < st.need) {
          ls[p] = x[u];
          li[p] = int(i0 + u);
        }
        ++p;
      }
    }
    taken += total;
  }
}

// One block a query: sort the list best first and write its first k.  In
// shared memory an entry is one integer, (order key << 32) | ~row, so a
// step of the sort is one compare.
__global__ void __launch_bounds__(kSelThreads) finish_kernel(SelArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = blockIdx.x, tid = threadIdx.x;
  const State st = a.state[q];
  const long long m = st.mode == 2 ? (long long)a.k : (long long)st.list_n;
  long long size = 1;
  while (size < m) size <<= 1;
  float* ls = a.list_s + size_t(q) * a.list_cap;
  int* li = a.list_i + size_t(q) * a.list_cap;
  float* out_s = a.out_s + size_t(q) * a.k;
  int* out_i = a.out_i + size_t(q) * a.k;
  if (size > kSortSmem) {   // in global memory, in place
    for (long long j = m + tid; j < size; j += kSelThreads) {
      ls[j] = topk::lowest();
      li[j] = topk::kSentinelId;
    }
    __syncthreads();
    topk::sort_best_first(ls, li, int(size));
    for (int j = tid; j < a.k; j += kSelThreads) {
      out_s[j] = ls[j];
      out_i[j] = li[j];
    }
    return;
  }
  unsigned long long* key = reinterpret_cast<unsigned long long*>(smem);
  for (int j = tid; j < int(size); j += kSelThreads)
    key[j] = j < m ? (static_cast<unsigned long long>(topk::order_key(ls[j])) << 32) | unsigned(~li[j]) : 0ull;
  __syncthreads();
  const int half = int(size) / 2;
  for (int len = 2; len <= size; len <<= 1) {
    for (int stride = len >> 1; stride > 0; stride >>= 1) {
      for (int p = tid; p < half; p += kSelThreads) {
        const int lo = 2 * stride * (p / stride) + (p % stride), hi = lo + stride;
        const unsigned long long x = key[lo], y = key[hi];
        if ((x < y) == ((lo & len) == 0)) {
          key[lo] = y;
          key[hi] = x;
        }
      }
      __syncthreads();
    }
  }
  for (int j = tid; j < a.k; j += kSelThreads) {
    const unsigned long long x = key[j];
    const unsigned ok = unsigned(x >> 32);
    out_s[j] = __uint_as_float((ok & 0x80000000u) ? (ok & 0x7fffffffu) : ~ok);   // order_key's inverse
    out_i[j] = int(~unsigned(x));
  }
}

cudaError_t run_select(const SelArgs& a, cudaStream_t st) {
  if (a.b < 1 || a.n_valid < 1 || a.k < 1 || a.k > a.n_valid || a.cap < 1 || a.chunk_rows < kPassRows ||
      a.chunk_rows % kPassRows || (long long)a.chunks * a.chunk_rows < a.n_valid || a.b > 65535 || a.list_cap < (long long)a.k + a.cap || (a.list_cap & (a.list_cap - 1)) ||
      a.list_cap > 0x7fffffffll || !a.scores || !a.state || !a.hist || !a.ties || !a.list_s || !a.list_i ||
      !a.out_s || !a.out_i)
    return cudaErrorInvalidValue;
  // state, histograms and tie counts are one zeroed workspace
  cudaError_t err = cudaMemsetAsync(a.state, 0,
                                    size_t(a.b) * (sizeof(State) + kHistInts * 4 + size_t(a.chunks) * 4), st);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.chunks, a.b);
  hist_kernel<0><<<grid, kThreads, 0, st>>>(a);
  thresh_kernel<0><<<a.b, kSelThreads, 0, st>>>(a);
  hist_kernel<1><<<grid, kThreads, 0, st>>>(a);
  thresh_kernel<1><<<a.b, kSelThreads, 0, st>>>(a);
  hist_kernel<2><<<grid, kThreads, 0, st>>>(a);
  thresh_kernel<2><<<a.b, kSelThreads, 0, st>>>(a);
  collect_kernel<<<grid, kThreads, 0, st>>>(a);
  fill_kernel<<<grid, kSelThreads, 0, st>>>(a);
  const int smem = kSortSmem * 8;
  err = cudaFuncSetAttribute(finish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  finish_kernel<<<a.b, kSelThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace large

extern "C" {

// Dense ip (l2 = 0) or negated-l2 scores [b, n_valid] of the first n_valid
// rows through dense_kernel, times w when weighted.  c is f32 (c_bf16 = 0)
// or bf16, 16-byte aligned with d a multiple of 4 (f32) or 8 (bf16) values;
// q is the queries grouped as dense_kernel reads them (DenseArgs).
// `blocks` is the grid's row dimension.  Returns a cudaError_t.
int topk_large_dense_launch(const float* q, const void* c, int c_bf16, int d, int b, int n_valid,
                            int l2, int weighted, float w, int blocks, float* scores, void* stream) {
  const int elems = c_bf16 ? 8 : 4;
  if (!q || !c || !scores || b < 1 || n_valid < 1 || d < 1 || d % elems ||
      reinterpret_cast<uintptr_t>(c) % 16 || blocks < 1 || (b + large::kQB - 1) / large::kQB > 65535)
    return int(cudaErrorInvalidValue);
  large::DenseArgs a{q, c, d, b, n_valid, l2, weighted, w, scores};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(c_bf16 ? large::launch_dense<__nv_bfloat16>(a, blocks, st) : large::launch_dense<float>(a, blocks, st));
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
