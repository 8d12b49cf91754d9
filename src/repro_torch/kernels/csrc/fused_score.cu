// Fused dense+sparse scores for sm_90a, no selection.  One C entry point:
//
//   fused_score_launch  replaces src/repro/kernels/sparse_dense.py
//                       fused_score_pallas (with _kernel):
//                       score[b, n] = w_d*<q_d[b], c_d[n]> + w_s*sum_j qd[b, idx[n,j]]*val[n,j]
//                       written as f32 [B, N]; pad id V reads the table's
//                       column V.
//
// Design.  The scoring half of topk_scan.cu's scan_kernel, with the top-k
// replaced by a store.  Each block scores one tile of corpus rows for QB
// queries: per thread a register tile of 4 rows x QW queries, corpus
// chunks of kDenseChunk columns transposed through shared memory and the
// queries' columns read with 16-byte loads from a transposed copy (q_t,
// built by the wrapper in the order the threads read it), the next
// chunk's loads in flight meanwhile.  Two shapes:
//   QB = 16: 256-row tiles, 4 queries a thread (B <= 32: the query batch
//            and the NAPP probe);
//   QB = 64: 128-row tiles, 8 queries a thread (the NAPP build, B = 128:
//            each corpus tile is read by 2 blocks, not 8).
// Blocks are numbered query block fastest, so the blocks that share a
// corpus tile run side by side and the second finds it in L2.  Both
// shapes ask for two blocks an SM (at most 128 registers a thread).
//
// The sparse part does not read the densified query table.  The wrapper
// builds, per group of 16 queries, a query-term index (topk_scan.cuh:
// presence bits and ranks over the term ids, and a compact table of the
// group's present columns).  A block stages its groups' index words in
// shared memory (global memory above kWordsSmemCap: V large, the same
// code through a generic pointer).  The COO slots stream through in
// chunks of kSparseChunk with 16-byte loads, the next chunk's in flight
// while this one is used; four lanes turn a row's chunk into one hit list
// per group (stage_hits), and each thread then multiplies only its rows'
// hits, reading the group's values from the compact table in L2.  A miss
// contributes fmaf(0, v, acc) = acc, so the sums are bit for bit those of
// the table gather (misses with a non-finite value stay in the list).
//
// What bounds it on an H100 SXM (80 GB at 3.35 TB/s, 67 TFLOP/s f32 on
// CUDA cores), at MS MARCO passage scale (8,841,823 x 768 f32 dense,
// 128-nnz COO over 30,522 terms): at B = 16 the 36.2 GB corpus and the
// 0.57 GB output, 10.98 ms by bytes; at B = 128 the 1.74 TFLOP of dense
// products, about 26 ms by operations (the sparse products the data needs
// are those of the pivots that hold a row's terms, 1.2 GFLOP).  The table
// gather this replaces read 16 (128) floats from L2 per COO slot, 72 GB
// (579 GB); the hits are about 1.7% of slots per group at B = 16 and 6.7%
// at B = 128 on uniform ids.  What is left: the dense part's FMA issue at
// B = 128 and the per-slot staging (PERF.md holds what was measured).
//
// Numerics.  IEEE f32 on CUDA cores: no TF32, bf16 converted with
// __bfloat162float before the first multiply.  Both weights always
// apply, as in the TPU kernel: the mix is
// __fadd_rn(__fmul_rn(w_d, dense), __fmul_rn(w_s, sparse)), rounded
// products and a rounded sum that nvcc cannot contract into one FMA.
#include "topk_scan.cuh"

namespace fscore {

using topk::index_words;
using topk::kDenseChunk;
using topk::kSparseChunk;
using topk::kThreads;
using topk::kWordsSmemCap;
using topk::load_slots4;
using topk::stage_hits;
using topk::swizzle;
using topk::to_f32;

constexpr int kGroup = 16;     // queries per index group
constexpr int kNarrowQB = 16;  // queries per block, B <= 32
constexpr int kWideQB = 64;    // queries per block, B > 32

struct Args {
  const float* q_t;       // [D, b_pad] f32: the queries transposed, each block's columns in read order
  int b_pad;
  const void* c_dense;    // [N, D] f32/bf16
  int d;
  const uint2* words;     // [groups, index_words(vocab)] index words
  const float* table;     // [groups, vocab + 2, kGroup] compact tables
  const int* c_idx;       // [N, NNZ] i32
  const void* c_val;      // [N, NNZ] f32/bf16
  int nnz;
  int vocab;              // the pad id
  int b, n, n_qblocks, stage_words;
  float w_dense, w_sparse;
  float* out;             // [B, N] f32
};

template <int QB>
struct Shape {
  static constexpr int QW = QB == kNarrowQB ? 4 : 8;         // queries per thread
  static constexpr int QG = QB / QW;                          // threads per row group
  static constexpr int R = 4;                                 // rows per thread
  static constexpr int ROWS = kThreads / QG * R;              // rows per tile
  static constexpr int NG = QB / kGroup;                      // index groups per block
  static constexpr int kLoads = ROWS * kDenseChunk / 4 / kThreads;   // float4 loads per thread per chunk
  static constexpr int kSlotLoads = ROWS * kSparseChunk / 4 / kThreads;   // 4-slot loads per thread per chunk
  static constexpr int kSlotStride = kSparseChunk + 1;
  static constexpr int kRowTile = ROWS * kSlotStride + 1;     // odd: the groups' rows fall in other banks
  static constexpr int kDenseStage = kDenseChunk * ROWS * 4 + kDenseChunk * QB * 4;
  static constexpr int kSparseStage = 2 * NG * kRowTile * 4;  // hit lists: rows and values per group
  static constexpr int kQLoads = (kDenseChunk * QB / 4 + kThreads - 1) / kThreads;   // float4 loads of queries
  static constexpr int kStageMax = kDenseStage > kSparseStage ? kDenseStage : kSparseStage;
  static constexpr int kStage = (kStageMax + 15) / 16 * 16;     // the dense and sparse staging share it
  static_assert(QG * QW == QB && QW % 4 == 0 && kLoads * 4 * kThreads == ROWS * kDenseChunk, "layout");
};

// Four consecutive corpus values as f32 (16-byte f32 or 8-byte bf16
// load).  Plain cached loads: the other query blocks re-read the tile
// from L2.
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Two blocks an SM (at most 128 registers a thread): one block waits at
// its barriers while the other computes.
template <int QB, typename TD, typename TV>
__global__ void __launch_bounds__(kThreads, 2) score_kernel(Args a) {
  using S = Shape<QB>;
  constexpr int QW = S::QW, QG = S::QG, R = S::R, ROWS = S::ROWS, NG = S::NG;
  extern __shared__ float4 smem4[];
  float* c_tile = reinterpret_cast<float*>(smem4);           // [kDenseChunk][ROWS], swizzled
  float* q_tile = c_tile + kDenseChunk * ROWS;               // [kDenseChunk][QB], q_t's order
  int* row_tile = reinterpret_cast<int*>(smem4);             // [NG][kRowTile] hit lists: rows
  float* val_tile = reinterpret_cast<float*>(row_tile + NG * S::kRowTile);   // and values
  uint2* s_words = reinterpret_cast<uint2*>(reinterpret_cast<char*>(smem4) + S::kStage);

  const int tid = threadIdx.x;
  const int qg = tid % QG, rg = tid / QG;
  const int qblock = int(blockIdx.x % unsigned(a.n_qblocks));
  const int q0 = qblock * QB;
  const int qn = min(QB, a.b - q0);
  const int tile0 = int(blockIdx.x / unsigned(a.n_qblocks)) * ROWS;
  const int row_end = min(a.n, tile0 + ROWS);
  const TD* cd = static_cast<const TD*>(a.c_dense);
  const TV* cv = static_cast<const TV*>(a.c_val);
  const bool vec = a.d % 4 == 0 && reinterpret_cast<uintptr_t>(a.c_dense) % 16 == 0;
  const bool svec = a.nnz % 4 == 0 && reinterpret_cast<uintptr_t>(a.c_idx) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(a.c_val) % (4 * sizeof(TV)) == 0;

  // the block's index groups: q0 / kGroup ... + NG - 1 (the wrapper pads B)
  const int nw = index_words(a.vocab);
  const uint2* words = a.words + size_t(q0 / kGroup) * nw;
  if (a.stage_words) {
    for (int i = tid; i < NG * nw; i += kThreads) s_words[i] = words[i];
    words = s_words;   // made visible by the first chunk's barrier
  }

  float4 pre[S::kLoads], qpre[S::kQLoads];
  // chunk [tile0, +ROWS) x [d0, +kDenseChunk) into registers, zero
  // outside, and the queries' rows [d0, +kDenseChunk) of q_t
  auto load_chunk = [&](int d0) {
#pragma unroll
    for (int i = 0; i < S::kQLoads; ++i) {
      const int e = i * kThreads + tid, c = e / (QB / 4);
      qpre[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < kDenseChunk * QB / 4 && d0 + c < a.d)
        qpre[i] = __ldg(reinterpret_cast<const float4*>(a.q_t + size_t(d0 + c) * a.b_pad + q0 + 4 * (e % (QB / 4))));
    }
#pragma unroll
    for (int i = 0; i < S::kLoads; ++i) {
      const int e = i * kThreads + tid;
      const int r = e / (kDenseChunk / 4), col = d0 + 4 * (e % (kDenseChunk / 4));
      const int grow = tile0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (grow < row_end && col < a.d) {
        const TD* src = cd + size_t(grow) * a.d + col;
        if (vec) {
          v = load4(src);
        } else {
          v.x = to_f32(src[0]);
          if (col + 1 < a.d) v.y = to_f32(src[1]);
          if (col + 2 < a.d) v.z = to_f32(src[2]);
          if (col + 3 < a.d) v.w = to_f32(src[3]);
        }
      }
      pre[i] = v;
    }
  };
  // registers -> transposed shared chunk, plus the queries' columns
  auto store_chunk = [&]() {
#pragma unroll
    for (int i = 0; i < S::kLoads; ++i) {
      const int e = i * kThreads + tid;
      const int r = e / (kDenseChunk / 4), c = 4 * (e % (kDenseChunk / 4));
      c_tile[swizzle<ROWS>(c + 0, r)] = pre[i].x;
      c_tile[swizzle<ROWS>(c + 1, r)] = pre[i].y;
      c_tile[swizzle<ROWS>(c + 2, r)] = pre[i].z;
      c_tile[swizzle<ROWS>(c + 3, r)] = pre[i].w;
    }
#pragma unroll
    for (int i = 0; i < S::kQLoads; ++i) {
      const int e = i * kThreads + tid;
      if (e < kDenseChunk * QB / 4) reinterpret_cast<float4*>(q_tile)[e] = qpre[i];
    }
  };

  float dense[R][QW], sparse[R][QW];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < QW; ++j) { dense[r][j] = 0.f; sparse[r][j] = 0.f; }
  }

  load_chunk(0);
  for (int d0 = 0; d0 < a.d; d0 += kDenseChunk) {
    __syncthreads();   // the previous chunk is done
    store_chunk();
    __syncthreads();
    if (d0 + kDenseChunk < a.d) load_chunk(d0 + kDenseChunk);   // in flight meanwhile
#pragma unroll 8
    for (int c = 0; c < kDenseChunk; ++c) {
      float qv[QW];
#pragma unroll
      for (int h = 0; h < QW / 4; ++h) {
        const float4 t = *reinterpret_cast<const float4*>(q_tile + c * QB + h * (QB / 2) + 4 * qg);
        qv[4 * h] = t.x; qv[4 * h + 1] = t.y; qv[4 * h + 2] = t.z; qv[4 * h + 3] = t.w;
      }
      const float4 t = *reinterpret_cast<const float4*>(c_tile + swizzle<ROWS>(c, 4 * rg));
      const float x[R] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int j = 0; j < QW; ++j) dense[r][j] = fmaf(qv[j], x[r], dense[r][j]);
      }
    }
  }

  // this thread's queries lie in index group g; its table columns start at
  // col.  The sparse part runs as a pipeline over chunks of kSparseChunk
  // slots: the next chunk's ids and values are in flight while this chunk
  // is multiplied.
  const int g = qg * QW / kGroup, col = qg * QW % kGroup;
  const float* table = a.table + (size_t(q0 / kGroup + g) * (a.vocab + 2)) * kGroup + col;
  const int* my_rows = row_tile + g * S::kRowTile;
  const float* my_vals = val_tile + g * S::kRowTile;
  int4 pid[S::kSlotLoads];
  float4 pval[S::kSlotLoads];
  auto load_slots = [&](int j0) {
#pragma unroll
    for (int i = 0; i < S::kSlotLoads; ++i) {
      const int e = i * kThreads + tid;
      const int grow = tile0 + e / (kSparseChunk / 4), j = j0 + 4 * (e % (kSparseChunk / 4));
      pid[i] = make_int4(0, 0, 0, 0);
      pval[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (grow < row_end && j < a.nnz)
        load_slots4(a.c_idx + size_t(grow) * a.nnz, cv + size_t(grow) * a.nnz, j, a.nnz, svec, pid[i], pval[i]);
    }
  };
  if (a.nnz > 0) load_slots(0);
  for (int j0 = 0; j0 < a.nnz; j0 += kSparseChunk) {
    __syncthreads();
    // each row's slots become one hit list per group (topk_scan.cuh:
    // stage_hits); the next chunk's loads go out as soon as the registers
    // are free
#pragma unroll
    for (int i = 0; i < S::kSlotLoads; ++i) {
      const int e = i * kThreads + tid;
      const int r = e / (kSparseChunk / 4), j = j0 + 4 * (e % (kSparseChunk / 4));
      const int real = tile0 + r < row_end ? min(4, max(0, a.nnz - j)) : 0;
      stage_hits<NG>(words, nw, a.vocab, pid[i], pval[i], real, row_tile + r * S::kSlotStride,
                     val_tile + r * S::kSlotStride, S::kRowTile);
    }
    if (j0 + kSparseChunk < a.nnz) load_slots(j0 + kSparseChunk);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int* hit = my_rows + (rg * R + r) * S::kSlotStride;
      const float* hv = my_vals + (rg * R + r) * S::kSlotStride;
      for (int h = 0; h < hit[kSparseChunk]; ++h) {
        const float v = hv[h];
#pragma unroll
        for (int q = 0; q < QW / 4; ++q) {
          const float4 u = __ldg(reinterpret_cast<const float4*>(table + size_t(hit[h]) * kGroup + 4 * q));
          sparse[r][4 * q] = fmaf(u.x, v, sparse[r][4 * q]);
          sparse[r][4 * q + 1] = fmaf(u.y, v, sparse[r][4 * q + 1]);
          sparse[r][4 * q + 2] = fmaf(u.z, v, sparse[r][4 * q + 2]);
          sparse[r][4 * q + 3] = fmaf(u.w, v, sparse[r][4 * q + 3]);
        }
      }
    }
  }

  // out rows are 16-byte aligned when N % 4 == 0 (the wrapper allocates out)
  const int row0 = tile0 + rg * R;
  const bool vec_out = a.n % 4 == 0 && row0 + R <= row_end;
#pragma unroll
  for (int j = 0; j < QW; ++j) {
    const int q = QW * qg + j;
    if (q >= qn) continue;
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      s[r] = __fadd_rn(__fmul_rn(a.w_dense, dense[r][j]), __fmul_rn(a.w_sparse, sparse[r][j]));
    float* dst = a.out + size_t(q0 + q) * a.n + row0;
    if (vec_out) {
      __stcs(reinterpret_cast<float4*>(dst), make_float4(s[0], s[1], s[2], s[3]));
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (row0 + r < row_end) dst[r] = s[r];
    }
  }
}

template <int QB>
size_t smem_bytes(const Args& a) {
  return Shape<QB>::kStage + (a.stage_words ? size_t(Shape<QB>::NG) * index_words(a.vocab) * 8 : 0);
}

template <int QB, typename TD, typename TV>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long blocks = ((long long)a.n + Shape<QB>::ROWS - 1) / Shape<QB>::ROWS * a.n_qblocks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<QB>(a);
  auto kernel = score_kernel<QB, TD, TV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<unsigned(blocks), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int QB>
cudaError_t dispatch(Args a, bool dense_bf16, bool val_bf16, cudaStream_t st) {
  using bf = __nv_bfloat16;
  a.n_qblocks = (a.b + QB - 1) / QB;
  a.stage_words = size_t(Shape<QB>::NG) * index_words(a.vocab) * 8 <= size_t(kWordsSmemCap);
  if (dense_bf16) return val_bf16 ? launch<QB, bf, bf>(a, st) : launch<QB, bf, float>(a, st);
  return val_bf16 ? launch<QB, float, bf>(a, st) : launch<QB, float, float>(a, st);
}

}  // namespace fscore

extern "C" {

// Fused dense+sparse scores [B, N]; both parts required.  qb is 16 or 64
// queries per block; `q_t` [D, b_pad] holds the dense queries transposed,
// each block's qb columns in the order its threads read them
// (sparse_dense.py: query_columns); `words` and `table` are the
// query-term index of b_pad / 16 groups of 16 queries
// (kernels/query_index.py).  Returns a cudaError_t.
int fused_score_launch(const void* words, const float* table, const int* c_idx, const void* c_val,
                       int val_bf16, int nnz, int vocab, const float* q_t, int b_pad, const void* c_dense,
                       int dense_bf16, int d, int b, int n, int qb, float w_dense, float w_sparse,
                       float* out, void* stream) {
  if (!words || !table || !c_idx || !c_val || !q_t || !c_dense || !out || b < 1 || n < 1 ||
      qb < 1 || b_pad % qb || b_pad < b ||
      d < 0 || nnz < 0 || vocab < 0 || vocab > 0x7ffffffd)
    return int(cudaErrorInvalidValue);
  fscore::Args a{};
  a.q_t = q_t; a.b_pad = b_pad; a.c_dense = c_dense; a.d = d;
  a.words = static_cast<const uint2*>(words); a.table = table;
  a.c_idx = c_idx; a.c_val = c_val; a.nnz = nnz; a.vocab = vocab;
  a.b = b; a.n = n;
  a.w_dense = w_dense; a.w_sparse = w_sparse; a.out = out;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qb == fscore::kNarrowQB) return int(fscore::dispatch<fscore::kNarrowQB>(a, dense_bf16, val_bf16, st));
  if (qb == fscore::kWideQB) return int(fscore::dispatch<fscore::kWideQB>(a, dense_bf16, val_bf16, st));
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
