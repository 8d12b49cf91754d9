// Fused dense+sparse scores for sm_90a, no selection.  One C entry point:
//
//   fused_score_launch  replaces src/repro/kernels/sparse_dense.py
//                       fused_score_pallas (with _kernel):
//                       score[b, n] = w_d*<q_d[b], c_d[n]> + w_s*sum_j qd[b, idx[n,j]]*val[n,j]
//                       written as f32 [B, N]; pad id V lands in the
//                       table's zero row.
//
// Design.  The scoring half of topk_scan.cu's scan_kernel, with the top-k
// replaced by a store.  Each block scores one tile of kRows corpus rows
// for QB = 16 queries: per thread a register tile of 4 rows x 4 queries,
// corpus chunks of kDenseChunk columns transposed through shared memory
// (the next chunk's loads in flight meanwhile), the sparse part gathered
// 4 queries at a time from the densified query table laid out transposed,
// [V+1, b_pad].  B reaches 128 (the NAPP build scores all pivots as
// queries), so blocks are numbered query group fastest: the 8 blocks
// that share a corpus tile run side by side and all but the first find
// the tile in L2.  Each thread's 4 rows are contiguous in the output, so
// a warp stores 4 full 128-byte lines per instruction.  The ragged last
// tile is masked here: nothing is padded.
//
// What bounds it on an H100 SXM (80 GB at 3.35 TB/s, 67 TFLOP/s f32 on
// CUDA cores), at MS MARCO passage scale (8,841,823 x 768 f32 dense,
// 128-nnz COO over 30,522 terms): at B = 16 the 36.2 GB corpus and the
// 0.57 GB output, 10.98 ms by bytes against 3.8 ms of operations; at
// B = 128 (the NAPP build) 2.03 TFLOP, 30.3 ms by operations.  The
// sparse part reads the table 16 (128) times per COO slot from L2:
// 72 GB (579 GB) of L2 traffic, the same traffic that holds topk_scan.cu's
// fused kernel above its HBM bound (PERF.md holds what was measured).
//
// Numerics.  IEEE f32 on CUDA cores: no TF32, bf16 converted with
// __bfloat162float before the first multiply.  Both weights always
// apply, as in the TPU kernel: the mix is
// __fadd_rn(__fmul_rn(w_d, dense), __fmul_rn(w_s, sparse)), rounded
// products and a rounded sum that nvcc cannot contract into one FMA.
#include "topk_scan.cuh"

namespace fscore {

using topk::kDenseChunk;
using topk::kRows;
using topk::kSparseChunk;
using topk::kThreads;
using topk::swizzle;
using topk::to_f32;

constexpr int QB = 16;                                   // queries per block
constexpr int QG = QB / 4;                               // query groups of 4
constexpr int R = kRows * QG / kThreads;                 // rows per thread
constexpr int kLoads = kRows * kDenseChunk / 4 / kThreads;   // float4 loads per thread per chunk
static_assert(R == 4, "each thread holds 4 contiguous rows");
constexpr int kDenseStage = kDenseChunk * kRows * 4 + kDenseChunk * QB * 4;
constexpr int kSparseStage = kRows * (kSparseChunk + 1) * 4 * 2;
constexpr int kStage = kDenseStage > kSparseStage ? kDenseStage : kSparseStage;

struct Args {
  const float* q_dense;   // [B, D] f32
  const void* c_dense;    // [N, D] f32/bf16
  int d;
  const float* qdt;       // [V+1, b_pad] f32 transposed densified queries
  int b_pad;
  const int* c_idx;       // [N, NNZ] i32
  const void* c_val;      // [N, NNZ] f32/bf16
  int nnz;
  int vocab;              // the pad id; its table row is zero
  int b, n, n_groups;
  float w_dense, w_sparse;
  float* out;             // [B, N] f32
};

// Four consecutive corpus values as f32 (16-byte f32 or 8-byte bf16
// load).  Plain cached loads: the other query groups' blocks re-read the
// tile from L2.
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename TD, typename TV>
__global__ void __launch_bounds__(kThreads) score_kernel(Args a) {
  __shared__ float4 smem4[kStage / 16];
  float* c_tile = reinterpret_cast<float*>(smem4);           // [kDenseChunk][kRows], swizzled
  float* q_tile = c_tile + kDenseChunk * kRows;              // [kDenseChunk][QB]
  int* idx_tile = reinterpret_cast<int*>(smem4);             // [kRows][kSparseChunk + 1]
  float* val_tile = reinterpret_cast<float*>(idx_tile + kRows * (kSparseChunk + 1));

  const int tid = threadIdx.x;
  const int qg = tid % QG, rg = tid / QG;
  const int q0 = int(blockIdx.x % unsigned(a.n_groups)) * QB;
  const int qn = min(QB, a.b - q0);
  const int tile0 = int(blockIdx.x / unsigned(a.n_groups)) * kRows;
  const int row_end = min(a.n, tile0 + kRows);
  const TD* cd = static_cast<const TD*>(a.c_dense);
  const TV* cv = static_cast<const TV*>(a.c_val);
  const bool vec = a.d % 4 == 0 && reinterpret_cast<uintptr_t>(a.c_dense) % 16 == 0;

  float4 pre[kLoads];
  // chunk [tile0, +kRows) x [d0, +kDenseChunk) into registers; zero outside
  auto load_chunk = [&](int d0) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
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
  auto store_chunk = [&](int d0) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = i * kThreads + tid;
      const int r = e / (kDenseChunk / 4), c = 4 * (e % (kDenseChunk / 4));
      c_tile[swizzle(c + 0, r)] = pre[i].x;
      c_tile[swizzle(c + 1, r)] = pre[i].y;
      c_tile[swizzle(c + 2, r)] = pre[i].z;
      c_tile[swizzle(c + 3, r)] = pre[i].w;
    }
    for (int e = tid; e < kDenseChunk * QB; e += kThreads) {
      const int c = e / QB, q = e % QB;
      q_tile[e] = (q < qn && d0 + c < a.d) ? a.q_dense[size_t(q0 + q) * a.d + d0 + c] : 0.f;
    }
  };

  float dense[R][4], sparse[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) { dense[r][j] = 0.f; sparse[r][j] = 0.f; }
  }

  load_chunk(0);
  for (int d0 = 0; d0 < a.d; d0 += kDenseChunk) {
    __syncthreads();   // the previous chunk is done
    store_chunk(d0);
    __syncthreads();
    if (d0 + kDenseChunk < a.d) load_chunk(d0 + kDenseChunk);   // in flight meanwhile
#pragma unroll 8
    for (int c = 0; c < kDenseChunk; ++c) {
      const float4 qv = *reinterpret_cast<const float4*>(q_tile + c * QB + 4 * qg);
      const float4 t = *reinterpret_cast<const float4*>(c_tile + swizzle(c, 4 * rg));
      const float x[R] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int r = 0; r < R; ++r) {
        dense[r][0] = fmaf(qv.x, x[r], dense[r][0]);
        dense[r][1] = fmaf(qv.y, x[r], dense[r][1]);
        dense[r][2] = fmaf(qv.z, x[r], dense[r][2]);
        dense[r][3] = fmaf(qv.w, x[r], dense[r][3]);
      }
    }
  }

  for (int j0 = 0; j0 < a.nnz; j0 += kSparseChunk) {
    __syncthreads();
    for (int e = tid; e < kRows * kSparseChunk; e += kThreads) {
      const int r = e / kSparseChunk, c = e % kSparseChunk;
      const int grow = tile0 + r, gj = j0 + c;
      int id = a.vocab;
      float v = 0.f;
      if (grow < row_end && gj < a.nnz) {
        id = a.c_idx[size_t(grow) * a.nnz + gj];
        v = to_f32(cv[size_t(grow) * a.nnz + gj]);
      }
      idx_tile[r * (kSparseChunk + 1) + c] = id;
      val_tile[r * (kSparseChunk + 1) + c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int lr = rg * R + r;
#pragma unroll
      for (int c = 0; c < kSparseChunk; ++c) {
        unsigned id = static_cast<unsigned>(idx_tile[lr * (kSparseChunk + 1) + c]);
        if (id > static_cast<unsigned>(a.vocab)) id = a.vocab;   // out of range reads the zero row
        const float v = val_tile[lr * (kSparseChunk + 1) + c];
        const float4 t = __ldg(reinterpret_cast<const float4*>(a.qdt + size_t(id) * a.b_pad + q0 + 4 * qg));
        sparse[r][0] = fmaf(t.x, v, sparse[r][0]);
        sparse[r][1] = fmaf(t.y, v, sparse[r][1]);
        sparse[r][2] = fmaf(t.z, v, sparse[r][2]);
        sparse[r][3] = fmaf(t.w, v, sparse[r][3]);
      }
    }
  }

  // out rows are 16-byte aligned when N % 4 == 0 (the wrapper allocates out)
  const int row0 = tile0 + rg * R;
  const bool vec_out = a.n % 4 == 0 && row0 + R <= row_end;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = 4 * qg + j;
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

template <typename TD, typename TV>
cudaError_t launch(const Args& a, unsigned blocks, cudaStream_t stream) {
  score_kernel<TD, TV><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace fscore

extern "C" {

// Fused dense+sparse scores [B, N]; both parts required.  Returns a
// cudaError_t.
int fused_score_launch(const float* qdt, int b_pad, const int* c_idx, const void* c_val, int val_bf16,
                       int nnz, int vocab, const float* q_dense, const void* c_dense, int dense_bf16,
                       int d, int b, int n, float w_dense, float w_sparse, float* out, void* stream) {
  using bf = __nv_bfloat16;
  if (!qdt || !c_idx || !c_val || !q_dense || !c_dense || !out || b < 1 || n < 1 || d < 0 ||
      nnz < 0 || vocab < 0 || b_pad % fscore::QB || b_pad < b)
    return int(cudaErrorInvalidValue);
  fscore::Args a{};
  a.q_dense = q_dense; a.c_dense = c_dense; a.d = d;
  a.qdt = qdt; a.b_pad = b_pad; a.c_idx = c_idx; a.c_val = c_val; a.nnz = nnz; a.vocab = vocab;
  a.b = b; a.n = n; a.n_groups = (b + fscore::QB - 1) / fscore::QB;
  a.w_dense = w_dense; a.w_sparse = w_sparse; a.out = out;
  const long long blocks = ((long long)n + topk::kRows - 1) / topk::kRows * a.n_groups;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const unsigned g = unsigned(blocks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dense_bf16) return int(val_bf16 ? fscore::launch<bf, bf>(a, g, st) : fscore::launch<bf, float>(a, g, st));
  return int(val_bf16 ? fscore::launch<float, bf>(a, g, st) : fscore::launch<float, float>(a, g, st));
}

}  // extern "C"
