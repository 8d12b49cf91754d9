// Exact top-k scan over a dense, sparse (padded COO) or fused dense+sparse
// corpus, for sm_90a.  Two C entry points share one kernel:
//
//   mips_topk_launch   replaces src/repro/kernels/mips_topk.py
//                      mips_topk_pallas (with _kernel and _fold_topk):
//                      dense ip or negated l2 scores plus a running top-k;
//   fused_topk_launch  replaces src/repro/kernels/fused_topk.py
//                      fused_topk_pallas (with _kernel):
//                      w_d*dense_kind(q_d, c_d) + w_s*sum_j qd[b, idx[n,j]]*val[n,j]
//                      plus the same top-k; either part may be absent.
//
// Design.  The TPU grid walks corpus tiles in order and carries the top-k
// in VMEM from step to step.  Blocks on Hopper run in parallel, so:
//   1. scan: grid (corpus split x query group).  Each block scans a
//      contiguous row range in tiles of kRows rows, scores them in f32 on
//      CUDA cores for QB queries at once, and keeps a per-query top-k by
//      threshold insertion (topk_scan.cuh); it writes partials
//      [B, n_splits, k];
//   2. merge: one block per query streams its n_splits*k partials through
//      the same threshold list and writes the final [B, k].
//
// What bounds it on an H100 SXM (80 GB at 3.35 TB/s, 67 TFLOP/s f32 on
// CUDA cores): the dense part moves each corpus byte once, 27.16 GB =
// 8.1 ms for 8.84M x 768 f32, against 3.2 ms of f32 FMAs at B = 16; the
// FMAs only stay under the memory time if shared memory feeds them fast
// enough.  So each thread keeps a register tile of R rows x 4 queries
// (R = QB/4): per staged column it reads one 16-byte vector of corpus
// values and one of query values and issues 4R FMAs.  Corpus chunks are
// loaded with 16-byte streaming loads (__ldcs: read once, kept out of L2's
// way), transposed into shared memory, and the next chunk's loads are in
// flight while the current chunk is multiplied.
// The sparse part gathers 4 contiguous floats per COO slot and thread
// from the densified query table laid out transposed, [V+1, b_pad].  The
// table (1.95 MB at V = 30,522 and B = 16) stays in L2, and 16 x 128 table
// reads per corpus row (72 GB per batch) are expected to bound the fused
// kernel by L2, not by HBM (an estimate; PERF.md holds what was measured).
//
// Numerics.  Every score is IEEE f32: no TF32, bf16 loads converted with
// __bfloat162float before the first multiply.  The mix is computed as
// __fadd_rn(__fmul_rn(w_d, dense), __fmul_rn(w_s, sparse)) so that nvcc
// cannot contract it into one FMA: the reference rounds each product.
// l2 is -((q2 + c2) - 2*s), the grouping of spaces.dense_scores.  Rows
// at or past n_valid score f32-min (NEG), as in the TPU kernel; the
// ragged last tile is masked here, so no padding to a tile is needed.
#include "topk_scan.cuh"

namespace topk {

struct ScanArgs {
  const float* q_dense;   // [B, D] f32, or null
  const void* c_dense;    // [N, D] f32/bf16, or null
  int d;
  const float* qdt;       // [V+1, b_pad] f32 transposed densified queries, or null
  int b_pad;
  const int* c_idx;       // [N, NNZ] i32, or null
  const void* c_val;      // [N, NNZ] f32/bf16
  int nnz;
  int vocab;              // the pad id; its table row is zero
  int b, n, n_valid, k;
  int l2, weighted;
  float w_dense, w_sparse;
  float* part_s;          // [B, n_splits, k]
  int* part_i;
  int n_splits, rows_per_split, buf;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Staging area for one tile, shared by the dense and the sparse pass (they
// run one after the other, separated by barriers).
template <int QB>
__host__ __device__ inline size_t staging_bytes() {
  const size_t dense = size_t(kDenseChunk) * kRows * 4 + size_t(kDenseChunk) * QB * 4;
  const size_t sparse = size_t(kRows) * (kSparseChunk + 1) * 4 * 2;
  return align16(dense > sparse ? dense : sparse);
}

template <int QB>
__host__ __device__ inline size_t scan_smem_bytes(int buf) {
  return align16(size_t(QB) * buf * 4) * 2 + align16(QB * 16) + staging_bytes<QB>();
}

// Four consecutive corpus values as f32 (16-byte f32 or 8-byte bf16 load).
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <int QB, bool DENSE, bool SPARSE, typename TD, typename TV>
__global__ void __launch_bounds__(kThreads) scan_kernel(ScanArgs a) {
  // thread layout: QG query groups of 4 x (kRows / R) row groups of R rows
  constexpr int QG = QB / 4;
  constexpr int R = kRows * QG / kThreads;
  static_assert(QB % 4 == 0 && R * kThreads == kRows * QG && (R == 1 || R == 4), "layout");
  constexpr int kLoads = kRows * kDenseChunk / 4 / kThreads;   // float4 loads per thread per chunk

  extern __shared__ float4 smem4[];
  char* p = reinterpret_cast<char*>(smem4);
  float* cand_s = reinterpret_cast<float*>(p);  p += align16(size_t(QB) * a.buf * 4);
  int* cand_i = reinterpret_cast<int*>(p);      p += align16(size_t(QB) * a.buf * 4);
  int* cnt = reinterpret_cast<int*>(p);
  float* th_s = reinterpret_cast<float*>(cnt + QB);
  int* th_i = reinterpret_cast<int*>(th_s + QB);
  float* q2 = reinterpret_cast<float*>(th_i + QB);
  p += align16(QB * 16);
  float* c_tile = reinterpret_cast<float*>(p);               // [kDenseChunk][kRows], swizzled
  float* q_tile = c_tile + kDenseChunk * kRows;              // [kDenseChunk][QB]
  int* idx_tile = reinterpret_cast<int*>(p);                 // [kRows][kSparseChunk + 1]
  float* val_tile = reinterpret_cast<float*>(idx_tile + kRows * (kSparseChunk + 1));

  const int tid = threadIdx.x;
  const int qg = tid % QG, rg = tid / QG;
  const int split = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const int qn = min(QB, a.b - q0);
  const int row_begin = split * a.rows_per_split;
  const int row_end = min(a.n, row_begin + a.rows_per_split);
  const TD* cd = static_cast<const TD*>(a.c_dense);
  const TV* cv = static_cast<const TV*>(a.c_val);
  const bool vec = a.d % 4 == 0 && reinterpret_cast<uintptr_t>(a.c_dense) % 16 == 0;

  auto cands = [&](int q) {
    return Cands{cand_s + size_t(q) * a.buf, cand_i + size_t(q) * a.buf, cnt + q, th_s + q, th_i + q};
  };
  if (tid < QB) {
    init_cands(cands(tid));
    float acc = 0.f;
    if (DENSE && a.l2 && tid < qn) {
      const float* qrow = a.q_dense + size_t(q0 + tid) * a.d;
      for (int j = 0; j < a.d; ++j) acc = fmaf(qrow[j], qrow[j], acc);
    }
    q2[tid] = acc;
  }

  float4 pre[kLoads];
  // chunk [tile0, +kRows) x [d0, +kDenseChunk) into registers; zero outside
  auto load_chunk = [&](int tile0, int d0) {
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

  for (int tile0 = row_begin; tile0 < row_end; tile0 += kRows) {
    __syncthreads();
    for (int q = 0; q < qn; ++q) {
      if (cnt[q] > a.buf - kRows) compact(cands(q), a.buf, a.k);
    }
    float dense[R][4], sparse[R][4], c2[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      c2[r] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) { dense[r][j] = 0.f; sparse[r][j] = 0.f; }
    }

    if (DENSE) {
      load_chunk(tile0, 0);
      for (int d0 = 0; d0 < a.d; d0 += kDenseChunk) {
        __syncthreads();   // the previous chunk (or the compaction) is done
        store_chunk(d0);
        __syncthreads();
        if (d0 + kDenseChunk < a.d) load_chunk(tile0, d0 + kDenseChunk);   // in flight meanwhile
#pragma unroll 8
        for (int c = 0; c < kDenseChunk; ++c) {
          const float4 qv = *reinterpret_cast<const float4*>(q_tile + c * QB + 4 * qg);
          float x[R];
          if constexpr (R == 4) {
            const float4 t = *reinterpret_cast<const float4*>(c_tile + swizzle(c, 4 * rg));
            x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
          } else {
            x[0] = c_tile[swizzle(c, rg)];
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (a.l2) c2[r] = fmaf(x[r], x[r], c2[r]);
            dense[r][0] = fmaf(qv.x, x[r], dense[r][0]);
            dense[r][1] = fmaf(qv.y, x[r], dense[r][1]);
            dense[r][2] = fmaf(qv.z, x[r], dense[r][2]);
            dense[r][3] = fmaf(qv.w, x[r], dense[r][3]);
          }
        }
      }
    }

    if (SPARSE) {
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
            const float4 t = __ldg(reinterpret_cast<const float4*>(
                a.qdt + size_t(id) * a.b_pad + q0 + 4 * qg));
            sparse[r][0] = fmaf(t.x, v, sparse[r][0]);
            sparse[r][1] = fmaf(t.y, v, sparse[r][1]);
            sparse[r][2] = fmaf(t.z, v, sparse[r][2]);
            sparse[r][3] = fmaf(t.w, v, sparse[r][3]);
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = tile0 + rg * R + r;
      if (row >= row_end) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = 4 * qg + j;
        if (q >= qn) continue;
        float dv = dense[r][j];
        if (DENSE && a.l2) dv = -__fsub_rn(__fadd_rn(q2[q], c2[r]), __fmul_rn(2.f, dv));
        float score;
        if (DENSE && SPARSE) {
          score = __fadd_rn(__fmul_rn(a.w_dense, dv), __fmul_rn(a.w_sparse, sparse[r][j]));
        } else if (DENSE) {
          score = a.weighted ? __fmul_rn(a.w_dense, dv) : dv;
        } else {
          score = a.weighted ? __fmul_rn(a.w_sparse, sparse[r][j]) : sparse[r][j];
        }
        if (row >= a.n_valid) score = kNeg;
        offer(cands(q), score, row);
      }
    }
  }

  __syncthreads();
  for (int q = 0; q < qn; ++q) {
    compact(cands(q), a.buf, a.k);
    const size_t out = (size_t(q0 + q) * a.n_splits + split) * a.k;
    for (int j = tid; j < a.k; j += kThreads) {
      a.part_s[out + j] = cand_s[size_t(q) * a.buf + j];
      a.part_i[out + j] = cand_i[size_t(q) * a.buf + j];
    }
  }
}

// One block per query: top-k of its m = n_splits*k partials.
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* part_s, const int* part_i, int m, int k, int buf, float* out_s, int* out_i) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  int* id = reinterpret_cast<int*>(s + buf);
  int* cnt = id + buf;
  float* th_s = reinterpret_cast<float*>(cnt + 1);
  int* th_i = reinterpret_cast<int*>(th_s + 1);
  const Cands c{s, id, cnt, th_s, th_i};
  const size_t q = blockIdx.x;
  if (threadIdx.x == 0) init_cands(c);
  for (int base = 0; base < m; base += kThreads) {
    __syncthreads();
    if (*cnt > buf - kThreads) compact(c, buf, k);
    const int p = base + threadIdx.x;
    if (p < m) offer(c, part_s[q * m + p], part_i[q * m + p]);
  }
  __syncthreads();
  compact(c, buf, k);
  for (int j = threadIdx.x; j < k; j += kThreads) {
    out_s[q * k + j] = s[j];
    out_i[q * k + j] = id[j];
  }
}

template <int QB, bool DENSE, bool SPARSE, typename TD, typename TV>
cudaError_t launch_scan(const ScanArgs& a, cudaStream_t stream) {
  const size_t smem = scan_smem_bytes<QB>(a.buf);
  auto kernel = scan_kernel<QB, DENSE, SPARSE, TD, TV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n_splits, (a.b + QB - 1) / QB);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int QB>
cudaError_t dispatch_types(const ScanArgs& a, bool dense_bf16, bool val_bf16, cudaStream_t st) {
  using bf = __nv_bfloat16;
  const bool dense = a.c_dense != nullptr, sparse = a.c_idx != nullptr;
  if (dense && sparse) {
    if (dense_bf16) return val_bf16 ? launch_scan<QB, true, true, bf, bf>(a, st)
                                    : launch_scan<QB, true, true, bf, float>(a, st);
    return val_bf16 ? launch_scan<QB, true, true, float, bf>(a, st)
                    : launch_scan<QB, true, true, float, float>(a, st);
  }
  if (dense) return dense_bf16 ? launch_scan<QB, true, false, bf, float>(a, st)
                               : launch_scan<QB, true, false, float, float>(a, st);
  return val_bf16 ? launch_scan<QB, false, true, float, bf>(a, st)
                  : launch_scan<QB, false, true, float, float>(a, st);
}

cudaError_t run(const ScanArgs& a, int qb, bool dense_bf16, bool val_bf16,
                float* out_s, int* out_i, cudaStream_t st) {
  const bool dense = a.c_dense != nullptr, sparse = a.c_idx != nullptr;
  if (!(dense || sparse) || a.k < 1 || a.k > a.n || a.buf < a.k + kRows || (a.buf & (a.buf - 1)) ||
      a.n_splits < 1 || size_t(a.n_splits) * a.rows_per_split < size_t(a.n) ||
      a.rows_per_split % kRows || (sparse && (a.b_pad % 4 || a.b_pad < (a.b + qb - 1) / qb * qb)) ||
      (dense && sparse && !a.weighted))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (qb == 16) err = dispatch_types<16>(a, dense_bf16, val_bf16, st);
  else if (qb == 4) err = dispatch_types<4>(a, dense_bf16, val_bf16, st);
  else return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  const size_t smem = size_t(a.buf) * 8 + 16;
  err = cudaFuncSetAttribute(merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  merge_kernel<<<a.b, kThreads, smem, st>>>(a.part_s, a.part_i, a.n_splits * a.k, a.k, a.buf, out_s, out_i);
  return cudaGetLastError();
}

}  // namespace topk

extern "C" {

// Dense ip (l2 = 0) or negated l2 (l2 = 1) top-k.  Returns a cudaError_t.
int mips_topk_launch(const float* q, const void* c, int c_bf16, int b, int n, int d, int n_valid,
                     int k, int l2, float* part_s, int* part_i, int n_splits, int rows_per_split,
                     int qb, int buf, float* out_s, int* out_i, void* stream) {
  topk::ScanArgs a{};
  a.q_dense = q; a.c_dense = c; a.d = d;
  a.b = b; a.n = n; a.n_valid = n_valid; a.k = k; a.l2 = l2; a.weighted = 0;
  a.part_s = part_s; a.part_i = part_i;
  a.n_splits = n_splits; a.rows_per_split = rows_per_split; a.buf = buf;
  return int(topk::run(a, qb, c_bf16 != 0, false, out_s, out_i, static_cast<cudaStream_t>(stream)));
}

// Fused dense+sparse top-k.  A null c_dense (or c_idx) drops that part;
// weighted = 0 leaves a single part unscaled.  Returns a cudaError_t.
int fused_topk_launch(const float* qdt, int b_pad, const int* c_idx, const void* c_val, int val_bf16,
                      int nnz, int vocab, const float* q_dense, const void* c_dense, int dense_bf16,
                      int d, int b, int n, int n_valid, int k, int l2, int weighted, float w_dense,
                      float w_sparse, float* part_s, int* part_i, int n_splits, int rows_per_split,
                      int qb, int buf, float* out_s, int* out_i, void* stream) {
  topk::ScanArgs a{};
  a.q_dense = q_dense; a.c_dense = c_dense; a.d = d;
  a.qdt = qdt; a.b_pad = b_pad; a.c_idx = c_idx; a.c_val = c_val; a.nnz = nnz; a.vocab = vocab;
  a.b = b; a.n = n; a.n_valid = n_valid; a.k = k; a.l2 = l2; a.weighted = weighted;
  a.w_dense = w_dense; a.w_sparse = w_sparse;
  a.part_s = part_s; a.part_i = part_i;
  a.n_splits = n_splits; a.rows_per_split = rows_per_split; a.buf = buf;
  return int(topk::run(a, qb, dense_bf16 != 0, val_bf16 != 0, out_s, out_i,
                       static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
