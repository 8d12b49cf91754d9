// Exact top-k scan over a dense, sparse (padded COO) or fused dense+sparse
// corpus, for sm_90a.  Two C entry points share one kernel:
//
//   mips_topk_launch   dense ip or negated l2 scores plus a running top-k
//                      (src/repro/kernels/mips_topk.py mips_topk_pallas), for
//                      the corpora B1's ring route (mips_topk.cu) cannot
//                      take: D above 32 and not a multiple of 16 bytes, a
//                      base not 16-byte aligned;
//   fused_topk_launch  B2's scan route (src/repro/kernels/fused_topk.py
//                      fused_topk_pallas, with _kernel):
//                      w_d*dense_kind(q_d, c_d) + w_s*sum_j qd[b, idx[n,j]]*val[n,j]
//                      plus the same top-k; either part may be absent.
//                      It serves only what no layout of B2's
//                      ring route (fused_topk.cu) takes: D above 32 and
//                      not a multiple of 16 bytes, an odd D of at most 32,
//                      nnz above 32 and not a multiple of 16 bytes' worth,
//                      a base off 16 bytes (a shard at an odd row of
//                      D = 18 f32), a dense and a value array of two
//                      dtypes.  Its answers are the ring's bit for bit,
//                      which chip_smoke.py ("b2 small") holds.
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
// The sparse part no longer gathers the densified query table from L2
// (16 floats per COO slot, 72 GB per batch at B = 16, which held the fused
// kernel at 2.6x its bytes bound).  The wrapper builds a query-term index
// of the block's query group (topk_scan.cuh: presence bits and ranks over
// the term ids, and a compact table of the present columns); the block
// stages the index words in shared memory (7.6 KB at V = 30,522; global
// memory above kWordsSmemCap, through the same code).  The COO slots
// stream through in chunks of kSparseChunk with 16-byte streaming loads,
// the next chunk's in flight while this one is used; four lanes turn a
// row's chunk into its hit list (stage_hits) and each thread multiplies
// only its rows' hits, reading the group's values from the compact table
// in L2 (about 1.7% of slots at B = 16 on uniform ids).  A miss would add
// fmaf(0, v, acc) = acc, so the sums are bit for bit the gather's.  The
// compact table stays in global memory: in shared memory it would cost
// the second block an SM at qb = 16.  What bounds this kernel is the dense
// part's memory pipeline (55% of HBM) plus the per-slot staging, and above
// k = 256 the plan's 4 queries a block (the corpus read four times at
// B = 16): the reasons B2 moved to the ring (PERF.md holds what was
// measured).  The dense-only instantiation
// (mips_topk_launch) compiles to the same code as before the index; it now
// serves only B1's corpora that neither ring layout takes (D > 32 not a
// multiple of 16 bytes, an unaligned base: mips_topk.cu).
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
  const uint2* words;     // [groups, index_words(vocab)] query-term index words, or null
  const float* table;     // [groups, vocab + 2, QB] compact query tables
  const int* c_idx;       // [N, NNZ] i32, or null
  const void* c_val;      // [N, NNZ] f32/bf16
  int nnz;
  int vocab;              // the pad id
  int b, n, n_valid, k;
  int l2, weighted;
  float w_dense, w_sparse;
  float* part_s;          // [B, n_splits, k] the order keys' bits
  int* part_i;
  int n_splits, rows_per_split, buf;
  int stage_words;        // the block's index words fit in shared memory
};
// The dense-only kernel (mips_topk_launch) reads its arguments at the
// offsets they had before the index: one more 8-byte field made nvcc emit
// different and 14% slower code for that unchanged kernel (PERF.md).  A new
// field takes the place of an old one.
static_assert(sizeof(ScanArgs) == 128, "ScanArgs layout: see the note above");

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Staging area for one tile, shared by the dense and the sparse pass (they
// run one after the other, separated by barriers).
template <int QB>
__host__ __device__ inline size_t staging_bytes() {
  const size_t dense = size_t(kDenseChunk) * kRows * 4 + size_t(kDenseChunk) * QB * 4;
  const size_t sparse = size_t(kRows) * (kSparseChunk + 1) * 4 * 2;
  return align16(dense > sparse ? dense : sparse);
}

// Candidate lists, per-query scalars, staging, then (sparse, staged) the
// block's index words.
template <int QB>
__host__ __device__ inline size_t scan_smem_bytes(int buf, size_t words_bytes) {
  return align16(size_t(QB) * buf * 4) * 2 + align16(QB * 16) + staging_bytes<QB>() + words_bytes;
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
  constexpr int kSlotLoads = kRows * kSparseChunk / 4 / kThreads;   // 4-slot loads per thread per chunk

  extern __shared__ float4 smem4[];
  char* p = reinterpret_cast<char*>(smem4);
  unsigned* cand_k = reinterpret_cast<unsigned*>(p);  p += align16(size_t(QB) * a.buf * 4);
  int* cand_i = reinterpret_cast<int*>(p);            p += align16(size_t(QB) * a.buf * 4);
  int* cnt = reinterpret_cast<int*>(p);
  unsigned* th_k = reinterpret_cast<unsigned*>(cnt + QB);
  int* th_i = reinterpret_cast<int*>(th_k + QB);
  float* q2 = reinterpret_cast<float*>(th_i + QB);
  p += align16(QB * 16);
  float* c_tile = reinterpret_cast<float*>(p);               // [kDenseChunk][kRows], swizzled
  float* q_tile = c_tile + kDenseChunk * kRows;              // [kDenseChunk][QB]
  int* row_tile = reinterpret_cast<int*>(p);                 // [kRows][kSparseChunk + 1] compact rows
  float* val_tile = reinterpret_cast<float*>(row_tile + kRows * (kSparseChunk + 1));
  uint2* s_words = reinterpret_cast<uint2*>(p + staging_bytes<QB>());

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
  const bool svec = a.nnz % 4 == 0 && reinterpret_cast<uintptr_t>(a.c_idx) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(a.c_val) % (4 * sizeof(TV)) == 0;

  auto cands = [&](int q) {
    return Cands{cand_k + size_t(q) * a.buf, cand_i + size_t(q) * a.buf, cnt + q, th_k + q, th_i + q};
  };
  // the block's query group has one index; its words go to shared memory
  // when they fit (made visible by the first tile's barrier)
  const uint2* words = nullptr;
  const float* table = nullptr;
  if (SPARSE) {
    const int nw = index_words(a.vocab);
    words = a.words + size_t(blockIdx.y) * nw;
    table = a.table + size_t(blockIdx.y) * (a.vocab + 2) * QB + 4 * qg;
    if (a.stage_words) {
      for (int i = tid; i < nw; i += kThreads) s_words[i] = words[i];
      words = s_words;
    }
  }
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
      // a pipeline over chunks of kSparseChunk slots: the next chunk's ids
      // and values are in flight while this chunk is multiplied
      int4 pid[kSlotLoads];
      float4 pval[kSlotLoads];
      auto load_slots = [&](int j0) {
#pragma unroll
        for (int i = 0; i < kSlotLoads; ++i) {
          const int e = i * kThreads + tid;
          const int grow = tile0 + e / (kSparseChunk / 4), j = j0 + 4 * (e % (kSparseChunk / 4));
          pid[i] = make_int4(0, 0, 0, 0);
          pval[i] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (grow < row_end && j < a.nnz)
            load_slots4(a.c_idx + size_t(grow) * a.nnz, cv + size_t(grow) * a.nnz, j, a.nnz, svec,
                        pid[i], pval[i]);
        }
      };
      load_slots(0);
      for (int j0 = 0; j0 < a.nnz; j0 += kSparseChunk) {
        __syncthreads();
        // each row's slots become its hit list (topk_scan.cuh: stage_hits);
        // the next chunk's loads go out as soon as the registers are free
#pragma unroll
        for (int i = 0; i < kSlotLoads; ++i) {
          const int e = i * kThreads + tid;
          const int r = e / (kSparseChunk / 4), j = j0 + 4 * (e % (kSparseChunk / 4));
          const int real = tile0 + r < row_end ? min(4, max(0, a.nnz - j)) : 0;
          stage_hits<1>(words, 0, a.vocab, pid[i], pval[i], real, row_tile + r * (kSparseChunk + 1),
                        val_tile + r * (kSparseChunk + 1), 0);
        }
        if (j0 + kSparseChunk < a.nnz) load_slots(j0 + kSparseChunk);
        __syncthreads();
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int* hit = row_tile + (rg * R + r) * (kSparseChunk + 1);
          const float* hv = val_tile + (rg * R + r) * (kSparseChunk + 1);
          for (int h = 0; h < hit[kSparseChunk]; ++h) {
            const float4 t = __ldg(reinterpret_cast<const float4*>(table + size_t(hit[h]) * QB));
            const float v = hv[h];
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
        offer(cands(q), order_key(score), row);
      }
    }
  }

  __syncthreads();
  for (int q = 0; q < qn; ++q) {
    compact(cands(q), a.buf, a.k);
    const size_t out = (size_t(q0 + q) * a.n_splits + split) * a.k;
    for (int j = tid; j < a.k; j += kThreads) {
      a.part_s[out + j] = __uint_as_float(cand_k[size_t(q) * a.buf + j]);   // keys, for merge_kernel
      a.part_i[out + j] = cand_i[size_t(q) * a.buf + j];
    }
  }
}

// One block per query: top-k of its m = n_splits*k partials (order keys
// in part_s's bits).
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* part_s, const int* part_i, int m, int k, int buf, float* out_s, int* out_i) {
  extern __shared__ float4 smem4[];
  unsigned* key = reinterpret_cast<unsigned*>(smem4);
  int* id = reinterpret_cast<int*>(key + buf);
  int* cnt = id + buf;
  unsigned* th_k = reinterpret_cast<unsigned*>(cnt + 1);
  int* th_i = reinterpret_cast<int*>(th_k + 1);
  const Cands c{key, id, cnt, th_k, th_i};
  const size_t q = blockIdx.x;
  if (threadIdx.x == 0) init_cands(c);
  for (int base = 0; base < m; base += kThreads) {
    __syncthreads();
    const bool crowded = *cnt > buf - kThreads;
    // no offer may move the count before every thread has read it: a warp
    // that read it late would enter compact's barriers alone (a delayed
    // warp, as under another stream's kernel on the same SMs, did so)
    __syncthreads();
    if (crowded) compact(c, buf, k);
    const int p = base + threadIdx.x;
    if (p < m) offer(c, __float_as_uint(part_s[q * m + p]), part_i[q * m + p]);
  }
  __syncthreads();
  compact(c, buf, k);
  for (int j = threadIdx.x; j < k; j += kThreads) {
    out_s[q * k + j] = from_key(key[j]);
    out_i[q * k + j] = id[j];
  }
}

template <int QB, bool DENSE, bool SPARSE, typename TD, typename TV>
cudaError_t launch_scan(ScanArgs a, cudaStream_t stream) {
  const size_t words_bytes = SPARSE ? size_t(index_words(a.vocab)) * 8 : 0;
  a.stage_words = SPARSE && words_bytes <= size_t(kWordsSmemCap);
  const size_t smem = scan_smem_bytes<QB>(a.buf, a.stage_words ? align16(words_bytes) : 0);
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
      a.rows_per_split % kRows || (sparse && (!a.words || !a.table || a.vocab < 0 || a.vocab > 0x7ffffffd)) ||
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

// The query-term index (topk_scan.cuh: index_kernel_bits, index_kernel_rows)
// of `groups` groups of `group` queries.
template <typename T>
cudaError_t query_index(const T* qd, int b, int vocab, int group, int groups, uint2* words,
                        float* table, cudaStream_t st) {
  const dim3 grid((index_words(vocab) + kIndexWords - 1) / kIndexWords, groups);
  index_kernel_bits<<<grid, kIndexThreads, 0, st>>>(qd, b, vocab, group, words);
  index_kernel_rows<<<grid, kIndexThreads, 0, st>>>(qd, b, vocab, group, words, table);
  return cudaGetLastError();
}

}  // namespace topk

extern "C" {

// The query-term index (topk_scan.cuh: index_kernel_bits, index_kernel_rows)
// of `groups` groups of `group` queries from the densified table
// [b, vocab + 1] (f32, or bf16 with bf16 = 1).  Returns a cudaError_t.
int query_index_launch(const void* qd, int bf16, int b, int vocab, int group, int groups,
                       void* words, float* table, void* stream) {
  if (!qd || !words || !table || b < 1 || vocab < 0 || vocab > 0x7ffffffd || group < 1 ||
      groups < (b + group - 1) / group || groups > 65535)
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint2* w = static_cast<uint2*>(words);
  if (bf16) return int(topk::query_index(static_cast<const __nv_bfloat16*>(qd), b, vocab, group, groups, w, table, st));
  return int(topk::query_index(static_cast<const float*>(qd), b, vocab, group, groups, w, table, st));
}

// Dense ip (l2 = 0) or negated l2 (l2 = 1) top-k: B1's scan route, for rows
// the ring route (mips_topk.cu) cannot copy by tensor map.  Returns a
// cudaError_t.
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
// weighted = 0 leaves a single part unscaled.  `words` and `table` are the
// query-term index of ceil(B / qb) groups of qb queries
// (kernels/query_index.py).  Returns a cudaError_t.
int fused_topk_launch(const void* words, const float* table, const int* c_idx, const void* c_val, int val_bf16,
                      int nnz, int vocab, const float* q_dense, const void* c_dense, int dense_bf16,
                      int d, int b, int n, int n_valid, int k, int l2, int weighted, float w_dense,
                      float w_sparse, float* part_s, int* part_i, int n_splits, int rows_per_split,
                      int qb, int buf, float* out_s, int* out_i, void* stream) {
  topk::ScanArgs a{};
  a.q_dense = q_dense; a.c_dense = c_dense; a.d = d;
  a.words = static_cast<const uint2*>(words); a.table = table; a.c_idx = c_idx; a.c_val = c_val; a.nnz = nnz; a.vocab = vocab;
  a.b = b; a.n = n; a.n_valid = n_valid; a.k = k; a.l2 = l2; a.weighted = weighted;
  a.w_dense = w_dense; a.w_sparse = w_sparse;
  a.part_s = part_s; a.part_i = part_i;
  a.n_splits = n_splits; a.rows_per_split = rows_per_split; a.buf = buf;
  return int(topk::run(a, qb, dense_bf16 != 0, val_bf16 != 0, out_s, out_i,
                       static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
