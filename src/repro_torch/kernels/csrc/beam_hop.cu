// One graph-ANN hop for sm_90a: beam_hop_launch replaces
// src/repro/kernels/beam_topk.py beam_hop_pallas (with _hop_kernel and
// the -inf-masking _fold_topk).
//
// A hop, per query b with beam (s, id)[ef] and adjacency nbr[N, R]:
//   cand[p] = nbr[clip(id[p / R], 0, n-1)][p % R]         p < C = ef*R
//   valid[p] = id[p / R] in [0, n) and cand[p] in [0, n) and its visited
//              bit is clear and no q < p has cand[q] == cand[p] (raw ids,
//              valid or not: an invalid first copy kills a valid later one)
//   score[p] = valid ? w_d*dense(q_b, c[cand]) + w_s*sparse(q_b, c[cand]) : NEG
//   beam'    = top ef of [beam, (score, valid ? cand : n)] by (score
//              descending, slot ascending), as lax.top_k orders ties;
//   words[p] = clip(cand[p]) >> 5, addend[p] = valid ? 1 << (clip & 31) : 0.
// The visited mask is read only; the caller commits the deltas.
//
// Design.  The TPU kernel runs one grid step per query block and holds
// the gathered [QB, C, D] block in VMEM.  Here two kernels:
//   1. score: grid (C / kChunk, B).  Each block stages the raw ids
//      cand[0, p1) of its query in shared memory (the first-occurrence
//      test needs every earlier position: 4*C bytes, the budget behind
//      MAX_BEAM_CANDIDATES), tests its kChunk positions against the
//      packed mask, writes words/addend, and scores each valid candidate
//      with one warp: 16-byte loads of the gathered dense row, the sparse
//      part gathered from the query's row of the densified table, warp
//      sums.  Invalid candidates are never read from the corpus.
//   2. merge: one block per query sorts the ef + C (score, slot) pairs,
//      padded to a power of two, bitonically (topk::sort_best_first) in
//      shared memory, or in a global scratch buffer beyond 16384 entries,
//      and writes the top ef.
//
// What bounds it on an H100 SXM (3.35 TB/s): the gathered rows.  Each
// valid candidate reads D*4 dense bytes and NNZ*8 COO bytes once (4 KB at
// 768-d f32 and 128 nnz), plus 4 bytes of adjacency and 4 of mask per
// candidate slot; the merge's sort and the dedup's C*C/2 compares stay in
// shared memory.  On a random degree-16 graph over 8.84M rows (ef 64, 16
// queries) a hop has about 44 valid candidates per query, about 3 MB, a
// bound under 1 us, so latency sets the time: the merge's block-wide
// sort, one block per query, and the two launches (PERF.md has the times
// measured on an H100 80GB HBM3 at 700 W).
//
// Numerics.  IEEE f32 on CUDA cores: no TF32, bf16 converted with
// __bfloat162float before the first multiply; the mix is
// __fadd_rn(__fmul_rn(w_d, dense), __fmul_rn(w_s, sparse)) (rounded
// products, rounded sum, no FMA contraction); l2 is -((q2 + c2) - 2*dot),
// the grouping of spaces.dense_scores.  Warp sums order the additions
// differently from the plain version: scores agree within a tolerance,
// not bitwise.
#include "topk_scan.cuh"

namespace beam {

using topk::kNeg;
using topk::to_f32;

constexpr int kScoreThreads = 256;
constexpr int kWarps = kScoreThreads / 32;
constexpr int kChunk = 64;                     // candidate positions per score block
constexpr int kPerPos = kScoreThreads / kChunk;  // threads sharing one position's dedup scan
constexpr int kMergeThreads = 1024;
constexpr int kMaxCandidates = 32768;          // MAX_BEAM_CANDIDATES in beam_topk.py
constexpr int kMergeSmemEntries = 16384;       // MERGE_SMEM_ENTRIES in beam_topk.py
constexpr int kPadSlot = 0x7fffffff;

struct HopArgs {
  const float* qd;          // [B, V+1] f32 densified queries (zero trash column), or null
  int vp1;
  const float* q_dense;     // [B, D] f32, or null
  int d;
  const float* beam_s;      // [B, ef]
  const int* beam_i;        // [B, ef]
  int b, ef;
  const unsigned* visited;  // [B, W] packed mask
  int w;
  const int* neighbors;     // [N, R]
  int r;
  const int* c_idx;         // [N, NNZ], or null
  const void* c_val;        // [N, NNZ] f32/bf16
  int nnz;
  const void* c_dense;      // [N, D] f32/bf16, or null
  int n;                    // n_valid
  int l2, weighted;
  float w_dense, w_sparse;
  float* cand_s;            // [B, C] scratch
  int* cand_i;
  float* sort_s;            // [B, sort_size] global sort scratch, or null (shared memory)
  int* sort_i;
  int sort_size;
  float* out_s;             // [B, ef]
  int* out_i;
  int* words;               // [B, C]
  unsigned* addend;         // [B, C]
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// dot(q, row) and |row|^2 over d columns, one warp, result in every lane.
template <typename TD>
__device__ __forceinline__ float2 dense_dot(const float* q, const TD* row, int d, bool vec, int lane) {
  float dot = 0.f, c2 = 0.f;
  if (vec) {
    for (int j = 4 * lane; j < d; j += 128) {
      const float4 x = ld4(row + j);
      const float4 qv = ld4(q + j);
      dot = fmaf(qv.x, x.x, dot); dot = fmaf(qv.y, x.y, dot);
      dot = fmaf(qv.z, x.z, dot); dot = fmaf(qv.w, x.w, dot);
      c2 = fmaf(x.x, x.x, c2); c2 = fmaf(x.y, x.y, c2);
      c2 = fmaf(x.z, x.z, c2); c2 = fmaf(x.w, x.w, c2);
    }
  } else {
    for (int j = lane; j < d; j += 32) {
      const float x = to_f32(row[j]);
      dot = fmaf(__ldg(q + j), x, dot);
      c2 = fmaf(x, x, c2);
    }
  }
  return make_float2(warp_sum(dot), warp_sum(c2));
}

template <bool DENSE, bool SPARSE, typename TD, typename TV>
__global__ void __launch_bounds__(kScoreThreads) score_kernel(HopArgs a) {
  extern __shared__ int cand[];            // raw candidate ids [0, p1)
  __shared__ int dup[kChunk];
  __shared__ int valid[kChunk];
  __shared__ float q2_s;
  const int q = blockIdx.y;
  const int c = a.ef * a.r;
  const int p0 = blockIdx.x * kChunk;
  const int p1 = min(c, p0 + kChunk);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int* beam = a.beam_i + size_t(q) * a.ef;
  const float* qrow = DENSE ? a.q_dense + size_t(q) * a.d : nullptr;

  for (int p = tid; p < p1; p += kScoreThreads) {
    const int src = min(max(beam[p / a.r], 0), a.n - 1);
    cand[p] = a.neighbors[size_t(src) * a.r + p % a.r];
  }
  if (tid < kChunk) dup[tid] = 0;
  if (DENSE && a.l2 && warp == 0) {
    float acc = 0.f;
    for (int j = lane; j < a.d; j += 32) acc = fmaf(qrow[j], qrow[j], acc);
    acc = warp_sum(acc);
    if (lane == 0) q2_s = acc;
  }
  __syncthreads();

  // first occurrence wins: any earlier position with the same raw id
  {
    const int i = tid % kChunk, p = p0 + i;
    if (p < p1) {
      const int id = cand[p];
      for (int j = tid / kChunk; j < p; j += kPerPos) {
        if (cand[j] == id) { dup[i] = 1; break; }
      }
    }
  }
  __syncthreads();

  if (tid < p1 - p0) {
    const int p = p0 + tid;
    const int src = beam[p / a.r];
    const int id = cand[p];
    const int safe = min(max(id, 0), a.n - 1);
    const int word = safe >> 5;
    const unsigned bit = 1u << (safe & 31);
    const bool seen = (a.visited[size_t(q) * a.w + word] & bit) != 0u;
    const bool ok = src >= 0 && src < a.n && id >= 0 && id < a.n && !seen && !dup[tid];
    a.words[size_t(q) * c + p] = word;
    a.addend[size_t(q) * c + p] = ok ? bit : 0u;
    valid[tid] = ok;
  }
  __syncthreads();

  const TD* cd = static_cast<const TD*>(a.c_dense);
  const TV* cv = static_cast<const TV*>(a.c_val);
  const float* trow = SPARSE ? a.qd + size_t(q) * a.vp1 : nullptr;
  const bool vec = DENSE && a.d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(a.c_dense) % (4 * sizeof(TD)) == 0 &&
                   reinterpret_cast<uintptr_t>(a.q_dense) % 16 == 0;
  for (int i = warp; i < p1 - p0; i += kWarps) {
    const int p = p0 + i;
    float score = kNeg;
    int out_id = a.n;
    if (valid[i]) {                        // warp-uniform
      const size_t row = size_t(cand[p]);
      float dv = 0.f, sv = 0.f;
      if (DENSE) {
        const float2 r = dense_dot(qrow, cd + row * a.d, a.d, vec, lane);
        dv = a.l2 ? -__fsub_rn(__fadd_rn(q2_s, r.y), __fmul_rn(2.f, r.x)) : r.x;
      }
      if (SPARSE) {
        float acc = 0.f;
        for (int j = lane; j < a.nnz; j += 32) {
          unsigned t = static_cast<unsigned>(__ldg(a.c_idx + row * a.nnz + j));
          if (t > static_cast<unsigned>(a.vp1 - 1)) t = a.vp1 - 1;   // out of range reads the zero column
          acc = fmaf(__ldg(trow + t), to_f32(cv[row * a.nnz + j]), acc);
        }
        sv = warp_sum(acc);
      }
      if (DENSE && SPARSE) {
        score = __fadd_rn(__fmul_rn(a.w_dense, dv), __fmul_rn(a.w_sparse, sv));
      } else if (DENSE) {
        score = a.weighted ? __fmul_rn(a.w_dense, dv) : dv;
      } else {
        score = a.weighted ? __fmul_rn(a.w_sparse, sv) : sv;
      }
      out_id = cand[p];
    }
    if (lane == 0) {
      a.cand_s[size_t(q) * c + p] = score;
      a.cand_i[size_t(q) * c + p] = out_id;
    }
  }
}

// One block per query: top ef of [beam, candidates] by (score desc, slot asc).
__global__ void __launch_bounds__(kMergeThreads) merge_kernel(HopArgs a) {
  extern __shared__ float4 smem4[];
  const int q = blockIdx.x;
  const int c = a.ef * a.r, m = a.ef + c, size = a.sort_size;
  float* s;
  int* slot;
  if (a.sort_s != nullptr) {
    s = a.sort_s + size_t(q) * size;
    slot = a.sort_i + size_t(q) * size;
  } else {
    s = reinterpret_cast<float*>(smem4);
    slot = reinterpret_cast<int*>(s + size);
  }
  for (int p = threadIdx.x; p < size; p += kMergeThreads) {
    float v = -INFINITY;
    int sl = kPadSlot;
    if (p < a.ef) { v = a.beam_s[size_t(q) * a.ef + p]; sl = p; }
    else if (p < m) { v = a.cand_s[size_t(q) * c + p - a.ef]; sl = p; }
    s[p] = v;
    slot[p] = sl;
  }
  __syncthreads();
  topk::sort_best_first(s, slot, size);
  for (int j = threadIdx.x; j < a.ef; j += kMergeThreads) {
    const int sl = slot[j];
    a.out_s[size_t(q) * a.ef + j] = s[j];
    a.out_i[size_t(q) * a.ef + j] = sl < a.ef ? a.beam_i[size_t(q) * a.ef + sl]
                                              : a.cand_i[size_t(q) * c + sl - a.ef];
  }
}

template <bool DENSE, bool SPARSE, typename TD, typename TV>
cudaError_t launch_score(const HopArgs& a, cudaStream_t st) {
  const int c = a.ef * a.r;
  const size_t smem = size_t(c) * 4;
  auto kernel = score_kernel<DENSE, SPARSE, TD, TV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((c + kChunk - 1) / kChunk, a.b);
  kernel<<<grid, kScoreThreads, smem, st>>>(a);
  return cudaGetLastError();
}

cudaError_t run(const HopArgs& a, bool dense_bf16, bool val_bf16, cudaStream_t st) {
  using bf = __nv_bfloat16;
  const bool dense = a.c_dense != nullptr, sparse = a.c_idx != nullptr;
  const long long c = (long long)a.ef * a.r;
  const int size = a.sort_size;
  if (!(dense || sparse) || a.b < 1 || a.b > 65535 || a.ef < 1 || a.r < 1 || c > kMaxCandidates ||
      a.n < 1 || a.w != (a.n + 31) / 32 || size < a.ef + c || (size & (size - 1)) ||
      (a.sort_s == nullptr && size > kMergeSmemEntries) || (dense && (a.q_dense == nullptr || a.d < 1)) ||
      (sparse && (a.qd == nullptr || a.vp1 < 1 || a.nnz < 0)) || (sparse && a.l2) ||
      (dense && sparse && !a.weighted))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (dense && sparse) {
    if (dense_bf16) err = val_bf16 ? launch_score<true, true, bf, bf>(a, st)
                                   : launch_score<true, true, bf, float>(a, st);
    else err = val_bf16 ? launch_score<true, true, float, bf>(a, st)
                        : launch_score<true, true, float, float>(a, st);
  } else if (dense) {
    err = dense_bf16 ? launch_score<true, false, bf, float>(a, st)
                     : launch_score<true, false, float, float>(a, st);
  } else {
    err = val_bf16 ? launch_score<false, true, float, bf>(a, st)
                   : launch_score<false, true, float, float>(a, st);
  }
  if (err != cudaSuccess) return err;
  const size_t smem = a.sort_s == nullptr ? size_t(size) * 8 : 0;
  err = cudaFuncSetAttribute(merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  merge_kernel<<<a.b, kMergeThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace beam

extern "C" {

// One hop; see the comment at the top.  A null c_dense (or c_idx) drops
// that part; weighted = 0 leaves a single part unscaled.  sort_s/sort_i
// are [B, sort_size] global scratch when sort_size > 16384, else null.
// Returns a cudaError_t.
int beam_hop_launch(const float* qd, int vp1, const float* q_dense, int d, const float* beam_s,
                    const int* beam_i, int b, int ef, const int* visited, int w, const int* neighbors,
                    int r, const int* c_idx, const void* c_val, int val_bf16, int nnz,
                    const void* c_dense, int dense_bf16, int n, int l2, int weighted, float w_dense,
                    float w_sparse, float* cand_s, int* cand_i, float* sort_s, int* sort_i,
                    int sort_size, float* out_s, int* out_i, int* words, int* addend, void* stream) {
  beam::HopArgs a{};
  a.qd = qd; a.vp1 = vp1; a.q_dense = q_dense; a.d = d;
  a.beam_s = beam_s; a.beam_i = beam_i; a.b = b; a.ef = ef;
  a.visited = reinterpret_cast<const unsigned*>(visited); a.w = w;
  a.neighbors = neighbors; a.r = r;
  a.c_idx = c_idx; a.c_val = c_val; a.nnz = nnz; a.c_dense = c_dense;
  a.n = n; a.l2 = l2; a.weighted = weighted; a.w_dense = w_dense; a.w_sparse = w_sparse;
  a.cand_s = cand_s; a.cand_i = cand_i;
  a.sort_s = sort_s; a.sort_i = sort_i; a.sort_size = sort_size;
  a.out_s = out_s; a.out_i = out_i; a.words = words;
  a.addend = reinterpret_cast<unsigned*>(addend);
  return int(beam::run(a, dense_bf16 != 0, val_bf16 != 0, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
