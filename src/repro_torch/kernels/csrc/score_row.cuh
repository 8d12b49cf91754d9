// One corpus row's score for one query, computed by one warp: the
// per-row arithmetic of the graph hop (beam_hop.cu) and of the large-k
// scan (topk_large.cu), so that both give a row the same score bit for bit.
//
// `A` is an argument struct with the fields
//   const float* qd; int vp1;          [B, V+1] densified queries, zero trash column last
//   const float* q_dense; int d;       [B, D] f32
//   const int* c_idx; const void* c_val; int nnz;   [N, NNZ] padded COO, f32/bf16 values
//   const void* c_dense;               [N, D] f32/bf16
//   int l2, weighted; float w_dense, w_sparse;
//
// Numerics: IEEE f32 on CUDA cores, no TF32, bf16 converted with
// __bfloat162float before the first multiply; each lane sums its columns
// (or COO slots) in order with fmaf, then a butterfly warp sum; l2 is
// -((q2 + c2) - 2*dot); the mix is __fadd_rn(__fmul_rn(w_d, dense),
// __fmul_rn(w_s, sparse)) (rounded products, rounded sum).  A sparse id
// outside [0, V] indexes the table as repro's qdensified[:, c_idx]: a
// negative id counts from the end once, then ids clamp to [0, V].
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "topk_scan.cuh"

namespace rows {

using topk::to_f32;

constexpr int kUnroll = 6;   // loads a lane issues before its multiply-adds (768-d: one pass)

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
// Each lane issues the row loads of kUnroll strides before its
// multiply-adds, which run in column order.
template <typename TD>
__device__ __forceinline__ float2 dense_dot(const float* q, const TD* row, int d, bool vec, int lane) {
  float dot = 0.f, c2 = 0.f;
  if (vec) {
    for (int j0 = 4 * lane; j0 < d; j0 += 128 * kUnroll) {
      float4 x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j0 + 128 * u < d) x[u] = ld4(row + j0 + 128 * u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j0 + 128 * u < d) {
          const float4 qv = ld4(q + j0 + 128 * u);   // the query's row stays in L1
          dot = fmaf(qv.x, x[u].x, dot); dot = fmaf(qv.y, x[u].y, dot);
          dot = fmaf(qv.z, x[u].z, dot); dot = fmaf(qv.w, x[u].w, dot);
          c2 = fmaf(x[u].x, x[u].x, c2); c2 = fmaf(x[u].y, x[u].y, c2);
          c2 = fmaf(x[u].z, x[u].z, c2); c2 = fmaf(x[u].w, x[u].w, c2);
        }
      }
    }
  } else {
    for (int j0 = lane; j0 < d; j0 += 32 * kUnroll) {
      float x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j0 + 32 * u < d) x[u] = to_f32(row[j0 + 32 * u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j0 + 32 * u < d) {
          dot = fmaf(__ldg(q + j0 + 32 * u), x[u], dot);
          c2 = fmaf(x[u], x[u], c2);
        }
      }
    }
  }
  return make_float2(warp_sum(dot), warp_sum(c2));
}

// COO slots j0 + 32u (u < kUnroll, below nnz) of one row: ids and values.
template <typename TV, typename A>
__device__ __forceinline__ void load_slots(const A& a, size_t row, int j0, int* t, float* v) {
  const int* idx = a.c_idx + row * a.nnz;
  const TV* cv = static_cast<const TV*>(a.c_val) + row * a.nnz;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (j0 + 32 * u < a.nnz) {
      t[u] = __ldg(idx + j0 + 32 * u);
      v[u] = to_f32(cv[j0 + 32 * u]);
    }
  }
}

// The score of corpus row `row` for query q, one warp, result in every
// lane.  The first chunk of COO slots is loaded before the dense part, so
// that both parts' loads are in flight together.
template <bool DENSE, bool SPARSE, typename TD, typename TV, typename A>
__device__ __forceinline__ float score_row(const A& a, int q, size_t row, float q2, bool vec, int lane) {
  float dv = 0.f, sv = 0.f;
  int t[kUnroll];
  float v[kUnroll];
  if (SPARSE) load_slots<TV>(a, row, lane, t, v);
  if (DENSE) {
    const float2 r = dense_dot(a.q_dense + size_t(q) * a.d, static_cast<const TD*>(a.c_dense) + row * a.d,
                               a.d, vec, lane);
    dv = a.l2 ? -__fsub_rn(__fadd_rn(q2, r.y), __fmul_rn(2.f, r.x)) : r.x;
  }
  if (SPARSE) {
    const float* trow = a.qd + size_t(q) * a.vp1;
    float acc = 0.f;
    for (int j0 = lane; j0 < a.nnz; j0 += 32 * kUnroll) {
      if (j0 != lane) load_slots<TV>(a, row, j0, t, v);   // the first chunk came before the dense part
      float qt[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j0 + 32 * u < a.nnz) {
          int id = t[u];
          if (id < 0) id += a.vp1;                 // counts from the end once
          qt[u] = __ldg(trow + min(max(id, 0), a.vp1 - 1));
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j0 + 32 * u < a.nnz) acc = fmaf(qt[u], v[u], acc);
      }
    }
    sv = warp_sum(acc);
  }
  if (DENSE && SPARSE) return __fadd_rn(__fmul_rn(a.w_dense, dv), __fmul_rn(a.w_sparse, sv));
  if (DENSE) return a.weighted ? __fmul_rn(a.w_dense, dv) : dv;
  return a.weighted ? __fmul_rn(a.w_sparse, sv) : sv;
}

}  // namespace rows
