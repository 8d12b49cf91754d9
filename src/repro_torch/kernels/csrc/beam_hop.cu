// Graph-ANN hops for sm_90a: beam_hop_launch replaces
// src/repro/kernels/beam_topk.py beam_hop_pallas (with _hop_kernel and the
// -inf-masking _fold_topk) and, run for `hops` hops in one launch, the
// lax.scan of beam_search_pallas over it.
//
// A hop, per query b with beam (s, id)[ef] and adjacency nbr[N, R]:
//   cand[p] = nbr[clip(id[p / R], 0, n-1)][p % R]         p < C = ef*R
//   valid[p] = id[p / R] in [0, n) and cand[p] in [0, n) and its visited
//              bit is clear and no q < p has cand[q] == cand[p] (raw ids,
//              valid or not: an invalid first copy kills a valid later one)
//   score[p] = valid ? w_d*dense(q_b, c[cand]) + w_s*sparse(q_b, c[cand]) : NEG
//   beam'    = top ef of [beam, (score, valid ? cand : n)] by (score
//              descending, slot ascending) in lax.top_k's order of scores
//              (topk_scan.cuh: order_key; +0 above -0, NaN by its bits);
//   words[p] = clip(cand[p]) >> 5, addend[p] = valid ? 1 << (clip & 31) : 0.
// With commit = 0 (one hop, beam_hop) the visited mask is read only and
// the deltas are written out; with commit = 1 (a traversal, beam_search)
// each hop ors its valid candidates' bits into the mask before the next.
//
// Design.  The TPU kernel runs one grid step per query block and holds
// the gathered [QB, C, D] block in VMEM, and the traversal is a scan of
// such launches.  Here one launch runs every hop: one thread-block
// cluster per query (as many blocks as keep B x cluster within the SM
// count, at most 8, halved while the B clusters cannot all be resident at
// once), no grid-wide synchronisation
// (queries never depend on each other).  The query's state lives in the
// leader block's shared memory (or, when it does not fit, in a global
// scratch buffer): the beam (two buffers), the raw candidate ids and
// their flags, a hash set of raw ids, the valid list and the merge's sort
// arrays.  Per hop, between cluster barriers:
//   1. leader: gather the C raw ids, test range and visited bit (the mask
//      as it stood at the hop's start), and insert the ids that pass into
//      a hash set that keeps each id's lowest position (atomicCAS, then
//      atomicMin).  A copy that failed the test can never be valid, so it
//      stays out; a copy from an invalid source slot goes in.
//   2. leader: valid = source slot in range and first occurrence; an
//      ordered compaction (block scan) lists the V valid (position, id);
//      the deltas are written out or committed with atomicOr.
//   3. every block of the cluster: one warp per valid candidate, reading
//      the list through distributed shared memory and writing the score
//      back: 16-byte loads of the gathered dense row, the sparse part
//      gathered from the query's row of the densified table, warp sums.
//   4. leader: the merge ranks the ef beam entries and those of the V
//      valid candidates that score above the beam's worst entry (the
//      others have all ef beam entries before them, whose slots are
//      lower).  The C - V invalid ones are all (NEG, n); they rank among
//      themselves by slot, after every entry ranking above NEG (NaN with
//      the sign bit clear included), so when fewer than ef entries do the first
//      ef - (entries above NEG) of them join as (NEG, slot).  The top ef of
//      these is the top ef of all ef + C entries.  Up to kRankMax entries,
//      each entry's place is the count of entries ahead of it (the order is
//      total: order keys, then slots); beyond, a bitonic sort.
//
// What bounds it on an H100 SXM (3.35 TB/s): the gathered rows.  Each
// valid candidate reads D*4 dense bytes and NNZ*8 COO bytes once (4 KB at
// 768-d f32 and 128 nnz), plus 4 bytes of adjacency and 4 of mask per
// candidate slot.  On a random degree-16 graph over 8.84M rows (ef 64, 16
// queries) a hop has about 44 valid candidates per query on average, most
// of them in the first hop (about 1000), later ones a dozen: a bound of
// about 28 us for 31 hops, so latency sets the time: each hop is a chain
// of dependent loads (beam -> adjacency -> mask -> rows), two cluster
// barriers and the merge.  The launch takes the host out of the hop loop;
// the cluster spreads a query's candidates over 128 warps, each lane
// issuing its row's loads together; the hash set and the filtered merge
// replace an O(C^2) dedup and a 2048-entry sort per query.  Registers are
// capped for one 512-thread block an SM, so that all clusters of a
// served batch are resident at once (PERF.md has the times measured on an
// H100 80GB HBM3 at 700 W).
//
// Numerics.  IEEE f32 on CUDA cores: no TF32, bf16 converted with
// __bfloat162float before the first multiply; the mix is
// __fadd_rn(__fmul_rn(w_d, dense), __fmul_rn(w_s, sparse)) (rounded
// products, rounded sum, no FMA contraction); l2 is -((q2 + c2) - 2*dot),
// the grouping of spaces.dense_scores.  A sparse id outside [0, V] indexes
// the table as repro's qdensified[:, c_idx]: a negative id counts from the
// end once, then ids clamp to [0, V].  Warp sums order the additions
// differently from the plain version: scores agree within a tolerance,
// not bitwise.  A candidate's score does not depend on the warp, block or
// launch that computes it, so a traversal equals its hops launched one by
// one, bit for bit.
#include <cooperative_groups.h>

#include "score_row.cuh"
#include "topk_scan.cuh"

namespace cg = cooperative_groups;

namespace beam {

using rows::score_row;
using rows::warp_sum;
using topk::kNeg;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;                // portable cluster size
constexpr int kMaxCandidates = 32768;         // MAX_BEAM_CANDIDATES in beam_topk.py
constexpr size_t kSmemBudget = 220 * 1024;    // dynamic shared memory a leader may take
constexpr int kEmpty = -1;                    // free hash slot (entered ids are >= 0)
constexpr int kPadSlot = 0x7fffffff;
constexpr int kMaxDevices = 64;
constexpr int kGather = 4;                    // candidate positions a thread gathers at once
constexpr int kBlocksPerSm = 1;               // register budget (128 a thread): one block an SM
constexpr int kRankMax = 1024;                // merges up to this many entries select by rank
constexpr int kRankStep = 8;                  // entries a rank count reads between exit tests

// per-position flags
constexpr unsigned char kSrcOk = 1;   // the beam slot's id lies in [0, n)
constexpr unsigned char kEnter = 2;   // the id lies in [0, n) and was not visited
constexpr unsigned char kValid = 4;

__host__ __device__ inline int log2_ceil(long long x) {
  int k = 0;
  while ((1ll << k) < x) ++k;
  return k;
}
__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Byte offsets of one query's state; the same on host and device.
struct Layout {
  int c, hbits, sbits;
  size_t cand, vid, vpos, vscore, hkey, hpos, beam_s, beam_i, ks, kslot, kkey, flag, bytes;
};

__host__ __device__ inline Layout layout(int ef, int r) {
  Layout L;
  L.c = ef * r;
  L.hbits = log2_ceil(2ll * L.c);          // load factor <= 1/2
  if (L.hbits < 1) L.hbits = 1;
  L.sbits = log2_ceil(ef + L.c);           // the merge sorts at most ef + C entries
  const size_t c4 = size_t(L.c) * 4, h4 = (size_t(1) << L.hbits) * 4, s4 = (size_t(1) << L.sbits) * 4;
  // header: [0] valid count, [1] entries above NEG, [2] the order key of
  // the beam's worst score, [3] candidates entering the merge
  size_t o = 16;
  L.cand = o;   o = align16(o + c4);
  L.vid = o;    o = align16(o + c4);
  L.vpos = o;   o = align16(o + c4);
  L.vscore = o; o = align16(o + c4);
  L.hkey = o;   o = align16(o + h4);
  L.hpos = o;   o = align16(o + h4);
  L.beam_s = o; o = align16(o + size_t(ef) * 8);   // two buffers
  L.beam_i = o; o = align16(o + size_t(ef) * 8);
  L.ks = o;     o = align16(o + s4);
  L.kslot = o;  o = align16(o + s4);
  L.kkey = o;   o = align16(o + 2 * s4);
  L.flag = o;   o = align16(o + size_t(L.c));
  L.bytes = o;
  return L;
}

struct HopArgs {
  const float* qd;          // [B, V+1] f32 densified queries (zero trash column), or null
  int vp1;
  const float* q_dense;     // [B, D] f32, or null
  int d;
  const float* beam_s;      // [B, ef]
  const int* beam_i;        // [B, ef]
  int b, ef;
  unsigned* visited;        // [B, W] packed mask; written only with commit
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
  int hops, commit;
  unsigned char* scratch;   // [B, layout bytes] when the state exceeds kSmemBudget, else null
  float* out_s;             // [B, ef]
  int* out_i;
  int* words;               // [B, C] without commit, else null
  unsigned* addend;
};

// An integer in the merge's order of (score, slot): topk::ahead(order_key(sa),
// la, order_key(sb), lb) iff rank_key(sa, la) > rank_key(sb, lb).
__device__ __forceinline__ unsigned long long rank_key(float s, int slot) {
  return (static_cast<unsigned long long>(topk::order_key(s)) << 32) | static_cast<unsigned>(0x7fffffff - slot);
}

__device__ __forceinline__ unsigned hash_slot(int id, int bits) {
  return (static_cast<unsigned>(id) * 2654435761u) >> (32 - bits);
}

// Insert id at position p: the slot keeps the lowest position of the id.
__device__ __forceinline__ void hash_insert(int* key, int* pos, int bits, int id, int p) {
  const unsigned mask = (1u << bits) - 1u;
  for (unsigned h = hash_slot(id, bits);; h = (h + 1u) & mask) {
    const int k = atomicCAS(key + h, kEmpty, id);
    if (k == kEmpty || k == id) {
      atomicMin(pos + h, p);
      return;
    }
  }
}

// Lowest position of an inserted id.
__device__ __forceinline__ int hash_first(const int* key, const int* pos, int bits, int id) {
  const unsigned mask = (1u << bits) - 1u;
  unsigned h = hash_slot(id, bits);
  while (key[h] != id) h = (h + 1u) & mask;
  return pos[h];
}

// Exclusive block-wide prefix sum of v; `total` receives the sum.
__device__ __forceinline__ int exclusive_scan(int v, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const int s = warp_sums[i];
    before += i < warp ? s : 0;
    total += s;
  }
  return before + x - v;
}

template <bool DENSE, bool SPARSE, typename TD, typename TV>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) hop_kernel(HopArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float q2_s;
  __shared__ int warp_sums[kWarps];
  __shared__ unsigned warp_lo[kWarps];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const bool leader = rank == 0;
  const int q = blockIdx.x / cs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ef = a.ef, r = a.r, n = a.n;
  const Layout L = layout(ef, r);
  const int c = L.c, hsize = 1 << L.hbits;
  // the leader reaches the state directly, the others through the cluster
  unsigned char* base = a.scratch != nullptr ? a.scratch + size_t(q) * L.bytes
                        : leader ? smem : cluster.map_shared_rank(smem, 0);
  int* hdr = reinterpret_cast<int*>(base);
  int* cand = reinterpret_cast<int*>(base + L.cand);
  int* vid = reinterpret_cast<int*>(base + L.vid);
  int* vpos = reinterpret_cast<int*>(base + L.vpos);
  float* vscore = reinterpret_cast<float*>(base + L.vscore);
  int* hkey = reinterpret_cast<int*>(base + L.hkey);
  int* hpos = reinterpret_cast<int*>(base + L.hpos);
  float* bs = reinterpret_cast<float*>(base + L.beam_s);
  int* bi = reinterpret_cast<int*>(base + L.beam_i);
  float* ks = reinterpret_cast<float*>(base + L.ks);
  int* kslot = reinterpret_cast<int*>(base + L.kslot);
  // (order_key(score), -slot) in one integer per entry: the rank count's
  // one compare and one load
  unsigned long long* kkey = reinterpret_cast<unsigned long long*>(base + L.kkey);
  unsigned char* flag = base + L.flag;
  unsigned* mask = a.visited + size_t(q) * a.w;

  if (DENSE && a.l2 && warp == 0) {
    const float* qrow = a.q_dense + size_t(q) * a.d;
    float acc = 0.f;
    for (int j = lane; j < a.d; j += 32) acc = fmaf(qrow[j], qrow[j], acc);
    acc = warp_sum(acc);
    if (lane == 0) q2_s = acc;
  }
  if (leader) {
    for (int j = tid; j < ef; j += kThreads) {
      bs[j] = a.beam_s[size_t(q) * ef + j];
      bi[j] = a.beam_i[size_t(q) * ef + j];
    }
    for (int h = tid; h < hsize; h += kThreads) {
      hkey[h] = kEmpty;
      hpos[h] = kPadSlot;
    }
    // the order key of the entry beam's worst score (the beam need not
    // be sorted)
    unsigned lo = 0xffffffffu;
    for (int j = tid; j < ef; j += kThreads) lo = min(lo, topk::order_key(a.beam_s[size_t(q) * ef + j]));
    lo = __reduce_min_sync(0xffffffffu, lo);
    if (lane == 0) warp_lo[warp] = lo;
    __syncthreads();
    if (tid == 0) {
      for (int i = 1; i < kWarps; ++i) lo = min(lo, warp_lo[i]);
      reinterpret_cast<unsigned*>(hdr)[2] = lo;
    }
  }
  __syncthreads();
  const float q2 = (DENSE && a.l2) ? q2_s : 0.f;
  const bool vec = DENSE && a.d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(a.c_dense) % (4 * sizeof(TD)) == 0 &&
                   reinterpret_cast<uintptr_t>(a.q_dense) % 16 == 0;
  // the leader's thread owns positions [p0, p1) for the ordered compaction
  const int per = (c + kThreads - 1) / kThreads;
  const int p0 = min(c, tid * per), p1 = min(c, p0 + per);

  int cur = 0;
  for (int hop = 0; hop < a.hops; ++hop) {
    float* cur_s = bs + cur * ef;
    int* cur_i = bi + cur * ef;
    int first_valid = 0;   // valid positions before p0
    if (leader) {
      // 1. gather, range and visited tests, hash insert (each thread
      // issues the loads of kGather positions together)
      for (int pg = tid; pg < c; pg += kThreads * kGather) {
        int src[kGather], id[kGather];
        unsigned word[kGather];
#pragma unroll
        for (int u = 0; u < kGather; ++u) {
          const int p = pg + u * kThreads;
          if (p < c) {
            src[u] = cur_i[p / r];
            id[u] = __ldg(a.neighbors + size_t(min(max(src[u], 0), n - 1)) * r + p % r);
          }
        }
#pragma unroll
        for (int u = 0; u < kGather; ++u) {
          const int p = pg + u * kThreads;
          word[u] = p < c && id[u] >= 0 && id[u] < n ? __ldcg(mask + (id[u] >> 5)) : ~0u;
        }
#pragma unroll
        for (int u = 0; u < kGather; ++u) {
          const int p = pg + u * kThreads;
          if (p >= c) continue;
          unsigned char f = (src[u] >= 0 && src[u] < n) ? kSrcOk : 0;
          if (((word[u] >> (id[u] & 31)) & 1u) == 0u) {   // in range (else all ones) and not visited
            f |= kEnter;
            hash_insert(hkey, hpos, L.hbits, id[u], p);
          }
          cand[p] = id[u];
          flag[p] = f;
        }
      }
      __syncthreads();
      // 2. first occurrence, ordered compaction, deltas
      int cnt = 0;
      for (int p = p0; p < p1; ++p) {
        const unsigned char f = flag[p];
        const int id = cand[p];
        const bool ok = (f & kSrcOk) && (f & kEnter) && hash_first(hkey, hpos, L.hbits, id) == p;
        if (ok) {
          flag[p] = f | kValid;
          ++cnt;
        }
        if (!a.commit) {
          const int safe = min(max(id, 0), n - 1);
          a.words[size_t(q) * c + p] = safe >> 5;
          a.addend[size_t(q) * c + p] = ok ? 1u << (safe & 31) : 0u;
        } else if (ok) {
          atomicOr(mask + (id >> 5), 1u << (id & 31));
        }
      }
      int total;
      first_valid = exclusive_scan(cnt, warp_sums, total);
      for (int p = p0, o = first_valid; p < p1; ++p) {
        if (flag[p] & kValid) {
          vid[o] = cand[p];
          vpos[o] = p;
          ++o;
        }
      }
      if (tid == 0) {
        hdr[0] = total;
        hdr[1] = 0;
        hdr[3] = 0;
      }
    }
    cluster.sync();
    // 3. score the valid candidates, one warp each, over the cluster
    {
      const int nv = hdr[0];
      for (int i = rank * kWarps + warp; i < nv; i += cs * kWarps) {
        const float s = score_row<DENSE, SPARSE, TD, TV>(a, q, size_t(vid[i]), q2, vec, lane);
        if (lane == 0) vscore[i] = s;
      }
    }
    cluster.sync();
    if (leader) {
      // 4. merge: the beam, the valid candidates ahead of its worst score
      // (the others have all ef beam entries before them), and as many
      // invalid ones (in slot order) as can reach the top ef
      const int nv = hdr[0];
      const unsigned worst = reinterpret_cast<const unsigned*>(hdr)[2];
      const unsigned neg = topk::order_key(kNeg);
      int above = 0;
      for (int j = tid; j < ef; j += kThreads) {
        ks[j] = cur_s[j];
        kkey[j] = rank_key(cur_s[j], j);
        kslot[j] = j;
        above += topk::order_key(cur_s[j]) > neg;
      }
      for (int i = tid; i < nv; i += kThreads) {
        const float sc = vscore[i];
        above += topk::order_key(sc) > neg;
        if (topk::order_key(sc) > worst) {   // ahead of the worst beam entry, whose slot is lower
          const int k = ef + atomicAdd(hdr + 3, 1);
          ks[k] = sc;
          kkey[k] = rank_key(sc, ef + vpos[i]);
          kslot[k] = ef + vpos[i];
        }
      }
      above = __reduce_add_sync(0xffffffffu, above);
      if (lane == 0 && above) atomicAdd(hdr + 1, above);
      __syncthreads();
      const int m0 = ef + hdr[3];
      const int need = min(max(ef - hdr[1], 0), c - nv);
      if (need > 0) {
        for (int p = p0, before = first_valid; p < p1; ++p) {
          if (flag[p] & kValid) {
            ++before;
          } else if (p - before < need) {   // rank among the invalid positions
            ks[m0 + p - before] = kNeg;
            kkey[m0 + p - before] = rank_key(kNeg, ef + p);
            kslot[m0 + p - before] = ef + p;
          }
        }
      }
      const int m = m0 + need;
      float* nxt_s = bs + (cur ^ 1) * ef;
      int* nxt_i = bi + (cur ^ 1) * ef;
      auto id_of = [&](int sl) {
        return sl < ef ? cur_i[sl] : (flag[sl - ef] & kValid) ? cand[sl - ef] : n;
      };
      if (m <= kRankMax) {
        // an entry's place is the number of entries ahead of it, counted
        // on the entries' rank keys
        __syncthreads();
        for (int e = tid; e < m; e += kThreads) {
          const float se = ks[e];
          const int le = kslot[e];
          const unsigned long long ke = kkey[e];
          int rank = 0;
          for (int f0 = 0; f0 < m && rank < ef; f0 += kRankStep) {   // kRankStep loads in flight
#pragma unroll
            for (int u = 0; u < kRankStep; ++u) {
              if (f0 + u < m) rank += kkey[f0 + u] > ke;
            }
          }
          if (rank < ef) {
            nxt_s[rank] = se;
            nxt_i[rank] = id_of(le);
          }
        }
      } else {
        const int size = 1 << log2_ceil(m);
        for (int j = m + tid; j < size; j += kThreads) {
          ks[j] = topk::lowest();
          kslot[j] = kPadSlot;
        }
        __syncthreads();
        topk::sort_best_first(ks, kslot, size);
        for (int j = tid; j < ef; j += kThreads) {
          nxt_s[j] = ks[j];
          nxt_i[j] = id_of(kslot[j]);
        }
      }
      for (int h = tid; h < hsize; h += kThreads) {
        hkey[h] = kEmpty;
        hpos[h] = kPadSlot;
      }
      __syncthreads();
      if (tid == 0) reinterpret_cast<unsigned*>(hdr)[2] = topk::order_key(nxt_s[ef - 1]);   // in merge order
      cur ^= 1;
    }
  }
  if (leader) {
    for (int j = tid; j < ef; j += kThreads) {
      a.out_s[size_t(q) * ef + j] = bs[cur * ef + j];
      a.out_i[size_t(q) * ef + j] = bi[cur * ef + j];
    }
  }
}

template <bool DENSE, bool SPARSE, typename TD, typename TV>
cudaError_t launch(const HopArgs& a, size_t smem, cudaStream_t st) {
  auto kernel = hop_kernel<DENSE, SPARSE, TD, TV>;
  static bool ready[kMaxDevices] = {};   // the shared-memory attribute, once per device
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmemBudget));
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // blocks per query: as many as keep B x cluster within the SM count, at
  // most the portable 8; then all B clusters resident at once (a cluster
  // runs on one GPC): halve the cluster while they would not be, since
  // later clusters would wait for whole traversals to end
  int cluster = sms / a.b;
  cluster = cluster < 1 ? 1 : cluster > kMaxCluster ? kMaxCluster : cluster;
  for (;; cluster = (cluster + 1) / 2) {
    cfg.gridDim = dim3(unsigned(a.b) * unsigned(cluster));
    attr[0].val.clusterDim.x = unsigned(cluster);
    int fit = 0;
    err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (fit < 1) return cudaErrorLaunchOutOfResources;
    if (cluster == 1 || fit >= a.b) break;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t run(const HopArgs& a, bool dense_bf16, bool val_bf16, cudaStream_t st) {
  using bf = __nv_bfloat16;
  const bool dense = a.c_dense != nullptr, sparse = a.c_idx != nullptr;
  const long long c = (long long)a.ef * a.r;
  if (!(dense || sparse) || a.b < 1 || a.ef < 1 || a.r < 1 || c > kMaxCandidates || a.n < 1 ||
      a.w != (a.n + 31) / 32 || a.hops < 1 || (long long)a.b * kMaxCluster > 0x7fffffffll || (dense && (a.q_dense == nullptr || a.d < 1)) ||
      (sparse && (a.qd == nullptr || a.vp1 < 1 || a.nnz < 0)) || (sparse && a.l2) ||
      (dense && sparse && !a.weighted) || (!a.commit && (a.words == nullptr || a.addend == nullptr)))
    return cudaErrorInvalidValue;
  const size_t bytes = layout(a.ef, a.r).bytes;
  if ((bytes > kSmemBudget) != (a.scratch != nullptr)) return cudaErrorInvalidValue;
  const size_t smem = a.scratch != nullptr ? 0 : bytes;
  if (dense && sparse) {
    if (dense_bf16) return val_bf16 ? launch<true, true, bf, bf>(a, smem, st)
                                    : launch<true, true, bf, float>(a, smem, st);
    return val_bf16 ? launch<true, true, float, bf>(a, smem, st)
                    : launch<true, true, float, float>(a, smem, st);
  }
  if (dense) return dense_bf16 ? launch<true, false, bf, float>(a, smem, st)
                               : launch<true, false, float, float>(a, smem, st);
  return val_bf16 ? launch<false, true, float, bf>(a, smem, st)
                  : launch<false, true, float, float>(a, smem, st);
}

}  // namespace beam

extern "C" {

// Bytes of global scratch per query the launch needs for a beam of ef and
// degree r: 0 when the query's state fits the leader's shared memory.
long long beam_hop_scratch_bytes(int ef, int r) {
  const size_t bytes = beam::layout(ef, r).bytes;
  return bytes > beam::kSmemBudget ? (long long)bytes : 0;
}

// `hops` hops in one launch of B thread-block clusters; see the comment
// at the top.  A null c_dense (or c_idx) drops that part;
// weighted = 0 leaves a single part unscaled.  commit = 0: one hop, the
// mask read only, words/addend [B, ef*r] written; commit = 1: the mask is
// updated in place and words/addend are null.  scratch is [B,
// beam_hop_scratch_bytes(ef, r)] bytes, or null when that is 0.  Returns
// a cudaError_t.
int beam_hop_launch(const float* qd, int vp1, const float* q_dense, int d, const float* beam_s,
                    const int* beam_i, int b, int ef, int* visited, int w, const int* neighbors,
                    int r, const int* c_idx, const void* c_val, int val_bf16, int nnz,
                    const void* c_dense, int dense_bf16, int n, int l2, int weighted, float w_dense,
                    float w_sparse, int hops, int commit, void* scratch, float* out_s,
                    int* out_i, int* words, int* addend, void* stream) {
  beam::HopArgs a{};
  a.qd = qd; a.vp1 = vp1; a.q_dense = q_dense; a.d = d;
  a.beam_s = beam_s; a.beam_i = beam_i; a.b = b; a.ef = ef;
  a.visited = reinterpret_cast<unsigned*>(visited); a.w = w;
  a.neighbors = neighbors; a.r = r;
  a.c_idx = c_idx; a.c_val = c_val; a.nnz = nnz; a.c_dense = c_dense;
  a.n = n; a.l2 = l2; a.weighted = weighted; a.w_dense = w_dense; a.w_sparse = w_sparse;
  a.hops = hops; a.commit = commit;
  a.scratch = static_cast<unsigned char*>(scratch);
  a.out_s = out_s; a.out_i = out_i; a.words = words;
  a.addend = reinterpret_cast<unsigned*>(addend);
  return int(beam::run(a, dense_bf16 != 0, val_bf16 != 0, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
