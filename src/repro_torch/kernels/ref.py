"""Plain PyTorch versions of the CUDA kernels (counterpart of
``repro/kernels/ref.py``).  The kernel wrappers run them for tensors on
the CPU; the tests and ``chip_smoke.py`` hold the kernels against them.
The hop's plain version is at the end of the file.

They score through the library's own paths (``spaces.dense_scores``,
the ``"bnk,nk->bn"`` gather-reduce of ``core.sparse``,
``spaces.weighted_mix``) and select by a stable sort, so ties break
toward the lower row id.  ``tile_n`` scores the corpus in row tiles and
keeps a running top-k, which bounds the [B, tile, NNZ] gather at full
scale; the result does not depend on it.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.brute_force import order_keys, select_topk
from repro_torch.core.sparse import SparseVectors, accum_f32, densify
from repro_torch.core.spaces import dense_scores, ieee_f32, weighted_mix
from repro_torch.kernels.query_index import index_rows

NEG = float(torch.finfo(torch.float32).min)


def _scan(score_tile, n: int, k: int, n_valid, mask_value: float,
          tile_n: int | None):
    """Top-k over rows [0, n) of ``score_tile(r0, r1) -> [B, r1 - r0]``."""
    n_valid = n if n_valid is None else n_valid
    tile_n = n if not tile_n else tile_n
    best_s = best_i = None
    for r0 in range(0, n, tile_n):
        r1 = min(n, r0 + tile_n)
        s = score_tile(r0, r1)
        rows = torch.arange(r0, r1, device=s.device)
        s = torch.where(rows[None, :] < n_valid, s,
                        torch.full_like(s, mask_value))
        ids = rows.to(torch.int32).expand(s.shape[0], -1)
        if best_s is not None:           # running list first: lower ids
            s = torch.cat([best_s, s], dim=1)
            ids = torch.cat([best_i, ids], dim=1)
        best_s, pos = select_topk(s, k)
        best_i = torch.gather(ids, 1, pos)
    return best_s, best_i


def mips_topk_ref(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                  n_valid: int | None = None, space: str = "ip",
                  tile_n: int | None = None):
    """Exact dense ip / negated-l2 top-k; rows >= n_valid score f32-min."""
    if space not in ("ip", "l2"):
        raise ValueError(f"mips_topk serves ip/l2, not {space!r}")
    return _scan(lambda r0, r1: dense_scores(space, queries, corpus[r0:r1]),
                 corpus.shape[0], k, n_valid, NEG, tile_n)


def _pairs(scores: torch.Tensor, rows: np.ndarray) -> np.ndarray:
    """uint64 (order key << 32 | ~row): the order of ``csrc/mips_topk.cu``'s
    pairs, lax.top_k's (a higher key first, then the lower row)."""
    key = order_keys(scores).numpy().astype(np.int64) + (1 << 31)
    return (key.astype(np.uint64) << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - rows.astype(np.uint64))


def _unpair(pairs: np.ndarray):
    key = (pairs >> np.uint64(32)).astype(np.int64) - (1 << 31)
    bits = key ^ ((key >> 31) & 0x7FFFFFFF)          # order_keys is its own inverse
    scores = torch.from_numpy(bits.astype(np.int32)).view(torch.float32)
    rows = (np.uint64(0xFFFFFFFF) - (pairs & np.uint64(0xFFFFFFFF))).astype(np.int32)
    return scores, torch.from_numpy(rows)


def filter_ref(scores: torch.Tensor, k: int, plan):
    """Plain emulation of the ring route's selection (``csrc/filter.cuh``:
    B1's ``mips_topk.cu`` and B2's ``fused_topk.cu`` share it) over the
    scores ``[B, n_valid]`` of rows ``[0, n_valid)``, under
    ``plan`` (``mips_topk.filter_plan``), step for step: the sample's top
    k, its k-th pair as every block's first threshold, each filter block's
    tiles in its order with its lists sorted to their best k (the threshold
    raised to the k-th) when they hold more than slots - 256 pairs before a
    tile, and the merge of the sample's top k, the lists and the rows past
    n_valid (f32-min).  Returns (scores f32[B, k], ids i32[B, k], stats
    i32[B, 2]: the lists' sorts and the candidates merged)."""
    b, n_valid, tile = scores.shape[0], scores.shape[1], 256
    pairs = _pairs(scores.cpu(), np.arange(n_valid))                   # [B, n_valid]
    tiles = -(-n_valid // tile)
    in_sample = (np.arange(n_valid) // tile) % plan.stride == 0
    sample = np.sort(pairs[:, in_sample], axis=1)[:, ::-1][:, :plan.k_sample]   # best first (stride 1: all)
    th = sample[:, k - 1].copy() if plan.k_sample >= k else np.zeros(b, np.uint64)
    units = [t for t in range(tiles) if t % plan.stride]
    found, sorts = [sample], np.zeros(b, np.int32)
    for x in range(plan.blocks):
        lists = [np.zeros(0, np.uint64) for _ in range(b)]
        block_th = th.copy()
        for u in range(x, len(units), plan.blocks):
            t = units[u]
            got = pairs[:, t * tile:(t + 1) * tile]
            for q in range(b):
                if lists[q].size > plan.slots - tile:
                    lists[q] = np.sort(lists[q])[::-1][:k]
                    block_th[q] = lists[q][k - 1]
                    sorts[q] += 1
                lists[q] = np.concatenate([lists[q], got[q][got[q] >= block_th[q]]])
        width = max(x.size for x in lists)
        found.append(np.stack([np.pad(x, (0, width - x.size)) for x in lists]))   # pads as 0: below every pair
    masked = _pairs(torch.full((b, plan.masked), NEG), n_valid + np.arange(plan.masked))
    cands = np.concatenate(found + [masked], axis=1)
    merged = (cands != 0).sum(axis=1).astype(np.int32)
    best_s, best_i = _unpair(np.ascontiguousarray(np.sort(cands, axis=1)[:, ::-1][:, :k]))
    return best_s, best_i, torch.from_numpy(np.stack([sorts, merged], axis=1))


def mips_filter_ref(queries: torch.Tensor, corpus: torch.Tensor, k: int, plan,
                    n_valid: int | None = None, space: str = "ip"):
    """Plain emulation of B1's ring route (``csrc/mips_topk.cu``) under
    ``plan``: :func:`filter_ref` over the dense scores.  Scores and ids
    equal :func:`mips_topk_ref`'s."""
    return filter_ref(dense_scores(space, queries, corpus[:n_valid]), k, plan)


def fused_table_scores(qdensified, q_dense, c_idx, c_val, c_dense,
                       w_dense=None, w_sparse=None, dense_kind: str = "ip"):
    """Fused scores [B, N] from the kernel's inputs: the densified query
    table [B, V+1] (zero trash column last), COO ids/values, dense parts.
    ``None`` weights leave a single part unscaled.  Out-of-range ids
    index as in repro's ``qdensified[:, c_idx]``: a negative id counts
    from the end, then ids are clamped to [0, V]."""
    parts, weights = [], []
    if c_dense is not None:
        parts.append(dense_scores(dense_kind, q_dense, c_dense))
        weights.append(w_dense)
    if c_idx is not None:
        v1 = qdensified.shape[1]
        lo, hi = (torch.full((1,), x, dtype=torch.long, device=c_idx.device) for x in (-v1, v1 - 1))
        ids = torch.clamp(c_idx, lo, hi)      # int64 in one pass, as .long(); PyTorch wraps -v1 .. -1
        picked = accum_f32(qdensified)[:, ids]                 # [B, N, NNZ]
        parts.append(torch.einsum("bnk,nk->bn", picked, accum_f32(c_val)))
        weights.append(w_sparse)
    if not parts:
        raise ValueError("fused_topk: no components to score")
    if any(w is None for w in weights):
        if len(parts) > 1 or any(w is not None for w in weights):
            raise ValueError("mixing two components requires w_dense and "
                             "w_sparse (pass 1.0 explicitly for an "
                             "unweighted sum)")
        return parts[0]
    return weighted_mix(parts, weights)


def index_sparse_scores(words, table, c_idx, c_val, vocab: int, b: int) -> torch.Tensor:
    """Plain emulation of the fused kernels' sparse arithmetic through the
    query-term index (``kernels/query_index.py``): every COO slot's
    compact row per group (0 on a miss, whose values are zero), the
    group's values gathered from that row, and the slot sum reduced as
    ``fused_table_scores`` reduces it.  f32 [b, N]."""
    g, _, group = table.shape
    rows = index_rows(words, vocab, c_idx)                             # [G, N, NNZ]
    picked = torch.gather(table, 1, rows.reshape(g, -1, 1).expand(-1, -1, group))
    picked = picked.reshape(g, *c_idx.shape, group).permute(0, 3, 1, 2).reshape(g * group, *c_idx.shape)
    return torch.einsum("bnk,nk->bn", picked[:b], accum_f32(c_val))


def fused_score_ref(qdensified, q_dense, c_idx, c_val, c_dense, w_dense: float,
                    w_sparse: float, tile_n: int | None = None) -> torch.Tensor:
    """Plain version of the fused score kernel (``fused_score_pallas``) on
    its own inputs: scores [B, N] with both weights applied.  ``tile_n``
    scores the corpus in row blocks, which bounds the [B, tile, NNZ]
    gather at full scale; it changes the result only by summation order."""
    if not tile_n:
        return fused_table_scores(qdensified, q_dense, c_idx, c_val, c_dense, w_dense, w_sparse)
    return torch.cat([fused_table_scores(qdensified, q_dense, c_idx[r0:r0 + tile_n],
                                         c_val[r0:r0 + tile_n], c_dense[r0:r0 + tile_n],
                                         w_dense, w_sparse)
                      for r0 in range(0, c_dense.shape[0], tile_n)], dim=1)


def fused_topk_table_ref(qdensified, q_dense, c_idx, c_val, c_dense, k: int,
                         w_dense=None, w_sparse=None, dense_kind: str = "ip",
                         n_valid: int | None = None,
                         tile_n: int | None = None):
    """Plain version of the fused kernel on the kernel's own inputs."""
    n = (c_dense if c_dense is not None else c_idx).shape[0]

    def score_tile(r0, r1):
        return fused_table_scores(
            qdensified, q_dense,
            None if c_idx is None else c_idx[r0:r1],
            None if c_val is None else c_val[r0:r1],
            None if c_dense is None else c_dense[r0:r1],
            w_dense, w_sparse, dense_kind)

    return _scan(score_tile, n, k, n_valid, -torch.inf, tile_n)


def fused_filter_ref(qdensified, q_dense, c_idx, c_val, c_dense, k: int, plan,
                     w_dense=None, w_sparse=None, dense_kind: str = "ip",
                     n_valid: int | None = None):
    """Plain emulation of B2's ring route (``csrc/fused_topk.cu``) under
    ``plan``: :func:`filter_ref` over :func:`fused_table_scores`.  Rows past
    ``n_valid`` rank as f32-min, as on the card (the plain version
    :func:`fused_topk_table_ref` masks with -inf)."""
    cut = lambda x: None if x is None else x[:n_valid]
    scores = fused_table_scores(qdensified, q_dense, cut(c_idx), cut(c_val), cut(c_dense),
                                w_dense, w_sparse, dense_kind)
    return filter_ref(scores, k, plan)


def query_table(q_sparse: SparseVectors, vocab_size: int) -> torch.Tensor:
    """Densified queries [B, V+1] with the zero trash column, built as the
    library path builds it (densify in the storage dtype, then upcast)."""
    return torch.nn.functional.pad(accum_f32(densify(q_sparse, vocab_size)),
                                   (0, 1))


def fused_topk_ref(q_sparse, q_dense, c_sparse, c_dense, vocab_size: int,
                   k: int, w_dense=None, w_sparse=None,
                   dense_kind: str = "ip", n_valid: int | None = None,
                   tile_n: int | None = None):
    """Oracle for the fused kernel at the ``SparseVectors`` level; ``None``
    components are skipped."""
    has_sparse = q_sparse is not None and c_sparse is not None
    has_dense = q_dense is not None and c_dense is not None
    return fused_topk_table_ref(
        query_table(q_sparse, vocab_size) if has_sparse else None,
        q_dense if has_dense else None,
        c_sparse.indices if has_sparse else None,
        c_sparse.values if has_sparse else None,
        c_dense if has_dense else None,
        k, w_dense=w_dense if has_dense else None,
        w_sparse=w_sparse if has_sparse else None,
        dense_kind=dense_kind, n_valid=n_valid, tile_n=tile_n)


def _hop_candidates(beam_i, neighbors, n: int):
    """The hop's raw candidate list [B, C] (the neighbours of every beam
    slot, sentinel slots reading row ``clip(id, 0, n-1)``), whether each
    may be valid at all, and the clipped ids."""
    b, ef = beam_i.shape
    r = neighbors.shape[1]
    src_ok = (beam_i >= 0) & (beam_i < n)
    cand = neighbors[beam_i.clamp(0, n - 1).long()].reshape(b, ef * r)
    cand_ok = src_ok.repeat_interleave(r, dim=1) & (cand >= 0) & (cand < n)
    return cand, cand_ok, cand.clamp(0, n - 1).long()


def _earlier_duplicate(cand: torch.Tensor) -> torch.Tensor:
    """dup[b, i]: some j < i holds the same raw id.  A C x C strictly
    lower-triangular equality, one query row at a time."""
    c = cand.shape[1]
    earlier = torch.ones((c, c), dtype=torch.bool, device=cand.device).tril(-1)
    return torch.stack([((row[:, None] == row[None, :]) & earlier).any(1)
                        for row in cand])


def _hop(qdensified, q_dense, beam_s, beam_i, seen_of, neighbors, c_idx,
         c_val, c_dense, n: int, w_dense, w_sparse, dense_kind: str):
    """One hop given ``seen_of(safe_c) -> bool[B, C]``; returns the merged
    beam, the clipped candidate ids and the valid mask."""
    cand, cand_ok, safe_c = _hop_candidates(beam_i, neighbors, n)
    valid = cand_ok & ~seen_of(safe_c) & ~_earlier_duplicate(cand)
    parts = []
    if c_dense is not None:
        ieee_f32()
        q = accum_f32(q_dense)
        items = accum_f32(c_dense[safe_c])                      # [B, C, Dd]
        dense = torch.einsum("qd,qcd->qc", q, items)
        if dense_kind == "l2":
            q2 = torch.einsum("qd,qd->q", q, q)[:, None]
            c2 = torch.einsum("qcd,qcd->qc", items, items)
            dense = -(q2 + c2 - 2.0 * dense)
        parts.append(dense)
    if c_idx is not None:
        # out-of-range ids index as repro's qrow[irow]: a negative id
        # counts from the end once, then ids clamp to [0, V]
        v1 = qdensified.shape[1]
        lo, hi = (torch.full((1,), x, dtype=torch.long, device=c_idx.device) for x in (-v1, v1 - 1))
        idx = torch.clamp(c_idx[safe_c], lo, hi)                # int64 [B, C, NNZ]
        rows = torch.arange(idx.shape[0], device=idx.device)[:, None, None]
        picked = accum_f32(qdensified)[rows, idx]               # PyTorch wraps -v1 .. -1
        parts.append(torch.einsum("qck,qck->qc", picked,
                                  accum_f32(c_val[safe_c])))
    weights = ([w_dense] if c_dense is not None else []) + \
              ([w_sparse] if c_idx is not None else [])
    total = (weighted_mix(parts, weights)
             if any(w is not None for w in weights) else parts[0])
    s = torch.where(valid, total, torch.full_like(total, NEG))
    ids = torch.where(valid, cand, torch.full_like(cand, n))
    new_s, pos = select_topk(torch.cat([beam_s, s], dim=1), beam_s.shape[1])
    new_i = torch.gather(torch.cat([beam_i, ids], dim=1), 1, pos)
    return new_s, new_i.to(torch.int32), safe_c, valid


def beam_hop_ref(qdensified, q_dense, beam_s, beam_i, visited, neighbors,
                 c_idx, c_val, c_dense, *, n_valid: int, w_dense=None,
                 w_sparse=None, dense_kind: str = "ip"):
    """Oracle for one hop with machinery independent of the kernel: the
    visited set is an unpacked ``bool[B, N]`` table, the in-hop dedup a
    C x C strictly lower-triangular equality over the raw candidate list
    (an earlier copy of the same id, valid or not, kills a candidate),
    the merge a stable descending sort of ``[beam, candidates]`` (ties
    toward the lower slot, as ``lax.top_k``).  Scores use the library's
    groupings and ``weighted_mix``.  Returns ``(beam_s, beam_i,
    visited)`` with the new table (only scored candidates marked)."""
    new_s, new_i, safe_c, valid = _hop(
        qdensified, q_dense, beam_s, beam_i,
        lambda ids: torch.gather(visited, 1, ids), neighbors, c_idx, c_val,
        c_dense, n_valid, w_dense, w_sparse, dense_kind)
    marks = torch.zeros(visited.shape, dtype=torch.int32, device=visited.device)
    marks.scatter_add_(1, safe_c, valid.to(torch.int32))
    return new_s, new_i, visited | (marks > 0)


def beam_hop_plain(qdensified, q_dense, beam_s, beam_i, visited, neighbors,
                   c_idx, c_val, c_dense, *, n_valid: int, w_dense=None,
                   w_sparse=None, dense_kind: str = "ip"):
    """Plain version of the hop kernel on its own inputs and outputs: the
    packed int32 mask in, ``(beam_s, beam_i, words, addend)`` out, through
    :func:`beam_hop_ref`'s machinery."""
    from repro_torch.kernels.beam_topk import bit_i32, unpack_visited

    table = unpack_visited(visited, n_valid)
    new_s, new_i, safe_c, valid = _hop(
        qdensified, q_dense, beam_s, beam_i,
        lambda ids: torch.gather(table, 1, ids), neighbors, c_idx, c_val,
        c_dense, n_valid, w_dense, w_sparse, dense_kind)
    bit = bit_i32(safe_c & 31)
    addend = torch.where(valid, bit, torch.zeros_like(bit))
    return new_s, new_i, (safe_c >> 5).to(torch.int32), addend
