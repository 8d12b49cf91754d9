"""Proximity-graph k-NN search and NN-descent (counterpart of
``repro/core/graph_ann.py``).

A fixed-degree flat graph ``neighbors: i32[N, R]``, built by NN-descent
(the KGraph algorithm the paper cites) or imported through
:func:`flat_adjacency`; a coarse entry set of about sqrt(N) rows scored
exactly; a beam of ``ef`` merged with each hop's candidates; a fixed hop
count.  Scoring goes through the space, so the fused dense+sparse space
runs inside graph search, as in the paper.

Two traversals serve the same contract (recall@k against the exact
oracle):

  * :func:`beam_search`, the plain one: a ``bool[B, N]`` visited table,
    and every candidate of a hop is marked visited, scored or not;
  * :func:`kernel_beam_search`: entry set through the exact-scan kernels,
    hops through the beam-hop kernel (``kernels/beam_topk.py``) over a
    packed mask, where only scored candidates are marked.

Index semantics follow JAX's gathers, which the reference relies on: an
id past the last row reads the last row (a sentinel ``n`` pad of
:func:`flat_adjacency` scores as row ``n - 1`` in the plain traversal)
and marks nothing.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import spaces as spaces_lib
from repro_torch.core.brute_force import TopK, merge_topk, select_topk
from repro_torch.core.sparse import SparseVectors, accum_f32
from repro_torch.core.spaces import map_tensors, tensor_leaves

__all__ = [
    "GraphIndex",
    "gather_items",
    "score_many",
    "nn_descent",
    "nn_descent_round",
    "flat_adjacency",
    "default_hops",
    "beam_search",
    "beam_search_early_exit",
    "kernel_beam_search",
]

NEG = float(torch.finfo(torch.float32).min)
# Device memory one NN-descent node block may take for its gathered
# candidate rows and scores; blocks are sized from it (``_node_block``).
NODE_BLOCK_BYTES = 1 << 31


class GraphIndex(NamedTuple):
    neighbors: torch.Tensor   # i32[N, R]
    entry_ids: torch.Tensor   # i32[E] coarse entry-point sample


def _clip(ids: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's gather index rule: negative ids wrap once, then clamp to
    [0, n-1]."""
    ids = ids.long()
    return torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)


def _rows(x) -> int:
    """Leading size of a tensor, ``SparseVectors`` or ``FusedVectors``."""
    return int(tensor_leaves(x)[0].shape[0])


# ---------------------------------------------------------------------------
# Item gather / one-vs-many scoring for dense, sparse and fused data.
# ---------------------------------------------------------------------------

def gather_items(corpus, ids: torch.Tensor):
    """Corpus rows at ``ids`` (any leading shape) for a dense [N, D]
    tensor, ``SparseVectors`` or ``FusedVectors``; ids are clipped to the
    rows as JAX's gathers clip them."""
    safe = _clip(ids, _rows(corpus))
    return map_tensors(lambda leaf: leaf[safe], corpus)


def score_many(space, queries, items) -> torch.Tensor:
    """Scores [B, C] of query b against items[b, c].  Values are upcast to
    f32 before the first multiply (the precision contract), and a fused
    score is rounded products plus a rounded sum."""
    if isinstance(space, spaces_lib.DenseSpace):
        spaces_lib.ieee_f32()
        q, x = accum_f32(queries), accum_f32(items)
        if space.kind == "ip":
            return torch.einsum("bd,bcd->bc", q, x)
        if space.kind == "cosine":
            qn = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
            xn = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12)
            return torch.einsum("bd,bcd->bc", qn, xn)
        if space.kind == "l2":
            d = q[:, None, :] - x
            return -torch.sum(d * d, dim=-1)
        if space.kind == "lp":
            diff = torch.abs(q[:, None, :] - x) ** space.p
            return -torch.sum(diff, dim=-1) ** (1.0 / space.p)
        raise ValueError(f"unknown dense space kind: {space.kind}")
    if isinstance(space, spaces_lib.SparseSpace):
        from repro_torch.kernels.ref import query_table

        qd = query_table(queries, space.vocab_size)            # [B, V+1]
        b = qd.shape[0]
        idx = _clip(items.indices, space.vocab_size + 1)       # as repro's qrow[it_idx]
        picked = torch.gather(qd, 1, idx.reshape(b, -1)).reshape(idx.shape)
        return torch.sum(picked * accum_f32(items.values), dim=-1)
    if isinstance(space, spaces_lib.FusedSpace):
        total = None
        if queries.dense is not None and items.dense is not None:
            total = space.w_dense * score_many(
                spaces_lib.DenseSpace(space.dense_kind), queries.dense, items.dense)
        if queries.sparse is not None and items.sparse is not None:
            s = space.w_sparse * score_many(
                spaces_lib.SparseSpace(space.vocab_size), queries.sparse, items.sparse)
            total = s if total is None else total + s
        if total is None:
            raise ValueError("FusedSpace: no overlapping components to score")
        return total
    raise TypeError(f"unsupported space {type(space)}")


# ---------------------------------------------------------------------------
# Graph construction: NN-descent (KGraph), in node blocks.
# ---------------------------------------------------------------------------

def _item_bytes(corpus) -> int:
    """Bytes one gathered candidate costs while it is scored: its leaves
    as stored plus their f32 copies."""
    return sum(int(np.prod(t.shape[1:], dtype=np.int64)) * (t.element_size() + 4)
               for t in tensor_leaves(corpus))


def _node_block(space, corpus, n: int, n_cand: int) -> int:
    """Nodes per block such that the block's gathered candidates (and the
    densified query rows of a sparse space) stay within
    ``NODE_BLOCK_BYTES``."""
    per_node = n_cand * (_item_bytes(corpus) + 8)
    vocab = getattr(space, "vocab_size", None)
    if vocab is not None:
        per_node += 2 * 4 * (vocab + 1)
    return max(1, min(n, NODE_BLOCK_BYTES // per_node))


def nn_descent_round(space, corpus, neighbors: torch.Tensor,
                     rand_cand: torch.Tensor,
                     node_block: int | None = None) -> torch.Tensor:
    """One refinement round: each node's pool is its neighbours, their
    neighbours and ``rand_cand``'s ids; the pool is deduplicated, the node
    itself dropped, and the best ``R`` by score kept (ties toward the
    lower id).  Reads only the previous ``neighbors``, so the result does
    not depend on ``node_block``; a ragged last block is fine."""
    n, r = neighbors.shape
    pool = r + r * r + rand_cand.shape[1]
    block = node_block or _node_block(space, corpus, n, pool)
    out = torch.empty_like(neighbors)
    for s in range(0, n, block):
        e = min(n, s + block)
        ids = torch.arange(s, e, device=neighbors.device, dtype=neighbors.dtype)
        nbrs = neighbors[s:e]
        two_hop = neighbors[nbrs.long()].reshape(e - s, r * r)
        cand, _ = torch.cat([nbrs, two_hop, rand_cand[s:e]], dim=1).sort(dim=1)
        dead = torch.zeros_like(cand, dtype=torch.bool)
        dead[:, 1:] = cand[:, 1:] == cand[:, :-1]
        dead |= cand == ids[:, None]
        scores = score_many(space, gather_items(corpus, ids),
                            gather_items(corpus, cand))
        scores = torch.where(dead, torch.full_like(scores, -torch.inf), scores)
        _, pos = select_topk(scores, r)
        out[s:e] = torch.gather(cand, 1, pos)
    return out


def entry_sample(n: int, entry_count: int | None = None) -> torch.Tensor:
    """The coarse entry set: ``e = min(n, entry_count or max(16,
    sqrt(n)))`` ids evenly spread over [0, n), the ids the reference's
    f32 ``linspace`` gives once XLA has folded it to ``i * ((n-1) *
    (1/(e-1)))``, truncated."""
    e = min(n, entry_count or max(16, int(n ** 0.5)))
    if e == 1:
        return torch.zeros(1, dtype=torch.int32)
    f32 = torch.float32
    scale = torch.tensor(n - 1, dtype=f32) * (torch.tensor(1.0, dtype=f32) /
                                              torch.tensor(e - 1, dtype=f32))
    out = torch.arange(e - 1, dtype=f32) * scale
    return torch.cat([out.to(torch.int32), torch.tensor([n - 1], dtype=torch.int32)])


def nn_descent(space, corpus, n_items: int, degree: int = 16, rounds: int = 6,
               generator: torch.Generator | None = None,
               entry_count: int | None = None) -> GraphIndex:
    """Build a fixed-degree k-NN graph by neighbour-of-neighbour
    refinement from a random graph, ``rounds`` times (``rounds=0`` leaves
    the random graph).  Draws come from ``generator`` (seeded with 0 on
    the corpus's device when None): ``degree`` random ids per node for
    the start, then ``max(4, degree // 4)`` random candidates per node
    and round.  Node blocks are sized by memory (``NODE_BLOCK_BYTES``)."""
    dev = tensor_leaves(corpus)[0].device
    g = generator if generator is not None else torch.Generator(dev).manual_seed(0)
    n, r = n_items, degree
    neighbors = torch.randint(0, n, (n, r), generator=g, device=dev,
                              dtype=torch.int32)
    n_rand = max(4, r // 4)
    for _ in range(rounds):
        rand_cand = torch.randint(0, n, (n, n_rand), generator=g, device=dev,
                                  dtype=torch.int32)
        neighbors = nn_descent_round(space, corpus, neighbors, rand_cand)
    return GraphIndex(neighbors, entry_sample(n, entry_count).to(dev))


def flat_adjacency(neighbor_lists, n_items: int, degree: int,
                   sentinel: int | None = None, device=None) -> torch.Tensor:
    """Ragged adjacency -> the flat ``i32[N, R]`` layout both traversals
    walk: row ``i`` holds ``neighbor_lists[i]`` cut to ``degree`` and
    padded with ``sentinel`` (default ``n_items``, the id every traversal
    masks)."""
    from repro_torch.device import resolve_device

    if len(neighbor_lists) != n_items:
        raise ValueError(
            f"flat_adjacency: {len(neighbor_lists)} rows for {n_items} items")
    pad = n_items if sentinel is None else sentinel
    out = np.full((n_items, degree), pad, dtype=np.int32)
    for i, row in enumerate(neighbor_lists):
        row = list(row)[:degree]
        out[i, :len(row)] = row
    return torch.from_numpy(out).to(resolve_device(device))


# ---------------------------------------------------------------------------
# Plain batched beam search (the NSW/HNSW query algorithm, vectorised).
# ---------------------------------------------------------------------------

def default_hops(n_items: int) -> int:
    """Default fixed hop count ``max(4, int(2 ln N))``, HNSW's expected
    search path length."""
    return max(4, int(2 * math.log(max(n_items, 1))))


class _BeamState(NamedTuple):
    beam: TopK               # [B, ef]
    visited: torch.Tensor    # bool[B, N]
    frontier: torch.Tensor   # i32[B, F] ids expanded next hop


def _mark(visited: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``visited`` with ``ids`` in [0, N) set; other ids mark nothing."""
    b, n = visited.shape
    ids = ids.long()
    idx = torch.where((ids >= 0) & (ids < n), ids, torch.full_like(ids, n))
    marks = torch.zeros((b, n + 1), dtype=torch.bool, device=visited.device)
    marks.scatter_(1, idx, True)
    return visited | marks[:, :n]


def _init_beam(space, queries, corpus, index: GraphIndex, ef: int, batch: int,
               n: int) -> _BeamState:
    entries = gather_items(corpus, index.entry_ids)
    s = space.score_batch(queries, entries)                   # [B, E]
    k0 = min(ef, index.entry_ids.shape[0])
    vals, pos = select_topk(s, k0)
    ids = index.entry_ids[pos]
    if k0 < ef:
        # empty slots hold the out-of-range sentinel n, never a real row
        vals = torch.nn.functional.pad(vals, (0, ef - k0), value=-torch.inf)
        ids = torch.nn.functional.pad(ids, (0, ef - k0), value=n)
    visited = _mark(torch.zeros((batch, n), dtype=torch.bool, device=ids.device), ids)
    return _BeamState(TopK(vals, ids), visited, ids)


def _hop(space, queries, corpus, neighbors, state: _BeamState,
         ef: int) -> _BeamState:
    b = state.frontier.shape[0]
    n = state.visited.shape[1]
    # sentinel frontier slots read the last row's neighbours
    frontier = torch.clamp(state.frontier.long(), max=neighbors.shape[0] - 1)
    cand = neighbors[frontier].reshape(b, -1)                 # [B, F*R]
    seen = torch.gather(state.visited, 1, _clip(cand, n))
    cand_sorted, order = torch.sort(cand, dim=1, stable=True)
    dead = torch.gather(seen, 1, order)
    dead[:, 1:] |= cand_sorted[:, 1:] == cand_sorted[:, :-1]
    scores = score_many(space, queries, gather_items(corpus, cand_sorted))
    s = torch.where(dead, torch.full_like(scores, -torch.inf), scores)
    visited = _mark(state.visited, cand_sorted)
    new_beam = merge_topk(TopK(torch.cat([state.beam.scores, s], dim=1),
                               torch.cat([state.beam.indices, cand_sorted], dim=1)), ef)
    # expand the whole new beam next hop: already-expanded nodes only
    # bring visited neighbours, masked then
    return _BeamState(new_beam, visited, new_beam.indices)


def beam_search(space, queries, corpus, index: GraphIndex, n_items: int,
                k: int = 10, ef: int = 64, hops: int | None = None) -> TopK:
    """Fixed-hop batched beam search; the global top-k."""
    hops = hops if hops is not None else default_hops(n_items)
    state = _init_beam(space, queries, corpus, index, ef, _rows(queries), n_items)
    for _ in range(int(hops)):
        state = _hop(space, queries, corpus, index.neighbors, state, ef)
    return merge_topk(state.beam, k)


def beam_search_early_exit(space, queries, corpus, index: GraphIndex,
                           n_items: int, k: int = 10, ef: int = 64,
                           max_hops: int = 32) -> TopK:
    """Serving variant: stops when the beam's ids stop changing (the NSW
    termination rule), after at most ``max_hops`` hops."""
    state = _init_beam(space, queries, corpus, index, ef, _rows(queries), n_items)
    prev = torch.full_like(state.beam.indices, -1)
    it = 0
    while it < max_hops and bool((state.beam.indices != prev).any()):
        prev = state.beam.indices
        state = _hop(space, queries, corpus, index.neighbors, state, ef)
        it += 1
    return merge_topk(state.beam, k)


# ---------------------------------------------------------------------------
# Kernel beam search: the beam-hop kernel behind the same interface.
# ---------------------------------------------------------------------------

def _components(space, queries, corpus):
    """(qdensified, q_dense, c_idx, c_val, c_dense, w_dense, w_sparse,
    dense_kind, vocab) for the kernel call, under the fused kernel's
    conventions: only components present on both sides score, absent
    ones carry no weight, a lone SparseSpace part stays unscaled."""
    from repro_torch.kernels.ref import query_table

    if isinstance(space, spaces_lib.DenseSpace):
        return (None, queries, None, None, corpus, None, None, space.kind, None)
    if isinstance(space, spaces_lib.SparseSpace):
        return (query_table(queries, space.vocab_size), None, corpus.indices,
                corpus.values, None, None, None, "ip", space.vocab_size)
    if isinstance(space, spaces_lib.FusedSpace):
        has_dense = queries.dense is not None and corpus.dense is not None
        has_sparse = queries.sparse is not None and corpus.sparse is not None
        qd = c_idx = c_val = None
        if has_sparse:
            qd = query_table(queries.sparse, space.vocab_size)
            c_idx, c_val = corpus.sparse.indices, corpus.sparse.values
        return (qd, queries.dense if has_dense else None, c_idx, c_val,
                corpus.dense if has_dense else None,
                space.w_dense if has_dense else None,
                space.w_sparse if has_sparse else None,
                space.dense_kind, space.vocab_size)
    raise TypeError(f"unsupported space {type(space)}")


def kernel_beam_search(space, queries, corpus, index: GraphIndex,
                       n_items: int, k: int = 10, ef: int = 64,
                       hops: int | None = None) -> TopK:
    """``beam_search`` through the kernels: the entry set is scored by
    ``ops.mips_topk``/``ops.fused_topk`` over the gathered entry rows,
    the hops by ``ops.beam_topk``.  Same contract (global top-k under the
    ANN recall tier), with the degenerate tail when the beam cannot fill
    ``k`` reachable rows.  Serves dense ip/l2, sparse ip and fused spaces
    with ``dense_kind='ip'``; ``GraphANNBackend(kernel=True)`` routes
    everything else to the reference backend."""
    from repro_torch.kernels import ops

    (qd, q_dense, c_idx, c_val, c_dense, w_dense, w_sparse, dense_kind,
     vocab) = _components(space, queries, corpus)
    hops = hops if hops is not None else default_hops(n_items)

    e = int(index.entry_ids.shape[0])
    entries = gather_items(corpus, index.entry_ids)
    k0 = min(ef, e)
    if isinstance(space, spaces_lib.DenseSpace):
        tk = ops.mips_topk(queries, entries, k0, space=space.kind, n_valid=e)
    else:
        sparse_space = isinstance(space, spaces_lib.SparseSpace)
        q_sparse = queries if sparse_space else queries.sparse if qd is not None else None
        e_sparse = entries if sparse_space else entries.sparse if c_idx is not None else None
        e_dense = None if sparse_space or c_dense is None else entries.dense
        tk = ops.fused_topk(q_sparse, q_dense, e_sparse, e_dense, vocab, k0,
                            w_dense=w_dense, w_sparse=w_sparse,
                            dense_kind=dense_kind, n_valid=e)
    init_s = tk.scores
    init_ids = index.entry_ids[tk.indices.long()]
    if k0 < ef:
        init_s = torch.nn.functional.pad(init_s, (0, ef - k0), value=NEG)
        init_ids = torch.nn.functional.pad(init_ids, (0, ef - k0), value=n_items)
    return ops.beam_topk(qd, q_dense, init_s, init_ids.to(torch.int32),
                         index.neighbors, c_idx, c_val, c_dense, k, int(hops),
                         int(n_items), w_dense=w_dense, w_sparse=w_sparse,
                         dense_kind=dense_kind)
