"""NAPP, the Neighborhood APProximation index (counterpart of
``repro/core/napp.py``; Tellez et al. 2013, Boytsov et al. 2016).

Each item is indexed by its ``num_index`` best-scoring *pivots*, a random
sample of corpus rows; the index is a {0, 1} membership matrix f32
``[N, P]``.  A query takes its ``num_search`` best pivots, counts for
every item the pivots they share (one matrix product of the query's
membership with the corpus's), keeps the ``rerank_qty`` items with the
highest counts (counts below ``min_times`` demoted) and re-ranks them with
the true score.

Pivot scoring (the build's ``[P, N]`` and the probe's ``[B, P]``) runs
through the fused score kernel (``ops.fused_scores``) wherever that
kernel computes the space's own function (:func:`fused_kernel_serves`);
every other space scores through ``space.score_batch``, as the reference
does.  The build scores the corpus in row blocks of ``block_rows``, which
bounds the score matrix and the selection's temporaries next to a
resident corpus.

Every selection breaks ties toward the lower index, as ``lax.top_k``
does: a stable sort for the pivot choices and the re-rank, and for the
counts, where ties are the rule (almost a whole cluster can share every
probed pivot), a unique int64 key ``(count + 1) * N + (N - 1 - id)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.brute_force import TopK, select_topk
from repro_torch.core.graph_ann import gather_items, score_many
from repro_torch.core.spaces import (FusedSpace, FusedVectors, ieee_f32,
                                     map_tensors, tensor_leaves)

__all__ = ["NappIndex", "NAPP_BLOCK_ROWS", "draw_pivots", "fused_kernel_serves",
           "pivot_scores", "napp_membership", "build_napp", "napp_search"]

# Corpus rows the build scores at a time: the [P, rows] scores and the
# sort's temporaries stay near 2 GB at P = 128.
NAPP_BLOCK_ROWS = 1 << 20

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


class NappIndex(NamedTuple):
    pivot_ids: torch.Tensor    # i32[P] corpus rows used as pivots
    membership: torch.Tensor   # f32[N, P] one-hot top-num_index pivots per item
    num_index: int


def draw_pivots(n_items: int, num_pivots: int,
                generator: torch.Generator) -> torch.Tensor:
    """``num_pivots`` distinct row ids of [0, n_items), i32, drawn on the
    generator's device.  ``jax.random.choice`` cannot be reproduced, so
    the tests hand ``repro``'s pivot ids to :func:`napp_membership`."""
    perm = torch.randperm(n_items, generator=generator, device=generator.device)
    return perm[:num_pivots].to(torch.int32)


def fused_kernel_serves(space, queries, items) -> bool:
    """Whether ``ops.fused_scores`` computes ``space.score_batch(queries,
    items)``: a ``FusedSpace`` with ``dense_kind='ip'``, both components
    present on both sides, floating parts in f32 or bf16."""
    if not (isinstance(space, FusedSpace) and space.dense_kind == "ip"
            and isinstance(queries, FusedVectors) and isinstance(items, FusedVectors)):
        return False
    parts = (queries.dense, queries.sparse, items.dense, items.sparse)
    if any(p is None for p in parts):
        return False
    return all(t.dtype in _KERNEL_DTYPES for t in tensor_leaves(queries) + tensor_leaves(items)
               if t.is_floating_point())


def pivot_scores(space, queries, items) -> torch.Tensor:
    """``space.score_batch(queries, items)`` [B, M], through the fused
    score kernel where :func:`fused_kernel_serves`."""
    if fused_kernel_serves(space, queries, items):
        from repro_torch.kernels import ops   # kernels import core

        return ops.fused_scores(queries.sparse, queries.dense, items.sparse, items.dense,
                                space.vocab_size, space.w_dense, space.w_sparse)
    return space.score_batch(queries, items)


def napp_membership(space, corpus, pivot_ids: torch.Tensor, num_pivots: int,
                    num_index: int, block_rows: int = NAPP_BLOCK_ROWS) -> torch.Tensor:
    """The index's membership f32 [N, num_pivots]: row n holds 1.0 at its
    ``num_index`` best-scoring pivots (ties toward the lower pivot), 0.0
    elsewhere.  The corpus is scored ``block_rows`` rows at a time; the
    result does not depend on it."""
    n = int(tensor_leaves(corpus)[0].shape[0])
    pivots = gather_items(corpus, pivot_ids)
    member = torch.zeros((n, num_pivots), dtype=torch.float32, device=pivot_ids.device)
    for r0 in range(0, n, block_rows):
        block = map_tensors(lambda x: x[r0:r0 + block_rows], corpus)
        _, top = select_topk(pivot_scores(space, pivots, block).T, num_index)
        member[r0:r0 + top.shape[0]].scatter_(1, top, 1.0)
    return member


def build_napp(space, corpus, n_items: int, num_pivots: int = 128,
               num_index: int = 8,
               generator: torch.Generator | None = None) -> NappIndex:
    """Draw ``num_pivots`` pivots among the first ``n_items`` rows (from
    ``generator``, seeded with 1 on the corpus's device when None) and
    index every corpus row by its ``num_index`` best pivots."""
    dev = tensor_leaves(corpus)[0].device
    g = generator if generator is not None else torch.Generator(dev).manual_seed(1)
    pivot_ids = draw_pivots(n_items, num_pivots, g)
    return NappIndex(pivot_ids, napp_membership(space, corpus, pivot_ids, num_pivots,
                                                num_index), num_index)


def _top_counts(counts: torch.Tensor, m: int) -> torch.Tensor:
    """Ids [B, m] of the ``m`` highest counts per row, ties toward the
    lower id.  Counts lie in {-1} and [0, P], so the int64 key
    ``(count + 1) * N + (N - 1 - id)`` is unique and orders exactly so."""
    n = counts.shape[1]
    ids = torch.arange(n, device=counts.device, dtype=torch.int64)
    key = (counts.to(torch.int64) + 1) * n + (n - 1 - ids)
    return torch.topk(key, m, dim=1).indices


def napp_search(space, queries, corpus, index: NappIndex, k: int = 10,
                num_search: int = 8, min_times: int = 2,
                rerank_qty: int = 256) -> TopK:
    """Two-stage NAPP probe: pivot-intersection counting, then an exact
    re-rank of ``rerank_qty`` candidates (the highest counts; counts below
    ``min_times`` demoted to -1 and their candidates scored -inf).  Slots
    that no passing candidate fills carry ids ``n, n+1, ...`` (n = the
    index's rows) and score -inf, the exact backends' degenerate tail."""
    pivots = gather_items(corpus, index.pivot_ids)
    qs = pivot_scores(space, queries, pivots)                         # [B, P]
    _, qtop = select_topk(qs, num_search)
    qmember = torch.zeros(qs.shape, dtype=torch.float32, device=qs.device)
    qmember.scatter_(1, qtop, 1.0)

    ieee_f32()
    counts = qmember @ index.membership.T                              # [B, N]
    counts = torch.where(counts >= min_times, counts, torch.full_like(counts, -1.0))
    cand = _top_counts(counts, rerank_qty)                              # [B, rerank_qty]

    s = score_many(space, queries, gather_items(corpus, cand))
    s = torch.where(torch.gather(counts, 1, cand) < 0, torch.full_like(s, -torch.inf), s)
    vals, pos = select_topk(s, k)
    ids = torch.gather(cand, 1, pos)
    n = index.membership.shape[0]
    dead = ~(vals > -torch.inf)
    tail_rank = torch.cumsum(dead.to(torch.int64), dim=1) - 1
    ids = torch.where(dead, n + tail_rank, ids)
    return TopK(vals, ids.to(torch.int32))
