"""Exact k-NN / maximum inner-product search by brute force (counterpart
of ``repro/core/brute_force.py``).

Selection orders scores as ``lax.top_k`` does (+0 above -0, NaN by its
bits) and breaks ties toward the lower corpus row id.  ``torch.topk``
promises no order among ties, so selection here goes through a stable
descending sort of integer keys.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.spaces import map_tensors, tensor_leaves

__all__ = [
    "TopK",
    "order_keys",
    "select_topk",
    "exact_topk",
    "streaming_topk",
    "concat_topk",
    "merge_topk",
    "pad_corpus",
    "sharded_exact_topk",
]


class TopK(NamedTuple):
    scores: torch.Tensor   # f32[B, K] descending
    indices: torch.Tensor  # i32[B, K] corpus row ids


# The score that ranks below every other in lax.top_k's order: the NaN
# with every bit set (order key INT32_MIN).
LOWEST = float(torch.tensor(-1, dtype=torch.int32).view(torch.float32))


def order_keys(scores: torch.Tensor) -> torch.Tensor:
    """int32 keys in ``lax.top_k``'s order of f32 scores: the total order
    of their bit patterns, so +0 ranks above -0, a NaN with the sign bit
    clear above +inf and one with it set below -inf, NaNs by their bits."""
    bits = scores.float().view(torch.int32)
    key = bits >> 31
    key &= 0x7FFFFFFF
    key ^= bits
    return key


def select_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, positions) of the ``k`` largest entries of each row in
    ``lax.top_k``'s order (:func:`order_keys`), ties toward the lower
    position: a stable descending sort of the keys, with no host sync.  A
    strided last dimension (the NAPP build's transposed scores) is copied
    first: on the card the copy costs less than sorting along it."""
    scores = scores.contiguous()
    _, pos = torch.sort(order_keys(scores), dim=-1, descending=True, stable=True)
    pos = pos[..., :k]
    return torch.gather(scores, -1, pos), pos


def pad_corpus(x, multiple: int, fill: float = 0.0):
    """Pad every leaf of a row-major corpus along axis 0 up to a multiple
    of ``multiple`` with ``fill``; returns (padded, original row count)."""
    n = tensor_leaves(x)[0].shape[0]
    padded = (n + multiple - 1) // multiple * multiple
    if padded == n:
        return x, n

    def pad_leaf(leaf):
        tail = torch.full((padded - n, *leaf.shape[1:]), fill,
                          dtype=leaf.dtype, device=leaf.device)
        return torch.cat([leaf, tail], dim=0)

    return map_tensors(pad_leaf, x), n


def _mask_invalid(scores: torch.Tensor, n_valid: int, base: int = 0) -> torch.Tensor:
    """-inf out rows at or past ``n_valid``; column j is row ``base + j``."""
    rows = base + torch.arange(scores.shape[-1], device=scores.device)
    return torch.where(rows[None, :] < n_valid, scores,
                       torch.full_like(scores, -torch.inf))


def exact_topk(space, queries, corpus, k: int, n_valid: int | None = None) -> TopK:
    """One-shot exact top-k: the full [B, N] score matrix, then selection."""
    scores = space.score_batch(queries, corpus)
    if n_valid is not None:
        scores = _mask_invalid(scores, n_valid)
    vals, idx = select_topk(scores, k)
    return TopK(vals, idx.to(torch.int32))


def streaming_topk(space, queries, corpus, k: int, tile_n: int = 8192,
                   n_valid: int | None = None) -> TopK:
    """Scan corpus tiles keeping a running [B, k] heap, so the [B, N]
    score matrix never exists.  ``corpus`` is any row-major corpus (a
    tensor, ``SparseVectors`` or ``FusedVectors``) with N a multiple of
    ``tile_n`` (see :func:`pad_corpus`); each tile is scored through
    ``space.score_batch``.  The heap starts as (LOWEST, id 0) slots, which
    every row outranks, and precedes each tile in the merge.  (repro's heap
    starts at -inf, which outranks a row scoring a NaN with the sign bit
    set; its reference backend keeps such rows, and so does this.)"""
    n = int(tensor_leaves(corpus)[0].shape[0])
    if n % tile_n:
        raise ValueError(f"N={n} is not a multiple of tile_n={tile_n}")
    b = int(tensor_leaves(queries)[0].shape[0])
    n_valid = n if n_valid is None else n_valid
    dev = tensor_leaves(corpus)[0].device
    heap_s = torch.full((b, k), LOWEST, dtype=torch.float32, device=dev)
    heap_i = torch.zeros((b, k), dtype=torch.int32, device=dev)
    for base in range(0, n, tile_n):
        tile = map_tensors(lambda x: x[base:base + tile_n], corpus)
        s = _mask_invalid(space.score_batch(queries, tile).float(), n_valid, base)
        ids = torch.arange(base, base + tile_n, dtype=torch.int32, device=dev)
        heap_s, pos = select_topk(torch.cat([heap_s, s], dim=1), k)
        heap_i = torch.gather(torch.cat([heap_i, ids.expand(b, tile_n)], dim=1), 1, pos)
    return TopK(heap_s, heap_i)


def concat_topk(parts) -> TopK:
    """Column-concatenate candidate lists in order.  Order matters: with
    ties broken toward the lower slot, row-ordered shards reproduce the
    unsharded tie-break."""
    parts = list(parts)
    if len(parts) == 1:
        return parts[0]
    return TopK(torch.cat([p.scores for p in parts], dim=1),
                torch.cat([p.indices for p in parts], dim=1))


def merge_topk(parts: TopK, k: int) -> TopK:
    """Merge candidate lists: parts.scores [B, M >= k] -> top-k."""
    vals, pos = select_topk(parts.scores, k)
    return TopK(vals, torch.gather(parts.indices, 1, pos))


def sharded_exact_topk(space, queries, corpus, k: int, mesh, corpus_axis: str = "model",
                       tile_n: int = 0) -> TopK:
    """Distributed exact MIPS over a ``DeviceMesh``, called by every rank.

    ``corpus`` is row-sharded over ``corpus_axis``: a ``DTensor`` (its
    rows split over that axis, replicated over the others) or a tensor
    every rank holds whole, distributed first.  ``queries`` are replicated.
    Each rank takes a local top-k (``streaming_topk`` when ``tile_n`` is
    set) with *global* row ids; the k-lists are all-gathered in axis order
    and merged, so wire traffic is O(B * k * shards), and every rank
    returns the same result."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.collectives import gather_columns
    from repro_torch.distributed.sharding import NamedSharding, distribute

    n_shards = mesh.size(mesh.mesh_dim_names.index(corpus_axis))
    n = int(corpus.shape[0])
    assert n % n_shards == 0, f"corpus rows {n} % shards {n_shards} != 0"
    per = n // n_shards
    sharding = NamedSharding(mesh, (corpus_axis,) + (None,) * (corpus.ndim - 1))
    if not isinstance(corpus, DTensor):
        corpus = distribute(corpus, sharding)
    elif tuple(corpus.placements) != sharding.placements:
        raise ValueError(f"corpus placements {corpus.placements}: rows must be sharded over "
                         f"{corpus_axis!r} alone ({sharding.placements})")
    local = corpus.to_local()
    base = mesh.get_local_rank(corpus_axis) * per
    if tile_n:
        heap = streaming_topk(space, queries, local, k, tile_n)
    else:
        heap = exact_topk(space, queries, local, k)
    all_s = gather_columns(heap.scores, mesh, corpus_axis)
    all_i = gather_columns(heap.indices + base, mesh, corpus_axis)
    return merge_topk(TopK(all_s, all_i), k)
