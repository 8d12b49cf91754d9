"""Exact k-NN / maximum inner-product search by brute force (counterpart
of ``repro/core/brute_force.py``).

Selection breaks score ties toward the lower corpus row id, as
``lax.top_k`` does.  ``torch.topk`` promises no order among ties, so
selection here goes through a stable descending sort.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.spaces import map_tensors, tensor_leaves

__all__ = [
    "TopK",
    "select_topk",
    "exact_topk",
    "concat_topk",
    "merge_topk",
    "pad_corpus",
]


class TopK(NamedTuple):
    scores: torch.Tensor   # f32[B, K] descending
    indices: torch.Tensor  # i32[B, K] corpus row ids


def select_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, positions) of the ``k`` largest entries of each row, score
    descending, ties toward the lower position."""
    vals, pos = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


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


def _mask_invalid(scores: torch.Tensor, n_valid: int) -> torch.Tensor:
    """-inf out rows at or past ``n_valid``."""
    rows = torch.arange(scores.shape[-1], device=scores.device)
    return torch.where(rows[None, :] < n_valid, scores,
                       torch.full_like(scores, -torch.inf))


def exact_topk(space, queries, corpus, k: int, n_valid: int | None = None) -> TopK:
    """One-shot exact top-k: the full [B, N] score matrix, then selection."""
    scores = space.score_batch(queries, corpus)
    if n_valid is not None:
        scores = _mask_invalid(scores, n_valid)
    vals, idx = select_topk(scores, k)
    return TopK(vals, idx.to(torch.int32))


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
