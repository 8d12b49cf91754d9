"""Padded-COO sparse vectors and sparse inner products (counterpart of
``repro/core/sparse.py``).

    indices : i32[..., NNZ]   term ids; padding slots hold ``pad_id``
    values  : f32/bf16[..., NNZ]   weights; padding slots hold 0.0

``pad_id`` is by convention ``vocab_size``, so a scatter into a buffer of
``vocab_size + 1`` columns sends padding into a trash column, and a
gather from a densified query table with a zero last column scores
padding as 0.  Scores always accumulate in f32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "SparseVectors",
    "accum_f32",
    "from_dense",
    "densify",
    "sparse_inner_one_to_one",
    "sparse_inner_qbatch_docs",
    "sparse_inner_tiled",
    "l2_normalize_sparse",
    "topk_truncate",
]


def accum_f32(x: torch.Tensor) -> torch.Tensor:
    """Upcast sub-f32 values (bf16/f16 residency) to f32 before the first
    multiply; f32 and wider pass through unchanged."""
    return x.float() if x.element_size() < 4 else x


class SparseVectors(NamedTuple):
    """A batch of padded-COO sparse vectors."""

    indices: torch.Tensor  # i32[..., NNZ]
    values: torch.Tensor   # f32/bf16[..., NNZ]

    @property
    def nnz_capacity(self) -> int:
        return self.indices.shape[-1]

    @property
    def batch_shape(self):
        return self.indices.shape[:-1]


def from_dense(dense: torch.Tensor, nnz: int,
               pad_id: int | None = None) -> SparseVectors:
    """Dense rows [..., V] -> padded COO keeping the ``nnz`` entries of
    largest |value|; equal magnitudes keep the lower term id first, as
    ``lax.top_k`` does.  Zero entries become padding."""
    vocab = dense.shape[-1]
    pad_id = vocab if pad_id is None else pad_id
    mag, idx = torch.sort(dense.abs(), dim=-1, descending=True, stable=True)
    mag, idx = mag[..., :nnz], idx[..., :nnz]
    vals = torch.gather(dense, -1, idx)
    keep = mag > 0.0
    idx = torch.where(keep, idx, torch.full_like(idx, pad_id))
    vals = torch.where(keep, vals, torch.zeros_like(vals))
    return SparseVectors(idx.to(torch.int32), vals)


def densify(sp: SparseVectors, vocab_size: int) -> torch.Tensor:
    """Scatter padded-COO rows back to dense [..., vocab_size], in the
    storage dtype (padding lands in a trash column that is dropped)."""
    flat_idx = sp.indices.reshape(-1, sp.nnz_capacity).long()
    flat_val = sp.values.reshape(-1, sp.nnz_capacity)
    buf = torch.zeros(flat_idx.shape[0], vocab_size + 1,
                      dtype=flat_val.dtype, device=flat_val.device)
    buf.scatter_add_(1, flat_idx, flat_val)
    return buf[:, :vocab_size].reshape(*sp.batch_shape, vocab_size)


def l2_normalize_sparse(sp: SparseVectors, eps: float = 1e-12) -> SparseVectors:
    norm = torch.sqrt(torch.sum(sp.values * sp.values, dim=-1, keepdim=True))
    return SparseVectors(sp.indices, sp.values / torch.clamp(norm, min=eps))


def topk_truncate(sp: SparseVectors, nnz: int, pad_id: int) -> SparseVectors:
    """Reduce the nnz capacity to ``nnz``, keeping the entries of largest
    |value| in ``lax.top_k``'s order (equal magnitudes keep the lower
    slot first); zero entries become padding."""
    from repro_torch.core.brute_force import select_topk   # brute_force imports this module

    mag, pos = select_topk(sp.values.abs(), nnz)
    idx = torch.gather(sp.indices, -1, pos)
    val = torch.gather(sp.values, -1, pos)
    keep = mag > 0.0
    return SparseVectors(
        torch.where(keep, idx, torch.full_like(idx, pad_id)).to(torch.int32),
        torch.where(keep, val, torch.zeros_like(val)))


def _query_table(q: SparseVectors, vocab_size: int) -> torch.Tensor:
    """The densified query table [B, V+1] in f32 with a zero trash column.
    Densify in the storage dtype, THEN upcast, as the reference does."""
    qd = accum_f32(densify(q, vocab_size))
    return torch.nn.functional.pad(qd, (0, 1))


def sparse_inner_one_to_one(q: SparseVectors, d: SparseVectors,
                            vocab_size: int) -> torch.Tensor:
    """<q_b, d_b> for aligned batches: scatter q into a dense row of V+1
    slots, gather it at d's indices."""
    qi = q.indices.reshape(-1, q.nnz_capacity).long()
    qv = accum_f32(q.values.reshape(-1, q.nnz_capacity))
    di = d.indices.reshape(-1, d.nnz_capacity).long()
    dv = accum_f32(d.values.reshape(-1, d.nnz_capacity))
    buf = torch.zeros(qi.shape[0], vocab_size + 1, dtype=qv.dtype,
                      device=qv.device)
    buf.scatter_add_(1, qi, qv)
    out = torch.sum(torch.gather(buf, 1, di) * dv, dim=-1)
    return out.reshape(q.batch_shape)


def sparse_inner_qbatch_docs(q: SparseVectors, docs: SparseVectors,
                             vocab_size: int) -> torch.Tensor:
    """All-pairs scores [B, N]: densify the queries, gather the table at
    the docs' ids ([B, N, NNZ]) and reduce as ``"bnk,nk->bn"``."""
    qd = _query_table(q, vocab_size)
    picked = qd[:, docs.indices.long()]                  # [B, N, NNZ]
    return torch.einsum("bnk,nk->bn", picked, accum_f32(docs.values))


def sparse_inner_tiled(q: SparseVectors, docs: SparseVectors,
                       vocab_size: int, tile_n: int = 4096) -> torch.Tensor:
    """:func:`sparse_inner_qbatch_docs` over row tiles of ``tile_n``, so the
    [B, tile, NNZ] gather stays bounded; any doc count."""
    qd = _query_table(q, vocab_size)
    n = docs.indices.shape[0]
    out = []
    for r0 in range(0, n, tile_n):
        idx = docs.indices[r0:r0 + tile_n].long()
        val = accum_f32(docs.values[r0:r0 + tile_n])
        out.append(torch.einsum("bnk,nk->bn", qd[:, idx], val))
    return torch.cat(out, dim=1)
