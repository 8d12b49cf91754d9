"""Public wrappers around the kernels with the glue the retrieval core
needs (counterpart of ``repro/kernels/ops.py``: ``mips_topk``,
``fused_scores``, ``fused_topk`` and ``beam_topk``; ``topk_large`` serves
the k beyond the scan kernels' ``MAX_K`` that repro's kernels serve).

The TPU wrappers pad N up to a multiple of the tile (padded COO rows get
the trash id ``vocab_size``).  The CUDA kernel masks its ragged last tile
itself, so nothing is padded here, and the kernel wrappers clamp
``n_valid``.  The glue left is the densified ``[B, V+1]`` query table,
built by ``densify`` exactly as the library path builds it.
"""

from __future__ import annotations

import torch

from repro_torch.core.brute_force import TopK
from repro_torch.core.sparse import SparseVectors
from repro_torch.kernels import beam_topk as _beam
from repro_torch.kernels import fused_topk as _fused
from repro_torch.kernels import mips_topk as _mips
from repro_torch.kernels import sparse_dense as _score
from repro_torch.kernels import topk_large as _large
from repro_torch.kernels.ref import query_table


def mips_topk(queries, corpus, k: int, space: str = "ip",
              n_valid: int | None = None) -> TopK:
    """Kernelised exact k-NN over a dense corpus [N, D]."""
    s, i = _mips.mips_topk(queries, corpus, k, n_valid=n_valid, space=space)
    return TopK(s, i)


def fused_scores(q_sparse: SparseVectors, q_dense, c_sparse: SparseVectors, c_dense,
                 vocab_size: int, w_dense: float = 1.0, w_sparse: float = 1.0) -> torch.Tensor:
    """Kernelised fused sparse+dense scores [B, N]: the function
    ``FusedSpace.score_batch`` computes for ``dense_kind='ip'`` with both
    components present.  Both weights always apply."""
    return _score.fused_score(query_table(q_sparse, vocab_size), q_dense, c_sparse.indices,
                              c_sparse.values, c_dense, w_dense, w_sparse)


def fused_topk(q_sparse: SparseVectors | None, q_dense, c_sparse: SparseVectors | None,
               c_dense, vocab_size: int, k: int, w_dense: float | None = None,
               w_sparse: float | None = None, dense_kind: str = "ip",
               n_valid: int | None = None) -> TopK:
    """One-pass fused score + select over a ``FusedSpace``/``SparseSpace``
    corpus.  Only components present on both sides score; ``None``
    weights leave a single component unscaled (SparseSpace semantics).
    Requires ``k <= n_valid`` (the backend clamps and adds the tail)."""
    has_sparse = c_sparse is not None and q_sparse is not None
    has_dense = c_dense is not None and q_dense is not None
    if not (has_sparse or has_dense):
        raise ValueError("fused_topk: no overlapping components to score")
    s, i = _fused.fused_topk(
        query_table(q_sparse, vocab_size) if has_sparse else None,
        q_dense if has_dense else None,
        c_sparse.indices if has_sparse else None,
        c_sparse.values if has_sparse else None,
        c_dense if has_dense else None,
        k, w_dense=w_dense if has_dense else None,
        w_sparse=w_sparse if has_sparse else None,
        n_valid=n_valid, dense_kind=dense_kind)
    return TopK(s, i)


def topk_large(q_sparse: SparseVectors | None, q_dense, c_sparse: SparseVectors | None,
               c_dense, vocab_size: int, k: int, w_dense: float | None = None,
               w_sparse: float | None = None, dense_kind: str = "ip",
               n_valid: int | None = None) -> TopK:
    """Exact top-k at any k <= n_valid over a dense, sparse or fused
    corpus, with ``fused_topk``'s conventions (a dense space passes no
    sparse parts and its kind as ``dense_kind``)."""
    has_sparse = c_sparse is not None and q_sparse is not None
    has_dense = c_dense is not None and q_dense is not None
    s, i = _large.topk_large(
        query_table(q_sparse, vocab_size) if has_sparse else None,
        q_dense if has_dense else None,
        c_sparse.indices if has_sparse else None,
        c_sparse.values if has_sparse else None,
        c_dense if has_dense else None,
        k, w_dense=w_dense if has_dense else None,
        w_sparse=w_sparse if has_sparse else None,
        n_valid=n_valid, dense_kind=dense_kind)
    return TopK(s, i)


def beam_topk(qdensified, q_dense, init_scores, init_ids, neighbors, c_idx,
              c_val, c_dense, k: int, hops: int, n_valid: int, w_dense=None,
              w_sparse=None, dense_kind: str = "ip") -> TopK:
    """Kernelised graph-ANN traversal from a pre-scored entry beam: seeds
    the packed visited mask from ``init_ids``, runs ``hops`` hops and
    returns the beam's top ``k``, with sentinel slots rewritten to the
    exact backends' degenerate tail (ids ``n_valid``, ``n_valid + 1``, ...
    scoring -inf).

    ``init_scores``/``init_ids`` [B, ef] are score descending, sentinel
    slots (id >= ``n_valid``) scoring f32-min.  Components and weights
    follow ``fused_topk``'s conventions."""
    b, ef = init_scores.shape
    if k > ef:
        raise ValueError(f"beam_topk: k={k} exceeds the beam width ef={ef}")
    visited = torch.zeros((b, _beam.visited_words(n_valid)), dtype=torch.int32,
                          device=init_ids.device)
    visited = _beam.mark_visited(visited, init_ids, n_valid)
    beam_s, beam_i, _ = _beam.beam_search(
        qdensified, q_dense, init_scores, init_ids, visited, neighbors, c_idx,
        c_val, c_dense, n_valid=n_valid, hops=hops, w_dense=w_dense,
        w_sparse=w_sparse, dense_kind=dense_kind)
    # the merge keeps the beam sorted: its head is the top k
    s, i = beam_s[:, :k], beam_i[:, :k]
    sent = i >= n_valid
    i = torch.where(sent, n_valid + torch.cumsum(sent.int(), dim=1) - 1, i)
    s = torch.where(sent, torch.full_like(s, -torch.inf), s)
    return TopK(s, i.to(torch.int32))
