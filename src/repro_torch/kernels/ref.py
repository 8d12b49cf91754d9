"""Plain PyTorch versions of the CUDA kernels (counterpart of
``repro/kernels/ref.py``).  The kernel wrappers run them for tensors on
the CPU; the tests and ``chip_smoke.py`` hold the kernels against them.

They score through the library's own paths (``spaces.dense_scores``,
the ``"bnk,nk->bn"`` gather-reduce of ``core.sparse``,
``spaces.weighted_mix``) and select by a stable sort, so ties break
toward the lower row id.  ``tile_n`` scores the corpus in row tiles and
keeps a running top-k, which bounds the [B, tile, NNZ] gather at full
scale; the result does not depend on it.
"""

from __future__ import annotations

import torch

from repro_torch.core.brute_force import select_topk
from repro_torch.core.sparse import SparseVectors, accum_f32, densify
from repro_torch.core.spaces import dense_scores, weighted_mix

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


def fused_table_scores(qdensified, q_dense, c_idx, c_val, c_dense,
                       w_dense=None, w_sparse=None, dense_kind: str = "ip"):
    """Fused scores [B, N] from the kernel's inputs: the densified query
    table [B, V+1] (zero trash column last), COO ids/values, dense parts.
    ``None`` weights leave a single part unscaled."""
    parts, weights = [], []
    if c_dense is not None:
        parts.append(dense_scores(dense_kind, q_dense, c_dense))
        weights.append(w_dense)
    if c_idx is not None:
        picked = accum_f32(qdensified)[:, c_idx.long()]       # [B, N, NNZ]
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
