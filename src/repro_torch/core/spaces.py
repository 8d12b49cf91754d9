"""Distance/similarity spaces (counterpart of ``repro/core/spaces.py``).

Scores are "higher is better"; metric distances are negated (``-L2``), so
one top-k path serves similarities and distances.

Precision contract: a corpus may be resident in any of
:data:`CORPUS_DTYPES`, but scores always accumulate and emit in IEEE f32:
every scoring path upcasts its operands before the first multiply, and
the plain paths here run with TF32 switched off (see :func:`ieee_f32`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import sparse as sp
from repro_torch.core.sparse import accum_f32

__all__ = [
    "DenseSpace",
    "SparseSpace",
    "FusedSpace",
    "FusedVectors",
    "dense_scores",
    "weighted_mix",
    "ieee_f32",
    "CORPUS_DTYPES",
    "canonical_dtype",
    "corpus_dtype",
    "cast_corpus",
    "map_tensors",
]

CORPUS_DTYPES = ("float32", "bfloat16")

_DTYPE_ALIASES = {"f32": "float32", "fp32": "float32", "bf16": "bfloat16"}
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def ieee_f32():
    """Switch TF32 off for f32 matrix products and convolutions: TF32
    keeps about three decimal digits, which breaks the f32 tier.  Called
    by every plain scoring path before its first product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):
        return dtype
    try:
        return np.dtype(dtype).name          # numpy dtypes and scalar types
    except TypeError:
        return str(dtype)


def canonical_dtype(dtype) -> str:
    """Normalise a residency dtype spec (``"bf16"``, ``torch.bfloat16``,
    ``"float32"``, a numpy dtype) to its canonical string, or raise for
    dtypes outside the precision contract."""
    name = _dtype_name(dtype)
    name = _DTYPE_ALIASES.get(name, name)
    if name not in CORPUS_DTYPES:
        raise ValueError(
            f"corpus dtype {dtype!r} not supported; the precision "
            f"contract covers {CORPUS_DTYPES}")
    return name


def map_tensors(fn, corpus):
    """Apply ``fn`` to every tensor leaf of a corpus (a tensor, a
    ``SparseVectors`` or ``FusedVectors``, with ``None`` parts kept)."""
    if corpus is None:
        return None
    if isinstance(corpus, torch.Tensor):
        return fn(corpus)
    if isinstance(corpus, tuple) and hasattr(corpus, "_fields"):
        return type(corpus)(*(map_tensors(fn, x) for x in corpus))
    raise TypeError(f"not a corpus of tensors: {type(corpus).__name__}")


def tensor_leaves(corpus) -> list:
    out = []
    map_tensors(lambda t: out.append(t) or t, corpus)
    return out


def corpus_dtype(corpus) -> Optional[str]:
    """Residency dtype of a corpus: the dtype of its floating leaves when
    they agree and fall under the contract, else None."""
    try:
        leaves = tensor_leaves(corpus)
    except TypeError:
        return None
    dts = {_dtype_name(t.dtype) for t in leaves if t.is_floating_point()}
    if len(dts) == 1 and (d := dts.pop()) in CORPUS_DTYPES:
        return d
    return None


def cast_corpus(corpus, dtype):
    """Cast a corpus's floating leaves to a residency ``dtype``; integer
    leaves (COO term ids) stay i32.  Only narrowing from a source inside
    the contract is allowed: widening (bf16 -> f32) and out-of-contract
    sources (f16, f64) are refused, because the result would carry a tier
    label its values do not satisfy."""
    name = canonical_dtype(dtype)
    target = _TORCH_DTYPES[name]

    def cast_leaf(leaf):
        if not leaf.is_floating_point():
            return leaf
        src = _dtype_name(leaf.dtype)
        if src not in CORPUS_DTYPES:
            raise ValueError(
                f"cast_corpus: source dtype {src} is outside the precision "
                f"contract {CORPUS_DTYPES}; casting it to {name} would "
                "relabel out-of-contract data as a tier whose guarantees "
                "it does not satisfy")
        if leaf.element_size() < target.itemsize:
            raise ValueError(
                f"cast_corpus: widening {src} -> {name} is irreversible "
                "(the values were already rounded) and would mislabel "
                f"bounded-error data as the {name} tier; rebuild from the "
                "original corpus")
        return leaf.to(target)

    return map_tensors(cast_leaf, corpus)


def dense_scores(kind: str, q: torch.Tensor, d: torch.Tensor,
                 p: float = 2.0) -> torch.Tensor:
    """All-pairs dense scores [B, N] for queries [B, D] vs docs [N, D],
    with sub-f32 operands upcast first; l2 is ``-(q2 + c2 - 2s)``."""
    ieee_f32()
    q = accum_f32(q)
    d = accum_f32(d)
    if kind == "ip":
        return q @ d.T
    if kind == "cosine":
        qn = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
        dn = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
        return qn @ dn.T
    if kind == "l2":
        q2 = torch.einsum("bd,bd->b", q, q)[:, None]
        d2 = torch.einsum("nd,nd->n", d, d)[None, :]
        return -(q2 + d2 - 2.0 * (q @ d.T))
    if kind == "lp":
        diff = torch.abs(q[:, None, :] - d[None, :, :])    # [B, N, D], small D
        return -torch.sum(diff ** p, dim=-1) ** (1.0 / p)
    raise ValueError(f"unknown dense space kind: {kind}")


@dataclasses.dataclass(frozen=True)
class DenseSpace:
    """Fixed-size dense vectors with ip / cosine / l2 / lp scoring."""

    kind: str = "ip"
    p: float = 2.0

    def score_batch(self, queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
        return dense_scores(self.kind, queries, corpus, self.p)

    def score_pairs(self, queries: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
        """Aligned scores: queries [B, D] vs docs [B, D] -> [B], in f32."""
        q = accum_f32(queries)
        d = accum_f32(docs)
        if self.kind == "ip":
            return torch.sum(q * d, dim=-1)
        if self.kind == "cosine":
            qn = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
            dn = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
            return torch.sum(qn * dn, dim=-1)
        if self.kind == "l2":
            diff = q - d
            return -torch.sum(diff * diff, dim=-1)
        if self.kind == "lp":
            return -torch.sum(torch.abs(q - d) ** self.p, dim=-1) ** (1.0 / self.p)
        raise ValueError(f"unknown dense space kind: {self.kind}")


@dataclasses.dataclass(frozen=True)
class SparseSpace:
    """Padded-COO sparse vectors under inner product or cosine."""

    vocab_size: int
    kind: str = "ip"
    tile_n: int = 0  # 0 = untiled

    def score_batch(self, queries: sp.SparseVectors,
                    corpus: sp.SparseVectors) -> torch.Tensor:
        q = sp.l2_normalize_sparse(queries) if self.kind == "cosine" else queries
        d = sp.l2_normalize_sparse(corpus) if self.kind == "cosine" else corpus
        if self.tile_n:
            return sp.sparse_inner_tiled(q, d, self.vocab_size, self.tile_n)
        return sp.sparse_inner_qbatch_docs(q, d, self.vocab_size)

    def score_pairs(self, queries: sp.SparseVectors,
                    docs: sp.SparseVectors) -> torch.Tensor:
        """Aligned scores [B] of queries [B] vs docs [B]."""
        q = sp.l2_normalize_sparse(queries) if self.kind == "cosine" else queries
        d = sp.l2_normalize_sparse(docs) if self.kind == "cosine" else docs
        return sp.sparse_inner_one_to_one(q, d, self.vocab_size)


def weighted_mix(parts, weights) -> torch.Tensor:
    """``sum_c w_c * part_c`` in f32.  The reference mixes through one
    einsum so that jit cannot contract it into an FMA; PyTorch runs
    eagerly, so each product here is rounded and then the sum is rounded,
    which is the arithmetic the CUDA kernel runs (``__fmul_rn`` then
    ``__fadd_rn``)."""
    total = parts[0] * float(weights[0])
    for part, w in zip(parts[1:], weights[1:]):
        total = total + part * float(w)
    return total


class FusedVectors(NamedTuple):
    """One dense and one sparse component per item; either may be None."""

    dense: Optional[torch.Tensor]          # f32/bf16[..., D] or None
    sparse: Optional[sp.SparseVectors]     # padded COO or None


@dataclasses.dataclass(frozen=True)
class FusedSpace:
    """``w_dense * <q_d, x_d> + w_sparse * <q_s, x_s>`` with weights learned
    from training data (FlexNeuART export scenario 1)."""

    vocab_size: int
    w_dense: float = 1.0
    w_sparse: float = 1.0
    dense_kind: str = "ip"
    tile_n: int = 0

    def with_weights(self, w_dense: float, w_sparse: float) -> "FusedSpace":
        return dataclasses.replace(self, w_dense=w_dense, w_sparse=w_sparse)

    def score_batch(self, queries: FusedVectors, corpus: FusedVectors) -> torch.Tensor:
        parts, weights = [], []
        if queries.dense is not None and corpus.dense is not None:
            parts.append(dense_scores(self.dense_kind, queries.dense, corpus.dense))
            weights.append(self.w_dense)
        if queries.sparse is not None and corpus.sparse is not None:
            parts.append(SparseSpace(self.vocab_size, "ip", self.tile_n).score_batch(
                queries.sparse, corpus.sparse))
            weights.append(self.w_sparse)
        if not parts:
            raise ValueError("FusedSpace: no overlapping components to score")
        return weighted_mix(parts, weights)

    def score_pairs(self, queries: FusedVectors, docs: FusedVectors) -> torch.Tensor:
        """Aligned scores [B] of queries [B] vs docs [B], mixed as
        :meth:`score_batch` mixes."""
        parts, weights = [], []
        if queries.dense is not None and docs.dense is not None:
            parts.append(DenseSpace(self.dense_kind).score_pairs(queries.dense, docs.dense))
            weights.append(self.w_dense)
        if queries.sparse is not None and docs.sparse is not None:
            parts.append(SparseSpace(self.vocab_size).score_pairs(queries.sparse, docs.sparse))
            weights.append(self.w_sparse)
        if not parts:
            raise ValueError("FusedSpace: no overlapping components to score")
        return weighted_mix(parts, weights)
