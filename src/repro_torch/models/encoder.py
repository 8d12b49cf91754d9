"""Dense encoders + cross-encoder re-ranker heads: the bridge between the
assigned model architectures and the retrieval core (counterpart of
``repro/models/encoder.py``).

* ``encode`` — mean-pooled, L2-normalised backbone states -> fixed-size
  dense vectors (the paper's dense-representation path; DPR-style).
* ``cross_encoder_score`` — joint (query ++ doc) scoring with a scalar
  head: the neural re-ranker the paper plugs in via proxy scorers
  (CEDR/MatchZoo role), exposed as a ``ProxyExtractor``-compatible callable.
* ``CrossEncoderReranker`` — the same scorer packaged as a
  ``core.pipeline.Reranker``: the neural final stage of the served
  funnel (``repro_torch.serving.funnel.FunnelPipeline``).
* ``contrastive_loss`` — in-batch-negatives dual-encoder loss (the DPR
  objective), its value and metrics.

Reductions copy ``jax.numpy``'s: a sum, mean or dot of bf16 accumulates
in f32 and is rounded back to bf16 once, and a bf16 value divided by an
integer count or a Python float divides by it rounded to bf16.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import TransformerConfig
from repro_torch.core.pipeline import _masked, _reorder
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import ParallelCtx
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

__all__ = ["encode", "cross_encoder_score", "make_proxy_scorer", "CrossEncoderReranker",
           "contrastive_loss"]


def encode(params: T.Transformer, tokens: torch.Tensor, cfg: TransformerConfig,
           ctx: ParallelCtx, out_dim: int | None = None) -> torch.Tensor:
    """tokens [B, S] -> unit vectors [B, d_model] (mean pool over non-pad:
    ids below ``vocab_size``, negative ones included).  Under a mesh the
    backbone runs sharded and the pooling on its gathered states."""
    hidden, _ = T.backbone(params, tokens, cfg, ctx)
    hidden = T.gathered(hidden)
    dt = hidden.dtype
    mask = (tokens < cfg.vocab_size)[..., None]
    s = torch.where(mask, hidden, torch.zeros((), dtype=dt, device=hidden.device))
    s = s.float().sum(dim=1).to(dt)
    v = s / torch.clamp_min(mask.sum(dim=1), 1).to(dt)
    if out_dim is not None:
        v = v[..., :out_dim]
    norm = torch.sqrt((v * v).float().sum(dim=-1, keepdim=True).to(dt))
    return v / torch.clamp_min(norm, 1e-9)


def cross_encoder_score(params: T.Transformer, q_tokens: torch.Tensor, d_tokens: torch.Tensor,
                        cfg: TransformerConfig, ctx: ParallelCtx) -> torch.Tensor:
    """Joint scoring: concat(q, doc) through the backbone, dot the pooled
    state (the mean over every position, pads included) with the first
    column of the output head as a scalar relevance head (under a mesh,
    on the gathered states and that column alone)."""
    joint = torch.cat([q_tokens, d_tokens], dim=1)
    hidden, _ = T.backbone(params, joint, cfg, ctx)
    hidden = T.gathered(hidden)
    pooled = hidden.float().mean(dim=1).to(hidden.dtype)
    head = _first_head_column(params, cfg, ctx)
    return (pooled.float() @ head.float()).to(pooled.dtype)


def _first_head_column(params: T.Transformer, cfg: TransformerConfig, ctx: ParallelCtx) -> torch.Tensor:
    """The output head's first column ``[d]`` (the tied embedding's row 0),
    whole on every rank.  Under a mesh the vocabulary shard that holds id 0
    gives it and the others zeros, summed over the vocabulary's axis, and
    a split ``d`` is gathered: nothing else of the head moves.  Every rank
    uses it alike, so its gradient is each rank's own."""
    plan = L.RankPlan.of(ctx)
    tied = cfg.tie_embeddings
    axes = ("vocab", "embed") if tied else ("embed", "vocab")
    blk = C.rank_block(params.embed if tied else params.lm_head, ctx.sharding(*axes), split=())
    v0, vl = plan.block(cfg.padded_vocab, plan.vocab)
    vdim = 0 if tied else 1
    col = blk.select(vdim, 0) if v0 == 0 and vl > 0 else blk.new_zeros(blk.shape[1 - vdim])
    return C.gather_axis(C.all_sum(col, plan.mesh, plan.vocab), plan.mesh, plan.embed, 0)


def make_proxy_scorer(params: T.Transformer, cfg: TransformerConfig, ctx: ParallelCtx,
                      doc_tokens: torch.Tensor) -> Callable:
    """Adapter producing the (q_tokens, cand_ids) -> [B, C] signature the
    retrieval pipeline's ProxyExtractor expects; inference only (no
    autograd graph), where ``params`` live."""

    @torch.no_grad()
    def score(q_tokens, cand_ids):
        b, c = cand_ids.shape
        docs = T.gather_rows(doc_tokens, cand_ids)              # [B, C, L]
        flat_q = q_tokens.repeat_interleave(c, dim=0)          # pair (i, j) at i * C + j
        flat_d = docs.reshape(b * c, -1)
        return cross_encoder_score(params, flat_q, flat_d, cfg, ctx).reshape(b, c)

    return score


class CrossEncoderReranker:
    """Neural re-rank stage: ``cross_encoder_score`` over the candidate
    documents' tokens, packaged as a ``core.pipeline.Reranker``.

    Gathers ``doc_tokens[cand_ids]``, flattens the (query, candidate)
    pairs to one ``[B*C]`` batch through the joint scorer
    (:func:`make_proxy_scorer`'s adapter pattern), masks padded / absent
    candidates (non-finite candidate scores) to ``-inf``, and reorders —
    the funnel's final stage, also usable as ``RetrievalPipeline``'s
    ``final``.  Scores keep the model's dtype."""

    def __init__(self, params: T.Transformer, cfg: TransformerConfig, ctx: ParallelCtx,
                 doc_tokens: torch.Tensor):
        self.doc_tokens = doc_tokens
        self._score = make_proxy_scorer(params, cfg, ctx, self.doc_tokens)

    def rerank(self, q_tokens: torch.Tensor, cands, keep: int):
        mask = torch.isfinite(cands.scores)
        # masked ids read row 0 so the gather stays in bounds; their
        # scores are forced to -inf below regardless of what row 0 scores
        ids = torch.where(mask, cands.indices, torch.zeros_like(cands.indices))
        return _reorder(cands, _masked(cands, self._score(q_tokens, ids)), keep)


def contrastive_loss(params: T.Transformer, q_tokens: torch.Tensor, pos_doc_tokens: torch.Tensor,
                     cfg: TransformerConfig, ctx: ParallelCtx, temperature: float = 0.05):
    """In-batch-negative dual-encoder loss (DPR): query i's positive is doc
    i; all other docs in the batch are negatives.  Returns (loss, metrics)."""
    qv = encode(params, q_tokens, cfg, ctx)
    dv = encode(params, pos_doc_tokens, cfg, ctx)
    dt = qv.dtype
    logits = (qv @ dv.T) / torch.tensor(temperature, dtype=dt).item()
    labels = torch.arange(qv.shape[0], device=logits.device)
    # jax.nn.logsumexp: shifted by the (finite) row max, the sum in f32
    amax = logits.amax(dim=-1, keepdim=True)
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    sumexp = torch.exp(logits - amax).float().sum(dim=-1).to(dt)
    lse = torch.log(sumexp) + amax[:, 0]
    gold = logits[labels, labels]
    loss = (lse - gold).float().mean().to(dt)
    acc = (logits.argmax(dim=-1) == labels).float().mean()
    return loss, {"contrastive": loss, "in_batch_acc": acc}
