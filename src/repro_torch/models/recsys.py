"""RecSys ranking models: Wide&Deep, DIN, DIEN (AUGRU), BST (counterpart of
``repro/models/recsys.py``).

The hot path is the sparse *embedding lookup*, built as the reference
builds it: a row gather plus a masked reduction (padded bags) or a
segment sum (ragged bags, ``index_add_``).  Indexing copies ``jnp.take``
as :func:`embedding_lookup` calls it, which is not the rule of
``transformer.gather_rows``: an id in ``[-V, 0)`` wraps, an id below
``-V`` gives a NaN row (``jnp.take``'s fill), and every id ``>= V`` (the
pad id ``V`` and past it) gives a zero row.

Retrieval tie-in: the ``retrieval_cand`` shape (scoring 1M candidates for
one user) is the paper's candidate-generation scenario.  The user tower
emits a dense query vector (:func:`user_query`), item embeddings are the
corpus, and the exact scan kernels (``kernels.mips_topk`` and, with
user-tag one-hots beside the dense interest vector, ``kernels.fused_topk``)
generate the candidates.

The parameters live in a :class:`RecSys` ``nn.Module`` under the
reference's names: tables in ``nn.ParameterDict``s, MLPs in
``nn.ModuleList``s of ``nn.ParameterDict``s (``w [d_in, d_out]``, ``b``).
Draws come from an explicit ``torch.Generator`` with the reference's
distributions and scales; parity with ``repro`` goes through
``interop.recsys_params``.  Masks are -1e9 as in the reference, so a
history that is all padding attends uniformly over zero rows, and BST
pools with a mean over all ``S + 1`` positions (pads as zeros).  DIEN's
GRUs run their 2 x ``seq_len`` steps as a Python loop.  Only the forward
pass is ported: training waits for ``optim/`` and ``launch/train.py``.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs.base import RecSysConfig
from repro_torch.core.brute_force import select_topk
from repro_torch.core.pipeline import _masked as _finite_only, _reorder
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import ParallelCtx
from repro_torch.models.transformer import _parameter_dict, gather_rows, torch_dtype

__all__ = ["embedding_lookup", "embedding_bag", "embedding_bag_ragged", "init_recsys",
           "RecSys", "RecBatch", "user_tower", "user_query", "forward_logits", "bce_loss",
           "retrieval_scores", "TagFusion", "ExactRescore"]

MASK = -1e9   # the reference's attention mask value (not f32-min)


# ---------------------------------------------------------------------------
# EmbeddingBag substrate.
# ---------------------------------------------------------------------------

def embedding_lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather; the pad id ``V`` and every id past it give zeros, an id
    in ``[-V, 0)`` wraps and one below ``-V`` gives a NaN row."""
    v = table.shape[0]
    idx = idx.long()
    safe = idx.clamp(max=v - 1)
    safe = torch.where(safe < 0, safe + v, safe)
    out = table[safe.clamp(min=0)]
    zero = torch.zeros((), dtype=table.dtype, device=table.device)
    out = torch.where((safe < 0)[..., None], torch.full_like(zero, math.nan), out)
    return torch.where((idx < v)[..., None], out, zero)


def embedding_bag(table: torch.Tensor, idx: torch.Tensor, mode: str = "sum") -> torch.Tensor:
    """Padded multi-hot bag: idx [..., M] (pad id = n_rows) -> [..., D]."""
    emb = embedding_lookup(table, idx)
    if mode == "sum":
        return emb.sum(dim=-2)
    count = torch.clamp_min((idx < table.shape[0]).sum(dim=-1, keepdim=True), 1)
    return emb.sum(dim=-2) / count


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: rows added into their segment; ids outside
    ``[0, num_segments)`` (negative ones too) are dropped.  On the card
    ``index_add_`` adds in atomic order, so f32 sums may differ in their
    last bits from run to run."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    rows = torch.where(keep.reshape(keep.shape + (1,) * (data.dim() - 1)), data, zero)
    out = torch.zeros((num_segments, *data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add_(0, torch.where(keep, ids, 0), rows)


def embedding_bag_ragged(table: torch.Tensor, flat_idx: torch.Tensor,
                         bag_ids: torch.Tensor, n_bags: int) -> torch.Tensor:
    """Ragged EmbeddingBag: gather rows, then a segment sum by bag id."""
    return segment_sum(embedding_lookup(table, flat_idx), bag_ids, n_bags)


# ---------------------------------------------------------------------------
# Shared init helpers.
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    """Standard normal f32 draws times ``scale`` (in place: a 100M-row
    table is drawn once), cast to ``dtype``."""
    return torch.randn(shape, generator=gen, device=device).mul_(scale).to(dtype)


def _dense(gen, din, dout, dtype, device):
    return {"w": _normal(gen, (din, dout), 1.0 / math.sqrt(din), dtype, device),
            "b": torch.zeros(dout, dtype=dtype, device=device)}


def _apply(p, x):
    return x @ p["w"] + p["b"]


def _mlp_init(gen, dims, dtype, device):
    return [_dense(gen, a, b, dtype, device) for a, b in zip(dims[:-1], dims[1:])]


def _mlp_apply(layers, x, final_act=False):
    n = len(layers)
    for i, p in enumerate(layers):
        x = _apply(p, x)
        if i < n - 1 or final_act:
            x = torch.relu(x)
    return x


def _mlp_axes(dims):
    return [{"w": ("hidden", "hidden"), "b": ("hidden",)} for _ in dims[:-1]]


_ROW_SHARD_MIN = 65536   # smaller tables are replicated in the reference's mesh layout


def _table_axes(vocab: int):
    return ("table_rows", None) if vocab >= _ROW_SHARD_MIN else (None, None)


class RecSys(nn.Module):
    """A recommendation model's parameters under the reference's names:
    ``tables`` (field and item tables), and by kind ``wide``, ``att``,
    ``mlp`` (``nn.ModuleList``s of layers), ``gru1`` / ``augru``, ``pos``
    and ``blocks``."""

    def __init__(self, cfg: RecSysConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        for name, sub in tree.items():
            if isinstance(sub, torch.Tensor):
                self.register_parameter(name, nn.Parameter(sub))
            elif isinstance(sub, list):
                self.add_module(name, nn.ModuleList(_parameter_dict(x) for x in sub))
            else:
                self.add_module(name, _parameter_dict(sub))

    def forward(self, batch: "RecBatch", ctx: Optional[ParallelCtx] = None):
        return forward_logits(self, self.cfg, batch, ctx or ParallelCtx(None, self.cfg.rules))


def init_recsys(cfg: RecSysConfig, seed: int = 0, device=None):
    """Random weights with the reference's distributions and scales
    (tables and BST positions ``N(0, 0.01^2)``, dense layers ``N(0,
    1/d_in)``, zero biases, zero wide tables), drawn on ``device`` (None
    = the card) from a ``torch.Generator`` seeded with ``seed``.  Returns
    ``(model, axes)``; ``device="meta"`` gives shapes and dtypes only."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=dev if dev.type == "cuda" else "cpu").manual_seed(seed)
    d = cfg.embed_dim
    p, a = {"tables": {}}, {"tables": {}}
    for f in cfg.fields:
        p["tables"][f.name] = _normal(gen, (f.vocab, d), 0.01, dtype, dev)
        a["tables"][f.name] = _table_axes(f.vocab)
    if cfg.item_vocab:
        p["tables"]["item"] = _normal(gen, (cfg.item_vocab, d), 0.01, dtype, dev)
        a["tables"]["item"] = _table_axes(cfg.item_vocab)

    feat_dim = d * (len(cfg.fields) + (1 if cfg.item_vocab else 0))
    if cfg.kind == "wide_deep":
        p["wide"] = {f.name: torch.zeros(f.vocab, 1, dtype=dtype, device=dev) for f in cfg.fields}
        a["wide"] = {f.name: _table_axes(f.vocab) for f in cfg.fields}
        dims = (d * len(cfg.fields), *cfg.mlp, 1)   # tower = field embeds only
    elif cfg.kind == "din":
        att_dims = (4 * d, *cfg.attn_mlp, 1)
        p["att"], a["att"] = _mlp_init(gen, att_dims, dtype, dev), _mlp_axes(att_dims)
        dims = (feat_dim + d, *cfg.mlp, 1)   # + attended interest
    elif cfg.kind == "dien":
        g = cfg.gru_dim
        for name in ("gru1", "augru"):
            din = d if name == "gru1" else g
            p[name] = {k: _dense(gen, din if k[0] == "w" else g, g, dtype, dev)
                       for k in ("wz", "uz", "wr", "ur", "wh", "uh")}
            a[name] = {k: {"w": ("hidden", "hidden"), "b": ("hidden",)} for k in p[name]}
        att_dims = (g + d, *(cfg.attn_mlp or (64,)), 1)
        p["att"], a["att"] = _mlp_init(gen, att_dims, dtype, dev), _mlp_axes(att_dims)
        dims = (feat_dim + g, *cfg.mlp, 1)
    elif cfg.kind == "bst":
        p["pos"] = _normal(gen, (cfg.seq_len + 1, d), 0.01, dtype, dev)
        a["pos"] = (None, None)
        p["blocks"] = [{"wq": _dense(gen, d, d, dtype, dev), "wk": _dense(gen, d, d, dtype, dev),
                        "wv": _dense(gen, d, d, dtype, dev), "wo": _dense(gen, d, d, dtype, dev),
                        "ff1": _dense(gen, d, 4 * d, dtype, dev),
                        "ff2": _dense(gen, 4 * d, d, dtype, dev)} for _ in range(cfg.n_blocks)]
        a["blocks"] = [{k: {"w": ("hidden", "hidden"), "b": ("hidden",)} for k in blk}
                       for blk in p["blocks"]]
        dims = (feat_dim + d, *cfg.mlp, 1)
    else:
        raise ValueError(cfg.kind)
    p["mlp"], a["mlp"] = _mlp_init(gen, dims, dtype, dev), _mlp_axes(dims)
    return RecSys(cfg, p), a


# ---------------------------------------------------------------------------
# Batches.
# ---------------------------------------------------------------------------

class RecBatch(NamedTuple):
    fields: Dict[str, torch.Tensor]              # name -> i32[B] or i32[B, M]
    history: Optional[torch.Tensor] = None       # i32[B, S] item ids (pad = vocab)
    target_item: Optional[torch.Tensor] = None   # i32[B]
    label: Optional[torch.Tensor] = None         # f32[B]
    candidates: Optional[torch.Tensor] = None    # i32[B, N] retrieval candidates


def _field_embeds(params: RecSys, cfg: RecSysConfig, batch: RecBatch):
    outs = []
    for f in cfg.fields:
        idx = batch.fields[f.name]
        t = params.tables[f.name]
        outs.append(embedding_bag(t, idx) if idx.dim() == 2 else embedding_lookup(t, idx))
    return outs


def _masked(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, x, torch.tensor(MASK, dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# Towers / forward passes.
# ---------------------------------------------------------------------------

def _din_interest(params: RecSys, hist_e, hist_mask, target_e):
    """DIN target attention: MLP([h, t, h-t, h*t]) -> weights -> sum."""
    t = target_e[:, None, :].expand_as(hist_e)
    z = torch.cat([hist_e, t, hist_e - t, hist_e * t], dim=-1)
    w = _mlp_apply(params.att, z)[..., 0]                     # [B, S]
    w = torch.softmax(_masked(hist_mask, w), dim=-1)
    return torch.einsum("bs,bsd->bd", w, hist_e)


def _gru_scan(p, xs, mask, att: Optional[torch.Tensor] = None, unroll: bool = False):
    """GRU (or AUGRU when ``att`` given) over [B, S, d] -> ([B, S, g], final
    [B, g]).  A masked step keeps ``h`` and emits it; the AUGRU scales the
    update gate by the step's attention.  The input projections of every
    step are taken at once; the recurrence is a Python loop (``unroll`` is
    the reference's XLA knob and changes nothing here)."""
    b, s, _ = xs.shape
    g = p["uz"]["w"].shape[0]
    xz, xr, xh = (_apply(p[k], xs) for k in ("wz", "wr", "wh"))
    h = torch.zeros(b, g, dtype=xs.dtype, device=xs.device)
    hs = []
    for t in range(s):
        z = torch.sigmoid(xz[:, t] + _apply(p["uz"], h))
        r = torch.sigmoid(xr[:, t] + _apply(p["ur"], h))
        hh = torch.tanh(xh[:, t] + _apply(p["uh"], r * h))
        if att is not None:
            z = z * att[:, t, None]                           # AUGRU gate scaling
        hn = (1 - z) * h + z * hh
        h = torch.where(mask[:, t, None], hn, h)
        hs.append(h)
    return torch.stack(hs, dim=1), h


def user_tower(params: RecSys, cfg: RecSysConfig, batch: RecBatch, ctx: ParallelCtx):
    """Dense user representation [B, D_repr]."""
    feats = _field_embeds(params, cfg, batch)
    if cfg.kind == "wide_deep":
        return torch.cat(feats, dim=-1)
    item_t = params.tables["item"]
    hist_e = embedding_lookup(item_t, batch.history)          # [B, S, D]
    hist_mask = batch.history < cfg.item_vocab
    target_e = embedding_lookup(item_t, batch.target_item)
    if cfg.kind == "din":
        interest = _din_interest(params, hist_e, hist_mask, target_e)
        return torch.cat(feats + [interest, target_e], dim=-1)
    if cfg.kind == "dien":
        states, _ = _gru_scan(params.gru1, hist_e, hist_mask, unroll=cfg.unroll)
        att_in = torch.cat([states, target_e[:, None, :].expand_as(hist_e)], dim=-1)
        a = _mlp_apply(params.att, att_in)[..., 0]
        a = torch.softmax(_masked(hist_mask, a), dim=-1)
        _, final = _gru_scan(params.augru, states, hist_mask, att=a, unroll=cfg.unroll)
        return torch.cat(feats + [final, target_e], dim=-1)
    if cfg.kind == "bst":
        seq = torch.cat([hist_e, target_e[:, None, :]], dim=1)
        seq = seq + params.pos[None, : seq.shape[1]]
        mask = torch.cat([hist_mask, torch.ones_like(hist_mask[:, :1])], dim=1)
        b, s1, d = seq.shape
        nh = cfg.n_heads
        dh = d // nh
        for blk in params.blocks:
            q = _apply(blk["wq"], seq).reshape(b, s1, nh, dh)
            k = _apply(blk["wk"], seq).reshape(b, s1, nh, dh)
            v = _apply(blk["wv"], seq).reshape(b, s1, nh, dh)
            s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
            s = _masked(mask[:, None, None, :], s)
            o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
            seq = seq + _apply(blk["wo"], o.reshape(b, s1, d))
            seq = seq + _apply(blk["ff2"], torch.relu(_apply(blk["ff1"], seq)))
        zero = torch.zeros((), dtype=seq.dtype, device=seq.device)
        pooled = torch.where(mask[..., None], seq, zero).mean(dim=1)   # over S + 1, pads as 0
        return torch.cat(feats + [pooled, target_e], dim=-1)
    raise ValueError(cfg.kind)


def forward_logits(params: RecSys, cfg: RecSysConfig, batch: RecBatch, ctx: ParallelCtx):
    u = ctx.constrain(user_tower(params, cfg, batch, ctx), "batch", None)
    logit = _mlp_apply(params.mlp, u)[..., 0]
    if cfg.kind == "wide_deep":
        for f in cfg.fields:
            idx = batch.fields[f.name]
            t = params.wide[f.name]
            logit = logit + (embedding_bag(t, idx) if idx.dim() == 2
                             else embedding_lookup(t, idx))[..., 0]
    return logit


def bce_loss(params: RecSys, cfg: RecSysConfig, batch: RecBatch, ctx: ParallelCtx):
    """Mean binary cross-entropy of the logits (forward only)."""
    logit = forward_logits(params, cfg, batch, ctx).float()
    y = batch.label
    loss = torch.mean(torch.clamp_min(logit, 0) - logit * y + torch.log1p(torch.exp(-logit.abs())))
    return loss, {"bce": loss}


def user_query(params: RecSys, cfg: RecSysConfig, batch: RecBatch, ctx: ParallelCtx) -> torch.Tensor:
    """The retrieval query [B, embed_dim]: the user representation
    projected to item space by the first MLP layer's leading columns, a
    learned projection shared with ranking."""
    return user_tower(params, cfg, batch, ctx) @ params.mlp[0]["w"][:, : cfg.embed_dim]


def retrieval_scores(params: RecSys, cfg: RecSysConfig, batch: RecBatch, ctx: ParallelCtx,
                     k: int = 100):
    """Two-tower candidate scoring (the paper's candidate generation): the
    user query against ``batch.candidates``' item embeddings -> (top-k
    scores, their candidate ids), in ``lax.top_k``'s order (ties toward
    the lower candidate position)."""
    uq = user_query(params, cfg, batch, ctx)                   # [B, D]
    cand_e = embedding_lookup(params.tables["item"], batch.candidates)   # [B, N, D]
    cand_e = ctx.constrain(cand_e, "batch", "candidates", None)
    scores = torch.einsum("bd,bnd->bn", uq, cand_e)
    vals, pos = select_topk(scores, k)
    return vals, torch.gather(batch.candidates, 1, pos)


# ---------------------------------------------------------------------------
# The served candidate funnel's later stages (examples/recsys_candidates.py).
# ---------------------------------------------------------------------------

class TagFusion:
    """Fusion stage: a candidate whose item tag equals the user's first tag
    gains ``weight``.  ``q_tokens`` [B, d + T] carry the user query and
    then the user's T tags (as floats)."""

    def __init__(self, tag_of_item: torch.Tensor, d: int, weight: float = 0.5):
        self.tag_of_item, self.d, self.weight = tag_of_item, d, weight

    def rerank(self, q_tokens, cands, keep):
        tags = q_tokens[:, self.d:].to(torch.int32)
        bias = self.weight * (gather_rows(self.tag_of_item, cands.indices) == tags[:, :1]).float()
        return _reorder(cands, _finite_only(cands, cands.scores + bias), keep)


class ExactRescore:
    """Rerank stage: the candidates rescored by the inner product of the
    f32 user query (``q_tokens[:, :d]``) with their rows of ``table``."""

    def __init__(self, table: torch.Tensor, d: int):
        self.table, self.d = table, d

    def rerank(self, q_tokens, cands, keep):
        scores = torch.einsum("bd,bcd->bc", q_tokens[:, :self.d], gather_rows(self.table, cands.indices))
        return _reorder(cands, _finite_only(cands, scores), keep)
