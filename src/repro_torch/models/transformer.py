"""Causal LM transformer: GQA / MLA attention, optional MoE, the chunked
cross-entropy loss and the KV-cache decode and prefill steps (counterpart
of ``repro/models/transformer.py``).

Five assigned architectures instantiate this module (qwen2.5-3b,
minicpm3-4b/MLA, smollm-360m, phi3.5-moe, arctic-480b).  In the
retrieval system these models are (a) dense encoders for k-NN candidate
generation and (b) cross-encoder re-rankers (the paper's CEDR
proxy-scorer role) — see ``repro_torch.models.encoder``.

The parameters live in ``nn.Module``s: a :class:`Block` per layer (the
reference's per-layer tree as ``nn.ParameterDict``s, in its einsum
layouts; with experts, a ``moe`` subtree, and arctic's dense residual
FFN under ``ln3`` and ``ffn``) in the ``nn.ModuleList`` of a
:class:`Transformer`, where the reference stacks the blocks on a leading
layer axis and scans them.  :func:`decode_step` writes the step into the
caller's :class:`KVCache` in place and returns it (the reference returns
a new cache): a copy of a decode-length cache every step is no option.
``pos`` is a Python int, so a step needs no host sync.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import TransformerConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import ParallelCtx, require_no_mesh
from repro_torch.models import layers as L
from repro_torch.models import moe as M

__all__ = ["Block", "Transformer", "torch_dtype", "init_block", "init_transformer",
           "block_apply", "backbone", "gather_rows", "chunked_ce_loss", "lm_loss", "KVCache",
           "init_cache", "cache_axes", "decode_step", "prefill_step"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The tensor dtype a config's ``dtype`` string names."""
    return _DTYPES[name]


def _parameter_dict(tree: dict) -> nn.ParameterDict:
    """Nested dict of tensors -> nested ``nn.ParameterDict``."""
    return nn.ParameterDict({k: _parameter_dict(v) if isinstance(v, dict) else v
                             for k, v in tree.items()})


class Block(nn.Module):
    """One layer's parameters under the reference's names: ``ln1``,
    ``attn``, ``ln2`` and ``ffn``, or with experts ``moe`` (and, with a
    dense residual, ``ln3`` and ``ffn``), each an ``nn.ParameterDict``."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, sub in tree.items():
            self.add_module(name, _parameter_dict(sub))


class Transformer(nn.Module):
    """The backbone's parameters: ``embed [Vp, d]``, ``blocks`` (one
    :class:`Block` per layer), ``ln_f`` and, untied, ``lm_head [d, Vp]``.
    Calling it runs :func:`backbone` on one device."""

    STACKED = ("blocks",)   # the reference stacks these layers on a leading axis

    def __init__(self, cfg: TransformerConfig, embed: torch.Tensor, blocks, ln_f: dict,
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(embed)
        self.blocks = nn.ModuleList(blocks)
        self.ln_f = _parameter_dict(ln_f)
        self.lm_head = None if lm_head is None else nn.Parameter(lm_head)

    def forward(self, tokens: torch.Tensor, ctx: Optional[ParallelCtx] = None):
        return backbone(self, tokens, self.cfg, ctx or ParallelCtx(None, self.cfg.rules))


# ---------------------------------------------------------------------------
# Init.
# ---------------------------------------------------------------------------

def init_block(gen: torch.Generator, cfg: TransformerConfig, dtype, device=None):
    """(one layer's params tree, its axes tree), drawn from ``gen``."""
    dev = gen.device if device is None else device
    p, a = {}, {}
    p["ln1"], a["ln1"] = L.rmsnorm_init(cfg.d_model, dtype, dev)
    if cfg.attention == "mla":
        p["attn"], a["attn"] = L.mla_init(gen, cfg, dtype, dev)
    else:
        p["attn"], a["attn"] = L.gqa_init(gen, cfg, dtype, dev)
    p["ln2"], a["ln2"] = L.rmsnorm_init(cfg.d_model, dtype, dev)
    if cfg.is_moe:
        p["moe"], a["moe"] = M.moe_init(gen, cfg, dtype, dev)
        if cfg.dense_residual:
            p["ln3"], a["ln3"] = L.rmsnorm_init(cfg.d_model, dtype, dev)
            p["ffn"], a["ffn"] = L.swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype, dev)
    else:
        p["ffn"], a["ffn"] = L.swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype, dev)
    return p, a


def init_transformer(cfg: TransformerConfig, seed: int = 0, device=None) -> Tuple[Transformer, dict]:
    """Random weights with the reference's distributions and scales (embed
    and lm_head ``N(0, 0.02^2)``; dense layers and experts ``N(0, 1/in_dim)``,
    the router in f32; norms 1; biases 0), drawn on ``device`` (None = the
    card) from a ``torch.Generator`` seeded with ``seed``.  Returns the
    model and the axes tree, whose blocks carry the reference's leading
    layer axis (``None``).  ``device="meta"`` gives shapes and dtypes only."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=dev if dev.type == "cuda" else "cpu").manual_seed(seed)
    embed = L._normal(gen, (cfg.padded_vocab, cfg.d_model), 0.02, dtype, dev)
    blocks, block_axes = [], None
    for _ in range(cfg.n_layers):
        p, block_axes = init_block(gen, cfg, dtype, dev)
        blocks.append(Block(p))
    ln_f, ln_f_axes = L.rmsnorm_init(cfg.d_model, dtype, dev)
    a = {"embed": ("vocab", "embed"), "blocks": _lead_none(block_axes), "ln_f": ln_f_axes}
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = L._normal(gen, (cfg.d_model, cfg.padded_vocab), 0.02, dtype, dev)
        a["lm_head"] = ("embed", "vocab")
    return Transformer(cfg, embed, blocks, ln_f, lm_head), a


def _lead_none(axes):
    """The axes tree of one block with the stacked layer axis in front."""
    if isinstance(axes, dict):
        return {k: _lead_none(v) for k, v in axes.items()}
    return (None, *axes)


# ---------------------------------------------------------------------------
# Blocks.
# ---------------------------------------------------------------------------

def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with JAX's indexing of out-of-range ids: a negative id
    wraps once, then every id clamps to ``[0, n - 1]``."""
    n = table.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + n, ids).clamp_(0, n - 1)
    return table[ids]


def block_apply(bp: Block, x, positions, cfg: TransformerConfig, ctx: ParallelCtx):
    """One pre-norm block: ``x + attn(ln1(x))``, then ``+ ffn(ln2(.))`` or,
    with experts, ``+ moe(ln2(.))`` (plus ``ffn(ln3(.))`` with a dense
    residual).  Returns (x, aux): the MoE balance loss, 0 without experts."""
    require_no_mesh(ctx, "block_apply")
    attn_fn = L.mla_apply if cfg.attention == "mla" else L.gqa_apply
    x = x + attn_fn(bp.attn, L.rmsnorm(bp.ln1, x, cfg.norm_eps), positions, cfg, ctx)
    if cfg.seq_shard:
        x = ctx.constrain(x, "batch", "seq_act", None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.is_moe:
        mo, aux = M.moe_apply(bp.moe, L.rmsnorm(bp.ln2, x, cfg.norm_eps), cfg, ctx)
        if cfg.dense_residual:
            mo = mo + L.swiglu_apply(bp.ffn, L.rmsnorm(bp.ln3, x, cfg.norm_eps))
        x = x + mo
    else:
        x = x + L.swiglu_apply(bp.ffn, L.rmsnorm(bp.ln2, x, cfg.norm_eps))
    if cfg.seq_shard:
        x = ctx.constrain(x, "batch", "seq_act", None)
    return x, aux


def backbone(params: Transformer, tokens, cfg: TransformerConfig, ctx: ParallelCtx):
    """Embed + all blocks + final norm.  Returns (hidden [B,S,d], aux), aux
    the MoE balance loss summed over the layers and divided by their count
    (0 without experts).  Runs where ``params`` and ``tokens`` live.  With
    ``cfg.remat`` and grad enabled, each block is rematerialised (the
    reference's ``jax.checkpoint`` of the layer body): only its input is
    kept, and the backward runs it again, routing MoE tokens as the first
    pass did (``select_topk`` is deterministic)."""
    require_no_mesh(ctx, "backbone")
    b, s = tokens.shape
    x = gather_rows(params.embed, tokens).to(torch_dtype(cfg.dtype))
    x = ctx.constrain(x, "batch", "seq_act", None)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for bp in params.blocks:
        if remat:
            x, a = checkpoint(block_apply, bp, x, positions, cfg, ctx, use_reentrant=False)
        else:
            x, a = block_apply(bp, x, positions, cfg, ctx)
        aux = aux + a
    x = L.rmsnorm(params.ln_f, x, cfg.norm_eps)
    return x, aux / cfg.n_layers


def _head_matrix(params: Transformer, cfg: TransformerConfig) -> torch.Tensor:
    """[d, Vp]: the tied embedding's transpose, or ``lm_head``."""
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def _vocab_mask(cfg: TransformerConfig, device) -> Optional[torch.Tensor]:
    """True for the real vocabulary's columns, None when nothing is padded."""
    if cfg.padded_vocab == cfg.vocab_size:
        return None
    return torch.arange(cfg.padded_vocab, device=device) < cfg.vocab_size


def _take_target(logits: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``jnp.take_along_axis(logits, t[..., None], axis=-1)[..., 0]``: a
    negative target wraps once, and one still outside ``[0, Vp)`` reads
    NaN (JAX's fill)."""
    vp = logits.shape[-1]
    t = t.long()
    t = torch.where(t < 0, t + vp, t)
    inside = (t >= 0) & (t < vp)
    gold = torch.gather(logits, -1, t.clamp(0, vp - 1)[..., None])[..., 0]
    return torch.where(inside, gold, torch.nan)


def chunked_ce_loss(params: Transformer, hidden, targets, cfg: TransformerConfig,
                    ctx: ParallelCtx, chunk: int = 512):
    """Mean cross entropy without materialising [B, S, V]: sequence chunks
    of ``chunk`` positions, each chunk's logits (``h @ head`` rounded to the
    model dtype, then f32; the padded vocabulary masked at f32-min) and
    logsumexp, summed in f32.  With grad enabled each chunk is recomputed
    in the backward, so at most one chunk's logits are ever live."""
    require_no_mesh(ctx, "chunked_ce_loss")
    b, s, d = hidden.shape
    head = _head_matrix(params, cfg)
    c = min(chunk, s)
    assert s % c == 0
    vocab_mask = _vocab_mask(cfg, hidden.device)
    recompute = torch.is_grad_enabled() and (hidden.requires_grad or head.requires_grad)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, s, c):
        args = (hidden[:, lo:lo + c], head, targets[:, lo:lo + c], vocab_mask)
        part = checkpoint(_ce_chunk, *args, use_reentrant=False) if recompute else _ce_chunk(*args)
        total = total + part
    return total / (b * s)


def _ce_chunk(h, head, t, vocab_mask):
    """Summed ``logsumexp - gold`` of one chunk's logits [B, c, Vp]."""
    logits = (h @ head).float()
    if vocab_mask is not None:
        logits = logits.masked_fill_(~vocab_mask, torch.finfo(torch.float32).min)
    return torch.sum(torch.logsumexp(logits, dim=-1) - _take_target(logits, t))


def lm_loss(params: Transformer, batch, cfg: TransformerConfig, ctx: ParallelCtx,
            aux_weight: float = 0.01):
    """(ce + aux_weight * aux, {"ce": ce, "aux": aux}) of ``batch``'s
    ``tokens`` against its ``targets``."""
    hidden, aux = backbone(params, batch["tokens"], cfg, ctx)
    loss = chunked_ce_loss(params, hidden, batch["targets"], cfg, ctx)
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# Decode with KV cache.
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: Optional[torch.Tensor] = None      # [L, B, S, Hkv, Dh]     (GQA)
    v: Optional[torch.Tensor] = None
    ckv: Optional[torch.Tensor] = None    # [L, B, S, kv_lora]     (MLA)
    kpe: Optional[torch.Tensor] = None    # [L, B, S, rope_dim]


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, device=None) -> KVCache:
    """A zeroed cache in the model dtype on ``device`` (None = the card).
    GQA decode attends in chunks of ``min(attn_chunk_kv, max_len)``, which
    must divide ``max_len`` (asserted there, as the reference's
    ``flash_attention`` asserts it)."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    lcount = cfg.n_layers
    if cfg.attention == "mla":
        return KVCache(
            ckv=torch.zeros((lcount, batch, max_len, cfg.kv_lora_rank), dtype=dt, device=dev),
            kpe=torch.zeros((lcount, batch, max_len, cfg.qk_rope_head_dim), dtype=dt, device=dev),
        )
    dh = cfg.resolved_head_dim
    return KVCache(
        k=torch.zeros((lcount, batch, max_len, cfg.n_kv_heads, dh), dtype=dt, device=dev),
        v=torch.zeros((lcount, batch, max_len, cfg.n_kv_heads, dh), dtype=dt, device=dev),
    )


def cache_axes(cfg: TransformerConfig) -> KVCache:
    """Logical axes of the cache (for shardings)."""
    if cfg.attention == "mla":
        return KVCache(ckv=(None, "batch", "kv_seq", None),
                       kpe=(None, "batch", "kv_seq", None))
    return KVCache(k=(None, "batch", "kv_seq", "kv_heads", None),
                   v=(None, "batch", "kv_seq", "kv_heads", None))


def decode_step(params: Transformer, cache: KVCache, tokens, pos: int, cfg: TransformerConfig,
                ctx: ParallelCtx):
    """One-token decode.  tokens: [B, 1] (ids indexed as
    :func:`gather_rows`); pos: the current length, a Python int.  Returns
    (logits f32[B, Vp], the padded vocabulary at f32-min; ``cache``,
    written in place at ``pos``)."""
    require_no_mesh(ctx, "decode_step")
    x = gather_rows(params.embed, tokens).to(torch_dtype(cfg.dtype))
    for i, bp in enumerate(params.blocks):
        h = L.rmsnorm(bp.ln1, x, cfg.norm_eps)
        if cfg.attention == "mla":
            att, _, _ = L.mla_decode(bp.attn, h, cache.ckv[i], cache.kpe[i], pos, cfg, ctx)
        else:
            att, _, _ = _gqa_decode_reshaped(bp.attn, h, cache.k[i], cache.v[i], pos, cfg, ctx)
        x = _block_mlp(bp, x + att, cfg, ctx)
    x = L.rmsnorm(params.ln_f, x, cfg.norm_eps)
    logits = (x[:, 0, :] @ _head_matrix(params, cfg)).float()
    vocab_mask = _vocab_mask(cfg, logits.device)
    if vocab_mask is not None:
        logits = logits.masked_fill_(~vocab_mask, torch.finfo(torch.float32).min)
    return logits, cache


def _gqa_decode_reshaped(ap, h, ck, cv, pos, cfg, ctx):
    # layers.gqa_decode expects [B, S, Hkv, Dh]: a layer's cache already is
    return L.gqa_decode(ap, h, ck, cv, pos, cfg, ctx)


def _block_mlp(bp: Block, x, cfg: TransformerConfig, ctx: ParallelCtx):
    """The block's second half: ``x + ffn(ln2(x))``, or with experts
    ``x + moe(ln2(x))`` (plus arctic's dense residual); aux dropped."""
    if cfg.is_moe:
        mo, _ = M.moe_apply(bp.moe, L.rmsnorm(bp.ln2, x, cfg.norm_eps), cfg, ctx)
        if cfg.dense_residual:
            mo = mo + L.swiglu_apply(bp.ffn, L.rmsnorm(bp.ln3, x, cfg.norm_eps))
        return x + mo
    return x + L.swiglu_apply(bp.ffn, L.rmsnorm(bp.ln2, x, cfg.norm_eps))


def prefill_step(params: Transformer, tokens, cfg: TransformerConfig, ctx: ParallelCtx):
    """Inference prefill: the full forward, returning the last position's
    logits (f32[B, Vp]; the padded vocabulary is not masked here, as in the
    reference).  The KV cache is not populated, as in the reference."""
    hidden, _ = backbone(params, tokens, cfg, ctx)
    return (hidden[:, -1, :] @ _head_matrix(params, cfg)).float()
