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

Under a mesh every rank calls each entry point with the same logical
arguments: parameters are ``DTensor``s placed by ``params_sharding`` (or
whole tensors), tokens and targets whole.  Each rank takes its blocks
(``collectives.rank_block``: a block's gradient is summed over the axes
along which the ranks that share it see different tokens) and runs
explicit per-rank code (``layers.RankPlan``): the vocabulary-parallel
embedding (the id wrapped and clamped before the range test, so an
out-of-range id lands where one device puts it), the blocks on sequence
blocks of the residual stream, and the loss's logsumexp over vocabulary
shards (a max and a sum-exp, each reduced over the vocabulary's axis; the
gold logit picked by the global range test and summed).  ``backbone``
returns the hidden states as a ``DTensor`` laid out as the reference's
``(batch, seq_act)`` constraint lays them out; the losses are replicated
scalars; ``prefill_step`` and ``decode_step`` return whole logits.  The
decode cache is a tree of ``DTensor``s (``init_cache(..., ctx=)``), split
as ``cache_axes`` says.  Without a mesh the same per-rank code runs on one
device: every axis of the plan is None, a rank's blocks are the whole
tensors and each collective is the identity.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import TransformerConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives as C
from repro_torch.distributed.mesh_utils import mesh_axis_size
from repro_torch.distributed.sharding import NamedSharding, ParallelCtx, block_slices
from repro_torch.models import layers as L
from repro_torch.models import moe as M

__all__ = ["Block", "Transformer", "torch_dtype", "init_block", "init_transformer",
           "block_apply", "backbone", "gather_rows", "chunked_ce_loss", "lm_loss", "KVCache",
           "init_cache", "cache_axes", "decode_step", "prefill_step", "gathered"]

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
    wraps once, then every id clamps to ``[0, n - 1]``.  The gradient of a
    row read through a clamp is dropped, as the transpose of JAX's gather
    (a scatter at the unclamped id, out of bounds) drops it."""
    n = table.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + n, ids)
    rows = table[ids.clamp(0, n - 1)]
    return _drop_clamped_grad(rows, (ids >= 0) & (ids < n))


def _drop_clamped_grad(rows: torch.Tensor, inside: torch.Tensor) -> torch.Tensor:
    """``rows`` unchanged; no gradient flows to those read for an id that
    was outside the table."""
    if not rows.requires_grad:
        return rows
    inside = inside.reshape(inside.shape + (1,) * (rows.dim() - inside.dim()))
    return torch.where(inside, rows, rows.detach())


def block_apply(bp: Block, x, positions, cfg: TransformerConfig, ctx: ParallelCtx):
    """One pre-norm block: ``x + attn(ln1(x))``, then ``+ ffn(ln2(.))`` or,
    with experts, ``+ moe(ln2(.))`` (plus ``ffn(ln3(.))`` with a dense
    residual).  Returns (x, aux): the MoE balance loss, 0 without experts.
    Under a mesh, ``x`` (a ``DTensor`` or a whole tensor) and ``positions``
    ``[B, S]`` are the logical arguments; ``x`` comes back as it came."""
    plan = L.RankPlan.of(ctx)
    sh = _stream_sharding(plan)
    b, sq, _ = x.shape
    _check_even(plan, b, sq)
    b0, bl = plan.block(b, plan.batch)
    axes = _block_axes(cfg) if ctx.mesh is not None else None
    y, aux = _block_rank(_rank_tree(bp, axes, ctx), C.rank_block(x, sh), positions[b0:b0 + bl], cfg, ctx, plan,
                         tuple(x.shape))
    if isinstance(x, DTensor):
        return _as_dtensor(y, sh, x.shape), aux
    return C.from_blocks(y, sh, x.shape), aux


def backbone(params: Transformer, tokens, cfg: TransformerConfig, ctx: ParallelCtx):
    """Embed + all blocks + final norm.  Returns (hidden [B,S,d], aux), aux
    the MoE balance loss summed over the layers and divided by their count
    (0 without experts).  Runs where ``params`` and ``tokens`` live.  With
    ``cfg.remat`` and grad enabled, each block is rematerialised (the
    reference's ``jax.checkpoint`` of the layer body): only its input is
    kept, and the backward runs it again, routing MoE tokens as the first
    pass did (``select_topk`` is deterministic).  Under a mesh the hidden
    states come back as a ``DTensor`` split over ``(batch, seq_act)``."""
    plan = L.RankPlan.of(ctx)
    tokens = gathered(tokens)
    x, aux = _backbone_rank(_rank_view(params, cfg, ctx), tokens, cfg, ctx, plan)
    return _as_dtensor(x, _stream_sharding(plan), (*tokens.shape, cfg.d_model)), aux


def _vocab_mask(cfg: TransformerConfig, device) -> Optional[torch.Tensor]:
    """True for the real vocabulary's columns, None when nothing is padded."""
    if cfg.padded_vocab == cfg.vocab_size:
        return None
    return torch.arange(cfg.padded_vocab, device=device) < cfg.vocab_size


def chunked_ce_loss(params: Transformer, hidden, targets, cfg: TransformerConfig,
                    ctx: ParallelCtx, chunk: int = 512):
    """Mean cross entropy without materialising [B, S, V]: sequence chunks
    of ``chunk`` positions, each chunk's logits (``h @ head`` rounded to the
    model dtype, then f32; the padded vocabulary masked at f32-min) and
    logsumexp, summed in f32.  With grad enabled each chunk is recomputed
    in the backward, so at most one chunk's logits are ever live.  A
    target wraps once if negative, and one still outside ``[0, Vp)`` reads
    NaN (``jnp.take_along_axis``'s fill).  Under a mesh the logits are
    vocabulary-parallel (``hidden`` a ``DTensor`` or a whole tensor), and
    the loss a scalar that every rank holds."""
    plan = L.RankPlan.of(ctx)
    view = _rank_view(params, cfg, ctx, blocks=False)
    return _ce_rank(view.head, C.rank_block(hidden, _stream_sharding(plan)), gathered(targets), cfg, plan, chunk)


def lm_loss(params: Transformer, batch, cfg: TransformerConfig, ctx: ParallelCtx,
            aux_weight: float = 0.01):
    """(ce + aux_weight * aux, {"ce": ce, "aux": aux}) of ``batch``'s
    ``tokens`` against its ``targets``.  Under a mesh every rank takes its
    parameter blocks once for both halves and holds the same loss."""
    plan = L.RankPlan.of(ctx)
    view = _rank_view(params, cfg, ctx)
    hidden, aux = _backbone_rank(view, gathered(batch["tokens"]), cfg, ctx, plan)
    loss = _ce_rank(view.head, hidden, gathered(batch["targets"]), cfg, plan)
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# Decode with KV cache.
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: Optional[torch.Tensor] = None      # [L, B, S, Hkv, Dh]     (GQA)
    v: Optional[torch.Tensor] = None
    ckv: Optional[torch.Tensor] = None    # [L, B, S, kv_lora]     (MLA)
    kpe: Optional[torch.Tensor] = None    # [L, B, S, rope_dim]


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, device=None,
               ctx: Optional[ParallelCtx] = None) -> KVCache:
    """A zeroed cache in the model dtype on ``device`` (None = the card).
    GQA decode attends in chunks of ``min(attn_chunk_kv, max_len)``, which
    must divide ``max_len`` (asserted there, as the reference's
    ``flash_attention`` asserts it).  With a mesh in ``ctx`` every field
    is a ``DTensor`` split by :func:`cache_axes`' rules, of which each
    rank allocates its block alone."""
    if ctx is not None and ctx.mesh is not None:
        whole = init_cache(cfg, batch, max_len, "meta")
        dev = resolve_device(device)
        out = {}
        for name, axes in cache_axes(cfg)._asdict().items():
            like = getattr(whole, name)
            if like is None:
                continue
            sh = ctx.sharding(*axes)
            local = torch.zeros([n for _, n in block_slices(like.shape, sh)], dtype=like.dtype, device=dev)
            out[name] = _as_dtensor(local, sh, like.shape)
        return KVCache(**out)
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
    written in place at ``pos``).  Under a mesh (the decode rules of
    ``launch.steps.rules_for_shape``: weights split on ``"embed"``, the
    cache's sequence on ``"kv_seq"``) the cache is ``init_cache(...,
    ctx=)``'s and the logits come back whole on every rank."""
    return _decode_rank(params, cache, gathered(tokens), pos, cfg, ctx), cache


def prefill_step(params: Transformer, tokens, cfg: TransformerConfig, ctx: ParallelCtx):
    """Inference prefill: the full forward, returning the last position's
    logits (f32[B, Vp]; the padded vocabulary is not masked here, as in the
    reference).  The KV cache is not populated, as in the reference.
    Under a mesh the logits come back whole on every rank."""
    plan = L.RankPlan.of(ctx)
    tokens = gathered(tokens)
    view = _rank_view(params, cfg, ctx)
    x, _ = _backbone_rank(view, tokens, cfg, ctx, plan)
    last = x[:, -1:]
    if plan.seq is not None:    # the last position sits in the last sequence block
        last = C.gather_axis(last, plan.mesh, plan.seq, 1)[:, -1:]
    logits = (last[:, 0] @ view.head).float()
    return C.gather_full(logits, _sharding(plan, plan.batch, plan.vocab), (tokens.shape[0], cfg.padded_vocab))


# ---------------------------------------------------------------------------
# Per-rank code: under a mesh each rank's blocks; without one, the whole
# tensors (every axis of the plan None, every collective the identity).
# ---------------------------------------------------------------------------

def gathered(x):
    """A ``DTensor`` (hidden states, a parameter) as the whole tensor on
    every rank, under autograd (its gradient the logical one on every
    rank); any other tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    sh = NamedSharding.of(x)
    return C.from_blocks(C.rank_block(x, sh), sh, x.shape)


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _sharding(plan: L.RankPlan, *spec) -> Optional[NamedSharding]:
    """``spec`` on the plan's mesh (None without a mesh)."""
    return None if plan.mesh is None else NamedSharding(plan.mesh, spec)


def _as_dtensor(local: torch.Tensor, sharding: Optional[NamedSharding], shape):
    """``local`` as this rank's block of a ``DTensor`` of ``shape`` laid out
    by ``sharding``; ``local`` itself without a sharding."""
    if sharding is None:
        return local
    stride = torch.empty(tuple(shape), device="meta").stride()
    return DTensor.from_local(local, sharding.mesh, sharding.placements, run_check=False, shape=torch.Size(shape),
                              stride=stride)


def _stream_sharding(plan: L.RankPlan) -> Optional[NamedSharding]:
    """The residual stream's layout: ``(batch, seq_act, None)``."""
    return _sharding(plan, plan.batch, plan.seq, None)


def _check_even(plan: L.RankPlan, b: int, s: int):
    for n, axes, what in ((b, plan.batch, "batch"), (s, plan.seq, "sequence")):
        if axes is not None and n % mesh_axis_size(plan.mesh, axes):
            raise ValueError(f"a {what} of {n} does not split evenly over {axes!r}")


def _block_axes(cfg: TransformerConfig) -> dict:
    """One block's logical axes tree (shapes on the meta device: nothing is
    drawn)."""
    return init_block(torch.Generator(), cfg, torch_dtype(cfg.dtype), "meta")[1]


def _rank_tree(node, axes, ctx: ParallelCtx):
    """A block's parameters as this rank's blocks (nested dicts in the
    reference's names); the MoE subtree stays as given: ``moe_apply``
    takes ``DTensor``s or whole tensors itself.  The block itself without
    a mesh."""
    if ctx.mesh is None:
        return node
    if isinstance(node, Block):
        return SimpleNamespace(**{name: sub if name == "moe" else _rank_tree(sub, axes[name], ctx)
                                  for name, sub in node.named_children()})
    if isinstance(node, torch.Tensor):
        return C.rank_block(node, ctx.sharding(*axes), deferred=ctx.deferred)
    return {k: _rank_tree(v, axes[k], ctx) for k, v in node.items()}


def _rank_view(params: Transformer, cfg: TransformerConfig, ctx: ParallelCtx, blocks: bool = True):
    """This rank's blocks of every parameter, taken once (so that each
    block's gradient is summed once), with ``head``, the output head's."""
    def block(x, *axes):
        return C.rank_block(x, ctx.sharding(*axes), deferred=ctx.deferred)

    embed = block(params.embed, "vocab", "embed")
    lm_head = None if params.lm_head is None else block(params.lm_head, "embed", "vocab")
    axes = _block_axes(cfg) if blocks and ctx.mesh is not None else None
    return SimpleNamespace(
        embed=embed, lm_head=lm_head, head=embed.T if cfg.tie_embeddings else lm_head,
        blocks=[_rank_tree(bp, axes, ctx) for bp in params.blocks] if blocks else None,
        ln_f={"scale": block(params.ln_f["scale"], "embed")})


def _embed_rank(embed, tokens, cfg: TransformerConfig, plan: L.RankPlan):
    """The vocabulary-parallel lookup of ``tokens [B_loc, S]`` -> this
    rank's block of the stream: each rank's rows for the ids in its range
    (the global id wrapped and clamped first, as :func:`gather_rows` reads
    it, and its gradient dropped where it was clamped), zeros elsewhere,
    summed over the vocabulary's axis into sequence blocks."""
    if plan.vocab is None:
        return plan.reduce_seq(gather_rows(embed, tokens), None)
    n = cfg.padded_vocab
    ids = tokens.long()
    ids = torch.where(ids < 0, ids + n, ids)
    valid = (ids >= 0) & (ids < n)
    ids = ids.clamp(0, n - 1)
    v0, vl = plan.block(n, plan.vocab)
    inside = (ids >= v0) & (ids < v0 + vl)
    rows = _drop_clamped_grad(embed[torch.where(inside, ids - v0, 0)], valid)
    rows = torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    return plan.reduce_seq(rows, plan.vocab)


def _block_rank(bp, x, positions, cfg: TransformerConfig, ctx: ParallelCtx, plan: L.RankPlan, shape):
    """:func:`block_apply` on this rank's blocks: ``x [B_loc, S_loc, d]``
    (the stream of logical ``shape``), ``positions [B_loc, S]``."""
    attn_fn = L.mla_apply if cfg.attention == "mla" else L.gqa_apply
    x = x + attn_fn(bp.attn, L.rmsnorm(bp.ln1, x, cfg.norm_eps), positions, cfg, ctx)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.is_moe:
        h = _as_dtensor(L.rmsnorm(bp.ln2, x, cfg.norm_eps), _stream_sharding(plan), shape)
        mo, aux = M.moe_apply(bp.moe, h, cfg, ctx)
        mo = _local(mo)
        if cfg.dense_residual:
            mo = mo + L.swiglu_apply(bp.ffn, L.rmsnorm(bp.ln3, x, cfg.norm_eps), ctx)
        return x + mo, aux
    return x + L.swiglu_apply(bp.ffn, L.rmsnorm(bp.ln2, x, cfg.norm_eps), ctx), aux


def _backbone_rank(view, tokens, cfg: TransformerConfig, ctx: ParallelCtx, plan: L.RankPlan):
    """(this rank's block of the final-normed stream, the mean aux)."""
    b, s = tokens.shape
    _check_even(plan, b, s)
    b0, bl = plan.block(b, plan.batch)
    x = _embed_rank(view.embed, tokens[b0:b0 + bl], cfg, plan).to(torch_dtype(cfg.dtype))
    positions = torch.arange(s, device=tokens.device).expand(bl, s)
    shape = (b, s, cfg.d_model)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for bp in view.blocks:
        if remat:
            x, a = checkpoint(_block_rank, bp, x, positions, cfg, ctx, plan, shape, use_reentrant=False)
        else:
            x, a = _block_rank(bp, x, positions, cfg, ctx, plan, shape)
        aux = aux + a
    return L.rmsnorm(view.ln_f, x, cfg.norm_eps), aux / cfg.n_layers


def _ce_rank(head, hidden, targets, cfg: TransformerConfig, plan: L.RankPlan, chunk: int = 512):
    """:func:`chunked_ce_loss` on this rank's blocks: ``hidden [B_loc,
    S_loc, d]``, ``head [d, V_loc]``; the whole ``targets [B, S]``."""
    b, s = targets.shape
    b0, bl = plan.block(b, plan.batch)
    split = C.axis_names(plan.batch)
    if plan.vocab is not None:
        # every vocabulary shard needs every position of its batch block
        plan.require(plan.seq in (None, plan.vocab), "chunked_ce_loss")
        h, t = plan.gather_seq(hidden), targets[b0:b0 + bl]
    else:
        s0, sl = plan.block(s, plan.seq)
        h, t = hidden, targets[b0:b0 + bl, s0:s0 + sl]
        split += C.axis_names(plan.seq)
    v0, vl = plan.block(cfg.padded_vocab, plan.vocab)
    pad = None
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(v0, v0 + vl, device=h.device) >= cfg.vocab_size
    n = h.shape[1]
    c = min(chunk, n)
    assert n % c == 0
    recompute = torch.is_grad_enabled() and (h.requires_grad or head.requires_grad)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo in range(0, n, c):
        args = (h[:, lo:lo + c], head, t[:, lo:lo + c], pad, v0, cfg.padded_vocab, plan)
        total = total + (checkpoint(_ce_chunk, *args, use_reentrant=False) if recompute
                         else _ce_chunk(*args))
    return C.all_sum(total, plan.mesh, split) / (b * s)


def _ce_chunk(h, head, t, pad=None, v0: int = 0, vp: Optional[int] = None, plan: Optional[L.RankPlan] = None):
    """Summed ``logsumexp - gold`` of one chunk's logits ``h @ head`` (the
    columns ``pad`` marks at f32-min).  Under a mesh ``head`` holds the
    vocabulary's columns from ``v0`` of ``vp``: the max and the sum-exp are
    reduced over the vocabulary's axis, and the gold logit comes from the
    shard whose range holds the target (:func:`_take_target`)."""
    plan = plan or L.RankPlan.of(None)
    mesh, axis = plan.mesh, plan.vocab
    logits = (h @ head).float()
    if pad is not None:
        logits = logits.masked_fill_(pad, torch.finfo(torch.float32).min)
    m = C.all_max(logits.amax(dim=-1), mesh, axis)
    lse = m + torch.log(C.all_sum(torch.exp(logits - m[..., None]).sum(dim=-1), mesh, axis))
    return torch.sum(lse - C.all_sum(_take_target(logits, t, v0, vp), mesh, axis))


def _take_target(logits: torch.Tensor, t: torch.Tensor, v0: int = 0, vp: Optional[int] = None) -> torch.Tensor:
    """``jnp.take_along_axis(logits, t[..., None], axis=-1)[..., 0]`` from
    the columns ``[v0, v0 + n)`` of a vocabulary of ``vp`` (default: all of
    it) that ``logits [..., n]`` hold: a negative target wraps once, one
    still outside ``[0, Vp)`` reads NaN (JAX's fill), and one in another
    rank's columns reads 0."""
    vp = logits.shape[-1] if vp is None else vp
    t = t.long()
    t = torch.where(t < 0, t + vp, t)
    mine = (t >= v0) & (t < v0 + logits.shape[-1])
    gold = torch.gather(logits, -1, torch.where(mine, t - v0, 0)[..., None])[..., 0]
    gold = torch.where(mine, gold, torch.zeros((), dtype=gold.dtype, device=gold.device))
    return torch.where((t >= 0) & (t < vp), gold, torch.nan)


def _norm_block(scale, x, eps: float, d0: int):
    """``rmsnorm`` of the whole ``x [..., d]``, this rank's ``d`` block of it
    (from ``d0``) times the block ``scale`` of the norm's scale."""
    dt = x.dtype
    xf = x.float()
    xn = (xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)).to(dt)
    if scale.shape[0] != x.shape[-1]:
        xn = xn.narrow(-1, d0, scale.shape[0])
    return xn * scale


def _decode_rank(params: Transformer, cache: KVCache, tokens, pos: int, cfg: TransformerConfig,
                 ctx: ParallelCtx) -> torch.Tensor:
    """:func:`decode_step` under the decode rules: the stream ``[B_loc, 1, d]``
    whole on every rank of the ``"embed"`` axis; each norm gives this rank's
    ``d`` block, each product over ``d`` a partial sum; the layers' ``d``
    blocks are all-gathered back into the stream."""
    plan = L.RankPlan.of(ctx)
    L._decode_plan_ok(plan, "decode_step")
    for name in KVCache._fields:
        if ctx.mesh is not None and getattr(cache, name) is not None and not isinstance(getattr(cache, name),
                                                                                          DTensor):
            raise TypeError(f"cache.{name}: decode_step under a mesh takes init_cache(..., ctx=)'s DTensors")
    mesh, e = plan.mesh, plan.embed
    view = _rank_view(params, cfg, ctx)
    b = tokens.shape[0]
    _check_even(plan, b, 1)
    b0, bl = plan.block(b, plan.batch)
    d0, _ = plan.block(cfg.d_model, e)
    eps = cfg.norm_eps

    def whole_d(y):
        return C.gather_axis(y, mesh, e, y.dim() - 1) if e is not None else y

    x = whole_d(gather_rows(view.embed, tokens[b0:b0 + bl])).to(torch_dtype(cfg.dtype))
    for i, bp in enumerate(view.blocks):
        h = _norm_block(bp.ln1["scale"], x, eps, d0)
        if cfg.attention == "mla":
            att, _, _ = L.mla_decode(bp.attn, h, _local(cache.ckv)[i], _local(cache.kpe)[i], pos, cfg, ctx)
        else:
            att, _, _ = L.gqa_decode(bp.attn, h, _local(cache.k)[i], _local(cache.v)[i], pos, cfg, ctx)
        x = x + whole_d(att)
        if cfg.is_moe:
            h = whole_d(_norm_block(bp.ln2["scale"], x, eps, d0))
            mo, _ = M.moe_apply(bp.moe, _as_dtensor(h, _stream_sharding(plan), (b, 1, cfg.d_model)), cfg, ctx)
            mo = _local(mo)
            if cfg.dense_residual:
                mo = mo + whole_d(L.swiglu_apply(bp.ffn, _norm_block(bp.ln3["scale"], x, eps, d0), ctx))
            x = x + mo
        else:
            x = x + whole_d(L.swiglu_apply(bp.ffn, _norm_block(bp.ln2["scale"], x, eps, d0), ctx))
    h = _norm_block(view.ln_f["scale"], x, eps, d0)
    logits = C.all_sum(h[:, 0, :] @ view.head, mesh, e).float()
    vocab_mask = _vocab_mask(cfg, logits.device)
    if vocab_mask is not None:
        logits = logits.masked_fill_(~vocab_mask, torch.finfo(torch.float32).min)
    return C.gather_full(logits, _sharding(plan, plan.batch, None), (b, cfg.padded_vocab))
