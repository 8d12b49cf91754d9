"""Causal LM transformer backbone: GQA / MLA attention blocks (counterpart
of ``repro/models/transformer.py``).

Five assigned architectures instantiate this module (qwen2.5-3b,
minicpm3-4b/MLA, smollm-360m, phi3.5-moe, arctic-480b).  In the
retrieval system these models are (a) dense encoders for k-NN candidate
generation and (b) cross-encoder re-rankers (the paper's CEDR
proxy-scorer role) — see ``repro_torch.models.encoder``.

The parameters live in ``nn.Module``s: a :class:`Block` per layer (the
reference's per-layer tree as ``nn.ParameterDict``s, in its einsum
layouts) in the ``nn.ModuleList`` of a :class:`Transformer`, where the
reference stacks the blocks on a leading layer axis and scans them.  A
config with experts (phi3.5-moe, arctic-480b) waits for the port of
``models/moe.py`` and raises ``NotImplementedError``.  The loss, the KV
cache and the decode / prefill steps wait for the launch slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import TransformerConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import ParallelCtx
from repro_torch.models import layers as L

__all__ = ["Block", "Transformer", "torch_dtype", "init_block", "init_transformer",
           "block_apply", "backbone", "gather_rows"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The tensor dtype a config's ``dtype`` string names."""
    return _DTYPES[name]


def _no_moe(cfg: TransformerConfig):
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name} has {cfg.n_experts} experts: the mixture-of-experts layer "
            "(models/moe.py) is not ported yet; use a configuration without experts")


def _parameter_dict(tree: dict) -> nn.ParameterDict:
    """Nested dict of tensors -> nested ``nn.ParameterDict``."""
    return nn.ParameterDict({k: _parameter_dict(v) if isinstance(v, dict) else v
                             for k, v in tree.items()})


class Block(nn.Module):
    """One layer's parameters under the reference's names: ``ln1``,
    ``attn``, ``ln2``, ``ffn`` (each an ``nn.ParameterDict``)."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, sub in tree.items():
            self.add_module(name, _parameter_dict(sub))


class Transformer(nn.Module):
    """The backbone's parameters: ``embed [Vp, d]``, ``blocks`` (one
    :class:`Block` per layer), ``ln_f`` and, untied, ``lm_head [d, Vp]``.
    Calling it runs :func:`backbone` on one device."""

    def __init__(self, cfg: TransformerConfig, embed: torch.Tensor, blocks, ln_f: dict,
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        _no_moe(cfg)
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
    _no_moe(cfg)
    dev = gen.device if device is None else device
    p, a = {}, {}
    p["ln1"], a["ln1"] = L.rmsnorm_init(cfg.d_model, dtype, dev)
    if cfg.attention == "mla":
        p["attn"], a["attn"] = L.mla_init(gen, cfg, dtype, dev)
    else:
        p["attn"], a["attn"] = L.gqa_init(gen, cfg, dtype, dev)
    p["ln2"], a["ln2"] = L.rmsnorm_init(cfg.d_model, dtype, dev)
    p["ffn"], a["ffn"] = L.swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype, dev)
    return p, a


def init_transformer(cfg: TransformerConfig, seed: int = 0, device=None) -> Tuple[Transformer, dict]:
    """Random weights with the reference's distributions and scales (embed
    and lm_head ``N(0, 0.02^2)``; dense layers ``N(0, 1/in_dim)``; norms 1;
    biases 0), drawn on ``device`` (None = the card) from a
    ``torch.Generator`` seeded with ``seed``.  Returns the model and the
    axes tree, whose blocks carry the reference's leading layer axis
    (``None``).  ``device="meta"`` gives shapes and dtypes only."""
    _no_moe(cfg)
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
    """One pre-norm block: ``x + attn(ln1(x))``, then ``+ ffn(ln2(.))``.
    Returns (x, aux), aux 0 (the MoE balance loss's place)."""
    _no_moe(cfg)
    attn_fn = L.mla_apply if cfg.attention == "mla" else L.gqa_apply
    x = x + attn_fn(bp.attn, L.rmsnorm(bp.ln1, x, cfg.norm_eps), positions, cfg, ctx)
    if cfg.seq_shard:
        x = ctx.constrain(x, "batch", "seq_act", None)
    x = x + L.swiglu_apply(bp.ffn, L.rmsnorm(bp.ln2, x, cfg.norm_eps))
    if cfg.seq_shard:
        x = ctx.constrain(x, "batch", "seq_act", None)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def backbone(params: Transformer, tokens, cfg: TransformerConfig, ctx: ParallelCtx):
    """Embed + all blocks + final norm.  Returns (hidden [B,S,d], aux);
    aux, the MoE balance loss's mean, is 0 without experts.  Runs where
    ``params`` and ``tokens`` live."""
    b, s = tokens.shape
    x = gather_rows(params.embed, tokens).to(torch_dtype(cfg.dtype))
    x = ctx.constrain(x, "batch", "seq_act", None)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    for bp in params.blocks:
        x, _ = block_apply(bp, x, positions, cfg, ctx)
    x = L.rmsnorm(params.ln_f, x, cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _head_matrix(params: Transformer, cfg: TransformerConfig) -> torch.Tensor:
    """[d, Vp]: the tied embedding's transpose, or ``lm_head``."""
    return params.embed.T if cfg.tie_embeddings else params.lm_head
