"""Composable transformer layers: norms, SwiGLU, RoPE, GQA + MLA attention
(counterpart of ``repro/models/layers.py``).

``init_*`` returns ``(params, axes)``: two parallel nested dicts, the
first of tensors, the second of *logical axis names* per parameter dim
(see ``repro_torch.distributed.sharding``).  Draws come from an explicit
``torch.Generator`` with the reference's distributions and scales; they
cannot reproduce ``jax.random``, so parity with ``repro`` goes through
``interop.transformer_params``, never through equal draws.  The apply
functions take any mapping of tensors (a dict, an ``nn.ParameterDict``)
in the reference's einsum layouts (``wq [d, h, dh]``, ``wo [h, dh, d]``)
and a ``ParallelCtx``.

Attention is the reference's chunked online-softmax ("flash")
formulation in plain PyTorch, with its arithmetic: ``q`` scaled in its
own dtype, f32 scores and probabilities, masks at f32-min (not -inf),
the probabilities cast to ``v``'s dtype before the PV product (which
accumulates in f32), the output divided by ``max(l, 1e-30)``.  A bf16
product with an f32 result is taken as an f32 product of the widened
operands: a product of two bf16 values is exact in f32.  Head-count
padding multiplies padded heads by a zero mask, so semantics match the
unpadded model exactly.  Under autograd the attention keeps the
reference's memory contract (its ``jax.checkpoint`` of the tile body): a
``torch.autograd.Function`` saves q, k, v, the output and the rows' max
and sum, and its backward recomputes each tile (:class:`_FlashAttention`).

The decode forms write the step's key and value (or MLA latents) into
the caller's cache *in place* and return it, where the reference returns
a new array: a copy of a decode-length cache every step is no option.
The write position clamps as ``jax.lax.dynamic_update_slice`` clamps it
(a negative one wrapped once, then into ``[0, Smax - 1]``), while RoPE and
the valid length take the unclamped ``pos``.  GQA decode attends per KV
group (:func:`decode_attention`), never materialising the reference's
``jnp.repeat`` of the cache, and stops after the last chunk that holds a
valid key; a chunk past it would leave the online softmax's state bit for
bit unchanged.

Under a mesh (a ``ParallelCtx`` with a ``DeviceMesh``) the apply functions
are per-rank code, Megatron-style: ``params`` and ``x`` are this rank's
blocks, laid out by the context's rules (:class:`RankPlan`).  The residual
stream ``x [B_loc, S_loc, d]`` is split over the batch and ``seq_act``
axes; attention and the FFN all-gather the sequence, compute this rank's
heads (``"heads"``) or FFN columns (``"ff"``), and reduce-scatter their
row-parallel products back to sequence blocks (a sum, then a slice, where
the two axes differ).  The replicated ``wk``/``wv`` give every KV head; a
rank keeps the groups its q heads read.  Head padding is masked by global
head index.  The decode forms take the decode rules (weights split on
``"embed"``, the cache's sequence on ``"kv_seq"``): the products over a
split ``d`` are partial sums, summed over its axis, and attention
combines each rank's running max, sum and accumulator over the cache's
axis.  Without a mesh the same code runs with every axis ``None``: a
rank's block is then the whole tensor and each collective the identity.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import TransformerConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed.mesh_utils import mesh_axis_size
from repro_torch.distributed.sharding import ParallelCtx, axis_block

__all__ = ["dense_init", "rmsnorm_init", "rmsnorm", "apply_rope", "flash_attention",
           "gqa_init", "gqa_apply", "decode_attention", "gqa_decode", "mla_init", "mla_apply",
           "mla_decode", "swiglu_init", "swiglu_apply", "RankPlan"]


@dataclasses.dataclass(frozen=True)
class RankPlan:
    """The mesh axes that the per-rank code of a ``ParallelCtx`` splits
    each logical dim over (a name, a tuple of names, or None)."""

    mesh: object
    batch: object
    seq: object
    heads: object
    kv_heads: object
    ff: object
    vocab: object
    embed: object
    kv_seq: object

    @classmethod
    def of(cls, ctx: Optional[ParallelCtx]) -> "RankPlan":
        """The plan of ``ctx``'s mesh and rules (every axis None without a
        mesh, or without a ``ctx``)."""
        if ctx is None or ctx.mesh is None:
            return _ONE_DEVICE
        a = ctx.mesh_axes
        return cls(ctx.mesh, a("batch"), a("seq_act"), a("heads"), a("kv_heads"), a("ff"), a("vocab"),
                   a("embed"), a("kv_seq"))

    def block(self, n: int, axes) -> Tuple[int, int]:
        """(global start, length) of this rank's block of a dim of ``n``."""
        return axis_block(n, self.mesh, axes)

    def gather_seq(self, x: torch.Tensor) -> torch.Tensor:
        """[B, S_loc, d] -> [B, S, d] (under autograd)."""
        return C.gather_axis(x, self.mesh, self.seq, 1) if self.seq is not None else x

    def reduce_seq(self, y: torch.Tensor, inner) -> torch.Tensor:
        """``y [B, S, d]`` over the whole sequence, a partial sum over the
        axes ``inner`` (None: complete) -> this rank's sequence block of the
        sum: a reduce-scatter where both are one axis, else a sum over
        ``inner`` and a slice."""
        if inner is not None and inner == self.seq:
            return C.scatter_axis(y, self.mesh, inner, 1)
        if inner is not None:
            y = C.all_sum(y, self.mesh, inner)
        if self.seq is not None:
            lo, n = self.block(y.shape[1], self.seq)
            y = y.narrow(1, lo, n)
        return y

    def require(self, ok: bool, what: str):
        if not ok:
            raise ValueError(f"{what}: the per-rank code does not take these rules ({self})")


_ONE_DEVICE = RankPlan(*(None,) * 9)


# ---------------------------------------------------------------------------
# Param init helpers.
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, scale: float, dtype, device=None) -> torch.Tensor:
    """f32 standard normal draws times ``scale``, cast to ``dtype``, on
    ``device`` (default: the generator's; a CPU generator serves the
    ``meta`` device, which draws nothing)."""
    device = gen.device if device is None else device
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


def dense_init(gen, in_dim: int, out_shape: Tuple[int, ...], axes, dtype, device=None):
    shape = (in_dim, *out_shape)
    return _normal(gen, shape, 1.0 / math.sqrt(in_dim), dtype, device), axes


# ---------------------------------------------------------------------------
# Norms.
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, device=None) -> Tuple[dict, dict]:
    return {"scale": torch.ones(d, dtype=dtype, device=device)}, {"scale": ("embed",)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalised in f32, cast back to ``x``'s dtype, then scaled in it."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * params["scale"]


# ---------------------------------------------------------------------------
# RoPE.
# ---------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, D] (D even), positions: [B, S] or [S].  Half-split
    rotation (the first half of D pairs with the second), in f32."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs                   # [B, S, D/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Chunked (flash-style) attention — plain PyTorch online softmax.
# ---------------------------------------------------------------------------

def flash_attention(
    q: torch.Tensor,            # [B, Sq, H, Dk]
    k: torch.Tensor,            # [B, Skv, H, Dk]
    v: torch.Tensor,            # [B, Skv, H, Dv]
    *,
    causal: bool = True,
    q_offset: int = 0,
    chunk_q: int = 1024,
    chunk_kv: int = 1024,
    kv_valid_len: Optional[torch.Tensor] = None,   # [B]: mask keys >= this
) -> torch.Tensor:
    """Chunked online-softmax attention.  Under autograd the backward keeps
    the reference's memory contract (its ``jax.checkpoint`` of the tile
    body): no ``[cq, ckv]`` score or probability tile is saved; the
    backward recomputes each tile from the saved q, k, v, the output and
    the rows' max and sum (:class:`_FlashAttention`)."""
    b, sq, h, dk = q.shape
    skv = k.shape[1]
    cq = min(chunk_q, sq)
    ckv = min(chunk_kv, skv)
    assert sq % cq == 0 and skv % ckv == 0, (sq, cq, skv, ckv)
    # the scale rounded to q's dtype first, as JAX rounds a Python scalar
    # into a bf16 product (rounded on the host: no copy to the card)
    q = q * torch.tensor(1.0 / math.sqrt(dk), dtype=q.dtype).item()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, q_offset, cq, ckv, kv_valid_len)
    return _flash_forward(q, k, v, causal, q_offset, cq, ckv, kv_valid_len)[0]


def _tile_scores(qc, kc, qpos, kpos, causal, kv_valid_len):
    """f32 scores ``[B, H, cq, ckv]`` of one tile, masked at f32-min."""
    neg = torch.finfo(torch.float32).min
    s = torch.einsum("bqhd,bkhd->bhqk", qc, kc)
    if causal:
        s = s.masked_fill_(qpos[:, None] < kpos[None, :], neg)
    if kv_valid_len is not None:
        s = s.masked_fill_(kpos[None, None, None, :] >= kv_valid_len[:, None, None, None], neg)
    return s


def _flash_forward(q, k, v, causal, q_offset, cq, ckv, kv_valid_len):
    """(out [B, Sq, H, Dv] in v's dtype, the rows' running max m and sum l,
    each f32 [B, H, Sq]) of the scaled ``q``."""
    b, sq, h, _ = q.shape
    skv, dv = k.shape[1], v.shape[-1]
    nq, nk = sq // cq, skv // ckv
    dev = q.device
    outs, ms, ls = [], [], []
    for qi in range(nq):
        qc = q[:, qi * cq:(qi + 1) * cq].float()
        qpos = q_offset + qi * cq + torch.arange(cq, device=dev)
        m = torch.full((b, h, cq), -torch.inf, device=dev)
        l = torch.zeros((b, h, cq), device=dev)
        acc = torch.zeros((b, h, cq, dv), device=dev)
        for ki in range(nk):
            kc = k[:, ki * ckv:(ki + 1) * ckv].float()
            vc = v[:, ki * ckv:(ki + 1) * ckv]
            s = _tile_scores(qc, kc, qpos, ki * ckv + torch.arange(ckv, device=dev), causal, kv_valid_len)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(v.dtype).float(), vc.float())
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.permute(0, 2, 1, 3).to(v.dtype))          # [B, cq, H, Dv]
        ms.append(m)
        ls.append(l)
    if nq == 1:
        return outs[0], ms[0], ls[0]
    return torch.cat(outs, dim=1), torch.cat(ms, dim=-1), torch.cat(ls, dim=-1)


class _FlashAttention(torch.autograd.Function):
    """Attention whose backward recomputes every tile.  Saved: the scaled
    q, k, v, the output and the rows' max m and sum l (f32 ``[B, H, Sq]``).
    The backward walks the tiles as the forward does: ``P = exp(s - m) / l``
    (the forward's probabilities, so a masked key gets exactly 0),
    ``dV += P^T dO``, ``dS = P * (dO V^T - rowsum(dO * O))``, ``dQ += dS K``,
    ``dK += dS^T Q``, all in f32.  A causal tile above the diagonal has
    ``P = 0`` and is skipped.  The forward rounds P to v's dtype before the
    PV product; the backward takes that rounding's derivative as 1, as
    JAX's ``astype`` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, cq, ckv, kv_valid_len):
        out, m, l = _flash_forward(q, k, v, causal, q_offset, cq, ckv, kv_valid_len)
        ctx.save_for_backward(q, k, v, out, m, l, kv_valid_len)
        ctx.plan = (causal, q_offset, cq, ckv)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l, kv_valid_len = ctx.saved_tensors
        causal, q_offset, cq, ckv = ctx.plan
        sq, skv = q.shape[1], k.shape[1]
        dev = q.device
        dq = torch.empty(q.shape, dtype=torch.float32, device=dev)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=dev)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=dev)
        for q0 in range(0, sq, cq):
            qs = slice(q0, q0 + cq)
            qc, do = q[:, qs].float(), dout[:, qs].float()
            qpos = q_offset + q0 + torch.arange(cq, device=dev)
            rows = torch.einsum("bqhd,bqhd->bhq", do, out[:, qs].float())   # rowsum(dO * O)
            mi, inv_l = m[..., qs, None], 1.0 / torch.clamp_min(l[..., qs, None], 1e-30)
            dqc = torch.zeros(qc.shape, dtype=torch.float32, device=dev)
            for k0 in range(0, skv, ckv):
                if causal and q_offset + q0 + cq - 1 < k0:
                    continue                                   # every key of the tile is masked
                ks = slice(k0, k0 + ckv)
                kc, vc = k[:, ks].float(), v[:, ks].float()
                s = _tile_scores(qc, kc, qpos, k0 + torch.arange(ckv, device=dev), causal, kv_valid_len)
                p = torch.exp(s.sub_(mi)).mul_(inv_l)          # [B, H, cq, ckv]
                dv[:, ks] += torch.einsum("bhqk,bqhd->bkhd", p, do)
                ds = p.mul_(torch.einsum("bqhd,bkhd->bhqk", do, vc).sub_(rows[..., None]))
                dqc += torch.einsum("bhqk,bkhd->bqhd", ds, kc)
                dk[:, ks] += torch.einsum("bhqk,bqhd->bkhd", ds, qc)
            dq[:, qs] = dqc
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, None


# ---------------------------------------------------------------------------
# GQA attention (with optional QKV bias — qwen2.5).
# ---------------------------------------------------------------------------

def gqa_init(gen, cfg: TransformerConfig, dtype, device=None):
    d, dh = cfg.d_model, cfg.resolved_head_dim
    hp, hkv = cfg.padded_heads, cfg.n_kv_heads
    dev = gen.device if device is None else device
    p, a = {}, {}
    p["wq"], a["wq"] = dense_init(gen, d, (hp, dh), ("embed", "heads", None), dtype, dev)
    p["wk"], a["wk"] = dense_init(gen, d, (hkv, dh), ("embed", "kv_heads", None), dtype, dev)
    p["wv"], a["wv"] = dense_init(gen, d, (hkv, dh), ("embed", "kv_heads", None), dtype, dev)
    p["wo"], _ = dense_init(gen, hp * dh, (d,), None, dtype, dev)
    p["wo"] = p["wo"].reshape(hp, dh, d)
    a["wo"] = ("heads", None, "embed")
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hp, dh), dtype=dtype, device=dev); a["bq"] = ("heads", None)
        p["bk"] = torch.zeros((hkv, dh), dtype=dtype, device=dev); a["bk"] = ("kv_heads", None)
        p["bv"] = torch.zeros((hkv, dh), dtype=dtype, device=dev); a["bv"] = ("kv_heads", None)
    return p, a


def _head_mask(cfg: TransformerConfig, dtype, device=None) -> Optional[torch.Tensor]:
    """Zero-mask for TP head padding.  GQA pads *within each KV group* so
    the padded head -> KV group mapping (h // group_size) matches the
    unpadded model exactly: real head (g, w) sits at g*gpad + w."""
    hp = cfg.padded_heads
    if hp == cfg.n_heads:
        return None
    heads = torch.arange(hp, device=device)
    if cfg.attention == "mla":
        return (heads < cfg.n_heads).to(dtype)
    hkv = cfg.n_kv_heads
    assert hp % hkv == 0, f"pad_heads_to {hp} must be a multiple of kv heads {hkv}"
    gpad = hp // hkv
    rep_real = cfg.n_heads // hkv
    return ((heads % gpad) < rep_real).to(dtype)


def _attend_out(params, out, cfg: TransformerConfig, h0: int = 0) -> torch.Tensor:
    """Padded heads zeroed (``out`` holds the heads from global index
    ``h0`` on), then the output projection ``wo [h, dv, d]``."""
    hm = _head_mask(cfg, out.dtype, out.device)
    if hm is not None:
        out = out * hm[h0:h0 + out.shape[2]][None, None, :, None]
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])


def gqa_apply(params, x, positions, cfg: TransformerConfig, ctx: ParallelCtx,
              causal=True, q_offset=0):
    """Training/prefill attention over full sequences.  Under a mesh,
    ``params`` and ``x`` are this rank's blocks and ``positions [B_loc, S]``
    the whole sequence's (see the module's docstring)."""
    plan = RankPlan.of(ctx)
    plan.require(plan.kv_heads is None and plan.embed is None, "gqa_apply")
    hp, hkv = cfg.padded_heads, cfg.n_kv_heads
    h0, hl = plan.block(hp, plan.heads)
    xf = plan.gather_seq(x)
    q = torch.einsum("bsd,dhk->bshk", xf, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", xf, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", xf, params["wv"])
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    # jnp.repeat's head h reads KV head h // rep: keep this rank's heads' groups
    groups = torch.div(torch.arange(h0, h0 + hl, device=x.device), hp // hkv, rounding_mode="floor")
    k, v = k.index_select(2, groups), v.index_select(2, groups)
    out = flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                          chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv)
    return plan.reduce_seq(_attend_out(params, out, cfg, h0), plan.heads)


def _write_slot(pos: int, smax: int) -> int:
    """Where ``dynamic_update_slice_in_dim`` writes a one-row update at
    ``pos``: a negative start wraps once, then clamps to ``[0, smax - 1]``."""
    start = pos + smax if pos < 0 else pos
    return min(max(start, 0), smax - 1)


def decode_attention(q, cache_k, cache_v, valid_len: int, chunk_kv: int,
                     n_chunks: Optional[int] = None) -> torch.Tensor:
    """``flash_attention(q, repeat(cache_k), repeat(cache_v), causal=False,
    kv_valid_len=valid_len, chunk_q=1, chunk_kv=chunk_kv)`` for one query
    token, per KV group: q ``[B, 1, H, Dk]`` with head ``h`` reading KV
    head ``h // (H / Hkv)`` of cache ``[B, Smax, Hkv, D]``.  Keys at or past
    ``valid_len`` are masked at f32-min.  Only the first ``n_chunks`` chunks
    are scanned (default: through the last chunk that holds a valid key);
    a masked chunk leaves ``m``, ``l`` and ``acc`` unchanged (``p = 0``,
    ``corr = 1``) while one valid score is finite, so the result equals
    the full scan's."""
    m, l, acc = _decode_partials(q, cache_k, cache_v, valid_len, chunk_kv, n_chunks)
    return _decode_finish(m, l, acc, cache_v.dtype)


def _decode_finish(m, l, acc, dtype):
    b, hkv, rep, dv = acc.shape
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(b, 1, hkv * rep, dv).to(dtype)


def _decode_partials(q, cache_k, cache_v, valid_len: int, chunk_kv: int, n_chunks: Optional[int] = None,
                     k0: int = 0):
    """:func:`decode_attention`'s running max ``m``, sum ``l`` and
    accumulator ``acc`` (f32 ``[B, Hkv, rep(, Dv)]``) over a cache block
    whose first key sits at global position ``k0``."""
    b, _, h, dk = q.shape
    smax, hkv, dv = cache_k.shape[1], cache_k.shape[2], cache_v.shape[-1]
    rep = h // hkv
    ckv = min(chunk_kv, smax)
    assert smax % ckv == 0, (smax, ckv)
    if n_chunks is None:
        local = valid_len - k0
        n_chunks = smax // ckv if valid_len <= 0 else max(0, min(smax // ckv, -(-local // ckv)))
    dev = q.device
    # the scale rounded to q's dtype first, as in flash_attention
    qs = (q * torch.tensor(1.0 / math.sqrt(dk), dtype=q.dtype).item()).float()
    qs = qs.reshape(b, hkv, rep, dk)
    neg = torch.finfo(torch.float32).min
    m = torch.full((b, hkv, rep), -torch.inf, device=dev)
    l = torch.zeros((b, hkv, rep), device=dev)
    acc = torch.zeros((b, hkv, rep, dv), device=dev)
    for ki in range(n_chunks):
        kc = cache_k[:, ki * ckv:(ki + 1) * ckv].float()
        vc = cache_v[:, ki * ckv:(ki + 1) * ckv]
        s = torch.einsum("bgrd,bkgd->bgrk", qs, kc)
        kpos = k0 + ki * ckv + torch.arange(ckv, device=dev)
        s = s.masked_fill_(kpos >= valid_len, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrk,bkgd->bgrd", p.to(cache_v.dtype).float(), vc.float())
        m = m_new
    return m, l, acc


def _combine_partials(m, l, acc, mesh, axis):
    """The partials of the ranks along ``axis`` (each over its block of the
    keys) as one online softmax's: every rank rescaled to the global max."""
    if axis is None:
        return m, l, acc
    mg = C.all_max(m, mesh, axis)
    corr = torch.exp(m - mg)
    return mg, C.all_sum(l * corr, mesh, axis), C.all_sum(acc * corr[..., None], mesh, axis)


def gqa_decode(params, x, cache_k, cache_v, pos: int, cfg: TransformerConfig,
               ctx: ParallelCtx):
    """One-token decode.  x: [B, 1, d]; cache_[kv]: [B, Smax, Hkv, Dh],
    written in place at ``pos`` (clamped as the reference's
    ``dynamic_update_slice``); pos: the current length, a Python int
    (tokens 0..pos-1 are valid).  Returns (y [B, 1, d], cache_k, cache_v).
    Under a mesh (the decode rules): x is the normed stream's ``"embed"``
    block ``[B_loc, 1, d_loc]``, the caches this rank's ``"kv_seq"``
    blocks, and y this rank's ``d`` block of the output."""
    plan = RankPlan.of(ctx)
    _decode_plan_ok(plan, "gqa_decode")
    b = x.shape[0]
    mesh, e = plan.mesh, plan.embed
    q = C.all_sum(torch.einsum("bsd,dhk->bshk", x, params["wq"]), mesh, e)
    k = C.all_sum(torch.einsum("bsd,dhk->bshk", x, params["wk"]), mesh, e)
    v = C.all_sum(torch.einsum("bsd,dhk->bshk", x, params["wv"]), mesh, e)
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)
    k0, slot = _rank_slot(cache_k, pos, plan)
    if slot is not None:
        cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
        cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    m, l, acc = _decode_partials(q, cache_k, cache_v, pos + 1, cfg.attn_chunk_kv, k0=k0)
    out = _decode_finish(*_combine_partials(m, l, acc, mesh, plan.kv_seq), cache_v.dtype)
    return _attend_out(params, out, cfg), cache_k, cache_v


def _decode_plan_ok(plan: RankPlan, what: str):
    plan.require(plan.heads is None and plan.kv_heads is None and plan.ff is None and plan.vocab is None
                  and plan.seq is None, what)


def _rank_slot(cache_block, pos: int, plan: RankPlan):
    """(the global position of this rank's first cached key, the row of
    its block that ``pos`` writes, or None when the write lands in another
    rank's block).  The cache's sequence splits evenly over ``kv_seq``."""
    smax = cache_block.shape[1] * (1 if plan.kv_seq is None else mesh_axis_size(plan.mesh, plan.kv_seq))
    k0, n = plan.block(smax, plan.kv_seq)
    slot = _write_slot(pos, smax) - k0
    return k0, (slot if 0 <= slot < n else None)


# ---------------------------------------------------------------------------
# MLA attention (MiniCPM3 / DeepSeek-V2 style).
# ---------------------------------------------------------------------------

def mla_init(gen, cfg: TransformerConfig, dtype, device=None):
    d = cfg.d_model
    hp = cfg.padded_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dev = gen.device if device is None else device
    p, a = {}, {}
    p["wq_a"], a["wq_a"] = dense_init(gen, d, (qr,), ("embed", None), dtype, dev)
    p["q_norm"], a["q_norm"] = {"scale": torch.ones(qr, dtype=dtype, device=dev)}, {"scale": (None,)}
    p["wq_b"], a["wq_b"] = dense_init(gen, qr, (hp, dn + dr), (None, "heads", None), dtype, dev)
    p["wkv_a"], a["wkv_a"] = dense_init(gen, d, (kvr + dr,), ("embed", None), dtype, dev)
    p["kv_norm"], a["kv_norm"] = {"scale": torch.ones(kvr, dtype=dtype, device=dev)}, {"scale": (None,)}
    p["wk_b"], a["wk_b"] = dense_init(gen, kvr, (hp, dn), (None, "heads", None), dtype, dev)
    p["wv_b"], a["wv_b"] = dense_init(gen, kvr, (hp, dv), (None, "heads", None), dtype, dev)
    p["wo"], _ = dense_init(gen, hp * dv, (d,), None, dtype, dev)
    p["wo"] = p["wo"].reshape(hp, dv, d)
    a["wo"] = ("heads", None, "embed")
    return p, a


def _mla_qkv(params, x, positions, cfg: TransformerConfig, reduce=lambda t: t):
    """(q_nope, q_pe, ckv, k_pe); ``reduce`` sums the two down-projections'
    partial products where ``d`` is split (decode under a mesh)."""
    dn = cfg.qk_nope_head_dim
    kvr = cfg.kv_lora_rank
    cq = rmsnorm(params["q_norm"], reduce(torch.einsum("bsd,dr->bsr", x, params["wq_a"])), cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", cq, params["wq_b"])
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)

    ckv_pe = reduce(torch.einsum("bsd,dr->bsr", x, params["wkv_a"]))
    ckv, k_pe = ckv_pe[..., :kvr], ckv_pe[..., kvr:]
    ckv = rmsnorm(params["kv_norm"], ckv, cfg.norm_eps)
    k_pe = apply_rope(k_pe[:, :, None, :], positions, cfg.rope_theta)  # [B,S,1,dr]
    return q_nope, q_pe, ckv, k_pe


def mla_apply(params, x, positions, cfg: TransformerConfig, ctx: ParallelCtx,
              causal=True, q_offset=0):
    """Training/prefill MLA: expand latents to per-head K/V, flash attend.
    Under a mesh, per-rank code as :func:`gqa_apply`'s: the replicated
    down-projections give every rank the whole latents, and ``wq_b``,
    ``wk_b`` and ``wv_b`` this rank's heads."""
    dr = cfg.qk_rope_head_dim
    plan = RankPlan.of(ctx)
    plan.require(plan.embed is None, "mla_apply")
    h0 = plan.block(cfg.padded_heads, plan.heads)[0]
    q_nope, q_pe, ckv, k_pe = _mla_qkv(params, plan.gather_seq(x), positions, cfg)
    k_nope = torch.einsum("bsr,rhk->bshk", ckv, params["wk_b"])
    v = torch.einsum("bsr,rhk->bshk", ckv, params["wv_b"])
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(*k_nope.shape[:3], dr)], dim=-1)
    out = flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                          chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv)
    return plan.reduce_seq(_attend_out(params, out, cfg, h0), plan.heads)


def mla_decode(params, x, cache_ckv, cache_kpe, pos: int, cfg: TransformerConfig,
               ctx: ParallelCtx):
    """Absorbed-matmul MLA decode: scores against the *compressed* latent
    cache, ``W_uk`` absorbed into the query and ``W_uv`` applied after
    attention, so a step touches kv_lora + rope values per cached token.

    x: [B, 1, d]; cache_ckv: [B, Smax, kvr]; cache_kpe: [B, Smax, dr], both
    written in place at ``pos`` (clamped).  Every keys position ``<= pos``
    is valid (all of them once ``pos >= Smax - 1``).  The reference's
    roundings, one by one: ``q_lat`` rounded to the cache dtype, the two
    score products each rounded, their sum rounded, times the scale
    rounded to that dtype first; then f32 for the masked softmax, whose
    probabilities go back to the cache dtype for ``ctx_lat``.  Under a
    mesh (the decode rules), per-rank code as :func:`gqa_decode`'s: the
    softmax over the split cache takes the global max and sum."""
    b = x.shape[0]
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    plan = RankPlan.of(ctx)
    _decode_plan_ok(plan, "mla_decode")
    k0, slot = _rank_slot(cache_ckv, pos, plan)
    q_nope, q_pe, ckv_new, kpe_new = _mla_qkv(params, x, posv, cfg, lambda t: C.all_sum(t, plan.mesh, plan.embed))
    if slot is not None:
        cache_ckv[:, slot] = ckv_new[:, 0].to(cache_ckv.dtype)
        cache_kpe[:, slot] = kpe_new[:, 0, 0].to(cache_kpe.dtype)

    # absorb W_uk: q_lat[b,h,c] = sum_k q_nope[b,1,h,k] wk_b[c,h,k]
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], params["wk_b"])
    scale = torch.tensor(1.0 / math.sqrt(dn + dr), dtype=q_lat.dtype).item()
    s = (torch.einsum("bhr,bsr->bhs", q_lat, cache_ckv)
         + torch.einsum("bhk,bsk->bhs", q_pe[:, 0], cache_kpe)) * scale
    s = s.float()
    invalid = k0 + torch.arange(cache_ckv.shape[1], device=x.device) > pos
    s = s.masked_fill_(invalid, torch.finfo(torch.float32).min)
    # jax.nn.softmax over every rank's keys: exp(s - the global max) / the global sum
    e = torch.exp(s - C.all_max(s.amax(dim=-1, keepdim=True), plan.mesh, plan.kv_seq))
    p = (e / C.all_sum(e.sum(dim=-1, keepdim=True), plan.mesh, plan.kv_seq)).to(cache_ckv.dtype)
    ctx_lat = C.all_sum(torch.einsum("bhs,bsr->bhr", p, cache_ckv), plan.mesh, plan.kv_seq)
    # apply W_uv per head, then the output projection
    out = torch.einsum("bhr,rhk->bhk", ctx_lat, params["wv_b"])
    return _attend_out(params, out[:, None], cfg), cache_ckv, cache_kpe


# ---------------------------------------------------------------------------
# SwiGLU FFN.
# ---------------------------------------------------------------------------

def swiglu_init(gen, d: int, d_ff: int, dtype, device=None):
    dev = gen.device if device is None else device
    p, a = {}, {}
    p["w_in"], a["w_in"] = dense_init(gen, d, (d_ff,), ("embed", "ff"), dtype, dev)
    p["w_gate"], a["w_gate"] = dense_init(gen, d, (d_ff,), ("embed", "ff"), dtype, dev)
    p["w_out"], a["w_out"] = dense_init(gen, d_ff, (d,), ("ff", "embed"), dtype, dev)
    return p, a


def swiglu_apply(params, x, ctx: Optional[ParallelCtx] = None):
    """``silu(x @ w_gate) * (x @ w_in) @ w_out``; silu as ``jax.nn.silu``
    writes it, ``g * sigmoid(g)``, each step rounded to ``x``'s dtype.
    Under a mesh, per-rank code: with the training rules, ``x`` is this
    rank's sequence block and ``w_in``/``w_gate`` its ``"ff"`` columns,
    ``w_out`` its rows (the output reduce-scattered back to the block);
    with the decode rules (``"embed"`` split), ``x`` is the normed
    stream's ``d`` block, the two products over it partial sums, and the
    output this rank's ``d`` block."""
    plan = RankPlan.of(ctx)
    plan.require(plan.embed is None or (plan.ff is None and plan.seq is None), "swiglu_apply")
    x = plan.gather_seq(x)
    g = C.all_sum(x @ params["w_gate"], plan.mesh, plan.embed)
    h = g * torch.sigmoid(g) * C.all_sum(x @ params["w_in"], plan.mesh, plan.embed)
    return plan.reduce_seq(h @ params["w_out"], plan.ff)
