"""Mixture-of-Experts with sort-based (MegaBlocks-style) dispatch
(counterpart of ``repro/models/moe.py``, its single-device path).

No ``[T, E, C]`` one-hot dispatch einsum: tokens are *sorted* by
destination and moved with gathers and scatters:

  1. route: top-k over router probabilities (``lax.top_k``'s order, ties
     toward the lower expert id), weights normalised over the selected
     experts (the Mixtral/Arctic convention) + the load-balancing aux loss;
  2. dispatch: bucket the (token, k) pairs by expert with one stable sort,
     capacity-bounded, overflow dropped (the GShard convention);
  3. the grouped SwiGLU GEMM ``[E, C, d] x [E, d, f]`` over every expert's
     buffer at full capacity;
  4. combine: a weighted scatter-add back to the token rows.

``moe_apply`` runs ``moe_local`` when the ``ParallelCtx`` has no mesh.
The expert-parallel bodies (the all-to-all over an expert axis, experts
sharded over the model or the data axis, the 2-D split of the expert FFN)
wait for the port's distributed layer: with a mesh, ``moe_apply`` raises
``NotImplementedError``.

Arithmetic follows the reference: routing in f32, the weights cast to the
tokens' dtype after normalising; the buffers, the expert GEMMs and the
combine in the tokens' dtype (a bf16 product ``weight * value`` rounds,
and so does each add of the scatter, as JAX's bf16 scatter-add does).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.configs.base import TransformerConfig
from repro_torch.core.brute_force import select_topk
from repro_torch.distributed.sharding import ParallelCtx
from repro_torch.models.layers import _normal

__all__ = ["moe_init", "route", "Dispatch", "sort_dispatch", "fill_buffers",
           "combine_buffers", "moe_local", "moe_apply"]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def moe_init(gen: torch.Generator, cfg: TransformerConfig, dtype, device=None):
    """(params, axes): the router ``wg [d, E]`` in f32, the experts
    ``w_in``, ``w_gate [E, d, f]`` and ``w_out [E, f, d]`` in ``dtype``;
    ``N(0, 1/d)`` and ``N(0, 1/f)`` draws from ``gen``, as the reference's."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    dev = gen.device if device is None else device
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    ep = "experts"
    p = {
        "wg": _normal(gen, (d, e), s_in, torch.float32, dev),
        "w_in": _normal(gen, (e, d, f), s_in, dtype, dev),
        "w_gate": _normal(gen, (e, d, f), s_in, dtype, dev),
        "w_out": _normal(gen, (e, f, d), s_out, dtype, dev),
    }
    # the d dim has no logical name: "embed" is owned by the dense layers
    a = {
        "wg": (None, None),
        "w_in": (ep, None, "expert_ff"),
        "w_gate": (ep, None, "expert_ff"),
        "w_out": (ep, "expert_ff", None),
    }
    return p, a


def route(x_flat: torch.Tensor, wg: torch.Tensor, top_k: int):
    """Returns (expert_ids i32[T, K], weights [T, K] in ``x_flat``'s dtype,
    aux_loss f32 scalar).  The top k are selected in ``lax.top_k``'s order
    (:func:`~repro_torch.core.brute_force.select_topk`: ties toward the
    lower expert id, NaNs by their bits), which ``torch.topk`` does not
    promise."""
    logits = x_flat.float() @ wg                                 # [T, E]
    probs = torch.softmax(logits, dim=-1)
    w, ids = select_topk(probs, top_k)
    w = w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-9)
    e = wg.shape[1]
    # Switch-style load-balancing loss: E * sum_e f_e * p_e
    f_e = torch.nn.functional.one_hot(ids, e).float().sum(dim=1).mean(dim=0)
    p_e = probs.mean(dim=0)
    aux = e * torch.sum(f_e * p_e)
    return ids.to(torch.int32), w.to(x_flat.dtype), aux


class Dispatch(NamedTuple):
    """Reverse mapping for combine: for each (token, k) pair its slot in
    the bucketed buffer (or capacity overflow -> invalid)."""

    slot: torch.Tensor    # i32[T*K] position in flattened [n_buckets*C, ...]
    token: torch.Tensor   # i32[T*K] source row
    weight: torch.Tensor  # [T*K]
    valid: torch.Tensor   # bool[T*K]


def sort_dispatch(bucket_ids: torch.Tensor, token_ids: torch.Tensor, weights: torch.Tensor,
                  n_buckets: int, capacity: int) -> Dispatch:
    """Assign each (token, k) pair a slot = bucket*capacity + rank-in-bucket
    via one stable sort; pairs past capacity are dropped (GShard policy)
    and share the overflow slot ``n_buckets * capacity``."""
    n = bucket_ids.shape[0]
    dev = bucket_ids.device
    order = torch.argsort(bucket_ids, stable=True)
    sb = bucket_ids[order].long()
    counts = torch.zeros(n_buckets, dtype=torch.long, device=dev).scatter_add_(0, sb, torch.ones_like(sb))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=dev) - starts[sb]
    valid_sorted = rank < capacity
    slot_sorted = torch.where(valid_sorted, sb * capacity + rank,
                              torch.full_like(rank, n_buckets * capacity))
    # un-sort back to pair order
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=dev)
    return Dispatch(slot=slot_sorted[inv].to(torch.int32), token=token_ids.to(torch.int32),
                    weight=weights, valid=valid_sorted[inv])


def fill_buffers(disp: Dispatch, x: torch.Tensor, n_buckets: int, capacity: int,
                 payload: torch.Tensor | None = None):
    """Scatter token rows (and an optional int payload) into bucket
    buffers ``[n_buckets, capacity, d]`` (``[n_buckets, capacity]``, -1
    where empty).  Dropped pairs all land in the overflow row, which is cut
    off: only there do the duplicate writes race."""
    d = x.shape[-1]
    slot = disp.slot.long()
    buf = x.new_zeros((n_buckets * capacity + 1, d))
    buf[slot] = torch.where(disp.valid[:, None], x[disp.token.long()], 0.0)
    buf = buf[:-1].reshape(n_buckets, capacity, d)
    if payload is None:
        return buf
    pl = torch.full((n_buckets * capacity + 1,), -1, dtype=torch.int32, device=x.device)
    pl[slot] = torch.where(disp.valid, payload.to(torch.int32), -1)
    return buf, pl[:-1].reshape(n_buckets, capacity)


def combine_buffers(disp: Dispatch, out_buf: torch.Tensor, n_tokens: int) -> torch.Tensor:
    """Weighted scatter-add of expert outputs back to token rows, in the
    buffers' dtype (the product and each add rounded to it)."""
    d = out_buf.shape[-1]
    flat = torch.cat([out_buf.reshape(-1, d), out_buf.new_zeros((1, d))])
    vals = flat[torch.where(disp.valid, disp.slot, flat.shape[0] - 1).long()]
    contrib = torch.where(disp.valid[:, None], disp.weight[:, None] * vals, 0.0)
    y = out_buf.new_zeros((n_tokens, d))
    return y.index_add_(0, disp.token.long(), contrib)


def _expert_ffn(w_in, w_gate, w_out, buf):
    """Grouped SwiGLU over buf ``[E, C, d]``: one GEMM a weight for every
    expert's buffer, rounded as ``layers.swiglu_apply`` rounds."""
    g = torch.bmm(buf, w_gate)
    h = g * torch.sigmoid(g) * torch.bmm(buf, w_in)
    return torch.bmm(h, w_out)


def moe_local(params, x_flat: torch.Tensor, cfg: TransformerConfig):
    """Single-device MoE, all experts local.  x_flat: [T, d] -> (y [T, d],
    aux)."""
    t = x_flat.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    ids, w, aux = route(x_flat, params["wg"], k)
    cap = _round_up(max(1, int(t * k / e * cfg.capacity_factor)), 8)
    tokens = torch.arange(t, dtype=torch.int32, device=x_flat.device).repeat_interleave(k)
    disp = sort_dispatch(ids.reshape(-1), tokens, w.reshape(-1), e, cap)
    buf = fill_buffers(disp, x_flat, e, cap)
    out = _expert_ffn(params["w_in"], params["w_gate"], params["w_out"], buf)
    return combine_buffers(disp, out, t), aux


def moe_apply(params, x: torch.Tensor, cfg: TransformerConfig,
              ctx: ParallelCtx) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], aux loss).  One device only: a
    ``ctx`` with a mesh needs the expert-parallel bodies, which are not
    ported yet."""
    if ctx.mesh is not None:
        raise NotImplementedError(
            "moe_apply with a mesh needs the expert-parallel all-to-all of the port's "
            "distributed layer, which is not ported yet; use ParallelCtx(None, rules)")
    b, s, d = x.shape
    y, aux = moe_local(params, x.reshape(-1, d), cfg)
    return y.reshape(b, s, d), aux
