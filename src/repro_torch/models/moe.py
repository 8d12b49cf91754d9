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
With a ``DeviceMesh`` every rank calls it with the same logical
arguments and runs the expert-parallel body on its block of the tokens
(the reference's ``shard_map`` bodies): tokens bucketed by the rank that
owns their expert, an all-to-all over the expert axis, a second bucketing
by local expert, the grouped GEMM, and the moves reversed
(``ep_mode="model"``: experts over the TP axis; ``"data"``: over the DP
axis; with ``expert_ff`` on another axis, the 2-D split of each expert's
FFN, tokens all-gathered over the sequence axis and the partial outputs
reduce-scattered back).  The collectives are autograd functions
(:mod:`repro_torch.distributed.collectives`), so gradients flow as
``jax.grad`` of the ``shard_map`` gives them.

Arithmetic follows the reference: routing in f32, the weights cast to the
tokens' dtype after normalising; the buffers, the expert GEMMs and the
combine in the tokens' dtype (a bf16 product ``weight * value`` rounds,
and so does each add of the scatter, as JAX's bf16 scatter-add does).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import TransformerConfig
from repro_torch.core.brute_force import select_topk
from repro_torch.distributed import collectives as C
from repro_torch.distributed.mesh_utils import mesh_axis_size, mesh_sizes
from repro_torch.distributed.sharding import NamedSharding, ParallelCtx
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


def _ep_process(params, flat: torch.Tensor, cfg: TransformerConfig, mesh, ep_axis: str, n_ep: int,
                e_loc: int):
    """Dispatch -> all-to-all -> grouped GEMM on the local experts (their
    local ff slice in the 2-D split: a partial output) -> all-to-all ->
    combine, for one rank's tokens ``flat [T, d]`` (the reference's
    ``_moe_ep_body`` and ``_ep2d_process``).  Returns (y [T, d], aux)."""
    t, d = flat.shape
    k = cfg.top_k
    dev = flat.device
    ids, w, aux = route(flat, params["wg"], k)
    owner = ids // e_loc                                  # destination EP rank
    c1 = _round_up(max(1, int(t * k / n_ep * cfg.capacity_factor)), 8)
    tokens = torch.arange(t, dtype=torch.int32, device=dev).repeat_interleave(k)
    disp1 = sort_dispatch(owner.reshape(-1), tokens, w.reshape(-1), n_ep, c1)
    send, send_eid = fill_buffers(disp1, flat, n_ep, c1, payload=(ids % e_loc).reshape(-1))

    recv = C.all_to_all_axis(send, mesh, ep_axis)
    recv_eid = C.all_to_all(send_eid, mesh.get_group(ep_axis))

    rflat = recv.reshape(n_ep * c1, d)
    eid = recv_eid.reshape(n_ep * c1)
    # per-expert capacity: at most n_ep*c1 slots arrive in total, so cap
    # there (for e_loc==1 the cf multiplier would be pure waste).
    c2 = _round_up(max(1, int(n_ep * c1 / e_loc * cfg.capacity_factor)), 8)
    c2 = min(c2, _round_up(n_ep * c1, 8))
    # invalid slots (eid == -1) bucket to a trash expert index e_loc
    disp2 = sort_dispatch(torch.where(eid >= 0, eid, e_loc),
                          torch.arange(n_ep * c1, dtype=torch.int32, device=dev),
                          torch.ones(n_ep * c1, dtype=rflat.dtype, device=dev), e_loc + 1, c2)
    buf = fill_buffers(disp2, rflat, e_loc + 1, c2)[:e_loc]
    out = _expert_ffn(params["w_in"], params["w_gate"], params["w_out"], buf)
    out = torch.cat([out, out.new_zeros((1, c2, d))])
    back = combine_buffers(disp2, out, n_ep * c1).reshape(n_ep, c1, d)

    ret = C.all_to_all_axis(back, mesh, ep_axis)
    return combine_buffers(disp1, ret, t), aux


def _moe_ep_body_2d(params, x: torch.Tensor, cfg: TransformerConfig, mesh, ep_axis: str, tp_axis,
                    n_ep: int, e_loc: int):
    """2-D expert sharding (arctic scale): experts over ``ep_axis`` x FFN
    width over the tp axis.  Tokens enter sequence-sharded over
    ``tp_axis``, are all-gathered (so routing and dispatch are identical
    across its ranks), the grouped GEMM runs on the local ff slice, and the
    partial outputs reduce-scatter back to sequence shards.  Long sequences
    run in ``moe_token_chunks`` sequential chunks so that the dispatch
    buffers do not scale with T.  x: [B_l, S_loc, d]."""
    bl, _, d = x.shape
    x_full = C.gather_axis(x, mesh, tp_axis, 1) if tp_axis is not None else x
    t = bl * x_full.shape[1]
    flat = x_full.reshape(t, d)

    nc = cfg.moe_token_chunks
    if nc > 1 and t % nc == 0:
        ys, auxs = zip(*(_ep_process(params, xc, cfg, mesh, ep_axis, n_ep, e_loc)
                         for xc in flat.reshape(nc, t // nc, d)))
        y, aux = torch.stack(ys).reshape(t, d), torch.stack(auxs).mean()
    else:
        y, aux = _ep_process(params, flat, cfg, mesh, ep_axis, n_ep, e_loc)

    y = y.reshape(bl, -1, d)
    if tp_axis is not None:
        y = C.scatter_axis(y, mesh, tp_axis, 1)
    return y, aux


def moe_apply(params, x: torch.Tensor, cfg: TransformerConfig,
              ctx: ParallelCtx) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], aux loss).

    With a mesh, every rank calls this with the same logical arguments:
    ``x`` and the params are tensors every rank holds whole, or
    ``DTensor``s; each rank takes its token block by ``x``'s spec and its
    expert weights by the weights' specs.  ``y`` comes back whole on every
    rank for a whole ``x``, as a ``DTensor`` laid out as the tokens for a
    ``DTensor`` ``x``; ``aux`` is the mean over every rank."""
    b, s, d = x.shape
    mesh = ctx.mesh
    ep_axis = "model" if cfg.ep_mode == "model" else "data"
    n_ep = 1 if mesh is None else mesh_sizes(mesh).get(ep_axis, 1)
    if n_ep == 1 or cfg.n_experts % n_ep != 0:
        if isinstance(x, DTensor):
            whole = C.from_blocks(x.to_local(), NamedSharding.of(x), x.shape)
            y, aux = moe_local({k: v.full_tensor() if isinstance(v, DTensor) else v for k, v in params.items()},
                               whole.reshape(-1, d), cfg)
            return DTensor.from_local(C.to_block(y.reshape(b, s, d), NamedSharding.of(x)), mesh, x.placements,
                                      run_check=False, shape=x.shape, stride=x.stride()), aux
        y, aux = moe_local(params, x.reshape(-1, d), cfg)
        return y.reshape(b, s, d), aux
    e_loc = cfg.n_experts // n_ep

    dp = ctx.mesh_axes("batch")
    sp = ctx.mesh_axes("seq_act")
    # 2-D expert sharding: ff width over the tp axis (arctic-scale experts).
    ff_axis = ctx.mesh_axes("expert_ff")
    if ff_axis is not None and (ep_axis == ff_axis or cfg.moe_d_ff % mesh_axis_size(mesh, ff_axis)):
        ff_axis = None
    # decode / short sequences: the sequence dim cannot shard — replicate
    # it (each TP rank redoes the tiny dispatch; correctness unaffected).
    if sp is not None and s % mesh_axis_size(mesh, sp) != 0:
        sp = None
    if dp is not None and b % mesh_axis_size(mesh, dp) != 0:
        dp = None
    x_sh = NamedSharding(mesh, (dp, sp, None))
    w_specs = {"wg": (None, None), "w_in": (ep_axis, None, ff_axis), "w_gate": (ep_axis, None, ff_axis),
               "w_out": (ep_axis, ff_axis, None)}
    p = {k: C.rank_block(params[k], NamedSharding(mesh, spec), deferred=ctx.deferred) for k, spec in w_specs.items()}
    xin = C.rank_block(x, x_sh)

    if ff_axis is not None:
        y, aux = _moe_ep_body_2d(p, xin, cfg, mesh, ep_axis, sp, n_ep, e_loc)
        if sp is None:
            # partial-ff outputs with replicated tokens: reduce over tp
            y = C.psum(y, mesh, ff_axis)
    else:
        bl, sl, _ = xin.shape
        y, aux = _ep_process(p, xin.reshape(bl * sl, d), cfg, mesh, ep_axis, n_ep, e_loc)
        y = y.reshape(bl, sl, d)
    aux = C.pmean_all(aux, mesh)
    if isinstance(x, DTensor):
        return DTensor.from_local(y, mesh, x_sh.placements, run_check=False, shape=x.shape,
                                  stride=x.stride()), aux
    return C.from_blocks(y, x_sh, (b, s, d)), aux
