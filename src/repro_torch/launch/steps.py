"""Train steps of the three model families (counterpart of the train half
of ``repro/launch/steps.py``).

Each ``make_*_train_step`` returns ``(step, optimizer)``;
``step(params, opt_state, batch) -> (params, opt_state, metrics)`` takes
the gradients by autograd and updates ``params`` (a module) and
``opt_state`` in place, returning them (the reference's jitted step
donates both).  ``metrics`` holds the loss and the loss function's own
metrics as detached scalars on the parameters' device: no host sync.

The rules of a cell (``rules_for_shape``, ``_fit_batch_rule``) and the
optimizer-state plans (``_opt_axes_safe``, ``zero_axes_of``) are pure
functions of configs, shapes and mesh sizes, copied from the reference.
The ZeRO plan is made on the reference's stacked ``[L, ...]`` shapes
(:func:`stacked_shapes`); the port keeps one ``Block`` a layer, so where
the plan shards the layer axis, whole layers' state goes to a data rank.

The dry run's cell machinery (the counterpart of the reference's cell
half): :func:`build_cell` gives, for every (arch x shape) pair of
:func:`all_cells`, a :class:`Cell` of this rank's step and arguments on
a mesh: the parameters placed by ``params_sharding`` (a module of
``DTensor``s, through ``distribute_module``), the optimizer state as the
step's ``init`` places it (``zero_axes_of``, ``_opt_axes_safe``), and the
batch or the KV cache as ``DTensor`` blocks laid out as the reference's
``in_shardings``.  Under a ``FakeTensorMode`` (:func:`abstract_init`)
nothing is allocated: the full configs are only traced
(``launch.dryrun``).  Outside it the same cell runs on real tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import (GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES, LMShape, RecSysConfig, RecSysShape,
                                      SchNetConfig, TransformerConfig)
from repro_torch.distributed import collectives as C
from repro_torch.distributed.mesh_utils import mesh_axis_size
from repro_torch.distributed.sharding import NamedSharding, ParallelCtx, distribute_module, params_sharding
from repro_torch.models import recsys as R
from repro_torch.models import schnet as S
from repro_torch.models import transformer as T
from repro_torch.optim import make_optimizer
from repro_torch.optim.optimizer import (AdafactorState, AdamState, MeshUpdate, _dtensor_zeros, named_leaves,
                                        reference_leaves)

__all__ = ["shape_by_name", "rules_for_shape", "zero_axes_of", "stacked_shapes", "make_lm_train_step",
           "make_gnn_train_step", "make_recsys_train_step", "Cell", "abstract_init", "build_cell",
           "build_lm_probe", "all_cells", "probe_chunks", "arg_shapes", "storage_bytes"]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def shape_by_name(family: str, name: str):
    table = {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES}[family]
    return {s.name: s for s in table}[name]


# ---------------------------------------------------------------------------
# Rules specialisation per shape, and the optimizer-state plans.
# ---------------------------------------------------------------------------

def _fit_batch_rule(rules: dict, mesh, global_batch: int) -> None:
    """Trim the batch rule's mesh axes until the batch divides the DP
    degree (e.g. pure-DP smollm: batch 256 can't split 512 ways on the
    multi-pod mesh -> drop the leading axis)."""
    axes = rules.get("batch")
    if axes is None or mesh is None:
        return
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    while axes and global_batch % mesh_axis_size(mesh, axes) != 0:
        axes = axes[1:]
    rules["batch"] = axes if axes else None


def rules_for_shape(cfg, shape, mesh=None) -> dict:
    """``cfg.rules`` specialised to a shape, as the reference's: decode
    shards the weights on ``"embed"`` and the KV cache's sequence
    (``"kv_seq"``) over ``"model"`` (both axes at batch 1), the batch off
    the cache's axes; retrieval replicates its batch of 1; prefill keeps
    the batch on the DP axes and gives ``"model"`` to the sequence; and an
    LM batch that does not divide its axes loses the leading ones."""
    rules = dict(cfg.rules)
    if isinstance(shape, LMShape):
        if shape.kind == "decode":
            rules["heads"] = None
            rules["embed"] = "model"
            rules["ff"] = None
            rules["vocab"] = None
            rules["seq_act"] = None
            if shape.global_batch == 1:
                rules["batch"] = None
                rules["kv_seq"] = ("data", "model")
            else:
                rules["kv_seq"] = "model"
            b = rules.get("batch")
            if b is not None:
                kv = rules["kv_seq"]
                kv_axes = {kv} if isinstance(kv, str) else set(kv)
                axes = (b,) if isinstance(b, str) else tuple(b)
                axes = tuple(a for a in axes if a not in kv_axes)
                rules["batch"] = axes or None
    if isinstance(shape, RecSysShape) and shape.kind == "retrieval":
        rules["batch"] = None
    if isinstance(shape, LMShape):
        if shape.kind == "prefill":
            b = rules.get("batch")
            if b is not None:
                axes = (b,) if isinstance(b, str) else tuple(b)
                rules["batch"] = tuple(a for a in axes if a != "model") or None
            if rules.get("seq_act") is None:
                rules["seq_act"] = "model"
        _fit_batch_rule(rules, mesh, shape.global_batch)
    return rules


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def _flatten(tree, prefix=""):
    """``{dotted path: leaf}`` of nested dicts whose leaves are axes tuples,
    shapes or tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}.{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _unflatten(flat: dict) -> dict:
    out = {}
    for path, leaf in flat.items():
        node = out
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def stacked_shapes(params) -> dict:
    """The reference's tree of leaf shapes for a port module: a stacked
    list's layers as a leading axis (``blocks.attn.wq [L, d, h, dh]``)."""
    leaves = named_leaves(params)
    return _unflatten({ref: torch.Size((len(names), *leaves[names[0]].shape) if names != [ref]
                                       else leaves[ref].shape)
                       for ref, names in reference_leaves(params).items()})


def _opt_axes_safe(optimizer_name, params_sds, params_axes):
    """The optimizer state's axes: AdamW's moments as the parameters';
    Adafactor's row factor the leaf's axes but the last, its column factor
    all but the second to last (a leaf of rank < 2: its axes, and
    ``(None,)`` for the placeholder)."""
    if optimizer_name == "adamw":
        return AdamState(step=(), m=params_axes, v=params_axes)
    flat_sds, flat_axes = _flatten(params_sds), _flatten(params_axes)
    vr, vc = {}, {}
    for k, axes in flat_axes.items():
        axes = tuple(axes)
        if len(flat_sds[k]) >= 2:
            vr[k], vc[k] = axes[:-1], axes[:-2] + (axes[-1],)
        else:
            vr[k], vc[k] = axes, (None,)
    return AdafactorState(step=(), vr=_unflatten(vr), vc=_unflatten(vc))


def _constructible(ctx: ParallelCtx, axes) -> bool:
    """Whether a sharding of ``axes`` exists: no mesh axis twice, each
    dim's axes in mesh order (JAX's ``DuplicateSpecError`` and friends)."""
    spec = ctx.spec(*axes)
    used = [a for e in spec if e is not None for a in ((e,) if isinstance(e, str) else e)]
    if len(used) != len(set(used)):
        return False
    try:
        ctx.sharding(*axes).placements
    except ValueError:
        return False
    return True


def zero_axes_of(params_sds, params_axes, ctx: ParallelCtx, zero_axis: str = "data"):
    """ZeRO-1 sharding plan: for each leaf (of the reference's stacked
    shapes), additionally shard the first unsharded, 16-divisible dim over
    ``zero_axis``.  Leaves that already consume the data axis (arctic's
    EP-over-data experts) or have no eligible dim keep their original
    axes."""
    flat_sds, flat_axes = _flatten(params_sds), _flatten(params_axes)
    out = {}
    for k, axes in flat_axes.items():
        axes = tuple(axes)
        cand = None
        for i, (dim, ax) in enumerate(zip(flat_sds[k], axes)):
            if ax is None and dim % 16 == 0:
                cand = axes[:i] + (zero_axis,) + axes[i + 1:]
                break
        if cand is not None and ctx.mesh is not None and not _constructible(ctx, cand):
            cand = None
        out[k] = cand if cand is not None else axes
    return _unflatten(out)


def _zero_dims(params_sds, params_axes, ctx: ParallelCtx, zero_axis: str = "data") -> dict:
    """``{reference leaf: the dim ZeRO shards}`` for the leaves it shards.
    The plan names the mesh axis ``zero_axis`` where the leaf's other dims
    name logical axes, so ``zero_axes_of`` does not see a leaf whose
    layout already takes that mesh axis (arctic-480b's experts, split over
    "data"); such a leaf keeps its layout, as the plan means it to."""
    flat = _flatten(zero_axes_of(params_sds, params_axes, ctx, zero_axis))
    base = _flatten(params_axes)
    out = {}
    for k, z in flat.items():
        used = {a for e in ctx.spec(*base[k]) if e is not None for a in ((e,) if isinstance(e, str) else e)}
        if zero_axis in used:
            continue
        out.update((k, i) for i, (a, b) in enumerate(zip(z, base[k])) if a == zero_axis and b is None)
    return out


def _grads(loss: torch.Tensor, leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """d loss / d leaf by name; a leaf the loss does not reach gets zeros,
    as ``jax.grad`` gives them."""
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(leaves.items(), gs)}


def _detached(loss, metrics) -> dict:
    return {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}}


def make_lm_train_step(cfg: TransformerConfig, ctx: ParallelCtx, lr: float = 1e-4, params_axes=None,
                       params_sds=None):
    """The LM step: ``lm_loss`` and its gradients, over ``cfg.grad_accum``
    microbatches when it is above 1 (the gradients summed in their own
    dtype, as ``jnp.add`` sums them, then divided by k; the metrics then
    hold the loss alone, as the reference's), then the config's optimizer.

    Under a mesh every rank calls the step with the same logical batch;
    the parameters are ``DTensor``s placed by ``params_sharding`` (their
    gradients come back in that placement, each the logical gradient), and
    the returned optimizer's ``init`` places the state
    (:class:`~repro_torch.optim.optimizer.MeshUpdate`).  With
    ``cfg.zero_sharding`` and ``params_axes`` (the axes tree of
    ``init_transformer``; ``params_sds`` the reference's stacked shapes,
    by default the model's), ZeRO-1: each data rank keeps, and updates,
    only its :func:`zero_axes_of` block of the gradient accumulator and
    of the optimizer state, then all-gathers the new parameters.  Without
    a mesh ZeRO is a no-op."""
    opt = make_optimizer(cfg.optimizer)
    if ctx.mesh is not None:
        return _make_mesh_lm_step(cfg, ctx, opt, lr, params_axes, params_sds)

    def step(params, opt_state, batch):
        leaves = named_leaves(params)
        k = max(1, cfg.grad_accum)
        if k == 1:
            loss, metrics = T.lm_loss(params, batch, cfg, ctx)
            grads = _grads(loss, leaves)
            metrics = _detached(loss, metrics)
        else:
            grads = {n: torch.zeros_like(p) for n, p in leaves.items()}
            total = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            for mb in zip(*(v.chunk(k) for v in batch.values())):
                loss, _ = T.lm_loss(params, dict(zip(batch, mb)), cfg, ctx)
                for n, g in _grads(loss, leaves).items():
                    grads[n].add_(g)
                total = total + loss.detach()
            grads = {n: g / k for n, g in grads.items()}
            metrics = {"loss": total / k}
        opt.step(grads, opt_state, params, lr)
        return params, opt_state, metrics

    return step, opt


def _make_mesh_lm_step(cfg: TransformerConfig, ctx: ParallelCtx, opt, lr, params_axes, params_sds):
    zero = cfg.zero_sharding and params_axes is not None
    plans = {}

    def plan(params) -> MeshUpdate:
        if "update" not in plans:
            zdims = None
            if zero:
                zdims = _zero_dims(stacked_shapes(params) if params_sds is None else params_sds, params_axes, ctx)
            plans["update"] = MeshUpdate(opt, params, ctx.mesh, zdims)
        return plans["update"]

    # ZeRO: the gradients' sum over the batch's axes is left to the step, which reduce-scatters each leaf's
    # into its block (GSPMD's reduce-scatter into the zero sharding), half the bytes of an all-reduce
    deferred = C.axis_names(ctx.mesh_axes("batch")) if zero else ()
    loss_ctx = dataclasses.replace(ctx, deferred=deferred)

    def step(params, opt_state, batch):
        upd = plan(params)
        leaves = named_leaves(params)
        k = max(1, cfg.grad_accum)
        acc, total, metrics = None, None, {}
        for mb in zip(*(v.chunk(k) for v in batch.values())):
            loss, m = T.lm_loss(params, dict(zip(batch, mb)), cfg, loss_ctx)
            grads = _grads(loss, leaves)
            first, acc = acc is None, acc or {}
            for u in upd.units:     # ZeRO: this rank's block only, each gradient let go once it is added
                g = upd.reduced_block(u, grads, deferred) if deferred else upd.block(u, grads)
                if first:
                    acc[u.key] = g
                else:
                    acc[u.key].add_(g)
                for name in u.names:
                    del grads[name]
            total = loss.detach() if total is None else total + loss.detach()
            if k == 1:
                metrics = _detached(loss, m)
        if k > 1:
            acc = {key: g / k for key, g in acc.items()}
            metrics = {"loss": total / k}
        upd.step(acc, opt_state, params, lr)
        return params, opt_state, metrics

    step.mesh_update = plan   # the MeshUpdate of a model: its state layout (interop.mesh_opt_state)
    return step, dataclasses.replace(opt, init=lambda params: plan(params).init(params))


def _make_mesh_step(opt, loss_fn, ctx: ParallelCtx, lr):
    """A step over a mesh: ``loss_fn(params, batch) -> (loss, metrics)``,
    its gradients, and ``opt`` through a :class:`MeshUpdate`."""
    plans = {}

    def plan(params) -> MeshUpdate:
        if "update" not in plans:
            plans["update"] = MeshUpdate(opt, params, ctx.mesh)
        return plans["update"]

    def step(params, opt_state, batch):
        upd = plan(params)
        loss, metrics = loss_fn(params, batch)
        grads = _grads(loss, named_leaves(params))
        upd.step({u.key: upd.block(u, grads) for u in upd.units}, opt_state, params, lr)
        return params, opt_state, _detached(loss, metrics)

    step.mesh_update = plan
    return step, dataclasses.replace(opt, init=lambda params: plan(params).init(params))


def make_gnn_train_step(cfg: SchNetConfig, ctx: ParallelCtx, lr: float = 1e-3, n_graphs: int = 0):
    """SchNet's step: ``schnet_loss`` (energies of ``n_graphs`` molecules
    or per-node targets) and AdamW (over a mesh through a ``MeshUpdate``,
    as the LM's)."""
    opt = make_optimizer("adamw")
    if ctx.mesh is not None:
        return _make_mesh_step(opt, lambda p, b: S.schnet_loss(p, b, cfg, ctx, n_graphs), ctx, lr)

    def step(params, opt_state, batch):
        loss, metrics = S.schnet_loss(params, batch, cfg, ctx, n_graphs)
        opt.step(_grads(loss, named_leaves(params)), opt_state, params, lr)
        return params, opt_state, _detached(loss, metrics)

    return step, opt


def make_recsys_train_step(cfg: RecSysConfig, ctx: ParallelCtx, lr: float = 1e-3):
    """A recommendation model's step: ``bce_loss`` and AdamW.  The tables'
    gradients are dense, as JAX's are: AdamW decays every row.  Over a
    mesh through a ``MeshUpdate``, as the LM's."""
    opt = make_optimizer("adamw")
    if ctx.mesh is not None:
        return _make_mesh_step(opt, lambda p, b: R.bce_loss(p, cfg, b, ctx), ctx, lr)

    def step(params, opt_state, batch):
        loss, metrics = R.bce_loss(params, cfg, batch, ctx)
        opt.step(_grads(loss, named_leaves(params)), opt_state, params, lr)
        return params, opt_state, _detached(loss, metrics)

    return step, opt


# ---------------------------------------------------------------------------
# The dry run's cells.
# ---------------------------------------------------------------------------

class Cell(NamedTuple):
    """One (arch x shape) step on this rank: ``fn(*cell.inputs())``, where
    ``args`` are this rank's arguments (a module of ``DTensor``
    parameters, the optimizer state, ``DTensor`` blocks of the batch or
    the KV cache) and ``in_shardings`` mirror them by the reference's
    leaves.  ``donate`` names the arguments the step updates in place (the
    reference's donated buffers); ``batch_arg`` the one that ``fn`` takes
    whole, as the port's entry points take the logical batch on every
    rank (:meth:`inputs`)."""

    fn: Callable
    args: tuple
    in_shardings: tuple
    cfg: Any
    shape: Any
    donate: tuple = ()
    batch_arg: Optional[int] = None

    def inputs(self) -> tuple:
        """``args`` as ``fn`` takes them: the batch's blocks gathered whole."""
        if self.batch_arg is None:
            return self.args
        return tuple(_whole(a) if i == self.batch_arg else a for i, a in enumerate(self.args))


def abstract_init(init_fn, cfg, device="cuda", seed: int = 0):
    """``init_fn(cfg, seed, device) -> (params, axes)`` under a
    ``FakeTensorMode`` (the active one, else a new one): the parameters
    come back as fake tensors of their shapes and dtypes on ``device``
    (nothing allocated: full configs are hundreds of GB), with their axes
    tree."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    active = detect_fake_mode() is not None
    with contextlib.nullcontext() if active else FakeTensorMode(allow_non_fake_inputs=True):
        return init_fn(cfg, seed, device)


def _init(init_fn, cfg, device, abstract: bool):
    return abstract_init(init_fn, cfg, device) if abstract else init_fn(cfg, 0, device)


def probe_chunks(cfg: TransformerConfig) -> TransformerConfig:
    """``cfg`` with the probe's attention chunks: at least 4096 query and
    8192 key rows, so that a trace walks few tiles (the forward's FLOPs do
    not depend on the tiling; see ``launch.dryrun`` for the backward)."""
    return dataclasses.replace(cfg, attn_unroll=True, attn_chunk_q=max(cfg.attn_chunk_q, 4096),
                               attn_chunk_kv=max(cfg.attn_chunk_kv, 8192))


def _zeros_block(shape, dtype, sharding: Optional[NamedSharding], device):
    """This rank's block (zeros) of a ``DTensor`` of ``shape`` laid out by
    ``sharding``; the whole tensor without one."""
    if sharding is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    return _dtensor_zeros(shape, sharding, device, dtype)


def _blocks(sds, shardings, device):
    """A tree of meta tensors (shapes and dtypes) -> the tree of this
    rank's zero blocks, laid out by the mirroring ``shardings``."""
    if sds is None:
        return None
    if isinstance(sds, torch.Tensor):
        return _zeros_block(tuple(sds.shape), sds.dtype, shardings, device)
    if isinstance(sds, dict):
        return {k: _blocks(v, shardings[k], device) for k, v in sds.items()}
    return type(sds)(*(_blocks(v, s, device) for v, s in zip(sds, shardings)))


def _whole(tree):
    """Every ``DTensor`` of a batch tree gathered whole."""
    if isinstance(tree, DTensor):
        return T.gathered(tree)
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_whole(v) for v in tree))
    return tree


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _shardings(axes_tree, ctx: ParallelCtx):
    """``params_sharding`` of an axes tree that may hold lists (the
    recommendation models' layers)."""
    if isinstance(axes_tree, list):
        return [_shardings(a, ctx) for a in axes_tree]
    if isinstance(axes_tree, dict):
        return {k: _shardings(v, ctx) for k, v in axes_tree.items()}
    return params_sharding(axes_tree, ctx)


def _state_sharding(state_axes, ctx: ParallelCtx):
    """An optimizer state's axes (``_opt_axes_safe``) -> its shardings."""
    return type(state_axes)(*(ctx.sharding(*x) if _is_axes(x) else _shardings(x, ctx) for x in state_axes))


def _no_grad(fn):
    def run(*args):
        with torch.no_grad():
            return fn(*args)
    return run


def _lm_cell(cfg: TransformerConfig, shape: LMShape, ctx: ParallelCtx, device, abstract: bool) -> Cell:
    model, axes = _init(T.init_transformer, cfg, device, abstract)
    distribute_module(model, axes, ctx)
    p_shard = params_sharding(axes, ctx)
    b, s = shape.global_batch, shape.seq_len

    if shape.kind == "train":
        cfg = dataclasses.replace(cfg, ce_unroll=True)
        step, opt = make_lm_train_step(cfg, ctx, params_axes=axes)
        opt_state = opt.init(model)
        sds = stacked_shapes(model)
        state_axes = zero_axes_of(sds, axes, ctx) if (cfg.zero_sharding and ctx.mesh is not None) else axes
        o_shard = _state_sharding(_opt_axes_safe(cfg.optimizer, sds, state_axes), ctx)
        b_shard = {"tokens": ctx.sharding("batch", None), "targets": ctx.sharding("batch", None)}
        batch = _blocks({k: _meta((b, s), torch.int32) for k in b_shard}, b_shard, device)
        return Cell(step, (model, opt_state, batch), (p_shard, o_shard, b_shard), cfg, shape, donate=(0, 1),
                    batch_arg=2)

    t_shard = ctx.sharding("batch", None)
    if shape.kind == "prefill":
        toks = _zeros_block((b, s), torch.int32, t_shard, device)
        return Cell(_no_grad(lambda p, t: T.prefill_step(p, t, cfg, ctx)), (model, toks), (p_shard, t_shard), cfg,
                    shape, batch_arg=1)

    # decode: one new token against a seq_len KV cache
    dcfg = dataclasses.replace(cfg, attn_chunk_q=1, attn_chunk_kv=s)
    cache = T.init_cache(dcfg, b, s, device, ctx=ctx)
    c_shard = T.KVCache(*(None if ax is None else ctx.sharding(*ax) for ax in T.cache_axes(dcfg)))
    toks = _zeros_block((b, 1), torch.int32, t_shard, device)

    def step(params, cache, tokens):
        return T.decode_step(params, cache, tokens, s - 1, dcfg, ctx)

    return Cell(_no_grad(step), (model, cache, toks), (p_shard, c_shard, t_shard), dcfg, shape, donate=(1,),
                batch_arg=2)


def _gnn_batch_sds(cfg: SchNetConfig, shape, edge_multiple: int):
    """The batch of a GNN shape as meta tensors (shapes and dtypes), padded
    as the reference pads it."""
    f32, i32 = torch.float32, torch.int32
    if shape.kind == "batched":
        n = shape.n_nodes * shape.batch_graphs
        e = _round_up(shape.n_edges * shape.batch_graphs, edge_multiple)
        return S.GraphBatch(node_z=_meta((n,), i32), senders=_meta((e,), i32), receivers=_meta((e,), i32),
                            distances=_meta((e,), f32), edge_mask=_meta((e,), torch.bool),
                            graph_ids=_meta((n,), i32), targets=_meta((shape.batch_graphs,), f32))
    if shape.kind == "sampled":
        seeds = shape.batch_nodes
        f1, f2 = shape.fanout
        n = _round_up(seeds * (1 + f1 + f1 * f2), 1024)
        e = _round_up(seeds * f1 + seeds * f1 * f2, edge_multiple)
        return S.GraphBatch(node_z=_meta((n,), i32), senders=_meta((e,), i32), receivers=_meta((e,), i32),
                            distances=_meta((e,), f32), edge_mask=_meta((e,), torch.bool), targets=_meta((n,), f32))
    n = shape.n_nodes
    e = _round_up(shape.n_edges, edge_multiple)
    return S.GraphBatch(node_feat=_meta((n, shape.d_feat), f32), senders=_meta((e,), i32),
                        receivers=_meta((e,), i32), distances=_meta((e,), f32), edge_mask=_meta((e,), torch.bool),
                        targets=_meta((n,), f32))


def _gnn_cell(cfg: SchNetConfig, shape, ctx: ParallelCtx, device, abstract: bool) -> Cell:
    cfg = dataclasses.replace(cfg, unroll=True)
    if shape.kind == "sampled":
        cfg = dataclasses.replace(cfg, max_z=shape.n_nodes)
    model, axes = _init(S.init_schnet, cfg, device, abstract)
    distribute_module(model, axes, ctx)
    p_shard = params_sharding(axes, ctx)
    sds = _gnn_batch_sds(cfg, shape, 2048)
    e_shard, n_shard = ctx.sharding("edges"), ctx.sharding("nodes")
    b_shard = S.GraphBatch(
        node_z=n_shard if sds.node_z is not None else None,
        node_feat=ctx.sharding("nodes", None) if sds.node_feat is not None else None,
        senders=e_shard, receivers=e_shard, distances=e_shard,
        edge_mask=e_shard if sds.edge_mask is not None else None,
        graph_ids=n_shard if sds.graph_ids is not None else None,
        targets=n_shard)
    step, opt = make_gnn_train_step(cfg, ctx, n_graphs=(shape.batch_graphs if shape.kind == "batched" else 0))
    opt_state = opt.init(model)
    o_shard = _state_sharding(_opt_axes_safe("adamw", stacked_shapes(model), axes), ctx)
    return Cell(step, (model, opt_state, _blocks(sds, b_shard, device)), (p_shard, o_shard, b_shard), cfg, shape,
                donate=(0, 1), batch_arg=2)


def _recsys_batch_sds(cfg: RecSysConfig, shape: RecSysShape):
    """The batch of a recommendation shape as meta tensors; retrieval's
    candidates padded to a multiple of 2048 (the (data x model) axis)."""
    i32, f32 = torch.int32, torch.float32
    b = shape.batch
    fields = {f.name: _meta((b, f.multi_hot) if f.multi_hot > 1 else (b,), i32) for f in cfg.fields}
    return R.RecBatch(fields=fields,
                      history=_meta((b, cfg.seq_len), i32) if cfg.seq_len else None,
                      target_item=_meta((b,), i32) if cfg.item_vocab else None,
                      label=_meta((b,), f32),
                      candidates=(_meta((b, _round_up(shape.n_candidates, 2048)), i32)
                                  if shape.kind == "retrieval" else None))


def _recsys_cell(cfg: RecSysConfig, shape: RecSysShape, ctx: ParallelCtx, device, abstract: bool) -> Cell:
    cfg = dataclasses.replace(cfg, unroll=True)
    model, axes = _init(R.init_recsys, cfg, device, abstract)
    distribute_module(model, axes, ctx)
    p_shard = _shardings(axes, ctx)
    sds = _recsys_batch_sds(cfg, shape)
    bs, bs2 = ctx.sharding("batch"), ctx.sharding("batch", None)
    b_shard = R.RecBatch(
        fields={k: (bs2 if v.dim() == 2 else bs) for k, v in sds.fields.items()},
        history=bs2 if sds.history is not None else None,
        target_item=bs if sds.target_item is not None else None,
        label=bs,
        candidates=ctx.sharding("batch", "candidates") if sds.candidates is not None else None)
    batch = _blocks(sds, b_shard, device)
    if shape.kind == "train":
        step, opt = make_recsys_train_step(cfg, ctx)
        opt_state = opt.init(model)
        o_shard = _state_sharding(_opt_axes_safe("adamw", stacked_shapes(model), axes), ctx)
        return Cell(step, (model, opt_state, batch), (p_shard, o_shard, b_shard), cfg, shape, donate=(0, 1),
                    batch_arg=2)
    if shape.kind == "serve":
        fn = lambda p, bt: R.forward_logits(p, cfg, bt, ctx)   # noqa: E731
    else:
        fn = lambda p, bt: R.retrieval_scores(p, cfg, bt, ctx, k=100)   # noqa: E731
    return Cell(_no_grad(fn), (model, batch), (p_shard, b_shard), cfg, shape, batch_arg=1)


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------

def _cell_setup(arch: str, shape_name: str, mesh, batch: Optional[int]):
    """(config, shape, context) of a cell, ``batch`` replacing the shape's
    (an LM's ``global_batch``, a recommendation shape's ``batch``)."""
    from repro_torch import configs as config_registry

    cfg = config_registry.get_config(arch, shape_name)
    shape = shape_by_name(cfg.family, shape_name)
    if batch is not None:
        shape = dataclasses.replace(shape, **{"global_batch" if cfg.family == "lm" else "batch": batch})
    return cfg, shape, ParallelCtx(mesh, rules_for_shape(cfg, shape, mesh))


def build_cell(arch: str, shape_name: str, mesh, *, device="cuda", abstract: bool = True,
               n_layers: Optional[int] = None, batch: Optional[int] = None) -> Cell:
    """The :class:`Cell` of ``arch`` at ``shape_name`` on ``mesh`` (a
    ``DeviceMesh``; this rank's blocks), its tensors on ``device``:
    fake (:func:`abstract_init`, nothing allocated) with ``abstract``,
    else drawn for real.  For an LM, ``n_layers`` cuts the depth;
    ``batch`` replaces the shape's batch."""
    cfg, shape, ctx = _cell_setup(arch, shape_name, mesh, batch)
    if cfg.family == "lm":
        if n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        return _lm_cell(cfg, shape, ctx, device, abstract)
    if cfg.family == "gnn":
        return _gnn_cell(cfg, shape, ctx, device, abstract)
    return _recsys_cell(cfg, shape, ctx, device, abstract)


def build_lm_probe(arch: str, shape_name: str, mesh, *, n_layers: int = 1, device="cuda", abstract: bool = True,
                   batch: Optional[int] = None) -> Cell:
    """``arch``'s LM cell at ``shape_name`` cut to ``n_layers`` with the
    probe's attention chunks (:func:`probe_chunks`).  The reference's probe
    is one block, because XLA counts a rolled layer scan's body once; the
    port's layers run unrolled, so the probe is the whole step, and the
    cell at two layers less the cell at one is one layer with everything
    that goes with it (its block, its leaves' optimizer update and ZeRO's
    collectives of them: ``launch.dryrun.extend_lm``)."""
    cfg, shape, ctx = _cell_setup(arch, shape_name, mesh, batch)
    return _lm_cell(probe_chunks(dataclasses.replace(cfg, n_layers=n_layers)), shape, ctx, device, abstract)


def all_cells():
    """All 40 (arch, shape) pairs, in the reference's order."""
    from repro_torch import configs as config_registry

    out = []
    for arch in config_registry.all_archs():
        cfg = config_registry.get_config(arch)
        for s in cfg.shapes:
            out.append((arch, s.name))
    return out


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _arg_leaves(node, prefix: str, refs: dict):
    """``(path, shape, dtype)`` of one argument's local blocks by the
    reference's leaves: a module's stacked layers, and an optimizer
    state's entries keyed by the port's layer names, as one leaf with the
    layers in front."""
    if node is None:
        return
    if isinstance(node, torch.Tensor):
        x = _local(node)
        yield prefix, tuple(x.shape), x.dtype
    elif isinstance(node, torch.nn.Module):
        leaves = named_leaves(node)
        for ref, names in reference_leaves(node).items():
            x = _local(leaves[names[0]])
            yield f"{prefix}.{ref}", (tuple(x.shape) if names == [ref] else (len(names), *x.shape)), x.dtype
    elif isinstance(node, dict):
        layers = {}
        for k, v in node.items():
            if refs.get(k, k) != k:
                layers.setdefault(refs[k], []).append(_local(v))
            else:
                yield from _arg_leaves(v, f"{prefix}.{k}", refs)
        for ref, parts in layers.items():
            yield f"{prefix}.{ref}", (len(parts), *parts[0].shape), parts[0].dtype
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for name, v in zip(node._fields, node):
            yield from _arg_leaves(v, f"{prefix}.{name}", refs)
    elif isinstance(node, (tuple, list)):
        for i, v in enumerate(node):
            yield from _arg_leaves(v, f"{prefix}.{i}", refs)
    else:
        raise TypeError(f"{prefix}: {type(node).__name__} is no argument tree")


def arg_shapes(cell: Cell) -> Dict[str, tuple]:
    """``{path: (shape, dtype name)}`` of this rank's argument blocks, by
    the reference's leaves (``"0.blocks.attn.wq"``, ``"1.m.embed"``,
    ``"2.tokens"``): a stacked leaf's layers as a leading axis."""
    refs = {}
    for arg in cell.args:
        if isinstance(arg, torch.nn.Module):
            refs.update((n, ref) for ref, names in reference_leaves(arg).items() for n in names)
    return {path: (shape, str(dt).replace("torch.", ""))
            for i, arg in enumerate(cell.args) for path, shape, dt in _arg_leaves(arg, str(i), refs)}


def storage_bytes(tree) -> Dict[int, int]:
    """``{storage id: bytes}`` of the local tensors in ``tree`` (modules,
    ``DTensor``s, dicts, tuples), each storage once."""
    out = {}

    def walk(node):
        if isinstance(node, torch.Tensor):
            st = _local(node).untyped_storage()
            out[id(st)] = st.nbytes()
        elif isinstance(node, torch.nn.Module):
            for t in named_leaves(node).values():
                walk(t)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (tuple, list)):
            for v in node:
                walk(v)

    walk(tree)
    return out
