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
The dry run's cell machinery (``Cell``, ``abstract_init``, ``build_cell``,
``all_cells`` and the probes) reads XLA artifacts and is not ported here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs.base import (GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES, LMShape, RecSysConfig, RecSysShape,
                                      SchNetConfig, TransformerConfig)
from repro_torch.distributed import collectives as C
from repro_torch.distributed.mesh_utils import mesh_axis_size
from repro_torch.distributed.sharding import ParallelCtx
from repro_torch.models import recsys as R
from repro_torch.models import schnet as S
from repro_torch.models import transformer as T
from repro_torch.optim import make_optimizer
from repro_torch.optim.optimizer import AdafactorState, AdamState, MeshUpdate, named_leaves, reference_leaves

__all__ = ["shape_by_name", "rules_for_shape", "zero_axes_of", "stacked_shapes", "make_lm_train_step",
           "make_gnn_train_step", "make_recsys_train_step"]


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
    """``{reference leaf: the dim ZeRO shards}`` for the leaves it shards."""
    flat = _flatten(zero_axes_of(params_sds, params_axes, ctx, zero_axis))
    base = _flatten(params_axes)
    return {k: i for k, z in flat.items() for i, (a, b) in enumerate(zip(z, base[k]))
            if a == zero_axis and b is None}


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
