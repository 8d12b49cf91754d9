"""Elastic scaling: re-mesh a running job across topologies (counterpart
of ``repro/distributed/elastic.py``).

Checkpoints are topology-independent (logical, unsharded — see
``repro_torch.checkpoint``), so elasticity reduces to: build the new
mesh, re-derive shardings from the SAME logical rules, and restore.  This
module packages that flow plus the decision logic a controller runs when
membership changes (scale-down on failure, scale-up on spare arrival).

SPMD: every rank of the world calls :func:`remesh`.  The reference's
single controller gathers every leaf to the host; here the ranks of the
old mesh gather each leaf among themselves, and a rank that joins
receives it from the first of them, so that every rank of the new mesh
holds it whole before it keeps its block.  Ranks outside the new mesh
hold ``None``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.distributed.collectives import broadcast, gather_full
from repro_torch.distributed.mesh_utils import make_mesh
from repro_torch.distributed.sharding import NamedSharding, ParallelCtx, distribute, params_sharding

__all__ = ["Topology", "plan_remesh", "remesh"]


@dataclasses.dataclass(frozen=True)
class Topology:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def plan_remesh(available_devices: int, prefer_model: int,
                axes: Sequence[str] = ("data", "model")) -> Topology:
    """Pick a mesh for the devices that remain.  Policy: keep the model
    (TP) degree if divisible — TP degree is baked into per-layer shard
    shapes and changing it churns every buffer; shrink data parallelism
    instead (the standard elastic-DP policy)."""
    model = prefer_model
    while model > 1 and (available_devices % model != 0):
        model //= 2
    data = available_devices // model
    return Topology((data, model), tuple(axes))


def _whole(leaf, old_ctx: Optional[ParallelCtx]):
    """Every rank's copy of the whole leaf: gathered among the old mesh's
    ranks, then broadcast from the first of them to every rank of the
    world.  A plain tensor (no old mesh) is already whole everywhere."""
    if old_ctx is None or old_ctx.mesh is None:
        return leaf
    old = old_ctx.mesh
    src = int(old.mesh.flatten()[0])
    if old.get_coordinate() is not None:
        leaf = gather_full(leaf.to_local(), NamedSharding.of(leaf), leaf.shape) if isinstance(leaf, DTensor) \
            else leaf
        meta = [(tuple(leaf.shape), leaf.dtype, str(leaf.device))]
    else:
        meta = [None]
    dist.broadcast_object_list(meta, src=src)
    shape, dtype, device = meta[0]
    if leaf is None:
        leaf = torch.empty(shape, dtype=dtype, device=device)
    return broadcast(leaf, src)


def _walk(tree, shardings, old_ctx):
    if isinstance(shardings, dict):
        return {k: _walk(None if tree is None else tree[k], v, old_ctx) for k, v in shardings.items()}
    return distribute(_whole(tree, old_ctx), shardings)


def remesh(tree, axes_tree, rules, old_ctx: Optional[ParallelCtx], topo: Topology,
           device=None) -> Tuple[object, ParallelCtx]:
    """Re-shard a tree of tensors (nested dicts; ``DTensor``s on
    ``old_ctx``'s mesh, or tensors every rank holds whole when ``old_ctx``
    is None; ``None`` on a rank outside the old mesh) onto a new mesh of
    ``topo`` over the first ranks of the world.  Returns (the tree of
    ``DTensor``s, or ``None`` on a rank outside the new mesh; the new
    ``ParallelCtx``)."""
    mesh = make_mesh(topo.shape, topo.axes, device)
    ctx = ParallelCtx(mesh, rules)
    placed = _walk(tree, params_sharding(axes_tree, ctx), old_ctx)
    return (placed if mesh.get_coordinate() is not None else None), ctx
