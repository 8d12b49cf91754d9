"""Collectives over the axes of a ``DeviceMesh`` (counterpart of
``repro/distributed/collectives.py``): the distributed top-k merge, the
hierarchical (pod-aware) gradient reduction with optional compression,
and the primitives the port's SPMD code is written with.

Every function here is called by every rank of the mesh with the same
logical arguments, as a ``shard_map`` body runs on every device.  An axis
is a mesh dim name or a tuple of names; a collective over a tuple runs
over each name in turn, last name first, so that a gathered axis is in
row-major order of the names (``jax.lax.all_gather`` over ``("a", "b")``).

Each collective runs on the tensors' own device through the group's
backend (NCCL, or gloo where several ranks share one card or run on the
CPU); a backend that refuses a device raises.

The autograd functions are the transposes ``shard_map`` gives: an
all-to-all's is an all-to-all, an all-gather's a reduce-scatter and back,
a psum's a psum.  :func:`to_block` and :func:`from_blocks` are the
boundary between a logical tensor that every rank holds whole and the
blocks the ranks compute on; their gradients make every rank hold the
logical gradient, as ``jax.grad`` of a ``shard_map`` gives it.

The models' per-rank code (``models/{layers,transformer,recsys,schnet}``
under a mesh) is written Megatron-style on top of these: a loss that
every rank holds alike is differentiated by every rank with the same
cotangent, so a sum that makes such a replicated value (:func:`all_sum`)
passes its gradient through unchanged, and a parameter block that several
ranks use on different tokens gets the sum of their gradients
(:func:`rank_block`).  Without a mesh (a ``None`` sharding or axis)
:func:`rank_block`, :func:`from_blocks`, :func:`gather_full`,
:func:`all_sum` and the axis collectives are identities, so that the
same per-rank code runs on one device.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from repro_torch.core.brute_force import select_topk
from repro_torch.distributed.mesh_utils import mesh_sizes
from repro_torch.distributed.sharding import NamedSharding, local_block, splits

__all__ = ["axis_names", "all_gather", "all_reduce", "all_to_all", "reduce_scatter", "broadcast",
           "all_to_all_axis", "gather_axis", "scatter_axis", "psum", "sum_grad", "all_sum", "all_max", "pmean_all",
           "to_block", "from_blocks", "rank_block",
           "gather_full", "gather_columns", "distributed_topk", "hierarchical_psum", "dp_allreduce_grads"]


def all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``x``, in group rank order."""
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    return out


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group, as a new tensor."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block ``i`` of ``x``'s dim 0 goes to rank ``i``; block ``j`` of the
    result came from rank ``j`` (``jax.lax.all_to_all`` with split and
    concat axis 0)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum over the group of ``x``, of which rank ``i`` keeps block
    ``i`` along ``dim`` (an all-to-all, then the sum over its sources in
    rank order)."""
    n = dist.get_world_size(group)
    moved = x.movedim(dim, 0)
    parts = all_to_all(moved.reshape(n, moved.shape[0] // n, *moved.shape[1:]), group)
    return parts.sum(0).movedim(0, dim)


def broadcast(x: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``x`` of global rank ``src`` on every rank of the group (a new
    tensor; ``x`` gives the shape and dtype elsewhere)."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.broadcast(out, src=src, group=group)
    return out


def axis_names(axis) -> tuple:
    return () if axis is None else (axis,) if isinstance(axis, str) else tuple(axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return torch.cat(all_gather(x, group), dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ScatterDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return torch.cat(all_gather(g, ctx.group), ctx.dim), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _SumGrad(torch.autograd.Function):
    """The identity; its gradient is summed over ``groups``."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        for group in ctx.groups:
            g = all_reduce(g, group)
        return g, None


class _AllSum(torch.autograd.Function):
    """The sum over ``groups``; its gradient is the identity."""

    @staticmethod
    def forward(ctx, x, groups):
        for group in groups:
            x = all_reduce(x, group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def _groups(mesh: DeviceMesh, axis) -> list:
    return [mesh.get_group(a) for a in axis_names(axis)]


def all_to_all_axis(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """:func:`all_to_all` over one mesh axis, under autograd."""
    return _AllToAll.apply(x, mesh.get_group(axis))


def gather_axis(x: torch.Tensor, mesh: DeviceMesh, axis, dim: int) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=dim, tiled=True)``, under autograd."""
    for group in reversed(_groups(mesh, axis)):
        x = _GatherDim.apply(x, group, dim)
    return x


def scatter_axis(x: torch.Tensor, mesh: DeviceMesh, axis, dim: int) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``,
    under autograd."""
    for group in _groups(mesh, axis):
        x = _ScatterDim.apply(x, group, dim)
    return x


def psum(x: torch.Tensor, mesh: DeviceMesh, axis) -> torch.Tensor:
    """``jax.lax.psum`` over ``axis``, under autograd."""
    for group in _groups(mesh, axis):
        x = _Psum.apply(x, group)
    return x


def sum_grad(x: torch.Tensor, mesh: DeviceMesh, axis) -> torch.Tensor:
    """The identity, whose gradient is summed over ``axis``: an input
    replicated over ``axis`` gets the sum of its replicas' cotangents, as
    a ``shard_map`` input does."""
    groups = _groups(mesh, axis)
    return _SumGrad.apply(x, groups) if groups else x


def gather_full(block: torch.Tensor, sharding: Optional[NamedSharding], shape) -> torch.Tensor:
    """The whole tensor of ``shape`` from each rank's block of it (an
    all-gather over each sharded mesh dim, last first; short and empty
    blocks padded for the exchange and cut after it); ``block`` itself
    without a sharding (one device)."""
    x = block
    if sharding is None:
        return x
    for i, dim, n, _, _ in reversed(splits(shape, sharding)):
        per = -(-n // sharding.mesh.size(i))
        if x.shape[dim] < per:
            pad = list(x.shape)
            pad[dim] = per - x.shape[dim]
            x = torch.cat([x, x.new_zeros(pad)], dim)
        x = torch.cat(all_gather(x, sharding.mesh.get_group(i)), dim).narrow(dim, 0, n)
    return x


def _replicas(sharding: NamedSharding) -> int:
    return math.prod(sharding.mesh.size(i) for i, p in enumerate(sharding.placements)
                     if not isinstance(p, Shard))


class _FromBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, sharding, shape):
        ctx.sharding = sharding
        return gather_full(block, sharding, shape)

    @staticmethod
    def backward(ctx, g):
        # every rank holds the logical cotangent; the replicas of a block
        # share it, so that their sum (to_block's backward) counts it once
        return local_block(g, ctx.sharding) / _replicas(ctx.sharding), None, None


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.n = mesh.size()
        for name in mesh.mesh_dim_names:
            x = all_reduce(x, mesh.get_group(name))
        return x / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def all_sum(x: torch.Tensor, mesh: DeviceMesh, axis) -> torch.Tensor:
    """The sum over ``axis`` of per-rank partial values into one that every
    rank of ``axis`` then holds and uses alike (Megatron's reduction after
    a row-parallel product): each rank's cotangent of the result is the
    whole cotangent of its partial value, so the gradient is the identity."""
    if axis is None:
        return x
    groups = _groups(mesh, axis)
    return _AllSum.apply(x, groups) if groups else x


def all_max(x: torch.Tensor, mesh: DeviceMesh, axis) -> torch.Tensor:
    """The elementwise maximum over ``axis`` (no gradient: a softmax's
    shift)."""
    x = x.detach()
    groups = _groups(mesh, axis)
    if groups:
        x = x.clone(memory_format=torch.contiguous_format)
    for group in groups:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def pmean_all(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The mean over every rank of the mesh, held whole by every rank: its
    gradient on each rank is the logical one, 1/ranks of the cotangent."""
    return _Mean.apply(x, mesh)


def to_block(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of ``x``, which every rank holds whole.  Its
    gradient is the sum over every rank of the mesh of the blocks'
    gradients, each in its place: every rank gets the logical gradient."""
    x = sum_grad(x, sharding.mesh, sharding.mesh.mesh_dim_names)
    return local_block(x, sharding)


def from_blocks(block: torch.Tensor, sharding: Optional[NamedSharding], shape) -> torch.Tensor:
    """The whole tensor of ``shape`` on every rank, from each rank's block
    (:func:`gather_full` under autograd); ``block`` itself without a
    sharding (one device)."""
    return block if sharding is None else _FromBlocks.apply(block, sharding, tuple(shape))


def rank_block(x, sharding: Optional[NamedSharding], split=None, deferred=()) -> torch.Tensor:
    """This rank's block of a parameter or an input as ``sharding`` lays it
    out, for per-rank code: from a ``DTensor`` (redistributed if laid out
    otherwise), or sliced from a tensor that every rank holds whole.  Its
    gradient is summed over ``split`` (default: every mesh axis the block
    is replicated on), the axes along which the ranks holding one block
    use it on different data (tokens, edges, heads): the block's gradient
    is then the logical one on every rank, as a ``shard_map`` input's.  A
    whole tensor's gradient is also summed over its sharded axes, each
    block in its place, so that every rank holds the whole logical
    gradient.  The axes in ``deferred`` are left out of the sum: the
    block's gradient is then this rank's part of the sum over them (a
    ZeRO step reduce-scatters it into each rank's block, where an
    all-reduce would move twice the bytes).  ``x`` itself without a
    sharding (one device)."""
    if sharding is None:
        return x
    mesh = sharding.mesh
    split = sharding.replicated_axes() if split is None else axis_names(split)
    split = tuple(a for a in split if a not in deferred)
    if isinstance(x, DTensor):
        if tuple(x.placements) != sharding.placements:
            x = x.redistribute(mesh, sharding.placements)
        return sum_grad(x.to_local(), mesh, split)
    sharded = tuple(n for n in mesh.mesh_dim_names if n not in sharding.replicated_axes())
    return local_block(sum_grad(x, mesh, sharded + tuple(split)), sharding)


def distributed_topk(scores_local: torch.Tensor, base_offset: int, k: int, axis, *, mesh: DeviceMesh):
    """Per-rank ``[B, n_local]`` scores -> the global top-k over ``axis``:
    a local top-k (``select_topk``'s order), ids rebased by
    ``base_offset``, an all-gather of the k-lists in axis order, a merge.
    Wire cost O(B * k * shards).  ``scores_local`` needs at least k
    columns."""
    vals, idx = select_topk(scores_local, k)
    idx = idx.to(torch.int32) + base_offset
    all_v = gather_columns(vals, mesh, axis)
    all_i = gather_columns(idx, mesh, axis)
    v, pos = select_topk(all_v, k)
    return v, torch.gather(all_i, 1, pos)


def gather_columns(x: torch.Tensor, mesh: DeviceMesh, axis) -> torch.Tensor:
    """Every rank's ``[B, m]`` x side by side, ``[B, m * shards]``, in
    row-major order of ``axis``."""
    for a in reversed(axis_names(axis)):
        x = torch.cat(all_gather(x, mesh.get_group(a)), 1)
    return x


def hierarchical_psum(x: torch.Tensor, intra_axis: str, inter_axis: Optional[str], compress=None, *,
                      mesh: DeviceMesh) -> torch.Tensor:
    """Two-level gradient reduction: a full-precision psum over the
    intra-pod axis, then ``compress`` (e.g. an int8 round trip) and a psum
    over the cross-pod axis."""
    x = all_reduce(x, mesh.get_group(intra_axis))
    if inter_axis is not None:
        if compress is not None:
            x = compress(x)
        x = all_reduce(x, mesh.get_group(inter_axis))
    return x


def _tree_map(fn, tree):
    """``fn`` over the tensors of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def dp_allreduce_grads(grads, mesh: DeviceMesh, dp_axes: Sequence[str] = ("pod", "data"), compress=None):
    """The mean of every rank's gradients over the data-parallel axes
    present in ``mesh``, ``compress`` applied on the cross-pod hop only."""
    present = [a for a in dp_axes if a in mesh.mesh_dim_names]
    if not present:
        return grads
    intra = present[-1]
    inter = present[0] if len(present) > 1 else None
    sizes = mesh_sizes(mesh)
    n = math.prod(sizes[a] for a in present)
    return _tree_map(lambda g: hierarchical_psum(g, intra, inter, compress, mesh=mesh) / n, grads)
