"""Logical-axis sharding: map model-level dimension names to mesh axes
(counterpart of ``repro/distributed/sharding.py``).

Models name the dimensions of parameters and activations with *logical*
axes ("heads", "ff", "vocab", "batch", ...), and a per-arch rule table
(``repro_torch.configs.base``) maps them onto mesh axes.  Rules naming
absent mesh axes drop them, so ("pod", "data") degrades to ("data",) on a
single-pod mesh.

A mesh is a ``DeviceMesh`` (:mod:`repro_torch.distributed.mesh_utils`).
A spec is a tuple with one entry per tensor dim: ``None``, an axis name,
or a tuple of names (``PartitionSpec``'s entries).  :class:`NamedSharding`
pairs a mesh with a spec and gives the ``DTensor`` placements (one per
mesh dim); :func:`distribute` takes each rank's block of a tensor that
every rank holds whole, without communication.  ``mesh=None`` disables
everything: one device, one shard on every axis.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.mesh_utils import mesh_axis_size

__all__ = ["ParallelCtx", "NamedSharding", "params_sharding", "splits", "block_slices", "local_block",
           "axis_block", "distribute", "leaf_axes", "distribute_module"]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (one entry per tensor dim)."""

    mesh: DeviceMesh
    spec: Tuple

    @classmethod
    def of(cls, x: DTensor) -> "NamedSharding":
        """The sharding of a ``DTensor`` (splits of one dim in mesh order)."""
        spec = [[] for _ in range(x.ndim)]
        for name, p in zip(x.device_mesh.mesh_dim_names, x.placements):
            if isinstance(p, Shard):
                spec[p.dim].append(name)
            elif not isinstance(p, Replicate):
                raise ValueError(f"placement {p} has no spec")
        return cls(x.device_mesh, tuple(None if not a else a[0] if len(a) == 1 else tuple(a) for a in spec))

    def replicated_axes(self) -> Tuple[str, ...]:
        """The mesh axes this sharding does not split."""
        return tuple(n for n, p in zip(self.mesh.mesh_dim_names, self.placements) if not isinstance(p, Shard))

    @property
    def placements(self) -> Tuple:
        """One ``Shard(dim)`` or ``Replicate()`` per mesh dim.  A tensor dim
        over several mesh axes splits in mesh order (the reference's
        ``("pod", "data")``: pod major), so its names must come in mesh
        order."""
        names = self.mesh.mesh_dim_names
        out = [Replicate()] * len(names)
        for dim, entry in enumerate(self.spec):
            axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
            where = [names.index(a) for a in axes]
            if where != sorted(where):
                raise ValueError(f"spec entry {entry!r} is not in the mesh's axis order {names}")
            for i in where:
                out[i] = Shard(dim)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """Mesh + logical rules threaded through model apply functions.

    ``mesh=None`` disables all constraints (one device).  ``deferred``
    names mesh axes over which the models' per-rank code leaves the sum of
    its parameters' gradients to the caller (``collectives.rank_block``):
    a ZeRO step reduce-scatters those parts into each rank's block."""

    mesh: Optional[DeviceMesh]
    rules: Mapping[str, object]
    deferred: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.mesh is not None and not isinstance(self.mesh, DeviceMesh):
            raise TypeError(f"a ParallelCtx's mesh is a torch.distributed DeviceMesh, not a "
                            f"{type(self.mesh).__name__}")

    def _resolve(self, logical: Optional[str]):
        if logical is None or self.mesh is None:
            return None
        phys = self.rules.get(logical)
        if phys is None:
            return None
        axes = (phys,) if isinstance(phys, str) else tuple(phys)
        present = tuple(a for a in axes if a in self.mesh.mesh_dim_names)
        if not present:
            return None
        return present if len(present) > 1 else present[0]

    def spec(self, *logical: Optional[str]) -> Tuple:
        return tuple(self._resolve(name) for name in logical)

    def sharding(self, *logical: Optional[str]) -> Optional[NamedSharding]:
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, self.spec(*logical))

    def constrain(self, x, *logical: Optional[str]):
        """A ``DTensor`` redistributed to the logical axes' placements; a
        plain tensor unchanged (a GSPMD constraint changes no value)."""
        if self.mesh is None or not isinstance(x, DTensor):
            return x
        return x.redistribute(self.mesh, self.sharding(*logical).placements)

    def axis_size(self, logical: str) -> int:
        """Number of shards a logical axis maps onto."""
        if self.mesh is None:
            return 1
        return mesh_axis_size(self.mesh, self.rules.get(logical))

    def mesh_axes(self, logical: str):
        """Physical axis name(s) for per-rank code, or None."""
        return self._resolve(logical)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def params_sharding(axes_tree, ctx: ParallelCtx):
    """The tree of logical-axis tuples ``axes_tree`` (mirroring a params
    tree) with every leaf replaced by its :class:`NamedSharding` (``None``
    without a mesh).  A leaf that is ``None`` itself stays ``None``."""
    if isinstance(axes_tree, Mapping):
        return {k: params_sharding(v, ctx) for k, v in axes_tree.items()}
    if axes_tree is None:
        return None
    if _is_axes(axes_tree):
        return ctx.sharding(*axes_tree)
    raise TypeError(f"not a tree of logical-axis tuples: {axes_tree!r}")


def splits(shape, sharding: NamedSharding):
    """Each split of this rank's block of a tensor of ``shape``, in mesh
    order: (mesh dim, tensor dim, the dim's length before the split, the
    block's start after it, its length after it).  A split of n over s
    ranks gives ceil(n / s) to a rank, the last ones short or empty, as
    ``DTensor`` cuts.  None on a rank outside the mesh."""
    coord = sharding.mesh.get_coordinate()
    if coord is None:
        return None
    cuts = [[0, int(n)] for n in shape]
    out = []
    for i, p in enumerate(sharding.placements):
        if isinstance(p, Shard):
            start, n = cuts[p.dim]
            per = -(-n // sharding.mesh.size(i))
            lo = min(per * coord[i], n)
            cuts[p.dim] = [start + lo, min(per, n - lo)]
            out.append((i, p.dim, n, *cuts[p.dim]))
    return out


def block_slices(shape, sharding: NamedSharding):
    """This rank's block of a tensor of ``shape``: one ``(start, length)``
    per dim; None on a rank outside the mesh."""
    done = splits(shape, sharding)
    if done is None:
        return None
    cuts = [(0, int(n)) for n in shape]
    for _, dim, _, lo, n in done:
        cuts[dim] = (lo, n)
    return cuts


def local_block(x: torch.Tensor, sharding: NamedSharding) -> Optional[torch.Tensor]:
    """This rank's block of ``x`` (a view), or None outside the mesh."""
    cuts = block_slices(x.shape, sharding)
    if cuts is None:
        return None
    for dim, (lo, n) in enumerate(cuts):
        if (lo, n) != (0, x.shape[dim]):
            x = x.narrow(dim, lo, n)
    return x


def axis_block(n: int, mesh: DeviceMesh, axes) -> Tuple[int, int]:
    """(global start, length) of this rank's block of a dim of ``n`` split
    over ``axes`` (a mesh axis name, a tuple of them in mesh order, or
    None), as ``DTensor`` cuts it: per-rank code reads vocabulary rows,
    heads, sequence positions and table rows by their global index with
    it.  (0, n) when ``axes`` is None; (0, 0)-style empty blocks for the
    last ranks of an uneven split."""
    if axes is None or mesh is None:
        return 0, int(n)
    return block_slices((n,), NamedSharding(mesh, (axes,)))[0]


def distribute(x: torch.Tensor, sharding: Optional[NamedSharding]):
    """``x``, which every rank holds whole, as a ``DTensor`` of which each
    rank keeps its block (no communication); ``x`` itself when ``sharding``
    is None; None on a rank outside the mesh."""
    if sharding is None:
        return x
    block = local_block(x, sharding)
    if block is None:
        return None
    return DTensor.from_local(block.contiguous(), sharding.mesh, sharding.placements, run_check=False,
                              shape=x.shape, stride=torch.empty(x.shape, device="meta").stride())


def leaf_axes(axes_tree, name: str, stacked=()):
    """The logical axes of the parameter ``name`` (dotted, as
    ``named_parameters`` gives it) in the axes tree of its model's init:
    a layer index after a stacked list's name (``blocks.3``) drops the
    stacked layer axis, which the port's one-module-a-layer leaves lack."""
    node, lead = axes_tree, False
    parts = name.split(".")
    i = 0
    while i < len(parts):
        part = parts[i]
        node = node[int(part)] if isinstance(node, (list, tuple)) and not _is_axes(node) else node[part]
        if part in stacked and i + 1 < len(parts) and parts[i + 1].isdigit():
            lead, i = True, i + 1
        i += 1
    return tuple(node[1:]) if lead else tuple(node)


def distribute_module(module, axes_tree, ctx: ParallelCtx):
    """``module`` with every parameter replaced, in place, by a ``DTensor``
    parameter of which this rank keeps its block (a copy: the whole tensor
    can go), placed by its logical axes (:func:`leaf_axes`) under ``ctx``
    (no communication: every rank holds the whole module).  Returns the module; without a mesh it is
    unchanged."""
    import torch.nn as nn

    if ctx.mesh is None:
        return module
    stacked = tuple(getattr(module, "STACKED", ()))
    for name, p in list(module.named_parameters()):
        owner = module
        *path, last = name.split(".")
        for part in path:
            owner = owner[int(part)] if part.isdigit() else (owner[part] if isinstance(owner, nn.ParameterDict)
                                                              else getattr(owner, part))
        new = distribute(p.detach(), ctx.sharding(*leaf_axes(axes_tree, name, stacked)))
        block = new.to_local()
        if block.untyped_storage().nbytes() > block.numel() * block.element_size():
            # a view would keep the whole tensor alive: the module keeps its block alone
            new = DTensor.from_local(block.clone(), new.device_mesh, new.placements, run_check=False,
                                     shape=new.shape, stride=new.stride())
        new = nn.Parameter(new, requires_grad=p.requires_grad)
        if isinstance(owner, nn.ParameterDict):
            owner[last] = new
        else:
            setattr(owner, last, new)
    return module
