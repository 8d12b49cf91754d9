"""Mesh construction helpers (counterpart of
``repro/distributed/mesh_utils.py``).

The reference has one controller: a ``jax.sharding.Mesh`` in one process
spans every device.  The port is SPMD over a process group: a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose ``mesh_dim_names`` are
the reference's axis names, and every rank of the group builds it and
calls each function that takes it with the same logical arguments (as a
``shard_map`` body runs on every device).  :func:`init_rank` joins a
rank to its group first.  Nothing here runs at import time.
"""

from __future__ import annotations

import math
from datetime import timedelta
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve_device

__all__ = ["init_rank", "make_mesh", "local_mesh", "mesh_axis_size", "mesh_sizes"]


def init_rank(rank: int, world: int, store_path: str, *, backend: str = "gloo",
              timeout_s: float = 60.0) -> None:
    """Join this process to the default process group as ``rank`` of
    ``world``, meeting the others through the file ``store_path`` (a
    ``file://`` store: no port to collide on).  ``timeout_s`` bounds the
    rendezvous and every collective after it, so a peer that died fails
    the others instead of hanging them.  NCCL needs a card for each rank;
    several ranks sharing one card use gloo."""
    dist.init_process_group(backend, init_method=f"file://{store_path}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=timeout_s))


def make_mesh(shape: Sequence[int], axes: Sequence[str], device=None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over the first ranks of the
    initialised world (all of them when the sizes agree, as
    ``jax.make_mesh`` takes the first devices), its dims named ``axes``, on
    ``device``'s type (None: the card).  Every rank of the world calls it;
    a rank outside the mesh gets ``get_coordinate() is None``."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    n, world = math.prod(shape), dist.get_world_size()
    if n > world:
        raise ValueError(f"a mesh of shape {shape} needs {n} ranks; the world has {world}")
    return DeviceMesh(resolve_device(device).type, torch.arange(n).reshape(shape), mesh_dim_names=axes)


def local_mesh(axes: Sequence[str] = ("data", "model"), device=None) -> DeviceMesh:
    """``[1, ..., world]`` over the initialised world (the reference's
    ``[1, ..., n_devices]``)."""
    return make_mesh([1] * (len(axes) - 1) + [dist.get_world_size()], axes, device)


def mesh_sizes(mesh: DeviceMesh) -> dict:
    """``{axis name: size}``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_axis_size(mesh, axis) -> int:
    """Product size of ``axis`` (a name or a tuple of names); a missing
    mesh, axis or name counts 1."""
    if mesh is None or axis is None:
        return 1
    sizes = mesh_sizes(mesh)
    size = 1
    for a in ((axis,) if isinstance(axis, str) else tuple(axis)):
        size *= sizes.get(a, 1)
    return size

