"""Production mesh construction (counterpart of ``repro/launch/mesh.py``).

A FUNCTION, not a module-level constant: importing this module touches no
process group."""

from __future__ import annotations

import torch.distributed as dist

from repro_torch.distributed.mesh_utils import make_mesh

__all__ = ["make_production_mesh"]


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """``("data", "model") = (16, 16)``, or ``("pod", "data", "model") =
    (2, 16, 16)`` with ``multi_pod``, over an initialised world of exactly
    that many ranks; any other world raises ``ValueError``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"the production mesh {shape} needs a world of {need} ranks; this one has {world}")
    return make_mesh(shape, axes, device)
