"""Logical-axis sharding on one device (counterpart of
``repro/distributed/sharding.py``).

Models name the dimensions of parameters and activations with *logical*
axes ("heads", "ff", "vocab", "batch", ...), and a per-arch rule table
(``repro_torch.configs.base``) maps them onto mesh axes.  The port runs
on one device: a ``ParallelCtx`` without a mesh constrains nothing,
places nothing and counts one shard on every axis.  A mesh waits for the
port's distributed layer (``torch.distributed``) and raises
``NotImplementedError``, as ``serving.sharded.shard_corpus(ctx=...)``
does.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

__all__ = ["ParallelCtx", "params_sharding"]


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """Mesh + logical rules threaded through model apply functions.

    Only ``mesh=None`` is ported: every method is then the identity of
    ``repro``'s with ``mesh=None``."""

    mesh: Optional[object]
    rules: Mapping[str, object]

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "a ParallelCtx with a mesh needs the port's distributed layer, "
                "which is not ported yet; use ParallelCtx(None, rules) on one device")

    def spec(self, *logical: Optional[str]) -> Tuple[None, ...]:
        """One ``None`` (replicated) per dimension."""
        return (None,) * len(logical)

    def sharding(self, *logical: Optional[str]) -> None:
        return None

    def constrain(self, x, *logical: Optional[str]):
        return x

    def axis_size(self, logical: str) -> int:
        """Number of shards a logical axis maps onto: 1 without a mesh."""
        return 1

    def mesh_axes(self, logical: str) -> None:
        return None


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def params_sharding(axes_tree, ctx: ParallelCtx):
    """The tree of logical-axis tuples ``axes_tree`` (mirroring a params
    tree) with every leaf replaced by its sharding: ``None`` on one
    device.  A leaf that is ``None`` itself stays ``None``."""
    if isinstance(axes_tree, Mapping):
        return {k: params_sharding(v, ctx) for k, v in axes_tree.items()}
    if axes_tree is None or _is_axes(axes_tree):
        return ctx.sharding(*(axes_tree or ()))
    raise TypeError(f"not a tree of logical-axis tuples: {axes_tree!r}")
