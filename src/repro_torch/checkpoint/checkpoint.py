"""Topology-independent checkpointing (counterpart of
``repro/checkpoint/checkpoint.py``), in the reference's on-disk layout.

A checkpoint is one ``.npy`` per tree leaf, keyed by its path, plus a
``manifest.json`` (step; each leaf's file, dtype and shape), written into
a temp directory and renamed into place, so that a crash mid-save never
leaves a torn ``step_<n>`` directory.  Paths join dict keys, list
indices and a module's parameter names with ``/``, and a NamedTuple's
fields as ``.name`` (as JAX prints a field): the port's AdamW state is
``opt/.m/blocks/3/attn/wq``.  numpy has no bf16: a bf16 leaf is written as
its 2-byte patterns (``|V2``, as ``repro`` writes it) and the manifest
records ``bfloat16``.  ``interop.read_repro_checkpoint`` reads a
directory that ``repro`` wrote into the port's structures.

Over a mesh a leaf may be a ``DTensor``: :func:`host_array` gathers it
(every rank of its mesh takes part), the writer is the rank at the
mesh's origin (:func:`is_writer`) while the others wait at a barrier
(``CheckpointManager.save``), and a restore in place copies each rank's
block of the leaf it reads.  The layout on disk is the same.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from collections.abc import Mapping
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor

__all__ = ["flatten_with_paths", "host_array", "save_checkpoint", "write_leaves", "restore_checkpoint",
           "checkpoint_step", "load_leaves", "mesh_of", "is_writer", "mesh_barrier"]

_BF16_DISK = np.dtype("V2")


def flatten_with_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """``{path: leaf}`` of a tree of tensors (or numpy arrays): dicts,
    lists, NamedTuples and modules (by parameter name)."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return {prefix: tree}
    join = (lambda k: f"{prefix}/{k}") if prefix else (lambda k: str(k))
    if isinstance(tree, nn.Module):
        return {join(name.replace(".", "/")): p for name, p in tree.named_parameters()}
    if hasattr(tree, "_fields"):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = [(str(k).replace(".", "/"), v) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        raise TypeError(f"{prefix or 'tree'}: cannot checkpoint a {type(tree).__name__}")
    out = {}
    for k, v in items:
        if v is not None:
            out.update(flatten_with_paths(v, join(k)))
    return out


def host_array(x, copy: bool = False) -> np.ndarray:
    """A leaf as the numpy array written to disk (bf16 as ``|V2`` bit
    patterns); ``copy`` makes it independent of the tensor's storage.  A
    ``DTensor`` is gathered whole first: every rank of its mesh calls this."""
    if isinstance(x, np.ndarray):
        return x.copy() if copy else x
    if isinstance(x, DTensor):
        from repro_torch.distributed.collectives import gather_full
        from repro_torch.distributed.sharding import NamedSharding

        x = gather_full(x.to_local().detach(), NamedSharding.of(x), x.shape)
    t = x.detach()
    t = t.to("cpu", copy=True) if copy else t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_DISK)
    return t.numpy()


def mesh_of(leaves) -> Optional[object]:
    """The mesh of the first ``DTensor`` among ``leaves`` (None: none is)."""
    for leaf in leaves:
        if isinstance(leaf, DTensor):
            return leaf.device_mesh
    return None


def is_writer(mesh) -> bool:
    """Whether this rank writes a checkpoint of a tree laid out on ``mesh``:
    the rank at the mesh's origin (every rank without a mesh)."""
    if mesh is None:
        return True
    coord = mesh.get_coordinate()
    return coord is not None and not any(coord)


def mesh_barrier(mesh):
    """Every rank of ``mesh`` waits for the others (a one-element sum over
    each of its axes)."""
    x = torch.zeros(1, device=mesh.device_type)
    for name in mesh.mesh_dim_names:
        torch.distributed.all_reduce(x, group=mesh.get_group(name))


def _disk_dtype(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == _BF16_DISK else str(arr.dtype)


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Atomically save ``tree`` under ``directory/step_<step>``."""
    return write_leaves(directory, step, flatten_with_paths(tree))


def write_leaves(directory: str, step: int, leaves: Dict[str, Any]) -> str:
    """Atomically save ``{path: leaf}`` under ``directory/step_<step>``."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        manifest = {"step": step, "leaves": {}}
        for key, leaf in leaves.items():
            arr = host_array(leaf)
            fname = key.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][key] = {"file": fname, "dtype": _disk_dtype(arr), "shape": list(arr.shape)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


class _Leaves(Mapping):
    """A checkpoint's leaves by path, each read from its file when it is
    first asked for and kept (memory-mapped on the read).  :meth:`read`
    reads a leaf without keeping it: a restore then holds one leaf at a
    time, and ranks restoring one checkpoint share the page cache."""

    def __init__(self, path: str, manifest: dict):
        self.path, self.info, self._kept = path, manifest["leaves"], {}

    def read(self, key) -> torch.Tensor:
        info = self.info[key]
        arr = np.load(os.path.join(self.path, info["file"]), mmap_mode="r")
        if info["dtype"] == "bfloat16":
            return torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(np.array(arr))

    def __getitem__(self, key) -> torch.Tensor:
        if key not in self._kept:
            self._kept[key] = self.read(key)
        return self._kept[key]

    def __contains__(self, key) -> bool:
        return key in self.info

    def __iter__(self):
        return iter(self.info)

    def __len__(self):
        return len(self.info)


def load_leaves(path: str) -> Mapping[str, torch.Tensor]:
    """Every leaf of a checkpoint directory as a CPU tensor, by path (bf16
    leaves bit for bit): a mapping that reads each leaf when it is first
    asked for."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    return _Leaves(path, manifest)


def restore_checkpoint(path: str, target_tree: Any, shardings: Optional[Any] = None) -> Any:
    """Restore into ``target_tree``'s tensors in place (each cast to its
    target's dtype, on its target's device) and return the tree.  A leaf of
    another shape raises ``ValueError``.

    With ``shardings`` (a tree of :class:`~repro_torch.distributed.sharding.
    NamedSharding` or ``None`` leaves mirroring a target of nested dicts,
    as ``params_sharding`` makes it), every rank of the mesh calls this and
    gets a new tree: each leaf loaded, cast and distributed by its sharding
    (a ``DTensor`` of which the rank holds its block; a whole tensor where
    the sharding is ``None``; ``None`` on a rank outside the mesh).
    Without ``shardings`` a ``DTensor`` leaf of the target gets its block
    of the leaf read, in place."""
    leaves = load_leaves(path)

    def loaded(key, ref):
        arr = leaves.read(key)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {tuple(arr.shape)} vs target {tuple(ref.shape)}")
        return arr.to(ref.dtype)

    if shardings is not None:
        from repro_torch.distributed.sharding import distribute

        def place(tree, sh, prefix):
            if isinstance(tree, dict):
                return {k: place(v, sh.get(k) if isinstance(sh, dict) else sh,
                                 "/".join(filter(None, (prefix, str(k).replace(".", "/")))))
                        for k, v in tree.items()}
            if not isinstance(tree, torch.Tensor):
                raise TypeError(f"{prefix or 'tree'}: restoring onto shardings takes nested dicts of tensors, "
                                f"not a {type(tree).__name__}")
            return distribute(loaded(prefix, tree).to(tree.device), sh)

        return place(target_tree, shardings, "")
    with torch.no_grad():
        for key, ref in flatten_with_paths(target_tree).items():
            if isinstance(ref, DTensor):
                from repro_torch.distributed.sharding import NamedSharding, local_block

                ref.to_local().copy_(local_block(loaded(key, ref), NamedSharding.of(ref)))
            else:
                ref.copy_(loaded(key, ref))
    return target_tree


def checkpoint_step(path: str) -> int:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)["step"]
