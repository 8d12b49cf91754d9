"""Carry arrays taken from ``repro`` objects into the port's types.

Takes numpy arrays and plain numbers only, and imports nothing of
``repro``.  numpy has no bf16, so a bf16 array moves as its ``uint16``
bit pattern: pass ``bf16=True`` (or a ``uint16`` array, which always
means bf16 bits) and the bits are reinterpreted, never rounded again.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph_ann import GraphIndex
from repro_torch.core.napp import NappIndex
from repro_torch.core.sparse import SparseVectors
from repro_torch.core.spaces import FusedSpace, FusedVectors
from repro_torch.device import resolve_device

__all__ = ["tensor", "to_numpy", "sparse_vectors", "fused_vectors",
           "fused_space", "graph_index", "napp_index"]


def tensor(array, device=None, *, bf16: bool = False) -> torch.Tensor:
    """numpy array -> tensor on ``device`` (None = cuda).  ``uint16`` input
    or ``bf16=True`` means bf16 bit patterns."""
    dev = resolve_device(device)
    a = np.ascontiguousarray(array)
    if bf16 or a.dtype == np.uint16:
        if a.dtype != np.uint16:
            raise ValueError(f"bf16 arrays move as uint16 bits, got {a.dtype}")
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a.copy()).to(dev)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor -> numpy; bf16 comes back as its ``uint16`` bit pattern."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def sparse_vectors(indices, values, device=None, *,
                   bf16: bool = False) -> SparseVectors:
    """Padded COO from numpy ids (cast to i32) and values."""
    idx = tensor(np.asarray(indices, np.int32), device)
    return SparseVectors(idx, tensor(values, device, bf16=bf16))


def fused_vectors(dense=None, sparse_indices=None, sparse_values=None,
                  device=None, *, bf16: bool = False) -> FusedVectors:
    """``FusedVectors`` from numpy parts; a missing part stays None."""
    d = None if dense is None else tensor(dense, device, bf16=bf16)
    s = (None if sparse_indices is None
         else sparse_vectors(sparse_indices, sparse_values, device, bf16=bf16))
    return FusedVectors(d, s)


def fused_space(vocab_size: int, w_dense: float, w_sparse: float,
                dense_kind: str = "ip") -> FusedSpace:
    """``FusedSpace`` with the mixing weights learned by ``repro``."""
    return FusedSpace(int(vocab_size), float(w_dense), float(w_sparse),
                      str(dense_kind))


def graph_index(neighbors, entry_ids, device=None) -> GraphIndex:
    """``GraphIndex`` from a ``repro`` graph's numpy neighbour table
    [N, R] and entry ids [E] (cast to i32), so that both packages walk
    the same graph."""
    return GraphIndex(tensor(np.asarray(neighbors, np.int32), device),
                      tensor(np.asarray(entry_ids, np.int32), device))


def napp_index(pivot_ids, membership, num_index: int, device=None) -> NappIndex:
    """``NappIndex`` from a ``repro`` index's numpy pivot ids [P] (cast to
    i32) and membership [N, P] (f32), so that both packages probe the
    same index."""
    return NappIndex(tensor(np.asarray(pivot_ids, np.int32), device),
                     tensor(np.asarray(membership, np.float32), device), int(num_index))
