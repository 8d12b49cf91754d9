"""Carry arrays taken from ``repro`` objects into the port's types.

Takes numpy arrays and plain numbers only, and imports nothing of
``repro``.  numpy has no bf16, so a bf16 array moves as its ``uint16``
bit pattern: pass ``bf16=True`` (or a ``uint16`` array, which always
means bf16 bits) and the bits are reinterpreted, never rounded again.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fusion import ObliviousTreeEnsemble
from repro_torch.core.graph_ann import GraphIndex
from repro_torch.core.inverted_index import InvertedIndex
from repro_torch.core.napp import NappIndex
from repro_torch.core.scorers import ForwardIndex
from repro_torch.core.sparse import SparseVectors
from repro_torch.core.spaces import FusedSpace, FusedVectors
from repro_torch.device import resolve_device

__all__ = ["tensor", "to_numpy", "sparse_vectors", "fused_vectors",
           "fused_space", "graph_index", "napp_index", "forward_index",
           "inverted_index", "tree_ensemble", "transformer_params"]


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


def forward_index(tokens, length, df, vocab_size: int, avg_len: float,
                  device=None) -> ForwardIndex:
    """``ForwardIndex`` from a ``repro`` forward index's numpy tokens
    [N, L] and lengths [N] (cast to i32) and document frequencies [V]
    (f32), so that both packages extract from the same index."""
    return ForwardIndex(tensor(np.asarray(tokens, np.int32), device),
                        tensor(np.asarray(length, np.int32), device),
                        tensor(np.asarray(df, np.float32), device),
                        int(vocab_size), float(avg_len))


def inverted_index(docs, wts, n_docs: int, truncated: int = 0,
                   device=None) -> InvertedIndex:
    """``InvertedIndex`` from a ``repro`` index's numpy postings: doc ids
    [V, MAXP] (cast to i32) and weights [V, MAXP] (f32)."""
    return InvertedIndex(tensor(np.asarray(docs, np.int32), device),
                         tensor(np.asarray(wts, np.float32), device),
                         int(n_docs), int(truncated))


def tree_ensemble(feat, thresh, leaves, lr: float, device=None) -> ObliviousTreeEnsemble:
    """``ObliviousTreeEnsemble`` from a ``repro`` ensemble's numpy split
    features [M, D] (cast to i32), thresholds [M, D] and leaves
    [M, 2^D] (f32)."""
    return ObliviousTreeEnsemble(tensor(np.asarray(feat, np.int32), device),
                                 tensor(np.asarray(thresh, np.float32), device),
                                 tensor(np.asarray(leaves, np.float32), device), float(lr))


def transformer_params(params, cfg, device=None):
    """The port's ``models.transformer.Transformer`` holding the weights of
    ``repro``'s parameter tree ``params`` (nested dicts of numpy arrays,
    bf16 as ``uint16`` bits) for the config ``cfg``.

    The reference stacks the blocks on a leading layer axis
    (``init_transformer``'s vmap); they are split here, one ``Block`` a
    layer.  Layouts stay the reference's einsum layouts (``wq [d, h, dh]``,
    ``wo [h, dh, d]``, ``wq_b [r, h, k]``), so no array is transposed.
    Every array must have the shape and dtype that the port's own
    ``init_transformer(cfg)`` gives, and no name may be missing or extra;
    anything else raises ``ValueError``."""
    from repro_torch.models import transformer as T

    want, _ = T.init_transformer(cfg, device="meta")
    dev = resolve_device(device)
    dtype = T.torch_dtype(cfg.dtype)

    def carry(tree, like, where):
        if isinstance(like, torch.Tensor):
            a = np.asarray(tree)
            t = tensor(a, dev, bf16=dtype == torch.bfloat16)
            if tuple(t.shape) != tuple(like.shape) or t.dtype != like.dtype:
                raise ValueError(f"{where}: {t.dtype}{tuple(t.shape)} where the port "
                                 f"keeps {like.dtype}{tuple(like.shape)}")
            return t
        if not isinstance(tree, dict) or set(tree) != set(like.keys()):
            raise ValueError(f"{where}: names {sorted(tree) if isinstance(tree, dict) else tree!r} "
                             f"where the port keeps {sorted(like.keys())}")
        return {k: carry(tree[k], like[k], f"{where}.{k}") for k in like.keys()}

    top = {"embed", "blocks", "ln_f"} | ({"lm_head"} if want.lm_head is not None else set())
    if set(params) != top:
        raise ValueError(f"params: names {sorted(params)} where the port keeps {sorted(top)}")

    def layer(tree, i):
        if not isinstance(tree, dict):
            a = np.asarray(tree)
            if a.ndim == 0 or a.shape[0] != cfg.n_layers:
                raise ValueError(f"blocks: a leaf of shape {a.shape} where the port splits "
                                 f"a leading layer axis of {cfg.n_layers}")
            return a[i]
        return {k: layer(v, i) for k, v in tree.items()}

    blocks = [T.Block(carry(layer(params["blocks"], i), _tree(want.blocks[i]), f"blocks[{i}]"))
              for i in range(cfg.n_layers)]
    lm_head = None if want.lm_head is None else carry(params["lm_head"], want.lm_head, "lm_head")
    return T.Transformer(cfg, carry(params["embed"], want.embed, "embed"), blocks,
                         carry(params["ln_f"], _tree(want.ln_f), "ln_f"), lm_head)


def _tree(module) -> dict:
    """A module's parameters as the nested dict of its names."""
    out = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = p
    return out
