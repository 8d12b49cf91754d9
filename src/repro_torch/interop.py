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
           "inverted_index", "tree_ensemble", "transformer_params", "kv_cache",
           "recsys_params", "schnet_params", "adam_state", "adafactor_state",
           "restore_repro_checkpoint", "sharded_tree"]


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


def _placed(model, axes, ctx):
    """``model``'s parameters distributed over ``ctx``'s mesh by their
    logical ``axes`` (``params_sharding``'s layout); unchanged without one."""
    from repro_torch.distributed.sharding import distribute_module

    return model if ctx is None else distribute_module(model, axes, ctx)


def transformer_params(params, cfg, device=None, ctx=None):
    """The port's ``models.transformer.Transformer`` holding the weights of
    ``repro``'s parameter tree ``params`` (nested dicts of numpy arrays,
    bf16 as ``uint16`` bits) for the config ``cfg``.

    The reference stacks the blocks on a leading layer axis
    (``init_transformer``'s vmap); they are split here, one ``Block`` a
    layer.  Layouts stay the reference's einsum layouts (``wq [d, h, dh]``,
    ``wo [h, dh, d]``, ``wq_b [r, h, k]``; experts ``w_in [E, d, f]``), so
    no array is transposed.  A block with experts carries ``moe`` (the
    router ``wg`` in f32, the experts in the model dtype) and, with a dense
    residual, ``ln3`` and ``ffn``.
    Every array must have the shape and dtype that the port's own
    ``init_transformer(cfg)`` gives, and no name may be missing or extra;
    anything else raises ``ValueError``.  With a mesh in ``ctx`` every rank
    calls it with the same tree and keeps its blocks: each parameter a
    ``DTensor`` placed by ``params_sharding`` of ``init_transformer``'s
    axes, as ``train_lm`` places them."""
    from repro_torch.models import transformer as T

    want, axes = T.init_transformer(cfg, device="meta")
    dev = resolve_device(device)
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

    blocks = [T.Block(_carry_tree(layer(params["blocks"], i), _like(want.blocks[i]), f"blocks[{i}]", dev))
              for i in range(cfg.n_layers)]
    lm_head = None if want.lm_head is None else _carry_tree(params["lm_head"], want.lm_head, "lm_head", dev)
    return _placed(T.Transformer(cfg, _carry_tree(params["embed"], want.embed, "embed", dev), blocks,
                                 _carry_tree(params["ln_f"], _like(want.ln_f), "ln_f", dev), lm_head), axes, ctx)


def kv_cache(cache, cfg, device=None):
    """The port's ``models.transformer.KVCache`` holding ``repro``'s cache
    ``cache`` (a ``KVCache`` or any object with fields ``k``, ``v``, ``ckv``
    and ``kpe``, each a numpy array or None; bf16 as ``uint16`` bits) for
    the config ``cfg``.  The fields present must be the ones the port's
    ``init_cache(cfg, ...)`` makes, each ``[L, B, S, ...]`` in the model
    dtype, with one B and S; anything else raises ``ValueError``."""
    from repro_torch.models import transformer as T

    dev = resolve_device(device)
    fields = {name: getattr(cache, name) for name in T.KVCache._fields}
    present = {name for name, a in fields.items() if a is not None}
    some = next(iter(present), None)
    if some is None:
        raise ValueError("cache: no field holds an array")
    shape = np.asarray(fields[some]).shape
    if len(shape) < 3:
        raise ValueError(f"cache.{some}: shape {shape} where the port keeps [L, B, S, ...]")
    want = T.init_cache(cfg, shape[1], shape[2], device="meta")
    keep = {name for name in T.KVCache._fields if getattr(want, name) is not None}
    if present != keep:
        raise ValueError(f"cache: fields {sorted(present)} where the port keeps {sorted(keep)}")
    return T.KVCache(**{name: _carry_tree(fields[name], getattr(want, name), f"cache.{name}", dev)
                        for name in keep})


def _like(node):
    """A module's parameters as nested dicts (``nn.ParameterDict`` and
    modules) and lists (``nn.ModuleList``) of tensors."""
    from torch import nn

    if isinstance(node, torch.Tensor):
        return node
    if isinstance(node, nn.ModuleList):
        return [_like(m) for m in node]
    out = dict(node.named_parameters(recurse=False))
    out.update((name, _like(m)) for name, m in node.named_children())
    return out


def _carry_tree(tree, like, where, dev):
    """``tree`` (numpy arrays in nested dicts and lists) as tensors on
    ``dev`` in the structure of ``like``; a missing or extra name, a list
    of another length, or an array of another shape or dtype raises
    ``ValueError``."""
    if isinstance(like, torch.Tensor):
        a = np.asarray(tree)
        t = tensor(a, dev, bf16=like.dtype == torch.bfloat16)
        if tuple(t.shape) != tuple(like.shape) or t.dtype != like.dtype:
            raise ValueError(f"{where}: {t.dtype}{tuple(t.shape)} where the port "
                             f"keeps {like.dtype}{tuple(like.shape)}")
        return t
    if isinstance(like, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(like):
            raise ValueError(f"{where}: {type(tree).__name__} of "
                             f"{len(tree) if isinstance(tree, (list, tuple, dict)) else '?'} "
                             f"where the port keeps a list of {len(like)}")
        return [_carry_tree(t, l, f"{where}[{i}]", dev) for i, (t, l) in enumerate(zip(tree, like))]
    if not isinstance(tree, dict) or set(tree) != set(like):
        raise ValueError(f"{where}: names {sorted(tree) if isinstance(tree, dict) else tree!r} "
                         f"where the port keeps {sorted(like)}")
    return {k: _carry_tree(tree[k], like[k], f"{where}.{k}", dev) for k in like}


def recsys_params(params, cfg, device=None, ctx=None):
    """The port's ``models.recsys.RecSys`` holding the weights of
    ``repro``'s parameter tree ``params`` (nested dicts and lists of numpy
    arrays, bf16 as ``uint16`` bits) for the config ``cfg``.  Every array
    must have the shape and dtype that the port's own ``init_recsys(cfg)``
    gives, and no name may be missing or extra; anything else raises
    ``ValueError``.  With a mesh in ``ctx``, placed as
    :func:`transformer_params` places them."""
    from repro_torch.models import recsys as R

    want, axes = R.init_recsys(cfg, device="meta")
    return _placed(R.RecSys(cfg, _carry_tree(params, _like(want), "params", resolve_device(device))), axes, ctx)


def schnet_params(params, cfg, device=None, ctx=None):
    """The port's ``models.schnet.SchNet`` holding the weights of
    ``repro``'s parameter tree ``params`` (nested dicts of numpy arrays)
    for the config ``cfg``.  The reference stacks the interactions on a
    leading axis; they are split here, one parameter dict an interaction.
    Shapes, dtypes and names are checked as in :func:`recsys_params`, and
    a mesh in ``ctx`` places them as there."""
    from repro_torch.models import schnet as S

    want, axes = S.init_schnet(cfg, device="meta")
    like = _like(want)
    if not isinstance(params, dict) or "blocks" not in params:
        raise ValueError(f"params: names {sorted(params) if isinstance(params, dict) else params!r} "
                         f"where the port keeps {sorted(like)}")

    def layer(tree, i):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        a = np.asarray(tree)
        if a.ndim == 0 or a.shape[0] != cfg.n_interactions:
            raise ValueError(f"blocks: a leaf of shape {a.shape} where the port splits a "
                             f"leading interaction axis of {cfg.n_interactions}")
        return a[i]

    tree = dict(params, blocks=[layer(params["blocks"], i) for i in range(cfg.n_interactions)])
    return _placed(S.SchNet(cfg, _carry_tree(tree, like, "params", resolve_device(device))), axes, ctx)


def _split_layer(parts, stacked=()):
    """(``parts`` without the layer index that follows a stacked list's
    name, that index or None): the port's path of a leaf to ``repro``'s."""
    out, layer, i = [], None, 0
    while i < len(parts):
        out.append(parts[i])
        if parts[i] in stacked and i + 1 < len(parts) and parts[i + 1].isdigit():
            layer = int(parts[i + 1])
            i += 1
        i += 1
    return out, layer


def _reference_array(tree, name: str, stacked=()):
    """The array of the port's leaf ``name`` (dotted) in ``repro``'s tree
    ``tree`` (nested dicts and lists): a layer index after a stacked list's
    name indexes the stacked leaf's leading axis."""
    parts, layer = _split_layer(name.split("."), stacked)
    node = tree
    for part in parts:
        node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
    a = np.asarray(node)
    return a if layer is None else a[layer]


def adam_state(state, model, device=None):
    """The port's ``optim.optimizer.AdamState`` for ``model`` (a port
    module) holding ``repro``'s AdamW state ``state`` (any object with
    fields ``step``, ``m`` and ``v``; the moments as nested dicts of f32
    numpy arrays in the parameters' tree).  A stacked layer axis is split
    as :func:`transformer_params` splits it; shapes and dtypes are checked
    against the port's own ``init``."""
    from repro_torch.optim.optimizer import AdamState, _adamw_init

    dev = resolve_device(device)
    want = _adamw_init(model)
    stacked = getattr(model, "STACKED", ())
    moments = [{n: _carry_tree(_reference_array(tree, n, stacked), like, f"{field}.{n}", dev)
                for n, like in getattr(want, field).items()}
               for field, tree in (("m", state.m), ("v", state.v))]
    return AdamState(tensor(np.asarray(state.step, np.int32), dev), *moments)


def adafactor_state(state, model, device=None):
    """The port's ``optim.optimizer.AdafactorState`` for ``model`` holding
    ``repro``'s Adafactor state ``state`` (fields ``step``, ``vr`` and
    ``vc``).  The port keys it by the reference's leaves, stacked layer
    axis and all (``AdafactorState`` says why), so nothing is split."""
    from repro_torch.optim.optimizer import AdafactorState, _adafactor_init

    dev = resolve_device(device)
    want = _adafactor_init(model)
    factors = [{n: _carry_tree(_reference_array(tree, n), like, f"{field}.{n}", dev)
                for n, like in getattr(want, field).items()}
               for field, tree in (("vr", state.vr), ("vc", state.vc))]
    return AdafactorState(tensor(np.asarray(state.step, np.int32), dev), *factors)


def restore_repro_checkpoint(path: str, target) -> int:
    """Read a checkpoint directory that ``repro`` wrote into the port's
    ``target`` (a tree of port modules, optimizer states and tensors, e.g.
    ``{"params": model, "opt": state}`` for ``repro``'s ``{"params": ...,
    "opt": ...}``) in place, bf16 bit for bit, and return its step.  A
    layer index after the name of a module's stacked list reads that layer
    of ``repro``'s stacked leaf; a leaf of another shape raises
    ``ValueError``."""
    from torch import nn

    from repro_torch.checkpoint.checkpoint import checkpoint_step, flatten_with_paths, load_leaves

    leaves = load_leaves(path)
    stacked = set()
    for node in (target.values() if isinstance(target, dict) else [target]):
        if isinstance(node, nn.Module):
            stacked |= set(getattr(node, "STACKED", ()))
    with torch.no_grad():
        for key, like in flatten_with_paths(target).items():
            ref, layer = _split_layer(key.split("/"), stacked)
            arr = leaves["/".join(ref)]
            if layer is not None:
                arr = arr[layer]
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"{key}: {tuple(arr.shape)} in the checkpoint where the port keeps "
                                 f"{tuple(like.shape)}")
            like.copy_(arr.to(like.dtype))
    return checkpoint_step(path)


def sharded_tree(tree, shardings, device=None):
    """A carried tree (nested dicts of numpy arrays, bf16 as ``uint16``
    bits) with each leaf distributed by its leaf of ``shardings`` (a
    ``params_sharding`` tree): a ``DTensor`` of which this rank holds its
    block, as ``restore_checkpoint`` places a leaf; a whole tensor where
    the sharding is None.  Every rank of the mesh calls it with the same
    tree."""
    from repro_torch.distributed.sharding import distribute

    if isinstance(tree, dict):
        return {k: sharded_tree(v, shardings.get(k) if isinstance(shardings, dict) else shardings, device)
                for k, v in tree.items()}
    return distribute(tensor(np.asarray(tree), device), shardings)


def mesh_opt_state(state, update, device=None):
    """The optimizer state of a ``MeshUpdate`` (``make_lm_train_step``'s
    over a mesh, its ``opt.init`` layout) holding ``repro``'s state
    ``state`` (an ``AdamState``'s ``step``, ``m`` and ``v``, or an
    ``AdafactorState``'s ``step``, ``vr`` and ``vc``: nested dicts of f32
    numpy arrays in the reference's stacked tree).  Every rank calls it
    with the same state and keeps its blocks: the layout ``_opt_axes_safe``
    gives the state's axes, ZeRO's included (a state entry that ZeRO
    shards is keyed by the reference's stacked leaf)."""
    from repro_torch.distributed.sharding import NamedSharding, distribute
    from repro_torch.optim.optimizer import AdafactorState, AdamState, _factor_specs

    dev = resolve_device(device)
    fields = ("m", "v") if update.opt.name == "adamw" else ("vr", "vc")
    out = {f: {} for f in fields}
    for u in update.units:
        for f in fields:
            tree = getattr(state, f)
            if u.zdim is None and update.opt.name == "adamw":
                a = _reference_array(tree, u.key, ("blocks",))
                spec = u.spec
            else:
                a = _reference_array(tree, u.key)
                spec = u.spec if f in ("m", "v") else _factor_specs(u.spec)[f == "vc"]
            t = tensor(np.asarray(a, np.float32), dev)
            out[f][u.key] = distribute(t, NamedSharding(update.mesh, spec))
    step = tensor(np.asarray(state.step, np.int32), dev)
    return (AdamState if update.opt.name == "adamw" else AdafactorState)(step, *(out[f] for f in fields))
