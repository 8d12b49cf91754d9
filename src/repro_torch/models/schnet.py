"""SchNet (Schütt et al., arXiv:1706.08566): the continuous-filter
convolutional GNN (counterpart of ``repro/models/schnet.py``).

Message passing is a segment sum over an edge index (senders ->
receivers), ``index_add_`` here as ``jax.ops.segment_sum`` there: ids
outside the node range are dropped.  On the card ``index_add_`` adds in
atomic order, so node states may differ in their last bits from run to
run.  Node and sender gathers follow JAX's indexing
(``transformer.gather_rows``: a negative id wraps once, then ids clamp).

The parameters live in a :class:`SchNet` ``nn.Module`` under the
reference's names: ``embed`` (atomic number) or ``in_proj`` (node
features), ``blocks`` (one ``nn.ParameterDict`` an interaction, in an
``nn.ModuleList``, where the reference stacks them on a leading axis),
``head1`` and ``head2``.  Only the forward pass is ported.

The radial basis copies the reference's centres: eager JAX's f32
``linspace(0, cutoff, n)`` is ``i * f32(cutoff / (n - 1))`` with the last
centre set to ``cutoff``, which ``torch.linspace`` is not (it differs in
124 of 300 centres).  ``exp`` and ``log1p`` are PyTorch's: XLA's CPU
versions differ from them in the last bit of some values.

Retrieval tie-in: :func:`radius_graph` builds each molecule's neighbour
lists through the retrieval core's exact top-k (``DenseSpace("l2")``,
self at rank 0), and :func:`molecule_embeddings` pools node states into
the unit vectors the molecule k-NN search indexes.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs.base import SchNetConfig
from repro_torch.core.brute_force import exact_topk, select_topk
from repro_torch.core.pipeline import _masked, _reorder
from repro_torch.core.spaces import DenseSpace
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import ParallelCtx
from repro_torch.models.recsys import _normal, segment_sum
from repro_torch.models.transformer import _parameter_dict, gather_rows, torch_dtype

__all__ = ["ssp", "rbf_expand", "rbf_centers", "init_schnet", "SchNet", "GraphBatch", "cfconv",
           "schnet_apply", "node_readout", "energy_readout", "schnet_loss", "radius_graph",
           "molecule_embeddings", "FullRescore"]

_BLOCK_NAMES = ("atom_in", "filter1", "filter2", "atom_mid", "atom_out")


def ssp(x: torch.Tensor) -> torch.Tensor:
    """Shifted softplus, SchNet's activation: ``logaddexp(x, 0) - log 2``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device)) - math.log(2.0)


def rbf_centers(n_rbf: int, cutoff: float, device=None, dtype=torch.float32):
    """(centres [n_rbf], gamma) as the reference computes them in f32:
    ``linspace(0, cutoff, n_rbf)`` and ``1 / (c1 - c0)^2``."""
    step = torch.tensor(cutoff / (n_rbf - 1), dtype=dtype)
    centers = torch.arange(n_rbf, dtype=dtype) * step
    centers[-1] = cutoff
    gamma = 1.0 / (centers[1] - centers[0]) ** 2
    return centers.to(device), gamma.to(device)


def rbf_expand(dist: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Gaussian radial basis over [0, cutoff]: [E] -> [E, n_rbf]."""
    centers, gamma = rbf_centers(n_rbf, cutoff, dist.device)
    return torch.exp(-gamma * (dist[..., None] - centers) ** 2)


def _dense(gen, din, dout, dtype, device):
    return {"w": _normal(gen, (din, dout), 1.0 / math.sqrt(din), dtype, device),
            "b": torch.zeros(dout, dtype=dtype, device=device)}


def _apply_dense(p, x):
    return x @ p["w"] + p["b"]


class SchNet(nn.Module):
    """SchNet's parameters under the reference's names; calling it runs
    :func:`schnet_apply`."""

    def __init__(self, cfg: SchNetConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        if "embed" in tree:
            self.embed = nn.Parameter(tree["embed"])
        else:
            self.in_proj = _parameter_dict(tree["in_proj"])
        self.blocks = nn.ModuleList(_parameter_dict(b) for b in tree["blocks"])
        self.head1 = _parameter_dict(tree["head1"])
        self.head2 = _parameter_dict(tree["head2"])

    def forward(self, batch: "GraphBatch", ctx: Optional[ParallelCtx] = None):
        return schnet_apply(self, batch, self.cfg, ctx or ParallelCtx(None, self.cfg.rules))


def init_schnet(cfg: SchNetConfig, seed: int = 0, device=None):
    """Random weights with the reference's distributions and scales (dense
    layers ``N(0, 1/d_in)``, zero biases, the atom embedding ``N(0,
    0.1^2)``), drawn on ``device`` (None = the card) from a
    ``torch.Generator`` seeded with ``seed``.  Returns ``(model, axes)``;
    the axes carry the reference's stacked interaction axis.
    ``device="meta"`` gives shapes and dtypes only."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=dev if dev.type == "cuda" else "cpu").manual_seed(seed)
    d, r = cfg.d_hidden, cfg.n_rbf
    p, a = {}, {}
    if cfg.d_feat_in:
        p["in_proj"] = _dense(gen, cfg.d_feat_in, d, dtype, dev)
        a["in_proj"] = {"w": (None, None), "b": (None,)}
    else:
        p["embed"] = _normal(gen, (cfg.max_z, d), 0.1, dtype, dev)
        a["embed"] = (None, None)
    dims = {"atom_in": (d, d), "filter1": (r, d), "filter2": (d, d), "atom_mid": (d, d),
            "atom_out": (d, d)}
    p["blocks"] = [{k: _dense(gen, *dims[k], dtype, dev) for k in _BLOCK_NAMES}
                   for _ in range(cfg.n_interactions)]
    a["blocks"] = {k: {"w": (None, None, None), "b": (None, None)} for k in _BLOCK_NAMES}
    p["head1"] = _dense(gen, d, d // 2, dtype, dev)
    a["head1"] = {"w": (None, None), "b": (None,)}
    p["head2"] = _dense(gen, d // 2, 1, dtype, dev)
    a["head2"] = {"w": (None, None), "b": (None,)}
    return SchNet(cfg, p), a


class GraphBatch(NamedTuple):
    """Padded graph(s).  For batched molecules, node/edge arrays are the
    flattened concatenation with ``graph_ids`` for per-graph readout; the
    graph count is the ``n_graphs`` argument of :func:`schnet_loss`."""

    node_z: Optional[torch.Tensor] = None        # i32[N] atomic numbers
    node_feat: Optional[torch.Tensor] = None     # f32[N, d_feat]
    senders: torch.Tensor = None                 # i32[E]
    receivers: torch.Tensor = None               # i32[E]
    distances: torch.Tensor = None               # f32[E]
    edge_mask: Optional[torch.Tensor] = None     # bool[E] padding mask
    graph_ids: Optional[torch.Tensor] = None     # i32[N] for molecule batches
    targets: Optional[torch.Tensor] = None       # per-node or per-graph


def cfconv(blk, x, batch: GraphBatch, cfg: SchNetConfig, ctx: ParallelCtx):
    """Continuous-filter convolution: x_i <- sum_j x_j * W(rbf(d_ij))."""
    n = x.shape[0]
    h = _apply_dense(blk["atom_in"], x)
    w = rbf_expand(batch.distances, cfg.n_rbf, cfg.cutoff).to(x.dtype)
    w = ssp(_apply_dense(blk["filter1"], w))
    w = ssp(_apply_dense(blk["filter2"], w))                 # [E, d]
    msg = gather_rows(h, batch.senders) * w
    if batch.edge_mask is not None:
        msg = torch.where(batch.edge_mask[:, None], msg, torch.zeros((), dtype=msg.dtype, device=msg.device))
    msg = ctx.constrain(msg, "edges", None)
    agg = ctx.constrain(segment_sum(msg, batch.receivers, n), "nodes", None)
    h = ssp(_apply_dense(blk["atom_mid"], agg))
    return x + _apply_dense(blk["atom_out"], h)


def schnet_apply(params: SchNet, batch: GraphBatch, cfg: SchNetConfig, ctx: ParallelCtx):
    """Per-node hidden states [N, d]."""
    if cfg.d_feat_in:
        x = _apply_dense(params.in_proj, batch.node_feat.to(torch_dtype(cfg.dtype)))
    else:
        x = gather_rows(params.embed, batch.node_z)
    for blk in params.blocks:
        x = cfconv(blk, x, batch, cfg, ctx)
    return x


def node_readout(params: SchNet, x):
    """Per-node scalar prediction (full-graph regression head)."""
    return _apply_dense(params.head2, ssp(_apply_dense(params.head1, x)))[..., 0]


def energy_readout(params: SchNet, x, graph_ids, n_graphs):
    """Per-graph energy: sum of per-atom contributions (SchNet readout)."""
    return segment_sum(node_readout(params, x), graph_ids, n_graphs)


def schnet_loss(params: SchNet, batch: GraphBatch, cfg: SchNetConfig, ctx: ParallelCtx,
                n_graphs: int = 0):
    """Mean squared error of the energy (molecules) or node (full graph)
    predictions (forward only)."""
    x = schnet_apply(params, batch, cfg, ctx)
    if batch.graph_ids is not None:
        pred = energy_readout(params, x, batch.graph_ids, n_graphs)
    else:
        pred = node_readout(params, x)
    err = (pred.float() - batch.targets.float()) ** 2
    return err.mean(), {"mse": err.mean()}


def radius_graph(positions: torch.Tensor, k: int):
    """k-NN graph from 3D coordinates via the retrieval core's exact top-k
    in ``DenseSpace("l2")`` (self, at distance 0, is rank 0 and dropped).
    ``positions [n, 3]`` -> (senders, receivers, distances), each [n * k];
    a leading molecule axis ``[M, n, 3]`` gives each [M, n * k] (molecule-
    local ids), as ``jax.vmap`` of the reference gives them."""
    if positions.dim() == 2:
        tk = exact_topk(DenseSpace("l2"), positions, positions, k + 1)
        scores, ids = tk.scores, tk.indices
    else:   # the l2 formula of DenseSpace, one score matrix a molecule
        p = positions.float()
        sq = torch.einsum("mnd,mnd->mn", p, p)
        scores = -(sq[:, :, None] + sq[:, None, :] - 2.0 * (p @ p.transpose(1, 2)))
        scores, ids = select_topk(scores, k + 1)
        ids = ids.to(torch.int32)
    n = positions.shape[-2]
    lead = positions.shape[:-2]
    senders = ids[..., 1:].reshape(*lead, n * k)
    receivers = torch.arange(n, dtype=torch.int32, device=positions.device).repeat_interleave(k)
    receivers = receivers.expand(*lead, n * k)
    dist = torch.sqrt(torch.clamp_min(-scores[..., 1:].reshape(*lead, n * k), 0.0))
    return senders, receivers, dist


def molecule_embeddings(params: SchNet, positions: torch.Tensor, node_z: torch.Tensor,
                        cfg: SchNetConfig, ctx: ParallelCtx, k: int = 6) -> torch.Tensor:
    """Molecules ``positions [M, n, 3]``, ``node_z [M, n]`` -> unit vectors
    [M, 2 d]: each molecule's :func:`radius_graph` (``k`` neighbours), the
    node states of :func:`schnet_apply` on the M graphs as one batch, then
    mean ++ std (``correction=0``) over a molecule's atoms, L2-normalised
    (``examples/molecule_retrieval.py``'s embedding, batched)."""
    m, n, _ = positions.shape
    send, recv, dist = radius_graph(positions, k)
    off = (torch.arange(m, dtype=torch.int32, device=positions.device) * n)[:, None]
    batch = GraphBatch(node_z=node_z.reshape(-1), senders=(send + off).reshape(-1),
                       receivers=(recv + off).reshape(-1), distances=dist.reshape(-1))
    h = schnet_apply(params, batch, cfg, ctx).reshape(m, n, -1)
    v = torch.cat([h.mean(dim=1), h.std(dim=1, correction=0)], dim=-1)
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True), 1e-9)


class FullRescore:
    """The molecule funnel's rerank stage (``examples/molecule_retrieval.py``):
    candidates found on the cheap half-embedding rescored by the inner
    product of the full query vector (``q_tokens``) with their rows of
    ``emb``."""

    def __init__(self, emb: torch.Tensor):
        self.emb = emb

    def rerank(self, q_tokens, cands, keep):
        scores = torch.einsum("bd,bcd->bc", q_tokens, gather_rows(self.emb, cands.indices))
        return _reorder(cands, _masked(cands, scores), keep)
