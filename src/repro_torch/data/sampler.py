"""GraphSAGE-style neighbor sampler (host-side, numpy CSR; a copy of
``repro/data/sampler.py``, equal arrays for a seed).

The ``minibatch_lg`` GNN shape requires a *real* neighbor sampler: given
seed nodes and a fanout per hop, sample a fixed number of neighbors per
node per hop, producing padded bipartite blocks that the SchNet/segment-sum
message passing consumes.  Sampling is uniform-without-replacement
(with-replacement when degree < fanout, matching DGL's default)."""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray    # i64[N+1]
    indices: np.ndarray   # i32[E]

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    @classmethod
    def from_edges(cls, senders: np.ndarray, receivers: np.ndarray, n: int):
        order = np.argsort(receivers, kind="stable")
        s, r = senders[order], receivers[order]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr[1:], r, 1)
        indptr = np.cumsum(indptr)
        return cls(indptr, s.astype(np.int32))

    @classmethod
    def random(cls, n: int, avg_degree: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        e = n * avg_degree
        return cls.from_edges(rng.integers(0, n, e).astype(np.int32),
                              rng.integers(0, n, e).astype(np.int32), n)


@dataclasses.dataclass
class SampledBlock:
    """One hop: edges from sampled source nodes into destination nodes.
    Node ids are *local* to the subgraph's node table."""

    senders: np.ndarray     # i32[n_dst * fanout]
    receivers: np.ndarray   # i32[n_dst * fanout]
    edge_mask: np.ndarray   # bool — false for padding / repeated samples


@dataclasses.dataclass
class SampledSubgraph:
    node_ids: np.ndarray         # i32[N_sub] global ids (padded w/ -1)
    blocks: List[SampledBlock]
    seed_count: int


def sample_subgraph(graph: CSRGraph, seeds: np.ndarray,
                    fanout: Sequence[int], seed: int = 0) -> SampledSubgraph:
    rng = np.random.default_rng(seed)
    node_ids = list(seeds.astype(np.int64))
    local = {int(v): i for i, v in enumerate(node_ids)}
    frontier = list(seeds.astype(np.int64))
    blocks: List[SampledBlock] = []

    for f in fanout:
        senders, receivers, mask = [], [], []
        next_frontier = []
        for dst in frontier:
            lo, hi = graph.indptr[dst], graph.indptr[dst + 1]
            deg = hi - lo
            if deg == 0:
                nbrs = np.full(f, dst, dtype=np.int64)   # self-loop padding
                valid = np.zeros(f, dtype=bool)
            elif deg >= f:
                nbrs = graph.indices[lo + rng.choice(deg, f, replace=False)].astype(np.int64)
                valid = np.ones(f, dtype=bool)
            else:
                nbrs = graph.indices[lo + rng.integers(0, deg, f)].astype(np.int64)
                valid = np.ones(f, dtype=bool)
            for v, ok in zip(nbrs, valid):
                vi = int(v)
                if vi not in local:
                    local[vi] = len(node_ids)
                    node_ids.append(vi)
                    if ok:
                        next_frontier.append(vi)
                senders.append(local[vi])
                receivers.append(local[int(dst)])
                mask.append(bool(ok))
        blocks.append(SampledBlock(np.asarray(senders, np.int32),
                                   np.asarray(receivers, np.int32),
                                   np.asarray(mask)))
        frontier = next_frontier

    return SampledSubgraph(np.asarray(node_ids, np.int64), blocks, len(seeds))


def pad_subgraph(sub: SampledSubgraph, max_nodes: int, max_edges_per_block: Sequence[int]):
    """Pad to static shapes for jit: node table to max_nodes, each block's
    edge arrays to its cap.  Returns (node_ids, senders, receivers, mask)
    with all blocks' edges concatenated (the model runs interactions over
    the union edge set)."""
    n = len(sub.node_ids)
    assert n <= max_nodes, (n, max_nodes)
    node_ids = np.full(max_nodes, -1, dtype=np.int64)
    node_ids[:n] = sub.node_ids
    senders, receivers, mask = [], [], []
    for blk, cap in zip(sub.blocks, max_edges_per_block):
        e = len(blk.senders)
        assert e <= cap, (e, cap)
        s = np.zeros(cap, np.int32); s[:e] = blk.senders
        r = np.zeros(cap, np.int32); r[:e] = blk.receivers
        m = np.zeros(cap, bool); m[:e] = blk.edge_mask
        senders.append(s); receivers.append(r); mask.append(m)
    return (node_ids, np.concatenate(senders), np.concatenate(receivers),
            np.concatenate(mask))
