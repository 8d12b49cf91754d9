"""schnet [gnn] — n_interactions=3 d_hidden=64 rbf=300 cutoff=10.
[arXiv:1706.08566; paper]

Kernel regime: triplet gather / segment_sum (see models/schnet.py).
Full-graph shapes attach a per-node head; the molecule shape uses the
per-graph energy readout.  ``d_feat_in`` is shape-dependent (full-graph
citation/products graphs carry node features; molecules carry atomic
numbers) — ``config_for_shape`` resolves it.
"""

import dataclasses

from repro_torch.configs.base import GNN_SHAPES, SchNetConfig

CONFIG = SchNetConfig(
    name="schnet",
    n_interactions=3,
    d_hidden=64,
    n_rbf=300,
    cutoff=10.0,
)


def config_for_shape(shape_name: str) -> SchNetConfig:
    shape = {s.name: s for s in GNN_SHAPES}[shape_name]
    if shape.d_feat:
        return dataclasses.replace(CONFIG, d_feat_in=shape.d_feat)
    return CONFIG


def smoke_config() -> SchNetConfig:
    return dataclasses.replace(CONFIG, n_interactions=2, d_hidden=16, n_rbf=8)
