"""wide-deep [recsys] — n_sparse=40 embed_dim=32 mlp=1024-512-256, concat
interaction + wide linear path.  [arXiv:1606.07792; paper]

40 sparse fields with a realistic vocabulary profile: 2 x 10M (user/device
ids), 6 x 1M, 12 x 100k, 20 x 1k; four of the mid-size fields are
multi-hot bags (EmbeddingBag path).  The wide component keeps one scalar
weight per row — the sparse linear model the paper's fused sparse+dense
space maps onto natively (DESIGN.md §6)."""

import dataclasses

from repro_torch.configs.base import FieldSpec, RecSysConfig


def _fields():
    fs = []
    for i in range(2):
        fs.append(FieldSpec(f"id_huge_{i}", 10_000_000))
    for i in range(6):
        fs.append(FieldSpec(f"id_large_{i}", 1_000_000))
    for i in range(12):
        mh = 8 if i < 4 else 1
        fs.append(FieldSpec(f"cat_med_{i}", 100_000, multi_hot=mh))
    for i in range(20):
        fs.append(FieldSpec(f"cat_small_{i}", 1_000))
    return tuple(fs)


CONFIG = RecSysConfig(
    name="wide-deep",
    kind="wide_deep",
    embed_dim=32,
    mlp=(1024, 512, 256),
    item_vocab=4_000_000,      # used only for the retrieval_cand tower
    fields=_fields(),
)


def smoke_config() -> RecSysConfig:
    fs = tuple(
        [FieldSpec(f"f{i}", 200, multi_hot=(4 if i % 5 == 0 else 1))
         for i in range(8)]
    )
    return dataclasses.replace(CONFIG, mlp=(64, 32), fields=fs, item_vocab=500)
