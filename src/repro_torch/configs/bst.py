"""bst [recsys] — Behavior Sequence Transformer (Alibaba): embed_dim=32
seq_len=20 n_blocks=1 n_heads=8 mlp=1024-512-256, transformer-seq
interaction.  [arXiv:1905.06874; paper]

Taobao-scale vocabularies: item 4M, user 8M (row-sharded over "model")."""

import dataclasses

from repro_torch.configs.base import FieldSpec, RecSysConfig

CONFIG = RecSysConfig(
    name="bst",
    kind="bst",
    embed_dim=32,
    seq_len=20,
    n_blocks=1,
    n_heads=8,
    mlp=(1024, 512, 256),
    item_vocab=4_000_000,
    fields=(
        FieldSpec("user", 8_000_000),
        FieldSpec("category", 10_000),
        FieldSpec("city", 512),
        FieldSpec("tags", 50_000, multi_hot=8),
    ),
)


def smoke_config() -> RecSysConfig:
    return dataclasses.replace(
        CONFIG, seq_len=8, mlp=(64, 32), item_vocab=1000,
        fields=(FieldSpec("user", 500), FieldSpec("category", 50),
                FieldSpec("city", 16), FieldSpec("tags", 100, multi_hot=4)),
    )
