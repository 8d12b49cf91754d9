"""din [recsys] — Deep Interest Network: embed_dim=18 seq_len=100
attn_mlp=80-40 mlp=200-80, target-attention interaction.
[arXiv:1706.06978; paper]

Alibaba-scale item vocabulary (10^8) to exercise the huge-embedding
regime; tables row-sharded over "model"."""

import dataclasses

from repro_torch.configs.base import FieldSpec, RecSysConfig

CONFIG = RecSysConfig(
    name="din",
    kind="din",
    embed_dim=18,
    seq_len=100,
    attn_mlp=(80, 40),
    mlp=(200, 80),
    item_vocab=100_000_000,
    fields=(
        FieldSpec("user", 10_000_000),
        FieldSpec("category", 100_000),
        FieldSpec("shop", 1_000_000),
    ),
)


def smoke_config() -> RecSysConfig:
    return dataclasses.replace(
        CONFIG, seq_len=12, attn_mlp=(32, 16), mlp=(64, 32), item_vocab=1000,
        fields=(FieldSpec("user", 500), FieldSpec("category", 50),
                FieldSpec("shop", 100)),
    )
