"""dien [recsys] — Deep Interest Evolution Network: embed_dim=18
seq_len=100 gru_dim=108 mlp=200-80, AUGRU interaction.
[arXiv:1809.03672; unverified]"""

import dataclasses

from repro_torch.configs.base import FieldSpec, RecSysConfig

CONFIG = RecSysConfig(
    name="dien",
    kind="dien",
    embed_dim=18,
    seq_len=100,
    gru_dim=108,
    attn_mlp=(64,),
    mlp=(200, 80),
    item_vocab=20_000_000,
    fields=(
        FieldSpec("user", 5_000_000),
        FieldSpec("category", 100_000),
    ),
)


def smoke_config() -> RecSysConfig:
    return dataclasses.replace(
        CONFIG, seq_len=12, gru_dim=24, attn_mlp=(16,), mlp=(64, 32),
        item_vocab=1000,
        fields=(FieldSpec("user", 500), FieldSpec("category", 50)),
    )
