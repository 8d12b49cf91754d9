"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8) expert
d_ff=6400 vocab=32064, MoE 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]

Expert parallelism over the TP ("model") axis: 16 experts / 16-way TP = 1
expert per rank, full-width expert FFN local (ep_mode="model"; see
models/moe.py).
"""

import dataclasses

from repro_torch.configs.base import TransformerConfig

CONFIG = TransformerConfig(
    name="phi3.5-moe-42b-a6.6b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    n_experts=16,
    top_k=2,
    moe_d_ff=6400,
    ep_mode="model",
    capacity_factor=1.25,
    # Adafactor: AdamW's f32 moments for 42B params shard only over the
    # model axis (16-way) -> 21 GB/chip, over v5e HBM.  Factored second
    # moments keep optimizer state negligible (DESIGN.md §5).
    optimizer="adafactor",
    grad_accum=4,
    zero_sharding=True,   # grads-accum + update sharded over data (ZeRO-1)
)


def smoke_config() -> TransformerConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, moe_d_ff=192, n_experts=4, top_k=2, vocab_size=512,
        capacity_factor=2.0, attn_chunk_q=32, attn_chunk_kv=32,
        dtype="float32", remat=False,
    )
