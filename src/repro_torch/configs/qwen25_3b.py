"""qwen2.5-3b [dense] — 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936; GQA with QKV bias.  [hf:Qwen/Qwen2.5-3B; hf]"""

import dataclasses

from repro_torch.configs.base import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen2.5-3b",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,       # qwen2.5-3b ties embeddings
    optimizer="adamw",
)


def smoke_config() -> TransformerConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, attn_chunk_q=32, attn_chunk_kv=32,
        dtype="float32", remat=False,
    )
