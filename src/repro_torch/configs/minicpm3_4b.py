"""minicpm3-4b [dense] — 62L d_model=2560 40H (MLA) d_ff=6400 vocab=73448.
MLA latent attention (DeepSeek-V2 family): q_lora=768, kv_lora=256,
qk_nope=64, qk_rope=32, v_head=64.  [hf:openbmb/MiniCPM3-4B; hf]

Heads padded 40 -> 48 for TP=16 divisibility (zero-masked; DESIGN.md §5).
"""

import dataclasses

from repro_torch.configs.base import TransformerConfig

CONFIG = TransformerConfig(
    name="minicpm3-4b",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    pad_vocab_to=73472,          # next multiple of 256 (TP=16 divisibility)
    attention="mla",
    pad_heads_to=48,
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_head_dim=64,
    qk_rope_head_dim=32,
    v_head_dim=64,
    optimizer="adamw",
)


def smoke_config() -> TransformerConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        pad_heads_to=0, pad_vocab_to=0, q_lora_rank=48, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16, d_ff=256,
        vocab_size=512, attn_chunk_q=32, attn_chunk_kv=32, dtype="float32",
        remat=False,
    )
