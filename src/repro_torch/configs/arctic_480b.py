"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128 experts top-2 + dense residual FFN.
[hf:Snowflake/snowflake-arctic-base; hf]

Scale-driven choices (DESIGN.md §5):
  * heads padded 56 -> 64 (zero-masked, per-KV-group) for TP=16;
  * experts sharded over the *data* axis (128/16 = 8 per rank, full-width
    FFN replicas across TP) — 469B expert params cannot fit 16-way; EP
    all-to-all rides intra-pod ICI (ep_mode="data");
  * Adafactor optimizer: factored second moments keep optimizer state from
    doubling the 3.7 GB/chip bf16 parameter residency.
"""

import dataclasses

from repro_torch.configs.base import DEFAULT_LM_RULES, TransformerConfig

_RULES = dict(DEFAULT_LM_RULES)
_RULES["experts"] = "data"        # EP over the data axis (128/16 = 8 per rank)
_RULES["expert_ff"] = "model"     # 2-D expert sharding: ff width over TP

CONFIG = TransformerConfig(
    name="arctic-480b",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    pad_heads_to=64,
    d_ff=4864,
    vocab_size=32000,
    n_experts=128,
    top_k=2,
    moe_d_ff=4864,
    dense_residual=True,
    ep_mode="data",
    capacity_factor=1.25,
    optimizer="adafactor",
    rules=_RULES,
    # 8 microbatches: MoE dispatch buffers + activations are the per-device
    # memory peak at B_loc=16; accumulation streams them (§Perf log).
    grad_accum=8,
    zero_sharding=True,   # grads-accum + update sharded over data (ZeRO-1)
    moe_token_chunks=4,   # bound EP dispatch buffers (prefill memory fix)
)


def smoke_config() -> TransformerConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=6, n_kv_heads=2, head_dim=32,
        pad_heads_to=8, d_ff=192, moe_d_ff=160, n_experts=8, top_k=2,
        vocab_size=512, capacity_factor=2.0, attn_chunk_q=32, attn_chunk_kv=32,
        dtype="float32", remat=False,
    )
