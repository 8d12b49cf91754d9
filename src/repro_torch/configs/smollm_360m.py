"""smollm-360m [dense] — 32L d_model=960 15H (GQA kv=5) d_ff=2560
vocab=49152; llama-architecture small model.
[hf:HuggingFaceTB/SmolLM-360M; hf]

15 heads don't divide TP=16, and padding 15->16 would break the 5-group
GQA structure — attention is therefore *replicated* over the model axis
(rules override) while the FFN and vocab shard; at d_model=960 attention
is ~15% of the FLOPs so replication costs little (DESIGN.md §6).
"""

import dataclasses

from repro_torch.configs.base import DEFAULT_LM_RULES, TransformerConfig

# §Perf hillclimb (EXPERIMENTS.md): the BASELINE rules (TP on ff/vocab,
# replicated 15-head attention, sequence-parallel stream) spent 10.3 s/step
# in collectives and hit useful-compute 0.054 — a 360M model cannot feed a
# 16-way TP axis.  The optimized plan is PURE DATA PARALLELISM over
# data x model (256-way, batch=256 -> B_loc=1): params replicated (0.7 GiB
# bf16), the only collective is the gradient all-reduce.
_RULES = dict(DEFAULT_LM_RULES)
_RULES["heads"] = None           # replicate attention heads (15 % 16 != 0)
_RULES["batch"] = ("data", "model")
_RULES["seq_act"] = None
_RULES["ff"] = None
_RULES["vocab"] = None

CONFIG = TransformerConfig(
    name="smollm-360m",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    tie_embeddings=True,
    rules=_RULES,
    optimizer="adamw",
)


def smoke_config() -> TransformerConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=96, n_heads=3, n_kv_heads=1, head_dim=32,
        d_ff=192, vocab_size=512, attn_chunk_q=32, attn_chunk_kv=32,
        dtype="float32", remat=False,
    )
