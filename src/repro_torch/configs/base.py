"""Config system: architecture + shape + parallelism descriptors (the
port's own copy of ``repro/configs/base.py``, field for field).

Every assigned architecture gets one module
``repro_torch/configs/<id>.py`` exporting ``CONFIG`` (exact
public-literature hyperparameters) and ``smoke_config()`` (a reduced
same-family config for CPU smoke tests).  ``repro_torch.configs``
resolves ``--arch <id>``.

Parallelism is expressed as *logical axis rules* (the MaxText pattern):
parameters and activations carry logical dimension names which a per-arch
rule table maps onto mesh axes.  Hillclimbing (§Perf) edits the rule table,
not the model code.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

# ---------------------------------------------------------------------------
# Shape specs (the assigned input-shape sets).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LMShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


LM_SHAPES: Tuple[LMShape, ...] = (
    LMShape("train_4k", 4096, 256, "train"),
    LMShape("prefill_32k", 32768, 32, "prefill"),
    LMShape("decode_32k", 32768, 128, "decode"),
    LMShape("long_500k", 524288, 1, "decode"),
)


@dataclasses.dataclass(frozen=True)
class GNNShape:
    name: str
    n_nodes: int
    n_edges: int
    d_feat: int = 0
    batch_nodes: int = 0         # sampled-training minibatch
    fanout: Tuple[int, ...] = ()
    batch_graphs: int = 0        # batched-small-graphs
    kind: str = "full"           # "full" | "sampled" | "batched"


GNN_SHAPES: Tuple[GNNShape, ...] = (
    GNNShape("full_graph_sm", 2708, 10556, d_feat=1433, kind="full"),
    GNNShape("minibatch_lg", 232965, 114615892, batch_nodes=1024,
             fanout=(15, 10), kind="sampled"),
    GNNShape("ogb_products", 2449029, 61859140, d_feat=100, kind="full"),
    GNNShape("molecule", 30, 64, batch_graphs=128, kind="batched"),
)


@dataclasses.dataclass(frozen=True)
class RecSysShape:
    name: str
    batch: int
    n_candidates: int = 0
    kind: str = "train"          # "train" | "serve" | "retrieval"


RECSYS_SHAPES: Tuple[RecSysShape, ...] = (
    RecSysShape("train_batch", 65536, kind="train"),
    RecSysShape("serve_p99", 512, kind="serve"),
    RecSysShape("serve_bulk", 262144, kind="serve"),
    RecSysShape("retrieval_cand", 1, n_candidates=1_000_000, kind="retrieval"),
)


# ---------------------------------------------------------------------------
# Architecture configs.
# ---------------------------------------------------------------------------

# logical axis -> mesh axis (or None = replicated; tuples = multi-axis).
ShardRules = Mapping[str, Optional[object]]

DEFAULT_LM_RULES: ShardRules = {
    "batch": ("pod", "data"),     # DP over pod x data (pod collapses if absent)
    "seq_act": "model",           # sequence-parallel residual stream
    "heads": "model",
    "kv_heads": None,             # replicated (repeat-on-the-fly GQA)
    "embed": None,
    "ff": "model",
    "vocab": "model",
    "experts": "model",           # ep_mode "model"
    "expert_ff": None,
    "kv_seq": None,               # decode KV cache sequence dim
}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                      # 0 -> d_model // n_heads
    qkv_bias: bool = False
    attention: str = "gqa"                 # "gqa" | "mla"
    # padding for TP divisibility (0 = no padding); see DESIGN.md §5
    pad_heads_to: int = 0
    pad_vocab_to: int = 0                  # Megatron-style padded vocab
    # MLA
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    dense_residual: bool = False           # arctic: dense FFN in parallel w/ MoE
    capacity_factor: float = 1.25
    ep_mode: str = "model"                 # "model" | "data" (see models/moe.py)
    moe_token_chunks: int = 1              # sequentialise dispatch buffers
    # misc
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    grad_accum: int = 1                    # microbatches per optimizer step
    zero_sharding: bool = False            # ZeRO-1: shard grads-accum + opt
                                           # state over the data axis
    seq_shard: bool = True                 # sequence-parallel residual stream
    optimizer: str = "adamw"               # "adamw" | "adafactor"
    attn_chunk_q: int = 1024               # chunked (flash-style) attention
    attn_chunk_kv: int = 1024
    attn_unroll: bool = False              # dry-run probes: unroll chunk loops
    ce_unroll: bool = False                # dry-run probes: unroll CE chunks
    rules: ShardRules = dataclasses.field(default_factory=lambda: dict(DEFAULT_LM_RULES))
    shapes: Tuple[LMShape, ...] = LM_SHAPES
    family: str = "lm"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_heads(self) -> int:
        return self.pad_heads_to or self.n_heads

    @property
    def padded_vocab(self) -> int:
        return self.pad_vocab_to or self.vocab_size

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Analytic parameter count (unpadded), for MODEL_FLOPS."""
        d, v = self.d_model, self.vocab_size
        h, hk, dh = self.n_heads, self.n_kv_heads, self.resolved_head_dim
        if self.attention == "mla":
            attn = (
                d * self.q_lora_rank
                + self.q_lora_rank * h * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                + d * (self.kv_lora_rank + self.qk_rope_head_dim)
                + self.kv_lora_rank * h * (self.qk_nope_head_dim + self.v_head_dim)
                + h * self.v_head_dim * d
            )
        else:
            attn = d * h * dh + 2 * d * hk * dh + h * dh * d
        dense_ffn = 3 * d * self.d_ff
        moe_ffn = 3 * d * self.moe_d_ff * self.n_experts if self.is_moe else 0
        per_layer = attn + (dense_ffn if (not self.is_moe or self.dense_residual) else 0) + moe_ffn
        embed = v * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + embed

    def active_param_count(self) -> int:
        """Per-token active params (MoE: top_k experts)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        moe_total = self.n_layers * 3 * d * self.moe_d_ff * self.n_experts
        moe_active = self.n_layers * 3 * d * self.moe_d_ff * self.top_k
        return self.param_count() - moe_total + moe_active


DEFAULT_GNN_RULES: ShardRules = {
    "batch": ("pod", "data"),
    "edges": ("pod", "data", "model"),
    "nodes": None,
    "feat": None,
    "hidden": "model",
}


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    d_feat_in: int = 0            # 0 -> atomic-number embedding; >0 -> linear proj
    max_z: int = 100
    unroll: bool = False          # dry-run: unroll the interaction scan
    dtype: str = "float32"
    rules: ShardRules = dataclasses.field(default_factory=lambda: dict(DEFAULT_GNN_RULES))
    shapes: Tuple[GNNShape, ...] = GNN_SHAPES
    family: str = "gnn"

    def param_count(self) -> int:
        d, r = self.d_hidden, self.n_rbf
        per = d * d * 2 + r * d + d * d  # cfconv filters + in/out projections
        return self.max_z * d + self.n_interactions * per + d * d + d


DEFAULT_RECSYS_RULES: ShardRules = {
    "batch": ("pod", "data"),
    "table_rows": "model",        # row-sharded embedding tables (DLRM pattern)
    "embed_dim": None,
    "hidden": None,
    "candidates": ("data", "model"),
}


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    name: str
    vocab: int
    multi_hot: int = 1            # >1 = bag with this many values


@dataclasses.dataclass(frozen=True)
class RecSysConfig:
    name: str
    kind: str                     # "bst" | "din" | "dien" | "wide_deep"
    embed_dim: int
    fields: Tuple[FieldSpec, ...]
    seq_len: int = 0              # behaviour-sequence length
    item_vocab: int = 0
    mlp: Tuple[int, ...] = (1024, 512, 256)
    attn_mlp: Tuple[int, ...] = ()
    n_blocks: int = 0
    n_heads: int = 0
    gru_dim: int = 0
    unroll: bool = False          # dry-run: unroll the GRU scans (DIEN)
    dtype: str = "float32"
    rules: ShardRules = dataclasses.field(default_factory=lambda: dict(DEFAULT_RECSYS_RULES))
    shapes: Tuple[RecSysShape, ...] = RECSYS_SHAPES
    family: str = "recsys"

    def param_count(self) -> int:
        emb = sum(f.vocab for f in self.fields) * self.embed_dim
        emb += self.item_vocab * self.embed_dim
        mlp = 0
        dims = list(self.mlp)
        for a, b in zip(dims[:-1], dims[1:]):
            mlp += a * b
        return emb + mlp


ArchConfig = object  # union of the three dataclasses
