"""The paper's own system configuration: the FlexNeuART retrieval stack.

This drives the examples and paper-table benchmarks: corpus scale, sparse
vector capacities, candidate funnel depths, LETOR settings, and the fused
sparse+dense weights' initialisation.  (The assigned LM architectures plug
in as encoders / re-rankers; see repro_torch.models.encoder.)
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    # corpus
    n_docs: int = 2000
    n_queries: int = 200
    vocab_lemmas: int = 2000
    n_variants: int = 3
    # sparse representation
    doc_nnz: int = 64
    query_nnz: int = 16
    # dense representation
    embed_dim: int = 64
    # funnel (paper Fig. 4: candQty=2000 on MS MARCO; scaled to corpus)
    cand_qty: int = 100
    interm_qty: int = 50
    final_qty: int = 10
    # BM25
    k1: float = 1.2
    b: float = 0.75
    # graph ANN
    ann_degree: int = 16
    ann_ef: int = 64
    ann_rounds: int = 6
    # NAPP
    napp_pivots: int = 128
    napp_index: int = 8
    napp_search: int = 8
    # Model 1
    model1_iters: int = 5
    model1_lambda: float = 0.1
    # LETOR
    ca_rounds: int = 4
    ca_restarts: int = 3
    lmart_trees: int = 50
    lmart_depth: int = 3


CONFIG = RetrievalConfig()


def smoke_config() -> RetrievalConfig:
    return dataclasses.replace(
        CONFIG, n_docs=256, n_queries=32, vocab_lemmas=500, doc_nnz=32,
        query_nnz=8, cand_qty=32, interm_qty=16, final_qty=10,
        ann_degree=8, ann_ef=32, ann_rounds=4, napp_pivots=32, napp_index=4,
        model1_iters=3, lmart_trees=10,
    )
