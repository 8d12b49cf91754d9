#!/usr/bin/env python3
"""Drive the port's main path on one CUDA card and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py            # one H100, MS MARCO passage scale

Phases, one line each: the card; the build of every kernel from
``src/repro_torch/kernels/csrc``; the query-term index built on the card
against its plain version ("index"); the exact-scan kernels against their
plain versions at small shapes, with the index's risky cases (Zipf-skewed
and out-of-range ids, repeated query terms, an all-pad query, both
launch plans, V = 250,000) and exact scores that are NaN, +0 and -0
("small"), B1 where its ring route can break, bit for bit on exact
scores (a sorted corpus, all scores equal, NaN / +0 / -0 at the k-th,
n_valid below k, a sample that misses every good row, so that the filter's
lists overflow; "b1 small"), the large-k kernels likewise, with the
selection's refinement and ordered-fill paths ("large small"), the
beam-hop kernel against
its plain version hop for hop, and one traversal launch against the
hop-by-hop launches bit for bit ("beam small"), and the fused score kernel
against its plain version ("score small"); then the main path at MS
MARCO passage v1 scale (8,841,823 passages, 768-d dense, 30,522-term
sparse with 128 nnz per passage and 32 per query, batches of 16): fused
dense+sparse retrieval through ``RetrievalPipeline`` on the ``cuda``
backend and dense ip through ``mips_topk``, and one dense request of
k = 4096 through ``topk_large``; the scan kernels timed, ``topk_large``'s
score and select passes apart and the fused space at k = 4096, the
sparse part alone, and uniform against Zipf-skewed term ids over
1,048,576 rows ("skew", not gated); then graph ANN over the same
resident corpus ("graph full": ``GraphANNBackend(kernel=True)``, degree
16, ef 64, 31 hops in one launch per batch, on a random graph); NAPP
over it ("napp full": ``NappBackend``, 128 pivots, index 8, search 8,
the index built through the fused score kernel); the fused score kernel timed at B = 16 and at
B = 128 ("score full"); and over a planted-cluster corpus of 1,048,576
rows at full widths, graph ANN ("graph recall": an NN-descent index) and
NAPP ("napp recall"), recall@10 against the exact answer.  Between "score
full" and "graph recall", over the resident corpus: mixing weights learned
on the card from planted training queries and served to held-out ones
("fusion full"), and live corpora on those weights and on dense ip
through ``LiveCorpus`` and ``LiveGenerator``, before and after inserts,
deletes (the main fetch past 2048 rows takes ``topk_large``) and a
compaction, each result equal to the plain live path ("live full");
last, a live corpus with a graph-ANN main under churn and the background
compactor, recall@10 gated before and after ("live ann"), and the
autotuner's search over that corpus, each genome load-tested under a
fresh ``RetrievalService`` (graph-ANN genomes through the beam-hop kernel,
NAPP genomes through the fused score kernel; "autotune").  After "live
full", still over the resident corpus, the served path ("serve full"):
a ``RetrievalService`` with six endpoints (fused, dense, dense at k =
4096, fused over four row shards, a fused funnel with a dense rerank
under a stage budget, a live dense corpus) flooded by four client
threads with host queries, each endpoint alone and then all at once,
every answer equal to the offline run of its batch; where a flood's host
time goes ("serve split"); a live endpoint flooded while a writer
upserts, every answer equal to the plain live path at the generation
that served it ("serve churn"); and B1
against ``topk_large``, the library call and its own scan route (the
parent's kernel) at k = 10, 100, 356, 1,100, 2,000 and 2,048 and B = 1, 16
and 64, B2 against ``topk_large`` at B = 16
("crossover"), with B1's extra device memory ("b1 memory").  Then the
FlexNeuART feature side over the same corpus ("flexneuart full"): the
forward index of its COO ids, BM25 vectors and the inverted index built
on the card, Model 1 trained at full vocabulary, a linear and a tree
reranker learned on planted queries, and held-out batches served through
the pipeline of a Fig. 4 experiment descriptor (B2's candidates, then the
rerankers), the inverted index alone, and the paper's candQty = 2,000.  Still over the resident corpus,
the distributed layer ("dist full"): four gloo ranks sharing the card (CUDA IPC views of the corpus),
mesh (data, model) = (1, 4), serve the corpus sharded (B2 fused, B1 dense, ``topk_large`` at k = 4096,
``sharded_exact_topk``) over 4 and 8 shards equal to the single-process answers; the gradient
all-reduce over (pod, data) = (2, 2), smollm-360m's parameters re-meshed 4 -> 2 -> 4 ranks and restored
from a checkpoint onto (1, 4), bit for bit; and the sharded fused run on a one-rank NCCL group.  After the corpus's release, the
recommendation family ("recsys full": DIN as published, 100M items, user
queries through B1 in f32 and bf16 and B2 over item tags, the example's
funnel served; wide-deep, DIEN and BST's logits against f64) and the
molecule family ("molecule full": SchNet as published embedding 1,048,576
molecules, searched through B3 with B1 on the entry set, the funnel
served), then LM inference ("lm full": qwen2.5-3b and minicpm3-4b as
published and phi3.5-moe at 16 of its 32 layers, bf16, through
``prefill_step`` and a ``decode_step`` loop over a KV cache, one step at
32,768 positions; in f32 at 2 layers, the card against the CPU and decode
against prefill; it launches no kernel of the port), then training
("train full": one f32 train step of those configs and smollm-360m at
2 layers, the card against the CPU; smollm-360m as published trained
through ``launch.train.train_lm`` at 4 x 4,096 tokens with checkpoints
and a resumed run; DIN and SchNet train steps at published widths; no
kernel of the port either), then expert parallelism ("moe ep full": phi3.5-moe's MoE layer as
published over (1, 4) and arctic-480b's over (2, 2) through the 2-D split, bf16, against ``moe_local``
on the card, then both at their smoke configs in f32).  Last, the dry
run ("dryrun"), after every timed phase: ``repro_torch.launch.dryrun
--both-meshes`` (fake CPU tensors, nice 19) traces all 40 cells on the
(16, 16) and (2, 16, 16) meshes, every one ok, while three cells are
traced on a world of one rank and then run on the card, their predicted
peak memory and FLOPs held against the measured.  Each
served path runs with the launch counters set to 0 just before and read
just after.  The last lines are the ``kernels`` JSON, the card's name and
power limit, and ``{"ok": true, ...}``.  Any failure raises and exits
non-zero.  The data is synthetic, made on the card from ``--seed``.

    python3 chip_smoke.py --graph-build-n 8841823   # also time one
                                                    # NN-descent build

Tolerance, kernel against plain version: f32 scores agree within
``TOL_REL`` times the row's largest |score| (summation order differs:
sequential FMAs in the kernel, cuBLAS or a CPU reduction in the plain
version), NaN and zero scores of exact data bit for bit (the order is
``lax.top_k``'s: +0 above -0, NaN by its bits); ids are equal wherever
the construction plants a margin, and
elsewhere may differ only between neighbours whose plain scores lie
within that tolerance of each other.  A hop's mark-deltas (words and
addends: which candidates were valid) must be equal, and its beam is
held to the same rule, f32-min entries aligned exactly.
"""

from __future__ import annotations

import argparse
import atexit
import dataclasses
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

TOL_REL = 1e-5
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOPS = 67e12                # H100 SXM data sheet, f32 on CUDA cores
BF16_FLOPS = 989.4e12            # H100 SXM data sheet, dense bf16 on the tensor cores
BATCHES = 8                      # served batches on the main path
DEEP_K = 4096                    # the main path's one deep dense request: k above the scan kernels' 2048
MSMARCO = dict(n=8_841_823, d=768, v=30_522, nnz=128, nnz_q=32, b=16)
SOURCES = ("src/repro_torch/kernels/csrc/topk_scan.cu", "src/repro_torch/kernels/csrc/beam_hop.cu",
           "src/repro_torch/kernels/csrc/fused_score.cu", "src/repro_torch/kernels/csrc/topk_large.cu",
           "src/repro_torch/kernels/csrc/mips_topk.cu")
GRAPH = dict(degree=16, ef=64)   # configs/paper_retrieval.py ann_degree / ann_ef
NAPP = dict(num_pivots=128, num_index=8, num_search=8, min_times=2, rerank_qty=256)  # paper_retrieval.py:36-38
NAPP_DRAWS = 32                  # pivot draws whose recall "napp recall" prints beside the gated one
RECALL_N = 1_048_576             # rows of the planted-cluster recall corpus
SKEW_N = 1_048_576               # rows of the uniform / Zipf term-id timing
CLUSTERS = 8
FUSION_TRAIN, FUSION_HELD = 256, 128   # "fusion full": training and held-out queries
LIVE_CAND = 100                  # "live full": cand_qty, as the main path
LIVE_INSERTS, LIVE_PLANTED_INSERTS = 1024, 256   # state (b): rows inserted, of which planted
LIVE_DELETES, LIVE_MORE_DELETES = 1000, 4000     # state (b) deletes, then state (c)'s
LIVE_PLANTED_DELETES = (300, 500)                # of those, planted rows
ANN_INSERTS, ANN_DELETES, ANN_MAIN_DELETES = 1024, 512, 48   # "live ann" churn; main deletes <= ef - k
SERVE_QUERIES, SERVE_DEEP_QUERIES = 512, 64   # "serve full": distinct queries an endpoint
SERVE_CLIENTS, SERVE_SHARDS, SERVE_UPSERT = 4, 4, 256
SERVE_ALL_PASSES = 6                           # "serve all": every endpoint at once, this many times
# "serve full": fused_funnel's e2e budget in offline fused batches.  The flood's first batch must
# fit it (the rerank runs) and the full queue's must not (it is skipped).  Each run logs every
# batch's time before its rerank decision (PreRerankClock), the margins this constant keeps: under
# 4 clients computing cache keys the first batch once spent more than 4 batches' time there
SERVE_FUNNEL_BATCHES = 8
CHURN_UPSERT, CHURN_PERIOD_S = 16, 0.01        # "serve churn": ids an upsert writes, the writer's pause
SPLIT_VARIANTS = (   # "serve split": label, cache size, client work before each submit, clients, switch interval
                     # in s (None: the interpreter's default)
    ("cache", 4096, None, SERVE_CLIENTS, None),
    ("no cache", 0, None, SERVE_CLIENTS, None),
    ("no cache, clients compute the key", 0, "key", SERVE_CLIENTS, None),
    ("no cache, clients compute the key from numpy copies", 0, "key on numpy", SERVE_CLIENTS, None),
    ("no cache, clients make only the key's PyTorch calls", 0, "torch calls", SERVE_CLIENTS, None),
    ("no cache, clients spin in Python for a key's time", 0, "spin", SERVE_CLIENTS, None),
    ("cache, 1 client", 4096, None, 1, None),
    ("cache, switch interval 0.1 ms", 4096, None, SERVE_CLIENTS, 1e-4),
)
CROSSOVER_K = (10, 100, 356, 1100, 2000, 2048)  # "crossover": B1 and B2 against topk_large at these k
FLEX = dict(cand=100, interm=50, final=10, k1=1.2, b=0.75, model1_iters=5, model1_lambda=0.1,   # configs/
            trees=50, depth=3, ca_rounds=4, ca_restarts=3)                                      # paper_retrieval.py
FLEX_TRAIN, FLEX_HELD, FLEX_MARGIN = 256, 128, 16   # "flexneuart full": training, held-out and margin queries
FLEX_TOPICS, FLEX_EMBED = 8, 300                    # a planted query's topic terms; avgWordEmbed's width E
FLEX_PREFIX, FLEX_DEEP = 4096, 2000                 # rows of the plain builds' prefix; the paper's candQty
FLEX_EXTRACTORS = (                                 # the composite extractor, a Fig. 3 configuration
    {"type": "TFIDFSimilarity", "params": {"k1": 1.2, "b": 0.75}},
    {"type": "proximity", "params": {"window": 5}},
    {"type": "avgWordEmbed", "params": {"use_idf": True, "dist_type": "cosine"}},
    {"type": "model1", "params": {"lam": 0.1}},
    {"type": "rm3", "params": {"fb_docs": 10, "fb_terms": 32}},
)
# card vs cpu, of each row's largest |feature| (tests/test_torch_scorers.py states why log and exp need more)
FLEX_FEATURE_TOL = {"TFIDFSimilarity": TOL_REL, "proximity": TOL_REL, "avgWordEmbed": TOL_REL,
                    "model1": 1e-5, "rm3": 1e-5}
CROSS = dict(arch="smollm-360m", cand=50, keep=10, out_dim=768)   # "cross full": configs/paper_retrieval.py
                                                                   # interm_qty / final_qty; the dense width
CROSS_BATCHES, CROSS_QUERIES, CROSS_CLIENTS = 8, 256, 4   # offline batches timed; served host queries; clients
# "cross full": bf16 against f32 scores of the same weights, of each pair's sum_i |pooled_i * head_i|: a score is
# the head's dot with the pooled state, so a relative error e of every pooled component moves it by at most e times
# that sum.  bf16 keeps 8 significant bits (a rounding moves a value by at most 2^-9 of it) and the residual stream
# takes 2 rounded adds a layer: over smollm's 32 layers the 64 roundings add up to about sqrt(64) x 2^-9 = 2^-6 of
# the stream as a random walk (1% measured for the pooled state's norm on the CPU at full width), so 2^-6
CROSS_BF16_TOL = 2.0 ** -6
# "recsys full": DIN as published (configs/din.py) serving candidate generation, the examples/recsys_candidates.py
# settings: users a batch, tag vocabulary, tags a user, the fused space's weights, k, the candidates of the
# retrieval_cand shape (configs/base.py RECSYS_SHAPES), served users and clients, the funnel's widths
RECSYS = dict(arch="din", b=16, tags=50, user_tags=3, w_dense=1.0, w_sparse=0.5, k=100, cand=1_000_000,
              served=256, clients=4, cand_qty=50, fusion_qty=30, keep=20)
RECSYS_OTHERS, RECSYS_OTHER_B = ("wide-deep", "dien", "bst"), 512   # forward_logits at serve_p99's batch
# "molecule full": SchNet as published (configs/schnet.py), the examples/molecule_retrieval.py settings: molecules,
# atoms a molecule, template families, the perturbation, radius_graph's k, molecules an embedding batch, served
# queries and clients, the funnel's widths
MOLECULE = dict(mols=1_048_576, atoms=30, families=1024, sigma=0.05, k_graph=6, batch=4096, queries=256,
                clients=4, served_b=32, cand_qty=24, keep=6)
# the graph over the molecules' half-embeddings keeps one component a family (near duplicates link only to
# each other): an evenly spread entry set of sqrt(N) = 1,024 ids misses a family with probability e^-1, 16 ids
# a family (16,384) with e^-16
MOLECULE_ENTRIES = 16_384
# "lm full": the repo's LM family on the card, LM inference through the port's decode and prefill steps
LM_ARCHS = ("qwen2.5-3b", "minicpm3-4b", "phi3.5-moe-42b-a6.6b")
LM_MOE_LAYERS = 16               # phi3.5-moe: 16 of its 32 layers (83.8 GB as published does not fit in 80 GB)
# prefill (batch, tokens); the decode loop's batch, cache length, prompt and greedy steps; the long-context step's
# cache length (decode_32k, configs/base.py LM_SHAPES) and batch (of the shape's 128); the f32 checks' depth, the
# card-vs-CPU check's batch, prompt and decode steps, the decode-vs-prefill check's steps, the profiled steps
LM = dict(prefill=(4, 1024), decode_b=16, decode_len=4096, prompt=32, gen=32, long_len=32768, long_b=16,
          long_b_moe=4, check_layers=2, cpu_b=2, cpu_prompt=16, cpu_steps=4, dvp_steps=8, profiled=4)
# long_b_moe: phi3.5-moe's 16 layers hold 8.6 GB of cache at B = 4 beside 42.2 GB of weights (34.4 GB at 16)
LM_TOL = 1e-5                    # f32 logits, card vs CPU and decode vs prefill, of each row's largest |logit|
LM_TOP1_AT = (7, 31, 63)         # decode steps whose bf16 top-1 is held against prefill's (printed, not gated)
# "train full": the f32 card-vs-CPU steps' depth, batch (phi3.5-moe's: its grad_accum 4 needs 4 rows) and length;
# smollm-360m's training batch and length (train_4k's positions, configs/base.py LM_SHAPES), steps, checkpoint
# interval, resumed steps and lr (train_lm's default); DIN's batch (train_batch) and steps; SchNet's molecules
# (the molecule shape's 128 graphs) and steps
TRAIN = dict(check_layers=2, check_b=2, check_b_moe=4, check_s=256, b=4, s=4096, steps=6, interval=3, more=2,
             lr=3e-4, din_b=65536, din_steps=3, mol_graphs=128, mol_steps=4)
TRAIN_TOL = 1e-5                 # f32 train steps, card vs CPU, of each leaf's largest |value|
GRAD_FLOOR = 1e-3                # a vanishing gradient is noise: leaves held against this share of the largest
STEP_LR = 1e-3                   # the card-vs-CPU steps' learning rate
AUTOTUNE = dict(generations=2, population=16, measure_budget=4)   # "autotune": the search's settings
AUTOTUNE_QUERIES, AUTOTUNE_WARM, AUTOTUNE_REQUESTS = 256, 16, 256   # distinct queries, warm-up, workload
# "dist full": the ranks sharing the card, their mesh, cand_qty, the shard counts (8: two a rank), the gradient
# all-reduce's ("pod", "data") mesh; the limit on the phase's ranks and on each collective, in s
DIST = dict(world=4, mesh=(1, 4), cand=100, shards=(4, 8), grad_mesh=(2, 2), timeout=600, collective_timeout=300)
# "moe ep full": B x S tokens of the published layers; positions of the f32 smoke pass
MOE_EP = dict(tokens=(4, 1024), smoke_seq=64)
# "moe ep full", bf16, of a row's largest |y|: each side rounds an expert's SwiGLU (3 roundings of at most 2^-9 of
# a value) and its combine (a product and an add a pair); the 2-D split adds its two halves' outputs, their
# combines and their sum, about 8 roundings of values up to the row's scale on the two sides: 8 x 2^-9 = 2^-6
# each, 2^-5 between them
MOE_BF16_TOL = 2.0 ** -5
# "mesh train full", "mesh lm full", "mesh models full": DIST["world"] gloo ranks on one ("data", "model") mesh
# sharing the card. (a) qwen2.5-3b f32 at a_layers: a_steps of train_lm at a_b x a_s; (b) bf16 at b_layers, remat,
# b_steps at b_b x b_s, checkpointed at b_save; (c) phi3.5-moe f32 at c_layers, c_steps of its ZeRO step at c_b x
# c_s (4 microbatches); the LMs' prefill and decode at lm_layers; DIN's users and candidates; SchNet's molecules
MESH = dict(shape=(2, 2), a_layers=2, a_b=4, a_s=512, a_steps=3, b_layers=8, b_b=4, b_s=1024, b_steps=4, b_save=2,
            c_layers=2, c_b=8, c_s=512, c_steps=2, lm_layers=2, prefill=(2, 1024), cache=4096, decode=8,
            din_b=512, din_cand=1_000_000, mol=128)
# AdamW over a_steps steps, f32: each side moves an element by lr (|m_hat| / (sqrt(v_hat) + eps) + wd |p|) a step,
# and |m_hat| / sqrt(v_hat) <= 1.001 for t <= 3 at b1 0.9, b2 0.95 (Cauchy-Schwarz over the moments' weights), so
# two runs whose gradients differ only by summation order part by at most 2 lr (1.001 + wd max|p|) a step where a
# tiny gradient flips the update's sign; the parameters after the last step are held within TRAIN_TOL of the leaf's
# scale plus that drift, the first step's within adamw_first_step_err's bound and its moments within TRAIN_TOL
MESH_ADAMW_RATIO = 1.001
# f32 gradients over a mesh, of a leaf's largest |value| (the first step's first moment, m = (1 - b1) g): each is a
# sum over 2,048 tokens of products summed over up to 11,008 terms, which the mesh splits into partial sums in
# another order (over the data ranks, the model ranks' heads and columns, the vocabulary shards); one device's
# two orders, the card's and the CPU's, already part by up to 8.2e-6 in "train full" (against TRAIN_TOL 1e-5), and
# the mesh's reorder adds about as much again (1.2e-5 measured here, qwen's key bias against its floor); the
# second moment, (1 - b2) g^2, doubles a gradient's relative error
MESH_GRAD_TOL = 5e-5
# phi3.5-moe's router over a mesh, f32: the residual streams reaching it agree with one process's within about 1e-5
# of their scale (reordered sums), so a decision may flip only between experts whose probabilities lie that close;
# a flip held a near-tie within 1e-4 of the token's largest probability (10x), then routed as one process routed it
MESH_MOE_NEAR = 1e-4
NEG = -3.4028234663852886e38     # f32 min, the mask of invalid candidates
SLEEP_CYCLES = 2_000_000         # ~1 ms at an H100 SXM's 1.98 GHz boost clock: outlasts the host's enqueue of a traversal


def log(*parts):
    print(*parts, flush=True)


def large_phase(torch, dev, check):
    """The large-k kernels (k above the scan kernels' 2048) against their
    plain version: dense ip/l2, fused and sparse, f32 and bf16, k from
    2049 to n_valid; a sparse corpus of small integers (exact scores, so
    ties everywhere and the lower id must win) with rows scoring NaN
    (+inf at a term no query weighs) and COO ids out of range; and k past
    n_valid through the backend, which adds the reference's tail.  Then
    the selection's paths: exact NaN / +0 / -0 scores (``exact_rows``)
    through the dense tiles, the fused score kernel and the row kernel at
    B = 1, 16 and 128; 40,000 scores sharing their top 12 bits, which the
    refinement passes resolve at 22 and at 32 bits; and all-equal scores
    on 40,000 rows, beyond the capacity, which take the ordered fill of
    tied rows, at k = 2049 and k = n_valid."""
    from repro_torch.core.backends import CudaBackend, ReferenceBackend
    from repro_torch.core.spaces import DenseSpace
    from repro_torch.kernels import ref
    from repro_torch.kernels import topk_large as lk

    def plain(table, q, c_idx, c_val, c_dense, k, n_valid=None, **kw):
        """topk_large's plain version: the plain scan over rows [0, n_valid)."""
        cut = lambda x: x if x is None or n_valid is None else x[:n_valid]
        return ref.fused_topk_table_ref(table, q, cut(c_idx), cut(c_val), cut(c_dense), k, **kw)

    n, d, v, nnz, n_valid = 5003, 64, 1000, 16, 4900
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        dense, idx, val, _ = make_corpus(torch, n, d, v, nnz, 2048, 51, dev, dtype)
        for b in (5, 16):
            qd, qi, qv = make_queries(torch, b, d, v, 8, 52 + b, dev)
            table = torch.zeros(b, v + 1, device=dev).scatter_add_(1, qi.long(), qv)
            table[:, v] = 0.0
            for k in (2049, n_valid):
                for label, args in (
                        ("dense ip", (None, qd, None, None, dense, k, None, None, "ip")),
                        ("dense l2", (None, qd, None, None, dense, k, None, None, "l2")),
                        ("fused", (table, qd, idx, val, dense, k, 0.6, 0.4, "ip"))):
                    kw = dict(w_dense=args[6], w_sparse=args[7], dense_kind=args[8], n_valid=n_valid)
                    want = plain(*args[:5], k, **kw)
                    check("topk_large", f"large {label} {tag} b{b} k{k}", lk.topk_large(*args[:6], **kw),
                          want, exact_ids=False)
        got = CudaBackend().topk(DenseSpace("ip"), qd, dense, 5000, n_valid=n_valid)
        want = ReferenceBackend().topk(DenseSpace("ip"), qd, dense, 5000, n_valid=n_valid)
        check("topk_large", f"large backend tail {tag}", got, want, exact_ids=False)
    # exact scores: ties everywhere, NaN rows, out-of-range ids
    g = torch.Generator(device=dev).manual_seed(53)
    idx = torch.randint(1, 64, (n, nnz), generator=g, device=dev, dtype=torch.int32)
    val = torch.randint(1, 4, (n, nnz), generator=g, device=dev).float()
    bad = torch.tensor([v + 1, 2 ** 31 - 1, -1, -7, -(v + 1)], dtype=torch.int32, device=dev)
    idx[1::9, 1] = bad.repeat(n // 45 + 1)[:len(range(1, n, 9))]
    idx[4::97, 2], val[4::97, 2] = v - 2, math.inf
    table = torch.randint(0, 3, (16, v + 1), generator=g, device=dev).float()
    table[:, v - 2] = 0.0
    full = plain(table, None, idx, val, None, n_valid, n_valid=n_valid)[0]
    assert bool(full.isnan().any()) and bool((full[:, 1:] == full[:, :-1]).any())
    for k in (2049, 4000, n_valid):
        want = plain(table, None, idx, val, None, k, n_valid=n_valid)
        check("topk_large", f"large sparse exact ties NaN k{k}",
              lk.topk_large(table, None, idx, val, None, k, n_valid=n_valid), want)
    # NaN, +0 and -0 (exact_rows); bf16 holds the same integers exactly
    for b in (1, 16, 128):
        (cd, ci, cv), (qd, table) = exact_rows(torch, n, d, v, b, 81 + b, dev)
        for dtype in (torch.float32, torch.bfloat16):
            tag = "f32" if dtype == torch.float32 else "bf16"
            cdt = cd.to(dtype)
            for k in (2049, n_valid):
                for label, args in (
                        ("dense ip", (None, qd, None, None, cdt, k, None, None, "ip")),
                        ("dense l2", (None, qd, None, None, cdt, k, None, None, "l2")),
                        ("dense ip d=61", (None, qd[:, :61].contiguous(), None, None, cdt[:, :61].contiguous(),
                                           k, None, None, "ip")),
                        ("fused", (table, qd, ci, cv.to(dtype), cdt, k, -0.5, -0.25, "ip")),
                        ("sparse", (table, None, ci, cv.to(dtype), None, k, None, None, "ip"))):
                    kw = dict(w_dense=args[6], w_sparse=args[7], dense_kind=args[8], n_valid=n_valid)
                    want = plain(*args[:6], **kw)
                    if k == n_valid:   # the case is what it claims to be
                        assert bool(want[0].isnan().any()) and bool((want[0] == 0).any()), label
                    check("topk_large", f"large {label} NaN/+-0 {tag} b{b} k{k}",
                          lk.topk_large(*args[:6], **kw), want, signed_zeros=True)
    # refinement: 40,000 rows whose scores (column q of a one-hot query q)
    # share their top 12 bits beyond the capacity, so that the selection
    # resolves the k-th key at 22 bits (query 0: 1 + j / 2**20) or at 32
    # (query 1: 1 + (j % 1024) / 2**23, each score on about 39 rows)
    m = 40_000
    j = torch.arange(m, device=dev, dtype=torch.float32)
    steps = torch.zeros((m, 64), device=dev)
    steps[:, 0] = 1.0 + j[torch.randperm(m, generator=g, device=dev)] / 2 ** 20
    steps[:, 1] = 1.0 + (j % 1024) / 2 ** 23
    qd = torch.eye(2, 64, device=dev)
    for k in (2049, m):
        check("topk_large", f"large refine k{k}", lk.topk_large(None, qd, None, None, steps, k),
              plain(None, qd, None, None, steps, k), signed_zeros=True)
    # all-equal scores (+0 everywhere) beyond the capacity: the ordered fill
    flat = torch.zeros((40_000, 64), device=dev)
    for b in (1, 16, 128):
        qd, _, _ = make_queries(torch, b, 64, v, 8, 57, dev)
        for k in (2049, 40_000):
            want = ref.fused_topk_table_ref(None, qd, None, None, flat, k)
            got = lk.topk_large(None, qd, None, None, flat, k)
            assert torch.equal(got[1].cpu(), torch.arange(k, dtype=torch.int32).expand(b, k)), \
                f"all-equal b{b} k{k}: not the lowest rows in order"
            check("topk_large", f"large all-equal b{b} k{k}", got, want, signed_zeros=True)


def exact_rows(torch, n, d, v, b, seed, device):
    """Small integers whose scores are exact, so that kernel and plain
    version agree bit for bit and the order of NaN, +0 and -0 decides the
    ids: dense values in {-1, 0, 1} (a third of the rows zero, every 13th
    row equal to query 0's dense part, every 17th holding +inf in column 1,
    where every query is 0: 0 * inf is NaN), one COO slot a row of value
    +-1 or +-2 at a term in [0, 8) (every 19th row also +inf at term v - 1,
    which no query weighs), the rest pad (id v, value 0); queries with
    dense values in {0, 1, 2} and weights 1 or 2 on terms 0-7.  Dense ip
    scores +0 on zero rows, l2 -0 on query 0's copies, and the fused mix
    with negative weights -0 where both parts are zero and +0 where they
    cancel.  Returns (dense, idx, val), (q_dense, table)."""
    g = torch.Generator(device=device).manual_seed(seed)
    dense = torch.randint(-1, 2, (n, d), generator=g, device=device).float()
    dense[torch.rand(n, generator=g, device=device) < 0.35] = 0.0
    qd = torch.randint(0, 3, (b, d), generator=g, device=device).float()
    qd[:, 1] = 0.0
    dense[::13] = qd[0]
    dense[::17, 1] = math.inf
    idx = torch.full((n, 4), v, dtype=torch.int32, device=device)
    val = torch.zeros(n, 4, device=device)
    idx[:, 0] = torch.randint(0, 8, (n,), generator=g, device=device, dtype=torch.int32)
    sign = torch.where(torch.rand(n, generator=g, device=device) < 0.5, -1.0, 1.0)
    val[:, 0] = sign * torch.randint(1, 3, (n,), generator=g, device=device).float()
    idx[::19, 1], val[::19, 1] = v - 1, math.inf
    table = torch.zeros(b, v + 1, device=device)
    table[:, :8] = torch.randint(1, 3, (b, 8), generator=g, device=device).float()
    table[:, :8] *= (torch.rand(b, 8, generator=g, device=device) < 0.6).float()
    return (dense, idx, val), (qd, table)


def make_corpus(torch, n, d, v, nnz, n_plant, seed, device, dtype):
    """Fused corpus: random unit-scale dense rows with column 0 zeroed and
    random COO rows over ids [1, v).  ``n_plant`` rows spread over the
    whole range get a single dense entry ``t_j = 1 + j/4096`` in column 0
    and a single COO entry (id 0, ``6 - j/512``), so against a planted
    query (column 0 = 2, id 0 weighted 8) their scores are exact, distinct
    and far above every other row: the top-k ids are pinned for k <=
    n_plant (the torch form of benchmarks/common.py planted_margin_*)."""
    g = torch.Generator(device=device).manual_seed(seed)
    dense = torch.randn(n, d, generator=g, device=device).mul_(1.0 / math.sqrt(d))
    dense[:, 0] = 0.0
    idx = torch.randint(1, v, (n, nnz), generator=g, device=device, dtype=torch.int32)
    val = torch.rand(n, nnz, generator=g, device=device)
    planted = (torch.arange(n_plant, device=device) * max(n // n_plant, 1)) % n
    j = torch.arange(n_plant, device=device, dtype=torch.float32)
    dense[planted] = 0.0
    dense[planted, 0] = 1.0 + j / 4096.0
    idx[planted] = v
    val[planted] = 0.0
    idx[planted, 0] = 0
    val[planted, 0] = 6.0 - j / 512.0
    return dense.to(dtype), idx, val.to(dtype), planted


def make_queries(torch, b, d, v, nnz_q, seed, device, planted=True):
    g = torch.Generator(device=device).manual_seed(seed)
    qd = torch.randn(b, d, generator=g, device=device).mul_(1.0 / math.sqrt(d))
    qi = torch.randint(1, v, (b, nnz_q), generator=g, device=device, dtype=torch.int32)
    qv = torch.rand(b, nnz_q, generator=g, device=device)
    qd[:, 0] = 2.0 if planted else 0.0
    if planted:
        qi[:, 0] = 0
        qv[:, 0] = 8.0
    return qd, qi, qv


def zipf_ids(torch, shape, v, g, device):
    """Term ids in [1, v) with id r drawn with probability proportional
    to 1 / r (a Zipf law over the vocabulary's rank order)."""
    cdf = torch.cumsum(1.0 / torch.arange(1, v, device=device, dtype=torch.float64), 0)
    u = torch.rand(shape, generator=g, device=device, dtype=torch.float64) * cdf[-1]
    return (torch.searchsorted(cdf, u) + 1).clamp_max(v - 1).to(torch.int32)


def index_stress(torch, idx, qi, qv, v, g, skew):
    """In place: the corpus ids Zipf-skewed (``skew``), five ids out of
    range (past v, -1, 2**31 - 1, -7, -(v+1)) in odd rows (never planted);
    every query repeats its terms 1-3 in slots 5-7 and the last query is
    all pad (ids v, values 0).  Returns the query table [B, V+1]."""
    if skew:
        keep = (idx == 0) | (idx == v)    # the planted entries and pad slots
        idx.copy_(torch.where(keep, idx, zipf_ids(torch, idx.shape, v, g, idx.device)))
    idx[3, 2], idx[11, 1], idx[17, idx.shape[1] - 1] = v + 7, -1, 2 ** 31 - 1
    idx[23, 3], idx[29, 0] = -7, -(v + 1)    # count from the end: columns v - 6 and 0
    if qi.shape[1] >= 8:
        qi[:, 5:8] = qi[:, 1:4]
    qi[-1], qv[-1] = v, 0.0
    table = torch.zeros(qi.shape[0], v + 1, device=qi.device).scatter_add_(1, qi.long(), qv)
    table[:, v] = 0.0
    return table


def sparse_fmas(torch, table, idx, rows=1 << 20):
    """Sparse multiply-adds that these inputs need: over every COO slot,
    the queries whose table column is present at its term (nonzero or not
    finite); the other products add zeros."""
    v = table.shape[1] - 1
    held = ((table != 0) | ~torch.isfinite(table)).sum(0, dtype=torch.int64)
    freq = torch.zeros(v + 1, dtype=torch.int64, device=idx.device)
    for r0 in range(0, idx.shape[0], rows):
        ids = idx[r0:r0 + rows].flatten().long()
        ids = torch.where(ids < 0, ids + v + 1, ids).clamp(0, v)   # as the kernels read them
        freq += torch.bincount(ids, minlength=v + 1)
    return int((freq * held).sum())


class Checker:
    """Kernel vs plain version; keeps the worst |error| per kernel."""

    def __init__(self, torch):
        self.torch = torch
        self.max_err = {}
        self.cases = 0

    def __call__(self, kernel, name, got, want, exact_ids=True, signed_zeros=False):
        """Scores and ids, kernel against plain version; with
        ``signed_zeros`` (exact scores) the NaN and zero scores must also
        be equal bit for bit."""
        torch = self.torch
        gs, gi = (x.cpu() for x in got)
        ws, wi = (x.cpu() for x in want)
        assert gs.shape == ws.shape and gi.shape == wi.shape, (name, gs.shape, ws.shape)
        fin = torch.isfinite(ws)
        assert torch.equal(fin, torch.isfinite(gs)), f"{name}: -inf tails differ"
        if signed_zeros:
            odd = ws.isnan() | (ws == 0)
            assert torch.equal(odd, gs.isnan() | (gs == 0)), f"{name}: NaN / zero slots differ"
            assert torch.equal(gs[odd].view(torch.int32), ws[odd].view(torch.int32)), \
                f"{name}: NaN / zero bits differ"
        self._compare(kernel, name, gs, gi, ws, wi, fin, exact_ids)

    def hop(self, name, got, want, exact_ids=True):
        """One hop, kernel against plain version: mark-deltas equal;
        beam scores within tolerance, f32-min (invalid) entries aligned;
        ids as in ``__call__``.  Returns the number of valid candidates."""
        torch = self.torch
        gs, gi, gw, ga = (x.cpu() for x in got)
        ws, wi, ww, wa = (x.cpu() for x in want)
        assert torch.equal(gw, ww), f"{name}: visited words differ"
        assert torch.equal(ga, wa), f"{name}: addends differ at {int((ga != wa).sum())} places"
        real = ws > NEG
        assert torch.equal(real, gs > NEG), f"{name}: invalid beam slots differ"
        assert torch.equal(ws.isnan(), gs.isnan()), f"{name}: NaN beam slots differ"
        self._compare("beam_hop", name, gs, gi, ws, wi, real, exact_ids)
        return int((ga != 0).sum())

    def scores(self, kernel, name, got, want):
        """A score matrix, kernel against plain version, on their device:
        finite, and within TOL_REL of each row's largest |score|."""
        torch = self.torch
        assert got.shape == want.shape, (name, got.shape, want.shape)
        assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all()), name
        scale = want.abs().amax(1, keepdim=True).clamp_min(1e-30)
        err = (got - want).abs()
        ratio = float((err / scale).max())
        assert ratio <= TOL_REL, f"{name}: score error {ratio:.3g} of row scale > {TOL_REL}"
        self.max_err[kernel] = max(self.max_err.get(kernel, 0.0), float(err.max()))
        self.cases += 1

    def _compare(self, kernel, name, gs, gi, ws, wi, real, exact_ids):
        """Scores where ``real`` within TOL_REL of the row scale; ids equal,
        or (``exact_ids`` False) different only at near-ties."""
        torch = self.torch
        scale = torch.where(real, ws.abs(), torch.zeros_like(ws)).amax(1, keepdim=True).clamp_min(1e-30)
        err = torch.where(real, (gs - ws).abs(), torch.zeros_like(ws))
        assert bool((err <= TOL_REL * scale).all()), \
            f"{name}: score error {float((err / scale).max()):.3g} of row scale > {TOL_REL}"
        bad = gi != wi
        if exact_ids:
            assert not bool(bad.any()), f"{name}: ids differ at {int(bad.sum())} places"
        elif bool(bad.any()):
            gap = (ws[:, :-1] - ws[:, 1:]).abs() <= 2 * TOL_REL * scale
            near = torch.zeros_like(bad)
            near[:, 1:] |= gap
            near[:, :-1] |= gap
            assert not bool((bad & ~near).any()), f"{name}: ids differ beyond near-ties"
        self.max_err[kernel] = max(self.max_err.get(kernel, 0.0), float(err.max()))
        self.cases += 1


def planted_cluster(torch, n, d, v, nnz, nnz_q, b, seed, device):
    """Fused planted-cluster corpus and queries over ``CLUSTERS`` clusters:
    the torch form of benchmarks/common.py planted_cluster_fused, with the
    COO built directly (a dense [N, V] table would take 128 GB at full
    scale).  Row i belongs to cluster c = i % C with weight t = 2 - (i //
    C) / m (m = n / C) on dense axis c and on term c; query j weighs 2 on
    axis and term j % C.  Noise lives in disjoint bands (queries: axes and
    terms [C, 2C); rows: [2C, d) and [2C, v), distinct terms per row), so
    every query scores exactly 2t per part on its cluster's rows and
    exactly 0 elsewhere: the exact top-k has a margin, and a row's best
    neighbours are its cluster's best-ranked rows."""
    C = CLUSTERS
    assert n % C == 0 and d >= 2 * C + 2 and v >= 2 * C + 2 and nnz >= 2 and nnz_q >= C + 1
    g = torch.Generator(device=device).manual_seed(seed)
    rows = torch.arange(n, device=device)
    t = 2.0 - (rows // C).float() / (n // C)
    dense = torch.zeros(n, d, device=device)
    z = torch.randn(n, d - 2 * C, generator=g, device=device)
    dense[:, 2 * C:] = z.mul_(0.25 / z.norm(dim=1, keepdim=True))
    del z
    dense[rows, rows % C] = t
    band = v - 2 * C
    j = torch.arange(nnz - 1, device=device)
    base = torch.randint(0, band, (n, 1), generator=g, device=device)
    step = torch.randint(1, max(1, (band - 1) // max(1, nnz - 2)) + 1, (n, 1), generator=g, device=device)
    idx = torch.empty(n, nnz, dtype=torch.int32, device=device)
    idx[:, 0] = rows % C
    idx[:, 1:] = 2 * C + (base + j * step) % band
    val = torch.empty(n, nnz, device=device)
    val[:, 0] = t
    val[:, 1:] = torch.rand(n, nnz - 1, generator=g, device=device).mul_(0.1).add_(0.05)
    qrows = torch.arange(b, device=device)
    qd = torch.zeros(b, d, device=device)
    w = torch.randn(b, C, generator=g, device=device)
    qd[:, C:2 * C] = w / w.norm(dim=1, keepdim=True)
    qd[qrows, qrows % C] = 2.0
    qi = torch.full((b, nnz_q), v, dtype=torch.int32, device=device)
    qv = torch.zeros(b, nnz_q, device=device)
    qi[:, 0] = qrows % C
    qv[:, 0] = 2.0
    qi[:, 1:C + 1] = C + torch.arange(C, device=device, dtype=torch.int32)
    qv[:, 1:C + 1] = torch.rand(b, C, generator=g, device=device).mul_(0.1).add_(0.05)
    return (dense, idx, val), (qd, qi, qv)


def cuda_ms(torch, fn, reps):
    """Median milliseconds of ``fn`` by CUDA events, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def small_phase(torch, dev, check):
    """Both kernels against their plain versions at small shapes."""
    from repro_torch.core.backends import CudaBackend, ReferenceBackend
    from repro_torch.core.spaces import DenseSpace
    from repro_torch.kernels import fused_topk as fk
    from repro_torch.kernels import mips_topk as mk
    from repro_torch.kernels import ref

    n, d, v, nnz, n_valid = 5003, 64, 1000, 16, 4900
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        dense, idx, val, planted = make_corpus(torch, n, d, v, nnz, 2048, 1, dev, dtype)
        # duplicate a few planted rows into their successors: equal scores,
        # the lower id must come first
        dup = planted[1:64:7]
        dense[dup + 1], idx[dup + 1], val[dup + 1] = dense[dup], idx[dup], val[dup]
        for b in (5, 16):
            qd, qi, qv = make_queries(torch, b, d, v, 8, 2 + b, dev)
            table = torch.zeros(b, v + 1, device=dev)
            table.scatter_add_(1, qi.long(), qv)
            table[:, v] = 0.0
            for k in (1, 10, 100, 2048):
                for space in ("ip", "l2"):
                    check("mips_topk", f"mips {space} {tag} b{b} k{k}",
                          mk.mips_topk(qd, dense, k, n_valid=n_valid, space=space),
                          ref.mips_topk_ref(qd, dense, k, n_valid=n_valid, space=space))
                for label, args in (
                        ("dense-only", (None, qd, None, None, dense, k, 0.7, None)),
                        ("sparse-only", (table, None, idx, val, None, k, None, None)),
                        ("fused", (table, qd, idx, val, dense, k, 0.6, 0.4))):
                    kw = dict(w_dense=args[6], w_sparse=args[7], n_valid=n_valid)
                    check("fused_topk", f"fused {label} {tag} b{b} k{k}",
                          fk.fused_topk(*args[:6], **kw),
                          ref.fused_topk_table_ref(*args[:6], **kw))
        # unplanted queries: general scoring, ids may swap only at near-ties
        qd, qi, qv = make_queries(torch, 16, d, v, 8, 99, dev, planted=False)
        table = torch.zeros(16, v + 1, device=dev).scatter_add_(1, qi.long(), qv)
        check("mips_topk", f"mips ip random {tag}", mk.mips_topk(qd, dense, 50),
              ref.mips_topk_ref(qd, dense, 50), exact_ids=False)
        args = (table, qd, idx, val, dense, 50)
        check("fused_topk", f"fused random {tag}",
              fk.fused_topk(*args, w_dense=0.6, w_sparse=0.4),
              ref.fused_topk_table_ref(*args, w_dense=0.6, w_sparse=0.4), exact_ids=False)
        # k > n_valid through the backend pins the reference's tail
        qd, _, _ = make_queries(torch, 4, d, v, 8, 7, dev)
        got = CudaBackend().topk(DenseSpace("ip"), qd, dense, 60, n_valid=40)
        want = ReferenceBackend().topk(DenseSpace("ip"), qd, dense, 60, n_valid=40)
        check("mips_topk", f"backend tail {tag}", got, want)
        # a width that is not a multiple of 4 takes the kernel's scalar loads
        odd = dense[:, :61].contiguous()
        qd, qi, qv = make_queries(torch, 16, 61, v, 8, 11, dev)
        for space in ("ip", "l2"):
            check("mips_topk", f"mips {space} d=61 {tag}", mk.mips_topk(qd, odd, 100, space=space),
                  ref.mips_topk_ref(qd, odd, 100, space=space))
        table = torch.zeros(16, v + 1, device=dev).scatter_add_(1, qi.long(), qv)
        args = (table, qd, idx, val, odd, 100)
        check("fused_topk", f"fused d=61 {tag}", fk.fused_topk(*args, w_dense=0.6, w_sparse=0.4),
              ref.fused_topk_table_ref(*args, w_dense=0.6, w_sparse=0.4))
    # NaN, +0 and -0 scores (exact_rows): ids equal, so that the order of
    # the kernels' threshold test and compaction is held to the plain one
    for b in (5, 16):
        (cd, ci, cv), (qd, table) = exact_rows(torch, n, d, v, b, 71 + b, dev)
        for space in ("ip", "l2"):   # the cases are what they claim to be
            full = ref.mips_topk_ref(qd, cd, n_valid, n_valid=n_valid, space=space)[0]
            assert bool(full.isnan().any()) and bool((full == 0).any()), space
        for k in (10, 100, 2048):
            for space in ("ip", "l2"):
                want = ref.mips_topk_ref(qd, cd, k, n_valid=n_valid, space=space)
                check("mips_topk", f"mips {space} NaN/+-0 b{b} k{k}",
                      mk.mips_topk(qd, cd, k, n_valid=n_valid, space=space), want, signed_zeros=True)
            for label, args in (("fused", (table, qd, ci, cv, cd, k, -0.5, -0.25)),
                                ("sparse-only", (table, None, ci, cv, None, k, None, None))):
                kw = dict(w_dense=args[6], w_sparse=args[7], n_valid=n_valid)
                want = ref.fused_topk_table_ref(*args[:6], **kw)
                check("fused_topk", f"fused {label} NaN/+-0 b{b} k{k}", fk.fused_topk(*args[:6], **kw), want,
                      signed_zeros=True)
    # the query-term index: Zipf-skewed and uniform ids, repeated query
    # terms, an all-pad query, ids out of range, both plans (qb 16 at
    # k <= 256, qb 4 at k = 2000), and a vocabulary whose index words
    # exceed the shared-memory cap (read from global memory)
    g = torch.Generator(device=dev).manual_seed(31)
    for v, dtype, skew in ((1000, torch.float32, True), (1000, torch.bfloat16, True),
                           (30_522, torch.float32, True), (250_000, torch.float32, False),
                           (250_000, torch.float32, True)):
        tag = f"v{v} {'zipf' if skew else 'uniform'} {'f32' if dtype == torch.float32 else 'bf16'}"
        dense, idx, val, _ = make_corpus(torch, n, d, v, nnz, 2048, 41, dev, dtype)
        for b in (5, 16):
            qd, qi, qv = make_queries(torch, b, d, v, 8, 43 + b, dev)
            table = index_stress(torch, idx, qi, qv, v, g, skew)
            for k in (10, 2000):
                for label, wd, ws, dn in (("fused", 0.6, 0.4, dense), ("sparse-only", None, None, None)):
                    qq = qd if dn is not None else None
                    kw = dict(w_dense=wd, w_sparse=ws, n_valid=n_valid)
                    check("fused_topk", f"index {label} {tag} b{b} k{k}",
                          fk.fused_topk(table, qq, idx, val, dn, k, **kw),
                          ref.fused_topk_table_ref(table, qq, idx, val, dn, k, **kw))


def b1_phase(torch, dev, check):
    """B1 (``mips_topk``) where its ring route can break, against the plain
    version on small integers, whose scores are exact, so that ids and
    score bits must be equal: B = 1, 5, 16 and 37, k from 1 to 2048, rows
    past n_valid, ip and l2, f32 and bf16; a corpus sorted by query 0's
    score (both ways); all scores equal (the k lowest rows); NaN, +0 and -0
    at the threshold; n_valid below k with a valid row at -inf, and
    n_valid = 0; a sample whose tiles all score 0 under scores above it, so
    that the filter's lists overflow and are sorted (asserted from the
    route's stats); the graph entry set's shape (2,973 rows of 768 at
    k = 64); and the scan route for rows a tensor map cannot describe (d =
    61, a pointer 4 bytes off).  Returns (cases, list sorts on the
    sample-blind corpus, route launches)."""
    from repro_torch.kernels import mips_topk as mk
    from repro_torch.kernels import ref

    def ints(shape, lo, hi, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randint(lo, hi, shape, generator=g, device=dev).float()

    def run(label, q, c, k, n_valid=None, space="ip", **over):
        s, i, st = mk.mips_filter(q, c, k, n_valid, space, **over)
        check("mips_topk", f"b1 {label} b{q.shape[0]} k{k} {space}", (s, i),
              ref.mips_topk_ref(q, c, k, n_valid=n_valid, space=space), signed_zeros=True)
        return st

    cases, before = check.cases, (mk.ring_launches, mk.scan_launches)
    n, d = 50_003, 64
    c = ints((n, d), -2, 3, 1)
    for b in (1, 5, 16, 37):
        q = ints((b, d), -3, 4, 2 + b)
        for k in (1, 10, 100, 356, 2048):
            for n_valid in (None, 49_000):
                for space in ("ip", "l2"):
                    run("ints", q, c, k, n_valid, space)
        for k, space in ((100, "ip"), (2048, "l2")):
            run("ints bf16", q, c.bfloat16(), k, 40_000, space)
    q = ints((16, d), -3, 4, 5)
    order = torch.argsort(q[0] @ c.T, stable=True)
    for k in (10, 2048):
        run("sorted ascending", q, c[order].contiguous(), k)
        run("sorted descending", q, c[order.flip(0)].contiguous(), k)
        s, i, _ = mk.mips_filter(ints((16, d), 1, 2, 0), torch.ones(n, d, device=dev), k)
        assert bool((i == torch.arange(k, device=dev, dtype=torch.int32)).all()), "all equal: not the lowest rows"
        run("all equal", ints((16, d), 1, 2, 0), torch.ones(n, d, device=dev), k)
    # NaN (0 * inf), +0 (zero rows in ip) and -0 (query 0's copies in l2) at
    # the k-th: every ip score <= 0 but theirs
    z = ints((n, d), -1, 1, 6)
    z[torch.rand(n, generator=torch.Generator(device=dev).manual_seed(6), device=dev) < 0.35] = 0.0
    qz = ints((16, d), 1, 3, 7)
    qz[:, 1] = 0.0
    z[::53] = qz[0]
    z[::101, 1] = math.inf
    for k in (10, 700, 2048):
        for space in ("ip", "l2"):
            st = run("NaN/+-0", qz, z, k, None, space)
    for space in ("ip", "l2"):   # the case is what it claims (a CPU ranks its NaN, 0xffc00000, last)
        full = ref.mips_topk_ref(qz, z, n, space=space)[0]
        assert bool(full.isnan().any()) and bool((full == 0).any()), f"the NaN/+-0 case has no NaN or zero: {space}"
    # n_valid below k, a valid row at -inf; no valid row
    m = ints((5000, d), -2, 3, 8)
    m[3, 0] = -math.inf
    qm = ints((4, d), 1, 3, 9)
    for space in ("ip", "l2"):
        run("n_valid < k", qm, m, 300, 200, space)
    run("n_valid = 0", qm, m, 50, 0)
    # the sample's tiles score 0, every other row more: the lists overflow
    blind = ints((n, d), 0, 3, 10)
    blind[(torch.arange(n, device=dev) // mk.TILE) % mk.SAMPLE_STRIDE == 0] = 0.0
    sorts = 0
    for k in (10, 300, 2048):
        run("sample-blind", ints((16, d), 1, 3, 11), blind, k, stride=mk.SAMPLE_STRIDE)
        # 7 filter blocks: 26 tiles each, more than a list holds
        st = run("sample-blind, 7 blocks", ints((16, d), 1, 3, 11), blind, k, stride=mk.SAMPLE_STRIDE, blocks=7)
        sorts += int(st[:, 0].sum())
        assert bool((st[:, 0] > 0).all()), f"sample-blind k={k}: the lists were never sorted"
    run("graph entry set", ints((16, 768), -2, 3, 12), ints((2973, 768), -2, 3, 13), 64)
    # rows a tensor map cannot describe take the scan route
    scan0 = mk.scan_launches
    odd, qo = ints((5003, 61), -2, 3, 14), ints((16, 61), -3, 4, 15)
    check("mips_topk", "b1 scan route d=61", mk.mips_topk(qo, odd, 100), ref.mips_topk_ref(qo, odd, 100),
          signed_zeros=True)
    off = torch.empty(5003 * 64 + 1, device=dev)[1:].view(5003, 64)
    off.copy_(c[:5003])
    assert not mk.ring_fits(off)
    check("mips_topk", "b1 scan route unaligned", mk.mips_topk(q, off, 100), ref.mips_topk_ref(q, off, 100),
          signed_zeros=True)
    if dev.type == "cuda":
        assert mk.scan_launches == scan0 + 2, "d=61 and an unaligned corpus must take the scan route"
    return check.cases - cases, sorts, (mk.ring_launches - before[0], mk.scan_launches - before[1])


def index_phase(torch, dev):
    """The query-term index built on the card (``build_index``) against
    its plain version (``query_index``): words equal, and the table read
    back through the index equal to the densified table (NaN where it is
    NaN).  Batches 1-128, groups of 4 and 16, blocks of 16 and 64,
    vocabularies with V+1 not a multiple of 32 up to 250,000, repeated
    query terms, an all-pad query, a nonzero pad column, inf and NaN
    entries, f32 and bf16.  Returns the number of indexes compared."""
    from repro_torch.kernels.query_index import build_index, query_index, table_from_index

    g = torch.Generator(device=dev).manual_seed(61)
    cases = 0
    for b, group, block, v, dtype in ((1, 16, 16, 60, torch.float32), (5, 4, 4, 1000, torch.float32),
                                      (16, 16, 16, 30_522, torch.float32), (16, 4, 4, 30_522, torch.bfloat16),
                                      (40, 16, 64, 30_522, torch.float32), (128, 16, 64, 30_522, torch.float32),
                                      (16, 16, 16, 250_000, torch.float32), (128, 16, 64, 250_000, torch.bfloat16)):
        qi = torch.randint(0, v, (b, 32), generator=g, device=dev)
        qi[:, 16:] = qi[:, :16]
        table = torch.zeros(b, v + 1, device=dev).scatter_add_(1, qi, torch.rand(b, 32, generator=g, device=dev))
        table[-1] = 0.0
        table[0, v] = 0.5
        table[0, 1], table[b // 2, 2] = float("inf"), float("nan")
        table = table.to(dtype)
        want_w, want_t = query_index(table, group, block)
        got_w, got_t = build_index(table, group, block)
        assert torch.equal(got_w, want_w), f"index words b{b} v{v} group {group}"
        back = table_from_index(got_w, got_t, v)
        torch.testing.assert_close(back[:b], table.float(), rtol=0, atol=0, equal_nan=True)
        assert torch.equal(table_from_index(want_w, want_t, v)[:b].nan_to_num(), back[:b].nan_to_num())
        cases += 1
    return cases


def beam_small_phase(torch, dev, check):
    """The hop kernel against its plain version, hop for hop from the
    kernel's own state (teacher-forced), and one traversal launch over the
    same hops against the hop-by-hop launches with their deltas committed
    (beam and final mask equal bit for bit): dense ip/l2, sparse and fused
    spaces, f32 and bf16, graphs with repeated ids, sentinel-padded rows
    and a starved beam, init beams with sentinel slots, COO ids out of
    range (V+1, 2**31-1, -1, -7, -(V+1)), valid candidates scoring f32-min,
    -inf, NaN, +0 and -0 from unsorted beams, a width that is not a multiple of 4,
    clusters of 8, 3 and 1 blocks, and ef*R at the budget cap (the state
    in global scratch)."""
    from repro_torch.core.sparse import SparseVectors
    from repro_torch.kernels import beam_topk as bk
    from repro_torch.kernels import ref

    def init_beam(g, n, ef, b, real):
        """Score-descending beam: ``real`` random ids, then sentinels (id n,
        one id -1) scoring f32-min."""
        ids = torch.randint(0, n, (b, ef), generator=g, device=dev, dtype=torch.int32)
        s = torch.randn(b, ef, generator=g, device=dev).sort(dim=1, descending=True).values
        ids[:, real:] = n
        ids[0, ef - 1] = -1
        s[:, real:] = NEG
        return s, ids

    def run(name, args, kw, nbr, n, beam, hops, exact_ids):
        beam_s, beam_i = beam
        b = beam_s.shape[0]
        vis = bk.mark_visited(torch.zeros((b, bk.visited_words(n)), dtype=torch.int32, device=dev),
                              beam_i, n)
        qd, q_dense, c_idx, c_val, c_dense = args
        start = (beam_s, beam_i, vis.clone())
        valid = 0
        for h in range(hops):
            hop_args = (qd, q_dense, beam_s, beam_i, vis, nbr, c_idx, c_val, c_dense)
            got = bk.beam_hop(*hop_args, n_valid=n, **kw)
            want = ref.beam_hop_plain(*hop_args, n_valid=n, **kw)
            valid += check.hop(f"{name} hop {h}", got, want, exact_ids)
            beam_s, beam_i = got[0], got[1]
            vis.scatter_add_(1, got[2].long(), got[3])
        one = bk.beam_search(qd, q_dense, start[0], start[1], start[2], nbr, c_idx, c_val, c_dense,
                             n_valid=n, hops=hops, **kw)
        for what, x, y in (("scores", one[0], beam_s), ("ids", one[1], beam_i), ("mask", one[2], vis)):
            x, y = (t.view(torch.int32) for t in (x, y))   # bit patterns: NaN equals NaN
            assert torch.equal(x, y), f"{name}: one launch and {hops} hop launches differ in {what}"
        return valid

    n, d, v, nnz, b = 4096, 64, 1000, 16, 16
    g = torch.Generator(device=dev).manual_seed(5)
    rnd = torch.randint(0, n, (n, 16), generator=g, device=dev, dtype=torch.int32)
    rnd[:, 8:12] = rnd[:, 0:4]                           # repeated ids in a row
    short = torch.randint(0, n, (n, 8), generator=g, device=dev, dtype=torch.int32)
    lens = torch.randint(0, 9, (n, 1), generator=g, device=dev)
    short[torch.arange(8, device=dev)[None, :] >= lens] = n   # flat_adjacency's sentinel pad
    starved = torch.full((n, 4), n, dtype=torch.int32, device=dev)
    hubs = torch.arange(0, n, 7, device=dev)
    starved[hubs, 0] = ((hubs + 1) % n).int()
    graphs = (("repeats", rnd, 64, 60), ("padded", short, 32, 29), ("starved", starved, 16, 2))
    # COO ids out of range in odd rows, read from columns V, V, V, V - 6, 0
    bad = torch.tensor([v + 1, 2 ** 31 - 1, -1, -7, -(v + 1)], dtype=torch.int32, device=dev)
    valid = seed = 0
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        (cd, ci, cv), (qd, qi, qv) = planted_cluster(torch, n, d, v, nnz, 16, b, 3, dev)
        cd, cv = cd.to(dtype), cv.to(dtype)
        table = ref.query_table(SparseVectors(qi, qv), v)
        spaces = (("dense-ip", (None, qd, None, None, cd), {}),
                  ("dense-l2", (None, qd, None, None, cd), dict(dense_kind="l2")),
                  ("sparse", (table, None, ci, cv, None), {}),
                  ("fused", (table, qd, ci, cv, cd), dict(w_dense=0.5, w_sparse=1.5)))
        for sname, args, kw in spaces:
            for gname, nbr, ef, real in graphs:
                seed += 1
                beam = init_beam(torch.Generator(device=dev).manual_seed(seed), n, ef, b, real)
                valid += run(f"beam {sname} {tag} {gname}", args, kw, nbr, n, beam, 4,
                             sname != "dense-l2")
        # out-of-range COO ids, and a table whose columns V - 6 and 0 weigh
        # in, so that a wrong column shows in the scores
        ci_bad = ci.clone()
        ci_bad[1::2, 1] = bad.repeat(n // 10 + 1)[:n // 2]
        table_bad = table.clone()
        table_bad[:, v - 6] = 0.5
        for sname, args, kw in (("sparse", (table_bad, None, ci_bad, cv, None), {}),
                                ("fused", (table_bad, qd, ci_bad, cv, cd), dict(w_dense=0.5, w_sparse=1.5))):
            seed += 1
            beam = init_beam(torch.Generator(device=dev).manual_seed(seed), n, 64, b, 60)
            valid += run(f"beam {sname} {tag} ids out of range", args, kw, rnd, n, beam, 4, False)
        # random (unplanted) data at a width that is not a multiple of 4
        gr = torch.Generator(device=dev).manual_seed(9)
        dense61 = torch.randn(n, 61, generator=gr, device=dev).to(dtype)
        q61 = torch.randn(b, 61, generator=gr, device=dev)
        valid += run(f"beam fused d=61 random {tag}", (table, q61, ci, cv, dense61),
                     dict(w_dense=0.7, w_sparse=0.3), rnd, n,
                     init_beam(torch.Generator(device=dev).manual_seed(11), n, 64, b, 60), 3, False)
    valid += extremes(torch, dev, run, n, v, nnz, b)
    # candidates scoring NaN, +0 and -0 (exact_rows, fused with negative
    # weights): ids equal, so the merge's order of them is the plain one's
    (cd, ci, cv), (qd, table) = exact_rows(torch, n, 64, v, b, 91, dev)
    beam = init_beam(torch.Generator(device=dev).manual_seed(92), n, 64, b, 60)
    valid += run("beam fused f32 NaN/+-0", (table, qd, ci, cv, cd), dict(w_dense=-0.5, w_sparse=-0.25),
                 rnd, n, beam, 3, True)
    # clusters of 3 (B = 40) and of 1 block (B = 200) a query
    for bq in (40, 200):
        (cd, _, _), (qd, _, _) = planted_cluster(torch, n, d, v, nnz, 16, bq, 6, dev)
        beam = init_beam(torch.Generator(device=dev).manual_seed(bq), n, 64, bq, 60)
        valid += run(f"beam dense-ip f32 b={bq}", (None, qd, None, None, cd), {}, rnd, n, beam, 3, True)
    # ef*R at the cap: each query's state in global scratch
    (cd, _, _), (qd, _, _) = planted_cluster(torch, n, d, v, nnz, 16, 3, 4, dev)
    cap = torch.randint(0, n, (n, 16), generator=g, device=dev, dtype=torch.int32)
    ef = bk.MAX_BEAM_CANDIDATES // 16
    assert dev.type != "cuda" or bk.scratch_bytes(ef, 16) > 0
    beam = init_beam(torch.Generator(device=dev).manual_seed(13), n, ef, 3, ef - 8)
    valid += run("beam dense-ip f32 ef*R=32768", (None, qd, None, None, cd), {}, cap, n, beam, 2, True)
    return valid


def extremes(torch, dev, run, n, v, nnz, b):
    """Sparse f32 hops where valid candidates score exactly f32-min (rows
    i % 4 == 1: one slot of value f32-min at a term every query weighs
    1.0, the rest pad) and -inf (rows i % 4 == 3), from unsorted beams:
    (a) a starved beam of 2 real slots among sentinel slots (ids n and
    -1) scoring -inf, degree 4 with a sentinel neighbour, so that the
    f32-min candidates interleave with the invalid ones by slot; (b) 8
    real slots, 3 at -inf and 1 at f32-min, degree 2, every candidate
    distinct, so that -inf candidates reach the beam; (c) valid candidates
    scoring NaN (rows i % 4 == 2 also hold +inf at a term no query weighs:
    0 * inf), which rank above +inf, from a starved beam and from a beam
    holding a NaN."""
    from repro_torch.core.sparse import SparseVectors
    from repro_torch.kernels import ref

    (_, ci, cv), (_, qi, qv) = planted_cluster(torch, n, 64, v, nnz, 16, b, 8, dev)
    table = ref.query_table(SparseVectors(qi, qv), v)
    table[:, v - 1] = 1.0
    rows = torch.arange(n, device=dev)
    for r0, val in ((1, NEG), (3, -math.inf)):
        x = rows[r0::4]
        ci[x], cv[x] = v, 0.0
        ci[x, 0], cv[x, 0] = v - 1, val
    g = torch.Generator(device=dev).manual_seed(17)
    even = lambda shape: 2 * torch.randint(0, n // 2, shape, generator=g, device=dev, dtype=torch.int32)
    i = rows.int()
    deg4 = torch.stack([(4 * i + 1) % n, torch.full_like(i, n), (4 * i + 3) % n, even((n,))], 1)
    deg2 = torch.stack([(4 * i + 1) % n, (4 * i + 3) % n], 1)
    valid = 0
    # (a)
    ids = torch.full((b, 16), n, dtype=torch.int32, device=dev)
    ids[:, 1::7] = -1
    s = torch.full((b, 16), -math.inf, device=dev)
    real = torch.stack([torch.randperm(16, generator=g, device=dev)[:2] for _ in range(b)])
    ids.scatter_(1, real, even((b, 2)))
    s.scatter_(1, real, torch.randn(b, 2, generator=g, device=dev))
    s16, ids16 = s.clone(), ids.clone()
    valid += run("beam sparse f32 f32-min/-inf starved", (table, None, ci, cv, None), {}, deg4, n,
                 (s, ids), 3, True)
    # (b)
    s = torch.randn(b, 8, generator=g, device=dev)
    s[:, 2], s[:, 5], s[:, 7], s[:, 4] = -math.inf, -math.inf, -math.inf, NEG
    valid += run("beam sparse f32 f32-min/-inf full", (table, None, ci, cv, None), {}, deg2, n,
                 (s, even((b, 8))), 3, True)
    # (c)
    ci_nan, cv_nan, table_nan = ci.clone(), cv.clone(), table.clone()
    ci_nan[rows[2::4], 1], cv_nan[rows[2::4], 1] = v - 2, math.inf
    table_nan[:, v - 2] = 0.0
    nan_args = (table_nan, None, ci_nan, cv_nan, None)
    valid += run("beam sparse f32 NaN starved", nan_args, {}, deg4, n, (s16, ids16), 3, True)
    s = torch.randn(b, 8, generator=g, device=dev)
    s[:, 1], s[:, 6] = math.nan, -math.inf
    deg2n = torch.stack([(4 * i + 2) % n, (4 * i + 3) % n], 1)
    valid += run("beam sparse f32 NaN full", nan_args, {}, deg2n, n, (s, even((b, 8))), 3, True)
    return valid


def score_small_phase(torch, dev, check):
    """The fused score kernel against its plain version: f32 and bf16;
    ragged N, N below one tile and N = 128 (the NAPP probe's pivots); NNZ
    1, 4 and 128 with pad slots (id V); d = 61; B = 1, 16 and 128;
    weights (0, 1), (1, 0) and mixed; and the weight linearity
    score(wd, ws) = wd * score(1, 0) + ws * score(0, 1)."""
    from repro_torch.core.sparse import SparseVectors
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_dense as sd

    v = 1000
    g = torch.Generator(device=dev).manual_seed(21)
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for n, d, nnz in ((5003, 64, 4), (100, 61, 1), (128, 768, 128), (4096, 768, 128)):
            dense = torch.randn(n, d, generator=g, device=dev).to(dtype)
            idx = torch.randint(0, v, (n, nnz), generator=g, device=dev, dtype=torch.int32)
            idx[torch.rand(n, nnz, generator=g, device=dev) < 0.25] = v
            val = torch.rand(n, nnz, generator=g, device=dev).to(dtype)
            for b in (1, 16, 128):
                qd = torch.randn(b, d, generator=g, device=dev)
                qi = torch.randint(0, v, (b, 32), generator=g, device=dev, dtype=torch.int32)
                table = ref.query_table(SparseVectors(qi, torch.rand(b, 32, generator=g, device=dev)), v)
                args = (table, qd, idx, val, dense)
                for wd, ws in ((0.0, 1.0), (1.0, 0.0), (0.6, 0.4)):
                    check.scores("fused_score", f"score {tag} n{n} d{d} nnz{nnz} b{b} w{wd}/{ws}",
                                 sd.fused_score(*args, wd, ws), ref.fused_score_ref(*args, wd, ws))
            s_d, s_s = sd.fused_score(*args, 1.0, 0.0), sd.fused_score(*args, 0.0, 1.0)
            for wd, ws in ((0.3, 1.7), (2.0, 0.5)):
                check.scores("fused_score", f"score linearity {tag} n{n} w{wd}/{ws}",
                             sd.fused_score(*args, wd, ws), wd * s_d + ws * s_s)
    # the query-term index: uniform and Zipf-skewed ids at V = 30,522,
    # B = 128 with 128-nnz queries (the largest compact tables), the
    # 64-query block with a partial block (B = 40), repeated query terms,
    # an all-pad query, ids out of range, and V = 250,000 (index words in
    # global memory)
    n, d, nnz = 4099, 96, 128
    for v, dtype, skew in ((30_522, torch.float32, False), (30_522, torch.bfloat16, True),
                           (30_522, torch.float32, True), (250_000, torch.float32, True)):
        tag = f"v{v} {'zipf' if skew else 'uniform'} {'f32' if dtype == torch.float32 else 'bf16'}"
        dense = torch.randn(n, d, generator=g, device=dev).to(dtype)
        idx = torch.randint(1, v, (n, nnz), generator=g, device=dev, dtype=torch.int32)
        idx[torch.rand(n, nnz, generator=g, device=dev) < 0.25] = v
        val = torch.rand(n, nnz, generator=g, device=dev).to(dtype)
        for b in (16, 40, 128):
            nnz_q = 128 if b == 128 else 32
            qd = torch.randn(b, d, generator=g, device=dev)
            qi = (zipf_ids(torch, (b, nnz_q), v, g, dev) if skew else
                  torch.randint(1, v, (b, nnz_q), generator=g, device=dev, dtype=torch.int32))
            qv = torch.rand(b, nnz_q, generator=g, device=dev)
            table = index_stress(torch, idx, qi, qv, v, g, skew)
            want = ref.fused_score_ref(table, qd, idx, val, dense, 0.6, 0.4)
            check.scores("fused_score", f"score index {tag} b{b} nnz_q{nnz_q}",
                         sd.fused_score(table, qd, idx, val, dense, 0.6, 0.4), want)


def graph_full_phase(torch, dev, check, corpus, batches, space, on_card):
    """Graph ANN over the resident MS MARCO-scale corpus: a random
    degree-16 graph (rounds=0), served through the pipeline with the
    beam-hop kernel for the fused and the dense ip space, one traversal
    launch per batch; then a timed pass (CUDA events around each
    traversal) whose traversals are replayed hop by hop, one launch a hop,
    and must equal it bit for bit; on batch 0 every replayed hop is held
    against the plain hop from the same input state."""
    from repro_torch.core import graph_ann
    from repro_torch.core.backends import GraphANNBackend, resolve_backend
    from repro_torch.core.pipeline import BruteForceGenerator, RetrievalPipeline
    from repro_torch.core.spaces import DenseSpace
    from repro_torch.kernels import beam_topk as bk
    from repro_torch.kernels import fused_topk as fk
    from repro_torch.kernels import mips_topk as mk
    from repro_torch.kernels import ref

    n, d = corpus.dense.shape
    nnz = corpus.sparse.indices.shape[1]
    b = batches[0].dense.shape[0]
    hops = graph_ann.default_hops(n)
    c = GRAPH["ef"] * GRAPH["degree"]
    backend = GraphANNBackend(kernel=True, rounds=0, **GRAPH)
    # per valid candidate: bytes of the gathered row, multiply-adds
    paths = {"fused": (space, corpus, lambda q: q, (d * 4 + nnz * 8, d + nnz)),
             "dense": (DenseSpace("ip"), corpus.dense, lambda q: q.dense, (d * 4, d))}
    pipes = {}
    t0 = time.perf_counter()
    for name, (sp, corp, _, _) in paths.items():
        assert resolve_backend(backend, sp, corp) is backend
        pipes[name] = RetrievalPipeline(BruteForceGenerator(sp, corp, backend=backend),
                                        cand_qty=GRAPH["ef"], final_qty=10)
        backend._index(sp, corp, n)                 # the random graph, set-up
    sync(torch, on_card)
    log(f"phase graph index: two random degree-{GRAPH['degree']} graphs over {n} rows in "
        f"{time.perf_counter() - t0:.1f} s; {hops} hops per batch")

    mk.launches = fk.launches = bk.launches = 0
    host = {name: [] for name in paths}
    results = {name: [] for name in paths}
    for q in batches:
        for name, (_, _, pick, _) in paths.items():
            t0 = time.perf_counter()
            results[name].append(pipes[name].run(pick(q)))
            sync(torch, on_card)
            host[name].append(time.perf_counter() - t0)
    launches = {"beam_hop": bk.launches, "fused_topk": fk.launches, "mips_topk": mk.launches}
    if on_card:   # one traversal launch per batch and space
        want = {"beam_hop": len(paths) * len(batches), "fused_topk": len(batches),
                "mips_topk": len(batches)}
        assert launches == want, f"graph launches {launches}, expected {want}"

    # every answer: top-10 of distinct rows, descending, rescored alike
    for name, (sp, corp, pick, _) in paths.items():
        for q, r in zip(batches, results[name]):
            ids = r.indices
            assert r.scores.shape == (b, 10) and bool(torch.isfinite(r.scores).all())
            assert bool(((ids >= 0) & (ids < n)).all())
            assert bool((ids.sort(dim=1).values.diff(dim=1) != 0).all()), "repeated ids"
            assert bool((r.scores.diff(dim=1) <= 0).all()), "not descending"
            rescored = graph_ann.score_many(sp, pick(q), graph_ann.gather_items(corp, ids))
            scale = rescored.abs().amax(1, keepdim=True).clamp_min(1e-30)
            assert bool(((r.scores - rescored).abs() <= TOL_REL * scale).all()), f"{name} rescoring"

    # timed pass: CUDA events around each traversal (its mask copy and its
    # one launch); its arguments and result are kept for the replay
    orig = bk.beam_search
    rec = []

    def timed(*a, **k):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if on_card else None
        if on_card:
            # keep the device busy while the host enqueues the traversal,
            # so that the events bracket the device's work, not the launch
            torch.cuda._sleep(SLEEP_CYCLES)
            ev[0].record()
        out = orig(*a, **k)
        if on_card:
            ev[1].record()
        rec.append((ev, a, k, out))
        return out

    traversals = {name: [] for name in paths}
    bk.beam_search = timed
    try:
        for name, (_, _, pick, _) in paths.items():
            for q in batches:
                rec.clear()
                pipes[name].run(pick(q))
                assert len(rec) == 1, f"timed pass saw {len(rec)} traversals in a batch"
                traversals[name].append(rec[0])
        sync(torch, on_card)
    finally:
        bk.beam_search = orig
    copy_ms = cuda_ms(torch, lambda: rec[0][1][4].clone(), 5) if on_card else float("nan")

    # replay every traversal hop by hop through beam_hop: the one launch
    # must equal it bit for bit; the valid candidates per hop give the
    # bound; batch 0's hops are held against the plain hop on the same
    # inputs (teacher-forced)
    kernel_ms = {name: [] for name in paths}
    bound_ms = {name: [] for name in paths}
    plain_ms = {name: 0.0 for name in paths}
    bound_by = {}
    forced_hops = 0
    for name, (_, _, _, (row_bytes, row_fmas)) in paths.items():
        for i, (ev, a, k, out) in enumerate(traversals[name]):
            kw = {key: val for key, val in k.items() if key != "hops"}
            assert k["hops"] == hops, (k["hops"], hops)
            beam_s, beam_i, vis = a[2], a[3], a[4].clone()
            valid = 0
            for h in range(hops):
                hop_args = (a[0], a[1], beam_s, beam_i, vis, *a[5:])
                got = bk.beam_hop(*hop_args, **kw)
                if i == 0:
                    pe = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if on_card else None
                    if on_card:
                        pe[0].record()
                    want = ref.beam_hop_plain(*hop_args, **kw)
                    if on_card:
                        pe[1].record()
                        pe[1].synchronize()
                        plain_ms[name] += pe[0].elapsed_time(pe[1])
                    check.hop(f"graph full {name} hop {h}", got, want, exact_ids=False)
                    forced_hops += 1
                valid += int((got[3] != 0).sum())
                beam_s, beam_i = got[0], got[1]
                vis.scatter_add_(1, got[2].long(), got[3])
            for what, x, y in (("scores", out[0], beam_s), ("ids", out[1], beam_i), ("mask", out[2], vis)):
                assert torch.equal(x, y), f"graph full {name} batch {i}: one launch and the replay differ in {what}"
            kernel_ms[name].append(ev[0].elapsed_time(ev[1]) if on_card else float("nan"))
            # each valid row read once, plus a neighbour id and a mask word
            # per candidate slot, summed over the hops; the valid rows' FMAs
            t_bytes = (valid * row_bytes + hops * b * c * 8) / HBM_BYTES_PER_S * 1e3
            t_ops = valid * 2 * row_fmas / F32_FLOPS * 1e3
            bound_ms[name].append(max(t_bytes, t_ops))
            bound_by[name] = "bytes" if t_bytes >= t_ops else "operations"
    assert forced_hops == len(paths) * hops, f"{forced_hops} hops held of {len(paths) * hops}"

    med = statistics.median
    for name, (_, _, pick, _) in paths.items():
        hms, kms = 1e3 * med(host[name]), med(kernel_ms[name])
        log(f"  graph {name}: {1e3 * min(host[name]):.3f}-{1e3 * max(host[name]):.3f} ms/batch, "
            f"median {hms:.3f} ms/batch (host clock, synchronised); traversal kernel {kms:.4f} ms/batch "
            f"(CUDA events around the one launch and the mask copy, {copy_ms:.4f} ms alone; per hop "
            f"{kms / hops:.5f} ms over {hops} hops); bound {med(bound_ms[name]):.4f} ms/batch summed over "
            f"the hops ({bound_by[name]}); plain hops of batch 0 {plain_ms[name]:.3f} ms")
        if on_card:
            busy, span_ms, kspan_ms = device_profile(torch, lambda: pipes[name].run(pick(batches[1])))
            if busy:
                total = sum(busy.values())
                log(f"    profiler, batch 1 alone: device busy {total:.3f} ms of its {span_ms:.3f} ms on "
                    f"the host clock (idle share {100 * (1 - total / span_ms):.1f}%; profiler on) and of "
                    f"its {kspan_ms:.3f} ms from first kernel start to last kernel end (idle share "
                    f"{100 * (1 - total / kspan_ms):.1f}%): "
                    + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(busy.items(), key=lambda kv: -kv[1])))
            else:
                log("    profiler: no device time recorded; idle share not measured")
    log(f"phase graph full: {len(batches)} batches of {b} per space, degree {GRAPH['degree']}, "
        f"ef {GRAPH['ef']}, {hops} hops in one launch; launches {launches}; every traversal equals its "
        f"{hops} hops replayed one launch each, bit for bit; batch 0's {forced_hops} hops agree with the "
        f"plain hop")
    return {"ms": med(kernel_ms["fused"]), "plain_ms": plain_ms["fused"] if on_card else float("nan"),
            "bound_ms": statistics.mean(bound_ms["fused"]), "bound_by": bound_by["fused"],
            "launches": launches["beam_hop"]}


def napp_full_phase(torch, dev, check, corpus, batches, space, on_card):
    """NAPP over the resident MS MARCO-scale corpus, served through the
    pipeline: the pivot index built through the fused score kernel in row
    blocks (timed), 8 batches (host clock), one profiled batch, batch 0
    against the same search with the kernel's pivot scores swapped for
    the plain version's.  Returns the index and the kernel's launches."""
    from repro_torch.core import graph_ann, napp
    from repro_torch.core.backends import CudaBackend, NappBackend, resolve_backend
    from repro_torch.core.pipeline import BruteForceGenerator, RetrievalPipeline
    from repro_torch.core.spaces import DenseSpace
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_dense as sd

    n = corpus.dense.shape[0]
    b = batches[0].dense.shape[0]
    assert type(resolve_backend("auto", space, corpus)) is CudaBackend
    if on_card:   # a dense corpus takes the kernels from "auto" on the card only
        assert type(resolve_backend("auto", DenseSpace("ip"), corpus.dense)) is CudaBackend
    backend = NappBackend(**NAPP)
    assert resolve_backend(backend, space, corpus) is backend
    pipe = RetrievalPipeline(BruteForceGenerator(space, corpus, backend=backend),
                             cand_qty=100, final_qty=10)
    blocks = -(-n // napp.NAPP_BLOCK_ROWS)
    sd.launches = 0
    t0 = time.perf_counter()
    _, index = backend._index(space, corpus, n)
    sync(torch, on_card)
    build_s = time.perf_counter() - t0
    host, results = [], []
    for q in batches:
        t0 = time.perf_counter()
        results.append(pipe.run(q))
        sync(torch, on_card)
        host.append(time.perf_counter() - t0)
    launches = sd.launches
    if on_card:
        assert launches == blocks + len(batches), f"fused_score launches {launches}, expected {blocks} + {len(batches)}"

    for q, r in zip(batches, results):
        ids = r.indices
        assert r.scores.shape == (b, 10) and bool(torch.isfinite(r.scores).all())
        assert bool(((ids >= 0) & (ids < n)).all())
        assert bool((ids.sort(dim=1).values.diff(dim=1) != 0).all()), "repeated ids"
        assert bool((r.scores.diff(dim=1) <= 0).all()), "not descending"
        rescored = graph_ann.score_many(space, q, graph_ann.gather_items(corpus, ids))
        scale = rescored.abs().amax(1, keepdim=True).clamp_min(1e-30)
        assert bool(((r.scores - rescored).abs() <= TOL_REL * scale).all()), "napp rescoring"
    # batch 0 again, the probe's pivot scores from the plain version
    kernel_score = sd.fused_score
    sd.fused_score = ref.fused_score_ref
    try:
        want = pipe.run(batches[0])
    finally:
        sd.fused_score = kernel_score
    check("fused_score", "napp batch 0 vs plain pivot scores", tuple(results[0]), tuple(want),
          exact_ids=False)
    log(f"phase napp full: pivots {NAPP['num_pivots']}, index {NAPP['num_index']}, search "
        f"{NAPP['num_search']}, min_times {NAPP['min_times']}, rerank {NAPP['rerank_qty']}; build "
        f"{build_s:.3f} s in {blocks} row blocks; {len(batches)} batches of {b}: "
        f"{1e3 * min(host):.3f}-{1e3 * max(host):.3f} ms/batch, median "
        f"{1e3 * statistics.median(host):.3f} ms/batch (host clock, synchronised); fused_score "
        f"launches {launches} ({blocks} build blocks + {len(batches)} batches); batch 0 agrees with "
        f"the plain pivot scores; auto resolves to cuda")
    if on_card:
        busy, span_ms, kspan_ms = device_profile(torch, lambda: pipe.run(batches[1]), by_kernel=True)
        if busy:
            total = sum(busy.values())
            log(f"  profiler, batch 1 alone: device busy {total:.3f} ms of its {span_ms:.3f} ms on the "
                f"host clock (idle share {100 * (1 - total / span_ms):.1f}%; profiler on) and of its "
                f"{kspan_ms:.3f} ms from first kernel start to last kernel end (idle share "
                f"{100 * (1 - total / kspan_ms):.1f}%); by kernel: "
                + "; ".join(f"{k} {v:.3f} ms" for k, v in sorted(busy.items(), key=lambda kv: -kv[1])))
        else:
            log("  profiler: no device time recorded; idle share not measured")
    return index, launches


def score_full_phase(torch, check, corpus, q, space, index, timer, reps, bound):
    """The fused score kernel on the resident corpus: at B = 16 (batch
    0's queries) against the plain version over every row, timed with the
    plain version; at B = 128 (the NAPP index's pivots, the build's
    shape) timed, held against the plain version on row slices, and the
    slices' top-``num_index`` pivots against the index's membership where
    the plain scores leave a margin at the cut."""
    from repro_torch.core import graph_ann
    from repro_torch.core.brute_force import select_topk
    from repro_torch.kernels import ops, ref

    n, d = corpus.dense.shape
    nnz, v = corpus.sparse.indices.shape[1], space.vocab_size
    w = (space.w_dense, space.w_sparse)
    tile = 1 << 16

    def args(queries):
        return (ref.query_table(queries.sparse, v), queries.dense, corpus.sparse.indices,
                corpus.sparse.values, corpus.dense)

    def work(queries):
        b = queries.dense.shape[0]
        nbytes = n * d * 4 + n * nnz * 8 + b * d * 4 + b * (v + 1) * 4 + b * n * 4
        fmas = b * n * d + sparse_fmas(torch, ref.query_table(queries.sparse, v), corpus.sparse.indices)
        return bound(nbytes, 2 * fmas + 3 * b * n)

    got = ops.fused_scores(q.sparse, q.dense, corpus.sparse, corpus.dense, v, *w)
    check.scores("fused_score", "score full b16", got, ref.fused_score_ref(*args(q), *w, tile_n=tile))
    del got
    ms16 = timer(lambda: ops.fused_scores(q.sparse, q.dense, corpus.sparse, corpus.dense, v, *w), reps)
    plain16 = timer(lambda: ref.fused_score_ref(*args(q), *w, tile_n=tile), 1)

    pivots = graph_ann.gather_items(corpus, index.pivot_ids)
    got = ops.fused_scores(pivots.sparse, pivots.dense, corpus.sparse, corpus.dense, v, *w)
    k = index.num_index
    margins = 0
    for r0 in (0, n // 2, max(0, n - 5003)):
        r1 = min(n, r0 + 16384)
        pa = args(pivots)
        want = ref.fused_score_ref(pa[0], pa[1], pa[2][r0:r1], pa[3][r0:r1], pa[4][r0:r1], *w)
        check.scores("fused_score", f"score full b128 rows {r0}:{r1}", got[:, r0:r1], want)
        vals, top = select_topk(want.T, k + 1)
        scale = want.abs().amax(0).clamp_min(1e-30)
        clear = (vals[:, k - 1] - vals[:, k]) > 2 * TOL_REL * scale
        member = torch.zeros_like(index.membership[r0:r1]).scatter_(1, top[:, :k], 1.0)
        assert torch.equal(member[clear], index.membership[r0:r1][clear]), f"membership rows {r0}:{r1}"
        margins += int(clear.sum())
    del got
    ms128 = timer(lambda: ops.fused_scores(pivots.sparse, pivots.dense, corpus.sparse, corpus.dense,
                                           v, *w), 3 if reps > 1 else 1)
    (b16, by16), (b128, by128) = work(q), work(pivots)
    log(f"phase score full: fused_score B=16 {ms16:.3f} ms vs bound {b16:.3f} ms ({by16}), plain "
        f"{plain16:.3f} ms; B=128 {ms128:.3f} ms vs bound {b128:.3f} ms ({by128}) (CUDA events, "
        f"median of {reps} / 3); [128, N] held on 3 row slices, index membership equal on "
        f"{margins} rows with a margin at the cut")
    return {"ms": ms16, "plain_ms": plain16, "bound_ms": b16, "bound_by": by16}


def skew_phase(torch, dev, corpus, q, space, timer):
    """How the index kernels depend on the term distribution: B2 at
    B = 16 (k = 100) and B4 at B = 128 (128 pivot rows as queries) over
    the first SKEW_N rows of the resident corpus, with its uniform ids and
    with Zipf-skewed ids (queries and pivots drawn from the same law).
    Timed, not gated; the hits are the queries holding a slot's term.
    Then B4's dense and sparse parts alone at B = 128 (uniform ids)."""
    from repro_torch.core import graph_ann
    from repro_torch.core.sparse import SparseVectors
    from repro_torch.core.spaces import FusedVectors
    from repro_torch.kernels import fused_topk as fk
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import sparse_dense as sd

    m = min(SKEW_N, corpus.dense.shape[0])
    v, w = space.vocab_size, (space.w_dense, space.w_sparse)
    b, nnz_q = q.sparse.indices.shape
    g = torch.Generator(device=dev).manual_seed(51)
    dense, val = corpus.dense[:m], corpus.sparse.values[:m]
    pivot_rows = torch.arange(0, m, max(1, m // 128), device=dev)[:128]
    parts = []
    for law in ("uniform", "zipf"):
        if law == "uniform":
            idx, qs = corpus.sparse.indices[:m], q.sparse
        else:
            idx = zipf_ids(torch, (m, corpus.sparse.indices.shape[1]), v, g, dev)
            qs = SparseVectors(zipf_ids(torch, (b, nnz_q), v, g, dev), q.sparse.values)
        sub = FusedVectors(dense, SparseVectors(idx, val))
        pivots = graph_ann.gather_items(sub, pivot_rows)
        table = ref.query_table(qs, v)
        ms2 = timer(lambda: fk.fused_topk(table, q.dense, idx, val, dense, 100, w_dense=w[0],
                                          w_sparse=w[1]), 3)
        ms4 = timer(lambda: ops.fused_scores(pivots.sparse, pivots.dense, sub.sparse, dense, v, *w), 3)
        hits2 = sparse_fmas(torch, table, idx) / idx.numel()
        hits4 = sparse_fmas(torch, ref.query_table(pivots.sparse, v), idx) / idx.numel()
        parts.append(f"{law}: fused_topk B={b} {ms2:.3f} ms ({hits2:.4f} queries hit a slot), "
                     f"fused_score B={pivots.dense.shape[0]} {ms4:.3f} ms ({hits4:.4f})")
        if law == "uniform":   # B4's two parts alone: 4 pad slots a row, or 4 zero dimensions
            pt = ref.query_table(pivots.sparse, v)
            pad_i = torch.full((m, 4), v, dtype=torch.int32, device=dev)
            zeros = torch.zeros((m, 4), device=dev)
            q0 = torch.zeros((pt.shape[0], 4), device=dev)
            split = (timer(lambda: sd.fused_score(pt, pivots.dense, pad_i, zeros, dense, *w), 3),
                     timer(lambda: sd.fused_score(pt, q0, idx, val, zeros, *w), 3))
    log(f"phase skew (n={m}, CUDA events, median of 3, no gate): " + "; ".join(parts)
        + f"; fused_score B=128 uniform, dense part alone {split[0]:.3f} ms, sparse part alone "
          f"{split[1]:.3f} ms")


def device_profile(torch, fn, by_kernel=False, host_ops=True):
    """One call of ``fn`` under torch.profiler.  Returns the device
    milliseconds by kernel group (the traversal kernel, the exact-scan
    kernels, the fused score kernel, the query-index build, and PyTorch's
    own; {} if the
    profiler saw no device time), or by kernel name with ``by_kernel``,
    the call's host-clock milliseconds (synchronised) and the trace's
    span from the first kernel's start to the last kernel's end, all from
    the same call.  ``host_ops=False`` records the device's activity
    alone (a train step's tens of thousands of host ops take the trace
    processing from seconds to nearly a minute)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        span_ms = 1e3 * (time.perf_counter() - t0)
    ranges = [(e.time_range.start, e.time_range.end) for e in prof.events()
              if "CUDA" in str(getattr(e, "device_type", ""))]
    kspan_ms = (max(r[1] for r in ranges) - min(r[0] for r in ranges)) / 1e3 if ranges else float("nan")
    groups = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if not us or "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        key = (e.key[:60] if by_kernel else
               "beam traversal" if "beam::hop_kernel" in e.key else
               "fused_score" if "fscore::" in e.key else
               "query index" if "topk::index_kernel" in e.key else
               "topk scan+merge" if "topk::scan_kernel" in e.key or "topk::merge_kernel" in e.key
               else "topk_large" if "large::" in e.key
               else "pytorch ops")
        groups[key] = groups.get(key, 0.0) + us / 1e3
    return groups, span_ms, kspan_ms


def graph_build(torch, dev, corpus, space, m, on_card):
    """Time one NN-descent build (degree 16, 6 rounds) over the first
    ``m`` rows of the resident corpus."""
    from repro_torch.core import graph_ann
    from repro_torch.core.sparse import SparseVectors
    from repro_torch.core.spaces import FusedVectors

    sub = FusedVectors(corpus.dense[:m], SparseVectors(corpus.sparse.indices[:m],
                                                       corpus.sparse.values[:m]))
    t0 = time.perf_counter()
    graph_ann.nn_descent(space, sub, m, degree=GRAPH["degree"], rounds=6,
                         generator=torch.Generator(dev).manual_seed(0))
    sync(torch, on_card)
    log(f"phase graph build: NN-descent over {m} fused rows (degree {GRAPH['degree']}, 6 rounds) "
        f"in {time.perf_counter() - t0:.1f} s")


def graph_recall_phase(torch, dev, n, seed, on_card):
    """An NN-descent index (6 rounds) over a planted-cluster fused corpus
    at full widths, built inside GraphANNBackend(kernel=True) and timed;
    served recall@10 against the exact cuda backend, and the plain
    traversal over the same index."""
    from repro_torch.core import graph_ann
    from repro_torch.core.backends import ANN_RECALL_TARGET, CudaBackend, GraphANNBackend
    from repro_torch.core.fusion import topk_recall
    from repro_torch.core.pipeline import BruteForceGenerator, RetrievalPipeline
    from repro_torch.core.sparse import SparseVectors
    from repro_torch.core.spaces import FusedSpace, FusedVectors
    from repro_torch.kernels import beam_topk as bk

    d, v, nnz, b = MSMARCO["d"], MSMARCO["v"], MSMARCO["nnz"], MSMARCO["b"]
    t0 = time.perf_counter()
    (cd, ci, cv), (qd, qi, qv) = planted_cluster(torch, n, d, v, nnz, MSMARCO["nnz_q"], b, seed, dev)
    corpus = FusedVectors(cd, SparseVectors(ci, cv))
    q = FusedVectors(qd, SparseVectors(qi, qv))
    space = FusedSpace(v, 0.5, 1.5)
    sync(torch, on_card)
    made = time.perf_counter() - t0
    backend = GraphANNBackend(kernel=True, **GRAPH)
    t0 = time.perf_counter()
    search_corpus, index = backend._index(space, corpus, n)
    sync(torch, on_card)
    build = time.perf_counter() - t0
    bk.launches = 0
    t0 = time.perf_counter()
    got = RetrievalPipeline(BruteForceGenerator(space, corpus, backend=backend),
                            cand_qty=GRAPH["ef"], final_qty=10).run(q)
    sync(torch, on_card)
    served = time.perf_counter() - t0
    launches = bk.launches
    exact = CudaBackend().topk(space, q, corpus, 10)
    recall = topk_recall(exact.indices, got.indices)
    plain = graph_ann.beam_search(space, q, search_corpus, index, n, k=10, ef=GRAPH["ef"])
    recall_plain = topk_recall(exact.indices, plain.indices)
    log(f"phase graph recall: n={n} d={d} v={v} nnz={nnz} planted clusters {CLUSTERS} (made in "
        f"{made:.1f} s); NN-descent build {build:.1f} s (degree {GRAPH['degree']}, 6 rounds); "
        f"served batch {1e3 * served:.3f} ms, beam_hop launches {launches}; recall@10 kernel "
        f"{recall:.4f}, plain traversal {recall_plain:.4f} (target {ANN_RECALL_TARGET})")
    assert recall >= ANN_RECALL_TARGET and recall_plain >= ANN_RECALL_TARGET, (recall, recall_plain)
    if on_card:   # one traversal launch for the batch
        assert launches == 1, launches
    return space, corpus, q, exact


def napp_recall_phase(torch, dev, space, corpus, q, exact, seed, on_card):
    """NAPP (``NAPP`` settings) over the planted-cluster corpus of "graph
    recall": recall@10 against the exact answer, gated.  Rows of a
    cluster rank by row id there, and NAPP's count ties go to the lower
    id, so the gate overstates NAPP's selectivity; the same search over a
    copy with the rows permuted by a seeded permutation is printed
    beside it, without a gate, and so is the recall of ``NAPP_DRAWS``
    pivot draws (generator seeds 0, 1, ...; seed 0 is the gated one)."""
    from repro_torch.core import napp
    from repro_torch.core.backends import ANN_RECALL_TARGET, CudaBackend, NappBackend
    from repro_torch.core.fusion import topk_recall
    from repro_torch.core.pipeline import BruteForceGenerator, RetrievalPipeline
    from repro_torch.core.spaces import map_tensors

    n = corpus.dense.shape[0]
    recalls, times = [], []
    perm = torch.randperm(n, generator=torch.Generator(dev).manual_seed(seed), device=dev)
    for corp in (corpus, map_tensors(lambda x: x[perm], corpus)):
        backend = NappBackend(**NAPP)
        t0 = time.perf_counter()
        backend._index(space, corp, n)
        sync(torch, on_card)
        times.append(time.perf_counter() - t0)
        got = RetrievalPipeline(BruteForceGenerator(space, corp, backend=backend),
                                cand_qty=100, final_qty=10).run(q)
        want = exact if corp is corpus else CudaBackend().topk(space, q, corp, 10)
        recalls.append(topk_recall(want.indices, got.indices))
    log(f"phase napp recall: n={n}, NAPP {NAPP}; build {times[0]:.3f} s; recall@10 {recalls[0]:.4f} "
        f"(target {ANN_RECALL_TARGET}); rows permuted (seed {seed}, no gate): build {times[1]:.3f} s, "
        f"recall@10 {recalls[1]:.4f}")
    draws = []
    search = {k: NAPP[k] for k in ("num_search", "min_times", "rerank_qty")}
    for seed_d in range(NAPP_DRAWS):
        index = napp.build_napp(space, corpus, n, NAPP["num_pivots"], NAPP["num_index"],
                                generator=torch.Generator(dev).manual_seed(seed_d))
        got = napp.napp_search(space, q, corpus, index, k=10, **search)
        draws.append(topk_recall(exact.indices, got.indices))
    assert draws[0] == recalls[0], (draws[0], recalls[0])
    log(f"  pivot draws 0-{NAPP_DRAWS - 1} (no gate): recall@10 min {min(draws):.4f}, median "
        f"{statistics.median(draws):.4f}, below {ANN_RECALL_TARGET} in "
        f"{sum(r < ANN_RECALL_TARGET for r in draws)} of {NAPP_DRAWS}: "
        + " ".join(f"{r:.4f}" for r in draws))
    assert recalls[0] >= ANN_RECALL_TARGET, recalls


def median_ms(xs):
    return 1e3 * statistics.median(xs)


def fusion_full_phase(torch, dev, check, corpus, card, on_card, seed):
    """Mixing weights learned on the card over the resident corpus, then
    served.  Each of FUSION_TRAIN + FUSION_HELD queries gets three planted
    rows (spread over the corpus, off make_corpus's planted rows): a
    relevant row scoring 2.5 dense and 25 sparse, a dense decoy (3, 0) and
    a sparse decoy (0, 29), so that neither part alone and not the uniform
    mix ranks the relevant row first, while a mix with w_dense / w_sparse
    between 1.6 and 50 does (no ratio the step grid reaches from the
    uniform start lies on either boundary); random rows score below 0.3
    dense and about 3 sparse.  Training: top-100 candidates per query
    through the fused scan kernel at weights (1, 1) (the relevant row put
    in the last slot if missing), each candidate's dense and sparse parts
    scored with ``score_pairs`` on the card, ``learn_fused_weights`` on the
    card and on the CPU over the same arrays (weights must be equal).
    Held out: the pipeline on the learned weights and on (1, 1), MRR@10 of
    each.  Returns the learned space and its ms/batch."""
    from repro_torch.core import fusion, segments
    from repro_torch.core.brute_force import TopK
    from repro_torch.core.pipeline import BruteForceGenerator, RetrievalPipeline
    from repro_torch.core.sparse import SparseVectors
    from repro_torch.core.spaces import DenseSpace, FusedSpace, FusedVectors, SparseSpace
    from repro_torch.kernels import fused_topk as fk
    from repro_torch.kernels import ref

    n, d = corpus.dense.shape
    v, b, nnz_q = MSMARCO["v"], MSMARCO["b"], MSMARCO["nnz_q"]
    nq = FUSION_TRAIN + FUSION_HELD
    g = torch.Generator(device=dev).manual_seed(seed)
    step = max(n // 2048, 2)          # make_corpus plants rows at multiples of this
    rows = 1 + step * torch.randperm(min(2047, (n - 2) // step), generator=g, device=dev)[:3 * nq]
    rel, dec_d, dec_s = rows.view(3, nq)
    terms = (1 + torch.randperm(v - 1, generator=g, device=dev)[:4 * nq]).view(nq, 4).int()
    u = torch.randn(nq, d, generator=g, device=dev)
    u[:, 0] = 0.0
    u /= u.norm(dim=1, keepdim=True)
    qi = torch.randint(1, v, (nq, nnz_q), generator=g, device=dev, dtype=torch.int32)
    qv = torch.rand(nq, nnz_q, generator=g, device=dev).mul_(0.1)
    qi[:, :4], qv[:, :4] = terms, 1.0
    queries = FusedVectors(u, SparseVectors(qi, qv))
    for r, dense_w, sparse_w in ((rel, 2.5, 6.25), (dec_d, 3.0, 0.0), (dec_s, 0.0, 7.25)):
        corpus.dense[r] = dense_w * u
        corpus.sparse.indices[r] = v
        corpus.sparse.values[r] = 0.0
        if sparse_w:
            corpus.sparse.indices[r, :4] = terms
            corpus.sparse.values[r, :4] = sparse_w
    batch = lambda i0: segments.take_rows(queries, torch.arange(i0, i0 + b, device=dev))

    uniform = FusedSpace(v, 1.0, 1.0)
    gen = BruteForceGenerator(uniform, corpus, backend="cuda")
    t0 = time.perf_counter()
    cands, dense_s, sparse_s = [], [], []
    for i0 in range(0, FUSION_TRAIN, b):
        q = batch(i0)
        res = gen.generate(q, 100)
        if i0 == 0:
            plain = ref.fused_topk_table_ref(ref.query_table(q.sparse, v), q.dense, corpus.sparse.indices,
                                             corpus.sparse.values, corpus.dense, 100, tile_n=1 << 16,
                                             w_dense=1.0, w_sparse=1.0)
            check("fused_topk", "fusion training candidates batch 0", tuple(res), plain, exact_ids=False)
        c = res.indices.clone()
        missing = ~(c == rel[i0:i0 + b, None]).any(1)
        c[missing, -1] = rel[i0:i0 + b][missing].int()
        docs = segments.take_rows(corpus, c.reshape(-1))
        q_rep = segments.take_rows(q, torch.arange(b, device=dev).repeat_interleave(100))
        dense_s.append(DenseSpace("ip").score_pairs(q_rep.dense, docs.dense).view(b, 100))
        sparse_s.append(SparseSpace(v).score_pairs(q_rep.sparse, docs.sparse).view(b, 100))
        cands.append(c)
    cand = torch.cat(cands)
    dense_s, sparse_s = torch.cat(dense_s), torch.cat(sparse_s)
    labels = (cand == rel[:FUSION_TRAIN, None]).float()
    valid = torch.ones_like(labels, dtype=torch.bool)
    sync(torch, on_card)
    cand_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    w_d, w_s, achieved = fusion.learn_fused_weights(dense_s, sparse_s, labels, valid)
    sync(torch, on_card)
    learn_s = time.perf_counter() - t0
    host = fusion.learn_fused_weights(dense_s.cpu(), sparse_s.cpu(), labels.cpu(), valid.cpu())
    assert (w_d, w_s) == host[:2], f"weights learned on {dev.type} {(w_d, w_s)} != on the cpu {host[:2]}"

    learned = uniform.with_weights(w_d, w_s)
    served = {}
    fk.launches = 0
    for name, space in (("learned", learned), ("uniform", uniform)):
        pipe = RetrievalPipeline(BruteForceGenerator(space, corpus, backend="cuda"), cand_qty=100,
                                 final_qty=10)
        host_s, res = [], []
        for i0 in range(FUSION_TRAIN, nq, b):
            t0 = time.perf_counter()
            res.append(pipe.run(batch(i0)))
            sync(torch, on_card)
            host_s.append(time.perf_counter() - t0)
        got = TopK(torch.cat([r.scores for r in res]), torch.cat([r.indices for r in res]))
        hit = (got.indices == rel[FUSION_TRAIN:, None]).float()
        served[name] = (float(fusion.mrr(got.scores, hit, torch.ones_like(hit, dtype=torch.bool), 10)),
                        median_ms(host_s), res[0])
    launches = fk.launches
    if on_card:
        assert launches == 2 * FUSION_HELD // b, f"fused_topk launches {launches}"
    q = batch(FUSION_TRAIN)
    for name, space in (("learned", learned), ("uniform", uniform)):
        want = ref.fused_topk_table_ref(ref.query_table(q.sparse, v), q.dense, corpus.sparse.indices,
                                        corpus.sparse.values, corpus.dense, 10, tile_n=1 << 16,
                                        w_dense=space.w_dense, w_sparse=space.w_sparse)
        check("fused_topk", f"fusion held-out batch 0 {name}", tuple(served[name][2]), want, exact_ids=False)
    (mrr_l, ms_l, _), (mrr_u, ms_u, _) = served["learned"], served["uniform"]
    log(f"phase fusion full: {FUSION_TRAIN} training queries, top-100 candidates through fused_topk at (1, 1) in "
        f"{cand_s:.3f} s; learn_fused_weights on {dev.type} {learn_s:.3f} s: w_dense {w_d!r}, w_sparse {w_s!r}, "
        f"training MRR@10 {achieved!r} (cpu: the same weights, MRR@10 {host[2]!r}); {FUSION_HELD} held-out "
        f"queries, {FUSION_HELD // b} batches of {b}: MRR@10 learned {mrr_l:.4f} vs uniform (1, 1) {mrr_u:.4f}; "
        f"{ms_l:.3f} ms/batch learned, {ms_u:.3f} uniform (host clock, synchronised); fused_topk launches "
        f"{launches}; {card}")
    assert mrr_l >= mrr_u, (mrr_l, mrr_u)
    return learned, ms_l


def live_rows(torch, n, d, v, nnz, seed, device):
    """State (b)'s inserted rows and the deletes of (b) and (c), as
    logical ids of the main segment.  Inserted: LIVE_PLANTED_INSERTS rows
    planted between make_corpus's planted rows (t = 1 + (j + 0.5) / 4096
    dense, 6 - (j + 0.5) / 512 at term 0, distinct scores above every
    random row), then random rows as make_corpus makes them.  Deleted:
    planted rows drawn at random (LIVE_PLANTED_DELETES) and random rows
    off the planted ones, every id once (so ``--n`` of 16,384 rows at the
    least)."""
    g = torch.Generator(device=device).manual_seed(seed)
    step = max(n // 2048, 1)
    planted = (torch.arange(2048, device=device) * step) % n
    m = LIVE_INSERTS
    dense = torch.randn(m, d, generator=g, device=device).mul_(1.0 / math.sqrt(d))
    dense[:, 0] = 0.0
    idx = torch.randint(1, v, (m, nnz), generator=g, device=device, dtype=torch.int32)
    val = torch.rand(m, nnz, generator=g, device=device)
    j = torch.arange(LIVE_PLANTED_INSERTS, device=device, dtype=torch.float32) * 8 + 3.5
    dense[:LIVE_PLANTED_INSERTS] = 0.0
    dense[:LIVE_PLANTED_INSERTS, 0] = 1.0 + j / 4096.0
    idx[:LIVE_PLANTED_INSERTS] = v
    val[:LIVE_PLANTED_INSERTS] = 0.0
    idx[:LIVE_PLANTED_INSERTS, 0] = 0
    val[:LIVE_PLANTED_INSERTS, 0] = 6.0 - j / 512.0
    perm = torch.randperm(2048, generator=g, device=device)
    pb, pc = LIVE_PLANTED_DELETES
    is_planted = torch.zeros(n, dtype=torch.bool, device=device)
    is_planted[planted] = True
    others = torch.randperm(n, generator=g, device=device)
    others = others[~is_planted[others]][:LIVE_DELETES + LIVE_MORE_DELETES - pb - pc]
    rb = LIVE_DELETES - pb
    dels_b = torch.cat([planted[perm[:pb]], others[:rb]])
    dels_c = torch.cat([planted[perm[pb:pb + pc]], others[rb:]])
    return (dense, idx, val), dels_b.cpu().numpy(), dels_c.cpu().numpy()


def live_full_phase(torch, dev, check, corpus, batches, space, frozen_ms, timer, card, on_card, seed):
    """Live corpora over the resident corpus: a fused one on the learned
    weights and a dense-ip one, ``backend="cuda"`` and
    ``append_backend="cuda"``, served through ``LiveGenerator`` in
    ``RetrievalPipeline`` (cand_qty 100, final_qty 10), the main path's
    planted batches at four states: (a) as built, (b) after LIVE_INSERTS
    inserts and LIVE_DELETES deletes, (c) after LIVE_MORE_DELETES more
    (the main fetch, 100 + 5000 rows, takes topk_large), (d) after
    ``compact()``.  At each state every result must equal
    ``live_topk(..., "reference", "reference")`` on the same pinned
    snapshot, ids and score bits; the append scan is held against the
    plain scan at k = 100 and k = its rows, and at (c) topk_large against
    the plain scan at the main fetch's depth.  The main fetch (k + the
    main's tombstones, through the ``cuda`` backend) is timed alone."""
    import dataclasses

    from repro_torch.core import segments
    from repro_torch.core.backends import CudaBackend
    from repro_torch.core.pipeline import RetrievalPipeline
    from repro_torch.core.sparse import SparseVectors
    from repro_torch.core.spaces import DenseSpace, FusedVectors
    from repro_torch.kernels import fused_topk as fk
    from repro_torch.kernels import mips_topk as mk
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import sparse_dense as sd
    from repro_torch.kernels import topk_large as lk
    from repro_torch.serving import LiveCorpus, LiveGenerator

    n, d = corpus.dense.shape
    v, nnz = space.vocab_size, corpus.sparse.indices.shape[1]
    (ad, ai, av), dels_b, dels_c = live_rows(torch, n, d, v, nnz, seed, dev)
    w = dict(w_dense=space.w_dense, w_sparse=space.w_sparse)
    main_fetch = LIVE_CAND + LIVE_DELETES + LIVE_MORE_DELETES
    kinds = {
        "fused": (space, corpus, FusedVectors(ad, SparseVectors(ai, av)), lambda q: q,
                  dataclasses.replace(space, tile_n=1 << 16), ("fused_topk", "topk_large", "fused_score")),
        "dense": (DenseSpace("ip"), corpus.dense, ad, lambda q: q.dense, DenseSpace("ip"),
                  ("mips_topk", "topk_large")),
    }
    counters = {"fused_topk": fk, "mips_topk": mk, "topk_large": lk, "fused_score": sd}
    expect = {   # kernels each state's batches must launch, by corpus
        "fused": {"a": ("fused_topk",), "b": ("fused_topk",), "c": ("topk_large", "fused_score", "fused_topk"),
                  "d": ("fused_topk",)},
        "dense": {"a": ("mips_topk",), "b": ("mips_topk",), "c": ("topk_large", "mips_topk"),
                  "d": ("mips_topk",)}}
    for name, (sp, corp, inserts, pick, ref_space, kernels) in kinds.items():
        t0 = time.perf_counter()
        live = LiveCorpus(sp, corp, backend="cuda", append_backend="cuda", max_append=10 ** 9, device=dev)
        init_s = time.perf_counter() - t0
        assert live.snapshot().main is corp
        pipe = RetrievalPipeline(LiveGenerator(live), cand_qty=LIVE_CAND, final_qty=10)
        parts = [f"LiveCorpus init {init_s:.3f} s"]
        for state in "abcd":
            if state == "b":
                live.insert(inserts)
                live.delete(dels_b)
            elif state == "c":
                live.delete(dels_c)
            elif state == "d":
                sync(torch, on_card)
                if on_card:
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                assert live.compact()
                sync(torch, on_card)
                parts.append(f"compact {time.perf_counter() - t0:.3f} s, peak "
                             + (f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB" if on_card else "not measured"))
            snap = live.snapshot()
            t0 = time.perf_counter()
            segments._locator(snap)
            locator_s = time.perf_counter() - t0
            for kernel in counters.values():
                kernel.launches = 0
            host, results = [], []
            for q in batches:
                t0 = time.perf_counter()
                results.append(pipe.run(pick(q)))
                sync(torch, on_card)
                host.append(time.perf_counter() - t0)
            launches = {k: counters[k].launches for k in kernels}
            assert pipe.generator.last_served_generation == snap.generation
            if on_card:
                assert all(launches[k] > 0 for k in expect[name][state]), (name, state, launches)
            for i, (q, got) in enumerate(zip(batches, results)):
                want = segments.live_topk(ref_space, snap, pick(q), LIVE_CAND, main_backend="reference",
                                          append_backend="reference")
                assert torch.equal(got.indices, want.indices[:, :10]), f"live {name} ({state}) batch {i}: ids"
                assert torch.equal(got.scores.view(torch.int32), want.scores[:, :10].view(torch.int32)), \
                    f"live {name} ({state}) batch {i}: score bits"
            q = pick(batches[0])
            if snap.n_append:
                app = snap.append
                for k in (LIVE_CAND, snap.n_append):
                    if name == "fused":
                        got = ops.fused_topk(q.sparse, q.dense, app.sparse, app.dense, v, k, **w)
                        want = ref.fused_topk_table_ref(ref.query_table(q.sparse, v), q.dense, app.sparse.indices,
                                                        app.sparse.values, app.dense, k, **w)
                    else:
                        got, want = mk.mips_topk(q, app, k), ref.mips_topk_ref(q, app, k)
                    check(kernels[0], f"live {name} ({state}) append n={snap.n_append} k={k}", tuple(got), want,
                          exact_ids=False)
            if state == "c":
                if name == "fused":
                    args = (ref.query_table(q.sparse, v), q.dense, corp.sparse.indices, corp.sparse.values,
                            corp.dense)
                    got = lk.topk_large(*args, main_fetch, **w)
                    want = ref.fused_topk_table_ref(*args, main_fetch, tile_n=1 << 16, **w)
                else:
                    got = lk.topk_large(None, q, None, None, corp, main_fetch)
                    want = ref.mips_topk_ref(q, corp, main_fetch, tile_n=1 << 18)
                check("topk_large", f"live {name} (c) main k={main_fetch}", got, want, exact_ids=False)
            k_fetch = min(snap.n_main, LIVE_CAND + int(snap.main_dead.sum()))
            fetch_ms = timer(lambda: CudaBackend().topk(sp, q, snap.main, k_fetch), 3)
            live_ms = median_ms(host)
            parts.append(f"({state}) gen {snap.generation}, main {snap.n_main} rows / {int(snap.main_dead.sum())} "
                         f"dead, append {snap.n_append}: {live_ms:.3f} ms/batch ({live_ms - frozen_ms[name]:+.3f} "
                         f"over frozen; the main fetch of {k_fetch} rows alone {fetch_ms:.3f} ms by CUDA events), "
                         f"locator {locator_s:.3f} s, launches {launches}")
        log(f"phase live full {name}: {len(batches)} batches of {batches[0].dense.shape[0]} per state, equal to "
            f"the reference live path (ids and score bits); frozen {frozen_ms[name]:.3f} ms/batch; "
            + "; ".join(parts) + f"; {card}")
        del live, pipe, results, snap
        if on_card:
            torch.cuda.empty_cache()


def live_ann_phase(torch, dev, check, space, corpus, q, card, on_card, seed):
    """A live corpus over the planted-cluster corpus of "graph recall"
    with a graph-ANN main (the kernel traversal, degree 16, ef 64; its
    index is the one "graph recall" built) and a ``cuda`` append segment.
    Churn: ANN_INSERTS new rows of the same law, each cluster's with
    weights half a step above its best rows' (so that they rank between
    them), and
    ANN_DELETES deletes, ANN_MAIN_DELETES of them each cluster's best main
    rows (the main fetch, k + main tombstones, must stay within ef) and
    the rest appended rows.  recall@10 against ``frozen_topk`` on the exact
    ``cuda`` backend, gated at ANN_RECALL_TARGET, before and after the
    background compactor (``start()``/``close()``) rebuilds the index;
    batches served while it runs must answer from their pinned snapshot."""
    from repro_torch.core import segments
    from repro_torch.core.backends import ANN_RECALL_TARGET, GraphANNBackend
    from repro_torch.core.fusion import topk_recall
    from repro_torch.core.pipeline import RetrievalPipeline
    from repro_torch.core.sparse import SparseVectors
    from repro_torch.core.spaces import FusedVectors
    from repro_torch.kernels import beam_topk as bk
    from repro_torch.kernels import fused_topk as fk
    from repro_torch.kernels import ops, ref
    from repro_torch.serving import LiveCorpus, LiveGenerator

    n = corpus.dense.shape[0]
    C, m = CLUSTERS, n // CLUSTERS
    v = space.vocab_size
    live = LiveCorpus(space, corpus, backend=GraphANNBackend(kernel=True, **GRAPH), append_backend="cuda",
                      max_append=10 ** 9, compact_interval_s=0.25, device=dev)
    pipe = RetrievalPipeline(LiveGenerator(live), cand_qty=10, final_qty=10)
    # inserts: new rows of the planted-cluster law (fresh noise and terms),
    # row r in cluster r % C with the weight of main row r, half a step up
    (rd, ri, rv), _ = planted_cluster(torch, ANN_INSERTS, corpus.dense.shape[1], v,
                                      corpus.sparse.indices.shape[1], MSMARCO["nnz_q"], C, seed, dev)
    r = torch.arange(ANN_INSERTS, device=dev)
    t = 2.0 - (r // C).float() / m + 0.5 / m
    rd[r, r % C] = t
    rv[:, 0] = t
    new_ids = live.insert(FusedVectors(rd, SparseVectors(ri, rv)))
    main_dels = (torch.arange(ANN_MAIN_DELETES // C, device=dev)[:, None] * C
                 + torch.arange(C, device=dev)[None, :]).reshape(-1).cpu().numpy()
    live.delete(np.concatenate([main_dels, new_ids[1::2][:ANN_DELETES - ANN_MAIN_DELETES]]))

    def recall(label):
        snap = live.snapshot()
        want = segments.frozen_topk(space, *segments.materialize(snap), q, 10, backend="cuda")
        bk.launches = fk.launches = 0
        t0 = time.perf_counter()
        got = pipe.run(q)
        sync(torch, on_card)
        ms = 1e3 * (time.perf_counter() - t0)
        launches = {"beam_hop": bk.launches, "fused_topk": fk.launches}
        r = topk_recall(want.indices, got.indices)
        if on_card:
            assert launches["beam_hop"] == 1 and launches["fused_topk"] >= 1, launches
        assert r >= ANN_RECALL_TARGET, (label, r)
        return snap, want, f"{label}: gen {snap.generation}, main {snap.n_main} / {int(snap.main_dead.sum())} " \
                           f"dead, append {snap.n_append} / {int(snap.append_dead.sum())} dead: recall@10 {r:.4f}, " \
                           f"{ms:.3f} ms, launches {launches}"

    snap, want_pre, before = recall("before compaction")
    k_app = min(snap.n_append, 10 + int(snap.append_dead.sum()))
    app = snap.append
    check("fused_topk", f"live ann append n={snap.n_append} k={k_app}",
          tuple(ops.fused_topk(q.sparse, q.dense, app.sparse, app.dense, v, k_app, w_dense=space.w_dense,
                               w_sparse=space.w_sparse)),
          ref.fused_topk_table_ref(ref.query_table(q.sparse, v), q.dense, app.sparse.indices, app.sparse.values,
                                   app.dense, k_app, w_dense=space.w_dense, w_sparse=space.w_sparse),
          exact_ids=False)
    gen0 = live.generation
    live.start()
    during = 0
    t_wait = time.perf_counter()
    while live.live_stats()["compactions"] == 0:
        assert time.perf_counter() - t_wait < 600, "the background compaction did not finish in 600 s"
        got = pipe.run(q)
        if pipe.generator.last_served_generation == gen0:
            during += 1
            assert topk_recall(want_pre.indices, got.indices) >= ANN_RECALL_TARGET
        time.sleep(0.05)
    live.close()
    rebuild_s = live.live_stats()["compaction_s"][0]
    _, _, after = recall("after compaction")
    log(f"phase live ann: n={n}, graph ANN main (kernel, degree {GRAPH['degree']}, ef {GRAPH['ef']}) + cuda "
        f"append; churn {ANN_INSERTS} inserts, {ANN_DELETES} deletes ({ANN_MAIN_DELETES} in the main); "
        f"{before}; background compaction (materialize + NN-descent rebuild + swap) {rebuild_s:.3f} s, "
        f"{during} batches served from the pinned snapshot meanwhile; {after} (target {ANN_RECALL_TARGET}); "
        f"{card}")


def offline_rows(torch, run, items, tokens, dev, b):
    """Each request's row of ``run`` over the submission order cut into
    batches of ``b`` (stacked as the batcher stacks them), as numpy
    (``items`` is a multiple of ``b`` long)."""
    from repro_torch.core.spaces import map_tensors
    from repro_torch.serving.batcher import stack_requests

    rows = []
    for lo in range(0, len(items), b):
        q = map_tensors(lambda t: t.to(dev), stack_requests(items[lo:lo + b]))
        out = run(q) if tokens is None else run(q, stack_requests(tokens[lo:lo + b]).to(dev))
        s, i = out[0].float().cpu().numpy(), out[1].cpu().numpy()   # bf16 scores widened, as served
        rows += [(s[r], i[r]) for r in range(b)]
    return rows


def same_row(got, want):
    """A served answer (scores, ids) equal to an offline row in ids and
    score bits."""
    return (np.array_equal(got[1], want[1])
            and np.array_equal(np.asarray(got[0]).view(np.int32), want[0].view(np.int32)))


def flood(svc, name, items, tokens, clients):
    """``clients`` threads submit ``items`` (thread c every c-th one) as fast
    as admission lets them, then wait for their answers.  Returns the
    answers in submission order and the pass's host seconds; a request
    that fails raises here."""
    import threading

    results, errors = [None] * len(items), []

    def client(c):
        try:
            futs = [(i, svc.submit(items[i], None if tokens is None else tokens[i], name))
                    for i in range(c, len(items), clients)]
            for i, f in futs:
                results[i] = f.result(timeout=600)
        except Exception as exc:          # noqa: BLE001 -- re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return results, wall


def serve_split(torch, pipe, pad, spec, items, clients, counted):
    """Where a cache-on flood's host time goes ("serve split"): the fused
    endpoint flooded with ``items`` on a fresh service under each variant
    of SPLIT_VARIANTS (cache on or off; before each submit, the clients
    computing ``quantized_key`` themselves, on the query or on numpy
    copies of it made beforehand, or making only the key's PyTorch calls
    (``detach().cpu().numpy()`` of each leaf), or spinning in Python for
    as long as one key takes alone; 1 or ``clients`` clients; the
    interpreter's switch interval).  Timed on the host clock by wrapping
    the batcher's methods: per batch, the stacking and copy to the card
    (assemble), the pipeline's launches (run), the copy back (host copy)
    and the rest of the batch (fan-out to the futures and the cache); per
    request, the clients' key and the cache's get and put (each a call
    under the cache's lock).  ``counted(label, batches)`` checks each
    flood's launches.  Returns one line."""
    from repro_torch.core.spaces import map_tensors, tensor_leaves
    from repro_torch.serving import RetrievalService
    from repro_torch.serving import batcher as bm
    from repro_torch.serving.cache import quantized_key

    def timed(fn, into):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                into.append(time.perf_counter() - t0)
        return wrapper

    as_numpy = {id(q): map_tensors(lambda t: t.numpy(), q) for q in items}
    key_s = [0.0]

    def spin():
        end = time.perf_counter() + key_s[0]
        while time.perf_counter() < end:
            pass

    works = {"key": lambda q: quantized_key("fused", (q, None)),
             "key on numpy": lambda q: quantized_key("fused", (as_numpy[id(q)], None)),
             "torch calls": lambda q: [leaf.detach().cpu().numpy() for leaf in tensor_leaves(q)],
             "spin": lambda q: spin()}
    alone = {}
    for name, work in works.items():   # one thread, nothing else running
        t0 = time.perf_counter()
        for q in items:
            work(q)
        alone[name] = (time.perf_counter() - t0) / len(items)
        if name == "key":
            key_s[0] = alone[name]
    host_fn, switch0 = bm._host, sys.getswitchinterval()
    parts = ["client work alone, us a request: " + ", ".join(f"{k} {1e6 * v:.1f}" for k, v in alone.items())]
    for label, cache_size, client_work, n_clients, switch_s in SPLIT_VARIANTS:
        t = {k: [] for k in ("execute", "assemble", "run", "host", "key", "get", "put")}
        bm._host = timed(host_fn, t["host"])
        try:
            with RetrievalService(cache_size=cache_size) as svc:
                svc.register_pipeline("fused", pipe, pad, spec=spec)
                bt = svc.router.resolve("fused")
                bt._execute = timed(bt._execute, t["execute"])
                bt._assemble = timed(bt._assemble, t["assemble"])
                bt.run_fn = timed(bt.run_fn, t["run"])
                if svc.cache is not None:
                    for name in ("key", "get", "put"):
                        setattr(svc.cache, name, timed(getattr(svc.cache, name), t[name]))
                if client_work is not None:
                    work = timed(works[client_work], t["key"])
                    submit = svc.submit
                    svc.submit = lambda q, tokens, name: (work(q), submit(q, tokens, name))[1]
                sys.setswitchinterval(switch_s or switch0)
                _, wall = flood(svc, "fused", items, None, n_clients)
                sys.setswitchinterval(switch0)
                ep = svc.snapshot().endpoints["fused"]
                counted(label, ep.n_batches)
        finally:
            bm._host = host_fn
            sys.setswitchinterval(switch0)
        nb = ep.n_batches
        per = {k: 1e3 * sum(v) / nb for k, v in t.items() if k in ("execute", "assemble", "run", "host")}
        rest = per["execute"] - per["assemble"] - per["run"] - per["host"]
        us = {k: (f"{1e6 * statistics.median(v):.1f} / {1e6 * max(v):.1f}" if v else "-")
              for k, v in t.items() if k in ("key", "get", "put")}
        parts.append(f"{label}: {len(items) / wall:.1f} qps, exec {per['execute']:.3f} ms a batch = assemble "
                     f"{per['assemble']:.3f} + run {per['run']:.3f} + host copy {per['host']:.3f} + rest "
                     f"{rest:.3f} (means of {nb} batches); per request median / max us: client work {us['key']}, "
                     f"cache get {us['get']}, put {us['put']}")
    return "; ".join(parts)


def serve_churn(torch, dev, dense, seed, counted):
    """Upserts racing a flood ("serve churn"): a ``LiveCorpus`` over the
    dense part (``cuda`` main and append) behind a cached endpoint, and a
    writer thread that upserts CHURN_UPSERT fresh ids every CHURN_PERIOD_S
    while SERVE_CLIENTS clients flood it with SERVE_QUERIES host queries;
    each upsert's rows are twins (2x) of the next queries in turn, so that
    their answers change with the generation.  Every upsert replaces the
    append segment and frees the one before, which batches still queued
    on the worker's stream may be reading.  The served generation of each
    answer is the one the cache stored it under (looked up between its
    submit and its completion); the upserts are replayed on a second
    ``LiveCorpus`` and every answer held against ``live_topk(...,
    "reference", "reference")`` on the snapshot of that generation, ids
    and score bits.  Returns one line."""
    import threading

    from repro_torch.core import segments
    from repro_torch.core.spaces import DenseSpace
    from repro_torch.serving import EndpointSpec, LiveCorpus, RetrievalService
    from repro_torch.serving.batcher import stack_requests

    n, d = dense.shape
    b = MSMARCO["b"]
    sp = DenseSpace("ip")
    g = torch.Generator().manual_seed(seed)
    items = list(torch.randn(SERVE_QUERIES, d, generator=g).mul_(1.0 / math.sqrt(d)))
    twins = torch.stack(items) * 2.0

    def upsert_args(t):
        j = (np.arange(CHURN_UPSERT) + CHURN_UPSERT * t) % len(items)
        return n + CHURN_UPSERT * t + np.arange(CHURN_UPSERT), twins[j]

    live = LiveCorpus(sp, dense, backend="cuda", append_backend="cuda", max_append=10 ** 9, device=dev)
    spec = EndpointSpec(batch_size=b, max_wait_s=0.01, max_queue=128, overload="block", live=live)
    gens = [None] * len(items)
    done, n_upserts = threading.Event(), [0]

    def writer():
        while not done.is_set():
            ids, rows = upsert_args(n_upserts[0])
            live.upsert(ids, rows.to(dev))
            n_upserts[0] += 1
            time.sleep(CHURN_PERIOD_S)

    with RetrievalService(cache_size=4096) as svc:
        svc.register_pipeline("churn", None, torch.zeros(d, device=dev), spec=spec)
        submit = svc.submit

        def stamped(q, tokens, name):
            i = next(k for k, x in enumerate(items) if x is q)
            g0 = live.generation
            fut = submit(q, tokens, name)
            fut.add_done_callback(lambda f: gens.__setitem__(i, (g0, live.generation)))
            return fut

        svc.submit = stamped
        w = threading.Thread(target=writer)
        w.start()
        try:
            got, wall = flood(svc, "churn", items, None, SERVE_CLIENTS)
        finally:
            done.set()
            w.join()
        snap = svc.snapshot()
        ep = snap.endpoints["churn"]
        assert snap.cache_hits == 0
        counted("serve churn", ep.n_batches)
        bt = svc.router.resolve("churn")
        served = []
        for i, (g0, g1) in enumerate(gens):
            hit = [gen for gen in range(g0, g1 + 1)
                   if svc.cache.get(svc.cache.key("churn", (items[i], None), backend=bt.backend,
                                                  corpus_dtype=bt.corpus_dtype, generation=gen)) is not None]
            assert len(hit) == 1, f"serve churn request {i}: stored under generations {hit} of [{g0}, {g1}]"
            served.append(hit[0])
    live.close()
    del live
    # replay the upserts and hold each answer at the generation it was served
    replay = LiveCorpus(sp, dense, backend="cuda", append_backend="cuda", max_append=10 ** 9, device=dev)
    by_gen = {}
    for i, gen in enumerate(served):
        by_gen.setdefault(gen, []).append(i)
    changed = 0
    for gen in range(max(served) + 1):
        if gen:
            ids, rows = upsert_args(gen - 1)
            replay.upsert(ids, rows.to(dev))
        assert replay.generation == gen
        snap = replay.snapshot()
        todo = by_gen.get(gen, [])
        for lo in range(0, len(todo), b):
            part = todo[lo:lo + b]
            q = stack_requests([items[i] for i in part] + [torch.zeros(d)] * (b - len(part))).to(dev)
            want = segments.live_topk(sp, snap, q, LIVE_CAND, main_backend="reference", append_backend="reference")
            ws, wi = want.scores[:, :10].cpu().numpy(), want.indices[:, :10].cpu().numpy()
            for r, i in enumerate(part):
                assert same_row(got[i], (ws[r], wi[r])), \
                    f"serve churn request {i} (generation {gen}): differs from the plain live path"
                changed += int(wi[r][0] >= n)
    del replay
    return (f"{n_upserts[0]} upserts of {CHURN_UPSERT} ids (one every {1e3 * CHURN_PERIOD_S:.0f} ms) during a "
            f"flood of {len(items)} by {SERVE_CLIENTS} clients, {len(items) / wall:.1f} qps, {ep.n_batches} "
            f"batches over generations {min(served)}-{max(served)} ({len(by_gen)} distinct); every answer equal "
            f"to the plain live path on the snapshot of its generation (ids and score bits), {changed} of them "
            f"topped by an upserted twin")


class DenseRescore:
    """The served funnel's rerank stage in "serve full": the fused top-100
    rescored on the dense part alone through ``DenseSpace.score_pairs``
    (the query tokens are the queries' dense parts), the best ``keep``
    kept in ``lax.top_k``'s order."""

    def __init__(self, torch, dense):
        from repro_torch.core.spaces import DenseSpace

        self.torch, self.dense, self.space = torch, dense, DenseSpace("ip")

    def rerank(self, q_tokens, cands, keep):
        from repro_torch.core.brute_force import TopK, select_topk

        b, k = cands.indices.shape
        docs = self.dense[cands.indices.reshape(-1).long()]
        scores = self.space.score_pairs(q_tokens.repeat_interleave(k, dim=0), docs).reshape(b, k)
        vals, pos = select_topk(scores, keep)
        return TopK(vals, self.torch.gather(cands.indices, 1, pos))


class PreRerankClock:
    """A funnel pipeline that records, for each batch it runs, the seconds
    spent before its rerank decision (the queue's wait plus the candidate
    stage) and whether the rerank was skipped; a budget rebind keeps the
    record."""

    def __init__(self, funnel, record=None):
        self.funnel = funnel
        self.record = [] if record is None else record

    def __getattr__(self, name):
        return getattr(self.__dict__["funnel"], name)

    def with_budget(self, budget):
        return PreRerankClock(self.funnel.with_budget(budget), self.record)

    def run_timed(self, query_repr, q_tokens=None, *, elapsed_s=0.0):
        out, trace = self.funnel.run_timed(query_repr, q_tokens, elapsed_s=elapsed_s)
        self.record.append((elapsed_s + trace.candgen_s + (trace.fusion_s or 0.0), trace.fallback))
        return out, trace


def serve_full_phase(torch, dev, check, corpus, space, card, on_card, seed):
    """The served main path: one ``RetrievalService(cache_size=4096)`` on
    the resident corpus with six endpoints, each registered through
    ``EndpointSpec(batch_size=16, max_wait_s=0.01, max_queue=128,
    overload="block")``: "fused" and "dense" (cand_qty 100, final_qty 10,
    the ``cuda`` backend: B2, B1), "dense_deep" (cand_qty 4096:
    ``topk_large``), "fused_sharded" (SERVE_SHARDS row shards that are
    views of the corpus: B2 per shard), "fused_funnel" (the fused
    candidates, then ``DenseRescore`` under a ``StageBudget`` whose
    end-to-end deadline skips the rerank once queueing eats the budget)
    and "dense_live" (a ``LiveCorpus`` over the dense part, one upsert of
    SERVE_UPSERT ids between its two passes).  Queries are host tensors
    from the main path's generator, SERVE_QUERIES distinct ones an
    endpoint (SERVE_DEEP_QUERIES for dense_deep).  Each endpoint alone:
    a flood pass (SERVE_CLIENTS client threads, profiled on the card for
    the device's idle share) and a replay pass of the same queries (from
    the cache, except dense_live after its upsert).  Then every endpoint
    at once, SERVE_ALL_PASSES times, each pass on a fresh service without a
    cache.  Every answer is held to
    the offline run of its batch of 16 (ids and score bits; the funnel's
    to its full or its degraded answer), and the launches of every pass
    to its batches.  Shapes only the served path gives: fused_sharded's
    batch 0 against the plain fused scan of the whole corpus and the last
    shard's B2 against its plain version; after the upsert, dense_live's
    answers against the plain live path on the pinned snapshot (ids and
    score bits) and B1 against its plain version at the main fetch's
    depth (100 + the tombstones) and over the append segment.  Then "serve
    split" (``serve_split``) and "serve churn" (``serve_churn``).  Last,
    the ``launch/serve.py`` shim over a ``cuda`` runner.  Returns the
    launches of all these passes by kernel."""
    import dataclasses
    import threading
    import warnings

    from repro_torch.core import segments
    from repro_torch.core.pipeline import BruteForceGenerator, RetrievalPipeline
    from repro_torch.core.sparse import SparseVectors
    from repro_torch.core.spaces import DenseSpace, FusedVectors, map_tensors, tensor_leaves
    from repro_torch.kernels import fused_topk as fk
    from repro_torch.kernels import mips_topk as mk
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as plain
    from repro_torch.kernels import topk_large as lk
    from repro_torch.launch.serve import BatchingServer
    from repro_torch.serving import (EndpointSpec, FunnelPipeline, LiveCorpus, LiveGenerator,
                                     RetrievalService, ShardedPipeline, StageBudget)
    from repro_torch.serving.batcher import stack_requests

    t_phase = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    d = corpus.dense.shape[1]
    v, b, nnz_q = space.vocab_size, MSMARCO["b"], MSMARCO["nnz_q"]
    dense = corpus.dense
    counters = {"mips_topk": mk, "fused_topk": fk, "topk_large": lk}
    total = dict.fromkeys(counters, 0)

    def launches():
        return {k: m.launches for k, m in counters.items()}

    def reset():
        for m in counters.values():
            m.launches = 0

    def host_queries(count, base):
        rows = []
        for c in range(count // b):
            qd, qi, qv = (t.cpu() for t in make_queries(torch, b, d, v, nnz_q, base + c, dev,
                                                        planted=False))
            rows += [FusedVectors(qd[i], SparseVectors(qi[i], qv[i])) for i in range(b)]
        return rows

    fused_pad = FusedVectors(torch.zeros(d, device=dev), SparseVectors(
        torch.full((nnz_q,), v, dtype=torch.int32, device=dev), torch.zeros(nnz_q, device=dev)))
    dense_pad = torch.zeros(d, device=dev)
    pipe_f = RetrievalPipeline(BruteForceGenerator(space, corpus, backend="cuda"), cand_qty=100, final_qty=10)
    pipe_d = RetrievalPipeline(BruteForceGenerator(DenseSpace("ip"), dense, backend="cuda"),
                               cand_qty=100, final_qty=10)
    pipe_deep = RetrievalPipeline(BruteForceGenerator(DenseSpace("ip"), dense, backend="cuda"),
                                  cand_qty=DEEP_K, final_qty=10)
    sharded = ShardedPipeline.from_corpus(space, corpus, SERVE_SHARDS, backend="cuda", cand_qty=100,
                                          final_qty=10)
    for s in sharded.shards:    # views of the resident corpus, not copies
        for whole, part in zip(tensor_leaves(corpus), tensor_leaves(s.corpus)):
            assert part.data_ptr() == whole.data_ptr() + s.offset * whole.stride(0) * whole.element_size()
    funnel = FunnelPipeline(BruteForceGenerator(space, corpus, backend="cuda"),
                            rerank=DenseRescore(torch, dense), cand_qty=100, fusion_qty=100, rerank_keep=10)
    live = LiveCorpus(DenseSpace("ip"), dense, backend="cuda", append_backend="cuda", max_append=10 ** 9,
                      device=dev)
    assert live.snapshot().main is dense

    funnel_q = host_queries(SERVE_QUERIES, seed + 4000)
    queries = {
        "fused": (host_queries(SERVE_QUERIES, seed), None),
        "dense": ([r.dense for r in host_queries(SERVE_QUERIES, seed + 1000)], None),
        "dense_deep": ([r.dense for r in host_queries(SERVE_DEEP_QUERIES, seed + 2000)], None),
        "fused_sharded": (host_queries(SERVE_QUERIES, seed + 3000), None),
        "fused_funnel": (funnel_q, [r.dense for r in funnel_q]),
        "dense_live": ([r.dense for r in host_queries(SERVE_QUERIES, seed + 5000)], None),
    }

    # offline references, each batch of 16 run once
    sync(torch, on_card)
    t0 = time.perf_counter()
    ref = {"fused": offline_rows(torch, pipe_f.run, queries["fused"][0], None, dev, b)}
    sync(torch, on_card)
    fused_batch_s = (time.perf_counter() - t0) / (SERVE_QUERIES // b)
    ref["dense"] = offline_rows(torch, pipe_d.run, queries["dense"][0], None, dev, b)
    ref["dense_deep"] = offline_rows(torch, pipe_deep.run, queries["dense_deep"][0], None, dev, b)
    ref["fused_sharded"] = offline_rows(torch, sharded.run, queries["fused_sharded"][0], None, dev, b)
    flat = offline_rows(torch, pipe_f.run, queries["fused_sharded"][0], None, dev, b)
    assert all(np.array_equal(s[1], f[1]) for s, f in zip(ref["fused_sharded"], flat)), \
        "fused_sharded ids differ from the unsharded fused answer"
    # the sharded answer and a shard's B2 against the plain fused scan
    w = dict(w_dense=space.w_dense, w_sparse=space.w_sparse)
    q0 = map_tensors(lambda t: t.to(dev), stack_requests(queries["fused_sharded"][0][:b]))
    table = plain.query_table(q0.sparse, v)
    got = tuple(torch.from_numpy(np.stack([r[j] for r in ref["fused_sharded"][:b]])) for j in (0, 1))
    check("fused_topk", f"serve fused_sharded batch 0 ({SERVE_SHARDS} shards) against the whole corpus", got,
          plain.fused_topk_table_ref(table, q0.dense, corpus.sparse.indices, corpus.sparse.values, corpus.dense,
                                     10, tile_n=1 << 16, **w), exact_ids=False)
    last = sharded.shards[-1]
    check("fused_topk", f"serve shard of {last.n_rows} rows at row {last.offset}",
          tuple(ops.fused_topk(q0.sparse, q0.dense, last.corpus.sparse, last.corpus.dense, v, 100, **w)),
          plain.fused_topk_table_ref(table, q0.dense, last.corpus.sparse.indices, last.corpus.sparse.values,
                                     last.corpus.dense, 100, tile_n=1 << 16, **w), exact_ids=False)
    full = offline_rows(torch, funnel.run, funnel_q, queries["fused_funnel"][1], dev, b)
    degraded = offline_rows(torch, pipe_f.run, funnel_q, None, dev, b)
    ref["fused_funnel"] = full
    live_pipe = RetrievalPipeline(LiveGenerator(live))
    ref["dense_live"] = offline_rows(torch, live_pipe.run, queries["dense_live"][0], None, dev, b)

    def hold_live(items):
        """dense_live's offline rows against the plain live path on the
        pinned snapshot, ids and score bits; B1 against its plain version
        at the depths the snapshot's segments are fetched at."""
        snap = live.snapshot()
        assert live_pipe.generator.last_served_generation == snap.generation
        for lo in range(0, len(items), b):
            want = segments.live_topk(DenseSpace("ip"), snap, stack_requests(items[lo:lo + b]).to(dev), LIVE_CAND,
                                      main_backend="reference", append_backend="reference")
            ws, wi = want.scores[:, :10].cpu().numpy(), want.indices[:, :10].cpu().numpy()
            for r in range(b):
                assert same_row(ref["dense_live"][lo + r], (ws[r], wi[r])), \
                    f"serve dense_live request {lo + r}: differs from the plain live path"
        q = stack_requests(items[:b]).to(dev)
        for seg, n_dead, what in ((snap.main, int(snap.main_dead.sum()), "main"),
                                  (snap.append, int(snap.append_dead.sum()), "append")):
            k = min(seg.shape[0], LIVE_CAND + n_dead)
            check("mips_topk", f"serve dense_live {what} n={seg.shape[0]} k={k}", tuple(mk.mips_topk(q, seg, k)),
                  plain.mips_topk_ref(q, seg, k, tile_n=1 << 18), exact_ids=False)
        return snap

    def check_rows(name, got):
        for i, row in enumerate(got):
            if name == "fused_funnel":
                assert same_row(row, full[i]) or same_row(row, degraded[i]), \
                    f"serve full {name} request {i}: neither the full nor the degraded offline answer"
            else:
                assert same_row(row, ref[name][i]), f"serve full {name} request {i}: differs from its offline batch"

    per_batch = {"fused": ("fused_topk", 1), "dense": ("mips_topk", 1), "dense_deep": ("topk_large", 2),
                 "fused_sharded": ("fused_topk", SERVE_SHARDS), "fused_funnel": ("fused_topk", 1),
                 "dense_live": ("mips_topk", 1)}

    def check_launches(what, got, batches_by_name):
        want = dict.fromkeys(counters, 0)
        for name, batches in batches_by_name.items():
            kernel, per = per_batch[name]
            want[kernel] += per * batches
        if on_card:
            assert got == want, f"serve full {what}: launches {got}, expected {want} for {batches_by_name} batches"
        for k, c in got.items():
            total[k] += c

    spec = EndpointSpec(batch_size=b, max_wait_s=0.01, max_queue=128, overload="block")
    budget = StageBudget(total_s=SERVE_FUNNEL_BATCHES * fused_batch_s)
    clocked = PreRerankClock(funnel)
    pipelines = {"fused": (pipe_f, fused_pad, None, spec), "dense": (pipe_d, dense_pad, None, spec),
                 "dense_deep": (pipe_deep, dense_pad, None, spec),
                 "fused_sharded": (sharded, fused_pad, None, spec),
                 "fused_funnel": (clocked, fused_pad, dense_pad, dataclasses.replace(spec, budget=budget)),
                 "dense_live": (None, dense_pad, None, dataclasses.replace(spec, live=live))}

    def register_all(svc):
        for name, (pipe, pad, pad_tokens, sp) in pipelines.items():
            svc.register_pipeline(name, pipe, pad, pad_tokens, spec=sp)

    def profiled_flood(svc, name):
        """A flood of ``name``'s queries, under the profiler on the card:
        (answers, host seconds, the device's idle share of the pass)."""
        box = {}

        def run():
            box["out"] = flood(svc, name, *queries[name], SERVE_CLIENTS)

        idle = "not measured"
        if on_card:
            groups, span_ms, _ = device_profile(torch, run)
            if groups:
                idle = f"{max(0.0, 1.0 - sum(groups.values()) / span_ms):.3f}"
        else:
            run()
        return (*box["out"], idle)

    def line(name, ep, n_req, wall, idle):
        return (f"{name}: exec {ep.execute.p50_ms:.3f} ms/batch (p50), {n_req / wall:.1f} qps, e2e p50 "
                f"{ep.e2e.p50_ms:.3f} ms p99 {ep.e2e.p99_ms:.3f} ms, {ep.n_batches} batches, fill "
                f"{ep.mean_batch_fill:.3f} (size {ep.closed_by_size} / deadline {ep.closed_by_deadline}), "
                f"idle {idle}")

    parts = []
    with RetrievalService(cache_size=4096) as svc:
        register_all(svc)
        for name, (items, tokens) in queries.items():
            svc.reset_stats()
            reset()
            clocked.record.clear()
            got, wall, idle = profiled_flood(svc, name)
            snap = svc.snapshot()
            ep = snap.endpoints[name]
            check_launches(name, launches(), {name: ep.n_batches})
            check_rows(name, got)
            assert snap.cache_misses == len(items) and ep.n_requests == len(items)
            extra = ""
            if name == "fused_funnel":
                runs = ep.stages["rerank"].count if "rerank" in ep.stages else 0
                fallbacks = ep.stage_fallbacks["rerank"]
                only_degraded = sum(same_row(r, degraded[i]) and not same_row(r, full[i])
                                    for i, r in enumerate(got))
                assert runs >= 1 and fallbacks >= 1, f"funnel budget: {runs} reranks, {fallbacks} fallbacks"
                assert runs + fallbacks == ep.n_batches and only_degraded <= b * fallbacks
                ran = [1e3 * t for t, skipped in clocked.record if not skipped]
                skipped = [1e3 * t for t, skipped in clocked.record if skipped]
                extra = (f", rerank run in {runs} batches and skipped in {fallbacks} (e2e budget "
                         f"{1e3 * budget.total_s:.1f} ms = {SERVE_FUNNEL_BATCHES} offline batches of "
                         f"{1e3 * fused_batch_s:.1f} ms), {only_degraded} degraded answers; time before the "
                         f"rerank decision (queue wait + candidates): first batch "
                         f"{1e3 * clocked.record[0][0]:.1f} ms, batches that reranked at most {max(ran):.1f} ms, "
                         f"skipped ones at least {min(skipped):.1f} ms")
            if name == "dense_live":   # one upsert between the passes
                before = got
                ids = np.unique(np.array([r[1][0] for r in got]))[:SERVE_UPSERT]
                assert len(ids) == SERVE_UPSERT
                live.upsert(ids, torch.zeros(SERVE_UPSERT, d, device=dev))
                ref["dense_live"] = offline_rows(torch, live_pipe.run, items, None, dev, b)
                live_snap = hold_live(items)
                per_batch["dense_live"] = ("mips_topk", 2)   # main and append segments
            svc.reset_stats()
            reset()
            again, _ = flood(svc, name, items, tokens, SERVE_CLIENTS)
            snap2 = svc.snapshot()
            ep2 = snap2.endpoints[name]
            check_launches(name, launches(), {name: ep2.n_batches})
            check_rows(name, again)
            if name == "dense_live":
                assert snap2.cache_hits == 0, "dense_live served a cached answer of the old generation"
                changed = sum(not np.array_equal(a[1], o[1]) for a, o in zip(again, before))
                assert changed >= 1, "the upsert changed no answer"
                extra = (f", upsert of {SERVE_UPSERT} ids changed {changed} answers, generation {ep2.generation}, "
                         f"main fetch k = {LIVE_CAND + int(live_snap.main_dead.sum())}, every answer equal to the "
                         f"plain live path")
            else:
                assert snap2.cache_hits == len(items) and ep2.n_batches == 0
            parts.append(line(name, ep, len(items), wall, idle)
                         + f"; replay hit rate {snap2.cache_hit_rate:.3f}{extra}")
    log(f"phase serve full: {SERVE_CLIENTS} clients an endpoint, each endpoint alone, host clock (the flood "
        f"under the profiler); " + "; ".join(parts) + f"; {card}")

    # without the cache: the fused endpoint alone (its clients hash no keys),
    # then every endpoint at once, answers and launches under concurrency,
    # SERVE_ALL_PASSES times (a race between streams need not show in one)
    with RetrievalService(cache_size=0) as svc:
        register_all(svc)
        reset()
        got, wall, idle = profiled_flood(svc, "fused")
        ep = svc.snapshot().endpoints["fused"]
        check_rows("fused", got)
        check_launches("fused without the cache", launches(), {"fused": ep.n_batches})
        log(f"phase serve nocache: the fused endpoint alone, no cache, {SERVE_CLIENTS} clients: "
            + line("fused", ep, len(got), wall, idle) + f"; {card}")
    walls = []
    for _ in range(SERVE_ALL_PASSES):
        outs, errors = {}, []
        with RetrievalService(cache_size=0) as svc:
            register_all(svc)
            reset()
            t0 = time.perf_counter()

            def endpoint(name):
                try:
                    outs[name] = flood(svc, name, *queries[name], SERVE_CLIENTS)[0]
                except Exception as exc:      # noqa: BLE001 -- re-raised below
                    errors.append(exc)

            threads = [threading.Thread(target=endpoint, args=(name,)) for name in queries]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                raise errors[0]
            walls.append(time.perf_counter() - t0)
            snap = svc.snapshot()
        for name in queries:
            check_rows(name, outs[name])
        check_launches("all endpoints", launches(), {name: ep.n_batches for name, ep in snap.endpoints.items()})
    n_req = sum(len(q[0]) for q in queries.values())
    log(f"phase serve all: {len(queries)} endpoints at once, {n_req} requests a pass, {SERVE_ALL_PASSES} passes in "
        + ", ".join(f"{w:.3f}" for w in walls) + f" s ({n_req / statistics.median(walls):.1f} qps, median), every "
        f"answer equal to its offline batch, launches equal to the batches served; the last pass: funnel "
        f"fallbacks {snap.endpoints['fused_funnel'].stage_fallbacks['rerank']}, "
        + ", ".join(f"{name} e2e p99 {ep.e2e.p99_ms:.3f} ms" for name, ep in snap.endpoints.items())
        + f"; {card}")

    def tally(label, batches, kernel, lo, hi):
        """A pass's launches: only ``kernel``, ``lo`` to ``hi`` a batch."""
        got = launches()
        if on_card:
            assert lo * batches <= got[kernel] <= hi * batches and sum(got.values()) == got[kernel], \
                f"{label}: launches {got} for {batches} batches"
        for k, c in got.items():
            total[k] += c
        reset()

    reset()
    split = serve_split(torch, pipe_f, fused_pad, spec, queries["fused"][0], SERVE_CLIENTS,
                        lambda label, nb: tally(f"serve split {label}", nb, "fused_topk", 1, 1))
    log(f"phase serve split: the fused endpoint, a flood of {SERVE_QUERIES} a variant, host clock; {split}; "
        f"{card}")
    reset()
    churn = serve_churn(torch, dev, dense, seed + 6000, lambda label, nb: tally(label, nb, "mips_topk", 1, 2))
    log(f"phase serve churn: {churn}; {card}")

    # the deprecated shim over a cuda runner
    items = queries["dense"][0][:b]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        srv = BatchingServer(lambda qb: ops.mips_topk(qb, dense, 10), batch_size=b, pad_query=dense_pad,
                             window_s=0.01, backend="cuda")
    reset()
    out = srv.serve(items)
    got = launches()
    srv.close()
    if on_card:
        assert got["mips_topk"] == srv.stats.n_batches >= 1, got
    for k, c in got.items():
        total[k] += c
    want = offline_rows(torch, lambda qb: ops.mips_topk(qb, dense, 10), items, None, dev, b)
    assert all(same_row(o, w) for o, w in zip(out, want)), "BatchingServer differs from its offline batch"
    log(f"phase serve shim: launch.serve.BatchingServer over ops.mips_topk, {srv.stats.n_requests} requests in "
        f"{srv.stats.n_batches} batch(es), equal to the offline batch; serve phases "
        f"{time.perf_counter() - t_phase:.1f} s"
        + (f", peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated" if on_card else ""))
    sharded.close()
    del live
    return total


def flex_plant(torch, corpus, v, seed, dev):
    """Plant the rows and queries of "flexneuart full" in the resident
    corpus (rows at an offset of 2 or more from make_corpus's planted grid,
    so off its planted rows and off "fusion full"'s).

    FLEX_TRAIN + FLEX_HELD ranked queries: FLEX_TOPICS topic terms (weight
    0.5) then random ids (weight 0.05) up to 32, over a unit dense part u.
    Each gets a relevant row (0.9 u; the topic terms in the query's order,
    then random ids, weight 0.05 each), three dense decoys (1.5, 1.6, 1.7 u;
    random ids) that outrank it in the fused space at (1, 1), and a BM25
    decoy (-u; each topic term 4 times, then padding) that outranks it
    under BM25 alone and never enters the fused candidates.  So the fused
    top-100 holds the relevant row at rank 4, and among the candidates the
    relevant row leads in BM25 and in bigram proximity.

    FLEX_MARGIN margin queries for the inverted-index check: a term a
    (16 times) and 16 random ids; 100 rows hold a alone, 28 to 127 times,
    so their BM25 scores rise strictly with the count and lie far above
    every other row's: the BM25 top-100 is these rows, with margins.
    Returns (query tokens i32[Q, 32], dense parts, sparse values, relevant
    rows) of the ranked queries and the margin queries' tokens."""
    n, d = corpus.dense.shape
    nnz, nq_len = corpus.sparse.indices.shape[1], MSMARCO["nnz_q"]
    nq, t = FLEX_TRAIN + FLEX_HELD, FLEX_TOPICS
    g = torch.Generator(device=dev).manual_seed(seed)
    step = max(n // 2048, 2)
    rows = torch.randperm(n, generator=g, device=dev)
    rows = rows[rows % step >= 2][:5 * nq + 100 * FLEX_MARGIN]
    assert rows.numel() == 5 * nq + 100 * FLEX_MARGIN, "corpus too small for the planted rows"
    rel, dec1, dec2, dec3, bm_dec = rows[:5 * nq].view(5, nq)
    idx, val, dense = corpus.sparse.indices, corpus.sparse.values, corpus.dense

    terms = (1 + torch.randperm(v - 1, generator=g, device=dev)[:nq * t]).view(nq, t).int()
    q_tok = torch.randint(1, v, (nq, nq_len), generator=g, device=dev, dtype=torch.int32)
    q_tok[:, :t] = terms
    q_val = torch.full((nq, nq_len), 0.05, device=dev)
    q_val[:, :t] = 0.5
    u = torch.randn(nq, d, generator=g, device=dev)
    u /= u.norm(dim=1, keepdim=True)
    for r, scale in ((rel, 0.9), (dec1, 1.5), (dec2, 1.6), (dec3, 1.7), (bm_dec, -1.0)):
        dense[r] = scale * u
        idx[r] = torch.randint(1, v, (nq, nnz), generator=g, device=dev, dtype=torch.int32)
        val[r] = 0.05
    idx[rel, :t] = terms
    idx[bm_dec] = v
    val[bm_dec] = 0.0
    idx[bm_dec, :4 * t] = terms.repeat_interleave(4, dim=1)
    val[bm_dec, :4 * t] = 0.05

    margin = rows[5 * nq:].view(FLEX_MARGIN, 100)
    a = (1 + torch.randperm(v - 1, generator=g, device=dev)[:FLEX_MARGIN]).int()
    m_tok = torch.randint(1, v, (FLEX_MARGIN, nq_len), generator=g, device=dev, dtype=torch.int32)
    m_tok[:, :nq_len // 2] = a[:, None]
    idx[margin] = v
    val[margin] = 0.0
    reps = torch.arange(28, 128, device=dev)
    slot = torch.arange(nnz, device=dev)
    fill = slot[None, None, :] < reps[None, :, None]                 # [1, 100, nnz]
    idx[margin] = torch.where(fill, a[:, None, None], idx[margin])
    val[margin] = torch.where(fill, torch.full_like(val[margin], 0.01), val[margin])
    return (q_tok, u, q_val, rel), m_tok


def plain_inverted_index(idx, val, v, max_posting=None):
    """The reference's host build of an inverted index, step for step
    (``src/repro/core/inverted_index.py``): a double loop over documents
    and slots, each term's list in that order, and a longer list than
    ``max_posting`` cut by ``np.argsort`` of its float64 weights."""
    n_docs = idx.shape[0]
    term_docs = [[] for _ in range(v)]
    term_wts = [[] for _ in range(v)]
    for dd in range(n_docs):
        for t, w in zip(idx[dd], val[dd]):
            if t < v and w != 0.0:
                term_docs[int(t)].append(dd)
                term_wts[int(t)].append(float(w))
    longest = max((len(p) for p in term_docs), default=0)
    maxp = max(longest if max_posting is None else max_posting, 1)
    docs_arr = np.full((v, maxp), n_docs, dtype=np.int32)
    wts_arr = np.zeros((v, maxp), dtype=np.float32)
    truncated = 0
    for t in range(v):
        p = len(term_docs[t])
        if p > maxp:
            truncated += 1
            order = np.argsort(-np.abs(np.asarray(term_wts[t])))[:maxp]
            docs_arr[t] = np.asarray(term_docs[t], dtype=np.int32)[order]
            wts_arr[t] = np.asarray(term_wts[t], dtype=np.float32)[order]
        elif p:
            docs_arr[t, :p] = term_docs[t]
            wts_arr[t, :p] = term_wts[t]
    return docs_arr, wts_arr, truncated


def flexneuart_full_phase(torch, dev, check, corpus, card, on_card, seed, timer):
    """The FlexNeuART feature side over the resident corpus (settings of
    ``configs/paper_retrieval.py``): the forward index of the corpus's own
    COO ids (tokens share the corpus's storage), BM25 document vectors,
    the inverted index, Model 1 at full vocabulary on a bitext of
    (training query, relevant row), a Fig. 3 ``CompositeExtractor`` of
    BM25, proximity, avgWordEmbed, Model 1 and RM3, a ``LinearReranker``
    (coordinate ascent) and a ``TreeReranker`` (LambdaMART) learned on
    FLEX_TRAIN planted training queries, and the pipeline built by
    ``RetrievalPipeline.from_descriptor`` from a Fig. 4 descriptor (B2
    candidates, the linear model over 50, the tree over 10), serving
    FLEX_HELD // 16 held-out batches of 16; ``InvertedIndexGenerator``
    alone (BM25 top-100); one batch at candQty 2,000 through the
    intermediate extractors.  Checks: the index builds against their plain
    ways on a FLEX_PREFIX-row prefix; the generator's top-100 against exact
    sparse scoring through the ``reference`` backend on margin queries;
    batch 0's features and reranked ids against the CPU path; Model 1's
    likelihood and column sums; the descriptor's round trip.  Returns the
    launches of the served batches and the inverted-index check by kernel."""
    from repro_torch.core import fusion
    from repro_torch.core import inverted_index as inv
    from repro_torch.core.backends import ReferenceBackend
    from repro_torch.core.brute_force import TopK, select_topk
    from repro_torch.core.model1 import train_model1
    from repro_torch.core.pipeline import (BruteForceGenerator, InvertedIndexGenerator,
                                           RetrievalPipeline)
    from repro_torch.core.scorers import (CompositeExtractor, ForwardIndex, _term_counts,
                                          bm25_doc_vectors, build_forward_index,
                                          forward_index_from_padded, query_sparse_vectors)
    from repro_torch.core.sparse import SparseVectors, from_dense
    from repro_torch.core.spaces import FusedSpace, FusedVectors, SparseSpace
    from repro_torch.kernels import fused_topk as fk
    from repro_torch.kernels import topk_large as lk

    t_phase = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    n = corpus.dense.shape[0]
    v, b = MSMARCO["v"], MSMARCO["b"]
    (q_tok, q_dense, q_val, rel), m_tok = flex_plant(torch, corpus, v, seed, dev)
    ids = corpus.sparse.indices

    # ---- builds: forward index, BM25 vectors, inverted index
    stamps = {}
    t0 = time.perf_counter()
    fwd = forward_index_from_padded(ids, v)
    sync(torch, on_card)
    stamps["forward index"] = time.perf_counter() - t0
    assert fwd.tokens.data_ptr() == ids.data_ptr(), "the forward index copied the corpus's ids"
    t0 = time.perf_counter()
    bm25 = bm25_doc_vectors(fwd, MSMARCO["nnz"], FLEX["k1"], FLEX["b"])
    sync(torch, on_card)
    stamps["BM25 vectors"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = inv.build_inverted_index(bm25, v)
    sync(torch, on_card)
    stamps["inverted index"] = time.perf_counter() - t0
    maxp = index.postings_docs.shape[1]
    peak_build = torch.cuda.max_memory_allocated() / 1e9 if on_card else float("nan")

    # prefix checks against the plain ways
    p = FLEX_PREFIX
    host_ids = ids[:p].cpu().numpy()
    ragged = [r[r < v] for r in host_ids]
    want = build_forward_index(ragged, v, device=dev)
    got = forward_index_from_padded(ids[:p], v)
    for name in ("tokens", "length", "df"):
        assert torch.equal(getattr(got, name), getattr(want, name)), f"forward index prefix: {name} differs"
    assert got.avg_len == want.avg_len, (got.avg_len, want.avg_len)
    assert torch.equal(fwd.length[:p], want.length), "forward index: lengths differ on the prefix"
    # the BM25 vectors against the reference's dense form on the prefix
    pf = ForwardIndex(fwd.tokens[:p], fwd.length[:p], fwd.df, v, fwd.avg_len)
    idf = torch.clamp(torch.log(1.0 + (n - fwd.df + 0.5) / (fwd.df + 0.5)), min=0.0)
    tf = _term_counts(pf.tokens, v)
    norm = FLEX["k1"] * (1.0 - FLEX["b"] + FLEX["b"] * pf.length[:, None] / fwd.avg_len)
    w = idf[None, :] * tf * (FLEX["k1"] + 1.0) / (tf + norm)
    dense_bm25 = from_dense(torch.where(tf > 0, w, torch.zeros_like(w)), MSMARCO["nnz"], pad_id=v)
    del tf, w
    assert torch.equal(dense_bm25.indices, bm25.indices[:p]), "BM25 vectors: ids differ from the dense form"
    assert torch.equal(dense_bm25.values.view(torch.int32), bm25.values[:p].view(torch.int32)), \
        "BM25 vectors: weights differ from the dense form"
    host_val = bm25.values[:p].cpu().numpy()
    host_idx = bm25.indices[:p].cpu().numpy()
    truncs = []
    for max_posting in (None, 8):
        pd_, pw_, tr_ = plain_inverted_index(host_idx, host_val, v, max_posting)
        got = inv.build_inverted_index(SparseVectors(bm25.indices[:p], bm25.values[:p]), v, max_posting)
        assert np.array_equal(got.postings_docs.cpu().numpy(), pd_), f"inverted index prefix docs ({max_posting})"
        assert np.array_equal(got.postings_wts.cpu().numpy(), pw_), f"inverted index prefix weights ({max_posting})"
        assert got.truncated_terms == tr_, (got.truncated_terms, tr_)
        truncs.append(tr_)
    log(f"phase flexneuart full: builds over n={n}: forward index {stamps['forward index']:.3f} s (tokens are "
        f"the corpus's ids, shared), BM25 vectors {stamps['BM25 vectors']:.3f} s "
        f"({bm25.indices.numel() * 8 / 1e9:.2f} GB), inverted index {stamps['inverted index']:.3f} s (maxp "
        f"{maxp}, {2 * index.postings_docs.numel() * 4 / 1e9:.2f} GB, truncated terms {index.truncated_terms}); "
        f"peak {peak_build:.2f} GB; prefix of {p} rows: forward index equal to build_forward_index, BM25 "
        f"vectors equal to the dense form bit for bit, inverted index equal to the host loop (truncated "
        f"terms {truncs[0]} and {truncs[1]} at max_posting None and 8)")

    # ---- InvertedIndexGenerator against exact scoring through the reference backend
    gen_bm25 = InvertedIndexGenerator(index)
    mq = query_sparse_vectors(m_tok, v, MSMARCO["nnz_q"])
    lk.launches = 0
    got = gen_bm25.generate(mq, FLEX["cand"])
    inv_launches = lk.launches
    want = ReferenceBackend().topk(SparseSpace(v, "ip", 1 << 16), mq, bm25, FLEX["cand"])
    check("topk_large", "inverted index top-100 vs the reference backend (margin queries)", tuple(got), tuple(want))
    del bm25, want, dense_bm25
    if on_card:
        torch.cuda.empty_cache()

    # ---- Model 1 on (training query, relevant row) at full vocabulary
    train = slice(0, FLEX_TRAIN)
    t0 = time.perf_counter()
    ttable, lls = train_model1(q_tok[train], fwd.tokens[rel[train]], v, v, iters=FLEX["model1_iters"])
    sync(torch, on_card)
    stamps["Model 1"] = time.perf_counter() - t0
    lls = lls.tolist()
    assert all(lls[i + 1] >= lls[i] - 1e-4 for i in range(len(lls) - 1)), f"EM likelihood fell: {lls}"
    col_err = float((ttable.sum(0) - 1.0).abs().max())
    assert col_err <= 1e-5, f"a Model 1 column sums to 1 +- {col_err}"
    coll = torch.clamp(fwd.df, min=1.0)
    background = coll / coll.sum()
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    embeds = []
    for _ in range(2):
        e = torch.randn(v + 1, FLEX_EMBED, generator=g, device=dev) / math.sqrt(FLEX_EMBED)
        e[v] = 0.0
        embeds.append(e)
    context = {"fwd": fwd, "query_embed": embeds[0], "doc_embed": embeds[1], "ttable": ttable,
               "background": background}
    comp = CompositeExtractor.from_config(FLEX_EXTRACTORS, **context)

    # ---- training features over B2's candidates, LETOR models
    space = FusedSpace(v, 1.0, 1.0)
    b2 = BruteForceGenerator(space, corpus, backend="cuda")

    def fused_batch(i0, nb=b):
        sel = slice(i0, i0 + nb)
        return FusedVectors(q_dense[sel], SparseVectors(q_tok[sel], q_val[sel])), q_tok[sel]

    t0 = time.perf_counter()
    feats, labels = [], []
    for i0 in range(0, FLEX_TRAIN, b):
        qr, qt = fused_batch(i0)
        c = b2.generate(qr, FLEX["cand"]).indices.clone()
        r = rel[i0:i0 + b]
        missing = ~(c == r[:, None]).any(1)
        c[missing, -1] = r[missing].int()
        feats.append(comp.extract(qt, c))
        labels.append((c == r[:, None]).float())
    feats, labels = torch.cat(feats), torch.cat(labels)
    valid = torch.ones_like(labels, dtype=torch.bool)
    weights, ca_mrr = fusion.coordinate_ascent(feats, labels, valid, n_rounds=FLEX["ca_rounds"],
                                               n_restarts=FLEX["ca_restarts"],
                                               generator=torch.Generator(dev).manual_seed(seed))
    ensemble = fusion.lambdamart(feats, labels, valid, n_trees=FLEX["trees"], depth=FLEX["depth"])
    sync(torch, on_card)
    stamps["LETOR"] = time.perf_counter() - t0
    context.update(fused_b2=b2, linear=weights, tree=ensemble)
    desc = {"candProv": "fused_b2", "backend": "pallas", "candQty": FLEX["cand"],
            "intermQty": FLEX["interm"], "finalQty": FLEX["final"],
            "extrTypeInterm": list(FLEX_EXTRACTORS), "modelInterm": "linear",
            "extrType": list(FLEX_EXTRACTORS), "model": "tree"}
    pipe = RetrievalPipeline.from_descriptor(desc, context)
    canon = pipe.descriptor
    assert "backend" not in canon and canon["execBackend"] == "pallas", canon
    assert RetrievalPipeline.from_descriptor(canon, context).descriptor == canon, "descriptor round trip"
    assert type(pipe.generator.backend).__name__ == "CudaBackend", pipe.generator.backend

    # ---- serve the held-out batches, stage by stage and end to end
    fk.launches = lk.launches = 0
    stage_ms = {"candidates (B2)": [], "features": [], "rerank": [], "pipeline": [], "inverted index": []}
    inter, final = pipe.intermediate, pipe.final
    rerank_split = []
    served, bm25_only, fused_only, linear_only = [], [], [], []

    def clock(fn):
        sync(torch, on_card)
        t = time.perf_counter()
        out = fn()
        sync(torch, on_card)
        return out, 1e3 * (time.perf_counter() - t)

    for i0 in range(FLEX_TRAIN, FLEX_TRAIN + FLEX_HELD, b):
        qr, qt = fused_batch(i0)
        cands, ms_c = clock(lambda: pipe.generate_candidates(qr))
        f1, ms_f1 = clock(lambda: inter.extractor.extract(qt, cands.indices))
        mid = inter.rerank_features(cands, f1, FLEX["interm"])
        ms_r1 = timer(lambda: inter.rerank_features(cands, f1, FLEX["interm"]), 5)
        f2, ms_f2 = clock(lambda: final.extractor.extract(qt, mid.indices))
        out = final.rerank_features(mid, f2, FLEX["final"])
        ms_r2 = timer(lambda: final.rerank_features(mid, f2, FLEX["final"]), 5)
        whole, ms_p = clock(lambda: pipe.run(qr, qt))
        assert torch.equal(whole.indices, out.indices), "pipeline.run differs from its stages"
        qs = query_sparse_vectors(qt, v, MSMARCO["nnz_q"])
        alone, ms_i = clock(lambda: gen_bm25.generate(qs, FLEX["final"]))
        stage_ms["candidates (B2)"].append(ms_c)
        stage_ms["features"].append(ms_f1 + ms_f2)
        stage_ms["rerank"].append(ms_r1 + ms_r2)
        rerank_split.append((ms_r1, ms_r2))
        stage_ms["pipeline"].append(ms_p)
        stage_ms["inverted index"].append(ms_i)
        served.append(out)
        bm25_only.append(alone)
        fused_only.append(TopK(cands.scores[:, :FLEX["final"]], cands.indices[:, :FLEX["final"]]))
        linear_only.append(TopK(mid.scores[:, :FLEX["final"]], mid.indices[:, :FLEX["final"]]))
        if i0 == FLEX_TRAIN:
            batch0 = (qr, qt, cands, mid, out)
    served_launches = {"fused_topk": fk.launches, "topk_large": lk.launches + inv_launches}
    n_batches = FLEX_HELD // b
    if on_card:
        assert fk.launches == 2 * n_batches and lk.launches == n_batches, served_launches
    held = rel[FLEX_TRAIN:]

    def mrr_of(results):
        got = TopK(torch.cat([r.scores for r in results]), torch.cat([r.indices for r in results]))
        hit = (got.indices == held[:, None]).float()
        return float(fusion.mrr(got.scores, hit, torch.ones_like(hit, dtype=torch.bool), 10))

    mrrs = {name: mrr_of(r) for name, r in (("BM25 alone (inverted index)", bm25_only),
                                            ("fused candidates alone (B2)", fused_only),
                                            ("linear stage", linear_only), ("tree stage", served))}

    # ---- batch 0 against the CPU path on the same inputs
    qr, qt, cands, mid, out = batch0
    cpu = torch.device("cpu")
    host_fwd = ForwardIndex(fwd.tokens.cpu(), fwd.length.cpu(), fwd.df.cpu(), v, fwd.avg_len)
    host_ctx = {"fwd": host_fwd, "query_embed": embeds[0].cpu(), "doc_embed": embeds[1].cpu(),
                "ttable": ttable.cpu(), "background": background.cpu()}
    host_comp = CompositeExtractor.from_config(FLEX_EXTRACTORS, **host_ctx)
    feat_err = {}
    for e_card, e_host, desc_e in zip(comp.extractors, host_comp.extractors, FLEX_EXTRACTORS):
        f_card = e_card.extract(qt, cands.indices).cpu()
        f_host = e_host.extract(qt.cpu(), cands.indices.cpu())
        scale = f_host.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-30)
        ratio = float(((f_card - f_host).abs() / scale).max())
        feat_err[desc_e["type"]] = ratio
        assert ratio <= FLEX_FEATURE_TOL[desc_e["type"]], \
            f"{desc_e['type']} features: card vs cpu {ratio:.3g} of row scale"
    from repro_torch.core.pipeline import LinearReranker, TreeReranker
    host_ens = fusion.ObliviousTreeEnsemble(*(x.cpu() for x in ensemble[:3]), ensemble.lr)
    host_cands = TopK(cands.scores.cpu(), cands.indices.cpu())
    # the tree's precondition for equal ids: no feature within the tolerance of a split threshold
    near = thresholds_near(torch, host_comp.extract(qt.cpu(), mid.indices.cpu()), host_ens)
    assert near[1] == 0, f"{near[1]} (feature, threshold) pairs within 1e-5 but not equal: ids may part"
    host_mid = LinearReranker(host_comp, weights.cpu()).rerank(qt.cpu(), host_cands, FLEX["interm"])
    check("rerank", "linear rerank batch 0 (card vs cpu)", tuple(mid), tuple(host_mid))
    host_out = TreeReranker(host_comp, host_ens).rerank(qt.cpu(), TopK(mid.scores.cpu(), mid.indices.cpu()),
                                                        FLEX["final"])
    check("rerank", "tree rerank batch 0 (card vs cpu)", tuple(out), tuple(host_out))
    del host_fwd, host_ctx, host_comp

    # ---- InvertedIndexGenerator's time against its byte bound; its two selections
    qs = query_sparse_vectors(batch0[1], v, MSMARCO["nnz_q"])
    inv_ms = timer(lambda: gen_bm25.generate(qs, FLEX["cand"]), 5)
    score_buf = inv.daat_score(index, qs).contiguous()
    sel_large_ms = timer(lambda: lk.select_large(score_buf, FLEX["cand"]), 5)
    sel_sort_ms = timer(lambda: select_topk(score_buf, FLEX["cand"]), 5)
    del score_buf
    live_terms = int((qs.indices < v).sum())
    inv_bytes = live_terms * maxp * 8 + 2 * b * n * 4
    inv_bound = inv_bytes / HBM_BYTES_PER_S * 1e3

    # ---- one batch at the paper's candQty = 2,000 through the intermediate extractors
    qr, qt = fused_batch(FLEX_TRAIN)
    peak_pre = torch.cuda.max_memory_allocated() / 1e9 if on_card else float("nan")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    deep = pipe.generate_candidates(qr, FLEX_DEEP)           # warm-up: the first [B, 2000, V] RM3 buffers
    deep_mid = inter.rerank(qt, deep, FLEX["interm"])
    reps_deep = [(clock(lambda: pipe.generate_candidates(qr, FLEX_DEEP))[1],
                  clock(lambda: inter.rerank(qt, deep, FLEX["interm"]))[1],
                  clock(lambda: inter.extractor.extract(qt, deep.indices))[1]) for _ in range(3)]
    ms_deep_c, ms_deep_r, ms_deep_f = (statistics.median(x) for x in zip(*reps_deep))
    f_deep = inter.extractor.extract(qt, deep.indices)
    ms_deep_m = timer(lambda: inter.rerank_features(deep, f_deep, FLEX["interm"]), 5)
    del f_deep
    assert deep_mid.indices.shape == (b, FLEX["interm"])
    deep_hit = (deep_mid.indices[:, :10] == held[:b, None]).float()
    deep_mrr = float(fusion.mrr(deep_mid.scores[:, :10], deep_hit, torch.ones_like(deep_hit, dtype=torch.bool), 10))
    peak_deep = torch.cuda.max_memory_allocated() / 1e9 if on_card else float("nan")
    med = {k: statistics.median(x) for k, x in stage_ms.items()}
    log(f"  Model 1: table {v}x{v} f32 ({v * v * 4 / 1e9:.2f} GB), {FLEX['model1_iters']} EM iterations on "
        f"{FLEX_TRAIN} pairs in {stamps['Model 1']:.3f} s, mean log-likelihood " + " ".join(f"{x:.5f}" for x in lls)
        + f" (non-decreasing), columns sum to 1 within {col_err:.2e}; embeddings E={FLEX_EMBED}; LETOR on "
        f"{FLEX_TRAIN} training queries in {stamps['LETOR']:.3f} s (coordinate ascent {FLEX['ca_rounds']} rounds, "
        f"{FLEX['ca_restarts']} restarts, training MRR@10 {ca_mrr:.4f}; LambdaMART {FLEX['trees']} trees of depth "
        f"{FLEX['depth']}); weights " + " ".join(f"{x:.4f}" for x in weights.tolist()))
    log(f"  served {n_batches} batches of {b} from the Fig. 4 descriptor (candidates B2 k={FLEX['cand']}, linear "
        f"over {FLEX['interm']}, tree over {FLEX['final']}), median ms/batch (host clock, synchronised, but rerank: "
        f"the two models and selections on precomputed features, CUDA events, median of 5 a batch): "
        + ", ".join(f"{k} {x:.3f}" for k, x in med.items())
        + f" (of the rerank: linear {statistics.median(x[0] for x in rerank_split):.3f}, tree "
        f"{statistics.median(x[1] for x in rerank_split):.3f})"
        + f"; held-out MRR@10: " + ", ".join(f"{k} {x:.4f}" for k, x in mrrs.items()))
    log(f"  InvertedIndexGenerator top-{FLEX['cand']} (B={b}, {live_terms} live query terms): {inv_ms:.3f} ms "
        f"(CUDA events, median of 5) against a bound of {inv_bound:.3f} ms (bytes: postings gathered "
        f"{live_terms * maxp * 8 / 1e9:.3f} GB + the [B, N] buffer written and read {2 * b * n * 4 / 1e9:.3f} GB); "
        f"its selection over the [B, N] scores: topk_large.select_large {sel_large_ms:.3f} ms, "
        f"brute_force.select_topk {sel_sort_ms:.3f} ms; select_large launches {inv_launches} on the check")
    log(f"  candQty {FLEX_DEEP} (after a warm-up; medians of 3, host clock, synchronised): candidates "
        f"{ms_deep_c:.3f} ms, linear stage over {FLEX_DEEP} ({len(FLEX_EXTRACTORS)} extractors, RM3's [B, C, V] "
        f"counts {b * FLEX_DEEP * v * 4 / 1e9:.2f} GB) {ms_deep_r:.3f} ms, of it features {ms_deep_f:.3f} ms and the "
        f"model and selection on precomputed features {ms_deep_m:.3f} ms (CUDA events, median of 5); peak "
        f"{peak_deep:.2f} GB; MRR@10 of the linear stage's top 10 {deep_mrr:.4f}")
    log(f"  batch 0 card vs cpu: features (worst |card - cpu| of row scale) "
        + ", ".join(f"{k} {x:.2e}" for k, x in feat_err.items())
        + f"; reranked ids equal, scores within {TOL_REL} of the row scale (linear, tree); (feature, threshold) "
        f"pairs of the tree's inputs equal {near[0]} (exact zeros on both), within 1e-5 but not equal {near[1]} "
        f"(must be 0); descriptor round-trips; launches on the served batches and the check {served_launches}; "
        f"max_memory_allocated over the phase {max(peak_pre, peak_deep):.2f} GB (the builds {peak_build:.2f}, the "
        f"candQty {FLEX_DEEP} batch {peak_deep:.2f}); phase {time.perf_counter() - t_phase:.1f} s; {card}")
    assert mrrs["tree stage"] >= mrrs["fused candidates alone (B2)"], mrrs
    del index, gen_bm25, ttable, comp, pipe, context, feats, fwd
    if on_card:
        torch.cuda.empty_cache()
    return served_launches


class EventTimed:
    """A reranker whose ``rerank`` calls are bracketed by CUDA events (on
    the card) while ``events`` is a list; ``ms()`` reads their times."""

    def __init__(self, torch, inner, on_card):
        self.torch, self.inner, self.on_card, self.events = torch, inner, on_card, []

    def rerank(self, q_tokens, cands, keep):
        if self.events is None or not self.on_card:
            return self.inner.rerank(q_tokens, cands, keep)
        start, end = (self.torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = self.inner.rerank(q_tokens, cands, keep)
        end.record()
        self.events.append((start, end))
        return out

    def ms(self):
        if not self.events:
            return [float("nan")]
        self.torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


class BatchRecorder:
    """A funnel pipeline that keeps, for each batch it serves, a copy of
    its inputs (queries and tokens as the batcher stacked them) and of its
    answer, so that each served batch can be run again offline."""

    def __init__(self, funnel):
        self.funnel = funnel
        self.batches = []

    def __getattr__(self, name):
        return getattr(self.__dict__["funnel"], name)

    def run_timed(self, query_repr, q_tokens=None, *, elapsed_s=0.0):
        from repro_torch.core.spaces import map_tensors

        out, trace = self.funnel.run_timed(query_repr, q_tokens, elapsed_s=elapsed_s)
        self.batches.append((map_tensors(lambda t: t.clone(), query_repr), q_tokens.clone(),
                             map_tensors(lambda t: t.clone(), out)))
        return out, trace


def cross_flops(cfg, pairs, seq):
    """Operations of the cross-encoder on ``pairs`` (query ++ passage)
    sequences of ``seq`` tokens: the projections and the FFN (2 a
    multiply-add), causal attention (the S(S+1)/2 query-key pairs its mask
    keeps, twice: scores and values), the head's dot."""
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    per_token = 2 * d * (h * dh + 2 * hkv * dh) + 2 * h * dh * d + 3 * 2 * d * cfg.d_ff
    attention = 2 * 2 * h * dh * seq * (seq + 1) // 2
    return pairs * (cfg.n_layers * (seq * per_token + attention) + 2 * d)


def cross_full_phase(torch, dev, check, corpus, space, card, on_card, seed, timer, cfg=None, queries=CROSS_QUERIES):
    """The funnel's neural stage over the resident corpus: smollm-360m as
    published (``configs/smollm_360m.py``, bf16, random weights from
    ``init_transformer`` with ``seed``) as a ``CrossEncoderReranker`` over
    B2's top CROSS["cand"] of each fused query, keeping CROSS["keep"].  A
    query's tokens are its 32 sparse ids, a passage's its 128 COO ids (the
    resident ``idx``); the fused query's dense part is ``encode`` of its
    tokens (out_dim 768).  Batch 0's encoded queries through B1 (dense) and
    B2 (fused) against their plain versions; the funnel offline, batch by
    batch after a warm-up (stage times on the host clock; the rerank
    stage by CUDA events against the cross-encoder's FLOP bound, and the
    cross-encoder by kernel under the profiler); the same funnel served
    (``RetrievalService(cache_size=0)``, no budget) to CROSS_CLIENTS
    threads sending ``queries`` host queries, every answer held to the
    offline batch of the submission order (where one differs,
    every served batch is run again on its own inputs and must equal its
    answer; the difference is reported); batch 0's bf16 scores against the
    same weights in f32 (TF32 off) within CROSS_BF16_TOL, top-``keep`` ids
    (and sets) equal on rows with no near tie.
    ``cfg`` (default: the published config) cuts the model for a CPU
    rehearsal.  Returns the launches by kernel."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import BruteForceGenerator
    from repro_torch.core.sparse import SparseVectors
    from repro_torch.core.spaces import FusedVectors, map_tensors
    from repro_torch.distributed.sharding import ParallelCtx
    from repro_torch.kernels import fused_topk as fk
    from repro_torch.kernels import mips_topk as mk
    from repro_torch.kernels import ref as plain
    from repro_torch.models.encoder import CrossEncoderReranker, encode, make_proxy_scorer
    from repro_torch.models.transformer import init_transformer
    from repro_torch.serving import EndpointSpec, FunnelPipeline, RetrievalService

    t_phase = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    cfg = get_config(CROSS["arch"]) if cfg is None else cfg
    n, d = corpus.dense.shape
    v, b, nnz_q = space.vocab_size, MSMARCO["b"], MSMARCO["nnz_q"]
    cand, keep = CROSS["cand"], CROSS["keep"]
    idx = corpus.sparse.indices
    assert int(idx.max()) < cfg.vocab_size, "passage ids beyond the model's vocabulary"
    t0 = time.perf_counter()
    model, _ = init_transformer(cfg, seed=seed, device=dev)
    model.requires_grad_(False)
    sync(torch, on_card)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    ctx = ParallelCtx(None, cfg.rules)
    counters = {"mips_topk": mk, "fused_topk": fk}
    for m in counters.values():
        m.launches = 0

    # ---- the encoder path: each query's dense part is encode(its tokens)
    def fused_batch(i):
        _, qi, qv = make_queries(torch, b, d, v, nnz_q, seed + 100 + i, dev, planted=False)
        qe = encode(model, qi, cfg, ctx, out_dim=CROSS["out_dim"])
        return FusedVectors(qe.float(), SparseVectors(qi, qv)), qi

    q0, tok0 = fused_batch(0)
    encode_ms = timer(lambda: encode(model, tok0, cfg, ctx, out_dim=CROSS["out_dim"]), 5)
    assert q0.dense.shape == (b, d) and bool(torch.isfinite(q0.dense).all())
    norms = q0.dense.norm(dim=1)
    assert bool(((norms - 1).abs() < 2e-2).all()), f"encoded queries are not unit vectors: {norms.tolist()}"
    w = dict(w_dense=space.w_dense, w_sparse=space.w_sparse)
    table = plain.query_table(q0.sparse, v)
    b1 = mk.mips_topk(q0.dense, corpus.dense, 100)
    b2 = fk.fused_topk(table, q0.dense, idx, corpus.sparse.values, corpus.dense, 100, **w)
    check("mips_topk", "cross full: encoded queries, dense k=100", b1,
          plain.mips_topk_ref(q0.dense, corpus.dense, 100, tile_n=1 << 18), exact_ids=False)
    check("fused_topk", "cross full: encoded fused queries k=100", b2,
          plain.fused_topk_table_ref(table, q0.dense, idx, corpus.sparse.values, corpus.dense, 100,
                                     tile_n=1 << 16, **w), exact_ids=False)

    # ---- the funnel offline: B2's top `cand`, then the cross-encoder
    gen = BruteForceGenerator(space, corpus, backend="cuda")
    reranker = EventTimed(torch, CrossEncoderReranker(model, cfg, ctx, idx), on_card)
    funnel = FunnelPipeline(gen, rerank=reranker, cand_qty=cand, fusion_qty=cand, rerank_keep=keep)
    batches = [fused_batch(1 + i) for i in range(queries // b)]
    funnel.run(*batches[0])                                        # warm-up
    reranker.events.clear()
    stages, results = [], []
    for q, tok in batches:
        sync(torch, on_card)
        t0 = time.perf_counter()
        out, trace = funnel.run_timed(q, tok)
        sync(torch, on_card)
        stages.append((1e3 * (time.perf_counter() - t0), 1e3 * trace.candgen_s, 1e3 * trace.rerank_s))
        results.append(out)
        assert out.indices.shape == (b, keep) and bool(torch.isfinite(out.scores).all())
    timed = stages[:CROSS_BATCHES]
    ce_ms = statistics.median(reranker.ms()[:CROSS_BATCHES])
    reranker.events = None                 # served batches are not timed
    # the cross-encoder alone on batch 0's candidates under the profiler, by kernel; its bf16 scores (all
    # `cand` a query) are kept for the f32 comparison below
    tok0, ids0 = batches[0][1], gen.generate(batches[0][0], cand).indices
    scorer, box = make_proxy_scorer(model, cfg, ctx, idx), {}
    if on_card:
        kernels_ms = device_profile(torch, lambda: box.__setitem__("s16", scorer(tok0, ids0)), by_kernel=True)[0]
    else:
        kernels_ms, box["s16"] = {}, scorer(tok0, ids0)
    s16 = box["s16"].float()
    flops = cross_flops(cfg, b * cand, nnz_q + MSMARCO["nnz"])
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    bound_ms = max(flops / BF16_FLOPS, weight_bytes / HBM_BYTES_PER_S) * 1e3
    peak_offline = torch.cuda.max_memory_allocated() / 1e9 if on_card else float("nan")

    # ---- served: one endpoint, no budget, every batch reranked
    items, tokens = [], []
    for q, tok in batches:
        host = map_tensors(lambda t: t.cpu(), q)
        items += [FusedVectors(host.dense[r], SparseVectors(host.sparse.indices[r], host.sparse.values[r]))
                  for r in range(b)]
        tokens += list(tok.cpu())
    offline = [(r.scores[i].float().cpu().numpy(), r.indices[i].cpu().numpy()) for r in results for i in range(b)]
    pad = FusedVectors(torch.zeros(d, device=dev), SparseVectors(
        torch.full((nnz_q,), v, dtype=torch.int32, device=dev), torch.zeros(nnz_q, device=dev)))
    pad_tok = torch.full((nnz_q,), v, dtype=torch.int32, device=dev)
    recorder = BatchRecorder(funnel)
    spec = EndpointSpec(batch_size=b, max_wait_s=0.01, max_queue=128, overload="block")
    before_serve = fk.launches
    with RetrievalService(cache_size=0) as svc:
        svc.register_pipeline("cross", recorder, pad, pad_tok, spec=spec)
        box = {}

        def run():
            box["out"] = flood(svc, "cross", items, tokens, CROSS_CLIENTS)

        idle = "not measured"
        if on_card:
            groups, span_ms, _ = device_profile(torch, run)
            if groups:
                idle = f"{max(0.0, 1.0 - sum(groups.values()) / span_ms):.3f}"
        else:
            run()
        got, wall = box["out"]
        ep = svc.snapshot().endpoints["cross"]
    launches = {k: m.launches for k, m in counters.items()}
    served_b2 = fk.launches - before_serve
    reranks = ep.stages["rerank"].count
    assert reranks == ep.n_batches == len(recorder.batches), (reranks, ep.n_batches, len(recorder.batches))
    assert ep.stage_fallbacks["rerank"] == 0 and ep.n_requests == len(items)
    if on_card:
        assert served_b2 == ep.n_batches, f"served B2 launches {served_b2} for {ep.n_batches} batches"
        assert all(c > 0 for c in launches.values()), launches
    # every answer against the offline batch of the submission order; where one differs, the pairs'
    # results may depend on their place in the batch: every served batch is then run again offline on its
    # own inputs and must equal its served answer bit for bit, and the difference is reported
    differ = [i for i, row in enumerate(got) if not same_row(row, offline[i])]
    worst = max((float(np.abs(got[i][0].astype(np.float64) - offline[i][0]).max()) for i in differ), default=0.0)
    ids_differ = sum(not np.array_equal(got[i][1], offline[i][1]) for i in differ)
    if differ:
        sync(torch, on_card)          # the copies were made on the worker's stream
        for q, tok, out in recorder.batches:
            again = funnel.run(q, tok)
            assert torch.equal(again.indices, out.indices) and torch.equal(
                again.scores.float().view(torch.int32), out.scores.float().view(torch.int32)), \
                "cross full: a served batch differs from its offline run on the same inputs"

    # ---- batch 0's bf16 scores against the same weights in f32, TF32 off
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 is on: the f32 reference would round to 10 bits"
    model32 = copy.deepcopy(model).float()
    model32.cfg = dataclasses.replace(cfg, dtype="float32")
    with torch.no_grad():   # cross_encoder_score in f32, and each pair's sum_i |pooled_i * head_i|
        joint = torch.cat([tok0.repeat_interleave(cand, dim=0), idx[ids0.reshape(-1).long()]], 1)
        pooled = model32(joint)[0].mean(1)
        head = model32.embed[0]
        s32, scale = (pooled @ head).reshape(b, cand), (pooled.abs() @ head.abs()).reshape(b, cand)
    del model32, pooled, joint
    err = (s16 - s32).abs()
    ratio = float((err / scale).max())
    assert ratio <= CROSS_BF16_TOL, f"cross full: bf16 vs f32 error {ratio:.3g} of the dot's scale > {CROSS_BF16_TOL}"
    order16 = torch.argsort(s16, dim=1, descending=True, stable=True)
    order32 = torch.argsort(s32, dim=1, descending=True, stable=True)
    # a near tie, where the errors measured could swap two candidates: two neighbours among a row's best
    # keep f32 scores closer than their two errors, or the keep-th closer to the next than its error plus
    # the row's largest; on a row without one, the bf16 top-keep ids must equal the f32 ones
    top32 = torch.gather(s32, 1, order32[:, :keep + 1])
    e_top = torch.gather(err, 1, order32[:, :keep + 1])
    gaps = top32[:, :-1] - top32[:, 1:]
    near = (gaps[:, :-1] <= e_top[:, :-2] + e_top[:, 1:-1]).any(1) | (gaps[:, -1] <= e_top[:, -2] + err.amax(1))
    same = (order16[:, :keep] == order32[:, :keep]).all(1)
    assert bool((same | near).all()), "cross full: bf16 and f32 top ids differ on a row with no near tie"
    # the top-keep as a set: only the keep-th against the next can part them
    near_set = gaps[:, -1] <= e_top[:, -2] + err.amax(1)
    same_set = (order16[:, :keep].sort(1).values == order32[:, :keep].sort(1).values).all(1)
    assert bool((same_set | near_set).all()), "cross full: bf16 and f32 top sets differ with no near tie"
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else float("nan")

    med = [statistics.median(x) for x in zip(*timed)]
    e2e = ep.e2e
    log(f"phase cross full: {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads / "
        f"{cfg.n_kv_heads} KV, head dim {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}, tied: {cfg.tie_embeddings}), {n_params:,} parameters ({weight_bytes / 1e9:.3f} GB) drawn on "
        f"{dev} in {init_s:.2f} s from seed {seed}; over the resident corpus (n={n}), B2 top {cand} -> "
        f"cross-encoder top {keep}: {b * cand} pairs of {nnz_q} + {MSMARCO['nnz']} tokens a batch of {b}")
    log(f"  encode (B={b}, {nnz_q} tokens, out_dim {CROSS['out_dim']}; CUDA events, median of 5) {encode_ms:.3f} ms; "
        f"batch 0's encoded queries: B1 dense and B2 fused top-100 equal their plain versions (tolerance "
        f"{TOL_REL} of row scale)")
    log(f"  offline funnel, {len(timed)} batches after a warm-up (host clock, synchronised, median): whole "
        f"{med[0]:.3f} ms, candidates (B2) {med[1]:.3f} ms, rerank {med[2]:.3f} ms; the rerank stage by CUDA "
        f"events (median of the same batches) {ce_ms:.3f} ms against a bound of {bound_ms:.3f} ms "
        f"({flops / 1e12:.2f} TFLOP at {BF16_FLOPS / 1e12:.1f} TFLOP/s dense bf16: projections, FFN, the causal "
        f"half of attention; the plain attention computes every query-key pair in f32): "
        f"{flops / (ce_ms / 1e3) / 1e12 if ce_ms == ce_ms else float('nan'):.1f} TFLOP/s; peak "
        f"{peak_offline:.2f} GB allocated; under the profiler, device ms by kernel (the 8 largest of "
        f"{sum(kernels_ms.values()):.1f}): "
        + ", ".join(f"{k} {v:.1f}" for k, v in sorted(kernels_ms.items(), key=lambda kv: -kv[1])[:8]))
    log(f"  served ({CROSS_CLIENTS} clients, {len(items)} host queries, no cache, no budget): "
        f"{len(items) / wall:.1f} qps, e2e p50 {e2e.p50_ms:.3f} ms p99 {e2e.p99_ms:.3f} ms, exec "
        f"{ep.execute.p50_ms:.3f} ms/batch (p50), {ep.n_batches} batches (fill {ep.mean_batch_fill:.3f}), "
        f"rerank run in {reranks}, idle {idle}; against the offline batches of the submission order: "
        f"{len(items) - len(differ)} of {len(items)} answers equal in ids and score bits"
        + (f", {len(differ)} differ (ids in {ids_differ}; worst |score difference| {worst:.6g}): the pairs' "
           f"scores depend on their place in the batch; every served batch equals its offline run on the same "
           f"inputs" if differ else "")
        + f"; launches {launches} (B2 {served_b2} served)")
    log(f"  bf16 vs f32 (batch 0, {b * cand} pairs, TF32 off): worst |error| {float(err.max()):.6g}, "
        f"{ratio:.4g} of the pair's sum |pooled_i head_i| (bound {CROSS_BF16_TOL}); top-{keep} ids equal on "
        f"{int(same.sum())} of {b} rows, {int((~same & near).sum())} differing rows near a tie, "
        f"{int(near.sum())} rows with a near tie (neighbours among the best {keep + 1} f32 scores within their "
        f"errors); top-{keep} sets equal on {int(same_set.sum())} rows, {int(near_set.sum())} rows near a tie at "
        f"the {keep}-th; peak {peak:.2f} GB allocated; phase "
        f"{time.perf_counter() - t_phase:.1f} s; {card}")
    del model, reranker, funnel, recorder, gen
    if on_card:
        torch.cuda.empty_cache()
    return launches


def thresholds_near(torch, feats, ensemble, tol=1e-5):
    """(pairs of a feature value and a split threshold on that feature that
    are equal, pairs within ``tol`` of the feature's scale but not equal):
    the second are where the card and the CPU may branch apart."""
    x = feats.reshape(-1, feats.shape[-1])
    scale = x.abs().amax(0).clamp_min(1e-30)
    f = ensemble.feat.long().reshape(-1)
    gap = (x[:, f] - ensemble.thresh.reshape(-1)[None, :]).abs()
    return int((gap == 0).sum()), int(((gap > 0) & (gap <= tol * scale[f][None, :])).sum())


def autotune_phase(torch, dev, check, space, corpus, card, on_card, seed):
    """The autotuner's search over the planted-cluster fused corpus of
    "graph recall" (full widths; ``reduced``: 1,048,576 rows): AUTOTUNE_QUERIES
    distinct queries (the phase's own, made as ``planted_cluster`` makes
    them) and a workload of AUTOTUNE_REQUESTS requests with repeats, each
    genome measured by ``measure_config`` (a fresh ``RetrievalService``, a
    warm-up, 2 passes); ``autotune`` with AUTOTUNE settings and three
    explore genomes (f32 ``pallas``, ``graph_ann`` with ``kernel=True``,
    ``napp``), on a copy of the space whose sparse scoring is tiled, so
    that a reference genome at batch 128 stays within memory.  The recall
    oracle is the plain fused scan, not B2.  Checks every measured point's
    identity and dtype, recall@10 1.0 for exact f32 genomes, B2 against
    its plain version at every (batch, dtype, shards) a served ``pallas``
    genome ran it at, the counts, a replay of the search on the first
    run's numbers, and B3 and B4 launched from served genomes.  Returns
    the launches of the measured genomes by kernel."""
    import dataclasses

    from repro_torch.core.backends import ann_index_cache_info, CudaBackend
    from repro_torch.core.sparse import SparseVectors
    from repro_torch.core.spaces import FusedVectors, canonical_dtype, cast_corpus
    from repro_torch.kernels import beam_topk as bk
    from repro_torch.kernels import fused_topk as fk
    from repro_torch.kernels import mips_topk as mk
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_dense as sd
    from repro_torch.kernels import topk_large as lk
    from repro_torch.serving.sharded import ShardedPipeline
    from repro_torch.serving.autotune import (ServingConfig, _served_as_declared, autotune,
                                              measure_config, pareto_front, proxy_objectives)

    t_phase = time.perf_counter()
    n, d = corpus.dense.shape
    v, k = space.vocab_size, 10
    tuned_space = dataclasses.replace(space, tile_n=1 << 13)
    nq = AUTOTUNE_QUERIES + AUTOTUNE_WARM
    _, (qd, qi, qv) = planted_cluster(torch, CLUSTERS, d, v, corpus.sparse.indices.shape[1], MSMARCO["nnz_q"],
                                      nq, seed, dev)
    take = lambda lo, hi: FusedVectors(qd[lo:hi], SparseVectors(qi[lo:hi], qv[lo:hi]))
    queries, warm = take(0, AUTOTUNE_QUERIES), take(AUTOTUNE_QUERIES, nq)
    w = dict(w_dense=space.w_dense, w_sparse=space.w_sparse)

    def plain_topk(c, nq_):
        """The plain fused scan of the first ``nq_`` queries over ``c``, 64 at a time."""
        parts = []
        for lo in range(0, nq_, 64):
            qq = take(lo, min(lo + 64, nq_))
            parts.append(ref.fused_topk_ref(qq.sparse, qq.dense, c.sparse, c.dense, v, k, tile_n=1 << 13, **w))
        return tuple(torch.cat([x[j] for x in parts]) for j in (0, 1))

    t0 = time.perf_counter()
    oracle_s, oracle = plain_topk(corpus, AUTOTUNE_QUERIES)
    sync(torch, on_card)
    oracle_secs = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    workload = rng.integers(0, AUTOTUNE_QUERIES // 4, AUTOTUNE_REQUESTS)    # a hot set: repeats
    workload[::2] = rng.integers(0, AUTOTUNE_QUERIES, AUTOTUNE_REQUESTS // 2)
    counters = {"fused_topk": fk, "beam_hop": bk, "fused_score": sd, "mips_topk": mk, "topk_large": lk}
    launches = dict.fromkeys(counters, 0)
    rows, builds = [], {"graph_ann": 0, "napp": 0}

    def measure(cfg):
        for m in counters.values():
            m.launches = 0
        misses = ann_index_cache_info()["misses"]
        t0 = time.perf_counter()
        point = measure_config(cfg, space=tuned_space, corpus=corpus, queries=queries, warmup_queries=warm,
                               workload=workload, k=k, oracle_indices=oracle, check_n=16, passes=2)
        sync(torch, on_card)
        got = {name: m.launches for name, m in counters.items()}
        for name, c in got.items():
            launches[name] += c
        if cfg.backend in builds:
            builds[cfg.backend] += ann_index_cache_info()["misses"] - misses
        rows.append((cfg, point, time.perf_counter() - t0, got))
        return point

    explore = [ServingConfig(backend="pallas", batch_size=16),
               ServingConfig(backend="graph_ann", ef=64, kernel=True, batch_size=16),
               ServingConfig(backend="napp", num_search=8, rerank_qty=256, batch_size=16)]
    n_replayed = 2 * len(workload)
    repeat_fraction = 1.0 - len(set(workload.tolist())) / n_replayed
    kw = dict(k=k, n_docs=n, dim=d, seed=seed, repeat_fraction=repeat_fraction,
              explore_configs=explore, space=tuned_space, corpus=corpus, **AUTOTUNE)
    gen_log = []
    result = autotune(measure, log=gen_log.append, **kw)
    measured = [(cfg, p) for cfg, p, _, _ in rows]
    # the explore genomes the proxy pruned, measured outside the search
    searched = {cfg.key() for cfg, _ in measured}
    extra = [cfg for cfg in explore if cfg.key() not in searched]
    for cfg in extra:
        measure(cfg)

    # checks
    for cfg, p, _, got in rows:
        if p is None:      # served nothing: a point autotune skips as unmeasurable
            continue
        assert _served_as_declared(cfg, p.identity), (cfg.backend, p.identity)
        assert p.corpus_dtype == cfg.corpus_dtype, (cfg, p.corpus_dtype)
        if cfg.backend in ("reference", "streaming", "pallas") and cfg.corpus_dtype == "float32":
            assert p.recall == 1.0, f"exact f32 genome {cfg} recall@10 {p.recall}"
    c = result.counts
    assert c["pruned"] + c["measured"] == c["generated"], c
    recorded = {cfg.key(): p for cfg, p in measured}
    replayed = []
    again = autotune(lambda cfg: replayed.append(cfg) or recorded[cfg.key()], **kw)
    assert replayed == [cfg for cfg, _ in measured], "the search is not repeatable on the same numbers"
    assert again.counts == c
    served_b3 = sum(got["beam_hop"] for cfg, _, _, got in rows if cfg.backend == "graph_ann")
    served_b4 = sum(got["fused_score"] for cfg, _, _, got in rows if cfg.backend == "napp")
    if on_card:
        assert served_b3 > 0 and served_b4 > 0, (served_b3, served_b4)

    # the batch axis: the pallas genome at batch 1, 16, 64 and 128, measured against its proxy
    axis = []
    for bs in (1, 16, 64, 128):
        cfg = ServingConfig(backend="pallas", batch_size=bs, max_wait_s=0.002)
        p = measure(cfg)
        axis.append((bs, p, proxy_objectives(cfg, n_docs=n, dim=d, k=k)[0]))
    proxy_rank = np.argsort([x[2] for x in axis]).tolist()

    # B2 against its plain version at the shapes the served pallas genomes gave it: the
    # batch (a batch closes padded to its size), the residency dtype, a shard's rows
    b2_shapes = sorted({(cfg.batch_size, cfg.corpus_dtype, cfg.n_shards) for cfg, p, _, _ in rows
                        if cfg.backend == "pallas" and p is not None})
    for bs, dt, shards in b2_shapes:
        resident = corpus if dt == "float32" else cast_corpus(corpus, canonical_dtype(dt))
        part = resident
        if shards > 1:
            sharded = ShardedPipeline.from_corpus(tuned_space, resident, shards, backend="cuda", cand_qty=k,
                                                  final_qty=k)
            part = sharded.shards[-1].corpus
            sharded.close()
        want = (oracle_s[:bs], oracle[:bs]) if part is corpus else plain_topk(part, bs)
        check("fused_topk", f"autotune pallas genome B={bs} {dt} shard of {part.dense.shape[0]} rows",
              tuple(CudaBackend().topk(tuned_space, take(0, bs), part, k)), want, exact_ids=False)
        del resident, part
    measured_rank = np.argsort([x[1].qps if x[1] else 0.0 for x in axis]).tolist()

    def show(cfg, p, secs, got):
        genes = {f: getattr(cfg, f) for f in ("backend", "corpus_dtype", "n_shards", "batch_size", "max_wait_s",
                                              "cache_size", "max_queue", "overload", "tile_n", "ef", "hops",
                                              "kernel", "num_search", "rerank_qty")
                 if getattr(cfg, f) not in (None, False)}
        if p is None:
            return f"{genes} -> served nothing ({secs:.1f} s)"
        return (f"{genes} -> qps {p.qps:.1f}, p50 {p.p50_ms:.2f} ms, p99 {p.p99_ms:.2f} ms, recall@10 "
                f"{p.recall:.4f}, identity {p.identity} ({secs:.1f} s; launches "
                + ", ".join(f"{name} {x}" for name, x in got.items() if x) + ")")

    log(f"phase autotune: n={n} fused (the graph recall corpus), {AUTOTUNE_QUERIES} queries, workload "
        f"{AUTOTUNE_REQUESTS} requests x 2 passes (repeat fraction {repeat_fraction:.3f}), {AUTOTUNE}; "
        + "; ".join(gen_log) + f"; counts {c}; explore genomes pruned by the proxy and measured after the "
        f"search: {len(extra)}; graph builds {builds['graph_ann']}, NAPP builds {builds['napp']}; the replay "
        f"on the first run's numbers measured the same {len(replayed)} genomes in the same order")
    for cfg, p, secs, got in rows[:len(rows) - len(axis)]:
        log("  measured " + show(cfg, p, secs, got))
    everything = pareto_front([p for _, p, _, _ in rows if p is not None])
    for label, front in (("the search's front", result.front), ("front of every measured genome", everything)):
        for p in front:
            log(f"  {label}: {p.config.backend} b={p.config.batch_size} {p.config.corpus_dtype}: qps "
                f"{p.qps:.1f}, p50 {p.p50_ms:.2f} ms, p99 {p.p99_ms:.2f} ms, recall@10 {p.recall:.4f}")
    for bs in (64, 128):
        at = [p for p in result.archive if p.config.batch_size == bs]
        best = max(at, key=lambda p: p.qps) if at else None
        log(f"  the search at batch {bs}: " + (show(best.config, best, 0.0, {}) if best else
                                               "no measured genome at this batch size"))
    log(f"  batch axis (pallas f32, max_wait 2 ms): " + ", ".join(
        f"b={bs} qps {p.qps:.1f} (proxy {px:.1f}), p99 {p.p99_ms:.2f} ms" if p else f"b={bs} served nothing"
        for bs, p, px in axis)
        + f"; proxy qps rank {proxy_rank}, measured rank {measured_rank} (not gated); B2 held against the "
        f"plain fused scan at (batch, dtype, shards) {b2_shapes}; recall oracle: the plain fused scan "
        f"({oracle_secs:.1f} s); served B3 launches "
        f"{served_b3}, B4 launches {served_b4}; the phase's launches {launches}; phase "
        f"{time.perf_counter() - t_phase:.1f} s; {card}")
    return launches


def recsys_batch(torch, cfg, b, g, dev, n_cand=0):
    """``tests/test_models_smoke.py``'s ``_recsys_batch`` on ``dev`` from
    ``g``: single-valued fields in [0, vocab), multi-hot ones in [0, vocab]
    (the pad id included), target items in [0, item_vocab); each user's
    history holds a uniform number of real items in [0, seq_len], the
    rest pads (so that some histories are all padding); ``n_cand`` random
    candidate items a user."""
    from repro_torch.models.recsys import RecBatch

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev, dtype=torch.int32)

    fields = {f.name: ints(0, f.vocab + 1, (b, f.multi_hot)) if f.multi_hot > 1 else ints(0, f.vocab, (b,))
              for f in cfg.fields}
    history = None
    if cfg.seq_len:
        history = ints(0, cfg.item_vocab, (b, cfg.seq_len))
        real = ints(0, cfg.seq_len + 1, (b, 1))
        history[torch.arange(cfg.seq_len, device=dev)[None] >= real] = cfg.item_vocab
    target = ints(0, cfg.item_vocab, (b,)) if cfg.item_vocab else None
    candidates = ints(0, cfg.item_vocab, (b, n_cand)) if n_cand else None
    return RecBatch(fields, history, target, ints(0, 2, (b,)).float(), candidates)


def chunked_library_topk(torch, q, corpus, k, rows=1 << 22):
    """The library call for B1's function: ``torch.topk(q @ c.T)`` over row
    chunks (a bf16 chunk widened to f32 first), then over the chunks' bests."""
    parts_s, parts_i = [], []
    for r0 in range(0, corpus.shape[0], rows):
        s, i = torch.topk(q @ corpus[r0:r0 + rows].float().T, k)
        parts_s.append(s)
        parts_i.append(i + r0)
    s, p = torch.topk(torch.cat(parts_s, 1), k)
    return s, torch.gather(torch.cat(parts_i, 1), 1, p)


def served_equals_offline(torch, recorder, got, tokens, on_card):
    """Every recorded served batch run again offline on its own inputs must
    equal its answer in ids and score bits, and every answer must be its
    request's row of its batch (found by its tokens).  Returns the batches
    held."""
    sync(torch, on_card)          # the copies were made on the worker's stream
    rows = {}
    for q, tok, out in recorder.batches:
        again = recorder.funnel.run(q, tok)
        assert torch.equal(again.indices, out.indices) and torch.equal(
            again.scores.float().view(torch.int32), out.scores.float().view(torch.int32)), \
            "a served batch differs from its offline run on the same inputs"
        s, i = out.scores.float().cpu().numpy(), out.indices.cpu().numpy()
        for r, t in enumerate(tok.cpu().numpy()):
            rows.setdefault(t.tobytes(), (s[r], i[r]))
    for n, (row, tok) in enumerate(zip(got, tokens)):
        want = rows[tok.numpy().tobytes()]
        assert same_row((np.asarray(row.scores), np.asarray(row.indices)), want), f"served answer {n} differs"
    return len(recorder.batches)


def recsys_full_phase(torch, dev, check, card, on_card, seed, timer, cfg=None, others=None):
    """DIN as published (``configs/din.py``: embed 18, history 100, 100M
    items; 8.0 GB of f32 tables drawn on the card from ``seed``) serving
    the candidate generation of ``examples/recsys_candidates.py``.  Offline,
    on batches of RECSYS["b"] users: the user query (``user_query``),
    B1 (``mips_topk``) over the item table in f32 and bf16 and B2
    (``fused_topk``) over the items with one tag each, through
    ``BruteForceGenerator`` on the ``cuda`` backend, each held against its
    plain version (ids up to near-ties: the random tables plant no margin),
    and ``retrieval_scores`` at the retrieval_cand shape; the user tower
    and ``retrieval_scores`` held against the CPU on a copy of the weights.
    Served: the example's funnel (bf16 B1, tag fusion, exact f32 rescore)
    on one endpoint, RECSYS["served"] users from RECSYS["clients"] clients,
    every answer equal to its batch's offline run.  Then ``forward_logits``
    of each of ``others`` (default: wide-deep, dien, bst as published) at a
    batch of RECSYS_OTHER_B, against the same run in f64.  ``cfg`` and
    ``others`` (configs) cut the models for a CPU rehearsal.  Returns the
    launches by kernel of the offline and served paths."""
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import BruteForceGenerator
    from repro_torch.core.sparse import SparseVectors
    from repro_torch.core.spaces import DenseSpace, FusedSpace, FusedVectors
    from repro_torch.distributed.sharding import ParallelCtx
    from repro_torch.kernels import fused_topk as fk
    from repro_torch.kernels import mips_topk as mk
    from repro_torch.kernels import ref as plain
    from repro_torch.models import recsys as R
    from repro_torch.serving import EndpointSpec, FunnelPipeline, RetrievalService, StageBudget

    t_phase = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9 if on_card else float("nan")
    cfg = get_config(RECSYS["arch"]) if cfg is None else cfg
    others = [get_config(a) for a in RECSYS_OTHERS] if others is None else others
    b, k, tags, ut = RECSYS["b"], RECSYS["k"], RECSYS["tags"], RECSYS["user_tags"]
    d, n = cfg.embed_dim, cfg.item_vocab
    ctx = ParallelCtx(None, cfg.rules)
    t0 = time.perf_counter()
    model, _ = R.init_recsys(cfg, seed=seed, device=dev)
    model.requires_grad_(False)
    sync(torch, on_card)
    init_s = time.perf_counter() - t0
    table_gb = sum(t.numel() * t.element_size() for t in model.tables.values()) / 1e9
    item = model.tables["item"]
    g = torch.Generator(dev).manual_seed(seed)
    batches = [recsys_batch(torch, cfg, b, g, dev) for _ in range(RECSYS["served"] // b)]
    tag_idx = torch.randint(0, tags, (n, 1), generator=g, device=dev, dtype=torch.int32)
    tag_val = torch.ones(n, 1, device=dev)
    user_tags = [torch.randint(0, tags, (b, ut), generator=g, device=dev, dtype=torch.int32) for _ in batches]
    user_one = torch.ones(b, ut, device=dev)
    cand_batch = recsys_batch(torch, cfg, 1, g, dev, n_cand=min(RECSYS["cand"], n))
    space = FusedSpace(tags, RECSYS["w_dense"], RECSYS["w_sparse"])
    items = FusedVectors(item, SparseVectors(tag_idx, tag_val))
    dense_gen = BruteForceGenerator(DenseSpace("ip"), item, backend="cuda")
    fused_gen = BruteForceGenerator(space, items, backend="cuda")
    counters = {"mips_topk": mk, "fused_topk": fk}

    # ---- the offline path, counted: queries, B1 f32 and bf16, B2, the retrieval_cand shape
    for m in counters.values():
        m.launches = 0
    mk.ring_launches = mk.scan_launches = 0
    with torch.no_grad():
        tower_s, uq = [], []
        for batch in batches:
            sync(torch, on_card)
            t0 = time.perf_counter()
            uq.append(R.user_query(model, cfg, batch, ctx))
            sync(torch, on_card)
            tower_s.append(time.perf_counter() - t0)
        q0 = uq[0]
        assert q0.shape == (b, d) and bool(torch.isfinite(q0).all())
        t0 = time.perf_counter()
        b1 = dense_gen.generate(q0, k)
        sync(torch, on_card)
        b1_s = time.perf_counter() - t0
        gen16 = dense_gen.with_corpus_dtype("bfloat16")
        item16 = gen16.corpus
        t0 = time.perf_counter()
        b1_16 = gen16.generate(q0, k)
        sync(torch, on_card)
        b1_16_s = time.perf_counter() - t0
        users0 = FusedVectors(q0, SparseVectors(user_tags[0], user_one))
        t0 = time.perf_counter()
        b2 = fused_gen.generate(users0, k)
        sync(torch, on_card)
        b2_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rs = R.retrieval_scores(model, cfg, cand_batch, ctx, k)
        sync(torch, on_card)
        rs_s = time.perf_counter() - t0
    offline = {name: m.launches for name, m in counters.items()}
    routes = (mk.ring_launches, mk.scan_launches)
    if on_card:
        assert offline == {"mips_topk": 2, "fused_topk": 1}, offline
        assert routes == (0, 2), f"B1 at D = 18 did not take the scan route: ring, scan {routes}"

    # the kernels against their plain versions (ids up to near-ties: random tables plant no margin)
    check("mips_topk", "recsys full: DIN items f32 k=100", tuple(b1),
          plain.mips_topk_ref(q0, item, k, tile_n=1 << 22), exact_ids=False)
    check("mips_topk", "recsys full: DIN items bf16 k=100", tuple(b1_16),
          plain.mips_topk_ref(q0, item16, k, tile_n=1 << 22), exact_ids=False)
    qtable = plain.query_table(users0.sparse, tags)
    w = dict(w_dense=space.w_dense, w_sparse=space.w_sparse)
    check("fused_topk", "recsys full: DIN items + 50 tags k=100", tuple(b2),
          plain.fused_topk_table_ref(qtable, q0, tag_idx, tag_val, item, k, tile_n=1 << 22, **w), exact_ids=False)
    match = lambda ids: float((tag_idx[ids.long(), 0] == user_tags[0][:, :1]).float().mean())
    tag_match = (match(b1.indices), match(b2.indices))
    assert tag_match[1] >= tag_match[0], f"fusion lowered the tag-match rate: {tag_match}"
    assert rs[0].shape == (1, k) and bool(torch.isfinite(rs[0]).all())

    # ---- the card against the CPU on a copy of the weights: the user tower and retrieval_scores
    t0 = time.perf_counter()
    cpu_model, _ = R.init_recsys(cfg, device="meta")
    cpu_model = cpu_model.to_empty(device="cpu")
    cpu_model.load_state_dict(model.state_dict())

    def host(batch):
        return R.RecBatch({f: v.cpu() for f, v in batch.fields.items()},
                          *(None if x is None else x.cpu() for x in batch[1:]))

    with torch.no_grad():
        u_card = R.user_tower(model, cfg, batches[0], ctx)
        u_cpu = R.user_tower(cpu_model, cfg, host(batches[0]), ctx)
        rs_cpu = R.retrieval_scores(cpu_model, cfg, host(cand_batch), ctx, k)
    check.scores("recsys", "recsys full: user tower card vs cpu", u_card.cpu(), u_cpu)
    check("recsys", "recsys full: retrieval_scores card vs cpu", tuple(rs), rs_cpu, exact_ids=False)
    tower_err = float(((u_card.cpu() - u_cpu).abs() / u_cpu.abs().amax(1, keepdim=True)).max())
    del cpu_model, u_cpu, rs_cpu
    cpu_s = time.perf_counter() - t0

    # ---- served: the example's funnel on one endpoint (bf16 B1 candidates, tag fusion, exact f32 rescore)
    funnel = FunnelPipeline(BruteForceGenerator(DenseSpace("ip"), item, backend="cuda"),
                            fusion=R.TagFusion(tag_idx[:, 0], d, RECSYS["w_sparse"]),
                            rerank=R.ExactRescore(item, d), cand_qty=RECSYS["cand_qty"],
                            fusion_qty=RECSYS["fusion_qty"], rerank_keep=RECSYS["keep"])
    del gen16, item16
    funnel = funnel.with_corpus_dtype("bfloat16").with_budget(StageBudget(rerank_s=5.0))
    recorder = BatchRecorder(funnel)
    queries = [row for x in uq for row in x.cpu()]
    tokens = [row for x, t in zip(uq, user_tags) for row in torch.cat([x, t.float()], 1).cpu()]
    pad, pad_tok = torch.zeros(d, device=dev), torch.zeros(d + ut, device=dev)
    before = {name: m.launches for name, m in counters.items()}
    with RetrievalService(cache_size=0) as svc:
        svc.register_pipeline("recs", recorder, pad, pad_tok,
                              spec=EndpointSpec(batch_size=b, max_wait_s=0.005, max_queue=128, overload="block"))
        box = {}

        def run():
            box["out"] = flood(svc, "recs", queries, tokens, RECSYS["clients"])

        idle = "not measured"
        if on_card:
            groups, span_ms, _ = device_profile(torch, run)
            if groups:
                idle = f"{max(0.0, 1.0 - sum(groups.values()) / span_ms):.3f}"
        else:
            run()
        got, wall = box["out"]
        ep = svc.snapshot().endpoints["recs"]
    served = {name: m.launches - before[name] for name, m in counters.items()}
    launches = {name: offline[name] + served[name] for name in counters}
    assert ep.corpus_dtype == "bfloat16" and ep.stage_fallbacks["rerank"] == 0 and ep.n_requests == len(queries)
    if on_card:
        assert served["mips_topk"] == ep.n_batches, f"served B1 launches {served} for {ep.n_batches} batches"
    held = served_equals_offline(torch, recorder, got, tokens, on_card)
    served_ids = np.stack([np.asarray(r.indices) for r in got])
    all_tags = torch.cat(user_tags).cpu().numpy()
    tag_served = float(np.mean(tag_idx[:, 0].cpu().numpy()[served_ids] == all_tags[:, :1]))

    # ---- timings (CUDA events, median): B1 at B = 16 and 1, f32 and bf16, against the byte bound and the
    # library call; B2; the tower; retrieval_scores
    item16 = item.bfloat16()
    q1 = q0[:1].contiguous()
    b1_ms, lib_ms, plain_ms, bounds = {}, {}, {}, {}
    for dt, corpus in (("f32", item), ("bf16", item16)):
        for bq, qq in ((b, q0), (1, q1)):
            b1_ms[dt, bq] = timer(lambda: mk.mips_topk(qq, corpus, k), 5)
            lib_ms[dt, bq] = timer(lambda: chunked_library_topk(torch, qq, corpus, k), 3)
            nbytes = corpus.numel() * corpus.element_size() + bq * d * 4 + bq * k * 8
            t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, 2 * bq * n * d / F32_FLOPS * 1e3
            bounds[dt, bq] = (t_b, "bytes") if t_b >= t_o else (t_o, "operations")
        plain_ms[dt] = timer(lambda: plain.mips_topk_ref(q0, corpus, k, tile_n=1 << 22), 1)
    del item16
    b2_ms = timer(lambda: fk.fused_topk(qtable, q0, tag_idx, tag_val, item, k, **w), 5)
    b2_plain = timer(lambda: plain.fused_topk_table_ref(qtable, q0, tag_idx, tag_val, item, k, tile_n=1 << 22, **w), 1)
    b2_bytes = n * d * 4 + n * 8 + b * d * 4 + b * (tags + 1) * 4 + b * k * 8
    b2_ops = 2 * (b * n * d + sparse_fmas(torch, qtable, tag_idx)) + 3 * b * n
    b2_bound = max(b2_bytes / HBM_BYTES_PER_S, b2_ops / F32_FLOPS) * 1e3
    with torch.no_grad():
        tower_ms = timer(lambda: R.user_query(model, cfg, batches[0], ctx), 5)
        rs_ms = timer(lambda: R.retrieval_scores(model, cfg, cand_batch, ctx, k), 5)
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else float("nan")
    ms = lambda xs: 1e3 * statistics.median(xs)
    log(f"phase recsys full: {cfg.name} (embed {d}, history {cfg.seq_len}, attention MLP "
        f"{'-'.join(map(str, cfg.attn_mlp))}, MLP {'-'.join(map(str, cfg.mlp))}, {n:,} items, fields "
        + ", ".join(f"{f.name} {f.vocab:,}" for f in cfg.fields)
        + f", {cfg.dtype}), {table_gb:.2f} GB of tables drawn on {dev} in {init_s:.2f} s from seed {seed}; "
        f"{len(batches)} batches of {b} users (histories of a uniform 0..{cfg.seq_len} real items, pads after)")
    log(f"  offline (host clock, synchronised): user tower + projection median {ms(tower_s):.3f} ms/batch; "
        f"B1 f32 {1e3 * b1_s:.3f} ms, bf16 {1e3 * b1_16_s:.3f} ms, B2 (FusedSpace({tags}, {space.w_dense}, "
        f"{space.w_sparse}), one tag an item, {ut} a user) {1e3 * b2_s:.3f} ms, retrieval_scores (1 user, "
        f"{cand_batch.candidates.shape[1]:,} candidates, k={k}) {1e3 * rs_s:.3f} ms; launches {offline} (B1 ring, scan "
        f"route {routes}); B1 f32 and bf16 and B2 equal their plain versions (tolerance {TOL_REL} of row "
        f"scale, ids up to near-ties); tag-match rate of the top-{k}: dense {tag_match[0]:.3f}, fused "
        f"{tag_match[1]:.3f}; card vs cpu (weights copied in {cpu_s:.1f} s): user tower worst {tower_err:.3g} of "
        f"row scale, retrieval_scores scores within {TOL_REL} of row scale, ids up to near-ties")
    log(f"  timings (CUDA events, median of 5; library of 3; plain 1): "
        + "; ".join(f"B1 {dt} B={bq} {b1_ms[dt, bq]:.3f} ms vs bound {bounds[dt, bq][0]:.3f} ms "
                    f"({bounds[dt, bq][1]}), library {lib_ms[dt, bq]:.3f} ms" for dt, bq in b1_ms)
        + f"; plain B1 f32 {plain_ms['f32']:.3f} ms, bf16 {plain_ms['bf16']:.3f} ms; B2 B={b} {b2_ms:.3f} ms vs "
        f"bound {b2_bound:.3f} ms ({b2_bytes / 1e9:.2f} GB), plain {b2_plain:.3f} ms; user tower + projection "
        f"{tower_ms:.3f} ms/batch; retrieval_scores {rs_ms:.3f} ms; {card}")
    e2e = ep.e2e
    log(f"  served funnel (bf16 B1 top {RECSYS['cand_qty']} -> tag fusion top {RECSYS['fusion_qty']} -> exact f32 "
        f"rescore top {RECSYS['keep']}; {RECSYS['clients']} clients, {len(queries)} users, no cache): "
        f"{len(queries) / wall:.1f} qps, e2e p50 {e2e.p50_ms:.3f} ms p99 {e2e.p99_ms:.3f} ms, exec "
        f"{ep.execute.p50_ms:.3f} ms/batch (p50), stages "
        + " ".join(f"{s} {ep.stages[s].p50_ms:.3f}" for s in ("candgen", "fusion", "rerank"))
        + f" ms (p50), {ep.n_batches} batches (fill {ep.mean_batch_fill:.3f}), idle {idle}; every answer equals "
        f"its batch's offline run in ids and score bits ({held} batches run again); tag-match {tag_served:.3f}; "
        f"launches {served}; peak {peak:.2f} GB allocated ({held_gb:.2f} GB held at the phase's start)")
    del svc, funnel, recorder, dense_gen, fused_gen, items, model, item, tag_idx, tag_val, batches, uq, b1, b1_16, b2
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # ---- the other kinds as published, one at a time: forward_logits at serve_p99's batch against f64
    for ocfg in others:
        import copy

        t0 = time.perf_counter()
        om, _ = R.init_recsys(ocfg, seed=seed, device=dev)
        om.requires_grad_(False)
        ob = recsys_batch(torch, ocfg, RECSYS_OTHER_B, g, dev)
        octx = ParallelCtx(None, ocfg.rules)
        with torch.no_grad():
            logits = R.forward_logits(om, ocfg, ob, octx)
            o_ms = timer(lambda: R.forward_logits(om, ocfg, ob, octx), 3)
            om64 = copy.deepcopy(om).double()
            l64 = R.forward_logits(om64, ocfg, ob, octx)
        assert logits.shape == (RECSYS_OTHER_B,) and bool(torch.isfinite(logits).all())
        ratio = float((logits.double() - l64).abs().max() / l64.abs().max().clamp_min(1e-30))
        assert ratio <= TOL_REL, f"recsys full: {ocfg.name} f32 vs f64 {ratio:.3g} of the batch's largest |logit|"
        gb = sum(t.numel() * t.element_size() for t in om.parameters()) / 1e9
        log(f"  {ocfg.name} ({ocfg.kind}, embed {ocfg.embed_dim}, {len(ocfg.fields)} fields, {ocfg.item_vocab:,} "
            f"items, {gb:.2f} GB): forward_logits B={RECSYS_OTHER_B} {o_ms:.3f} ms/batch (CUDA events, median of 3); "
            f"f32 vs f64 worst {ratio:.3g} of the batch's largest |logit| (bound {TOL_REL}); "
            f"{time.perf_counter() - t0:.1f} s")
        del om, om64, ob, logits, l64
        if on_card:
            torch.cuda.empty_cache()
    log(f"  phase {time.perf_counter() - t_phase:.1f} s; {card}")
    return launches


def schnet_flops(cfg, atoms, edges):
    """Operations of ``molecule_embeddings``' network on ``atoms`` nodes and
    ``edges`` edges: per interaction the filter network on every edge (the
    radial basis [E, n_rbf] times [n_rbf, d], then [d, d]), the message
    product, and the three atom-wise [d, d] layers, 2 a multiply-add."""
    d, r = cfg.d_hidden, cfg.n_rbf
    per = 2 * edges * (r * d + d * d) + edges * d + 3 * 2 * atoms * d * d
    return cfg.n_interactions * per


def molecule_full_phase(torch, dev, check, card, on_card, seed, timer, cfg=None, mols=None):
    """SchNet as published (``configs/schnet.py``: 3 interactions, d 64,
    300 radial bases, cutoff 10, random weights from ``seed``) embedding
    MOLECULE["mols"] molecules of MOLECULE["atoms"] atoms (perturbed copies,
    sigma MOLECULE["sigma"], of MOLECULE["families"] template families, as
    ``examples/molecule_retrieval.py`` makes them, on the card) in batches
    of MOLECULE["batch"]: each molecule's ``radius_graph`` (k 6), the
    network, mean ++ std pooling, L2-normalised (``molecule_embeddings``);
    batch 0 held against the CPU port on the same weights.  Over the
    normalised 64-d mean halves in ip space (cosine's ranking on unit
    vectors, which the kernels do not serve), an NN-descent graph (degree
    16, 6 rounds, MOLECULE_ENTRIES entry ids) searched at ef 64 through B3
    (``GraphANNBackend(kernel=True)``; its entry set scored by B1) for
    MOLECULE["queries"] corpus molecules: recall@10 against B1's exact scan;
    one traversal replayed hop by hop against the plain hop.  Served: the
    example's funnel (graph-ANN candidates on the half, rescored by the
    full vector) on one endpoint, every answer equal to its batch's offline
    run.  ``cfg`` and ``mols`` cut the model and the corpus for a CPU
    rehearsal.  Returns the launches by kernel of the search and served
    paths, and B3's numbers at this shape."""
    from repro_torch.configs import get_config
    from repro_torch.core import graph_ann
    from repro_torch.core.backends import (ANN_RECALL_TARGET, CudaBackend, GraphANNBackend,
                                           clear_ann_index_cache)
    from repro_torch.core.fusion import topk_recall
    from repro_torch.core.pipeline import BruteForceGenerator
    from repro_torch.core.spaces import DenseSpace
    from repro_torch.distributed.sharding import ParallelCtx
    from repro_torch.kernels import beam_topk as bk
    from repro_torch.kernels import mips_topk as mk
    from repro_torch.kernels import ref as plain
    from repro_torch.models import schnet as S
    from repro_torch.serving import EndpointSpec, FunnelPipeline, RetrievalService, StageBudget

    t_phase = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9 if on_card else float("nan")
    cfg = get_config("schnet") if cfg is None else cfg
    m_total = MOLECULE["mols"] if mols is None else mols
    a, fams, kg, mb = MOLECULE["atoms"], MOLECULE["families"], MOLECULE["k_graph"], MOLECULE["batch"]
    ctx = ParallelCtx(None, cfg.rules)
    model, _ = S.init_schnet(cfg, seed=seed, device=dev)
    model.requires_grad_(False)
    g = torch.Generator(dev).manual_seed(seed)
    templates = torch.randn(fams, a, 3, generator=g, device=dev) * 3.0
    types = torch.randint(1, 10, (fams, a), generator=g, device=dev, dtype=torch.int32)
    fam = torch.randint(0, fams, (m_total,), generator=g, device=dev)
    pos = templates[fam] + torch.randn(m_total, a, 3, generator=g, device=dev) * MOLECULE["sigma"]
    z = types[fam]

    # ---- embedding, batch by batch
    emb = torch.empty(m_total, 2 * cfg.d_hidden, device=dev)
    sync(torch, on_card)
    t0 = time.perf_counter()
    with torch.no_grad():
        for lo in range(0, m_total, mb):
            emb[lo:lo + mb] = S.molecule_embeddings(model, pos[lo:lo + mb], z[lo:lo + mb], cfg, ctx, k=kg)
    sync(torch, on_card)
    embed_s = time.perf_counter() - t0
    assert bool(torch.isfinite(emb).all())
    flops = schnet_flops(cfg, m_total * a, m_total * a * kg)
    embed_bound_s = flops / F32_FLOPS
    # batch 0 against the CPU port on the same weights
    t0 = time.perf_counter()
    cpu_model, _ = S.init_schnet(cfg, device="meta")
    cpu_model = cpu_model.to_empty(device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    with torch.no_grad():
        emb_cpu = S.molecule_embeddings(cpu_model, pos[:mb].cpu(), z[:mb].cpu(), cfg, ctx, k=kg)
    check.scores("schnet", "molecule full: embeddings card vs cpu", emb[:mb].cpu(), emb_cpu)
    emb_err = float(((emb[:mb].cpu() - emb_cpu).abs() / emb_cpu.abs().amax(1, keepdim=True)).max())
    cpu_s = time.perf_counter() - t0
    del cpu_model, emb_cpu

    # ---- search over the normalised mean halves in ip space
    half = emb[:, :cfg.d_hidden]
    half = half / half.norm(dim=1, keepdim=True).clamp_min(1e-9)
    space = DenseSpace("ip")
    qid = torch.arange(MOLECULE["queries"], device=dev) * (m_total // MOLECULE["queries"])
    q_half, q_full = half[qid], emb[qid]
    backend = GraphANNBackend(kernel=True, degree=GRAPH["degree"], rounds=6, ef=GRAPH["ef"],
                              entry_count=min(MOLECULE_ENTRIES, m_total))
    t0 = time.perf_counter()
    search_corpus, index = backend._index(space, half, m_total)
    sync(torch, on_card)
    build_s = time.perf_counter() - t0
    same_family = float((fam[index.neighbors.long()] == fam[:, None]).float().mean())
    counters = {"mips_topk": mk, "beam_hop": bk}
    for m in counters.values():
        m.launches = 0
    t0 = time.perf_counter()
    ann = backend.topk(space, q_half, half, 10)
    sync(torch, on_card)
    search_s = time.perf_counter() - t0
    exact = CudaBackend().topk(space, q_half, half, 10)
    searched = {name: m.launches for name, m in counters.items()}
    plain_ann = graph_ann.beam_search(space, q_half, search_corpus, index, m_total, k=10, ef=GRAPH["ef"])
    check("mips_topk", "molecule full: exact top-10 of the half-embeddings", tuple(exact),
          plain.mips_topk_ref(q_half, half, 10, tile_n=1 << 20), exact_ids=False)
    # recall@10: strict (ids), and counting a returned row whose exact score lies within TOL_REL of the row
    # scale of the exact 10th (the near-tie rule of the Checker: family members score within a few ULPs)
    strict, strict_plain = topk_recall(exact.indices, ann.indices), topk_recall(exact.indices, plain_ann.indices)

    def near_recall(got):
        s = space.score_pairs(q_half.repeat_interleave(10, 0), half[got.indices.reshape(-1).long()]).reshape(-1, 10)
        floor = exact.scores[:, 9:10] - TOL_REL * exact.scores.abs().amax(1, keepdim=True)
        return float((s >= floor).float().mean())

    recall, recall_plain = near_recall(ann), near_recall(plain_ann)
    gap = float((exact.scores[:, 8] - exact.scores[:, 9]).median())
    fam_prec = lambda ids: float((fam[ids[:, 1:6].long()] == fam[qid][:, None]).float().mean())
    precision = (fam_prec(exact.indices), fam_prec(ann.indices))
    assert recall >= ANN_RECALL_TARGET and recall_plain >= ANN_RECALL_TARGET, (recall, recall_plain)

    # ---- one traversal (batch of 32 queries) timed by CUDA events and replayed hop by hop through beam_hop,
    # each hop against the plain hop
    hops = graph_ann.default_hops(m_total)
    orig, rec = bk.beam_search, []

    def timed(*args, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if on_card else None
        if on_card:
            torch.cuda._sleep(SLEEP_CYCLES)
            ev[0].record()
        out = orig(*args, **kw)
        if on_card:
            ev[1].record()
        rec.append((ev, args, kw, out))
        return out

    bk.beam_search = timed
    try:
        for _ in range(4):
            backend.topk(space, q_half[:MOLECULE["served_b"]], half, 10)
        sync(torch, on_card)
    finally:
        bk.beam_search = orig
    b3_ms = statistics.median(ev[0].elapsed_time(ev[1]) for ev, _, _, _ in rec[1:]) if on_card else float("nan")
    ev, args, kw, out = rec[-1]
    kw = {key: val for key, val in kw.items() if key != "hops"}
    beam_s, beam_i, vis = args[2], args[3], args[4].clone()
    valid, b3_plain = 0, 0.0
    for h in range(hops):
        hop_args = (args[0], args[1], beam_s, beam_i, vis, *args[5:])
        got = bk.beam_hop(*hop_args, **kw)
        pe = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if on_card else None
        if on_card:
            pe[0].record()
        want = plain.beam_hop_plain(*hop_args, **kw)
        if on_card:
            pe[1].record()
            pe[1].synchronize()
            b3_plain += pe[0].elapsed_time(pe[1])
        check.hop(f"molecule full hop {h}", got, want, exact_ids=False)
        valid += int((got[3] != 0).sum())
        beam_s, beam_i = got[0], got[1]
        vis.scatter_add_(1, got[2].long(), got[3])
    for what, x, y in (("scores", out[0], beam_s), ("ids", out[1], beam_i), ("mask", out[2], vis)):
        assert torch.equal(x, y), f"molecule full: the traversal and its replay differ in {what}"
    d_half, slots = cfg.d_hidden, hops * MOLECULE["served_b"] * GRAPH["ef"] * GRAPH["degree"]
    t_b = (valid * d_half * 4 + slots * 8) / HBM_BYTES_PER_S * 1e3
    t_o = valid * 2 * d_half / F32_FLOPS * 1e3
    b3_bound = (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    # ---- served: graph-ANN candidates on the half, the full vector's rescore, one endpoint
    funnel = FunnelPipeline(BruteForceGenerator(space, half, backend=backend), rerank=S.FullRescore(emb),
                            cand_qty=MOLECULE["cand_qty"], fusion_qty=MOLECULE["cand_qty"],
                            rerank_keep=MOLECULE["keep"]).with_budget(StageBudget(rerank_s=5.0))
    recorder = BatchRecorder(funnel)
    queries, tokens = list(q_half.cpu()), list(q_full.cpu())
    pad, pad_tok = torch.zeros(d_half, device=dev), torch.zeros(2 * d_half, device=dev)
    before = {name: m.launches for name, m in counters.items()}
    with RetrievalService(cache_size=0) as svc:
        svc.register_pipeline("mols", recorder, pad, pad_tok,
                              spec=EndpointSpec(batch_size=MOLECULE["served_b"], max_wait_s=0.005, max_queue=128,
                                                overload="block"))
        box = {}

        def run():
            box["out"] = flood(svc, "mols", queries, tokens, MOLECULE["clients"])

        idle = "not measured"
        if on_card:
            groups, span_ms, _ = device_profile(torch, run)
            if groups:
                idle = f"{max(0.0, 1.0 - sum(groups.values()) / span_ms):.3f}"
        else:
            run()
        got, wall = box["out"]
        ep = svc.snapshot().endpoints["mols"]
    served = {name: m.launches - before[name] for name, m in counters.items()}
    launches = {name: searched[name] + served[name] for name in counters}   # not the timing and replay's
    assert ep.stage_fallbacks["rerank"] == 0 and ep.n_requests == len(queries)
    if on_card:
        assert served["beam_hop"] == ep.n_batches, f"served B3 launches {served} for {ep.n_batches} batches"
        assert searched == {"mips_topk": 2, "beam_hop": 1}, searched
    held = served_equals_offline(torch, recorder, got, tokens, on_card)
    served_ids = torch.from_numpy(np.stack([np.asarray(r.indices) for r in got])).to(dev)
    p_served = fam_prec(served_ids)
    search_ms = timer(lambda: backend.topk(space, q_half[:MOLECULE["served_b"]], half, 10), 5)
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else float("nan")
    log(f"phase molecule full: {cfg.name} ({cfg.n_interactions} interactions, d {cfg.d_hidden}, {cfg.n_rbf} radial "
        f"bases, cutoff {cfg.cutoff}, {cfg.dtype}) over {m_total:,} molecules of {a} atoms ({fams} families, "
        f"sigma {MOLECULE['sigma']}), radius_graph k {kg}, batches of {mb}: embedded in {embed_s:.2f} s (host "
        f"clock, synchronised) against an f32 bound of {embed_bound_s:.3f} s ({flops / 1e12:.2f} TFLOP at "
        f"{F32_FLOPS / 1e12:.0f} TFLOP/s: filter network, messages, atom-wise layers); batch 0 card vs cpu "
        f"(weights copied, cpu run {cpu_s:.1f} s) worst {emb_err:.3g} of row scale (bound {TOL_REL})")
    log(f"  search ({2 * cfg.d_hidden}-d embeddings, the {cfg.d_hidden}-d mean half normalised, ip): NN-descent "
        f"(degree {GRAPH['degree']}, 6 rounds, {backend.entry_count} entries) in {build_s:.1f} s, "
        f"{same_family:.4f} of the edges within a family; {len(qid)} queries, ef {GRAPH['ef']}, {hops} hops: "
        f"{1e3 * search_s:.3f} ms (host clock), a batch of {MOLECULE['served_b']} {search_ms:.3f} ms (CUDA events, "
        f"median of 5); recall@10 (a row within {TOL_REL} of row scale of the exact 10th counts) kernel "
        f"{recall:.4f}, plain traversal {recall_plain:.4f} (target {ANN_RECALL_TARGET}); strict id recall@10 kernel "
        f"{strict:.4f}, plain {strict_plain:.4f} (median gap of the exact 9th and 10th scores {gap:.3g}); "
        f"same-family precision@5 exact {precision[0]:.3f}, ANN {precision[1]:.3f}; launches {searched}")
    log(f"  B3 at this shape (B={MOLECULE['served_b']}, d {d_half}, ef {GRAPH['ef']}, {hops} hops; one traversal, "
        f"CUDA events, median of 3) {b3_ms:.4f} ms vs bound {b3_bound[0]:.4f} ms ({b3_bound[1]}: {valid} valid "
        f"candidates); plain hops {b3_plain:.3f} ms; each of the {hops} hops equals the plain hop (tolerance "
        f"{TOL_REL} of row scale, mark-deltas equal) and the one launch equals the replay bit for bit")
    e2e = ep.e2e
    log(f"  served funnel (graph-ANN top {MOLECULE['cand_qty']} on the half -> full-vector rescore top "
        f"{MOLECULE['keep']}; {MOLECULE['clients']} clients, {len(queries)} queries, batches of "
        f"{MOLECULE['served_b']}, no cache): {len(queries) / wall:.1f} qps, e2e p50 {e2e.p50_ms:.3f} ms p99 "
        f"{e2e.p99_ms:.3f} ms, exec {ep.execute.p50_ms:.3f} ms/batch (p50), {ep.n_batches} batches (fill "
        f"{ep.mean_batch_fill:.3f}), idle {idle}; every answer equals its batch's offline run in ids and score "
        f"bits ({held} batches run again); same-family precision@5 {p_served:.3f}; launches {served}; peak "
        f"{peak:.2f} GB allocated ({held_gb:.2f} GB held at the phase's start); phase "
        f"{time.perf_counter() - t_phase:.1f} s; {card}")
    b3 = {"ms": b3_ms, "plain_ms": b3_plain, "bound_ms": b3_bound[0], "bound_by": b3_bound[1]}
    del svc, funnel, recorder, emb, half, pos, z, model, index, search_corpus
    gc.collect()
    clear_ann_index_cache()
    if on_card:
        torch.cuda.empty_cache()
    return launches, b3


class DispatchRecorder:
    """Wraps ``models.moe.sort_dispatch`` while in use, keeping each call's
    bucket ids and validity (references only: no extra launch, no sync)."""

    def __init__(self, moe):
        self.moe, self.calls, self.dispatches = moe, [], []

    def __enter__(self):
        self.orig = self.moe.sort_dispatch

        def record(bucket_ids, token_ids, weights, n_buckets, capacity):
            disp = self.orig(bucket_ids, token_ids, weights, n_buckets, capacity)
            self.calls.append((bucket_ids, disp.valid, n_buckets, capacity))
            self.dispatches.append(disp)
            return disp

        self.moe.sort_dispatch = record
        return self

    def __exit__(self, *exc):
        self.moe.sort_dispatch = self.orig

    def take_ids(self):
        """[(bucket ids on the host, dropped pairs)] of the calls since the last take."""
        out = [(b.cpu(), int((~v).sum())) for b, v, _, _ in self.calls]
        self.calls, self.dispatches = [], []
        return out

    def take(self):
        """[(expert load, dropped pairs, capacity)] of the calls since the last take."""
        out = [(b.long().bincount(minlength=n)[:n].cpu(), int((~v).sum()), c) for b, v, n, c in self.calls]
        self.calls, self.dispatches = [], []
        return out


def lm_flops(cfg, tokens, seq, batch):
    """(tensor-core GEMM operations, f32 attention operations) of one
    prefill of ``batch`` sequences of ``seq`` tokens: the projections, the
    FFN or the top-k experts a token needs (2 a multiply-add, real heads
    only), the head at the last position; causal attention's S(S+1)/2
    query-key pairs a head, scores and values."""
    d, h = cfg.d_model, cfg.n_heads
    if cfg.attention == "mla":
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        attn = 2 * (d * qr + qr * h * (dn + dr) + d * (kvr + dr) + kvr * h * (dn + dv) + h * dv * d)
        dk = dn + dr
    else:
        dh = cfg.resolved_head_dim
        attn = 2 * (d * (h + 2 * cfg.n_kv_heads) * dh + h * dh * d)
        dk = dv = dh
    ffn = 3 * 2 * d * cfg.d_ff
    mlp = (cfg.top_k * 3 * 2 * d * cfg.moe_d_ff + 2 * d * cfg.n_experts
           + (ffn if cfg.dense_residual else 0)) if cfg.is_moe else ffn
    gemm = cfg.n_layers * tokens * (attn + mlp) + 2 * batch * d * cfg.padded_vocab
    pairs = batch * seq * (seq + 1) // 2
    return gemm, cfg.n_layers * 2 * h * (dk + dv) * pairs


def lm_weight_bytes(model, cfg, batch, hit=1.0):
    """Bytes a decode step must read of the weights: every block's (the
    experts' times the share ``hit`` of them that the step's tokens
    reached), the final norm, the head (the tied embedding whole) and,
    untied, the ``batch`` embedding rows."""
    blocks = experts = 0
    for bp in model.blocks:
        for name, p in bp.named_parameters():
            nbytes = p.numel() * p.element_size()
            if name.startswith("moe.w_"):
                experts += nbytes
            else:
                blocks += nbytes
    ln_f = sum(p.numel() * p.element_size() for p in model.ln_f.parameters())
    embed = model.embed.numel() * model.embed.element_size()
    head = embed if cfg.tie_embeddings else model.lm_head.numel() * model.lm_head.element_size()
    rows = 0 if cfg.tie_embeddings else batch * cfg.d_model * model.embed.element_size()
    return blocks + hit * experts + ln_f + head + rows


def lm_cache_bytes(cache, valid):
    """Bytes of ``valid`` positions of every layer's cache."""
    return sum(t[:, :, :valid].numel() * t.element_size() for t in cache if t is not None)


def row_err(torch, got, want):
    """Worst |got - want| of each row's largest |want|, over the finite entries of ``want``."""
    got, want = got.double().cpu(), want.double().cpu()
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got)), "finite entries differ"
    scale = torch.where(fin, want.abs(), 0).amax(-1, keepdim=True).clamp_min(1e-30)
    return float((torch.where(fin, (got - want).abs(), 0) / scale).max())


def lm_full_phase(torch, dev, card, on_card, seed, cfgs=None, shapes=None):
    """The repo's LM family through the port's inference path
    (``models/transformer.py``: ``prefill_step``, ``init_cache``,
    ``decode_step``; ``models/moe.py`` behind phi3.5-moe's blocks), random
    bf16 weights from ``seed`` on the card at published widths: qwen2.5-3b
    (36 layers) and minicpm3-4b (62, MLA) whole, phi3.5-moe at 16 of its 32
    layers.  For each: ``prefill_step`` on LM["prefill"] random tokens
    (CUDA events, median of 3, against its bf16 GEMM plus f32 attention
    FLOP bound); a decode loop over ``init_cache(cfg, 16, 4096)``, 32 prompt
    tokens fed one ``decode_step`` at a time from ``pos`` 0 then 32 greedy
    steps (each step by CUDA events; median against its byte bound), its
    top-1 at steps LM_TOP1_AT against ``prefill_step`` of the same tokens
    (printed); one step at ``decode_32k``'s length (``pos`` 32,767 of a
    32,768 cache, batch LM["long_b"], LM["long_b_moe"] with experts) against
    its bytes; LM["profiled"] more decode steps under the profiler.  Gated: finite
    logits; at f32 and 2 layers of full width, the card against the CPU
    (the same weights: prefill and LM["cpu_steps"] decode steps) and
    decode step t against ``prefill_step`` of t + 1 tokens for
    LM["dvp_steps"] steps at batch 16, within LM_TOL of each row's largest
    logit (with experts, only steps where no pair was dropped by capacity,
    in this step's or an earlier decode or in the prefill; drops printed).
    No kernel of the port is launched.  ``cfgs`` and ``shapes`` cut the
    configs and the shapes for a CPU rehearsal."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import ParallelCtx
    from repro_torch.kernels import beam_topk as bk, fused_topk as fk, mips_topk as mk, sparse_dense as sd
    from repro_torch.kernels import topk_large as lk
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    counters = {"mips_topk": mk, "fused_topk": fk, "topk_large": lk, "beam_hop": bk, "fused_score": sd}
    before = {name: m.launches for name, m in counters.items()}
    sh = dict(LM, **(shapes or {}))
    if cfgs is None:
        cfgs = [get_config(a) for a in LM_ARCHS]
        cfgs = [dataclasses.replace(c, n_layers=LM_MOE_LAYERS) if c.is_moe else c for c in cfgs]
    assert not (on_card and torch.backends.cuda.matmul.allow_tf32), "TF32 is on: f32 products would round to 10 bits"
    for cfg in cfgs:
        t_phase = time.perf_counter()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        full = get_config(cfg.name)
        reduced = [] if cfg.n_layers == full.n_layers else [f"depth {cfg.n_layers} of {full.n_layers} layers"]
        reduced.append(f"the long-context step's batch, {sh['long_b_moe' if cfg.is_moe else 'long_b']} of "
                       f"decode_32k's 128")
        ctx = ParallelCtx(None, cfg.rules)
        g = torch.Generator(dev).manual_seed(seed)
        t0 = time.perf_counter()
        model, _ = T.init_transformer(cfg, seed=seed, device=dev)
        model.requires_grad_(False)
        sync(torch, on_card)
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        rec = DispatchRecorder(M)
        with torch.no_grad(), rec:
            # ---- prefill
            pb, ps = sh["prefill"]
            ptok = torch.randint(0, cfg.vocab_size, (pb, ps), generator=g, device=dev)
            logits = T.prefill_step(model, ptok, cfg, ctx)
            assert logits.shape == (pb, cfg.padded_vocab) and bool(torch.isfinite(logits).all())
            prefill_ms = cuda_ms(torch, lambda: T.prefill_step(model, ptok, cfg, ctx), 3) if on_card else float("nan")
            prefill_moe = rec.take()
            gemm, attn = lm_flops(cfg, pb * ps, ps, pb)
            prefill_bound = (gemm / BF16_FLOPS + attn / F32_FLOPS) * 1e3

            # ---- the decode loop: a prompt fed token by token, then greedy steps
            b, smax, n_prompt, n_gen = sh["decode_b"], sh["decode_len"], sh["prompt"], sh["gen"]
            cache = T.init_cache(cfg, b, smax, device=dev)
            toks = torch.empty(b, n_prompt + n_gen, dtype=torch.long, device=dev)
            toks[:, :n_prompt] = torch.randint(0, cfg.vocab_size, (b, n_prompt), generator=g, device=dev)
            events, step_logits, finite = [], {}, torch.ones((), dtype=torch.bool, device=dev)
            for t in range(n_prompt + n_gen):
                if t >= n_prompt:
                    toks[:, t] = logits.argmax(-1)          # the first of equal maxima: ties to the lower id
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if on_card else None
                if on_card:
                    ev[0].record()
                logits, cache = T.decode_step(model, cache, toks[:, t:t + 1], t, cfg, ctx)
                if on_card:
                    ev[1].record()
                events.append(ev)
                finite &= torch.isfinite(logits).all()
                if t in LM_TOP1_AT:
                    step_logits[t] = logits[:, :cfg.vocab_size].float()
                assert logits.shape == (b, cfg.padded_vocab)
            sync(torch, on_card)
            decode_moe = rec.take()
            step_ms = [e[0].elapsed_time(e[1]) for e in events] if on_card else [float("nan")]
            decode_ms = statistics.median(step_ms)
            assert bool(finite), f"{cfg.name}: a decode step gave a logit that is not finite"
            hit = 1.0
            if decode_moe:
                hit = sum(int((load > 0).sum()) for load, _, _ in decode_moe) / sum(len(load) for load, _, _ in
                                                                                    decode_moe)
            decode_bound = (lm_weight_bytes(model, cfg, b, hit)
                            + lm_cache_bytes(cache, (n_prompt + n_gen) // 2)) / HBM_BYTES_PER_S * 1e3
            # bf16 top-1: decode step t against prefill of the t + 1 tokens it has seen (the real vocabulary:
            # prefill leaves the padded columns unmasked)
            agree, top1_steps = [], sorted(step_logits)
            for t, lg in step_logits.items():
                pre = T.prefill_step(model, toks[:, :t + 1], cfg, ctx)[:, :cfg.vocab_size]
                agree.append(float((pre.argmax(-1) == lg.argmax(-1)).float().mean()))
            # where a step's time goes: the device's busy share of a few more steps, its largest kernels
            idle, top = "not measured", "not measured"
            if on_card:
                def more_steps():
                    for t in range(n_prompt + n_gen, n_prompt + n_gen + sh["profiled"]):
                        T.decode_step(model, cache, toks[:, -1:], t, cfg, ctx)

                groups, span_ms, _ = device_profile(torch, more_steps, by_kernel=True)
                if groups:
                    idle = f"{max(0.0, 1.0 - sum(groups.values()) / span_ms):.3f}"
                    top = ", ".join(f"{k} {v / sh['profiled']:.3f}" for k, v in
                                    sorted(groups.items(), key=lambda kv: -kv[1])[:3])
            rec.take()
            del cache, step_logits

            # ---- one step at decode_32k's length
            lb, llen = sh["long_b_moe" if cfg.is_moe else "long_b"], sh["long_len"]
            cache = T.init_cache(cfg, lb, llen, device=dev)
            cache_gb = lm_cache_bytes(cache, llen) / 1e9
            ltok = torch.randint(0, cfg.vocab_size, (lb, 1), generator=g, device=dev)
            long_logits, _ = T.decode_step(model, cache, ltok, llen - 1, cfg, ctx)
            assert bool(torch.isfinite(long_logits).all())
            long_ms = cuda_ms(torch, lambda: T.decode_step(model, cache, ltok, llen - 1, cfg, ctx), 3) \
                if on_card else float("nan")
            long_moe = rec.take()
            lhit = 1.0
            if long_moe:
                lhit = sum(int((ld > 0).sum()) for ld, _, _ in long_moe) / sum(len(ld) for ld, _, _ in long_moe)
            long_bound = (lm_weight_bytes(model, cfg, lb, lhit) + lm_cache_bytes(cache, llen)) / HBM_BYTES_PER_S * 1e3
            del cache, long_logits
        peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else float("nan")
        del model
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        # ---- f32, 2 layers of full width: the card against the CPU, decode against prefill
        c32 = dataclasses.replace(cfg, n_layers=sh["check_layers"], dtype="float32")
        m32, _ = T.init_transformer(c32, seed=seed + 1, device=dev)
        m32.requires_grad_(False)
        cpu_m, _ = T.init_transformer(c32, device="meta")
        cpu_m = cpu_m.to_empty(device="cpu")
        cpu_m.load_state_dict(m32.state_dict())
        cpu_m.requires_grad_(False)
        cb, cp, cs = sh["cpu_b"], sh["cpu_prompt"], sh["cpu_steps"]
        ctok = torch.randint(0, cfg.vocab_size, (cb, cp), generator=g, device=dev)
        errs = []
        t0 = time.perf_counter()
        with torch.no_grad():
            errs.append(row_err(torch, T.prefill_step(m32, ctok, c32, ctx), T.prefill_step(cpu_m, ctok.cpu(), c32, ctx)))
            ccard = T.init_cache(c32, cb, cp, device=dev)
            ccpu = T.init_cache(c32, cb, cp, device="cpu")
            for t in range(cs):
                lc, _ = T.decode_step(m32, ccard, ctok[:, t:t + 1], t, c32, ctx)
                lh, _ = T.decode_step(cpu_m, ccpu, ctok[:, t:t + 1].cpu(), t, c32, ctx)
                errs.append(row_err(torch, lc, lh))
        cpu_s = time.perf_counter() - t0
        del cpu_m, ccard, ccpu
        assert max(errs) <= LM_TOL, f"{cfg.name}: card against CPU {errs} of row scale > {LM_TOL}"

        db, ds = sh["decode_b"], sh["dvp_steps"]
        dtok = torch.randint(0, cfg.vocab_size, (db, ds), generator=g, device=dev)
        dcache = T.init_cache(c32, db, max(cp, ds), device=dev)
        dvp, drops, seen_drop = [], [], 0
        with torch.no_grad(), rec:
            for t in range(ds):
                ld, _ = T.decode_step(m32, dcache, dtok[:, t:t + 1], t, c32, ctx)
                dec = sum(dropped for _, dropped, _ in rec.take())
                lp = T.prefill_step(m32, dtok[:, :t + 1], c32, ctx)
                pre = sum(dropped for _, dropped, _ in rec.take())
                seen_drop += dec
                drops.append((dec, pre))
                err = row_err(torch, ld[:, :cfg.vocab_size], lp[:, :cfg.vocab_size])
                if seen_drop == 0 and pre == 0:
                    dvp.append(err)
                    assert err <= LM_TOL, f"{cfg.name}: decode step {t} against prefill {err} of row scale > {LM_TOL}"
        assert dvp, f"{cfg.name}: every decode-vs-prefill step dropped a pair: {drops}"
        del m32, dcache
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        def moe_note(calls, what):
            if not calls:
                return ""
            load = torch.stack([ld for ld, _, _ in calls]).sum(0).tolist()
            return (f"; {what}: expert load {load} over {len(calls)} MoE calls, {sum(d for _, d, _ in calls)} pairs "
                    f"dropped (capacity {sorted({c for _, _, c in calls})})")

        tps = b / decode_ms * 1e3
        log(f"phase lm full: {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, {cfg.attention}"
            + (f", {cfg.n_experts} experts of d_ff {cfg.moe_d_ff}, top {cfg.top_k}, capacity {cfg.capacity_factor}"
               if cfg.is_moe else f", d_ff {cfg.d_ff}")
            + f", vocab {cfg.vocab_size} padded {cfg.padded_vocab}, {cfg.dtype}; {n_params / 1e9:.3f}B parameters; "
            f"reduced: {', '.join(reduced) or 'none'}) drawn in {init_s:.2f} s")
        log(f"  prefill {pb} x {ps}: {prefill_ms:.3f} ms (CUDA events, median of 3) against a bound of "
            f"{prefill_bound:.3f} ms ({gemm / 1e12:.3f} TFLOP of bf16 GEMMs at {BF16_FLOPS / 1e12:.1f} + "
            f"{attn / 1e12:.3f} TFLOP of f32 attention at {F32_FLOPS / 1e12:.0f} TFLOP/s)"
            + moe_note(prefill_moe, "prefill"))
        log(f"  decode B={b} over a {smax}-position cache, {n_prompt} prompt + {n_gen} greedy steps: "
            f"{decode_ms:.3f} ms a step (CUDA events, median of {len(step_ms)}; min {min(step_ms):.3f}, max "
            f"{max(step_ms):.3f}), {tps:.1f} tokens/s, against a bound of {decode_bound:.3f} ms (bytes: the "
            f"weights{'' if hit == 1.0 else f' with {hit:.3f} of the experts reached'} and the cache valid at "
            f"the median step at "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); bf16 top-1 decode against prefill at steps "
            f"{top1_steps}: {[round(a, 4) for a in agree]} (not gated); {sh['profiled']} more steps under the "
            f"profiler: device idle {idle}, the largest kernels (ms a step) {top}" + moe_note(decode_moe, "decode"))
        log(f"  long-context step (pos {llen - 1} of a {llen}-position cache, B={lb}, {cache_gb:.2f} GB of cache): "
            f"{long_ms:.3f} ms (CUDA events, median of 3) against a bound of {long_bound:.3f} ms (bytes: the weights "
            f"and the whole cache)" + moe_note(long_moe, "long"))
        log(f"  f32, {c32.n_layers} layers of full width: card against CPU (prefill {cb} x {cp} and {cs} decode "
            f"steps) worst {max(errs):.3g} of row scale (bound {LM_TOL}; cpu {cpu_s:.1f} s); decode against "
            f"prefill at B={db} for {ds} steps: {len(dvp)} checked, worst {max(dvp):.3g} (bound {LM_TOL}); "
            f"dropped pairs (decode, prefill) by step {drops}; peak {peak:.2f} GB allocated; phase "
            f"{time.perf_counter() - t_phase:.1f} s; {card}")
    launched = {name: m.launches - before[name] for name, m in counters.items()}
    assert not any(launched.values()), f"lm full launched a kernel of the port: {launched}"


class StepRecorder:
    """Wraps ``launch.train.make_lm_train_step`` while in use: each step
    ``train_lm`` takes is bracketed by CUDA events (the step's device time:
    ``train_lm`` synchronises on its loss before the next), the last call's
    parameters and state are kept (references: the step updates them in
    place), ``first`` is called with the first call's parameters and state
    before it steps, and call ``profile_at`` (1-based) runs under
    ``device_profile``."""

    def __init__(self, torch, train_mod, on_card, first=None, profile_at=0):
        self.torch, self.mod, self.on_card = torch, train_mod, on_card
        self.first, self.profile_at = first, profile_at
        self.events, self.last, self.profile, self.profile_s = [], None, None, float("nan")

    def __enter__(self):
        self.orig = self.mod.make_lm_train_step
        torch = self.torch

        def make(cfg, ctx, lr):
            step, opt = self.orig(cfg, ctx, lr=lr)

            def timed(params, state, batch):
                if self.first is not None and not self.events:
                    self.first(params, state)
                n = len(self.events) + 1
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if self.on_card else None
                if n == self.profile_at and self.on_card:
                    box, t0 = {}, time.perf_counter()
                    self.profile = device_profile(torch, lambda: box.update(out=step(params, state, batch)),
                                                  by_kernel=True, host_ops=False)
                    self.profile_s = time.perf_counter() - t0
                    out = box["out"]
                else:
                    if ev:
                        ev[0].record()
                    out = step(params, state, batch)
                    if ev:
                        ev[1].record()
                self.events.append(ev)
                self.last = (params, state)
                return out

            return timed, opt

        self.mod.make_lm_train_step = make
        return self

    def __exit__(self, *exc):
        self.mod.make_lm_train_step = self.orig

    def ms(self, calls):
        """CUDA-event milliseconds of the given 1-based calls (NaN off the card)."""
        if not self.on_card:
            return [float("nan")]
        return [self.events[i - 1][0].elapsed_time(self.events[i - 1][1]) for i in calls
                if self.events[i - 1] is not None and i != self.profile_at]


def train_flops(cfg, batch, seq):
    """(tensor-core GEMM operations, f32 attention operations) of one LM
    train step with layer remat: ``lm_flops``' forward with the head over
    every token, four times (the forward, the remat's second forward and
    the backward's two products a GEMM), the attention's causal pairs four
    times likewise."""
    tokens = batch * seq
    gemm, attn = lm_flops(cfg, tokens, seq, batch)
    gemm += 2 * (tokens - batch) * cfg.d_model * cfg.padded_vocab
    return 4 * gemm, 4 * attn


def leaf_err(torch, want, got, floor=0.0):
    """max |got - want| over max(max |want|, floor), in f64 on ``got``'s
    device (``want`` crosses in its own dtype, then widens there)."""
    w, g = want.detach().to(got.device).double(), got.detach().double()
    assert w.shape == g.shape and bool(torch.isfinite(w).all()) and bool(torch.isfinite(g).all())
    return float((g - w).abs().max()) / max(float(w.abs().max()), floor, 1e-30)


def adamw_first_step_err(torch, want, got, m_new, lr, floor, b1=0.9, eps=1e-8):
    """AdamW's first update, ``p - lr * (g / (|g| + eps) + decay)``, held
    against the reference side elementwise: within TRAIN_TOL of the leaf's
    largest |value| plus ``lr`` times the largest move of ``g / (|g| +
    eps)`` when ``g`` (``m_new / (1 - b1)``, the clipped gradient) moves by
    TRAIN_TOL of its leaf's largest |g| (at least ``floor``).  Returns the
    worst error over its bound (<= 1 holds); f64 on ``got``'s device."""
    dev = got.device
    w, t = want.detach().to(dev).double(), got.detach().double()
    g = m_new.detach().to(dev).double() / (1 - b1)
    u = lambda x: x / (x.abs() + eps)
    d = TRAIN_TOL * max(float(g.abs().max()), floor)
    moves = torch.maximum((u(g + d) - u(g)).abs(), (u(g - d) - u(g)).abs())
    bound = TRAIN_TOL * float(w.abs().max()) + lr * moves
    return float(((t - w).abs() / bound.clamp_min(1e-300)).max())


def step_parity(torch, dev, make_step, model, batch, steps_mod, rec=None):
    """One step of ``make_step()`` (a ``launch.steps`` factory) on the card
    and on a host copy of ``model``, from a fresh optimizer state, on
    ``batch`` (moved to each side).  Returns ({group: (worst error, its
    bound)}, the MoE routes of both sides as ``DispatchRecorder.take_ids``
    gives them, or None, and the seconds of each side's step and of the
    comparison, which runs on the card).  Held: the loss; the gradients of
    the first ``steps._grads`` call of each side (a leaf within TRAIN_TOL
    of its largest |value|, at least GRAD_FLOOR of the model's largest
    gradient: one that vanishes in exact arithmetic is noise on both
    sides); the updated parameters (AdamW: ``adamw_first_step_err``, at
    most 1); the state (m within TRAIN_TOL; second moments, squares of the
    gradient, within twice that)."""
    from repro_torch.optim.optimizer import named_leaves

    cpu_m = copy_to_cpu(torch, model)
    sides, secs = {}, {}
    orig = steps_mod._grads
    for name, m, d in (("card", model, dev), ("cpu", cpu_m, torch.device("cpu"))):
        t0 = time.perf_counter()
        seen = {}

        def record(loss, leaves, seen=seen):
            out = orig(loss, leaves)
            if not seen:
                seen.update({k: g.detach().clone() for k, g in out.items()})
            return out

        steps_mod._grads = record
        try:
            if rec is not None:
                rec.take_ids()
            step, opt = make_step()
            state = opt.init(m)
            _, _, metrics = step(m, state, to_device(torch, batch, d))
            routes = None if rec is None else rec.take_ids()
            float(metrics["loss"])
        finally:
            steps_mod._grads = orig
        sides[name] = (seen, state, metrics, routes, opt.name)
        secs[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    (g_card, s_card, mt_card, r_card, opt_name), (g_cpu, s_cpu, mt_cpu, r_cpu, _) = sides["card"], sides["cpu"]
    # the floors are scales: taken once, from the card's side
    floor = lambda tree, f=GRAD_FLOOR: f * max(float(t.abs().max()) for t in tree.values())
    g_floor = floor(g_card)
    errs = {"loss": (leaf_err(torch, mt_cpu["loss"], mt_card["loss"]), TRAIN_TOL),
            "grads": (max(leaf_err(torch, g_cpu[k], g_card[k], g_floor) for k in g_cpu), TRAIN_TOL)}
    p_cpu, p_card = named_leaves(cpu_m), named_leaves(model)
    if opt_name == "adamw":
        m_floor, v_floor = floor(s_card.m), floor(s_card.v, GRAD_FLOOR ** 2)
        errs["params"] = (max(adamw_first_step_err(torch, p_cpu[k], p_card[k], s_cpu.m[k], STEP_LR, m_floor / 0.1)
                              for k in p_cpu), 1.0)
        errs["m"] = (max(leaf_err(torch, s_cpu.m[k], s_card.m[k], m_floor) for k in s_cpu.m), TRAIN_TOL)
        errs["v"] = (max(leaf_err(torch, s_cpu.v[k], s_card.v[k], v_floor) for k in s_cpu.v), 2 * TRAIN_TOL)
    else:
        errs["params"] = (max(leaf_err(torch, p_cpu[k], p_card[k]) for k in p_cpu), TRAIN_TOL)
        errs["vr/vc"] = (max(leaf_err(torch, getattr(s_cpu, f)[k], getattr(s_card, f)[k])
                             for f in ("vr", "vc") for k in getattr(s_cpu, f)), 2 * TRAIN_TOL)
    secs["compare"] = time.perf_counter() - t0
    return errs, (None if rec is None else (r_card, r_cpu)), secs


def errs_text(errs):
    return ", ".join(f"{k} {v:.3g} (bound {b:g})" for k, (v, b) in errs.items())


def copy_to_cpu(torch, model):
    """A copy of ``model`` whose parameters live on the host (copied one by
    one: the card holds no second copy)."""
    import copy

    memo = {id(p): torch.nn.Parameter(p.detach().to("cpu", copy=True), requires_grad=p.requires_grad)
            for p in model.parameters()}
    return copy.deepcopy(model, memo)


def to_device(torch, batch, dev):
    """A batch (a dict or a NamedTuple of tensors, dicts of tensors and
    Nones) on ``dev``."""
    if isinstance(batch, torch.Tensor):
        return batch.to(dev)
    if isinstance(batch, dict):
        return {k: to_device(torch, v, dev) for k, v in batch.items()}
    if batch is None:
        return None
    return type(batch)(*(to_device(torch, v, dev) for v in batch))


def molecule_batch(torch, cfg, graphs, g, dev, atoms=30, edges=64):
    """``graphs`` molecules of the ``molecule`` shape (30 atoms, 64 edges
    each) in batched form: random edges inside each molecule, distances
    uniform in [0.5, cutoff), one edge in 16 masked out, energies N(0, 1)."""
    from repro_torch.models.schnet import GraphBatch

    off = (torch.arange(graphs, device=dev) * atoms).repeat_interleave(edges)
    ints = lambda hi, n: torch.randint(0, hi, (n,), generator=g, device=dev)
    e = graphs * edges
    return GraphBatch(node_z=(1 + ints(9, graphs * atoms)).int(), senders=(off + ints(atoms, e)).int(),
                      receivers=(off + ints(atoms, e)).int(),
                      distances=0.5 + (cfg.cutoff - 0.5) * torch.rand(e, generator=g, device=dev),
                      edge_mask=ints(16, e) != 0,
                      graph_ids=torch.arange(graphs, device=dev).repeat_interleave(atoms).int(),
                      targets=torch.randn(graphs, generator=g, device=dev))


def train_full_phase(torch, dev, card, on_card, seed, cfgs=None, shapes=None):
    """Training through the port (``launch/steps.py``, ``launch/train.py``,
    ``optim/``, ``checkpoint/``; the backward under the reference's memory
    contract: layer remat, attention tiles and loss chunks recomputed).
    (1) f32 at TRAIN["check_layers"] layers of full width, TF32 off: one
    ``make_lm_train_step`` step (lr STEP_LR) of each LM config of "lm full"
    and smollm-360m on the card against the CPU port on the same weights
    and batch (TRAIN["check_b"] x TRAIN["check_s"]; phi3.5-moe with its
    Adafactor and grad_accum 4 at TRAIN["check_b_moe"] rows), by
    ``step_parity``; with experts, gated where both sides routed every
    token alike (drops printed).  (2) smollm-360m as published (32 layers,
    bf16, remat, AdamW) trained by ``launch.train.train_lm`` at train_4k's
    4,096 positions and a batch of TRAIN["b"]: TRAIN["steps"] steps with a
    checkpoint every TRAIN["interval"], then a fresh ``train_lm`` resumes
    and takes TRAIN["more"] more (its last profiled): ms a step (CUDA
    events, median of steps 2 to TRAIN["steps"]) against ``train_flops``'
    bound and the optimizer's bytes, tokens/s, the device idle share, peak
    memory, the losses; gated: finite losses, the saved state equal to the
    trained one and the resumed run's start equal to the saved one, bit for
    bit, peak under 80 GB.  (3) DIN as published (100M items) at
    train_batch's TRAIN["din_b"] users, TRAIN["din_steps"] steps of
    ``make_recsys_train_step``, and SchNet as published on
    TRAIN["mol_graphs"] molecules of the molecule shape, TRAIN["mol_steps"]
    steps of ``make_gnn_train_step``: ms a step against the optimizer's
    bytes or the FLOPs, finite losses; before each, one step at its smoke
    width on the card against the CPU (``step_parity``).  ``cfgs`` (the LM
    configs of (1), the one trained in (2) last) and ``shapes`` cut the
    phase for a CPU rehearsal.  No kernel of the port is launched."""
    import os
    import shutil
    import tempfile

    from repro_torch.checkpoint.checkpoint import flatten_with_paths, load_leaves
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.distributed.sharding import ParallelCtx
    from repro_torch.kernels import beam_topk as bk, fused_topk as fk, mips_topk as mk, sparse_dense as sd
    from repro_torch.kernels import topk_large as lk
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train as TRN
    from repro_torch.models import moe as M
    from repro_torch.models import recsys as R
    from repro_torch.models import schnet as S
    from repro_torch.models import transformer as T

    counters = {"mips_topk": mk, "fused_topk": fk, "topk_large": lk, "beam_hop": bk, "fused_score": sd}
    before = {name: m.launches for name, m in counters.items()}
    sh = dict(TRAIN, **(shapes or {}))
    assert not (on_card and torch.backends.cuda.matmul.allow_tf32), "TF32 is on: f32 products would round to 10 bits"
    t_phase = time.perf_counter()
    if cfgs is None:
        cfgs = [get_config(a) for a in LM_ARCHS + ("smollm-360m",)]
    g = torch.Generator(dev).manual_seed(seed)

    # ---- (1) f32, a few layers of full width: the card against the CPU
    rec = DispatchRecorder(M)
    for cfg in cfgs:
        t0 = time.perf_counter()
        c32 = dataclasses.replace(cfg, n_layers=sh["check_layers"], dtype="float32")
        model, _ = T.init_transformer(c32, seed=seed, device=dev)
        b = sh["check_b_moe"] if c32.is_moe else sh["check_b"]
        tok = torch.randint(0, c32.vocab_size, (b, sh["check_s"] + 1), generator=g, device=dev)
        batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
        ctx = ParallelCtx(None, c32.rules)
        with rec:
            errs, routes, secs = step_parity(torch, dev, lambda: ST.make_lm_train_step(c32, ctx, lr=STEP_LR), model,
                                             batch, ST, rec if c32.is_moe else None)
        note, gated = "", True
        if routes is not None:
            rc, rh = routes
            gated = len(rc) == len(rh) and all(torch.equal(x[0], y[0]) for x, y in zip(rc, rh))
            note = (f"; routes of {len(rc)} MoE calls {'equal on both sides' if gated else 'differ: not gated'}, "
                    f"pairs dropped (card, cpu) by call {[(x[1], y[1]) for x, y in zip(rc, rh)]}")
        if gated:
            assert all(v <= bound for v, bound in errs.values()), f"{cfg.name}: card against CPU {errs}"
        log(f"phase train full: f32 {cfg.name} ({c32.n_layers} layers of d {c32.d_model}, {c32.optimizer}, "
            f"grad_accum {c32.grad_accum}, remat {c32.remat}), one step at B={b} x {sh['check_s']}: card against "
            f"CPU {errs_text(errs)}{note}; {time.perf_counter() - t0:.1f} s (steps: card "
            f"{secs['card']:.1f}, cpu {secs['cpu']:.1f} on {torch.get_num_threads()} threads; compare "
            f"{secs['compare']:.1f})")
        del model, batch, tok
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    # ---- (2) smollm-360m as published, through the entry point
    scfg = cfgs[-1] if shapes else get_config("smollm-360m")
    full = get_config("smollm-360m")
    reduced = [f"the batch, {sh['b']} of train_4k's 256"]
    if (scfg.n_layers, scfg.d_model) != (full.n_layers, full.d_model):
        reduced.append("the model (a CPU rehearsal)")
    ckpt = tempfile.mkdtemp(prefix="train_full_")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9 if on_card else float("nan")
    kw = dict(batch_size=sh["b"], seq_len=sh["s"], lr=sh["lr"], ckpt_interval=sh["interval"], device=dev, seed=seed)
    checks = {}
    t0 = time.perf_counter()
    with StepRecorder(torch, TRN, on_card) as run1:
        _, losses1 = TRN.train_lm(scfg, None, sh["steps"], ckpt, **kw)
    run1_s = time.perf_counter() - t0
    saved = load_leaves(os.path.join(ckpt, f"step_{sh['steps']:010d}"))
    live = flatten_with_paths(dict(zip(("params", "opt"), run1.last)))
    checks["saved == trained"] = list(saved) == list(live) and all(
        torch.equal(saved[k], v.detach().cpu()) for k, v in live.items())
    run1.last = live = None

    def resumed(params, state):
        now = flatten_with_paths({"params": params, "opt": state})
        checks["resumed == saved"] = list(now) == list(saved) and all(
            torch.equal(saved[k].to(v.device), v.detach()) for k, v in now.items())

    t0 = time.perf_counter()
    with StepRecorder(torch, TRN, on_card, first=resumed, profile_at=sh["more"]) as run2:
        _, losses2 = TRN.train_lm(scfg, None, sh["steps"] + sh["more"], ckpt, **kw)
    run2_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else float("nan")
    shutil.rmtree(ckpt, ignore_errors=True)
    saved = run2.last = None
    losses = losses1 + losses2
    assert len(losses1) == sh["steps"] and len(losses2) == sh["more"], (len(losses1), len(losses2))
    assert all(math.isfinite(x) for x in losses), f"a loss is not finite: {losses}"
    assert len(checks) == 2 and all(checks.values()), f"checkpoint round trip: {checks}"
    assert not on_card or peak < 80.0, f"peak {peak:.2f} GB"
    step_ms = run1.ms(range(2, sh["steps"] + 1))
    med = statistics.median(step_ms)
    tokens = sh["b"] * sh["s"]
    gemm, attn = train_flops(scfg, sh["b"], sh["s"])
    n_params = sum(p.numel() for p in T.init_transformer(scfg, device="meta")[0].parameters())
    pbytes = torch.empty((), dtype=T.torch_dtype(scfg.dtype)).element_size()
    opt_bytes = n_params * (4 * pbytes + 16)          # parameters and gradients, m and v (f32): read and written
    flop_ms = (gemm / BF16_FLOPS + attn / F32_FLOPS) * 1e3
    byte_ms = opt_bytes / HBM_BYTES_PER_S * 1e3
    idle, top = "not measured", "not measured"
    if run2.profile and run2.profile[0]:
        groups, span_ms, _ = run2.profile
        idle = f"{max(0.0, 1.0 - sum(groups.values()) / span_ms):.3f} of {span_ms:.1f} ms"
        top = ", ".join(f"{k} {v:.1f}" for k, v in sorted(groups.items(), key=lambda kv: -kv[1])[:4])
    log(f"phase train full: {scfg.name} ({scfg.n_layers} layers, d {scfg.d_model}, {scfg.dtype}, remat {scfg.remat}, "
        f"{scfg.optimizer}; {n_params / 1e6:.1f}M parameters; reduced: {', '.join(reduced)}) by train_lm at B="
        f"{sh['b']} x {sh['s']}: {sh['steps']} steps ({run1_s:.1f} s, a checkpoint every {sh['interval']}) + "
        f"{sh['more']} resumed ({run2_s:.1f} s): {med:.1f} ms a step (CUDA events, median of steps 2-"
        f"{sh['steps']}: {', '.join(f'{x:.1f}' for x in step_ms)}), {tokens / med * 1e3:.0f} tokens/s, against a "
        f"bound of {max(flop_ms, byte_ms):.1f} ms (train_flops: {gemm / 1e12:.2f} TFLOP of bf16 GEMMs at "
        f"{BF16_FLOPS / 1e12:.1f} + {attn / 1e12:.2f} TFLOP of f32 attention at {F32_FLOPS / 1e12:.0f} TFLOP/s = "
        f"{flop_ms:.1f} ms; the optimizer's {opt_bytes / 1e9:.2f} GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s = "
        f"{byte_ms:.2f} ms); the last resumed step profiled ({run2.profile_s:.1f} s with the profiler): device idle "
        f"{idle}, the largest kernels (ms) {top}; peak {peak:.2f} GB allocated "
        f"({held_gb:.2f} GB held before); losses {', '.join(f'{x:.4f}' for x in losses)}; checkpoint: "
        f"{', '.join(f'{k} {v}' for k, v in checks.items())}; {card}")
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # ---- (3) DIN and SchNet at published widths, each after a smoke-width parity step
    families = (
        ("din", sh.get("din_cfg") or get_config("din"), R.init_recsys, sh["din_b"], sh["din_steps"],
         lambda c, n: recsys_batch(torch, c, n, g, dev),
         lambda c, n: ST.make_recsys_train_step(c, ParallelCtx(None, c.rules), lr=STEP_LR)),
        ("schnet", sh.get("mol_cfg") or get_config("schnet"), S.init_schnet, sh["mol_graphs"], sh["mol_steps"],
         lambda c, n: molecule_batch(torch, c, n, g, dev),
         lambda c, n: ST.make_gnn_train_step(c, ParallelCtx(None, c.rules), lr=STEP_LR, n_graphs=n)))
    for label, cfg, init, n, steps_n, make_batch, make_step in families:
        smoke = get_smoke_config(label)
        if label == "din":
            smoke = dataclasses.replace(smoke, item_vocab=5000)
        ns = 64 if label == "din" else 8
        model, _ = init(smoke, seed=seed, device=dev)
        errs, _, _ = step_parity(torch, dev, lambda: make_step(smoke, ns), model, make_batch(smoke, ns), ST)
        assert all(v <= bound for v, bound in errs.values()), f"{label} smoke: card against CPU {errs}"
        del model
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model, _ = init(cfg, seed=seed, device=dev)
        batch = make_batch(cfg, n)
        step, opt = make_step(cfg, n)
        state = opt.init(model)
        sync(torch, on_card)
        init_s = time.perf_counter() - t0
        ms_list, step_losses = [], []
        for _ in range(steps_n):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if on_card else None
            if ev:
                ev[0].record()
            _, _, metrics = step(model, state, batch)
            if ev:
                ev[1].record()
            step_losses.append(float(metrics["loss"]))
            ms_list.append(ev[0].elapsed_time(ev[1]) if ev else float("nan"))
        assert all(math.isfinite(x) for x in step_losses), f"{label}: a loss is not finite: {step_losses}"
        idle, top = "not measured", "not measured"
        if on_card:
            groups, span_ms, _ = device_profile(torch, lambda: step(model, state, batch), by_kernel=True)
            if groups:
                idle = f"{max(0.0, 1.0 - sum(groups.values()) / span_ms):.3f}"
                top = ", ".join(f"{k} {v:.2f}" for k, v in sorted(groups.items(), key=lambda kv: -kv[1])[:3])
        n_par = sum(p.numel() for p in model.parameters())
        peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else float("nan")
        med = statistics.median(ms_list[1:] or ms_list)
        if label == "din":
            nbytes = n_par * 4 * 8                # f32 parameters, gradients, m, v: each read and written
            what = (f"{n_par / 1e9:.3f}B parameters: the optimizer's {nbytes / 1e9:.1f} GB (parameters, gradients, "
                    f"m, v, each read and written) at {HBM_BYTES_PER_S / 1e12:.2f} TB/s bound a step at "
                    f"{nbytes / HBM_BYTES_PER_S * 1e3:.2f} ms")
        else:
            ops = 3 * schnet_flops(cfg, batch.node_z.shape[0], batch.senders.shape[0])
            what = (f"{ops / 1e9:.3f} GFLOP (3x the network's forward) at {F32_FLOPS / 1e12:.0f} TFLOP/s bound a "
                    f"step at {ops / F32_FLOPS * 1e3:.4f} ms")
        log(f"phase train full: {label} as published ({'100M items, ' if label == 'din' else ''}batch {n}), "
            f"{steps_n} steps: {med:.2f} ms a step (CUDA events, median of steps 2-{steps_n}: "
            f"{', '.join(f'{x:.2f}' for x in ms_list)}); {what}; one more step profiled: device idle {idle}, the "
            f"largest kernels (ms) {top}; losses {', '.join(f'{x:.4f}' for x in step_losses)}; "
            f"peak {peak:.2f} GB; drawn in {init_s:.1f} s; smoke width, card against CPU: {errs_text(errs)}; {card}")
        del model, state, batch, step, opt
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    launched = {name: m.launches - before[name] for name, m in counters.items()}
    assert not any(launched.values()), f"train full launched a kernel of the port: {launched}"
    log(f"phase train full: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# "dist full" and "moe ep full": the distributed layer on ranks that share the one card
# ---------------------------------------------------------------------------

def _card_rank_main(body, rank, world, store, backend, device, box, results):
    """One spawned rank: the card (or the CPU), its process group, ``body``
    on the arguments in ``box``; its result or its traceback goes to
    ``results``.  The arguments leave ``box`` and are dropped before the
    rank reports: a CUDA tensor received through IPC stays allocated in
    the process that sent it until every receiver has freed it, and a
    reference held to the rank's exit is never freed."""
    import traceback

    import torch
    import torch.distributed as dist

    from repro_torch.distributed.mesh_utils import init_rank

    args = box.pop()
    try:
        if device == "cuda":
            torch.cuda.set_device(0)
        else:
            torch.set_num_threads(1)
        init_rank(rank, world, store, backend=backend, timeout_s=DIST["collective_timeout"])
        out = (rank, True, body(rank, world, device, *args))
    except BaseException:
        out = (rank, False, traceback.format_exc())
    finally:
        del args
        gc.collect()
        if device == "cuda":
            torch.cuda.synchronize()
        if dist.is_initialized():
            dist.destroy_process_group()
    results.put(out)


def run_card_ranks(body, world, device, args, backend="gloo"):
    """``[body(rank, world, device, *args)]`` for ``world`` spawned ranks of
    one process group (a file store under the temp dir).  Tensors in
    ``args`` travel as CUDA IPC handles (views of this process's memory, no
    copy; on the CPU as shared memory).  A rank that raises, dies or
    outlives DIST["timeout"] fails the phase, and every rank is stopped."""
    import os
    import queue
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    where = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    procs = [ctx.Process(target=_card_rank_main,
                         args=(body, r, world, os.path.join(where, "store"), backend, device, [args], results))
             for r in range(world)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + DIST["timeout"]
    try:
        while len(got) < world:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0) and r not in got]
                assert not dead, f"ranks {dead} died without a result"
                assert time.monotonic() < deadline, f"ranks outlived {DIST['timeout']} s"
                continue
            assert ok, f"rank {rank} of {world} failed:\n{out}"
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30.0 if len(got) == world else 0.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=30.0)
        results.close()
        shutil.rmtree(where, ignore_errors=True)
    return [got[r] for r in range(world)]


def _counted_kernels():
    from repro_torch.kernels import fused_topk as fk
    from repro_torch.kernels import mips_topk as mk
    from repro_torch.kernels import topk_large as lk

    return {"mips_topk": mk, "fused_topk": fk, "topk_large": lk}


def _sharded_runs(ctx, space, corpus, q, shard_counts, deep, against_plain=False):
    """The sharded main path on this rank: fused through B2 and dense
    through B1 over each shard count, and a dense request at DEEP_K
    through ``topk_large``; every held shard a view of the corpus on the
    ``cuda`` backend.  With ``against_plain``, each shard this rank holds
    at the first shard count is then run once more through its generator
    and through the plain version on the same view (launches not counted).
    Returns ({case: (scores, ids) on the host}, launches by kernel,
    seconds, [(kernel, case, kernel's (scores, ids), plain's)] in numpy)."""
    from repro_torch.core.spaces import DenseSpace
    from repro_torch.kernels import ref as plain
    from repro_torch.serving.sharded import ShardedPipeline

    kernels = _counted_kernels()
    for m in kernels.values():
        m.launches = 0
    out, held = {}, []
    t0 = time.perf_counter()
    runs = [(f"fused {n}", space, corpus, q, n, DIST["cand"]) for n in shard_counts]
    runs += [(f"dense {n}", DenseSpace("ip"), corpus.dense, q.dense, n, DIST["cand"]) for n in shard_counts]
    if deep:
        runs.append(("deep", DenseSpace("ip"), corpus.dense, q.dense, shard_counts[0], DEEP_K))
    for name, sp, corp, qq, n, k in runs:
        with ShardedPipeline.from_corpus(sp, corp, n, ctx=ctx, backend="cuda", cand_qty=k, final_qty=k) as pipe:
            leaf = corp.dense if hasattr(corp, "dense") else corp
            for g, s in zip(pipe.generators, pipe.shards):
                if g is None:
                    continue
                assert type(g.backend).__name__ == "CudaBackend", f"{name}: a shard took {type(g.backend)}"
                part = s.corpus.dense if hasattr(s.corpus, "dense") else s.corpus
                assert part.untyped_storage().data_ptr() == leaf.untyped_storage().data_ptr(), \
                    f"{name}: a shard is not a view of the corpus"
                if against_plain and n == shard_counts[0] and k == DIST["cand"]:
                    held.append((name, g, s))
            r = pipe.generate(qq, k)
            out[name] = (r.scores.cpu().numpy(), r.indices.cpu().numpy())
    seconds = time.perf_counter() - t0
    launches = {name: m.launches for name, m in kernels.items()}
    compared = []
    for name, g, s in held:
        fused = name.startswith("fused")
        qq = q if fused else q.dense
        got = g.generate(qq, DIST["cand"])
        if fused:
            want = plain.fused_topk_ref(q.sparse, q.dense, s.corpus.sparse, s.corpus.dense, space.vocab_size,
                                        DIST["cand"], w_dense=space.w_dense, w_sparse=space.w_sparse,
                                        tile_n=1 << 16)
        else:
            want = plain.mips_topk_ref(q.dense, s.corpus, DIST["cand"], tile_n=1 << 18)
        compared.append(("fused_topk" if fused else "mips_topk", f"{name} shard at rows {s.offset}",
                         tuple(x.cpu().numpy() for x in got), tuple(x.cpu().numpy() for x in want)))
    return out, launches, seconds, compared


def _dist_rank(rank, world, device, corpus, q, space, n4, tree, axes, rules, ckpt, seed):
    """A rank of "dist full" (4 gloo ranks on one card): the sharded main
    path over ("data", "model") = (1, 4); ``sharded_exact_topk``; the
    gradient all-reduce over ("pod", "data") = (2, 2) on a tree shaped as
    ``tree``; ``tree`` re-meshed 4 -> 2 -> 4 ranks and the checkpoint at
    ``ckpt`` restored onto (1, 4), each gathered and held bit for bit."""
    import torch

    from repro_torch.core.brute_force import sharded_exact_topk
    from repro_torch.core.spaces import DenseSpace
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.elastic import Topology, remesh
    from repro_torch.distributed.mesh_utils import make_mesh
    from repro_torch.distributed.sharding import NamedSharding, ParallelCtx, params_sharding
    from repro_torch.checkpoint.checkpoint import restore_checkpoint
    from repro_torch.optim.compression import int8_compress, int8_decompress

    dev = torch.device(device, 0) if device == "cuda" else torch.device("cpu")
    mesh = make_mesh(DIST["mesh"], ("data", "model"), device)
    ctx = ParallelCtx(mesh, {"corpus": "model"})
    out, launches, serve_s, compared = _sharded_runs(ctx, space, corpus, q, DIST["shards"], True, True)
    t0 = time.perf_counter()
    r = sharded_exact_topk(DenseSpace("ip"), q.dense, corpus.dense[:n4], DIST["cand"], mesh, corpus_axis="model")
    out["exact"] = (r.scores.cpu().numpy(), r.indices.cpu().numpy())
    exact_s = time.perf_counter() - t0

    # the gradient all-reduce: rank r's leaf i is N(0, 1) from seed (r, i); each rank draws every rank's
    # leaf again to hold the mean
    t0 = time.perf_counter()
    gmesh = make_mesh(DIST["grad_mesh"], ("pod", "data"), device)
    shapes = {k: tuple(v.shape) for k, v in _leaves(tree).items()}

    def draw(r, i, shape):
        g = torch.Generator(device=dev).manual_seed(seed * 100_003 + r * 1009 + i)
        return torch.randn(shape, generator=g, device=dev)

    mine = {k: draw(rank, i, s) for i, (k, s) in enumerate(shapes.items())}
    errs = []
    for compress in (None, lambda x: int8_decompress(int8_compress(x))):
        reduced, worst = C.dp_allreduce_grads(mine, gmesh, compress=compress), 0.0
        for i, (k, s) in enumerate(shapes.items()):
            parts = [draw(r, i, s) for r in range(world)]
            mean = sum(parts) / world
            if compress is None:     # f32 rounding: a few ULPs of the magnitudes summed
                e = float(((reduced[k] - mean).abs() / (sum(p.abs() for p in parts) / world)).max())
                assert e <= 4 * 2.0 ** -24, f"{k}: the all-reduce is {e:.3g} of sum |g| / ranks from the mean"
            else:                    # the reference test's bound
                e = float((reduced[k] - mean).abs().max() / mean.abs().max())
                assert e <= 2e-2, f"{k}: the int8 all-reduce is {e:.3g} of the largest |mean| from it"
            worst = max(worst, e)
        errs.append(worst)
        del reduced
    del mine
    grad_s = time.perf_counter() - t0

    # elastic: 4 -> 2 -> 4 ranks, then restoring onto (1, 4)
    t0 = time.perf_counter()
    p4, c4 = remesh(tree, axes, rules, None, Topology(DIST["mesh"], ("data", "model")), device)
    p2, c2 = remesh(p4, axes, rules, c4, Topology((1, 2), ("data", "model")), device)
    assert (p2 is None) == (rank >= 2)
    back, c4b = remesh(p2, axes, rules, c2, Topology(DIST["mesh"], ("data", "model")), device)
    remesh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = restore_checkpoint(ckpt, tree, params_sharding(axes, c4b))
    restore_s = time.perf_counter() - t0
    held = 0
    for name, placed in (("remesh", back), ("restore", restored)):
        for k, v in _leaves(placed).items():
            whole = C.gather_full(v.to_local(), NamedSharding.of(v), v.shape) if hasattr(v, "to_local") else v
            want = _leaves(tree)[k]
            assert whole.dtype == want.dtype and torch.equal(whole.contiguous().view(torch.uint8),
                                                             want.contiguous().view(torch.uint8)), \
                f"{name}: {k} differs after the round trip"
            held += 1
    blocks = sum(v.to_local().numel() for v in _leaves(back).values() if hasattr(v, "to_local"))
    return {"out": out, "launches": launches, "compared": compared, "errs": errs, "held": held,
            "block elements": blocks, "seconds": dict(serve=serve_s, exact=exact_s, grads=grad_s,
                                                      remesh=remesh_s, restore=restore_s),
            "peak": torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else float("nan")}


def _nccl_rank(rank, world, device, corpus, q, space):
    """The sharded fused run once more on a one-rank NCCL group."""
    import torch.distributed as dist

    from repro_torch.distributed.mesh_utils import make_mesh
    from repro_torch.distributed.sharding import ParallelCtx

    assert dist.get_backend() == "nccl"
    mesh = make_mesh((1, 1), ("data", "model"), device)
    out, launches, _, _ = _sharded_runs(ParallelCtx(mesh, {"corpus": "model"}), space, corpus, q,
                                        DIST["shards"][:1], False)
    return {"out": out, "launches": launches}


def _leaves(tree, prefix=""):
    """``{path: leaf}`` of nested dicts."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _stacked_params(torch, model):
    """A transformer's parameters in the reference's tree (nested dicts by
    name): the blocks' leaves stacked over the layer axis (a copy), the
    others as they are."""
    tree = {}

    def put(name, leaf):
        node = tree
        *path, last = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf

    for name, p in model.named_parameters():
        if not name.startswith("blocks."):
            put(name, p.detach())
    for name, _ in model.blocks[0].named_parameters():
        put("blocks." + name, torch.stack([dict(b.named_parameters())[name].detach() for b in model.blocks]))
    return tree


def dist_full_phase(torch, dev, check, corpus, batches, space, card, on_card, seed):
    """The distributed layer over the resident corpus, DIST["world"] gloo
    ranks sharing the card (NCCL refuses two ranks on one card), mesh
    ("data", "model") = DIST["mesh"], rules {"corpus": "model"}; every rank
    gets the corpus through CUDA IPC (views of this process's memory) and
    keeps the shards of its slot as views.  The sharded fused path (B2 on
    every shard) and dense path (B1) with cand_qty DIST["cand"] over each
    count of DIST["shards"] (8: two shards a rank, not adjacent), a dense
    request at DEEP_K (``topk_large`` on every shard) and
    ``sharded_exact_topk`` over the first rows that 4 divides: ids equal to
    the single-process path over the whole corpus (the deep request and
    the plain exact top-k: at near-ties as "full check" allows), scores
    within TOL_REL; every rank's answer equal.  Then ``dp_allreduce_grads``
    over ("pod", "data") = (2, 2) on smollm-360m's parameter shapes in f32
    (plain: within 4 ULPs of sum |g| / ranks of the mean; int8: 2e-2 of the
    largest |mean|, the reference test's bound); ``remesh`` of smollm-360m's
    parameters 4 -> 2 -> 4 ranks and ``restore_checkpoint`` of them onto
    (1, 4), bit for bit; and the sharded fused run once more on a one-rank
    NCCL group.  Returns the launches by kernel (each rank's, from its
    sharded runs)."""
    import os
    import shutil
    import tempfile

    from repro_torch.checkpoint.checkpoint import save_checkpoint
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.pipeline import BruteForceGenerator
    from repro_torch.core.spaces import DenseSpace
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    if on_card:   # blocks this process keeps cached are memory the ranks cannot have
        torch.cuda.empty_cache()
    q = batches[0]
    n = int(corpus.dense.shape[0])
    n4 = n - n % DIST["mesh"][1]
    cand = DIST["cand"]
    # the single-process answers over the whole corpus
    fused_want = BruteForceGenerator(space, corpus, backend="cuda").generate(q, cand)
    dense_gen = BruteForceGenerator(DenseSpace("ip"), corpus.dense, backend="cuda")
    dense_want = dense_gen.generate(q.dense, cand)
    deep_want = dense_gen.generate(q.dense, DEEP_K)
    exact_want = BruteForceGenerator(DenseSpace("ip"), corpus.dense[:n4], backend="cuda").generate(q.dense, cand)
    # smollm-360m's parameters (a smoke config on the CPU), stacked as the reference keeps them
    cfg = get_config("smollm-360m") if on_card else get_smoke_config("smollm-360m")
    model, axes = T.init_transformer(cfg, seed=seed, device=dev)
    tree = _stacked_params(torch, model)
    del model
    where = tempfile.mkdtemp(prefix="dist_full_")
    ckpt = save_checkpoint(where, 1, tree)
    try:
        device = dev.type
        ranks = run_card_ranks(_dist_rank, DIST["world"], device,
                               (corpus, q, space, n4, tree, axes, dict(cfg.rules), ckpt, seed))
        nccl = run_card_ranks(_nccl_rank, 1, device, (corpus, q, space), backend="nccl") if on_card else []
    finally:
        shutil.rmtree(where, ignore_errors=True)
    first = ranks[0]["out"]
    for r in ranks[1:] + nccl:
        for name, (s, i) in r["out"].items():
            assert np.array_equal(i, first[name][1]) and np.array_equal(s.view(np.int32), first[name][0].view(np.int32)), \
                f"{name}: the ranks disagree"
    first = {name: (torch.from_numpy(s), torch.from_numpy(i)) for name, (s, i) in first.items()}
    for name, want, kernel, exact in (
            [(f"fused {k}", fused_want, "fused_topk", True) for k in DIST["shards"]]
            + [(f"dense {k}", dense_want, "mips_topk", True) for k in DIST["shards"]]
            + [("deep", deep_want, "topk_large", False), ("exact", exact_want, "mips_topk", False)]):
        check(kernel, f"dist {name}", first[name], tuple(want), exact_ids=exact)
    for i, r in enumerate(ranks):   # each rank's shards at the first count, kernel against plain on the same view
        for kernel, name, got, want in r["compared"]:
            check(kernel, f"dist rank {i} {name}", tuple(map(torch.from_numpy, got)),
                  tuple(map(torch.from_numpy, want)), exact_ids=False)
    n_compared = sum(len(r["compared"]) for r in ranks)
    assert n_compared == 2 * DIST["shards"][0], f"dist full: {n_compared} shards held against plain"
    bits = {name: torch.equal(first[name][0].view(torch.int32), want.scores.cpu().view(torch.int32))
            for name, want in ((f"fused {k}", fused_want) for k in DIST["shards"])}
    launches = {k: sum(r["launches"][k] for r in ranks + nccl) for k in ranks[0]["launches"]}
    if on_card:
        assert all(v > 0 for v in launches.values()), f"dist full: a kernel was not launched: {launches}"
    secs = {k: max(r["seconds"][k] for r in ranks) for k in ranks[0]["seconds"]}
    log(f"phase dist full: {DIST['world']} gloo ranks on one card, mesh (data, model) = {DIST['mesh']}; "
        f"sharded fused (B2) and dense (B1) cand_qty {cand} over {DIST['shards']} shards, dense k = {DEEP_K} "
        f"(topk_large) and sharded_exact_topk over {n4} rows agree with the single-process path over the whole "
        f"corpus (ids equal; fused scores bit for bit: {bits}); every rank's answer equal"
        + (", and a one-rank NCCL group's" if nccl else "")
        + f"; launches from the ranks {launches} (by rank {[r['launches'] for r in ranks + nccl]}); "
        f"dp_allreduce_grads over (pod, data) = {DIST['grad_mesh']} on {len(_leaves(tree))} leaves of "
        f"{cfg.name}'s shapes in f32: plain {ranks[0]['errs'][0]:.3g} of sum |g| / ranks, int8 "
        f"{max(r['errs'][1] for r in ranks):.3g} of the largest |mean|; remesh 4 -> 2 -> 4 and restore_checkpoint "
        f"onto (1, 4): {ranks[0]['held']} leaves bit for bit; {n_compared} rank-held shards at "
        f"{DIST['shards'][0]} shards held against the plain version on the same view; rank seconds {secs}; rank peak "
        f"{max(r['peak'] for r in ranks):.2f} GB allocated; phase {time.perf_counter() - t_phase:.1f} s "
        f"(host clock; no speed claim for collectives: the ranks share one card and exchange over loopback); "
        f"{card}")
    del tree, fused_want, dense_want, deep_want, exact_want
    if on_card:
        torch.cuda.ipc_collect()
    return launches


def _row_keys(torch, rows):
    """A 64-bit key of each row's bits (a fixed random weighting of them,
    summed with wrap-around, so in any order alike): a token told by its
    own values, wherever a rank routed it."""
    bits = rows.contiguous().view(torch.int16 if rows.element_size() == 2 else torch.int32).long()
    w = torch.randint(1, 1 << 62, (rows.shape[1],), generator=torch.Generator().manual_seed(7)).to(rows.device)
    return (bits * w).sum(1)


def _moe_rank(rank, world, device, cases):
    """A rank of "moe ep full": ``moe_apply`` of each case's layer over its
    mesh, no gradient.  Returns each case's y on the host, aux, seconds and
    what the rank recorded of its own routing: per routed token its key
    (``_row_keys``), its expert ids and whether every one of its pairs was
    kept, at this rank's bucketing and at the destination's (that verdict
    sent back over the expert-parallel axis)."""
    import torch

    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.mesh_utils import make_mesh
    from repro_torch.distributed.sharding import ParallelCtx
    from repro_torch.models import moe as M

    out = {}
    route = M.route
    for name, (cfg, mesh_shape, params, x) in cases.items():
        mesh = make_mesh(mesh_shape, ("data", "model"), device)
        routed = []

        def record(x_flat, wg, k):
            ids, w, aux = route(x_flat, wg, k)
            routed.append((x_flat, ids))
            return ids, w, aux

        M.route = record
        try:
            with DispatchRecorder(M) as rec, torch.no_grad():
                if device == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                y, aux = M.moe_apply(params, x, cfg, ParallelCtx(mesh, cfg.rules))
                if device == "cuda":
                    torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
        finally:
            M.route = route
        # _ep_process buckets twice a call: by destination rank, then (there) by expert
        assert len(rec.dispatches) == 2 * len(routed) > 0, f"{name}: the expert-parallel path did not run"
        ep = mesh.get_group("model" if cfg.ep_mode == "model" else "data")
        keys, ids_all, kept_all = [], [], []
        for (x_flat, ids), d1, call1, call2 in zip(routed, rec.dispatches[0::2], rec.calls[0::2], rec.calls[1::2]):
            _, _, n_ep, c1 = call1
            back = C.all_to_all(call2[1].reshape(n_ep, c1).to(torch.int32), ep).reshape(-1).bool()
            kept = d1.valid & back[d1.slot.long().clamp(max=n_ep * c1 - 1)]
            keys.append(_row_keys(torch, x_flat))
            ids_all.append(ids)
            kept_all.append(kept.reshape(-1, cfg.top_k).all(1))
        out[name] = (y.float().cpu().numpy(), float(aux), seconds,
                     tuple(torch.cat(v).cpu().numpy() for v in (keys, ids_all, kept_all)))
        del routed, rec
    out["peak"] = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else float("nan")
    return out


def draw_moe(torch, gen, cfg, dtype, dev, block=8):
    """``moe_init``'s leaves, shapes and scales (the router ``N(0, 1/d)`` in
    f32, the experts ``N(0, 1/d)`` and ``N(0, 1/f)`` in ``dtype``) drawn
    from ``gen`` ``block`` experts at a time: an f32 draw of a whole arctic
    leaf would need 17.8 GB beside its 26.8 GB of bf16 experts."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts

    def experts(shape, scale):
        out = torch.empty(shape, dtype=dtype, device=dev)
        for i in range(0, e, block):
            part = (min(block, e - i), *shape[1:])
            out[i:i + block] = torch.randn(part, generator=gen, device=dev).mul_(scale)
        return out

    return {"wg": torch.randn(d, e, generator=gen, device=dev).mul_(1.0 / math.sqrt(d)),
            "w_in": experts((e, d, f), 1.0 / math.sqrt(d)), "w_gate": experts((e, d, f), 1.0 / math.sqrt(d)),
            "w_out": experts((e, f, d), 1.0 / math.sqrt(f))}


def moe_ep_full_phase(torch, dev, card, on_card, seed, smoke_only=False):
    """Expert parallelism on DIST["world"] gloo ranks sharing the card:
    phi3.5-moe's MoE layer as published (16 experts, top 2, d 4096,
    moe_d_ff 6400, capacity 1.25, ``ep_mode="model"``) over ("data",
    "model") = (1, 4) and arctic-480b's (128 experts, d 7168, moe_d_ff 4864,
    experts over data, ``expert_ff`` over model, ``moe_token_chunks`` 4)
    over (2, 2) through the 2-D body, both in bf16 on MOE_EP["tokens"]
    tokens, weights drawn on the card from ``seed`` and handed to the
    ranks through CUDA IPC (each rank's expert blocks are views); then
    both layers at their smoke configs in f32.  Each is held against
    ``moe_local`` on the card on the tokens both sides routed alike and
    neither dropped (the count printed): bf16 within MOE_BF16_TOL of a
    row's largest |y|, f32 within the CPU tests' rtol 1e-4, atol 1e-5.
    ``smoke_only`` (a CPU rehearsal) runs the f32 pass alone."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import moe as M

    t_phase = time.perf_counter()
    layers = [("phi3.5-moe-42b-a6.6b", (1, 4)), ("arctic-480b", (2, 2))]
    b, s = MOE_EP["tokens"]
    cases, passes = {}, []
    if not smoke_only:
        passes.append(("bf16", lambda a: get_config(a), torch.bfloat16, (b, s)))
    passes.append(("f32 smoke", lambda a: get_smoke_config(a), torch.float32, (b, MOE_EP["smoke_seq"])))
    for label, get, dtype, (bb, ss) in passes:
        for arch, mesh_shape in layers:
            cfg = dataclasses.replace(get(arch), dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
            gen = torch.Generator(device=dev).manual_seed(seed)
            params = draw_moe(torch, gen, cfg, dtype, dev)
            x = torch.randn(bb, ss, cfg.d_model, generator=gen, device=dev).to(dtype)
            cases[f"{arch} {label}"] = (cfg, mesh_shape, params, x)
    weights_gb = sum(v.numel() * v.element_size() for c in cases.values() for v in c[2].values()) / 1e9
    # reckoned: every layer's weights once (the ranks map them), moe_local's buffers and the largest
    # expert GEMM output ([E, cap, f] bf16) beside them, a few hundred MB a rank
    log(f"phase moe ep full: weights {weights_gb:.2f} GB on the card (the ranks map them through IPC); "
        f"reckoned peak about {weights_gb + 1.0:.1f} GB in this process and under 2 GB a rank")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ranks = run_card_ranks(_moe_rank, DIST["world"], dev.type, (cases,))
    for name, (cfg, mesh_shape, params, x) in cases.items():
        d = cfg.d_model
        flat = x.reshape(-1, d)
        with DispatchRecorder(M) as rec:
            want, _ = M.moe_local(params, flat, cfg)
        (_, valid, _, _), = rec.calls
        ids_local, _, _ = M.route(flat, params["wg"], cfg.top_k)
        kept_local = valid.reshape(-1, cfg.top_k).all(1)
        # the EP side as its ranks recorded it, each token found by its key
        keys = _row_keys(torch, flat)
        order = keys.argsort()
        sorted_keys = keys[order]
        assert bool((sorted_keys[1:] != sorted_keys[:-1]).all()), f"{name}: two tokens share a key"
        ids_ep = torch.full_like(ids_local, -1)
        kept_ep = torch.zeros_like(kept_local)
        for r in ranks:
            rk, rids, rkept = (torch.from_numpy(v).to(dev) for v in r[name][3])
            at = torch.searchsorted(sorted_keys, rk).clamp(max=keys.shape[0] - 1)
            assert torch.equal(sorted_keys[at], rk), f"{name}: a rank routed a token that is not in x"
            ids_ep[order[at]], kept_ep[order[at]] = rids, rkept
        assert bool((ids_ep >= 0).all()), f"{name}: a token was routed by no rank"
        ep_axis = "model" if cfg.ep_mode == "model" else "data"
        bb, ss = x.shape[:2]
        gate = (ids_ep == ids_local).all(1) & kept_ep & kept_local
        for r in ranks[1:]:
            assert np.array_equal(r[name][0], ranks[0][name][0]), f"{name}: the ranks disagree"
        got = torch.from_numpy(ranks[0][name][0]).to(dev, x.dtype).reshape(-1, d)    # bf16 exactly, as f32
        g, w = got[gate], want[gate]
        assert int(gate.sum()) > 0, f"{name}: no token was routed alike and kept on both sides"
        if x.dtype == torch.bfloat16:
            err = row_err(torch, g, w)
            assert err <= MOE_BF16_TOL, f"{name}: {err:.3g} of a row's scale > {MOE_BF16_TOL}"
            held = f"{err:.3g} of a row's largest |y| (tolerance {MOE_BF16_TOL:.4g})"
        else:
            assert torch.allclose(g, w, rtol=1e-4, atol=1e-5), f"{name}: outside rtol 1e-4, atol 1e-5"
            held = f"max |diff| {float((g - w).abs().max()):.3g} (rtol 1e-4, atol 1e-5)"
        log(f"phase moe ep full: {name} (E {cfg.n_experts}, top {cfg.top_k}, d {d}, moe_d_ff {cfg.moe_d_ff}, "
            f"ep over {ep_axis}{', expert_ff over model, ' + str(cfg.moe_token_chunks) + ' chunks' if ep_axis == 'data' else ''}"
            f", mesh {mesh_shape}, {bb} x {ss} tokens): {int(gate.sum())} of {bb * ss} tokens routed alike and "
            f"kept on both sides held, {held}; routes differ on {int((~(ids_ep == ids_local).all(1)).sum())}, "
            f"dropped {int((~kept_ep).sum())} (EP) and {int((~kept_local).sum())} (moe_local); rank seconds "
            f"{max(r[name][2] for r in ranks):.2f}")
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else float("nan")
    log(f"phase moe ep full: peak {peak:.2f} GB allocated here, {max(r['peak'] for r in ranks):.2f} GB a rank; "
        f"phase {time.perf_counter() - t_phase:.1f} s; {card}")
    del cases
    if on_card:
        torch.cuda.ipc_collect()


# ---------------------------------------------------------------------------
# "mesh train full", "mesh lm full", "mesh models full": the models under a ("data", "model") mesh of ranks that
# share the card (gloo: NCCL refuses two ranks on one card); four ranks on one card say nothing of NVLink
# ---------------------------------------------------------------------------

def _on_mesh(torch, device):
    """The (2, 2) mesh of the rank's world, TF32 off."""
    from repro_torch.distributed.mesh_utils import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    return make_mesh(MESH["shape"], ("data", "model"), device)


def _sync(torch, device):
    if device == "cuda":
        torch.cuda.synchronize()


_ERR_ROWS = 1 << 24     # the mesh phases' comparisons run in f64 over slices of about this many elements


def _slices(t):
    """Views of ``t`` over its first axis of about _ERR_ROWS elements each:
    four ranks and the parent share the card, and an f64 copy of a whole
    151,936-row embedding is 2.5 GB a temporary."""
    if t.dim() == 0 or t.numel() <= _ERR_ROWS:
        return [slice(None)]
    step = max(1, _ERR_ROWS // max(1, t[0].numel()))
    return [slice(i, i + step) for i in range(0, t.shape[0], step)]


def _pair(whole, got):
    """(the block of ``whole`` laid out as ``got``, ``got``'s local block),
    ``whole`` on ``got``'s device."""
    w = _local_of(whole, got)
    g = _local(got).detach()
    return w.detach().to(g.device), g


def _block_err(torch, whole, got, floor=0.0):
    """leaf_err of this rank's block ``got`` (a DTensor or a tensor) of a
    leaf held whole as ``whole``, in slices."""
    w, g = _pair(whole, got)
    assert w.shape == g.shape and bool(torch.isfinite(w).all()) and bool(torch.isfinite(g).all())
    scale = max(float(w.abs().max()), floor, 1e-30)
    return max(float((g[sl].double() - w[sl].double()).abs().max()) for sl in _slices(w)) / scale


def _first_step_err(torch, whole, got, m_whole, lr, floor, b1=0.9, eps=1e-8):
    """``adamw_first_step_err`` of this rank's block, in slices (the leaf's
    scales taken over the whole block first)."""
    w, t = _pair(whole, got)
    m = _local_of(m_whole, got).detach().to(t.device)
    d = TRAIN_TOL * max(float(m.abs().max()) / (1 - b1), floor)
    wmax = float(w.abs().max())
    u = lambda x: x / (x.abs() + eps)   # noqa: E731
    worst = 0.0
    for sl in _slices(w):
        g = m[sl].double() / (1 - b1)
        moves = torch.maximum((u(g + d) - u(g)).abs(), (u(g - d) - u(g)).abs())
        bound = TRAIN_TOL * wmax + lr * moves
        worst = max(worst, float(((t[sl].double() - w[sl].double()).abs() / bound.clamp_min(1e-300)).max()))
    return worst


def _drift_err(torch, whole, got, lr, steps, wd=0.1):
    """The worst error of a block of parameters after ``steps`` AdamW steps
    over its bound: TRAIN_TOL of the leaf's scale plus 2 lr steps (1.001 +
    wd max|p|) (MESH_ADAMW_RATIO's reasoning); <= 1 holds."""
    w, g = _pair(whole, got)
    scale = float(w.abs().max())
    bound = TRAIN_TOL * scale + 2 * lr * steps * (MESH_ADAMW_RATIO + wd * scale)
    return max(float((g[sl].double() - w[sl].double()).abs().max()) for sl in _slices(w)) / bound


class _FirstStep:
    """Wraps ``launch.train.make_lm_train_step`` while in use: the
    parameters and the AdamW moments after the first step, cloned, and the
    seconds of each step (synchronised)."""

    def __init__(self, torch, train_mod, device):
        self.torch, self.mod, self.device = torch, train_mod, device
        self.after, self.seconds = None, []

    def __enter__(self):
        self.orig, torch = self.mod.make_lm_train_step, self.torch

        def make(cfg, ctx, lr):
            step, opt = self.orig(cfg, ctx, lr=lr)

            def wrapped(params, state, batch):
                _sync(torch, self.device)
                t0 = time.perf_counter()
                out = step(params, state, batch)
                _sync(torch, self.device)
                self.seconds.append(time.perf_counter() - t0)
                if self.after is None:
                    clone = lambda t: t.detach().clone()   # noqa: E731 (DTensor clones keep their placement)
                    self.after = ({k: clone(p) for k, p in params.named_parameters()},
                                  {k: clone(v) for k, v in state.m.items()}, {k: clone(v) for k, v in state.v.items()})
                return out

            return wrapped, opt

        self.mod.make_lm_train_step = make
        return self

    def __exit__(self, *exc):
        self.mod.make_lm_train_step = self.orig


def _route_log(torch, M, aux_blocks):
    """Wraps ``moe.route`` and ``moe.moe_local`` on one process to record
    each call's expert ids; ``aux_blocks`` = (B, S, rows, cols):
    ``moe_local``'s balance loss replaced by the mean of each (rows x cols)
    token block's, the mesh's ``pmean`` of its ranks' losses.  A remat's
    recompute routes again (and may stop right after: PyTorch ends a
    recompute once it has what the backward needs), so a call is told by
    its route, not by the layer that made it."""
    log_ids, orig_route, orig_local = [], M.route, M.moe_local

    def route(x, wg, k):
        ids, w, aux = orig_route(x, wg, k)
        log_ids.append(ids.detach())
        return ids, w, aux

    def local(params, x, cfg):
        y, _ = orig_local(params, x, cfg)
        b, s, rows, cols = aux_blocks
        xb = x.reshape(b, s, -1)
        auxs = [orig_route(xb[i:i + b // rows, j:j + s // cols].reshape(-1, x.shape[-1]), params["wg"], cfg.top_k)[2]
                for i in range(0, b, b // rows) for j in range(0, s, s // cols)]
        return y, torch.stack(auxs).mean()

    M.route, M.moe_local = route, local

    def undo():
        M.route, M.moe_local = orig_route, orig_local
    return log_ids, undo


def _mesh_train_rank(rank, world, device, sizes, seed, cfg_a, a_want, cfg_b, ckpt):
    """A rank of "mesh train full".  (a) ``train_lm`` over the mesh; its
    losses, the first step's parameters and moments and the last step's
    parameters held against the one-process run's (``a_want``) on the
    card.  (b) the bf16 model: ``b_steps`` steps of the mesh step, timed,
    checkpointed after ``b_save``; restored in place and the steps after it
    run again, bit for bit.  ``sizes`` is the parent's MESH (a spawned rank
    imports this module afresh)."""
    import os

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import device_put_batch, lm_batches
    from repro_torch.distributed.sharding import ParallelCtx, distribute_module
    from repro_torch.launch import train as TRN
    from repro_torch.launch.steps import make_lm_train_step
    from repro_torch.models import transformer as T

    MESH.update(sizes)
    mesh = _on_mesh(torch, device)
    out = {}
    t_rank = time.perf_counter()
    # (a)
    with _FirstStep(torch, TRN, device) as rec:
        model, losses = TRN.train_lm(cfg_a, mesh, MESH["a_steps"], None, batch_size=MESH["a_b"],
                                     seq_len=MESH["a_s"], device=device, seed=seed, log_every=10 ** 9)
    p1, m1, v1 = rec.after
    lr = 3e-4
    want_p1, want_m1, want_v1, want_p = a_want["p1"], a_want["m1"], a_want["v1"], a_want["p"]
    out["a_losses"] = losses
    # a gradient that vanishes in exact arithmetic (qwen's key bias) is noise on both sides: held against
    # GRAD_FLOOR of the model's largest gradient, m / (1 - b1), as train full's step_parity holds it
    g_floor = GRAD_FLOOR * max(float(m.abs().max()) for m in want_m1.values()) / (1 - 0.9)
    out["a_first"] = max(_first_step_err(torch, want_p1[k], p1[k], want_m1[k], lr, g_floor) for k in p1)
    out["a_m"] = max((_block_err(torch, want_m1[k], m1[k], (1 - 0.9) * g_floor), k) for k in m1)
    out["a_v"] = max((_block_err(torch, want_v1[k], v1[k], (1 - 0.95) * g_floor ** 2), k) for k in v1)
    out["a_params"] = max(_drift_err(torch, want_p[k], p, lr, MESH["a_steps"]) for k, p in model.named_parameters())
    out["a_seconds"] = rec.seconds
    out["a_s"] = time.perf_counter() - t_rank
    t_rank = time.perf_counter()
    del model, rec, p1, m1, v1
    gc.collect()
    # (b)
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ctx = ParallelCtx(mesh, dict(cfg_b.rules))
    model, axes = T.init_transformer(cfg_b, seed=seed, device=device)
    distribute_module(model, axes, ctx)
    step, opt = make_lm_train_step(cfg_b, ctx, lr=3e-4)
    state = opt.init(model)
    data = lm_batches(np.random.default_rng(seed).integers(0, cfg_b.vocab_size, size=500_000).astype(np.int32),
                      MESH["b_b"], MESH["b_s"], seed=seed)
    batches = [device_put_batch(next(data), device) for _ in range(MESH["b_steps"])]
    secs, losses = [], []
    where = os.path.join(ckpt, "b")        # one directory for every rank: the writer's
    mgr = CheckpointManager(where, interval=MESH["b_save"])
    save_s = float("nan")
    for i, b in enumerate(batches):
        _sync(torch, device)
        t0 = time.perf_counter()
        _, _, m = step(model, state, b)
        losses.append(float(m["loss"]))
        _sync(torch, device)
        secs.append(time.perf_counter() - t0)
        if i + 1 == MESH["b_save"]:
            t0 = time.perf_counter()
            mgr.save(i + 1, {"params": model, "opt": state})
            save_s = time.perf_counter() - t0
    out["b_peak"] = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else float("nan")
    keep = lambda: ({k: _local(p).clone() for k, p in model.named_parameters()},   # noqa: E731
                    {k: _local(v).clone() for k, v in state.m.items()})
    unbroken = keep()
    t0 = time.perf_counter()
    at, _ = mgr.restore_latest({"params": model, "opt": state})
    restore_s = time.perf_counter() - t0
    assert at == MESH["b_save"]
    for b in batches[MESH["b_save"]:]:
        step(model, state, b)
    again = keep()
    out["b_bitwise"] = all(torch.equal(unbroken[0][k], again[0][k]) for k in unbroken[0]) and all(
        torch.equal(unbroken[1][k], again[1][k]) for k in unbroken[1])
    out.update(b_secs=secs, b_losses=losses, b_save_s=save_s, b_restore_s=restore_s,
               b_s=time.perf_counter() - t_rank)
    del model, state, unbroken, again, batches
    gc.collect()
    return out


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _local_of(whole, like):
    """This rank's block of ``whole`` laid out as ``like``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import NamedSharding, local_block

    return local_block(whole, NamedSharding.of(like)) if isinstance(like, DTensor) else whole


def _pinned_route(torch, M, pins, where, near):
    """Wraps ``moe.route`` on a rank: call ``c`` routes this rank's tokens
    (``where["now"]``: their rows and positions) as one process routed
    them (``pins[c]``, ids ``[B, S, k]``), after asserting that each
    decision that differs is a near-tie (the two experts' probabilities
    within ``near`` of the token's largest); the weights and the balance
    loss from this rank's own probabilities.  Returns (the log of (where,
    ids) each call, the flips, the largest gap of a flip, undo)."""
    log_ids, orig, state = [], M.route, {"calls": 0, "flips": 0, "gap": 0.0}

    def route(x, wg, k):
        ids, w, aux = orig(x, wg, k)
        b0, s0, bl, sl = where["now"]
        want = torch.from_numpy(pins[state["calls"]][b0:b0 + bl, s0:s0 + sl]).to(ids.device).reshape(-1, k)
        state["calls"] += 1
        log_ids.append((where["now"], ids.detach()))
        differ = (ids != want.to(ids.dtype)).any(dim=-1)
        if not bool(differ.any()):
            return ids, w, aux
        probs = torch.softmax(x.float() @ wg, dim=-1)
        for r in differ.nonzero()[:, 0].tolist():
            gap = float((probs[r, ids[r].long()] - probs[r, want[r].long()]).abs().max().detach()
                        / probs[r].max().detach())
            assert gap <= near, f"route call {state['calls'] - 1}: a flip {gap:.3g} apart is not a near-tie"
            state["gap"] = max(state["gap"], gap)
        state["flips"] += int(differ.sum())
        e = wg.shape[1]
        wv = torch.gather(probs, 1, want.long())
        wv = wv / torch.clamp_min(wv.sum(dim=-1, keepdim=True), 1e-9)
        f_e = torch.nn.functional.one_hot(want.long(), e).float().sum(dim=1).mean(dim=0)
        return want.to(ids.dtype), wv.to(x.dtype), e * torch.sum(f_e * probs.mean(dim=0))

    M.route = route

    def undo():
        M.route = orig
    return log_ids, state, undo


def _mesh_zero_rank(rank, world, device, sizes, seed, cfg, batch, want_path, pins):
    """A rank of "mesh train full" (c): phi3.5-moe's ZeRO step over the mesh
    (``make_lm_train_step(params_axes=...)``, Adafactor, grad_accum 4), each
    MoE call's expert ids recorded with the rows and positions of the
    rank's tokens and pinned to one process's (``pins``, near-ties only),
    and its drops; the losses, parameters and state held
    against the one-process run's, read from the checkpoint at
    ``want_path`` leaf by leaf; the state's and the accumulator's bytes on
    this rank with ZeRO and without it.  The ranks draw the model from the
    seed two at a time (a whole f32 draw is 11 GB) and keep their blocks."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint.checkpoint import load_leaves
    from repro_torch.distributed.sharding import NamedSharding, ParallelCtx, block_slices, distribute_module
    from repro_torch.launch.steps import make_lm_train_step
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizer import MeshUpdate

    MESH.update(sizes)
    mesh = _on_mesh(torch, device)
    ctx = ParallelCtx(mesh, dict(cfg.rules))
    t0 = time.perf_counter()
    for turn in range(0, world, 2):
        if rank // 2 == turn // 2:
            model, axes = T.init_transformer(cfg, seed=seed, device=device)
            distribute_module(model, axes, ctx)
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    step, opt = make_lm_train_step(cfg, ctx, lr=STEP_LR, params_axes=axes)
    state = opt.init(model)
    upd = step.mesh_update(model)
    orig_apply, where, drops = M.moe_apply, {}, [0]

    def apply(params, x, cfg_, ctx_):
        (b0, bl), (s0, sl) = block_slices(x.shape, NamedSharding.of(x))[:2]
        where["now"] = (b0, s0, bl, sl)
        with DispatchRecorder(M) as rec:
            try:
                return orig_apply(params, x, cfg_, ctx_)
            finally:
                drops[0] += sum(int((~v).sum()) for _, v, _, _ in rec.calls[0::2])
                # the destination's bucketing counts its trash expert's slots: only real ids overflow there
                drops[0] += sum(int((~v[b < n - 1]).sum()) for b, v, n, _ in rec.calls[1::2])

    ids_log, pinned, undo = _pinned_route(torch, M, pins, where, MESH_MOE_NEAR)
    M.moe_apply = apply
    secs = {"draw": time.perf_counter() - t0, "steps": []}
    try:
        losses = []
        for mb in batch:
            _sync(torch, device)
            t0 = time.perf_counter()
            _, _, m = step(model, state, mb)
            losses.append(float(m["loss"]))
            secs["steps"].append(time.perf_counter() - t0)
    finally:
        M.moe_apply = orig_apply
        undo()
    t0 = time.perf_counter()
    out = {"losses": losses, "dropped": drops[0], "flips": pinned["flips"], "gap": pinned["gap"],
           "routes": [(b0, s0, bl, sl, ids.reshape(bl, sl, -1).cpu().numpy()) for (b0, s0, bl, sl), ids in ids_log]}
    want = load_leaves(want_path)
    key = lambda *parts: "/".join(parts).replace(".", "/")   # noqa: E731 (checkpoint paths)
    out["params"] = max(_block_err(torch, want[key("p", k)].to(device), p) for k, p in model.named_parameters())
    out["state"] = max(_block_err(torch, want[key(f, k)].to(device), v)
                       for f in ("vr", "vc") for k, v in getattr(state, f).items())

    def nbytes(u, like):
        return math.prod(n for _, n in block_slices(u.shape, NamedSharding(mesh, u.spec))) * like.element_size()

    leaves = dict(model.named_parameters())
    out["acc_bytes"] = sum(nbytes(u, _local(leaves[u.names[0]])) for u in upd.units)
    out["state_bytes"] = sum(_local(v).numel() * 4 for f in ("vr", "vc") for v in getattr(state, f).values())
    plain = MeshUpdate(upd.opt, model, mesh)       # the same optimizer without ZeRO's plan
    out["acc_bytes_plain"] = sum(nbytes(u, _local(leaves[u.names[0]])) for u in plain.units)
    st = plain.init(model)
    out["state_bytes_plain"] = sum(_local(v).numel() * 4 for f in ("vr", "vc") for v in getattr(st, f).values())
    out["peak"] = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else float("nan")
    secs["compare"] = time.perf_counter() - t0
    out["secs"] = secs
    return out


def _ep_holding_factor(cfg, rows, seq):
    """The smallest capacity factor of 2^k / 4 at which ``_ep_process``'s
    two bucketings hold every pair of a rank's tokens (a microbatch of
    ``rows`` x ``seq`` over MESH["shape"], experts over "model"), by its
    own capacity expressions."""
    n_ep = MESH["shape"][1]
    e_loc = cfg.n_experts // n_ep
    t = rows // MESH["shape"][0] * (seq // MESH["shape"][1])
    up = lambda x: (x + 7) // 8 * 8   # noqa: E731
    cf = 1.25
    while True:
        c1 = up(max(1, int(t * cfg.top_k / n_ep * cf)))
        c2 = min(up(max(1, int(n_ep * c1 / e_loc * cf))), up(n_ep * c1))
        if c1 >= t * cfg.top_k and c2 >= n_ep * t * cfg.top_k:
            return cf
        cf *= 2


def mesh_train_full_phase(torch, dev, card, on_card, seed, cfgs=None):
    """Training under a (2, 2) ("data", "model") mesh of DIST["world"] gloo
    ranks sharing the card, each model built from ``seed`` on every rank
    and distributed by ``params_sharding`` (the one-process runs draw the
    same weights).  (a) qwen2.5-3b at its published width (d_model 2048, 16
    heads / 2 KV, d_ff 11,008, vocabulary 151,936, QKV bias, tied) in f32 at
    MESH["a_layers"] layers: MESH["a_steps"] steps of
    ``train_lm(cfg, mesh, ...)`` against ``train_lm(cfg, None, ...)`` on
    the card: every step's loss within TRAIN_TOL, the first step's
    parameters within ``adamw_first_step_err``'s bound, its first moments
    within MESH_GRAD_TOL of a leaf's scale and its second within twice
    that, the last step's parameters within MESH_ADAMW_RATIO's drift
    bound.  (b) the same model in bf16 at
    MESH["b_layers"] layers, remat, AdamW, MESH["b_b"] x MESH["b_s"]
    tokens: ms a step on the slowest rank, tokens/s, peak GB a rank; a
    checkpoint after step MESH["b_save"] restored in place resumes bit for
    bit (parameters and moments) against the unbroken run.  (c) phi3.5-moe
    at its published width in f32 at MESH["c_layers"] layers, with its
    Adafactor, grad_accum 4 and ZeRO-1 through ``make_lm_train_step(
    params_axes=...)``: MESH["c_steps"] steps against the one-process step
    on the card (its balance loss the mean of the mesh's token blocks', as
    the mesh's ``pmean``; capacity factors at which neither side can drop a
    pair; a decision that flips held a near-tie within MESH_MOE_NEAR and
    routed as one process routed it), gated where both sides dropped
    none: the losses and parameters within TRAIN_TOL, Adafactor's factors
    (means of g^2) within twice MESH_GRAD_TOL;
    the optimizer state's and the gradient accumulator's bytes a rank with
    ZeRO and without it.  ``cfgs`` ((a)'s, (b)'s and (c)'s configs) cut the
    phase for a CPU rehearsal."""
    import shutil
    import tempfile

    from repro_torch.checkpoint.checkpoint import save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import device_put_batch, lm_batches
    from repro_torch.distributed.sharding import ParallelCtx
    from repro_torch.launch import train as TRN
    from repro_torch.launch.steps import make_lm_train_step
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    if cfgs is None:
        qwen = get_config("qwen2.5-3b")
        cfgs = (dataclasses.replace(qwen, n_layers=MESH["a_layers"], dtype="float32"),
                dataclasses.replace(qwen, n_layers=MESH["b_layers"], dtype="bfloat16", remat=True),
                dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b"), n_layers=MESH["c_layers"], dtype="float32"))
    cfg_a, cfg_b, cfg_c = cfgs
    # (c)'s capacities hold every pair on both sides, since the expert-parallel path bounds each rank's buckets
    # and one process each expert's, so that they drop different pairs, and a random model routes most tokens to
    # a few experts (at the published 1.25 both sides drop about a quarter of the pairs, not alike).  With
    # nothing dropped a capacity changes no value, only the buffers' size: one process takes E / top_k (an
    # expert holds all T tokens), the mesh the smallest factor whose two bucketings hold every pair
    # of a rank (c1 >= T_loc k for one destination, c2 >= n_ep T_loc k for one expert; 5 here, where 8 would
    # size the ranks' expert buffers past the card)
    cfg_c = dataclasses.replace(cfg_c, capacity_factor=cfg_c.n_experts / cfg_c.top_k)
    cfg_c_mesh = dataclasses.replace(cfg_c, capacity_factor=_ep_holding_factor(cfg_c, MESH["c_b"] // cfg_c.grad_accum,
                                                                                  MESH["c_s"]))
    # ---- (a) the one-process run, its first step's and last step's state kept on the card for the ranks
    with _FirstStep(torch, TRN, dev.type) as rec:
        model, losses_1 = TRN.train_lm(cfg_a, None, MESH["a_steps"], None, batch_size=MESH["a_b"],
                                       seq_len=MESH["a_s"], device=dev, seed=seed, log_every=10 ** 9)
    p1, m1, v1 = rec.after
    a_want = {"p1": p1, "m1": m1, "v1": v1, "p": {k: p.detach() for k, p in model.named_parameters()}}
    del model, rec
    gc.collect()
    where = tempfile.mkdtemp(prefix="mesh_train_")
    try:
        ranks = run_card_ranks(_mesh_train_rank, DIST["world"], dev.type, (dict(MESH), seed, cfg_a, a_want, cfg_b, where))
    finally:
        shutil.rmtree(where, ignore_errors=True)
    del a_want, p1, m1, v1
    gc.collect()
    if on_card:
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()
    loss_err = max(abs(got - want) / abs(want) for r in ranks for got, want in zip(r["a_losses"], losses_1))
    worst = {k: max(r[k] for r in ranks) for k in ("a_first", "a_m", "a_v", "a_params")}
    log(f"phase mesh train full: (a) {cfg_a.name} f32 at {cfg_a.n_layers} layers of full width, {MESH['a_steps']} "
        f"train_lm steps of {MESH['a_b']} x {MESH['a_s']} over mesh {MESH['shape']} against one process: losses "
        f"{[round(x, 6) for x in ranks[0]['a_losses']]} vs {[round(x, 6) for x in losses_1]} ({loss_err:.3g} apart); "
        f"first step's parameters {worst['a_first']:.3g} of adamw_first_step_err's bound, m {worst['a_m'][0]:.3g} "
        f"({worst['a_m'][1]}) and v {worst['a_v'][0]:.3g} ({worst['a_v'][1]}) of a leaf's scale (limits "
        f"{MESH_GRAD_TOL:g} and {2 * MESH_GRAD_TOL:g}); last step's parameters {worst['a_params']:.3g} of the drift "
        f"bound; step seconds on the slowest rank "
        f"{[round(max(r['a_seconds'][i] for r in ranks), 3) for i in range(MESH['a_steps'])]}; the ranks' (a) "
        f"{max(r['a_s'] for r in ranks):.1f} s, (b) {max(r['b_s'] for r in ranks):.1f} s")
    timed = range(MESH["b_save"], MESH["b_steps"])
    ms = 1e3 * max(float(np.mean([r["b_secs"][i] for i in timed])) for r in ranks)
    tokens = MESH["b_b"] * MESH["b_s"]
    log(f"phase mesh train full: (b) {cfg_b.name} bf16 at {cfg_b.n_layers} layers, remat, AdamW, {MESH['b_b']} x "
        f"{MESH['b_s']} tokens over mesh {MESH['shape']}: {ms:.1f} ms a step on the slowest rank (mean of steps "
        f"{MESH['b_save'] + 1}-{MESH['b_steps']}; first steps {[round(1e3 * max(r['b_secs'][i] for r in ranks), 1) for i in range(MESH['b_save'])]} ms), "
        f"{tokens / ms * 1e3:.0f} tokens/s, peak {max(r['b_peak'] for r in ranks):.2f} GB a rank; losses "
        f"{[round(x, 4) for x in ranks[0]['b_losses']]}; checkpoint at step {MESH['b_save']} saved in "
        f"{ranks[0]['b_save_s']:.1f} s, restored in {max(r['b_restore_s'] for r in ranks):.1f} s, resumed bit for "
        f"bit; {card} (four ranks share one card: no figure says anything of NVLink)")
    assert loss_err <= TRAIN_TOL, f"mesh train full (a): losses {loss_err:.3g} apart"
    assert worst["a_first"] <= 1.0, f"mesh train full (a): the first step's parameters {worst['a_first']:.3g} of the bound"
    assert worst["a_m"][0] <= MESH_GRAD_TOL, f"mesh train full (a): m {worst['a_m']} of a leaf's scale"
    assert worst["a_v"][0] <= 2 * MESH_GRAD_TOL, f"mesh train full (a): v {worst['a_v']} of a leaf's scale"
    assert worst["a_params"] <= 1.0, f"mesh train full (a): parameters {worst['a_params']:.3g} of the drift bound"
    assert all(r["b_bitwise"] for r in ranks), "mesh train full (b): the resumed run is not bit for bit the unbroken one"
    assert all(math.isfinite(x) for r in ranks for x in r["b_losses"])
    # ---- (c) phi3.5-moe's ZeRO step: the one-process run first, its results kept on the card for the ranks
    c_b, c_s = MESH["c_b"], MESH["c_s"]
    data = lm_batches(np.random.default_rng(seed + 1).integers(0, cfg_c.vocab_size, size=500_000).astype(np.int32),
                      c_b, c_s, seed=seed + 1)
    batch = [device_put_batch(next(data), dev) for _ in range(MESH["c_steps"])]
    model, axes = T.init_transformer(cfg_c, seed=seed, device=dev)
    step, opt = make_lm_train_step(cfg_c, ParallelCtx(None, dict(cfg_c.rules)), lr=STEP_LR, params_axes=axes)
    state = opt.init(model)
    k = cfg_c.grad_accum
    ids_log, undo = _route_log(torch, M, aux_blocks=(c_b // k, c_s) + MESH["shape"])
    t_c = time.perf_counter()
    try:
        with DispatchRecorder(M) as drec:
            losses_c = [float(step(model, state, mb)[2]["loss"]) for mb in batch]
    finally:
        undo()
    t_one = time.perf_counter() - t_c
    dropped_1 = sum(int((~v).sum()) for _, v, _, _ in drec.calls)
    ids_1 = [i.reshape(c_b // k, c_s, -1) for i in ids_log]
    where = tempfile.mkdtemp(prefix="mesh_zero_")
    try:
        t_c = time.perf_counter()
        want_path = save_checkpoint(where, MESH["c_steps"], {"p": model, "vr": state.vr, "vc": state.vc})
        t_save = time.perf_counter() - t_c
        t_c = time.perf_counter()
        del model, step, opt, drec, state
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        pins = [i.cpu().numpy() for i in ids_1]
        zr = run_card_ranks(_mesh_zero_rank, DIST["world"], dev.type,
                            (dict(MESH), seed, cfg_c_mesh, batch, want_path, pins))
        t_ranks = time.perf_counter() - t_c
    finally:
        shutil.rmtree(where, ignore_errors=True)
    del batch
    gc.collect()
    if on_card:
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()
    # the mesh's routes, assembled by each rank's rows and positions, against one process's, call by call
    differ = dropped = 0
    n_calls = len(ids_1)
    for r in zr:
        assert len(r["routes"]) == n_calls, f"mesh train full (c): {len(r['routes'])} routings on a rank, {n_calls} in one"
        for c, (b0, s0, bl, sl, ids) in enumerate(r["routes"]):
            ids = torch.from_numpy(ids).to(ids_1[c].device)
            differ += int((ids != ids_1[c][b0:b0 + bl, s0:s0 + sl]).any(-1).sum())
        dropped += r["dropped"]
    flips = sum(r["flips"] for r in zr)
    alike = differ == flips and dropped == 0 and dropped_1 == 0   # every differing decision a pinned near-tie
    errs = {kk: max(r[kk] for r in zr) for kk in ("params", "state")}
    loss_err = max(abs(a - b) / abs(b) for r in zr for a, b in zip(r["losses"], losses_c))
    gb = lambda x: x / 1e9   # noqa: E731
    log(f"phase mesh train full: (c) {cfg_c.name} f32 at {cfg_c.n_layers} layers of full width (E {cfg_c.n_experts}, "
        f"d {cfg_c.d_model}, capacity factors {cfg_c.capacity_factor:g} one process and "
        f"{cfg_c_mesh.capacity_factor:g} the mesh), Adafactor, grad_accum {k}, ZeRO-1, {MESH['c_steps']} steps of {c_b} x {c_s} over mesh "
        f"{MESH['shape']}: {n_calls} routings a rank, {differ} decisions near-ties that flipped (largest gap "
        f"{max(r['gap'] for r in zr):.3g} of a token's largest probability, pinned to one process's), dropped "
        f"{dropped} (mesh) and {dropped_1} (one process); {'gated' if alike else 'NOT gated (drops)'}: losses "
        f"{loss_err:.3g} apart, parameters {errs['params']:.3g} and state {errs['state']:.3g} of a leaf's scale; "
        f"per rank: optimizer state {gb(zr[0]['state_bytes']):.4f} GB with ZeRO, {gb(zr[0]['state_bytes_plain']):.4f} "
        f"GB without; gradient accumulator {gb(zr[0]['acc_bytes']):.2f} GB with ZeRO, "
        f"{gb(zr[0]['acc_bytes_plain']):.2f} GB without; peak {max(r['peak'] for r in zr):.2f} GB a rank; seconds: "
        f"one process's steps {t_one:.1f}, its checkpoint {t_save:.1f}, the ranks {t_ranks:.1f} (draws "
        f"{max(r['secs']['draw'] for r in zr):.1f}, steps {[round(max(r['secs']['steps'][i] for r in zr), 2) for i in range(MESH['c_steps'])]}, "
        f"comparison {max(r['secs']['compare'] for r in zr):.1f})")
    assert alike, "mesh train full (c): a side dropped a pair"
    assert loss_err <= TRAIN_TOL, f"mesh train full (c): losses {loss_err:.3g} apart"
    assert errs["params"] <= TRAIN_TOL, f"mesh train full (c): parameters {errs['params']:.3g} of a leaf's scale"
    # Adafactor's factors average g^2 over a leaf's rows and columns: a gradient's relative error twice over
    assert errs["state"] <= 2 * MESH_GRAD_TOL, f"mesh train full (c): Adafactor's state {errs['state']:.3g}"
    log(f"phase mesh train full: {time.perf_counter() - t_phase:.1f} s; {card}")


def _mesh_lm_rank(rank, world, device, sizes, seed, cases, din, mol):
    """A rank of "mesh lm full" and "mesh models full": each LM's prefill
    under ``rules_for_shape``'s prefill rules and its decode under the
    decode rules, the one-process greedy tokens fed; DIN's forward and
    retrieval over its row-sharded tables (the parent's weights, mapped);
    one SchNet step.  Returns what the parent holds against one process."""
    import torch

    from repro_torch.configs.base import LMShape, RecSysShape
    from repro_torch.distributed.sharding import ParallelCtx, distribute_module
    from repro_torch.launch.steps import make_gnn_train_step, rules_for_shape
    from repro_torch.models import recsys as R
    from repro_torch.models import schnet as S
    from repro_torch.models import transformer as T

    MESH.update(sizes)
    mesh = _on_mesh(torch, device)
    out = {}
    with torch.no_grad():
        for name, (cfg, prompt, toks) in cases.items():
            b, s = prompt.shape
            r = {}
            pcfg = dataclasses.replace(cfg, rules=rules_for_shape(cfg, LMShape("prefill", s, b, "prefill"), mesh))
            pctx = ParallelCtx(mesh, pcfg.rules)
            model, axes = T.init_transformer(pcfg, seed=seed, device=device)
            distribute_module(model, axes, pctx)
            _sync(torch, device)
            t0 = time.perf_counter()
            r["prefill"] = T.prefill_step(model, prompt, pcfg, pctx)
            _sync(torch, device)
            r["prefill_s"] = time.perf_counter() - t0
            del model
            dcfg = dataclasses.replace(cfg, rules=rules_for_shape(cfg, LMShape("decode", MESH["cache"], b, "decode"),
                                                                  mesh))
            dctx = ParallelCtx(mesh, dcfg.rules)
            model, axes = T.init_transformer(dcfg, seed=seed, device=device)
            distribute_module(model, axes, dctx)
            cache = T.init_cache(dcfg, b, MESH["cache"], device, ctx=dctx)
            logits, secs = [], []
            for pos in range(MESH["decode"]):
                _sync(torch, device)
                t0 = time.perf_counter()
                lg, cache = T.decode_step(model, cache, toks[pos], pos, dcfg, dctx)
                _sync(torch, device)
                secs.append(time.perf_counter() - t0)
                logits.append(lg)
            r["decode"], r["decode_s"] = torch.stack(logits), secs
            r["rules"] = (dict(pcfg.rules), dict(dcfg.rules))
            del model, cache
            out[name] = r
        cfg, tree, batch, rbatch, k = din
        ctx = ParallelCtx(mesh, dict(cfg.rules))
        model = distribute_module(R.RecSys(cfg, tree), R.init_recsys(cfg, device="meta")[1], ctx)
        out["din_logits"] = R.forward_logits(model, cfg, batch, ctx).to_local()
        rr = rules_for_shape(cfg, RecSysShape("retrieval_cand", 1, kind="retrieval"), mesh)
        rcfg = dataclasses.replace(cfg, rules=rr)
        rctx = ParallelCtx(mesh, rr)
        rmodel = distribute_module(R.RecSys(rcfg, tree), R.init_recsys(rcfg, device="meta")[1], rctx)
        _sync(torch, device)
        t0 = time.perf_counter()
        out["din_ret"] = R.retrieval_scores(rmodel, rcfg, rbatch, rctx, k=k)
        _sync(torch, device)
        out["din_ret_s"] = time.perf_counter() - t0
        out["din_rows"] = tuple(model.tables["item"].to_local().shape)
        del model, rmodel
    scfg, stree, g, n_graphs = mol
    sctx = ParallelCtx(mesh, dict(scfg.rules))
    smodel = distribute_module(S.SchNet(scfg, {k_: (v.clone() if isinstance(v, torch.Tensor) else
                                                    [{kk: {x: t.clone() for x, t in d.items()} for kk, d in b.items()}
                                                     for b in v] if isinstance(v, list) else
                                                    {x: t.clone() for x, t in v.items()})
                                               for k_, v in stree.items()}),
                               S.init_schnet(scfg, device="meta")[1], sctx)
    step, opt = make_gnn_train_step(scfg, sctx, n_graphs=n_graphs)
    state = opt.init(smodel)
    _sync(torch, device)
    t0 = time.perf_counter()
    _, _, m = step(smodel, state, g)
    _sync(torch, device)
    out["mol_s"] = time.perf_counter() - t0
    out["mol_loss"] = float(m["loss"])
    out["mol_params"] = {k_: _local(p).detach().clone() for k_, p in smodel.named_parameters()}
    out["peak"] = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else float("nan")
    return _to_numpy(torch, out)


def _to_numpy(torch, tree):
    """A rank's result with every tensor as a numpy array: a CPU tensor sent
    back is a shared-memory handle that dies with the rank."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(torch, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(torch, v) for v in tree)
    return tree


def mesh_lm_models_full_phase(torch, dev, card, on_card, seed, lm_cfgs=None, din_cfg=None, mol_cfg=None):
    """"mesh lm full": qwen2.5-3b (GQA) and minicpm3-4b (MLA, 40 heads padded
    to 48, vocabulary 73,448 padded to 73,472) at their published widths, f32
    at MESH["lm_layers"] layers, under ``rules_for_shape``'s rules on the
    (2, 2) mesh: the prefill of MESH["prefill"] tokens (batch on "data", the
    sequence on "model"), then MESH["decode"] decode steps against a
    MESH["cache"]-position cache (weights split on "embed", the cache's
    sequence on "model"), fed one process's greedy tokens; each held
    against one process on the card within LM_TOL of a row's largest |logit|
    (the real vocabulary; the padded columns at f32-min), the greedy tokens
    equal.  "mesh models full": DIN as published (100M items, 8.0 GB of
    tables drawn here and mapped by the ranks, the tables row-sharded over
    "model"): ``forward_logits`` of MESH["din_b"] users within TOL_REL, and
    ``retrieval_scores`` over MESH["din_cand"] candidates under the
    retrieval rules (split over ("data", "model")): the top-k ids equal,
    the scores within TOL_REL; SchNet as published: one
    ``make_gnn_train_step`` step on MESH["mol"] molecules (edges over every
    axis) against one process: the loss within TRAIN_TOL, the parameters
    within ``adamw_first_step_err``'s bound.  One set of ranks runs both."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import ParallelCtx
    from repro_torch.launch.steps import make_gnn_train_step
    from repro_torch.models import recsys as R
    from repro_torch.models import schnet as S
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    g = torch.Generator(dev).manual_seed(seed)
    if lm_cfgs is None:
        lm_cfgs = [dataclasses.replace(get_config(a), n_layers=MESH["lm_layers"], dtype="float32")
                   for a in ("qwen2.5-3b", "minicpm3-4b")]
    cases, want = {}, {}
    b, s = MESH["prefill"]
    with torch.no_grad():
        for cfg in lm_cfgs:
            model, _ = T.init_transformer(cfg, seed=seed, device=dev)
            ctx = ParallelCtx(None, dict(cfg.rules))
            prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=dev, dtype=torch.int32)
            t0 = time.perf_counter()
            pre = T.prefill_step(model, prompt, cfg, ctx)
            sync(torch, on_card)
            pre_s = time.perf_counter() - t0
            cache = T.init_cache(cfg, b, MESH["cache"], dev)
            tok = pre[:, :cfg.vocab_size].argmax(-1, keepdim=True).int()
            toks, logits = [], []
            for pos in range(MESH["decode"]):
                toks.append(tok)
                lg, cache = T.decode_step(model, cache, tok, pos, cfg, ctx)
                logits.append(lg)
                tok = lg[:, :cfg.vocab_size].argmax(-1, keepdim=True).int()
            cases[cfg.name] = (cfg, prompt, torch.stack(toks))
            want[cfg.name] = (pre, torch.stack(logits), pre_s)
            del model, cache
            gc.collect()
    # DIN: the weights drawn once here (the ranks map them), one process's answers first
    if din_cfg is None:
        din_cfg = get_config(RECSYS["arch"])
    din, _ = R.init_recsys(din_cfg, seed=seed, device=dev)
    tree = {name: (sub if isinstance(sub, torch.Tensor) else
                   [dict(x.items()) for x in sub] if isinstance(sub, torch.nn.ModuleList) else
                   {k: (dict(v.items()) if isinstance(v, torch.nn.ParameterDict) else v) for k, v in sub.items()})
            for name, sub in list(din.named_parameters(recurse=False)) + list(din.named_children())}
    tree = _detached_tree(torch, tree)
    batch = recsys_batch(torch, din_cfg, MESH["din_b"], g, dev)
    rbatch = recsys_batch(torch, din_cfg, 1, g, dev, n_cand=MESH["din_cand"])
    with torch.no_grad():
        ctx = ParallelCtx(None, dict(din_cfg.rules))
        din_logits = R.forward_logits(din, din_cfg, batch, ctx)
        din_ret = R.retrieval_scores(din, din_cfg, rbatch, ctx, k=RECSYS["k"])
    del din
    # SchNet: one process's step
    if mol_cfg is None:
        mol_cfg = get_config("schnet")
    mol, _ = S.init_schnet(mol_cfg, seed=seed, device=dev)
    stree = _detached_tree(torch, {name: (sub if isinstance(sub, torch.Tensor) else
                                          [{k: dict(v.items()) for k, v in blk.items()} for blk in sub]
                                          if isinstance(sub, torch.nn.ModuleList) else dict(sub.items()))
                                   for name, sub in list(mol.named_parameters(recurse=False)) +
                                   list(mol.named_children())}, copy=True)   # the step below updates mol in place
    gbatch = molecule_batch(torch, mol_cfg, MESH["mol"], g, dev)
    step, opt = make_gnn_train_step(mol_cfg, ParallelCtx(None, dict(mol_cfg.rules)), n_graphs=MESH["mol"])
    state = opt.init(mol)
    _, _, m = step(mol, state, gbatch)
    mol_loss = float(m["loss"])
    mol_params = {k: p.detach() for k, p in mol.named_parameters()}
    mol_m = dict(state.m)
    if on_card:
        torch.cuda.empty_cache()
    ranks = run_card_ranks(_mesh_lm_rank, DIST["world"], dev.type,
                           (dict(MESH), seed, cases, (din_cfg, tree, batch, rbatch, RECSYS["k"]),
                            (mol_cfg, stree, gbatch, MESH["mol"])))
    ranks = [_from_numpy(torch, r) for r in ranks]
    for name, (cfg, prompt, toks) in cases.items():
        pre, dec, pre_s = want[name]
        v = cfg.vocab_size
        errs = [row_err(torch, r[name]["prefill"], pre) for r in ranks]
        derrs = [row_err(torch, r[name]["decode"][..., :v], dec[..., :v]) for r in ranks]
        assert max(errs) <= LM_TOL, f"mesh lm full: {name} prefill {max(errs):.3g} of a row's largest |logit|"
        assert max(derrs) <= LM_TOL, f"mesh lm full: {name} decode {max(derrs):.3g} of a row's largest |logit|"
        greedy = torch.stack([r[name]["decode"][..., :v].argmax(-1) for r in ranks])
        want_greedy = dec[..., :v].argmax(-1).cpu()
        assert bool((greedy == want_greedy).all()), f"mesh lm full: {name}'s greedy tokens differ"
        if cfg.padded_vocab != v:
            assert all(bool((r[name]["decode"][..., v:] == NEG).all()) for r in ranks), "padded vocabulary unmasked"
        log(f"phase mesh lm full: {name} f32 at {cfg.n_layers} layers of full width over mesh {MESH['shape']}: "
            f"prefill {b} x {s} ({ranks[0][name]['rules'][0]['batch']} batch, seq over "
            f"{ranks[0][name]['rules'][0]['seq_act']}) {max(errs):.3g} of a row's largest |logit| "
            f"(one process {1e3 * pre_s:.1f} ms, the ranks {1e3 * max(r[name]['prefill_s'] for r in ranks):.1f} ms); "
            f"{MESH['decode']} decode steps over a {MESH['cache']}-position cache (kv_seq over "
            f"{ranks[0][name]['rules'][1]['kv_seq']}, embed over {ranks[0][name]['rules'][1]['embed']}) "
            f"{max(derrs):.3g}, greedy tokens equal; a decode step {1e3 * float(np.median([x for r in ranks for x in r[name]['decode_s'][1:]])):.1f} ms "
            f"on the ranks (median)")
    got = torch.cat([r["din_logits"] for r in ranks[::MESH["shape"][1]]])
    err = row_err(torch, got[None], din_logits.cpu()[None])
    assert err <= TOL_REL, f"mesh models full: DIN logits {err:.3g} of their largest"
    vals, ids = din_ret
    for r in ranks:
        assert torch.equal(r["din_ret"][1], ids.cpu()), "mesh models full: DIN's retrieved ids differ"
        assert row_err(torch, r["din_ret"][0], vals) <= TOL_REL
    log(f"phase mesh models full: DIN ({din_cfg.item_vocab:,} items, item rows {ranks[0]['din_rows'][0]:,} a rank) "
        f"forward of {MESH['din_b']} users {err:.3g} of the largest logit; retrieval over {MESH['din_cand']:,} "
        f"candidates split over (data, model): top-{RECSYS['k']} ids equal, scores within {TOL_REL} "
        f"({1e3 * max(r['din_ret_s'] for r in ranks):.1f} ms on the slowest rank)")
    m_new = {k: v.detach() for k, v in mol_m.items()}
    worst = max(adamw_first_step_err(torch, mol_params[k], r["mol_params"][k].to(dev), m_new[k], 1e-3, 0.0)
                for r in ranks for k in mol_params)
    lerr = max(abs(r["mol_loss"] - mol_loss) / abs(mol_loss) for r in ranks)
    assert lerr <= TRAIN_TOL and worst <= 1.0, f"mesh models full: SchNet step loss {lerr:.3g}, parameters {worst:.3g}"
    log(f"phase mesh models full: SchNet ({mol_cfg.n_interactions} interactions, d {mol_cfg.d_hidden}) one step of "
        f"{MESH['mol']} molecules, edges over every axis: loss {lerr:.3g} apart, parameters {worst:.3g} of "
        f"adamw_first_step_err's bound ({1e3 * max(r['mol_s'] for r in ranks):.1f} ms on the slowest rank); peak "
        f"{max(r['peak'] for r in ranks):.2f} GB a rank; phase {time.perf_counter() - t_phase:.1f} s; {card} "
        f"(four ranks share one card: no figure says anything of NVLink)")
    del tree, stree, batch, rbatch, gbatch, mol, state, cases, want
    gc.collect()
    if on_card:
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()


def _from_numpy(torch, tree):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, dict):
        return {k: _from_numpy(torch, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_from_numpy(torch, v) for v in tree)
    return tree


def _detached_tree(torch, tree, copy=False):
    """Nested dicts and lists of parameters as plain tensors (no grad;
    copies with ``copy``)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone() if copy else tree.detach()
    if isinstance(tree, list):
        return [_detached_tree(torch, x, copy) for x in tree]
    return {k: _detached_tree(torch, v, copy) for k, v in tree.items()}


def sync(torch, on_card):
    if on_card:
        torch.cuda.synchronize()


# ---- the dry run ("dryrun") ------------------------------------------------

# the dry run's sweep (every cell on both production meshes) and its card check: the cells traced on a
# world of one rank and then run once on the card (an LM's batch cut to the rows given)
DRYRUN = dict(workers=8, limit_s=300.0, mem_rel=0.10, mem_abs=0.5e9, flops_rel=0.01,
              cells=(("smollm-360m", "train_4k", 4), ("qwen2.5-3b", "decode_32k", 16),
                     ("din", "retrieval_cand", None)))
HERE = Path(__file__).resolve().parent


def dryrun_sweep_start(on_card):
    """Start ``python -m repro_torch.launch.dryrun --both-meshes`` in the
    background, at the lowest CPU priority (``nice`` 19) and without the
    card (fake CPU tensors, no CUDA context), so that the card check, which
    times nothing, runs beside it; a CPU rehearsal sweeps one cell.
    Returns what ``dryrun_phase`` waits for."""
    import os
    import tempfile

    out = tempfile.mkdtemp(prefix="dryrun_")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--both-meshes", "--device", "cpu",
           "--workers", str(DRYRUN["workers"]), "--out", out]
    if not on_card:
        cmd += ["--arch", "schnet", "--shape", "molecule"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(HERE / "src"), os.environ.get("PYTHONPATH", "")]),
               CUDA_VISIBLE_DEVICES="")
    logf = open(os.path.join(out, "sweep.log"), "w")
    proc = subprocess.Popen(cmd, cwd=str(HERE), env=env, stdout=logf, stderr=subprocess.STDOUT,
                            start_new_session=True, preexec_fn=lambda: os.nice(19))
    atexit.register(_stop_group, proc)    # the sweep and its workers end with the run, however it ends
    return dict(proc=proc, out=out, log=logf, t0=time.perf_counter(), cpu0=os.times())


def _stop_group(proc):
    import os
    import signal

    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()


def attn_tile_flops(cfg, batch, seq, chunk_q, chunk_kv, remat=True):
    """Operations of one LM train step's attention as the port's tiles run
    it (``models/layers.py`` ``_flash_forward`` and ``_FlashAttention``),
    every layer, padded heads included: the forward's two products a tile
    over every tile, the causal ones above the diagonal too (twice with
    remat: the forward and the recompute); the backward's five a tile (the
    scores again, dV, dP, dQ, dK) over the tiles on or below the
    diagonal; and rowsum(dO * O) a query row."""
    h = cfg.padded_heads
    dk = dv = cfg.resolved_head_dim
    if cfg.attention == "mla":
        dk, dv = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim
    nq, nk = seq // chunk_q, seq // chunk_kv
    per = 2 * batch * h * chunk_q * chunk_kv
    below = sum(1 for qi in range(nq) for ki in range(nk) if ki * chunk_kv <= qi * chunk_q + chunk_q - 1)
    fwd = nq * nk * per * (dk + dv)
    bwd = below * per * (3 * dk + 2 * dv) + 2 * batch * h * seq * dv
    return cfg.n_layers * ((2 if remat else 1) * fwd + bwd)


def dryrun_card_check(device="cuda"):
    """The body of the dry run's card check, in a process of its own (the
    fake process group of ``launch.dryrun`` must not meet the mesh phases'
    ranks): each ``DRYRUN`` cell traced on rank 0 of a fake world of one
    rank over a (1, 1) mesh (``run_cell``), then built for real on the card
    over a one-rank NCCL group and run once, its peak memory above the
    baseline taken before the build (``torch.cuda.max_memory_allocated``).
    Prints one ``DRYRUN_CARD`` JSON line; returns 0."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.distributed.mesh_utils import make_mesh
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.steps import build_cell

    out = []
    for arch, shape, batch in DRYRUN["cells"]:
        t0 = time.perf_counter()
        rec = run_cell(arch, shape, False, None, device=device, mesh_shape=(1, 1), batch=batch)
        if not rec["ok"]:
            raise AssertionError(f"dry run of {arch} {shape}: {rec['traceback']}")
        out.append(dict(arch=arch, shape=shape, batch=batch, trace_s=time.perf_counter() - t0,
                        memory=rec["memory"], flops_by_dtype=rec["flops_by_dtype"],
                        model_flops=rec["roofline"]["model_flops"], roofline=rec["roofline"]))
    if device == "cuda":
        store = os.path.join(tempfile.mkdtemp(prefix="dryrun_card_"), "store")
        dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0, world_size=1)
        try:
            mesh = make_mesh((1, 1), ("data", "model"), "cuda")
            for r in out:
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated()
                cell = build_cell(r["arch"], r["shape"], mesh, device="cuda", abstract=False, batch=r["batch"])
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                res = cell.fn(*cell.inputs())
                torch.cuda.synchronize()
                r["measured_bytes"] = torch.cuda.max_memory_allocated() - base
                r["result"] = _dryrun_result(torch, r["shape"], res)
                del cell, res
        finally:
            dist.destroy_process_group()
    print("DRYRUN_CARD " + json.dumps(out), flush=True)
    return 0


def _dryrun_result(torch, shape, res):
    """What a card-check cell returned, checked finite: the train step's
    loss, decode's logits, retrieval's top scores and ids."""
    from torch.distributed.tensor import DTensor

    def whole(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    if shape == "train_4k":
        loss = whole(res[2]["loss"]).float()
        assert bool(torch.isfinite(loss)), loss
        return f"loss {float(loss):.4f}"
    if shape == "decode_32k":
        logits = whole(res[0])
        assert bool(torch.isfinite(logits[:, :-1]).all()) and logits.dim() == 2, logits.shape
        return f"logits {tuple(logits.shape)} finite"
    vals, ids = whole(res[0]), whole(res[1])
    assert vals.shape == ids.shape == (1, 100) and bool(torch.isfinite(vals).all()), (vals.shape, ids.shape)
    assert bool((vals[:, :-1] >= vals[:, 1:]).all())
    return f"top-100 scores and ids {tuple(ids.shape)}, finite and ordered"


def dryrun_phase(torch, card, on_card):
    """Run after every timed phase.  (b) the card check
    (``dryrun_card_check`` in a process of its own):
    predicted peak memory within ``mem_rel`` of the measured (at least
    ``mem_abs``); smollm-360m's counted FLOPs equal to ``train_flops``
    with the port's tiles (``attn_tile_flops``) and remat's early stop,
    within ``flops_rel``; ``model_flops_for`` against ``train_flops`` and
    ``lm_flops`` where they count the same work.  (a) the sweep, started
    (``dryrun_sweep_start``) before the card check and run beside it:
    every cell of both meshes ``ok``, one line each, the phase within
    ``limit_s``.  A CPU
    rehearsal traces on the CPU and runs nothing."""
    import os

    from repro_torch import configs
    from repro_torch.launch.steps import shape_by_name

    t_phase = time.perf_counter()
    sweep = dryrun_sweep_start(on_card)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(HERE), str(HERE / "src"),
                                                       os.environ.get("PYTHONPATH", "")]))
    dev = "cuda" if on_card else "cpu"
    run = subprocess.run([sys.executable, "-c", f"import sys, chip_smoke; sys.exit(chip_smoke.dryrun_card_check({dev!r}))"],
                         cwd=str(HERE), env=env, capture_output=True, text=True, timeout=600)
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("DRYRUN_CARD ")]
    if run.returncode != 0 or not lines:
        raise AssertionError(f"dryrun card check failed ({run.returncode}):\n{run.stdout[-3000:]}\n{run.stderr[-6000:]}")
    card_s = time.perf_counter() - t_phase
    for r in json.loads(lines[-1][len("DRYRUN_CARD "):]):
        cfg = configs.get_config(r["arch"], r["shape"])
        mem = r["memory"]
        pred = mem["per_device_total"]
        line = (f"phase dryrun card: {r['arch']} {r['shape']} at batch {r['batch'] or 'as published'} over (1, 1): "
                f"predicted {pred / 1e9:.3f} GB a device (arguments {mem['argument_bytes'] / 1e9:.3f}, temporaries "
                f"{mem['temp_bytes'] / 1e9:.3f}, new results {(mem['output_bytes'] - mem['alias_bytes']) / 1e9:.3f}); "
                f"counted {sum(r['flops_by_dtype'].values()):.6e} FLOP ({r['flops_by_dtype']}), model_flops_for "
                f"{r['model_flops']:.6e}; traced in {r['trace_s']:.1f} s")
        if on_card:
            meas = r["measured_bytes"]
            err = abs(pred - meas)
            line += (f"; on the card: {r['result']}, max_memory_allocated above the "
                     f"baseline {meas / 1e9:.3f} GB ({(pred - meas) / max(meas, 1) * 100:+.2f}% predicted)")
            assert err <= max(DRYRUN["mem_rel"] * meas, DRYRUN["mem_abs"]), (r["arch"], pred, meas)
        counted = sum(r["flops_by_dtype"].values())
        sh = shape_by_name("lm", r["shape"]) if cfg.family == "lm" else None
        if r["shape"] == "train_4k":
            b, seq = r["batch"], sh.seq_len
            gemm, attn = train_flops(cfg, b, seq)
            # remat's recompute stops at the last tensor the backward needs: the FFN's down projection
            skipped = cfg.n_layers * b * seq * 2 * cfg.d_ff * cfg.d_model
            tiles = attn_tile_flops(cfg, b, seq, cfg.attn_chunk_q, cfg.attn_chunk_kv, cfg.remat)
            want = gemm - skipped + tiles
            rel = abs(counted - want) / want
            mf_rel = abs(r["model_flops"] - 0.75 * gemm) / r["model_flops"]
            line += (f"; train_flops {gemm:.6e} GEMM + {attn:.6e} causal attention; expected with the port's tiles "
                     f"({tiles:.6e}: every tile forward, twice with remat; on or below the diagonal backward) and "
                     f"remat's early stop (-{skipped:.6e}): {want:.6e}, counted {rel:.2e} off (limit "
                     f"{DRYRUN['flops_rel']}); model_flops_for against 3/4 of train_flops' GEMMs (forward and "
                     f"backward, no remat) {mf_rel:.2e} off")
            assert rel <= DRYRUN["flops_rel"] and mf_rel <= 1e-9, (rel, mf_rel)
        elif r["shape"] == "decode_32k":
            b = r["batch"]
            gemm, _ = lm_flops(cfg, b, 1, b)
            cache = 2.0 * cfg.n_layers * b * sh.seq_len * cfg.padded_heads * cfg.resolved_head_dim * 2
            lookup = 0.0 if cfg.tie_embeddings else 2.0 * b * cfg.vocab_size * cfg.d_model
            rel = abs(counted - (gemm + cache)) / counted
            mf_rel = abs(r["model_flops"] - (gemm + lookup + cache)) / r["model_flops"]
            line += (f"; lm_flops' GEMMs at one token a row {gemm:.6e} + attention over the cache {cache:.6e}: "
                     f"counted {rel:.2e} off; model_flops_for (2 N B + the cache) against them and the "
                     f"embedding rows ({lookup:.3e}) {mf_rel:.2e} off")
            assert rel <= DRYRUN["flops_rel"] and mf_rel <= 1e-9, (rel, mf_rel)
        log(line + f"; {card}")

    # (a) the sweep
    proc = sweep["proc"]
    t_wait = time.perf_counter()
    try:
        proc.wait(timeout=max(10.0, DRYRUN["limit_s"] - (time.perf_counter() - t_phase)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        _stop_group(proc)
        sweep["log"].close()
    waited = time.perf_counter() - t_wait
    cpu = os.times()
    recs = []
    for name in sorted(os.listdir(sweep["out"])):
        if name.endswith(".json"):
            with open(os.path.join(sweep["out"], name)) as f:
                recs.append(json.load(f))
    from repro_torch.launch.dryrun import summary

    with open(os.path.join(sweep["out"], "sweep.log")) as f:
        tail = f.read()[-3000:]
    done = re.search(r"swept \d+ cells, \d+ failed, in ([\d.]+) s", tail)
    for rec in recs:
        log("  " + summary(rec))
    bad = [f"{r['arch']} {r['shape']} {r['mesh']}" for r in recs if not r["ok"]]
    want_n = 80 if on_card else 2
    phase_s = time.perf_counter() - t_phase
    log(f"phase dryrun: {len(recs) - len(bad)} of {want_n} cells ok on the (16, 16) and (2, 16, 16) meshes (rank 0 of "
        f"a fake world of 256 and 512 ranks, fake CPU tensors, {DRYRUN['workers']} processes at nice 19); the sweep "
        f"{done.group(1) + ' s' if done else 'unfinished'} of wall time, started with the phase, after every timed "
        f"phase ({cpu.children_user - sweep['cpu0'].children_user:.0f} s of CPU in finished children); the phase "
        f"{phase_s:.1f} s (the card check {card_s:.1f} s beside the sweep, then {waited:.1f} s waiting for it); "
        f"computed from data-sheet constants, not measured")
    assert proc.returncode == 0 and not bad and len(recs) == want_n, (proc.returncode, bad, len(recs), tail)
    assert phase_s <= DRYRUN["limit_s"], phase_s


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=MSMARCO["n"], help="corpus rows")
    ap.add_argument("--device", default="cuda", help="'cpu' rehearses the control flow and fails at the end")
    ap.add_argument("--graph-build-n", type=int, default=0,
                    help="also time one NN-descent build over this many rows of the main corpus")
    args = ap.parse_args()

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.core.backends import clear_ann_index_cache, resolve_backend
    from repro_torch.core.pipeline import BruteForceGenerator, RetrievalPipeline
    from repro_torch.core.sparse import SparseVectors
    from repro_torch.core.spaces import DenseSpace, FusedSpace, FusedVectors
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import fused_topk as fk
    from repro_torch.kernels import mips_topk as mk
    from repro_torch.kernels import topk_large as lk
    from repro_torch.kernels.ops import fused_topk as ops_fused
    from repro_torch.kernels.query_index import build_index
    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    card = "not measured (cpu rehearsal)"
    if on_card:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
        log(f"phase card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
            f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        t0 = time.perf_counter()
        _build.build_all()
        log(f"phase build: {time.perf_counter() - t0:.1f} s for {', '.join(SOURCES)}")
        for lib, ptxas in sorted(_build.PTXAS_LOG.items()):
            regs = [int(w) for line in ptxas.splitlines() if "registers" in line
                    for w, nxt in zip(line.split(), line.split()[1:]) if nxt == "registers,"]
            spills = sum(int(line.split()[line.split().index("spill") - 2])
                         for line in ptxas.splitlines() if " bytes spill stores" in line)
            log(f"  ptxas {lib}: {len(regs)} kernels, at most {max(regs, default=0)} registers, "
                f"{spills} bytes of spill stores")

    check = Checker(torch)
    if on_card:   # build_index launches the index kernels: no plain fallback
        log(f"phase index: {index_phase(torch, dev)} query-term indexes built on the card equal "
            f"their plain version")
    small_phase(torch, dev, check)
    log(f"phase small: {check.cases} cases agree (tolerance {TOL_REL} of row scale)")
    cases = check.cases
    t0 = time.perf_counter()
    b1_cases, b1_sorts, b1_routes = b1_phase(torch, dev, check)
    log(f"phase b1 small: {b1_cases} cases of B1 agree bit for bit (exact integer scores: sorted, all equal, "
        f"NaN/+0/-0 at the k-th, n_valid < k with a row at -inf, bf16, l2, the graph entry set's shape, the "
        f"scan route for d=61 and an unaligned corpus); the sample-blind corpus sorted the filter's lists "
        f"{b1_sorts} times; launches: ring {b1_routes[0]}, scan {b1_routes[1]}; {time.perf_counter() - t0:.1f} s")
    cases = check.cases
    large_phase(torch, dev, check)
    log(f"phase large small: {check.cases - cases} cases of k > 2048 agree (tolerance {TOL_REL} of row scale; "
        f"exact scores: ids equal, ties, NaN, +0 and -0, refinement to 22 and 32 bits, all-equal rows)")
    cases = check.cases
    t0 = time.perf_counter()
    valid = beam_small_phase(torch, dev, check)
    log(f"phase beam small: {check.cases - cases} hops agree hop for hop ({valid} valid candidates; "
        f"mark-deltas equal, tolerance {TOL_REL} of row scale) in {time.perf_counter() - t0:.1f} s")
    cases = check.cases
    score_small_phase(torch, dev, check)
    log(f"phase score small: {check.cases - cases} score matrices agree (tolerance {TOL_REL} of row scale)")

    # ---- full scale: the main path -------------------------------------
    cfg = dict(MSMARCO, n=args.n)
    n, d, v, nnz, b = cfg["n"], cfg["d"], cfg["v"], cfg["nnz"], cfg["b"]
    torch.manual_seed(args.seed)
    t0 = time.perf_counter()
    dense, idx, val, _ = make_corpus(torch, n, d, v, nnz, 2048, args.seed, dev, torch.float32)
    corpus = FusedVectors(dense, SparseVectors(idx, val))
    batches = []
    for i in range(BATCHES):
        qd, qi, qv = make_queries(torch, b, d, v, cfg["nnz_q"], args.seed + 100 + i, dev)
        batches.append(FusedVectors(qd, SparseVectors(qi, qv)))
    g = torch.Generator().manual_seed(args.seed)
    w_dense, w_sparse = (0.2 + 0.8 * torch.rand(2, generator=g)).tolist()
    if on_card:
        torch.cuda.synchronize()
    log(f"phase data: n={n} d={d} v={v} nnz={nnz} resident "
        f"{sum(t.numel() * t.element_size() for t in (dense, idx, val)) / 1e9:.2f} GB, "
        f"made in {time.perf_counter() - t0:.1f} s; weights {w_dense:.4f}/{w_sparse:.4f}")

    space = FusedSpace(v, w_dense, w_sparse)
    pipe = RetrievalPipeline(BruteForceGenerator(space, corpus, backend="cuda"),
                             cand_qty=100, final_qty=10)
    dense_gen = BruteForceGenerator(DenseSpace("ip"), dense, backend="cuda")
    assert type(resolve_backend("cuda", space, corpus)).__name__ == "CudaBackend"

    mk.launches = mk.ring_launches = mk.scan_launches = 0
    fk.launches = 0
    lk.launches = 0
    fused_s, dense_s, results, dense_results = [], [], [], []
    for q in batches:
        t0 = time.perf_counter()
        results.append(pipe.run(q))
        if on_card:
            torch.cuda.synchronize()
        fused_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        dense_results.append(dense_gen.generate(q.dense, 100))
        if on_card:
            torch.cuda.synchronize()
        dense_s.append(time.perf_counter() - t0)
    # one deep request: k above the scan kernels' 2048 (a reranking pool)
    deep = dense_gen.generate(batches[0].dense, DEEP_K)
    launches = {"mips_topk": mk.launches, "fused_topk": fk.launches, "topk_large": lk.launches}
    log(f"phase main path: {BATCHES} batches of {b} and one dense request of k = {DEEP_K}; launches {launches} "
        f"(mips_topk: ring {mk.ring_launches}, scan {mk.scan_launches}); "
        f"fused pipeline median {1e3 * statistics.median(fused_s):.3f} ms/batch, "
        f"dense median {1e3 * statistics.median(dense_s):.3f} ms/batch (host clock, synchronised)")
    if on_card:
        assert all(c > 0 for c in launches.values()), f"a kernel was not launched: {launches}"
        assert mk.ring_launches > 0, "the main path did not take B1's ring route"

    # correctness at full scale, against the plain versions
    for r in results:
        assert r.scores.shape == (b, 10) and bool(torch.isfinite(r.scores).all())
    q = batches[0]
    table = ref.query_table(q.sparse, v)
    fused_args = (table, q.dense, idx, val, dense)
    fused_kw = dict(w_dense=w_dense, w_sparse=w_sparse)
    want = ref.fused_topk_table_ref(*fused_args, 100, tile_n=1 << 16, **fused_kw)
    check("fused_topk", "full fused k=100 (pipeline)", tuple(results[0]),
          (want[0][:, :10], want[1][:, :10]))
    check("fused_topk", "full fused k=100", tuple(ops_fused(q.sparse, q.dense, corpus.sparse, dense, v, 100,
                                                           **fused_kw)), want)
    want2000 = ref.fused_topk_table_ref(*fused_args, 2000, tile_n=1 << 16, **fused_kw)
    check("fused_topk", "full fused k=2000", fk.fused_topk(*fused_args, 2000, **fused_kw), want2000)
    want_dense = ref.mips_topk_ref(q.dense, dense, 100, tile_n=1 << 18)
    check("mips_topk", "full dense k=100 (generator)", tuple(dense_results[0]), want_dense)
    want_deep = ref.mips_topk_ref(q.dense, dense, DEEP_K, tile_n=1 << 18)
    check("topk_large", f"full dense k={DEEP_K} (generator)", tuple(deep), want_deep, exact_ids=False)
    want_deep = ref.fused_topk_table_ref(*fused_args, DEEP_K, tile_n=1 << 16, **fused_kw)
    check("topk_large", f"full fused k={DEEP_K}", lk.topk_large(*fused_args, DEEP_K, **fused_kw), want_deep,
          exact_ids=False)
    del want_deep
    rq, _, _ = make_queries(torch, b, d, v, 8, args.seed + 7, dev, planted=False)
    check("mips_topk", "full dense k=100 random queries", mk.mips_topk(rq, dense, 100),
          ref.mips_topk_ref(rq, dense, 100, tile_n=1 << 18), exact_ids=False)
    # B1 at the paper's candQty = 2000 (configs/paper_retrieval.py:24): against the plain version, and
    # bit for bit against topk_large (the same arithmetic); a zero query scores every row +0: the k
    # lowest rows
    b1_2000 = mk.mips_topk(q.dense, dense, 2000)
    check("mips_topk", "full dense k=2000", b1_2000, ref.mips_topk_ref(q.dense, dense, 2000, tile_n=1 << 18))
    deep_2000 = lk.topk_large(None, q.dense, None, None, dense, 2000)
    assert torch.equal(b1_2000[1], deep_2000[1]) and torch.equal(b1_2000[0].view(torch.int32),
                                                                 deep_2000[0].view(torch.int32)), \
        "B1 and topk_large disagree at k=2000"
    zq = torch.zeros(b, d, device=dev)
    check("mips_topk", "full dense k=2048 all scores equal", mk.mips_topk(zq, dense, 2048),
          ref.mips_topk_ref(zq, dense, 2048, tile_n=1 << 18), signed_zeros=True)
    del b1_2000, deep_2000
    log(f"phase full check: fused k=100, k=2000 and k={DEEP_K}, dense k=100 (planted and random), k=2000 "
        f"(equal to topk_large bit for bit), k=2048 with every score +0 and k={DEEP_K} agree")

    # ---- timings ------------------------------------------------------
    reps = 5 if on_card else 1
    timer = (lambda fn, r: cuda_ms(torch, fn, r)) if on_card else (lambda fn, r: float("nan"))
    mips_ms = timer(lambda: mk.mips_topk(q.dense, dense, 100), reps)
    mips_plain = timer(lambda: ref.mips_topk_ref(q.dense, dense, 100, tile_n=1 << 18), 1)

    def library_topk(k, qq=q.dense):
        parts_s, parts_i = [], []
        for r0 in range(0, n, 1 << 20):
            s, i = torch.topk(qq @ dense[r0:r0 + (1 << 20)].T, k)
            parts_s.append(s)
            parts_i.append(i + r0)
        s, p = torch.topk(torch.cat(parts_s, 1), k)
        return s, torch.gather(torch.cat(parts_i, 1), 1, p)

    mips_lib = timer(lambda: library_topk(100), reps)
    fused_ms = timer(lambda: fk.fused_topk(*fused_args, 100, **fused_kw), reps)
    fused_plain = timer(lambda: ref.fused_topk_table_ref(*fused_args, 100, tile_n=1 << 16, **fused_kw), 1)

    dense_bytes = n * d * 4 + b * d * 4 + b * 100 * 8
    dense_ops = 2 * b * n * d
    fused_bytes = n * d * 4 + n * nnz * 8 + b * d * 4 + b * (v + 1) * 4 + b * 100 * 8
    fused_ops = 2 * (b * n * d + sparse_fmas(torch, table, idx)) + 3 * b * n

    def bound(nbytes, ops):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    large_ms = timer(lambda: lk.topk_large(None, q.dense, None, None, dense, DEEP_K), reps)
    large_plain = timer(lambda: ref.mips_topk_ref(q.dense, dense, DEEP_K, tile_n=1 << 18), 1)
    large_lib = timer(lambda: library_topk(DEEP_K), reps)
    large_bytes = n * d * 4 + b * d * 4 + b * DEEP_K * 8
    # topk_large's two steps apart, and the fused space at the same k
    score_ms = timer(lambda: lk.large_scores(None, q.dense, None, None, dense), reps)
    deep_scores = lk.large_scores(None, q.dense, None, None, dense)
    select_ms = timer(lambda: lk.select_large(deep_scores, DEEP_K), reps)
    del deep_scores
    fused_large_ms = timer(lambda: lk.topk_large(*fused_args, DEEP_K, **fused_kw), reps)
    score_bound = (n * d * 4 + b * d * 4 + b * n * 4) / HBM_BYTES_PER_S * 1e3
    select_bound = (b * n * 4 + b * DEEP_K * 8) / HBM_BYTES_PER_S * 1e3
    log(f"phase large timings (B={b}, k={DEEP_K}, f32, CUDA events, median of {reps}): topk_large dense ip "
        f"{large_ms:.3f} ms = score pass {score_ms:.3f} ms (bound {score_bound:.3f} ms: the corpus read, the "
        f"scores written) + select pass {select_ms:.3f} ms (bound {select_bound:.3f} ms: the scores read once); "
        f"library {large_lib:.3f} ms; fused topk_large {fused_large_ms:.3f} ms (bound "
        f"{bound(fused_bytes - b * 100 * 8 + b * DEEP_K * 8, fused_ops)[0]:.3f} ms)")

    # B1 against topk_large dense and the library call as k grows, at B = 1, 16 and 64 (batch 0's first
    # query, batch 0, batches 0-3), B2 against topk_large fused at B = 16 (k = 100: the scan kernels and
    # the library call as timed above); B1's extra device memory at B = 16
    def extra_gb(fn):
        if not on_card:
            return float("nan")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 1e9

    cross, b1_gb = [], {}
    for bq, qq in ((1, q.dense[:1].contiguous()), (b, q.dense),
                   (4 * b, torch.cat([x.dense for x in batches[:4]]))):
        for k in CROSSOVER_K:
            seen = bq == b and k == 100
            row = [bq, k, mips_ms if seen else timer(lambda: mk.mips_topk(qq, dense, k), 3),
                   timer(lambda: lk.topk_large(None, qq, None, None, dense, k), 3),
                   mips_lib if seen else timer(lambda: library_topk(k, qq), 3), None, None,
                   timer(lambda: mk.mips_scan(qq, dense, k), 1 if bq > b else 3)]
            if bq == b:
                row[5] = fused_ms if seen else timer(lambda: fk.fused_topk(*fused_args, k, **fused_kw), 3)
                row[6] = timer(lambda: lk.topk_large(*fused_args, k, **fused_kw), 3)
                b1_gb[k] = extra_gb(lambda: mk.mips_topk(qq, dense, k))
            cross.append(tuple(row))
    # the scan route is the parent's B1 kernel (topk_scan.cu, unchanged): B1's time before the ring
    for bq in (1, b, 4 * b):
        log(f"phase crossover B={bq} (f32, CUDA events, median of 3; B=16 k=100 rows of median 5; the scan "
            f"route at B=64 one run): "
            + "; ".join(f"k={k}: B1 {b1:.3f} ms, topk_large dense {ld:.3f} ms, library {lib:.3f} ms, "
                        f"B1's scan route {sc:.3f} ms"
                        + ("" if b2 is None else f", B2 {b2:.3f} ms, topk_large fused {lf:.3f} ms")
                        for bb, k, b1, ld, lib, b2, lf, sc in cross if bb == bq)
            + f"; {card}")
    ahead = all(b1 < lib and b1 <= ld for bb, k, b1, ld, lib, _, _, _ in cross if bb == b)
    faster = all(b1 <= sc for _, _, b1, _, _, _, _, sc in cross)
    log(f"phase b1 memory (B={b}, max_memory_allocated over one call): "
        + ", ".join(f"k={k}: {gb:.4f} GB" for k, gb in b1_gb.items())
        + f"; B1 faster than the library call and no slower than topk_large dense at every k at B={b}: {ahead}; "
        f"no slower than its scan route at every k and B: {faster}")

    kernels = []
    for name, source, replaces, ms, plain, lib, (bms, by) in (
            ("mips_topk", SOURCES[4], "src/repro/kernels/mips_topk.py:92", mips_ms, mips_plain, mips_lib,
             bound(dense_bytes, dense_ops)),
            ("fused_topk", SOURCES[0], "src/repro/kernels/fused_topk.py:146", fused_ms, fused_plain, None,
             bound(fused_bytes, fused_ops)),
            ("topk_large", SOURCES[3], "src/repro/kernels/mips_topk.py:92", large_ms, large_plain, large_lib,
             bound(large_bytes, dense_ops))):
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": check.max_err[name],
                        "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                        "library_ms": lib})
    log(f"phase timings (B={b}, k=100 (topk_large: k={DEEP_K}), f32, CUDA events, median of {reps}): "
        + "; ".join(f"{k['name']} {k['ms']:.3f} ms vs bound {k['bound_ms']:.3f} ms ({k['bound_by']}), "
                    f"plain {k['plain_ms']:.3f} ms, library {k['library_ms']}" for k in kernels))
    # where the fused time goes: the sparse part alone (the index lookups
    # and the COO stream), the query-table and query-index glue of
    # ops.fused_topk, and the k=2000 launch
    sparse_ms = timer(lambda: fk.fused_topk(table, None, idx, val, None, 100), reps)
    glue_ms = timer(lambda: ref.query_table(q.sparse, v), reps)
    index_ms = timer(lambda: build_index(table, 16), reps)
    k2000_ms = timer(lambda: fk.fused_topk(*fused_args, 2000, **fused_kw), 1)
    log(f"phase breakdown: sparse-only fused_topk {sparse_ms:.3f} ms "
        f"(bound {n * nnz * 8 / HBM_BYTES_PER_S * 1e3:.3f} ms by its {n * nnz * 8 / 1e9:.2f} GB COO stream; "
        f"{(fused_ops - 2 * b * n * d - 3 * b * n) / 2 / (n * nnz):.4f} of {b} queries hit a slot); "
        f"query table {glue_ms:.3f} ms; query index {index_ms:.3f} ms; "
        f"fused_topk k=2000 {k2000_ms:.3f} ms")

    skew_phase(torch, dev, corpus, q, space, timer)

    # ---- graph ANN and NAPP over the same resident corpus, then at recall scale
    hop = graph_full_phase(torch, dev, check, corpus, batches, space, on_card)
    if args.graph_build_n:
        graph_build(torch, dev, corpus, space, min(args.graph_build_n, n), on_card)
    napp_index, score_launches = napp_full_phase(torch, dev, check, corpus, batches, space, on_card)
    score = score_full_phase(torch, check, corpus, q, space, napp_index, timer, reps, bound)
    # ---- learned weights and live corpora over the same resident corpus;
    # the NAPP membership and the graphs go first: a compaction copies it
    del napp_index
    clear_ann_index_cache()
    if on_card:
        torch.cuda.empty_cache()
    learned, learned_ms = fusion_full_phase(torch, dev, check, corpus, card, on_card, args.seed + 21)
    live_full_phase(torch, dev, check, corpus, batches, learned,
                    {"fused": learned_ms, "dense": 1e3 * statistics.median(dense_s)}, timer, card, on_card,
                    args.seed + 22)
    serve_launches = serve_full_phase(torch, dev, check, corpus, space, card, on_card, args.seed + 23)
    flex_launches = flexneuart_full_phase(torch, dev, check, corpus, card, on_card, args.seed + 24, timer)
    # the funnel's neural stage: smollm-360m as published on the card; a rehearsal on the CPU cuts it to one
    # layer of a narrow FFN (the dense width stays 960 >= the encoded 768)
    cross_cfg = None
    if not on_card:
        from repro_torch.configs import get_config
        cross_cfg = dataclasses.replace(get_config(CROSS["arch"]), n_layers=1, d_ff=64)
    cross_launches = cross_full_phase(torch, dev, check, corpus, space, card, on_card, args.seed + 25, timer,
                                      cross_cfg, CROSS_QUERIES if on_card else 2 * MSMARCO["b"])
    # ---- the distributed layer over the resident corpus: ranks sharing the card
    dist_launches = dist_full_phase(torch, dev, check, corpus, batches, space, card, on_card, args.seed + 30)
    # release the 36 GB corpus: the pipelines, the checks and the ANN
    # index cache all hold it, and so do the closed services of the served
    # phases until the cyclic collector runs (a service and its endpoints
    # refer to each other)
    del dense, idx, val, corpus, batches, q, pipe, dense_gen, results, dense_results, fused_args
    gc.collect()
    clear_ann_index_cache()
    if on_card:   # "dist full"'s ranks held the corpus through IPC: its blocks go once they are collected
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated() / 1e9
        log(f"phase release: {left:.2f} GB still allocated after the corpus's release")
        assert left < 30.0, f"the corpus (36 GB) was not released: {left:.2f} GB allocated"
    # ---- the recommendation and molecule families at published widths; a CPU rehearsal cuts them to the
    # smoke configs, 5,000 items and 4,096 molecules
    rec_cfg = rec_others = mol_cfg = mol_n = None
    if not on_card:
        from repro_torch.configs import get_smoke_config
        rec_cfg = dataclasses.replace(get_smoke_config(RECSYS["arch"]), item_vocab=5000)
        rec_others = [get_smoke_config(a) for a in RECSYS_OTHERS]
        mol_cfg, mol_n = get_smoke_config("schnet"), 4096
    recsys_launches = recsys_full_phase(torch, dev, check, card, on_card, args.seed + 26, timer, rec_cfg,
                                        rec_others)
    molecule_launches, _ = molecule_full_phase(torch, dev, check, card, on_card, args.seed + 27, timer, mol_cfg,
                                               mol_n)
    # ---- LM inference at published widths; a CPU rehearsal cuts it to the smoke configs and small shapes
    lm_cfgs = lm_shapes = None
    if not on_card:
        from repro_torch.configs import get_smoke_config
        lm_cfgs = [dataclasses.replace(get_smoke_config(a), dtype="bfloat16") for a in LM_ARCHS]
        lm_shapes = dict(prefill=(2, 64), decode_b=4, decode_len=128, prompt=8, gen=8, long_len=256, long_b=2,
                         long_b_moe=2)
    lm_full_phase(torch, dev, card, on_card, args.seed + 28, lm_cfgs, lm_shapes)
    # ---- training at published widths; a CPU rehearsal cuts it to the smoke configs and small shapes
    train_cfgs = train_shapes = None
    if not on_card:
        from repro_torch.configs import get_smoke_config
        train_cfgs = [get_smoke_config(a) for a in LM_ARCHS] + [
            dataclasses.replace(get_smoke_config("smollm-360m"), dtype="bfloat16", remat=True)]
        train_shapes = dict(check_s=32, b=2, s=64, din_b=256, mol_graphs=16,
                            din_cfg=dataclasses.replace(get_smoke_config("din"), item_vocab=5000),
                            mol_cfg=get_smoke_config("schnet"))
    train_full_phase(torch, dev, card, on_card, args.seed + 29, train_cfgs, train_shapes)
    # ---- expert parallelism: the published MoE layers on ranks sharing the card; a CPU rehearsal runs the
    # f32 smoke pass alone
    moe_ep_full_phase(torch, dev, card, on_card, args.seed + 31, smoke_only=not on_card)
    # ---- the models under a (2, 2) mesh of ranks sharing the card; a CPU rehearsal cuts them to the smoke configs
    mesh_cfgs = mesh_lm = mesh_din = mesh_mol = None
    if not on_card:
        from repro_torch.configs import get_smoke_config
        q = get_smoke_config("qwen2.5-3b")
        mesh_cfgs = (q, dataclasses.replace(q, remat=True, dtype="bfloat16"),
                     get_smoke_config("phi3.5-moe-42b-a6.6b"))
        mesh_lm = [get_smoke_config("qwen2.5-3b"), dataclasses.replace(
            get_smoke_config("minicpm3-4b"), n_heads=6, n_kv_heads=6, pad_heads_to=8, vocab_size=500, pad_vocab_to=512)]
        mesh_din = dataclasses.replace(get_smoke_config("din"), item_vocab=70000)
        mesh_mol = get_smoke_config("schnet")
        MESH.update(a_s=64, b_s=64, c_b=8, c_s=64, prefill=(2, 64), cache=128, din_b=16, din_cand=4096, mol=8)
    mesh_train_full_phase(torch, dev, card, on_card, args.seed + 32, mesh_cfgs)
    mesh_lm_models_full_phase(torch, dev, card, on_card, args.seed + 33, mesh_lm, mesh_din, mesh_mol)
    recall_n = min(RECALL_N, n) // CLUSTERS * CLUSTERS
    recall_data = graph_recall_phase(torch, dev, recall_n, args.seed + 11, on_card)
    napp_recall_phase(torch, dev, *recall_data, args.seed + 12, on_card)
    live_ann_phase(torch, dev, check, *recall_data[:3], card, on_card, args.seed + 13)
    tune_launches = autotune_phase(torch, dev, check, *recall_data[:2], card, on_card, args.seed + 14)
    # ---- the dry run: every cell traced on the production meshes, and three held against the card
    dryrun_phase(torch, card, on_card)
    kernels.append({"name": "beam_hop", "route": "cuda", "source": SOURCES[1],
                    "replaces": "src/repro/kernels/beam_topk.py:238", "launches": hop["launches"],
                    "max_abs_err": check.max_err["beam_hop"], "ms": hop["ms"],
                    "plain_ms": hop["plain_ms"], "bound_ms": hop["bound_ms"], "bound_by": hop["bound_by"],
                    "library_ms": None})
    kernels.append({"name": "fused_score", "route": "cuda", "source": SOURCES[2],
                    "replaces": "src/repro/kernels/sparse_dense.py:61", "launches": score_launches,
                    "max_abs_err": check.max_err["fused_score"], **score, "library_ms": None})
    for k in kernels:    # the main path's launches, the served passes', FlexNeuART's, the cross-encoder's,
        # the recommendation and molecule paths', the search's, the ranks' of "dist full"
        k["launches"] += (serve_launches.get(k["name"], 0) + flex_launches.get(k["name"], 0)
                          + cross_launches.get(k["name"], 0) + recsys_launches.get(k["name"], 0)
                          + molecule_launches.get(k["name"], 0) + tune_launches.get(k["name"], 0)
                          + dist_launches.get(k["name"], 0))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    if not on_card:
        print("chip_smoke: cpu rehearsal finished; kernels were not launched", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
