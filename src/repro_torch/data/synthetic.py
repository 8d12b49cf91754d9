"""Synthetic retrieval corpora with controlled relevance structure (a
copy of ``repro/data/synthetic.py``: numpy only, equal arrays for a seed).

MS MARCO / Yahoo!Answers are not available offline, so the paper's Table
2/3 experiments are reproduced *directionally* on corpora whose generative
process builds in exactly the phenomena those tables measure:

  * **topic structure** — K latent topics, Zipfian per-topic unigram LMs
    over a shared vocabulary; a document mixes 1-2 topics.  Relevance is
    grounded in generation: a query is sampled *from a specific document*;
    that document is rel=2, same-primary-topic documents are rel=1 with
    probability ``soft_rel_p`` (graded judgments for NDCG).
  * **multi-field text** — the vocabulary is organised as
    ``lemma_id * n_variants + variant``: the "tokens" field carries raw
    variant ids, the "lemmas" field collapses variants (simulating
    lemmatization), and a "bert tokens" field splits rare tokens into two
    sub-word ids from a reduced vocabulary.  Fusing fields therefore adds
    real signal, as in the paper's Table 3.
  * **vocabulary gap** — with probability ``paraphrase_p`` a query token is
    mapped through a fixed synonym permutation, so exact term matching
    (BM25) misses it but a translation model (IBM Model 1) can bridge it —
    the paper's CQA finding.

Everything is numpy (host-side data preparation), deterministic per seed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticCorpus:
    # documents
    doc_tokens: List[np.ndarray]      # raw token ids (variant space)
    doc_lemmas: List[np.ndarray]      # lemma ids
    doc_bert: List[np.ndarray]        # sub-word ids
    doc_topic: np.ndarray             # primary topic per doc
    # queries
    q_tokens: List[np.ndarray]
    q_lemmas: List[np.ndarray]
    q_bert: List[np.ndarray]
    # relevance: qrels[i] = {doc_id: grade}
    qrels: List[dict]
    # vocab sizes
    vocab_tokens: int
    vocab_lemmas: int
    vocab_bert: int
    n_variants: int
    synonym_map: np.ndarray


def _zipf_probs(v: int, alpha: float, rng: np.random.Generator) -> np.ndarray:
    ranks = rng.permutation(v) + 1
    p = 1.0 / ranks.astype(np.float64) ** alpha
    return p / p.sum()


def make_corpus(
    n_docs: int = 2000,
    n_queries: int = 200,
    n_topics: int = 20,
    vocab_lemmas: int = 2000,
    n_variants: int = 3,
    doc_len: tuple = (20, 60),
    query_len: tuple = (3, 8),
    paraphrase_p: float = 0.3,
    soft_rel_p: float = 0.15,
    soft_rel_per_q: int = 5,
    zipf_alpha: float = 1.1,
    seed: int = 0,
) -> SyntheticCorpus:
    rng = np.random.default_rng(seed)
    vocab_tokens = vocab_lemmas * n_variants
    vocab_bert = max(64, vocab_lemmas // 2)

    # per-topic lemma distributions: a topic concentrates on a subset.
    topic_lm = np.zeros((n_topics, vocab_lemmas))
    base = _zipf_probs(vocab_lemmas, zipf_alpha, rng)
    for t in range(n_topics):
        boost = np.zeros(vocab_lemmas)
        core = rng.choice(vocab_lemmas, size=vocab_lemmas // n_topics, replace=False)
        boost[core] = 20.0
        p = base * (1.0 + boost)
        topic_lm[t] = p / p.sum()

    # synonym permutation in lemma space (derangement-ish)
    synonym_map = rng.permutation(vocab_lemmas)

    # rare-token split table for "BERT" sub-words
    bert_a = rng.integers(0, vocab_bert, size=vocab_tokens)
    bert_b = rng.integers(0, vocab_bert, size=vocab_tokens)
    common_cut = vocab_tokens // 4  # frequent tokens keep one piece

    def to_bert(tokens: np.ndarray) -> np.ndarray:
        out = []
        for t in tokens:
            out.append(bert_a[t])
            if t >= common_cut:
                out.append(bert_b[t])
        return np.asarray(out, dtype=np.int32)

    def lemma_to_token(lemma: np.ndarray) -> np.ndarray:
        variant = rng.integers(0, n_variants, size=lemma.shape)
        return (lemma * n_variants + variant).astype(np.int32)

    doc_tokens, doc_lemmas, doc_bert = [], [], []
    doc_topic = np.zeros(n_docs, dtype=np.int32)
    topic_docs = [[] for _ in range(n_topics)]
    for d in range(n_docs):
        t1 = rng.integers(0, n_topics)
        doc_topic[d] = t1
        topic_docs[t1].append(d)
        lm = topic_lm[t1]
        if rng.random() < 0.3:
            lm = 0.7 * lm + 0.3 * topic_lm[rng.integers(0, n_topics)]
            lm = lm / lm.sum()
        ln = rng.integers(doc_len[0], doc_len[1] + 1)
        lemmas = rng.choice(vocab_lemmas, size=ln, p=lm).astype(np.int32)
        tokens = lemma_to_token(lemmas)
        doc_lemmas.append(lemmas)
        doc_tokens.append(tokens)
        doc_bert.append(to_bert(tokens))

    q_tokens, q_lemmas, q_bert, qrels = [], [], [], []
    for q in range(n_queries):
        src = int(rng.integers(0, n_docs))
        ln = int(rng.integers(query_len[0], query_len[1] + 1))
        ln = min(ln, len(doc_lemmas[src]))
        pick = rng.choice(len(doc_lemmas[src]), size=ln, replace=False)
        lemmas = doc_lemmas[src][pick].copy()
        # vocabulary gap: paraphrase some lemmas through the synonym map
        para = rng.random(ln) < paraphrase_p
        lemmas[para] = synonym_map[lemmas[para]]
        tokens = lemma_to_token(lemmas)
        rel = {src: 2}
        peers = topic_docs[doc_topic[src]]
        if len(peers) > 1:
            extra = rng.choice(peers, size=min(soft_rel_per_q, len(peers)),
                               replace=False)
            for e in extra:
                if e != src and rng.random() < soft_rel_p * 4:
                    rel[int(e)] = 1
        q_lemmas.append(lemmas.astype(np.int32))
        q_tokens.append(tokens)
        q_bert.append(to_bert(tokens))
        qrels.append(rel)

    return SyntheticCorpus(
        doc_tokens, doc_lemmas, doc_bert, doc_topic,
        q_tokens, q_lemmas, q_bert, qrels,
        vocab_tokens, vocab_lemmas, vocab_bert, n_variants, synonym_map,
    )


def qrels_to_labels(corpus: SyntheticCorpus, cand_ids: np.ndarray) -> np.ndarray:
    """Graded labels [Q, C] for candidate id matrix."""
    q, c = cand_ids.shape
    out = np.zeros((q, c), dtype=np.float32)
    for i in range(q):
        rel = corpus.qrels[i]
        for j in range(c):
            out[i, j] = rel.get(int(cand_ids[i, j]), 0.0)
    return out


def make_bitext(corpus: SyntheticCorpus, field: str = "tokens",
                max_q: int = 16, max_d: int = 24, chunk: int = 24,
                seed: int = 0):
    """(query, relevant-doc-chunk) pairs for Model 1 training (paper §4:
    long documents are split into chunks to make EM alignment feasible)."""
    rng = np.random.default_rng(seed)
    qs = {"tokens": corpus.q_tokens, "lemmas": corpus.q_lemmas,
          "bert": corpus.q_bert}[field]
    ds = {"tokens": corpus.doc_tokens, "lemmas": corpus.doc_lemmas,
          "bert": corpus.doc_bert}[field]
    vocab = {"tokens": corpus.vocab_tokens, "lemmas": corpus.vocab_lemmas,
             "bert": corpus.vocab_bert}[field]
    pairs_q, pairs_d = [], []
    for qi, rel in enumerate(corpus.qrels):
        for d, grade in rel.items():
            if grade < 2:
                continue
            doc = ds[d]
            for start in range(0, len(doc), chunk):
                pairs_q.append(qs[qi][:max_q])
                pairs_d.append(doc[start:start + chunk][:max_d])
    nq = len(pairs_q)
    q_arr = np.full((nq, max_q), vocab, dtype=np.int32)
    d_arr = np.full((nq, max_d), vocab, dtype=np.int32)
    for i, (qq, dd) in enumerate(zip(pairs_q, pairs_d)):
        q_arr[i, : len(qq)] = qq
        d_arr[i, : len(dd)] = dd
    return q_arr, d_arr, vocab
