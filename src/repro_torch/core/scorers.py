"""FlexNeuART scoring modules, the feature extractors (counterpart of
``repro/core/scorers.py``; paper §3.3).

Each extractor produces one or more numerical features for (query,
candidate document) pairs; features feed the LETOR layer
(``core.fusion``).  The *composite* extractor mirrors the paper's Fig. 3
JSON configuration: a list of ``{"type": ..., "params": {...}}``
descriptors, each instantiated by type.

Signals: ``TFIDFSimilarity`` (BM25), ``proximity`` (BM25-weighted
ordered / unordered query-term bigrams), ``avgWordEmbed`` (IDF-weighted
averaged word embeddings, cosine or L2), ``model1`` (IBM Model 1
log-probability, ``core.model1``), ``rm3`` (pseudo-relevance feedback in
re-ranking mode) and ``proxy`` (scores of an external model).

The forward index keeps padded token sequences and collection statistics,
enough to compute every classic signal without the retrieval engine.
Every extractor runs on the device its tensors live on.  Two builders
are the port's own, for corpora too large for the reference's dense or
host-loop forms: :func:`forward_index_from_padded` (the forward index of
already padded token rows, built on their device) and the row-block
sparse computation inside :func:`bm25_doc_vectors`, which gives the
reference's ids in the reference's order without its dense [N, V]
matrix.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.brute_force import select_topk
from repro_torch.core.sparse import SparseVectors, from_dense
from repro_torch.device import resolve_device

__all__ = [
    "ForwardIndex",
    "build_forward_index",
    "forward_index_from_padded",
    "bm25_idf",
    "bm25_doc_vectors",
    "query_sparse_vectors",
    "BM25Extractor",
    "ProximityExtractor",
    "AvgWordEmbedExtractor",
    "Model1Extractor",
    "RM3Extractor",
    "ProxyExtractor",
    "CompositeExtractor",
    "make_extractor",
]

# Rows a block of the device builders handles at once (their working set
# is a few times the block's [rows, L] int64 sort).
BLOCK_ROWS = 1 << 20


class ForwardIndex(NamedTuple):
    """Per-field forward index: padded token sequences + collection stats.

    tokens : i32[N, L]  token ids, padding = vocab_size
    length : i32[N]     true token counts
    df     : f32[V]     document frequencies
    vocab_size : int
    avg_len : float
    """

    tokens: torch.Tensor
    length: torch.Tensor
    df: torch.Tensor
    vocab_size: int
    avg_len: float

    @property
    def n_docs(self) -> int:
        return self.tokens.shape[0]


def build_forward_index(token_rows: Sequence[np.ndarray], vocab_size: int,
                        max_len: int | None = None, device=None) -> ForwardIndex:
    """Host-side construction from ragged token id lists (ids in [0, V)),
    as the reference builds it, then moved to ``device`` (None = cuda)."""
    dev = resolve_device(device)
    n = len(token_rows)
    lens = np.asarray([len(r) for r in token_rows], dtype=np.int32)
    L = int(max_len or max(1, lens.max()))
    toks = np.full((n, L), vocab_size, dtype=np.int32)
    df = np.zeros((vocab_size,), dtype=np.float32)
    for i, row in enumerate(token_rows):
        row = np.asarray(row, dtype=np.int32)[:L]
        toks[i, : len(row)] = row
        df[np.unique(row)] += 1.0
    return ForwardIndex(
        torch.from_numpy(toks).to(dev), torch.from_numpy(np.minimum(lens, L)).to(dev),
        torch.from_numpy(df).to(dev), vocab_size, float(lens.mean() if n else 1.0))


def _sorted_first(block: torch.Tensor, vocab_size: int):
    """Each row of ``block`` sorted ascending, and the mask of the first
    occurrence of every real id (pads, ids >= V, sort last and are never
    first)."""
    s, _ = torch.sort(block, dim=-1)
    first = torch.ones_like(s, dtype=torch.bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    return s, first & (s < vocab_size)


def forward_index_from_padded(tokens: torch.Tensor, vocab_size: int,
                              block_rows: int = BLOCK_ROWS) -> ForwardIndex:
    """The forward index of packed token rows i32[N, L] on their device:
    each row's ids in [0, V) first, then padding ``vocab_size``.  Equal to
    :func:`build_forward_index` of the rows with their padding removed;
    the index shares the rows' storage.  Raises ``ValueError`` on rows
    that are not packed so."""
    real = (tokens >= 0) & (tokens < vocab_size)
    if not bool((real | (tokens == vocab_size)).all()) or bool((real[:, 1:] & ~real[:, :-1]).any()):
        raise ValueError(f"rows must hold ids in [0, {vocab_size}) first, then the pad {vocab_size}")
    length = real.sum(dim=1, dtype=torch.int32)
    df = torch.zeros(vocab_size, dtype=torch.int64, device=tokens.device)
    for r0 in range(0, tokens.shape[0], block_rows):
        s, first = _sorted_first(tokens[r0:r0 + block_rows], vocab_size)
        df += torch.bincount(s[first].long(), minlength=vocab_size)
    n = tokens.shape[0]
    avg_len = float(length.sum(dtype=torch.int64)) / n if n else 1.0
    return ForwardIndex(tokens, length, df.float(), vocab_size, avg_len)


def bm25_idf(fwd: ForwardIndex) -> torch.Tensor:
    """Robertson IDF, floored at 0 (the standard Lucene-style clamp)."""
    n = fwd.n_docs
    return torch.clamp(torch.log(1.0 + (n - fwd.df + 0.5) / (fwd.df + 0.5)), min=0.0)


def _scatter_ids(tokens: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Ids as the reference's scatter reads them: a negative id wraps once
    over the V+1 slots, an id still outside [0, V] goes to the trash slot
    V (the reference drops it)."""
    ids = tokens.long()
    ids = torch.where(ids < 0, ids + vocab_size + 1, ids)
    return torch.where((ids < 0) | (ids > vocab_size), torch.full_like(ids, vocab_size), ids)


def _term_counts(tokens: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Bag-of-words counts [..., V] from padded token rows [..., L].  A pad
    adds 0 to column V-1 instead of 1 to a trash column, so that the
    counts need no [.., V+1] buffer and no copy (the sums are exact)."""
    flat = _scatter_ids(tokens.reshape(-1, tokens.shape[-1]), vocab_size)
    real = (flat < vocab_size).float()
    out = torch.zeros((flat.shape[0], vocab_size), dtype=torch.float32, device=tokens.device)
    out.scatter_add_(1, torch.clamp(flat, max=vocab_size - 1), real)
    return out.reshape(*tokens.shape[:-1], vocab_size)


def _bm25_norm(length: torch.Tensor, avg_len: float, k1: float, b: float) -> torch.Tensor:
    return k1 * (1.0 - b + b * length / avg_len)


def bm25_doc_vectors(fwd: ForwardIndex, nnz: int, k1: float = 1.2, b: float = 0.75,
                     block_rows: int = BLOCK_ROWS) -> SparseVectors:
    """Export BM25 as document-side sparse vectors (FlexNeuART's NMSLIB
    export): weight(t, d) = idf(t) * tf*(k1+1) / (tf + k1*(1-b+b*len/avg));
    a query vector of per-term counts then makes <q, d> the exact BM25
    score.  Each row keeps its ``nnz`` largest weights, equal weights in
    ascending term order (``lax.top_k``'s), zero weights as padding: the
    reference's ``from_dense`` of the dense [N, V] matrix, computed here
    from each row's sorted ids in blocks of ``block_rows`` rows."""
    V = fwd.vocab_size
    idf = bm25_idf(fwd)
    norm = _bm25_norm(fwd.length[:, None], fwd.avg_len, k1, b)
    n, L = fwd.tokens.shape
    width = min(nnz, L)
    out_i = torch.full((n, nnz), V, dtype=torch.int32, device=fwd.tokens.device)
    out_v = torch.zeros((n, nnz), dtype=torch.float32, device=fwd.tokens.device)
    for r0 in range(0, n, block_rows):
        s, first = _sorted_first(fwd.tokens[r0:r0 + block_rows], V)
        s = s.contiguous()
        tf = (torch.searchsorted(s, s, right=True) - torch.searchsorted(s, s)).float()
        tf = torch.where(first, tf, torch.zeros_like(tf))
        w = idf[torch.clamp(s, max=V - 1).long()] * tf * (k1 + 1.0) / (tf + norm[r0:r0 + block_rows])
        w = torch.where(tf > 0, w, torch.zeros_like(w))
        mag, pos = select_topk(w.abs(), width)
        keep = mag > 0.0
        ids = torch.gather(s, 1, pos)
        vals = torch.gather(w, 1, pos)
        out_i[r0:r0 + block_rows, :width] = torch.where(keep, ids, torch.full_like(ids, V))
        out_v[r0:r0 + block_rows, :width] = torch.where(keep, vals, torch.zeros_like(vals))
    return SparseVectors(out_i, out_v)


def query_sparse_vectors(q_tokens: torch.Tensor, vocab_size: int, nnz: int) -> SparseVectors:
    """Query-side counts as a sparse vector (pairs with bm25_doc_vectors)."""
    return from_dense(_term_counts(q_tokens, vocab_size), nnz, pad_id=vocab_size)


# ---------------------------------------------------------------------------
# Extractors.  Interface: extract(q_tokens [B, LQ], cand_ids [B, C]) -> [B, C, F]
# ---------------------------------------------------------------------------

def _take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``ids`` as the reference's gathers read them:
    a negative id wraps once, then ids clamp to the table."""
    n = table.shape[0]
    ids = ids.long()
    ids = torch.clamp(torch.where(ids < 0, ids + n, ids), 0, n - 1)
    return table[ids]


def _gather_docs(fwd: ForwardIndex, cand_ids: torch.Tensor):
    return _take(fwd.tokens, cand_ids), _take(fwd.length, cand_ids)   # [B,C,L], [B,C]


def _query_idf(idf: torch.Tensor, q_tokens: torch.Tensor, V: int) -> torch.Tensor:
    """Each query token's IDF, 0 at padding."""
    q_idf = _take(idf, torch.clamp(q_tokens, max=V - 1))
    return torch.where(q_tokens < V, q_idf, torch.zeros_like(q_idf))


@dataclasses.dataclass(frozen=True)
class BM25Extractor:
    fwd: ForwardIndex
    k1: float = 1.2
    b: float = 0.75

    @property
    def n_features(self) -> int:
        return 1

    def extract(self, q_tokens: torch.Tensor, cand_ids: torch.Tensor) -> torch.Tensor:
        doc_toks, doc_len = _gather_docs(self.fwd, cand_ids)
        idf = bm25_idf(self.fwd)
        V = self.fwd.vocab_size
        # tf of each query term in each candidate doc: [B, C, LQ]
        match = doc_toks[:, :, None, :] == q_tokens[:, None, :, None]
        tf = torch.sum(match, dim=-1).float()
        norm = _bm25_norm(doc_len[..., None], self.fwd.avg_len, self.k1, self.b)
        q_idf = _query_idf(idf, q_tokens, V)
        s = q_idf[:, None, :] * tf * (self.k1 + 1.0) / (tf + norm)
        return torch.sum(s, dim=-1, keepdim=True)


@dataclasses.dataclass(frozen=True)
class ProximityExtractor:
    """BM25-weighted ordered + unordered query-term bigram counts within a
    window (two features), after Boytsov & Belova 2011 / Metzler-Croft
    SDM's proximity cliques."""

    fwd: ForwardIndex
    window: int = 5
    k1: float = 1.2
    b: float = 0.75

    @property
    def n_features(self) -> int:
        return 2

    def extract(self, q_tokens: torch.Tensor, cand_ids: torch.Tensor) -> torch.Tensor:
        doc_toks, doc_len = _gather_docs(self.fwd, cand_ids)
        idf = bm25_idf(self.fwd)
        V = self.fwd.vocab_size

        # presence masks per query term: [B, C, LQ, L]
        pos = (doc_toks[:, :, None, :] == q_tokens[:, None, :, None]).float()
        t1 = pos[:, :, :-1, :]   # adjacent query-term pairs (LQ-1 of them)
        t2 = pos[:, :, 1:, :]
        ordered = torch.zeros(t1.shape[:-1], dtype=torch.float32, device=pos.device)
        unordered = torch.zeros_like(ordered)
        for delta in range(1, self.window + 1):
            fwd_pairs = torch.sum(t1[..., :-delta] * t2[..., delta:], dim=-1)   # t1 then t2
            bwd_pairs = torch.sum(t2[..., :-delta] * t1[..., delta:], dim=-1)   # t2 then t1
            ordered = ordered + fwd_pairs
            unordered = unordered + fwd_pairs + bwd_pairs

        q_idf = _query_idf(idf, q_tokens, V)
        pair_idf = torch.minimum(q_idf[:, :-1], q_idf[:, 1:])[:, None, :]   # [B,1,LQ-1]
        valid_pair = ((q_tokens[:, :-1] < V) & (q_tokens[:, 1:] < V))[:, None, :]
        norm = _bm25_norm(doc_len[..., None], self.fwd.avg_len, self.k1, self.b)

        def bm25_of(tf):
            s = pair_idf * tf * (self.k1 + 1.0) / (tf + norm)
            return torch.sum(torch.where(valid_pair, s, torch.zeros_like(s)), dim=-1)

        return torch.stack([bm25_of(ordered), bm25_of(unordered)], dim=-1)


@dataclasses.dataclass(frozen=True)
class AvgWordEmbedExtractor:
    """IDF-weighted averaged word embeddings compared by cosine or -L2
    (paper Fig. 3 ``avgWordEmbed``; separate query/doc embedding tables
    as in the StarSpace setup)."""

    fwd: ForwardIndex
    query_embed: torch.Tensor   # f32[V+1, E] (pad row must be zeros)
    doc_embed: torch.Tensor     # f32[V+1, E]
    use_idf: bool = True
    dist_type: str = "cosine"   # "cosine" | "l2"

    @property
    def n_features(self) -> int:
        return 1

    def _avg(self, tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        V = self.fwd.vocab_size
        if self.use_idf:
            w = _query_idf(bm25_idf(self.fwd), tokens, V)
        else:
            w = (tokens < V).float()
        emb = _take(table, torch.clamp(tokens, max=V)) * w[..., None]
        s = torch.sum(emb, dim=-2)
        return s / torch.clamp(torch.linalg.norm(s, dim=-1, keepdim=True), min=1e-12)

    def extract(self, q_tokens: torch.Tensor, cand_ids: torch.Tensor) -> torch.Tensor:
        doc_toks, _ = _gather_docs(self.fwd, cand_ids)
        qe = self._avg(q_tokens, self.query_embed)          # [B, E]
        de = self._avg(doc_toks, self.doc_embed)            # [B, C, E]
        if self.dist_type == "cosine":
            f = torch.einsum("be,bce->bc", qe, de)
        else:
            d = qe[:, None, :] - de
            f = -torch.sqrt(torch.clamp(torch.sum(d * d, dim=-1), min=0.0))
        return f[..., None]


@dataclasses.dataclass(frozen=True)
class Model1Extractor:
    """IBM Model 1 alignment log-probability (see ``core.model1``)."""

    fwd: ForwardIndex
    ttable: torch.Tensor        # f32[Vq, Vd] P(q_term | d_term)
    background: torch.Tensor    # f32[Vq] collection LM P_c(q_term)
    lam: float = 0.1            # smoothing weight on the background model

    @property
    def n_features(self) -> int:
        return 1

    def extract(self, q_tokens: torch.Tensor, cand_ids: torch.Tensor) -> torch.Tensor:
        from repro_torch.core.model1 import model1_logprob

        doc_toks, doc_len = _gather_docs(self.fwd, cand_ids)
        b, c, l = doc_toks.shape
        lp = model1_logprob(
            self.ttable, self.background,
            q_tokens[:, None, :].expand(b, c, q_tokens.shape[1]).reshape(b * c, -1),
            doc_toks.reshape(b * c, l), doc_len.reshape(b * c),
            self.fwd.vocab_size, self.lam)
        return lp.reshape(b, c, 1)


@dataclasses.dataclass(frozen=True)
class RM3Extractor:
    """RM3 pseudo-relevance feedback in re-ranking mode (Diaz 2015): a
    relevance LM from the top ``fb_docs`` candidates by BM25, then every
    candidate scored by the cross-entropy of the interpolated query model
    against its Dirichlet-smoothed document LM.  Both selections follow
    ``lax.top_k``'s order (``brute_force.select_topk``)."""

    fwd: ForwardIndex
    fb_docs: int = 10
    fb_terms: int = 32
    alpha: float = 0.5       # original-query interpolation
    mu: float = 1000.0       # Dirichlet smoothing

    @property
    def n_features(self) -> int:
        return 1

    def extract(self, q_tokens: torch.Tensor, cand_ids: torch.Tensor) -> torch.Tensor:
        V = self.fwd.vocab_size
        doc_toks, doc_len = _gather_docs(self.fwd, cand_ids)
        counts = _term_counts(doc_toks, V)                   # [B, C, V]
        coll = torch.clamp(self.fwd.df, min=1.0)
        coll = coll / torch.sum(coll)

        # first pass: BM25 ranks the candidates
        bm25 = BM25Extractor(self.fwd).extract(q_tokens, cand_ids)[..., 0]
        topv, topi = select_topk(bm25, min(self.fb_docs, bm25.shape[1]))
        pdq = torch.softmax(topv, dim=-1)                    # P(d | q)
        fb_counts = torch.gather(counts, 1, topi[..., None].expand(-1, -1, V))
        fb_len = torch.clamp(torch.gather(doc_len, 1, topi), min=1)
        p_t_d = fb_counts / fb_len[..., None]
        rel_model = torch.einsum("bf,bfv->bv", pdq, p_t_d)   # P(t | R)
        # keep fb_terms strongest expansion terms
        tv, ti = select_topk(rel_model, self.fb_terms)
        rel_model = torch.zeros_like(rel_model).scatter_(1, ti, tv)
        rel_model = rel_model / torch.clamp(rel_model.sum(-1, keepdim=True), min=1e-12)

        q_counts = _term_counts(q_tokens, V)
        q_model = q_counts / torch.clamp(q_counts.sum(-1, keepdim=True), min=1e-12)
        mixed = self.alpha * q_model + (1 - self.alpha) * rel_model   # [B, V]

        # (counts + mu * coll) / (len + mu), then its log, in place: the
        # [B, C, V] buffer is the largest this slice allocates
        smoothed = counts.add_(self.mu * coll[None, None, :])
        smoothed /= doc_len[..., None] + self.mu
        ce = torch.einsum("bv,bcv->bc", mixed, smoothed.log_())
        return ce[..., None]


@dataclasses.dataclass(frozen=True)
class ProxyExtractor:
    """Scores from an external model (the paper's Thrift proxy scorers).
    ``score_fn(q_tokens, cand_ids)`` is any callable returning [B, C]."""

    score_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

    @property
    def n_features(self) -> int:
        return 1

    def extract(self, q_tokens: torch.Tensor, cand_ids: torch.Tensor) -> torch.Tensor:
        return self.score_fn(q_tokens, cand_ids)[..., None]


_EXTRACTOR_TYPES = {
    "TFIDFSimilarity": BM25Extractor,
    "proximity": ProximityExtractor,
    "avgWordEmbed": AvgWordEmbedExtractor,
    "model1": Model1Extractor,
    "rm3": RM3Extractor,
    "proxy": ProxyExtractor,
}


def make_extractor(desc: dict, **context):
    """Instantiate one extractor from a Fig.3-style descriptor:
    ``{"type": "TFIDFSimilarity", "params": {"k1": 1.2, "b": 0.75}}``.
    ``context`` supplies non-JSON objects (forward indices, tables, models)
    keyed by param name; names the extractor does not take are ignored."""
    cls = _EXTRACTOR_TYPES[desc["type"]]
    params = dict(desc.get("params", {}))
    params.update({k: v for k, v in context.items()
                   if k in cls.__dataclass_fields__})  # type: ignore[attr-defined]
    return cls(**params)


@dataclasses.dataclass(frozen=True)
class CompositeExtractor:
    """The paper's composite feature extractor: reads a config (list of
    descriptors) and concatenates every sub-extractor's features."""

    extractors: tuple

    @classmethod
    def from_config(cls, config: Sequence[dict], **context) -> "CompositeExtractor":
        return cls(tuple(make_extractor(d, **context) for d in config))

    @property
    def n_features(self) -> int:
        return sum(e.n_features for e in self.extractors)

    def extract(self, q_tokens: torch.Tensor, cand_ids: torch.Tensor) -> torch.Tensor:
        return torch.cat([e.extract(q_tokens, cand_ids) for e in self.extractors], dim=-1)
