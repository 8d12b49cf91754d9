"""Term-level inverted file with exact scoring by postings (counterpart of
``repro/core/inverted_index.py``): NMSLIB's exact sparse MIPS, Lucene's
role in the paper.

Scoring is a scatter-add over postings, term at a time:

  for each query term t (weight qw):
      scores[postings_docs[t]] += qw * postings_wts[t]

which gives the exact scores of a document-at-a-time walk.  Postings are
stored padded per term [V, MAXP]; a term whose list exceeds MAXP keeps its
highest-|weight| entries (the build reports how many terms were cut).

The reference builds the index in a host double loop over every posting.
Here the postings are placed by term on the device of the input with a
counting placement over row blocks (a stable sort of each block's terms,
each entry's rank among its term's entries so far), which keeps the
reference's order: doc ids ascending within a list, a document's slots
in their order.  The lists of truncated terms only are ordered on the
host by the reference's own ``np.argsort`` over the same float64 array,
so that ties keep the reference's order.  On the card the scatter-add
runs on atomics, so the last bits of a score can differ from run to run.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.sparse import SparseVectors

__all__ = ["InvertedIndex", "build_inverted_index", "daat_score", "daat_topk"]

# Documents a block of the placement handles at once.
BLOCK_ROWS = 1 << 18


class InvertedIndex(NamedTuple):
    """Padded per-term postings.

    postings_docs : i32[V, MAXP]  doc ids, padded with n_docs (trash row)
    postings_wts  : f32[V, MAXP]  stored term weights (e.g. BM25 components)
    n_docs        : int
    truncated_terms : int         build-time diagnostic
    """

    postings_docs: torch.Tensor
    postings_wts: torch.Tensor
    n_docs: int
    truncated_terms: int


def _terms(idx: torch.Tensor, val: torch.Tensor, vocab_size: int):
    """(term of every slot, mask of the slots that are postings).  A
    posting is a slot with an id below V and a nonzero weight; a negative
    id is read as the reference's host lists read it (V + id), and one
    below -V is dropped."""
    t = idx.long()
    t = torch.where(t < 0, t + vocab_size, t)
    return t, (t >= 0) & (t < vocab_size) & (val != 0.0)


def _block_postings(idx: torch.Tensor, val: torch.Tensor, r0: int, vocab_size: int):
    """The postings of documents [r0, r0 + rows): (terms, docs, weights),
    stably sorted by term, so that each term's entries keep (doc, slot)
    order."""
    t, live = _terms(idx, val, vocab_size)
    docs = torch.arange(r0, r0 + idx.shape[0], dtype=torch.int32,
                        device=idx.device)[:, None].expand_as(idx)
    t, d, w = t[live], docs[live], val[live].float()
    order = torch.sort(t, stable=True).indices
    return t[order], d[order], w[order]


def build_inverted_index(doc_sparse: SparseVectors, vocab_size: int,
                         max_posting: int | None = None,
                         block_rows: int = BLOCK_ROWS) -> InvertedIndex:
    """Index padded-COO doc vectors, on their device, equal to the
    reference's host build: every term's documents ascending (slots of one
    document in slot order), padded with ``n_docs``; MAXP the longest list
    or ``max_posting``; a longer list cut to its ``max_posting`` entries
    of largest |weight| in ``np.argsort``'s order, counted in
    ``truncated_terms``."""
    idx, val = doc_sparse.indices, doc_sparse.values
    n_docs = idx.shape[0]
    dev = idx.device
    blocks = [(r0, idx[r0:r0 + block_rows], val[r0:r0 + block_rows])
              for r0 in range(0, n_docs, block_rows)]

    counts = torch.zeros(vocab_size, dtype=torch.int64, device=dev)
    for _, bi, bv in blocks:
        t, live = _terms(bi, bv, vocab_size)
        counts += torch.bincount(t[live], minlength=vocab_size)
    longest = int(counts.max()) if vocab_size else 0
    maxp = max(longest if max_posting is None else max_posting, 1)
    truncated = counts > maxp

    docs_arr = torch.full((vocab_size, maxp), n_docs, dtype=torch.int32, device=dev)
    wts_arr = torch.zeros((vocab_size, maxp), dtype=torch.float32, device=dev)
    flat_docs, flat_wts = docs_arr.view(-1), wts_arr.view(-1)
    filled = torch.zeros(vocab_size, dtype=torch.int64, device=dev)
    cut = []                      # the truncated terms' postings, in order
    for r0, bi, bv in blocks:
        t, d, w = _block_postings(bi, bv, r0, vocab_size)
        here = torch.bincount(t, minlength=vocab_size)
        start = torch.cumsum(here, 0) - here
        slot = filled[t] + torch.arange(t.shape[0], device=dev) - start[t]
        filled += here
        keep = ~truncated[t]
        flat_docs[t[keep] * maxp + slot[keep]] = d[keep]
        flat_wts[t[keep] * maxp + slot[keep]] = w[keep]
        if bool(truncated.any()):
            gone = ~keep
            cut.append((t[gone].cpu().numpy(), d[gone].cpu().numpy(), w[gone].cpu().numpy()))

    n_truncated = int(truncated.sum())
    if n_truncated:
        t, d, w = (np.concatenate(parts) for parts in zip(*cut))
        order = np.argsort(t, kind="stable")
        t, d, w = t[order], d[order], w[order]
        bounds = np.searchsorted(t, np.arange(vocab_size + 1))
        for term in np.flatnonzero(truncated.cpu().numpy()):
            lo, hi = bounds[term], bounds[term + 1]
            # the reference's host array: the list's weights as float64
            top = np.argsort(-np.abs(w[lo:hi].astype(np.float64)))[:maxp]
            docs_arr[term] = torch.from_numpy(d[lo:hi][top]).to(dev)
            wts_arr[term] = torch.from_numpy(w[lo:hi][top]).to(dev)
    return InvertedIndex(docs_arr, wts_arr, n_docs, n_truncated)


def daat_score(index: InvertedIndex, queries: SparseVectors) -> torch.Tensor:
    """Exact sparse-MIPS scores [B, n_docs] via postings scatter-add: each
    query's term postings ([NNZ, MAXP]) scatter-added into an accumulator
    of n_docs+1 slots (a trash slot for padding).  The result is a view of
    that accumulator without its trash column."""
    vocab = index.postings_docs.shape[0]
    q_idx = queries.indices.long()
    safe = torch.clamp(q_idx, max=vocab - 1)                  # pad ids -> last row
    safe = torch.where(safe < 0, safe + vocab, safe).clamp(min=0)
    pd = index.postings_docs[safe]                            # [B, NNZ, MAXP]
    pw = index.postings_wts[safe]
    live = (q_idx < vocab)[..., None]
    contrib = torch.where(live, queries.values.float()[..., None] * pw, torch.zeros_like(pw))
    b = q_idx.shape[0]
    buf = torch.zeros((b, index.n_docs + 1), dtype=torch.float32, device=pw.device)
    buf.scatter_add_(1, pd.reshape(b, -1).long(), contrib.reshape(b, -1))
    return buf[:, : index.n_docs]


def daat_topk(index: InvertedIndex, queries: SparseVectors, k: int):
    """The top ``k`` of :func:`daat_score` in ``lax.top_k``'s order (ties to
    the lower doc id), selected by ``topk_large.select_large``: the radix
    select kernel on the card, its plain version on the CPU."""
    from repro_torch.core.brute_force import TopK
    from repro_torch.kernels.topk_large import select_large

    vals, idx = select_large(daat_score(index, queries).contiguous(), k)
    return TopK(vals, idx.to(torch.int32))
