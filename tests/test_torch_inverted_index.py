"""repro_torch.core.inverted_index held against repro.core.inverted_index.

The port places postings with a vectorised counting placement over row
blocks where the reference loops on the host; its arrays must equal the
reference's exactly: doc ids ascending within a list (a document's slots
in slot order), padding with ``n_docs``, truncated lists in the order of
the reference's own ``np.argsort`` (ties included), ``truncated_terms``.
Scores (a scatter-add in another order) are held within ``F32_RTOL`` of
the row scale, ids equal on margin-planted queries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import inverted_index as ji
from repro.core import pipeline as jp
from repro.core import scorers as js
from repro.core.sparse import SparseVectors as JSparse
from repro.data.synthetic import make_corpus
from repro_torch import interop
from repro_torch.core import inverted_index as ti
from repro_torch.core import pipeline as tp
from repro_torch.core.brute_force import select_topk

from _torch_parity import assert_scores_close, assert_topk_match

pytestmark = pytest.mark.torch

V = 500


@pytest.fixture(scope="module")
def bm25():
    """BM25 vectors of the smoke config's synthetic corpus (numpy)."""
    corpus = make_corpus(n_docs=256, n_queries=32, vocab_lemmas=V, seed=1)
    fwd = js.build_forward_index(corpus.doc_lemmas, V)
    dv = js.bm25_doc_vectors(fwd, nnz=32)
    return np.array(dv.indices), np.array(dv.values), fwd


def _both(idx, val):
    return (JSparse(jnp.asarray(idx), jnp.asarray(val)),
            interop.sparse_vectors(idx, val, "cpu"))


def _assert_index_equal(want, got):
    np.testing.assert_array_equal(got.postings_docs.numpy(), np.asarray(want.postings_docs))
    np.testing.assert_array_equal(got.postings_wts.numpy(), np.asarray(want.postings_wts))
    assert got.n_docs == want.n_docs
    assert got.truncated_terms == want.truncated_terms


@pytest.mark.parametrize("block_rows", [1, 50, 1 << 18])
@pytest.mark.parametrize("max_posting", [None, 1, 4, 12, 1000])
def test_build_matches_repro(bm25, max_posting, block_rows):
    j_sp, t_sp = _both(*bm25[:2])
    want = ji.build_inverted_index(j_sp, V, max_posting)
    got = ti.build_inverted_index(t_sp, V, max_posting, block_rows=block_rows)
    _assert_index_equal(want, got)
    if max_posting in (4, 12):
        assert got.truncated_terms > 0


def _tied_rows(seed, n=120, nnz=6):
    """COO rows whose weights repeat a few values (many exact ties within
    a term's list, +-w of equal magnitude), with a term repeated inside a
    row, zero weights (skipped), pad ids, and ids -1 (the reference's
    host lists read it as term V - 1) and past V (skipped)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 12, (n, nnz)).astype(np.int32)
    val = rng.choice(np.array([0.5, -0.5, 1.0, 2.0, 0.0], np.float32), (n, nnz))
    idx[::7, 1] = idx[::7, 0]            # a term twice in one row
    idx[::11, 2] = 12                    # pad id (V = 12)
    idx[::13, 3] = -1                    # the reference's lists wrap it to term 11
    idx[::17, 4] = 40                    # past V: skipped
    return idx, val


@pytest.mark.parametrize("max_posting", [None, 3, 7, 20])
@pytest.mark.parametrize("seed", range(3))
def test_build_keeps_repro_order_on_ties_and_odd_ids(seed, max_posting):
    idx, val = _tied_rows(seed)
    j_sp, t_sp = _both(idx, val)
    want = ji.build_inverted_index(j_sp, 12, max_posting)
    got = ti.build_inverted_index(t_sp, 12, max_posting, block_rows=17)
    _assert_index_equal(want, got)


def test_build_of_an_empty_vocabulary_slice():
    """Terms without postings keep a full row of padding; MAXP is at least 1."""
    idx = np.full((5, 3), 9, np.int32)
    val = np.zeros((5, 3), np.float32)
    j_sp, t_sp = _both(idx, val)
    _assert_index_equal(ji.build_inverted_index(j_sp, 9), ti.build_inverted_index(t_sp, 9))


def _queries(fwd, b=8, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, V, (b, 6)).astype(np.int32)
    toks[:, -1] = V
    return js.query_sparse_vectors(jnp.asarray(toks), V, 8)


def test_daat_score_matches_repro(bm25):
    j_sp, t_sp = _both(*bm25[:2])
    index = ji.build_inverted_index(j_sp, V)
    q = _queries(bm25[2])
    t_q = interop.sparse_vectors(np.asarray(q.indices), np.asarray(q.values), "cpu")
    want = np.asarray(ji.daat_score(index, q))
    got = ti.daat_score(interop.inverted_index(np.asarray(index.postings_docs),
                                               np.asarray(index.postings_wts), index.n_docs,
                                               index.truncated_terms, "cpu"), t_q)
    assert got.shape == want.shape
    assert_scores_close(want, got.numpy())


def _planted(n=300, nq=6, seed=0):
    """Margin-planted postings: query j weighs term j; docs hold term j
    with distinct weights 1 + i / 64 (i = 0..n/nq-1), and random noise
    terms 100.. that no query weighs."""
    rng = np.random.default_rng(seed)
    idx = np.full((n, 4), V, np.int32)
    val = np.zeros((n, 4), np.float32)
    for dd in range(n):
        j = dd % nq
        idx[dd, 0], val[dd, 0] = j, 1.0 + (dd // nq) / 64.0
        idx[dd, 1:] = rng.integers(100, V, 3)
        val[dd, 1:] = rng.random(3).astype(np.float32)
    q_idx = np.full((nq, 3), V, np.int32)
    q_val = np.zeros((nq, 3), np.float32)
    q_idx[:, 0], q_val[:, 0] = np.arange(nq), 2.0
    return (idx, val), (q_idx, q_val)


@pytest.mark.parametrize("k", [1, 10, 50])
def test_daat_topk_matches_repro_on_planted_margins(k):
    (idx, val), (qi, qv) = _planted()
    j_sp, t_sp = _both(idx, val)
    jq, tq = _both(qi, qv)
    want = ji.daat_topk(ji.build_inverted_index(j_sp, V), jq, k)
    got = ti.daat_topk(ti.build_inverted_index(t_sp, V), tq, k)
    assert got.indices.dtype == torch.int32
    assert_topk_match((np.asarray(want.scores), np.asarray(want.indices)),
                      (got.scores.numpy(), got.indices.numpy()))


def test_daat_topk_orders_ties_to_the_lower_doc(bm25):
    """Exact ties (single-term matches of equal weight, zero scores) go to
    the lower doc id, ``lax.top_k``'s order, through the same selection
    the card runs (its plain version on the CPU)."""
    j_sp, t_sp = _both(*bm25[:2])
    q = _queries(bm25[2], seed=3)
    t_q = interop.sparse_vectors(np.asarray(q.indices), np.asarray(q.values), "cpu")
    index = ti.build_inverted_index(t_sp, V)
    got = ti.daat_topk(index, t_q, 200)
    scores = ti.daat_score(index, t_q)
    vals, pos = select_topk(scores, 200)
    assert torch.equal(got.indices, pos.to(torch.int32))
    assert torch.equal(got.scores, vals)
    s = got.scores
    assert bool(((s[:, 1:] == s[:, :-1]) & (got.indices[:, 1:] > got.indices[:, :-1])).any())


def test_inverted_index_generator_matches_repro():
    (idx, val), (qi, qv) = _planted(seed=4)
    j_sp, t_sp = _both(idx, val)
    jq, tq = _both(qi, qv)
    want = jp.InvertedIndexGenerator(ji.build_inverted_index(j_sp, V)).generate(jq, 20)
    got = tp.InvertedIndexGenerator(ti.build_inverted_index(t_sp, V)).generate(tq, 20)
    assert_topk_match((np.asarray(want.scores), np.asarray(want.indices)),
                      (got.scores.numpy(), got.indices.numpy()))
    pipe = tp.RetrievalPipeline(tp.InvertedIndexGenerator(ti.build_inverted_index(t_sp, V)),
                                cand_qty=20, final_qty=5)
    out = pipe.run(tq)
    assert torch.equal(out.indices, got.indices[:, :5])
    with pytest.raises(TypeError, match="execution backend"):
        pipe.with_backend("reference")
