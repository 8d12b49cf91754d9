"""repro_torch.core.scorers held against repro.core.scorers: the forward
index (the reference's host build, and the port's build of padded rows),
BM25 IDF and document vectors, query count vectors, each of the six
extractors, the registry and the composite extractor.

Inputs are made once with numpy (``repro.data.synthetic.make_corpus`` at
the smoke config's sizes) and fed to both packages; extractors read the
reference's forward index, carried by ``interop.forward_index``.
Tolerances, of each row's largest |feature| (``assert_scores_close``):

* BM25, proximity, avgWordEmbed: ``F32_RTOL`` (2e-6), the f32 contract;
  their sums run in another order.
* Model 1 and RM3: ``LOG_RTOL`` = 1e-5.  Both end in a sum of logs (Model
  1 of LQ query terms, RM3 of 30-odd expansion terms against every
  vocabulary entry), and RM3 starts from a softmax; ``log`` and ``exp``
  are not correctly rounded in XLA's CPU code nor in PyTorch's (each
  within a few ULPs of the true value, not the same ULPs), and a log's
  absolute error is its argument's relative error, so these features
  carry a few ULPs of each of their terms rather than of their sum.  The
  measured worst case on these inputs is below 1e-6; 1e-5 leaves room
  for other seeds without admitting a different expansion term (which
  moves RM3 by more than 1e-3).

Ids (BM25 vectors, query vectors, term counts) must be equal, in order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import model1 as jm
from repro.core import scorers as js
from repro.core.sparse import from_dense as j_from_dense
from repro.data.synthetic import make_corpus
from repro_torch import interop
from repro_torch.core import scorers as ts
from repro_torch.core.sparse import from_dense

from _torch_parity import F32_RTOL, assert_scores_close

pytestmark = pytest.mark.torch

LOG_RTOL = 1e-5
V = 500


@pytest.fixture(scope="module")
def corpus():
    """The smoke config's sizes (``configs/paper_retrieval.smoke_config``)."""
    return make_corpus(n_docs=256, n_queries=32, vocab_lemmas=V, seed=0)


@pytest.fixture(scope="module")
def jfwd(corpus):
    return js.build_forward_index(corpus.doc_lemmas, V)


@pytest.fixture(scope="module")
def tfwd(jfwd):
    return _carry(jfwd)


def _carry(jf):
    return interop.forward_index(np.asarray(jf.tokens), np.asarray(jf.length),
                                 np.asarray(jf.df), jf.vocab_size, jf.avg_len, "cpu")


@pytest.fixture(scope="module")
def queries(corpus):
    lq = 8
    q = np.full((len(corpus.q_lemmas), lq), V, np.int32)
    for i, row in enumerate(corpus.q_lemmas):
        q[i, :len(row[:lq])] = row[:lq]
    return q


def _cands(seed, b, c, n=256, out_of_range=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, (b, c)).astype(np.int32)
    if out_of_range:          # the reference's gathers wrap -1 once and clamp past the end
        ids[0, 0], ids[-1, -1] = -1, n + 5
    return ids


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# The forward index.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_len", [None, 24])
def test_build_forward_index_matches_repro(corpus, max_len):
    want = js.build_forward_index(corpus.doc_lemmas, V, max_len)
    got = ts.build_forward_index(corpus.doc_lemmas, V, max_len, device="cpu")
    for name in ("tokens", "length", "df"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.avg_len == want.avg_len and got.vocab_size == want.vocab_size
    assert got.n_docs == want.n_docs


def test_forward_index_from_padded_equals_the_host_build(jfwd, tfwd):
    got = ts.forward_index_from_padded(tfwd.tokens.clone(), V, block_rows=37)
    for name in ("tokens", "length", "df"):
        assert torch.equal(getattr(got, name), getattr(tfwd, name)), name
    assert got.avg_len == jfwd.avg_len


def test_forward_index_from_padded_shares_packed_rows(tfwd):
    tokens = tfwd.tokens.clone()
    got = ts.forward_index_from_padded(tokens, V)
    assert got.tokens.data_ptr() == tokens.data_ptr()


@pytest.mark.parametrize("fault", ["pad between ids", "pad other than V", "negative id"])
def test_forward_index_from_padded_refuses_unpacked_rows(tfwd, fault):
    """Rows must hold their ids first and then the pad V; anything else
    is refused rather than repacked."""
    toks = tfwd.tokens.numpy().copy()
    row = int(np.argmax(tfwd.length.numpy() < toks.shape[1] - 1))
    n_real = int(tfwd.length[row])
    assert n_real >= 2 and n_real < toks.shape[1]
    if fault == "pad between ids":
        toks[row, 1:n_real + 1] = toks[row, 0:n_real].copy()
        toks[row, 0] = V
    elif fault == "pad other than V":
        toks[row, n_real] = V + 3
    else:
        toks[row, 0] = -1
    with pytest.raises(ValueError, match="pad"):
        ts.forward_index_from_padded(_t(toks), V)


# ---------------------------------------------------------------------------
# BM25: IDF, document vectors, query vectors.
# ---------------------------------------------------------------------------

def test_bm25_idf_matches_repro(jfwd, tfwd):
    assert_scores_close(np.asarray(js.bm25_idf(jfwd))[None], ts.bm25_idf(tfwd).numpy()[None])


@pytest.mark.parametrize("block_rows", [1, 37, 1 << 20])
@pytest.mark.parametrize("nnz", [8, 32, 64])
def test_bm25_doc_vectors_match_repro(jfwd, tfwd, nnz, block_rows):
    """Ids equal in the reference's order (equal weights, common here:
    equal term counts and document frequencies, keep the lower term id
    first); weights within the f32 contract."""
    want = js.bm25_doc_vectors(jfwd, nnz)
    got = ts.bm25_doc_vectors(tfwd, nnz, block_rows=block_rows)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    assert_scores_close(np.asarray(want.values), got.values.numpy())
    w = got.values.numpy()
    assert (w[:, :-1] == w[:, 1:])[w[:, 1:] > 0].any(), "no tied weights: the order of ties is untested"


@pytest.mark.parametrize("nnz", [8, 64])
def test_bm25_doc_vectors_equal_the_ports_dense_form_bit_for_bit(tfwd, nnz):
    """The row-sorted computation against the reference's construction
    (the dense [N, V] matrix and ``from_dense``) in the port itself."""
    idf = ts.bm25_idf(tfwd)
    tf = ts._term_counts(tfwd.tokens, V)
    norm = 1.2 * (1.0 - 0.75 + 0.75 * tfwd.length[:, None] / tfwd.avg_len)
    w = idf[None, :] * tf * (1.2 + 1.0) / (tf + norm)
    want = from_dense(torch.where(tf > 0, w, torch.zeros_like(w)), nnz, pad_id=V)
    got = ts.bm25_doc_vectors(tfwd, nnz, block_rows=50)
    assert torch.equal(got.indices, want.indices)
    assert torch.equal(got.values.view(torch.int32), want.values.view(torch.int32))


def test_term_counts_match_repro(tfwd):
    """Ids as the reference's scatter reads them: -1 wraps to the pad
    slot, -2 to V - 1, ids still out of [0, V] are dropped."""
    toks = tfwd.tokens.numpy()[:40].reshape(4, 10, -1).copy()
    toks[0, 0, :5] = [-1, -2, -7, V + 1, 3 * V]
    want = np.asarray(js._term_counts(jnp.asarray(toks), V))
    np.testing.assert_array_equal(ts._term_counts(_t(toks), V).numpy(), want)


@pytest.mark.parametrize("nnz", [4, 8, 16])
def test_query_sparse_vectors_match_repro(queries, nnz):
    q = queries.copy()
    q[0, :4] = q[0, 0]                     # a repeated query term counts twice
    want = js.query_sparse_vectors(jnp.asarray(q), V, nnz)
    got = ts.query_sparse_vectors(_t(q), V, nnz)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))


def test_export_matches_extractor(tfwd, queries):
    """<query counts, BM25 vector> == the BM25 extractor's score, in the
    port (the equivalence FlexNeuART's NMSLIB export rests on)."""
    from repro_torch.core.sparse import sparse_inner_qbatch_docs

    dv = ts.bm25_doc_vectors(tfwd, nnz=64)
    qv = ts.query_sparse_vectors(_t(queries), V, nnz=8)
    via_ip = sparse_inner_qbatch_docs(qv, dv, V).numpy()
    cand = torch.arange(tfwd.n_docs).expand(queries.shape[0], -1)
    via_extract = ts.BM25Extractor(tfwd).extract(_t(queries), cand).numpy()[..., 0]
    assert_scores_close(via_extract, via_ip, rtol=1e-5)


# ---------------------------------------------------------------------------
# The extractors.
# ---------------------------------------------------------------------------

def _embeds(seed, e=16):
    rng = np.random.default_rng(seed)
    tables = rng.standard_normal((2, V + 1, e)).astype(np.float32)
    tables[:, V] = 0.0
    return tables


def _ttable(seed):
    rng = np.random.default_rng(seed)
    t = rng.random((V, V)).astype(np.float32) + 0.01
    t /= t.sum(0, keepdims=True)
    bg = rng.random(V).astype(np.float32)
    return t, bg / bg.sum()


def _pair(kind, jfwd, tfwd, seed, **params):
    """(repro extractor, port extractor) of one kind on equal inputs."""
    if kind == "avgWordEmbed":
        qe, de = _embeds(seed)
        return (js.AvgWordEmbedExtractor(jfwd, jnp.asarray(qe), jnp.asarray(de), **params),
                ts.AvgWordEmbedExtractor(tfwd, _t(qe), _t(de), **params))
    if kind == "model1":
        t, bg = _ttable(seed)
        return (js.Model1Extractor(jfwd, jnp.asarray(t), jnp.asarray(bg), **params),
                ts.Model1Extractor(tfwd, _t(t), _t(bg), **params))
    j_cls, t_cls = {"bm25": (js.BM25Extractor, ts.BM25Extractor),
                    "proximity": (js.ProximityExtractor, ts.ProximityExtractor),
                    "rm3": (js.RM3Extractor, ts.RM3Extractor)}[kind]
    return j_cls(jfwd, **params), t_cls(tfwd, **params)


EXTRACTOR_CASES = [
    ("bm25", {}, F32_RTOL),
    ("bm25", {"k1": 0.9, "b": 0.4}, F32_RTOL),
    ("proximity", {}, F32_RTOL),
    ("proximity", {"window": 2}, F32_RTOL),
    ("avgWordEmbed", {}, F32_RTOL),
    ("avgWordEmbed", {"use_idf": False, "dist_type": "l2"}, F32_RTOL),
    ("model1", {}, LOG_RTOL),
    ("model1", {"lam": 0.5}, LOG_RTOL),
    ("rm3", {"fb_docs": 4, "fb_terms": 8}, LOG_RTOL),
    ("rm3", {}, LOG_RTOL),
]


@pytest.mark.parametrize("kind,params,rtol", EXTRACTOR_CASES)
@pytest.mark.parametrize("seed", range(2))
def test_extractor_features_match_repro(jfwd, tfwd, queries, kind, params, rtol, seed):
    je, te = _pair(kind, jfwd, tfwd, seed, **params)
    cand = _cands(seed, queries.shape[0], 12, out_of_range=seed == 1)
    want = np.asarray(je.extract(jnp.asarray(queries), jnp.asarray(cand)))
    got = te.extract(_t(queries), _t(cand)).numpy()
    assert got.shape == want.shape == (queries.shape[0], 12, te.n_features)
    assert te.n_features == je.n_features
    assert_scores_close(want.reshape(-1, want.shape[1] * want.shape[2]),
                        got.reshape(-1, got.shape[1] * got.shape[2]), rtol=rtol, ctx=kind)


def test_model1_extractor_on_a_trained_table(corpus, jfwd, tfwd, queries):
    """Model 1 features from a table trained by the reference's EM."""
    rng = np.random.default_rng(5)
    q = jnp.asarray(rng.integers(0, V, (64, 6)), jnp.int32)
    d = jnp.asarray(np.asarray(jfwd.tokens)[:64, :16])
    t, _ = jm.train_model1(q, d, V, V, iters=2)
    bg = np.full(V, 1.0 / V, np.float32)
    cand = _cands(9, queries.shape[0], 10)
    want = np.asarray(js.Model1Extractor(jfwd, t, jnp.asarray(bg)).extract(
        jnp.asarray(queries), jnp.asarray(cand)))
    got = ts.Model1Extractor(tfwd, _t(np.asarray(t)), _t(bg)).extract(_t(queries), _t(cand)).numpy()
    assert_scores_close(want[..., 0], got[..., 0], rtol=LOG_RTOL)


def test_proxy_extractor_wraps_its_score_fn(queries):
    fn = lambda q, c: (q[:, :1] + c).float()
    cand = _cands(1, queries.shape[0], 5)
    got = ts.ProxyExtractor(fn).extract(_t(queries), _t(cand))
    assert got.shape == (queries.shape[0], 5, 1)
    assert torch.equal(got[..., 0], fn(_t(queries), _t(cand)))


def test_rm3_expansion_keeps_repro_order_among_tied_terms(jfwd, tfwd, queries):
    """Single-occurrence terms of one feedback document tie exactly in
    the relevance model; the expansion keeps the lower term ids, as
    ``lax.top_k`` does, so a small ``fb_terms`` still agrees."""
    cand = _cands(3, queries.shape[0], 6)
    for fb_terms in (1, 2, 3):
        je = js.RM3Extractor(jfwd, fb_docs=1, fb_terms=fb_terms)
        te = ts.RM3Extractor(tfwd, fb_docs=1, fb_terms=fb_terms)
        want = np.asarray(je.extract(jnp.asarray(queries), jnp.asarray(cand)))[..., 0]
        got = te.extract(_t(queries), _t(cand)).numpy()[..., 0]
        assert_scores_close(want, got, rtol=LOG_RTOL, ctx=f"fb_terms={fb_terms}")


# ---------------------------------------------------------------------------
# The registry and the composite extractor.
# ---------------------------------------------------------------------------

FIG3 = [
    {"type": "TFIDFSimilarity", "params": {"k1": 1.2, "b": 0.75}},
    {"type": "proximity", "params": {"window": 5}},
    {"type": "avgWordEmbed", "params": {"use_idf": True, "dist_type": "l2"}},
    {"type": "model1", "params": {"lam": 0.1}},
    {"type": "rm3", "params": {"fb_docs": 4, "fb_terms": 8}},
]


def test_make_extractor_ignores_context_the_type_does_not_take(tfwd):
    e = ts.make_extractor({"type": "TFIDFSimilarity", "params": {"k1": 1.0}},
                          fwd=tfwd, ttable=None, query_embed=None, unrelated=3)
    assert isinstance(e, ts.BM25Extractor) and e.k1 == 1.0 and e.b == 0.75
    with pytest.raises(KeyError):
        ts.make_extractor({"type": "bm26"}, fwd=tfwd)


def test_composite_fig3_config_matches_repro(jfwd, tfwd, queries):
    qe, de = _embeds(4)
    t, bg = _ttable(4)
    jctx = dict(fwd=jfwd, query_embed=jnp.asarray(qe), doc_embed=jnp.asarray(de),
                ttable=jnp.asarray(t), background=jnp.asarray(bg))
    tctx = dict(fwd=tfwd, query_embed=_t(qe), doc_embed=_t(de), ttable=_t(t), background=_t(bg))
    jc = js.CompositeExtractor.from_config(FIG3, **jctx)
    tc = ts.CompositeExtractor.from_config(FIG3, **tctx)
    assert tc.n_features == jc.n_features == 6
    assert [type(e).__name__ for e in tc.extractors] == [type(e).__name__ for e in jc.extractors]
    cand = _cands(7, queries.shape[0], 10)
    want = np.asarray(jc.extract(jnp.asarray(queries), jnp.asarray(cand)))
    got = tc.extract(_t(queries), _t(cand)).numpy()
    assert got.shape == want.shape
    for f, rtol in enumerate((F32_RTOL, F32_RTOL, F32_RTOL, F32_RTOL, LOG_RTOL, LOG_RTOL)):
        assert_scores_close(want[..., f], got[..., f], rtol=rtol, ctx=f"feature {f}")


def test_from_dense_matches_repro_on_bm25_ties(jfwd):
    """The port's from_dense (the dense form above) keeps the reference's
    order on a matrix full of exact ties."""
    w = np.asarray(js._term_counts(jfwd.tokens, V))
    want = j_from_dense(jnp.asarray(w), 16, pad_id=V)
    got = from_dense(_t(w), 16, pad_id=V)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))


def test_build_forward_index_refuses_padded_rows_as_repro_does(corpus):
    """Copied on purpose: a row holding the pad id V indexes ``df`` at V,
    which both host builds refuse; padded rows go to
    ``forward_index_from_padded``."""
    rows = [np.asarray(r) for r in corpus.doc_lemmas[:4]]
    rows[2] = np.append(rows[2], V)
    with pytest.raises(IndexError):
        js.build_forward_index(rows, V)
    with pytest.raises(IndexError):
        ts.build_forward_index(rows, V, device="cpu")
    got = ts.forward_index_from_padded(_t(np.stack([np.pad(r, (0, 80 - len(r)), constant_values=V)
                                                    for r in rows])), V)
    want = ts.build_forward_index([r[r < V] for r in rows], V, 80, device="cpu")
    assert torch.equal(got.tokens, want.tokens) and torch.equal(got.df, want.df)
