"""The rest of repro_torch.core.pipeline held against repro.core.pipeline:
``_reorder``, ``LinearReranker``, ``TreeReranker`` and the experiment
descriptor (``canonicalize_descriptor``, ``descriptor``,
``from_descriptor``), with the funnel around them.

Reranked ids must be equal.  Features are margin-planted: a proxy
extractor reads the same table in both packages, with values on a grid
of 1/8 (so that every linear score is exact in f32 and ties are exact
ties), or, for the real composite, compared under the near-tie rule.  The
tree test states its precondition: no feature lies within ``F32_RTOL`` of
the feature's scale from a split threshold of the ensemble; it asserts
the precondition instead of filtering cases.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fusion as jf
from repro.core import pipeline as jp
from repro.core import scorers as js
from repro.core.brute_force import TopK as JTopK
from repro.core.spaces import DenseSpace as JDense
from repro.data.synthetic import make_corpus
from repro_torch import interop
from repro_torch.core import pipeline as tp
from repro_torch.core import scorers as ts
from repro_torch.core.brute_force import TopK
from repro_torch.core.fusion import ObliviousTreeEnsemble
from repro_torch.core.spaces import DenseSpace

from _torch_parity import F32_RTOL, assert_scores_close

pytestmark = pytest.mark.torch

N, D, B, C = 96, 8, 6, 24


def _t(a):
    return torch.from_numpy(np.array(a))


def _grid_table(seed, f=3, n=N, b=B):
    """Planted features [B, N, F] on a grid of 1/8 in [-2, 2]."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-16, 17, (b, n, f)) / 8.0).astype(np.float32)


def _proxies(table):
    """(repro composite, port composite) of one proxy extractor per
    feature column of ``table``, read at (query row, candidate id)."""
    def j_fn(col):
        return lambda q, c: jnp.asarray(table)[jnp.arange(c.shape[0])[:, None], c, col]

    def t_fn(col):
        tt = _t(table)
        return lambda q, c: tt[torch.arange(c.shape[0])[:, None], c.long(), col]

    f = table.shape[-1]
    return (js.CompositeExtractor(tuple(js.ProxyExtractor(j_fn(i)) for i in range(f))),
            ts.CompositeExtractor(tuple(ts.ProxyExtractor(t_fn(i)) for i in range(f))))


def _cands(seed, with_inf=True):
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.permutation(N)[:C] for _ in range(B)]).astype(np.int32)
    scores = -np.sort(-rng.standard_normal((B, C)).astype(np.float32), axis=1)
    if with_inf:
        scores[0, -3:] = -np.inf                 # padded candidates of a generator's tail
        scores[1, -1] = np.nan
    return (JTopK(jnp.asarray(scores), jnp.asarray(ids)), TopK(_t(scores), _t(ids)))


def _assert_equal(want, got):
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))


@pytest.mark.parametrize("keep", [1, 5, C])
@pytest.mark.parametrize("seed", range(3))
def test_reorder_matches_repro(seed, keep):
    """Exact ties (a grid), -inf, +0 / -0 and NaN in ``lax.top_k``'s order."""
    jc, tc = _cands(seed)
    rng = np.random.default_rng(seed + 10)
    s = (rng.integers(-3, 4, (B, C)) / 2.0).astype(np.float32)
    s[s == 0] *= np.where(rng.random((s == 0).sum()) < 0.5, -1.0, 1.0).astype(np.float32)
    s[2, :4] = -np.inf
    s[3, 1] = np.nan
    _assert_equal(jp._reorder(jc, jnp.asarray(s), keep), tp._reorder(tc, _t(s), keep))


@pytest.mark.parametrize("weights", [(0.5, -0.25, 1.0), (1.0, 0.0, 0.0), (0.25, 0.25, -0.5)])
@pytest.mark.parametrize("seed", range(3))
def test_linear_reranker_matches_repro(seed, weights):
    table = _grid_table(seed)
    j_ext, t_ext = _proxies(table)
    jc, tc = _cands(seed)
    w = np.asarray(weights, np.float32)
    want = jp.LinearReranker(j_ext, jnp.asarray(w)).rerank(None, jc, 10)
    got = tp.LinearReranker(t_ext, _t(w)).rerank(None, tc, 10)
    _assert_equal(want, got)
    assert got.indices.dtype == torch.int32


def _ensemble(seed, table):
    """A LambdaMART ensemble learned by repro on grid features."""
    rng = np.random.default_rng(seed)
    feats = table[:, :C]
    labels = (feats[..., 0] + feats[..., -1] > 0.5).astype(np.float32)
    labels[rng.random(labels.shape) < 0.1] = 2.0
    valid = np.ones(labels.shape, bool)
    return jf.lambdamart(jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(valid),
                         n_trees=6, depth=3, n_bins=8)


def _offset_features(table):
    """Held-out features 1/128 off the training grid.  LambdaMART's
    thresholds are quantiles of the training features: a point between
    two grid values at a fraction k/8 of the way (the quantile positions
    of 8 bins over 144 samples), so on a grid of 1/64, which 1/128 misses
    by 1/128.  The sums stay exact in f32."""
    return (table + np.float32(1.0 / 128.0)).astype(np.float32)


def _assert_no_feature_near_a_threshold(feats, ens, rtol=F32_RTOL):
    x = np.asarray(feats).reshape(-1, feats.shape[-1]).astype(np.float64)
    scale = np.maximum(np.abs(x).max(0), 1e-30)
    for f, t in zip(np.asarray(ens.feat).ravel(), np.asarray(ens.thresh).ravel()):
        gap = np.abs(x[:, f] - float(t)).min()
        assert gap > rtol * scale[f], \
            f"precondition broken: a feature {f} value lies {gap:.3g} from threshold {t}"


@pytest.mark.parametrize("seed", range(3))
def test_tree_reranker_matches_repro(seed):
    """Precondition: every held-out feature lies off every threshold by
    more than the tolerance (:func:`_offset_features`)."""
    table = _grid_table(seed)
    ens = _ensemble(seed, table)
    held = _offset_features(table)
    _assert_no_feature_near_a_threshold(held, ens)
    t_ens = interop.tree_ensemble(np.asarray(ens.feat), np.asarray(ens.thresh),
                                  np.asarray(ens.leaves), ens.lr, "cpu")
    assert isinstance(t_ens, ObliviousTreeEnsemble)
    np.testing.assert_array_equal(t_ens.predict(_t(held)).numpy(),
                                  np.asarray(ens.predict(jnp.asarray(held))))
    j_ext, t_ext = _proxies(held)
    jc, tc = _cands(seed + 3)
    want = jp.TreeReranker(j_ext, ens).rerank(None, jc, 10)
    got = tp.TreeReranker(t_ext, t_ens).rerank(None, tc, 10)
    _assert_equal(want, got)


@pytest.mark.parametrize("model", ["linear", "tree"])
def test_rerank_features_is_the_rerank_after_extraction(model):
    """``rerank_features`` on the extractor's output gives ``rerank``'s
    answer bit for bit (the split the card's stage timing uses)."""
    table = _grid_table(1)
    held = _offset_features(table)
    _, t_ext = _proxies(held)
    _, tc = _cands(4)
    if model == "linear":
        rr = tp.LinearReranker(t_ext, _t(np.float32([0.5, -0.25, 1.0])))
    else:
        ens = _ensemble(1, table)
        rr = tp.TreeReranker(t_ext, interop.tree_ensemble(np.asarray(ens.feat), np.asarray(ens.thresh),
                                                          np.asarray(ens.leaves), ens.lr, "cpu"))
    want = rr.rerank(None, tc, 10)
    got = rr.rerank_features(tc, t_ext.extract(None, tc.indices), 10)
    assert torch.equal(got.indices, want.indices)
    assert torch.equal(got.scores, want.scores)


def test_tree_precondition_check_catches_a_feature_on_a_threshold():
    table = _grid_table(0)
    ens = _ensemble(0, table)
    held = _offset_features(table)
    held[0, 0, int(np.asarray(ens.feat)[0, 0])] = float(np.asarray(ens.thresh)[0, 0])
    with pytest.raises(AssertionError, match="precondition broken"):
        _assert_no_feature_near_a_threshold(held, ens)


# ---------------------------------------------------------------------------
# Real extractors in the rerankers, and the apply_rerankers funnel tail.
# ---------------------------------------------------------------------------

V = 500


@pytest.fixture(scope="module")
def flex():
    corpus = make_corpus(n_docs=256, n_queries=32, vocab_lemmas=V, seed=3)
    jfwd = js.build_forward_index(corpus.doc_lemmas, V)
    tfwd = interop.forward_index(np.asarray(jfwd.tokens), np.asarray(jfwd.length),
                                 np.asarray(jfwd.df), V, jfwd.avg_len, "cpu")
    q = np.full((16, 8), V, np.int32)
    for i, row in enumerate(corpus.q_lemmas[:16]):
        q[i, :len(row[:8])] = row[:8]
    return jfwd, tfwd, q


CONFIG = [{"type": "TFIDFSimilarity", "params": {}}, {"type": "proximity", "params": {"window": 3}}]


def _near_tie_ids(want_ids, want_scores, got_ids, rtol=F32_RTOL):
    """Ids equal, or different only between neighbours whose scores lie
    within ``rtol`` of the row scale of each other."""
    bad = got_ids != want_ids
    if not bad.any():
        return
    s = np.asarray(want_scores, np.float64)
    scale = np.max(np.where(np.isfinite(s), np.abs(s), 0), axis=1, keepdims=True)
    gap = np.abs(s[:, :-1] - s[:, 1:]) <= 2 * rtol * scale
    near = np.zeros_like(bad)
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    assert not (bad & ~near).any(), "ids differ beyond near-ties"


def test_linear_reranker_on_real_features_matches_repro(flex):
    jfwd, tfwd, q = flex
    rng = np.random.default_rng(4)
    ids = np.stack([rng.permutation(256)[:40] for _ in range(16)]).astype(np.int32)
    scores = np.zeros((16, 40), np.float32)
    w = np.asarray([1.0, 0.5, 0.25], np.float32)
    want = jp.LinearReranker(js.CompositeExtractor.from_config(CONFIG, fwd=jfwd), jnp.asarray(w)).rerank(
        jnp.asarray(q), JTopK(jnp.asarray(scores), jnp.asarray(ids)), 20)
    got = tp.LinearReranker(ts.CompositeExtractor.from_config(CONFIG, fwd=tfwd), _t(w)).rerank(
        _t(q), TopK(_t(scores), _t(ids)), 20)
    assert_scores_close(np.asarray(want.scores), got.scores.numpy())
    _near_tie_ids(np.asarray(want.indices), np.asarray(want.scores), got.indices.numpy())


def test_apply_rerankers_funnel_matches_repro():
    """Generator -> linear (24 -> 12) -> tree (12 -> 5), both packages."""
    table = _grid_table(7)
    ens = _ensemble(7, table)
    held = _offset_features(table)
    _assert_no_feature_near_a_threshold(held, ens)
    j_ext, t_ext = _proxies(held)
    t_ens = interop.tree_ensemble(np.asarray(ens.feat), np.asarray(ens.thresh),
                                  np.asarray(ens.leaves), ens.lr, "cpu")
    w = np.asarray([0.5, 0.25, -0.125], np.float32)
    jc, tc = _cands(8, with_inf=False)
    want = jp.apply_rerankers(jc, None, intermediate=jp.LinearReranker(j_ext, jnp.asarray(w)),
                              final=jp.TreeReranker(j_ext, ens), interm_qty=12, final_qty=5)
    got = tp.apply_rerankers(tc, None, intermediate=tp.LinearReranker(t_ext, _t(w)),
                             final=tp.TreeReranker(t_ext, t_ens), interm_qty=12, final_qty=5)
    _assert_equal(want, got)


# ---------------------------------------------------------------------------
# The experiment descriptor (mirrors tests/test_funnel.py's round trip).
# ---------------------------------------------------------------------------

def _dense_data(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, D)).astype(np.float32),
            rng.standard_normal((B, D)).astype(np.float32))


def _ctx(seed=0):
    corpus, queries = _dense_data(seed)
    jctx = {"candidate_provider": jp.BruteForceGenerator(JDense("ip"), jnp.asarray(corpus))}
    tctx = {"candidate_provider": tp.BruteForceGenerator(DenseSpace("ip"), _t(corpus))}
    return jctx, tctx, queries


def test_legacy_keys_canonicalize_and_round_trip():
    jctx, tctx, queries = _ctx()
    legacy = {"backend": "streaming", "backendParams": {"tile_n": 16}, "candQty": 16, "finalQty": 4}
    pipe = tp.RetrievalPipeline.from_descriptor(legacy, tctx)
    desc = pipe.descriptor
    assert desc == jp.RetrievalPipeline.from_descriptor(legacy, jctx).descriptor
    assert "backend" not in desc and "backendParams" not in desc
    assert desc["execBackend"] == "streaming" and desc["execBackendParams"] == {"tile_n": 16}
    again = tp.RetrievalPipeline.from_descriptor(desc, tctx)
    assert again.descriptor == desc                  # fixed point
    a, b = pipe.run(_t(queries)), again.run(_t(queries))
    assert torch.equal(a.indices, b.indices) and torch.equal(a.scores, b.scores)
    assert pipe.generator.backend.tile_n == 16


def test_conflicting_spellings_rejected():
    _, tctx, _ = _ctx()
    with pytest.raises(ValueError, match="both"):
        tp.RetrievalPipeline.from_descriptor({"backend": "streaming", "execBackend": "reference"}, tctx)
    pipe = tp.RetrievalPipeline.from_descriptor({"backend": "reference", "execBackend": "reference"}, tctx)
    assert pipe.descriptor["execBackend"] == "reference"
    with pytest.raises(ValueError, match="requires 'execBackend'"):
        tp.RetrievalPipeline.from_descriptor({"backendParams": {"tile_n": 8}}, tctx)


def test_canonicalize_descriptor_matches_repro():
    for desc in ({"backend": "pallas", "candQty": 8}, {"execBackend": "napp"}, {}):
        assert (tp.RetrievalPipeline.canonicalize_descriptor(desc)
                == jp.RetrievalPipeline.canonicalize_descriptor(desc))
    assert tp.RetrievalPipeline._LEGACY_DESCRIPTOR_KEYS == jp.RetrievalPipeline._LEGACY_DESCRIPTOR_KEYS


def test_hand_built_pipeline_reports_canonical_keys():
    jctx, tctx, _ = _ctx()
    pipe = tp.RetrievalPipeline(tctx["candidate_provider"], cand_qty=16,
                                final_qty=4).with_backend("streaming")
    desc = pipe.descriptor
    assert desc == jp.RetrievalPipeline(jctx["candidate_provider"], cand_qty=16,
                                        final_qty=4).with_backend("streaming").descriptor
    assert desc["execBackend"].startswith("streaming") and "backend" not in desc
    assert desc["corpusDtype"] == "float32"


def test_pallas_descriptor_serves_through_the_cuda_backend():
    """A descriptor written for repro's kernel backend loads: ``"pallas"``
    names the port's ``cuda`` backend, and the descriptor keeps its word."""
    _, tctx, queries = _ctx()
    pipe = tp.RetrievalPipeline.from_descriptor({"backend": "pallas", "candQty": 16, "finalQty": 4}, tctx)
    assert type(pipe.generator.backend).__name__ == "CudaBackend"
    assert pipe.descriptor["execBackend"] == "pallas"
    ref = tp.RetrievalPipeline(tctx["candidate_provider"], cand_qty=16, final_qty=4)
    assert torch.equal(pipe.run(_t(queries)).indices, ref.run(_t(queries)).indices)


def test_fig4_descriptor_builds_both_rerankers_and_matches_repro():
    """candProv, extrTypeInterm/modelInterm (a linear model),
    extrType/model (an ensemble): the same reranked ids in both packages."""
    table = _grid_table(11, f=1)
    ens = _ensemble(11, table)
    held = _offset_features(table)
    _assert_no_feature_near_a_threshold(held, ens)
    jctx, tctx, queries = _ctx(11)
    j_ext, t_ext = _proxies(held)
    w = np.asarray([0.75], np.float32)
    config = [{"type": "proxy", "params": {}}]       # its score_fn comes from the context
    desc = {"candProv": "candidate_provider", "candQty": C, "intermQty": 12, "finalQty": 5,
            "extrTypeInterm": config, "modelInterm": "linear",
            "extrType": config, "model": "tree", "corpusDtype": "float32"}
    jctx.update(linear=w, tree=ens, score_fn=j_ext.extractors[0].score_fn)
    tctx.update(linear=w, tree=interop.tree_ensemble(np.asarray(ens.feat), np.asarray(ens.thresh),
                                                    np.asarray(ens.leaves), ens.lr, "cpu"),
                score_fn=t_ext.extractors[0].score_fn)
    jpipe = jp.RetrievalPipeline.from_descriptor(desc, jctx)
    tpipe = tp.RetrievalPipeline.from_descriptor(desc, tctx)
    assert isinstance(tpipe.intermediate, tp.LinearReranker)
    assert isinstance(tpipe.final, tp.TreeReranker)
    assert tpipe.descriptor == jpipe.descriptor == desc
    assert tp.RetrievalPipeline.from_descriptor(tpipe.descriptor, tctx).descriptor == desc
    cand_j = jpipe.generate_candidates(jnp.asarray(queries))
    cand_t = tpipe.generate_candidates(_t(queries))
    np.testing.assert_array_equal(cand_t.indices.numpy(), np.asarray(cand_j.indices))
    # rerank the same candidate lists (the generators' scores differ in ULPs)
    want = jp.apply_rerankers(cand_j, None, intermediate=jpipe.intermediate, final=jpipe.final,
                              interm_qty=12, final_qty=5)
    got = tp.apply_rerankers(cand_t, None, intermediate=tpipe.intermediate, final=tpipe.final,
                             interm_qty=12, final_qty=5)
    _assert_equal(want, got)
    assert torch.equal(tpipe.run(_t(queries)).indices, got.indices)
