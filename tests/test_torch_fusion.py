"""repro_torch.core.fusion (and sparse.topk_truncate) held against
repro.core.fusion, and the slice's end-to-end gate: weights learned by
the port and served through its ``cuda`` backend (plain versions on the
CPU) give the ids of repro's learned weights on its reference backend.

Inputs are made once with numpy and fed to both packages.  Tolerances:
metrics within ``F32_RTOL`` (2e-6) relative (the query sums run in
another order); coordinate-ascent weights and metric equal (the planted
problems keep every proposal's metric clear of f32 noise: a boundary
between two rankings never lies on a ratio the step grid reaches);
LambdaMART trees equal in features and thresholds (planted: labels are
thresholds of features on a coarse grid), leaves and predictions within
``LEAF_RTOL`` = 1e-5 of the largest |leaf| (each tree's gradients sum
over the candidate pairs, and its histograms scatter, in another order,
and the trees feed each other); exported composites: ids equal, values
within one f32 rounding; served ids equal, scores within ``F32_RTOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fusion as jf
from repro.core import pipeline as jp
from repro.core import sparse as jsp
from repro.core.spaces import FusedSpace as JFused
from repro_torch.core import fusion as tf
from repro_torch.core import pipeline as tp
from repro_torch.core import sparse as tsp
from repro_torch.core.spaces import FusedSpace

from _torch_parity import (F32_RTOL, assert_scores_close, assert_topk_match, fused_to_torch,
                           jnp_fused)

pytestmark = pytest.mark.torch

LEAF_RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _graded(seed, q=6, c=9, ties=False):
    """Scores, multi-grade labels and a padding mask; with ``ties``
    scores on a coarse grid, so that many tie (and +0 meets -0)."""
    rng = np.random.default_rng(seed)
    if ties:
        s = (rng.integers(-2, 3, (q, c)) * 0.5).astype(np.float32)
        s[s == 0] *= np.where(rng.random((s == 0).sum()) < 0.5, -1.0, 1.0).astype(np.float32)
    else:
        s = rng.standard_normal((q, c)).astype(np.float32)
    labels = rng.integers(0, 4, (q, c)).astype(np.float32)
    labels[rng.random((q, c)) < 0.4] = 0.0
    valid = rng.random((q, c)) < 0.8
    valid[0] = True
    labels[-1] = 0.0                      # a query with no relevant candidate
    return s, labels, valid


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_ranks_match_repro(seed, ties):
    s, _, valid = _graded(seed, ties=ties)
    want = np.asarray(jf._ranks(jnp.asarray(s), jnp.asarray(valid)))
    np.testing.assert_array_equal(tf._ranks(_t(s), _t(valid)).numpy(), want)


def test_ranks_tie_zeros_and_nan_as_argsort():
    s = np.array([[0.0, -0.0, 1.0, np.nan, -0.0, np.nan, 1.0, -np.inf]], np.float32)
    valid = np.array([[True, True, True, True, True, True, True, False]])
    want = np.asarray(jf._ranks(jnp.asarray(s), jnp.asarray(valid)))
    np.testing.assert_array_equal(tf._ranks(_t(s), _t(valid)).numpy(), want)


@pytest.mark.parametrize("k", [1, 3, 10])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("metric", ["mrr", "ndcg"])
def test_metrics_match_repro(metric, ties, k):
    for seed in range(3):
        s, labels, valid = _graded(seed, c=12, ties=ties)
        jfn, tfn = {"mrr": (jf.mrr, tf.mrr), "ndcg": (jf.ndcg_at_k, tf.ndcg_at_k)}[metric]
        want = float(jfn(jnp.asarray(s), jnp.asarray(labels), jnp.asarray(valid), k))
        got = float(tfn(_t(s), _t(labels), _t(valid), k))
        assert abs(got - want) <= F32_RTOL * max(abs(want), 1e-30), (seed, got, want)


def test_metrics_batch_leading_dimensions():
    """A leading proposal axis evaluates each slice as the 2-D call does."""
    s, labels, valid = _graded(4, c=10)
    stack = np.stack([s, -s, 2 * s])
    for fn in (tf.mrr, tf.ndcg_at_k):
        batched = fn(_t(stack), _t(labels), _t(valid), 5)
        one = torch.stack([fn(_t(x), _t(labels), _t(valid), 5) for x in stack])
        assert torch.equal(batched, one)


def _fusion_problem(seed, q=32, c=20, noise=0.3):
    """Candidate component scores of a planted problem: per query a
    relevant candidate (2.5 dense, 25 sparse), a dense decoy (3, 0) and a
    sparse decoy (0, 29), random candidates below (noise, 3 * noise); a
    mix ranks the relevant one first for w_dense / w_sparse in (1.6, 50),
    neither part alone nor (1, 1) does.  Two padded slots per query."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(-noise, noise, (q, c)).astype(np.float32)
    s = rng.uniform(0, 3 * noise, (q, c)).astype(np.float32)
    labels = np.zeros((q, c), np.float32)
    valid = np.ones((q, c), bool)
    for i in range(q):
        rel, dd, ds = rng.permutation(c - 2)[:3]
        d[i, rel], s[i, rel], labels[i, rel] = 2.5, 25.0, 1.0
        d[i, dd], s[i, dd] = 3.0, 0.0
        d[i, ds], s[i, ds] = 0.0, 29.0
    valid[:, -2:] = rng.random((q, 2)) < 0.5
    return d, s, labels, valid


@pytest.mark.parametrize("seed", range(3))
def test_learn_fused_weights_matches_repro(seed):
    d, s, labels, valid = _fusion_problem(seed)
    want = jf.learn_fused_weights(jnp.asarray(d), jnp.asarray(s), jnp.asarray(labels),
                                  jnp.asarray(valid), n_restarts=1)
    got = tf.learn_fused_weights(_t(d), _t(s), _t(labels), _t(valid), n_restarts=1)
    assert got == want
    assert 1.6 < got[0] / got[1] < 50 and got[2] == 1.0
    uniform = float(tf.mrr(_t(d) + _t(s), _t(labels), _t(valid)))
    assert got[2] > uniform


@pytest.mark.parametrize("metric", ["mrr", "ndcg"])
@pytest.mark.parametrize("seed", range(2))
def test_coordinate_ascent_three_features_matches_repro(seed, metric):
    d, s, labels, valid = _fusion_problem(seed)
    extra = np.random.default_rng(seed + 50).uniform(0, 1, d.shape).astype(np.float32)
    feats = np.stack([d, s, extra], axis=-1)
    jw, jm = jf.coordinate_ascent(jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(valid),
                                  metric=metric, n_restarts=1, n_rounds=3)
    tw, tm = tf.coordinate_ascent(_t(feats), _t(labels), _t(valid), metric=metric, n_restarts=1,
                                  n_rounds=3)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert tm == jm


def test_coordinate_ascent_restarts_never_lose_to_the_uniform_start():
    """Restarts draw from the explicit generator (not jax.random's
    stream), so only the achieved metric is held: at least the
    deterministic uniform start's, and repeatable for one seed."""
    d, s, labels, valid = _fusion_problem(7)
    d += np.random.default_rng(1).uniform(-1.0, 1.0, d.shape).astype(np.float32)   # a harder mix
    feats = _t(np.stack([d, s], axis=-1))
    _, one = tf.coordinate_ascent(feats, _t(labels), _t(valid), n_restarts=1)
    w3, three = tf.coordinate_ascent(feats, _t(labels), _t(valid), n_restarts=4,
                                     generator=torch.Generator().manual_seed(3))
    w3b, again = tf.coordinate_ascent(feats, _t(labels), _t(valid), n_restarts=4,
                                      generator=torch.Generator().manual_seed(3))
    assert three >= one and three == again and torch.equal(w3, w3b)
    assert abs(float(w3.abs().sum()) - 1.0) < 1e-6


def test_coordinate_ascent_batched_proposals_equal_one_by_one():
    """The round's one batched evaluation gives each proposal the metric
    it gets alone."""
    d, s, labels, valid = _fusion_problem(2)
    feats = _t(np.stack([d, s], axis=-1))
    w = torch.rand(7, 2, generator=torch.Generator().manual_seed(0)) - 0.3
    batched = tf.mrr(tf._linear_scores(feats, w), _t(labels), _t(valid))
    one = torch.stack([tf.mrr(tf._linear_scores(feats, w[i:i + 1])[0], _t(labels), _t(valid))
                       for i in range(len(w))])
    assert torch.equal(batched, one)


def _letor_problem(seed, q=12, c=16, f=3):
    """Features on a coarse grid (plus offsets below 1e-3) and labels that
    threshold features 0 and 1 (feature 2 is noise): split gains stand
    far apart, so both packages grow the same trees."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 8, (q, c, f)) / 8 + rng.uniform(0, 1e-3, (q, c, f))).astype(np.float32)
    labels = ((x[..., 0] > 0.5) * 2.0 + (x[..., 1] > 0.74)).astype(np.float32)
    valid = np.ones((q, c), bool)
    valid[:, -3:] = rng.random((q, 3)) < 0.5
    return x, labels, valid


@pytest.mark.parametrize("seed", range(4))
def test_lambdamart_matches_repro(seed):
    x, labels, valid = _letor_problem(seed)
    kw = dict(n_trees=8, depth=2, n_bins=8)
    want = jf.lambdamart(jnp.asarray(x), jnp.asarray(labels), jnp.asarray(valid), **kw)
    got = tf.lambdamart(_t(x), _t(labels), _t(valid), **kw)
    np.testing.assert_array_equal(got.feat.numpy(), np.asarray(want.feat))
    np.testing.assert_array_equal(got.thresh.numpy(), np.asarray(want.thresh))
    scale = float(np.abs(np.asarray(want.leaves)).max())
    np.testing.assert_allclose(got.leaves.numpy(), np.asarray(want.leaves), rtol=0,
                               atol=LEAF_RTOL * scale)
    np.testing.assert_allclose(got.predict(_t(x)).numpy(), np.asarray(want.predict(jnp.asarray(x))),
                               rtol=0, atol=LEAF_RTOL * scale * kw["n_trees"])
    # the ensemble learned something: NDCG@10 above the untrained order's
    pred = got.predict(_t(x))
    assert float(tf.ndcg_at_k(pred, _t(labels), _t(valid))) > float(
        tf.ndcg_at_k(torch.zeros_like(pred), _t(labels), _t(valid)))


def test_lambda_grads_match_repro():
    x, labels, valid = _letor_problem(9)
    s = x.sum(-1)
    jl, jw = jf._lambda_grads(jnp.asarray(s), jnp.asarray(labels), jnp.asarray(valid))
    tl, tw = tf._lambda_grads(_t(s), _t(labels), _t(valid))
    assert_scores_close(np.asarray(jl), tl.numpy())
    assert_scores_close(np.asarray(jw), tw.numpy())


def _components(seed):
    rng = np.random.default_rng(seed)
    b, n = 3, 5

    def coo(rows, vocab, nnz):
        idx = rng.integers(0, vocab + 3, (rows, nnz)).astype(np.int32)   # some past the vocab: padding
        val = rng.standard_normal((rows, nnz)).astype(np.float32)
        val[rng.random((rows, nnz)) < 0.2] = 0.0
        return idx, val

    parts = [("dense", 0.7, rng.standard_normal((b, 4)).astype(np.float32),
              rng.standard_normal((n, 4)).astype(np.float32)),
             ("sparse", 1.3, coo(b, 20, 6), coo(n, 20, 5)),
             ("dense", -0.4, rng.standard_normal((b, 2)).astype(np.float32),
              rng.standard_normal((n, 2)).astype(np.float32)),
             ("sparse", 0.25, coo(b, 15, 3), coo(n, 15, 4))]
    return parts, [20, 15]


def _as(pkg, part):
    kind, w, q, d = part
    if kind == "dense":
        return (kind, w, jnp.asarray(q), jnp.asarray(d)) if pkg == "jax" else (kind, w, _t(q), _t(d))
    make = ((lambda a: jsp.SparseVectors(jnp.asarray(a[0]), jnp.asarray(a[1]))) if pkg == "jax"
            else (lambda a: tsp.SparseVectors(_t(a[0]), _t(a[1]))))
    return kind, w, make(q), make(d)


@pytest.mark.parametrize("seed", range(3))
def test_export_composite_matches_repro(seed):
    parts, vocab = _components(seed)
    jq, jd, jv = jf.export_composite([_as("jax", p) for p in parts], vocab)
    tq, td, tv = tf.export_composite([_as("torch", p) for p in parts], vocab)
    assert tv == jv == sum(vocab)
    for jfv, tfv in ((jq, tq), (jd, td)):
        np.testing.assert_array_equal(tfv.sparse.indices.numpy(), np.asarray(jfv.sparse.indices))
        for want, got in ((jfv.dense, tfv.dense), (jfv.sparse.values, tfv.sparse.values)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=2 ** -24, atol=0)


def test_require_bf16_margin_raises_as_repro():
    scores = np.array([[5.0, 4.0, 3.9], [2.0, 1.99, 1.0]], np.float32)   # gaps 0.1 and 0.99
    for bound, thin in ((0.001, False), (0.06, True), (np.array([0.001, 0.6]), True),
                        (np.array([0.04, 0.4]), False)):
        outcome = []
        for fn, arg in ((jf.require_bf16_margin, scores), (tf.require_bf16_margin, _t(scores))):
            try:
                fn(arg, pert_bound=bound)
                outcome.append(False)
            except AssertionError:
                outcome.append(True)
        assert outcome == [thin, thin], (bound, outcome)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nnz", [1, 3, 6])
def test_topk_truncate_matches_repro(nnz, dtype):
    rng = np.random.default_rng(nnz)
    idx = rng.integers(0, 30, (4, 8)).astype(np.int32)
    val = (rng.integers(-2, 3, (4, 8)) * 0.5).astype(np.float32)    # ties in |value|, zeros
    val[0, :3] = [-0.0, 0.0, -1.0]
    jv = jnp.asarray(val, getattr(jnp, dtype))
    want = jsp.topk_truncate(jsp.SparseVectors(jnp.asarray(idx), jv), nnz, 30)
    tv = _t(val).to(getattr(torch, dtype))
    got = tsp.topk_truncate(tsp.SparseVectors(_t(idx), tv), nnz, 30)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.float().numpy(), np.asarray(want.values, np.float32))
    assert got.values.dtype == tv.dtype


def _served_problem(seed, n=300, d=16, v=200, nq=32):
    """A fused corpus with, per query, a relevant row (2.5 dense, 25
    sparse), a dense decoy (3, 0) and a sparse decoy (0, 29) planted on
    the query's own direction and two terms of its own; the other rows'
    terms lie above every query's, so they score their dense part only
    (a few tenths).  Returns numpy (corpus parts, query parts, relevant
    rows)."""
    rng = np.random.default_rng(seed)
    dense = (rng.standard_normal((n, d)) * 0.05).astype(np.float32)
    idx = rng.integers(2 * nq, v, (n, 6)).astype(np.int32)
    val = rng.uniform(0, 0.3, (n, 6)).astype(np.float32)
    u = rng.standard_normal((nq, d)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    terms = rng.permutation(2 * nq).reshape(nq, 2).astype(np.int32)
    qi = np.full((nq, 4), v, np.int32)
    qv = np.zeros((nq, 4), np.float32)
    qi[:, :2], qv[:, :2] = terms, 1.0
    rows = rng.permutation(n)[:3 * nq].reshape(3, nq)
    for r, dw, sw in ((rows[0], 2.5, 12.5), (rows[1], 3.0, 0.0), (rows[2], 0.0, 14.5)):
        dense[r] = dw * u
        idx[r], val[r] = v, 0.0
        if sw:
            idx[r, :2], val[r, :2] = terms, sw
    return (dense, idx, val), (u, qi, qv), rows[0]


def test_end_to_end_learned_weights_served_through_the_cuda_backend():
    """The slice's gate.  Both packages score the same training candidates
    (repro's reference top-12 at weights (1, 1), ids equal in the port)
    with their own ``score_pairs``, learn weights (equal), and serve the
    held-out queries: the port through ``RetrievalPipeline`` on the
    ``cuda`` backend (its plain versions on the CPU), repro on its
    reference backend.  Ids equal, scores within F32_RTOL; the learned
    weights beat (1, 1) on held-out MRR."""
    v, c, train = 200, 12, 24
    corpus_np, q_np, rel = _served_problem(0, v=v)
    jc, jq = jnp_fused(corpus_np), jnp_fused(q_np)
    tc, tq = fused_to_torch(jc), fused_to_torch(jq)
    take_j = lambda a, lo, hi: jax.tree.map(lambda x: x[lo:hi], a)
    take_t = lambda a, lo, hi: type(a)(a.dense[lo:hi], type(a.sparse)(a.sparse.indices[lo:hi],
                                                                       a.sparse.values[lo:hi]))
    uniform_j, uniform_t = JFused(v), FusedSpace(v)

    cand_j = jp.BruteForceGenerator(uniform_j, jc, backend="reference").generate(take_j(jq, 0, train), c)
    cand_t = tp.BruteForceGenerator(uniform_t, tc, backend="cuda").generate(take_t(tq, 0, train), c)
    assert_topk_match(cand_j, cand_t)
    ids = np.array(cand_j.indices)
    labels = (ids == rel[:train, None]).astype(np.float32)
    assert labels.any(1).all()
    flat = ids.reshape(-1)
    rep = np.repeat(np.arange(train), c)

    def parts(pkg, queries, corpus):
        if pkg == "jax":
            qd, qs = queries.dense[rep], jsp.SparseVectors(queries.sparse.indices[rep], queries.sparse.values[rep])
            dd, ds = corpus.dense[flat], jsp.SparseVectors(corpus.sparse.indices[flat], corpus.sparse.values[flat])
            from repro.core.spaces import DenseSpace as JDense, SparseSpace as JSparse
            return (np.asarray(JDense("ip").score_pairs(qd, dd)).reshape(train, c),
                    np.asarray(JSparse(v).score_pairs(qs, ds)).reshape(train, c))
        from repro_torch.core.spaces import DenseSpace, SparseSpace
        r, f = torch.from_numpy(rep), torch.from_numpy(flat)
        qs = tsp.SparseVectors(queries.sparse.indices[r], queries.sparse.values[r])
        ds = tsp.SparseVectors(corpus.sparse.indices[f], corpus.sparse.values[f])
        return (DenseSpace("ip").score_pairs(queries.dense[r], corpus.dense[f]).reshape(train, c).numpy(),
                SparseSpace(v).score_pairs(qs, ds).reshape(train, c).numpy())

    (jd, js), (td, ts) = parts("jax", jq, jc), parts("torch", tq, tc)
    assert_scores_close(jd, td)
    assert_scores_close(js, ts)
    valid = np.ones_like(labels, bool)
    jw = jf.learn_fused_weights(jnp.asarray(jd), jnp.asarray(js), jnp.asarray(labels), jnp.asarray(valid))
    tw = tf.learn_fused_weights(_t(td), _t(ts), _t(labels), _t(valid))
    assert tw == jw

    held_j, held_t = take_j(jq, train, None), take_t(tq, train, None)
    got = tp.RetrievalPipeline(tp.BruteForceGenerator(uniform_t.with_weights(*tw[:2]), tc, backend="cuda"),
                               cand_qty=10, final_qty=3).run(held_t)
    want = jp.RetrievalPipeline(jp.BruteForceGenerator(uniform_j.with_weights(*jw[:2]), jc,
                                                       backend="reference"),
                                cand_qty=10, final_qty=3).run(held_j)
    assert_topk_match(want, got)
    hits = lambda res: _t((res.indices.numpy() == rel[train:, None]).astype(np.float32))
    ones = torch.ones(len(rel) - train, 3, dtype=torch.bool)
    uni = tp.RetrievalPipeline(tp.BruteForceGenerator(uniform_t, tc, backend="cuda"), cand_qty=10,
                               final_qty=3).run(held_t)
    assert float(tf.mrr(got.scores, hits(got), ones)) == 1.0 > float(tf.mrr(uni.scores, hits(uni), ones))
