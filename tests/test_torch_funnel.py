"""repro_torch.serving.funnel: the staged candgen -> fusion -> rerank
endpoint held against ``repro``'s ``FunnelPipeline``, offline and served.

The funnel must equal the offline ``apply_rerankers`` composition of the
port bit for bit, and ``repro``'s funnel with ids equal and scores within
``F32_RTOL``.  Under a budget that forces the rerank stage to be skipped,
both packages count the same fallbacks and overruns and serve the same
degraded answer (the fused candidates truncated to the served width).
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as jp
from repro.core.pipeline import _reorder as j_reorder
from repro.core.spaces import DenseSpace as JDense
from repro import serving as js
from repro.serving.sharded import ShardedPipeline as JSharded
from repro_torch import serving as ts
from repro_torch.core import pipeline as tp
from repro_torch.core.brute_force import TopK, select_topk
from repro_torch.core.spaces import DenseSpace
from repro_torch.serving import (EndpointSpec, FunnelPipeline, LiveCorpus, LiveGenerator,
                                 RetrievalService, ShardedPipeline, StageBudget)

from _torch_parity import (FrozenClock, assert_topk_match, batched_offline, serve_in_order)

pytestmark = pytest.mark.torch

N, D, NQ = 80, 8, 12
K_CAND, K_FUSE, K_SERVE = 32, 16, 8


def _data(seed=0, n=N):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, D)).astype(np.float32),
            rng.standard_normal((NQ, D)).astype(np.float32))


class IdBias:
    """A deterministic reranker: candidate scores plus ``(id % 7) * scale``
    (plus 1e-3 of the token sum when tokens are given), re-ranked."""

    def __init__(self, scale: float):
        self.scale = scale

    def rerank(self, q_tokens, cands, keep):
        bias = (cands.indices % 7).float() * self.scale
        if q_tokens is not None:
            bias = bias + 1e-3 * q_tokens.float().sum(dim=-1, keepdim=True)
        scores = torch.where(torch.isfinite(cands.scores), cands.scores + bias,
                             torch.full_like(cands.scores, -torch.inf))
        vals, pos = select_topk(scores, keep)
        return TopK(vals, torch.gather(cands.indices, 1, pos))


class JIdBias:
    def __init__(self, scale: float):
        self.scale = scale

    def rerank(self, q_tokens, cands, keep):
        bias = (cands.indices % 7).astype(jnp.float32) * self.scale
        if q_tokens is not None:
            bias = bias + 1e-3 * jnp.sum(q_tokens.astype(jnp.float32), axis=-1, keepdims=True)
        mask = jnp.isfinite(cands.scores)
        return j_reorder(cands, jnp.where(mask, cands.scores + bias, -jnp.inf), keep)


class Slow:
    """A reranker with an injected host delay, counting its calls."""

    def __init__(self, inner, delay_s: float):
        self.inner, self.delay_s, self.calls = inner, delay_s, 0

    def rerank(self, q_tokens, cands, keep):
        self.calls += 1
        time.sleep(self.delay_s)
        return self.inner.rerank(q_tokens, cands, keep)


def _gens(corpus):
    return (jp.BruteForceGenerator(JDense("ip"), jnp.asarray(corpus)),
            tp.BruteForceGenerator(DenseSpace("ip"), torch.from_numpy(corpus), backend="cuda"))


def _funnels(corpus):
    jgen, tgen = _gens(corpus)
    widths = dict(cand_qty=K_CAND, fusion_qty=K_FUSE, rerank_keep=K_SERVE)
    return (js.FunnelPipeline(jgen, fusion=JIdBias(0.5), rerank=JIdBias(2.0), **widths),
            FunnelPipeline(tgen, fusion=IdBias(0.5), rerank=IdBias(2.0), **widths))


def test_offline_funnel_equals_apply_rerankers_and_repro():
    c, q = _data()
    jf, tf = _funnels(c)
    tq, tok = torch.from_numpy(q), torch.arange(NQ * 3, dtype=torch.int32).reshape(NQ, 3)
    got, trace = tf.run_timed(tq, tok)
    want = tp.apply_rerankers(tf.generator.generate(tq, K_CAND), tok, intermediate=IdBias(0.5),
                              final=IdBias(2.0), interm_qty=K_FUSE, final_qty=K_SERVE)
    assert torch.equal(got.indices, want.indices)
    assert torch.equal(got.scores.view(torch.int32), want.scores.view(torch.int32))
    assert got.indices.shape == (NQ, K_SERVE)
    assert trace.fusion_s is not None and trace.rerank_s is not None and not trace.fallback
    assert_topk_match(jf.run(jnp.asarray(q), jnp.asarray(tok.numpy())), got)


def test_widths_must_narrow_as_in_repro():
    c, _ = _data()
    jgen, tgen = _gens(c)
    with pytest.raises(ValueError) as jerr:
        js.FunnelPipeline(jgen, cand_qty=8, fusion_qty=16)
    with pytest.raises(ValueError) as terr:
        FunnelPipeline(tgen, cand_qty=8, fusion_qty=16)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="positive"):
        StageBudget(rerank_s=0.0)


def _serve_funnel(lib, funnel, queries, spec_kw, batch_size=4):
    arr = jnp.asarray if lib is js else torch.from_numpy
    clock = FrozenClock()
    with lib.RetrievalService(cache_size=0, time_fn=clock) as svc:
        svc.register_pipeline("funnel", funnel, arr(np.zeros(D, np.float32)),
                              spec=lib.EndpointSpec(batch_size=batch_size, **spec_kw))
        rows = [f.result() for f in serve_in_order(svc, "funnel", [arr(x) for x in queries], clock)]
        return rows, svc.snapshot().endpoints["funnel"]


def _stage_counts(ep):
    return (ep.n_batches, ep.stage_fallbacks, ep.stage_overruns, ep.stage_occupancy)


def test_served_funnel_without_budget_equals_offline_and_repro():
    c, q = _data(seed=1)
    jf, tf = _funnels(c)
    rows, ep = _serve_funnel(ts, tf, q, {})
    want = batched_offline(tf.run, [torch.from_numpy(x) for x in q], torch.zeros(D), 4)
    for i, (g, w) in enumerate(zip(rows, want)):
        assert np.array_equal(g.indices, w.indices) and np.array_equal(
            g.scores.view(np.int32), w.scores.view(np.int32)), i
    jrows, jep = _serve_funnel(js, jf, q, {})
    np.testing.assert_array_equal(np.stack([r.indices for r in rows]),
                                  np.stack([np.asarray(r.indices) for r in jrows]))
    assert _stage_counts(ep) == _stage_counts(jep)
    assert ep.stage_fallbacks == {"candgen": 0, "fusion": 0, "rerank": 0}
    assert ep.stages["rerank"].count == ep.n_batches == 3


def test_budget_skip_is_counted_and_serves_the_fused_answer_as_repro():
    """The first batch runs the slow rerank (it seeds the cost estimate)
    and overruns; every later batch skips it and serves the fused
    candidates truncated to the served width."""
    c, q = _data(seed=2)
    jgen, tgen = _gens(c)
    widths = dict(cand_qty=K_CAND, fusion_qty=K_FUSE, rerank_keep=K_SERVE)
    jf = js.FunnelPipeline(jgen, fusion=JIdBias(0.5), rerank=Slow(JIdBias(2.0), 0.02),
                           budget=js.StageBudget(rerank_s=1e-3), **widths)
    slow = Slow(IdBias(2.0), 0.02)
    tf = FunnelPipeline(tgen, fusion=IdBias(0.5), rerank=slow, budget=StageBudget(rerank_s=1e-3),
                        **widths)
    rows, ep = _serve_funnel(ts, tf, q, {})
    jrows, jep = _serve_funnel(js, jf, q, {})
    assert _stage_counts(ep) == _stage_counts(jep)
    assert ep.stage_fallbacks["rerank"] == 2 and ep.stage_overruns["rerank"] == 1
    assert ep.stage_occupancy["rerank"] == pytest.approx(1 / 3) and slow.calls == 1
    full = tp.apply_rerankers(tf.generator.generate(torch.from_numpy(q), K_CAND), None,
                              intermediate=IdBias(0.5), final=IdBias(2.0),
                              interm_qty=K_FUSE, final_qty=K_SERVE)
    degraded = tp.apply_rerankers(tf.generator.generate(torch.from_numpy(q), K_CAND), None,
                                  intermediate=IdBias(0.5), interm_qty=K_FUSE, final_qty=K_SERVE)
    for i, r in enumerate(rows):
        want = full if i < 4 else degraded
        np.testing.assert_array_equal(r.indices, want.indices[i].numpy(), err_msg=str(i))
        np.testing.assert_array_equal(np.asarray(jrows[i].indices), r.indices, err_msg=str(i))


def test_spec_binds_the_funnel_knobs_and_refuses_them_elsewhere():
    c, q = _data(seed=3)
    _, tf = _funnels(c)
    rows, ep = _serve_funnel(ts, tf, q[:4], {"rerank_keep": 5,
                                                    "budget": StageBudget(total_s=60.0)})
    assert rows[0].indices.shape == (5,)
    assert ep.stage_fallbacks["rerank"] == 0
    plain = tp.RetrievalPipeline(tf.generator)
    with RetrievalService(cache_size=0) as svc:
        with pytest.raises(ValueError, match="funnel knobs"):
            svc.register_pipeline("p", plain, torch.zeros(D), spec=EndpointSpec(rerank_keep=5))


def test_funnel_over_shards_reranks_once_after_the_merge():
    c, q = _data(seed=4, n=97)
    _, tf = _funnels(c)
    tq = torch.from_numpy(q)
    with ShardedPipeline.from_corpus(DenseSpace("ip"), torch.from_numpy(c), 3, backend="cuda",
                                     cand_qty=K_CAND) as sharded:
        sf = FunnelPipeline(sharded, fusion=IdBias(0.5), rerank=IdBias(2.0), cand_qty=K_CAND,
                            fusion_qty=K_FUSE, rerank_keep=K_SERVE)
        got = sf.run(tq)
        assert sf.n_shards == 3
    assert torch.equal(got.indices, tf.run(tq).indices)
    jgen = JSharded.from_corpus(JDense("ip"), jnp.asarray(c), 3, cand_qty=K_CAND)
    jf = js.FunnelPipeline(jgen, fusion=JIdBias(0.5), rerank=JIdBias(2.0), cand_qty=K_CAND,
                           fusion_qty=K_FUSE, rerank_keep=K_SERVE)
    assert_topk_match(jf.run(jnp.asarray(q)), got)
    jgen.close()


def test_funnel_over_a_live_corpus_pins_one_snapshot():
    c, q = _data(seed=5)
    live = LiveCorpus(DenseSpace("ip"), torch.from_numpy(c), backend="cuda", append_backend="cuda",
                      max_append=10 ** 9, device="cpu")
    gen = LiveGenerator(live)
    f = FunnelPipeline(gen, fusion=IdBias(0.5), rerank=IdBias(2.0), cand_qty=K_CAND,
                       fusion_qty=K_FUSE, rerank_keep=K_SERVE)
    tq = torch.from_numpy(q)
    before = f.run(tq)
    assert gen.last_served_generation == 0
    live.upsert(before.indices[:, 0].unique().numpy(), torch.zeros(len(before.indices[:, 0].unique()), D))
    after = f.run(tq)
    assert gen.last_served_generation == 1
    snap = live.snapshot()
    from repro_torch.core import segments
    cands = segments.live_topk(DenseSpace("ip"), snap, tq, K_CAND, main_backend=live.main_backend,
                               append_backend=live.append_backend)
    want = tp.apply_rerankers(cands, None, intermediate=IdBias(0.5), final=IdBias(2.0),
                              interm_qty=K_FUSE, final_qty=K_SERVE)
    assert torch.equal(after.indices, want.indices)
    assert not torch.equal(after.indices, before.indices)
