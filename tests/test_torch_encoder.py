"""repro_torch.models.encoder held against repro.models.encoder on the
reference's weights (carried by ``interop.transformer_params``) and the
same numpy tokens: ``encode`` with pads and ``out_dim``,
``cross_encoder_score`` with a tied head (smollm-360m, qwen2.5-3b) and an
untied one (minicpm3-4b), ``make_proxy_scorer`` with out-of-range
candidate ids, ``CrossEncoderReranker.rerank`` with ``-inf`` candidates,
``contrastive_loss`` and its metrics, and the cross-encoder as the
funnel's rerank stage (equal to the port's offline ``apply_rerankers`` bit
for bit, and to ``repro``'s funnel in ids).

Tolerances.  A cross-encoder score is a dot product whose terms cancel,
so its error is held to the batch's largest |score| (``RTOL``), an
encoded vector's to its row's largest |component|:

* f32: 1e-5, as ``test_torch_transformer.py``'s backbone.
* bf16: 2^-4.  The backbone's hidden states carry up to 2^-5 of the row
  scale (``test_torch_transformer.BF16_RTOL``); the pooling rounds once
  more (2^-9) and the head's dot over d_model terms, accumulated in f32
  and rounded once, keeps the hidden states' relative error against the
  batch's score scale: twice the backbone's bound leaves room for the
  ratio of a row's score scale to the batch's.

Reranked ids must be equal in f32.  In bf16 (8 significant bits) two
candidates' scores often lie within the tolerance of each other or are
equal, and their order then follows the last bit; ids may differ there
only between neighbours whose reference scores are that close.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.configs.base import TransformerConfig as JConfig
from repro.core import pipeline as jp
from repro.core.brute_force import TopK as JTopK
from repro.core.spaces import DenseSpace as JDense
from repro.distributed.sharding import ParallelCtx as JCtx
from repro.models import encoder as JE
from repro.models import transformer as JT
from repro import serving as js
import repro_torch.configs as tc
from repro_torch import interop
from repro_torch.configs.base import TransformerConfig
from repro_torch.core import pipeline as tp
from repro_torch.core.brute_force import TopK
from repro_torch.core.spaces import DenseSpace
from repro_torch.distributed.sharding import ParallelCtx
from repro_torch.models import encoder as TE
from repro_torch.models import transformer as TT
from repro_torch.serving import FunnelPipeline

from _torch_parity import np_of

pytestmark = pytest.mark.torch

RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -4}
ARCHS = ["smollm-360m", "qwen2.5-3b", "minicpm3-4b"]
JCTX, TCTX = JCtx(None, {}), ParallelCtx(None, {})


def _setup(arch, dtype, seed=0):
    """(repro config, port config, repro params, port model)."""
    jcfg = dataclasses.replace(jc.get_smoke_config(arch), dtype=dtype)
    tcfg = dataclasses.replace(tc.get_smoke_config(arch), dtype=dtype)
    p, _ = JT.init_transformer(jax.random.PRNGKey(seed), jcfg)
    model = interop.transformer_params(jax.tree.map(np_of, p), tcfg, "cpu")
    return jcfg, tcfg, p, model


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(np.asarray(x, np.float32), np.float64)


def assert_scores_close(want, got, rtol, ctx=""):
    """Scores within ``rtol`` of the batch's largest finite |score|; -inf
    where the reference has -inf."""
    w, g = _f64(want), _f64(got)
    assert w.shape == g.shape, (w.shape, g.shape)
    fin = np.isfinite(w)
    np.testing.assert_array_equal(fin, np.isfinite(g), err_msg=ctx)
    scale = max(np.abs(w[fin]).max(initial=0.0), 1e-30)
    err = np.abs(g[fin] - w[fin])
    assert np.all(err <= rtol * scale), f"error {err.max() / scale:.3g} of the batch scale > {rtol:.3g} {ctx}"


def assert_ids_equal_off_near_ties(want, got, rtol):
    """Reranked ids equal, except between neighbours whose reference
    scores lie within ``rtol`` of the batch scale of each other."""
    ws, wi, gi = _f64(want.scores), np.asarray(want.indices), got.indices.numpy()
    fin = np.isfinite(ws)
    scale = max(np.abs(ws[fin]).max(initial=0.0), 1e-30)
    gap = np.abs(np.diff(np.where(fin, ws, 0.0), axis=1)) <= 2 * rtol * scale
    near = np.zeros_like(fin)
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    bad = wi != gi
    assert not (bad & ~near).any(), f"ids differ beyond near ties at {np.argwhere(bad & ~near).tolist()}"
    if rtol < 1e-4:
        assert not bad.any()


def _tokens(rng, shape, vocab):
    return rng.integers(0, vocab, size=shape).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("out_dim", [None, 40])
def test_encode_matches_repro(arch, dtype, out_dim):
    """Pads (ids >= vocab_size) are left out of the mean; a negative id
    counts as a token; an all-pad row divides by max(count, 1)."""
    jcfg, tcfg, p, model = _setup(arch, dtype)
    v = jcfg.vocab_size
    tok = _tokens(np.random.default_rng(1), (4, 32), v)
    tok[0, 20:] = v            # trailing pads
    tok[1, ::3] = v + 5        # scattered pads past the vocabulary
    tok[2, 5] = -1             # a negative id: a token, the last row's embedding
    tok[3, :] = v              # all pads
    want = JE.encode(p, jnp.asarray(tok), jcfg, JCTX, out_dim=out_dim)
    with torch.no_grad():
        got = TE.encode(model, torch.from_numpy(tok), tcfg, TCTX, out_dim=out_dim)
    assert got.dtype == model.embed.dtype and got.shape == want.shape
    w, g = _f64(want), _f64(got)
    scale = np.abs(w).max(axis=-1, keepdims=True)
    assert np.all(np.abs(g - w) <= RTOL[dtype] * scale), float(np.max(np.abs(g - w) / scale))
    np.testing.assert_allclose(np.linalg.norm(g[:3], axis=-1), 1.0, rtol=2e-2 if dtype == "bfloat16" else 1e-5)
    assert not g[3].any() and not w[3].any()      # all pads: a zero sum over a count of 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cross_encoder_score_matches_repro(arch, dtype):
    jcfg, tcfg, p, model = _setup(arch, dtype)
    rng = np.random.default_rng(2)
    q, d = _tokens(rng, (6, 8), jcfg.vocab_size), _tokens(rng, (6, 24), jcfg.vocab_size)
    d[1, 18:] = jcfg.vocab_size          # padded passage: pads are positions of the mean
    want = JE.cross_encoder_score(p, jnp.asarray(q), jnp.asarray(d), jcfg, JCTX)
    with torch.no_grad():
        got = TE.cross_encoder_score(model, torch.from_numpy(q), torch.from_numpy(d), tcfg, TCTX)
    assert got.dtype == model.embed.dtype and got.shape == (6,)
    assert_scores_close(want, got, RTOL[dtype], f"{arch} {dtype}")


def test_cross_encoder_head_is_embed_row_0_tied_and_lm_head_column_0_untied():
    for arch, tied in (("smollm-360m", True), ("minicpm3-4b", False)):
        _, tcfg, _, model = _setup(arch, "float32")
        assert tcfg.tie_embeddings == tied
        q, d = torch.zeros(1, 2, dtype=torch.int64), torch.ones(1, 3, dtype=torch.int64)
        with torch.no_grad():
            hidden, _ = model(torch.cat([q, d], 1))
            head = model.embed[0] if tied else model.lm_head[:, 0]
            want = hidden.mean(1) @ head
            got = TE.cross_encoder_score(model, q, d, tcfg, TCTX)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch", ["smollm-360m", "minicpm3-4b"])
def test_proxy_scorer_matches_repro_with_out_of_range_ids(arch):
    """``doc_tokens[cand_ids]`` follows JAX: -1 is the last passage, an id
    past the end the last one, -(n + 1) wraps once and clamps to 0."""
    jcfg, tcfg, p, model = _setup(arch, "float32")
    rng = np.random.default_rng(3)
    n = 10
    docs, q = _tokens(rng, (n, 12), jcfg.vocab_size), _tokens(rng, (3, 6), jcfg.vocab_size)
    cand = np.array([[0, 4, -1, n], [n + 3, -(n + 1), 2, 9], [5, 5, 1, -n]], np.int32)
    want = JE.make_proxy_scorer(p, jcfg, JCTX, jnp.asarray(docs))(jnp.asarray(q), jnp.asarray(cand))
    got = TE.make_proxy_scorer(model, tcfg, TCTX, torch.from_numpy(docs))(torch.from_numpy(q),
                                                                         torch.from_numpy(cand))
    assert got.shape == (3, 4) and not got.requires_grad
    assert_scores_close(want, got, RTOL["float32"])
    g = got.numpy()
    assert g[0, 2] == g[0, 3] and g[1, 0] == g[1, 3] and g[2, 0] == g[2, 1]   # the same passage


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reranker_matches_repro_with_inf_candidates(dtype):
    jcfg, tcfg, p, model = _setup("smollm-360m", dtype)
    rng = np.random.default_rng(4)
    n, b, c, keep = 40, 4, 12, 5
    docs, q = _tokens(rng, (n, 10), jcfg.vocab_size), _tokens(rng, (b, 6), jcfg.vocab_size)
    ids = np.stack([rng.permutation(n)[:c] for _ in range(b)]).astype(np.int32)
    scores = np.sort(rng.standard_normal((b, c)).astype(np.float32), axis=1)[:, ::-1].copy()
    scores[1, 8:] = -np.inf                  # a short candidate list: padded slots
    scores[2, 3] = -np.inf                   # an absent candidate inside the list
    ids[1, 8:] = n + 100                     # out of range where masked: never gathered
    jr = JE.CrossEncoderReranker(p, jcfg, JCTX, jnp.asarray(docs))
    tr = TE.CrossEncoderReranker(model, tcfg, TCTX, torch.from_numpy(docs))
    want = jr.rerank(jnp.asarray(q), JTopK(jnp.asarray(scores), jnp.asarray(ids)), keep)
    got = tr.rerank(torch.from_numpy(q), TopK(torch.from_numpy(scores), torch.from_numpy(ids)), keep)
    assert got.scores.dtype == model.embed.dtype
    assert_ids_equal_off_near_ties(want, got, RTOL[dtype])
    assert_scores_close(want.scores, got.scores, RTOL[dtype])
    assert not np.isin(n + 100, got.indices.numpy())
    if dtype == "bfloat16":
        return
    # every pair scored once more alone, in the reranker's order
    full = TE.make_proxy_scorer(model, tcfg, TCTX, torch.from_numpy(docs))(
        torch.from_numpy(q), torch.from_numpy(np.where(np.isfinite(scores), ids, 0)))
    ref = np.where(np.isfinite(scores), _f64(full), -np.inf)
    order = np.argsort(-ref, axis=1, kind="stable")[:, :keep]
    np.testing.assert_array_equal(got.indices.numpy(), np.take_along_axis(ids, order, 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_contrastive_loss_matches_repro(arch):
    jcfg, tcfg, p, model = _setup(arch, "float32")
    rng = np.random.default_rng(5)
    q, d = _tokens(rng, (6, 8), jcfg.vocab_size), _tokens(rng, (6, 16), jcfg.vocab_size)
    d[:3] = q[:3, [0, 1, 2, 3, 4, 5, 6, 7] * 2]      # three positives that repeat their query
    want, wm = JE.contrastive_loss(p, jnp.asarray(q), jnp.asarray(d), jcfg, JCTX)
    with torch.no_grad():
        got, gm = TE.contrastive_loss(model, torch.from_numpy(q), torch.from_numpy(d), tcfg, TCTX)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(gm["contrastive"]), float(wm["contrastive"]), rtol=1e-5)
    assert float(gm["in_batch_acc"]) == float(wm["in_batch_acc"])
    assert gm["in_batch_acc"].dtype == torch.float32


def test_contrastive_loss_has_gradients():
    """The loss is differentiable through the port's parameters (the
    training step that will use it waits for the launch slice)."""
    _, tcfg, _, model = _setup("smollm-360m", "float32")
    q = torch.randint(0, tcfg.vocab_size, (4, 8), generator=torch.Generator().manual_seed(0))
    loss, _ = TE.contrastive_loss(model, q, q.flip(1), tcfg, TCTX)
    loss.backward()
    assert model.embed.grad is not None and bool(torch.isfinite(model.embed.grad).all())
    assert float(model.blocks[0].attn["wq"].grad.abs().sum()) > 0


# ---------------------------------------------------------------------------
# The cross-encoder as the funnel's rerank stage (tests/test_funnel.py's
# test_cross_encoder_reranker_is_a_funnel_stage, ported).
# ---------------------------------------------------------------------------

N, D, N_QUERIES, K_CAND, K_FUSE, K_SERVE = 64, 8, 12, 32, 16, 8
TINY = dict(name="tiny", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2, d_ff=32, vocab_size=31,
            dtype="float32", remat=False)


class IdBias:
    """The fusion stage of tests/test_funnel.py: candidate scores plus
    ``(id % 7) * scale``, re-ranked (torch)."""

    def __init__(self, scale):
        self.scale = scale

    def rerank(self, q_tokens, cands, keep):
        from repro_torch.core.pipeline import _masked, _reorder
        return _reorder(cands, _masked(cands, cands.scores + (cands.indices % 7).float() * self.scale), keep)


class JIdBias(IdBias):
    def rerank(self, q_tokens, cands, keep):
        s = cands.scores + (cands.indices % 7).astype(jnp.float32) * self.scale
        return jp._reorder(cands, jnp.where(jnp.isfinite(cands.scores), s, -jnp.inf), keep)


def test_cross_encoder_reranker_is_a_funnel_stage_as_in_repro():
    jcfg, tcfg = JConfig(**TINY), TransformerConfig(**TINY)
    p, _ = JT.init_transformer(jax.random.PRNGKey(0), jcfg)
    model = interop.transformer_params(jax.tree.map(np_of, p), tcfg, "cpu")
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((N, D)).astype(np.float32)
    queries = rng.standard_normal((N_QUERIES, D)).astype(np.float32)
    rng = np.random.default_rng(3)
    doc_tok = rng.integers(0, 31, size=(N, 6)).astype(np.int32)
    q_tok = rng.integers(0, 31, size=(N_QUERIES, 6)).astype(np.int32)
    widths = dict(cand_qty=K_CAND, fusion_qty=K_FUSE, rerank_keep=K_SERVE)

    ce = TE.CrossEncoderReranker(model, tcfg, TCTX, torch.from_numpy(doc_tok))
    gen = tp.BruteForceGenerator(DenseSpace("ip"), torch.from_numpy(corpus))
    funnel = FunnelPipeline(gen, fusion=IdBias(0.5), rerank=ce, **widths)
    tq, tt = torch.from_numpy(queries), torch.from_numpy(q_tok)
    got = funnel.run(tq, tt)
    offline = tp.apply_rerankers(gen.generate(tq, K_CAND), tt, intermediate=IdBias(0.5), final=ce,
                                 interm_qty=K_FUSE, final_qty=K_SERVE)
    assert torch.equal(got.indices, offline.indices)
    assert torch.equal(got.scores.view(torch.int32), offline.scores.view(torch.int32))
    assert got.indices.shape == (N_QUERIES, K_SERVE)

    jce = JE.CrossEncoderReranker(p, jcfg, JCTX, jnp.asarray(doc_tok))
    jfunnel = js.FunnelPipeline(jp.BruteForceGenerator(JDense("ip"), jnp.asarray(corpus)), fusion=JIdBias(0.5),
                                rerank=jce, **widths)
    want = jfunnel.run(jnp.asarray(queries), jnp.asarray(q_tok))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    assert_scores_close(want.scores, got.scores, RTOL["float32"])


def test_served_bf16_cross_encoder_funnel_equals_its_offline_batches():
    """Served through ``RetrievalService``, a bf16 cross-encoder's scores
    come back widened to f32 (numpy has no bf16; the widening is exact),
    every answer equal to its offline batch in ids and score bits."""
    from repro_torch.serving import EndpointSpec, RetrievalService
    from _torch_parity import FrozenClock, serve_in_order

    cfg = TransformerConfig(**dict(TINY, dtype="bfloat16"))
    model, _ = TT.init_transformer(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(6)
    corpus = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    queries = torch.from_numpy(rng.standard_normal((N_QUERIES, D)).astype(np.float32))
    doc_tok = torch.from_numpy(rng.integers(0, 31, size=(N, 6)).astype(np.int32))
    q_tok = torch.from_numpy(rng.integers(0, 31, size=(N_QUERIES, 6)).astype(np.int32))
    ce = TE.CrossEncoderReranker(model, cfg, TCTX, doc_tok)
    funnel = FunnelPipeline(tp.BruteForceGenerator(DenseSpace("ip"), corpus), rerank=ce,
                            cand_qty=K_CAND, fusion_qty=K_CAND, rerank_keep=K_SERVE)
    bs = 4
    clock = FrozenClock()
    with RetrievalService(cache_size=0, time_fn=clock) as svc:
        svc.register_pipeline("cross", funnel, torch.zeros(D), torch.zeros(6, dtype=torch.int32),
                              spec=EndpointSpec(batch_size=bs))
        rows = [f.result() for f in serve_in_order(svc, "cross", list(queries), clock, list(q_tok))]
        ep = svc.snapshot().endpoints["cross"]
    assert ep.stages["rerank"].count == ep.n_batches == N_QUERIES // bs
    for lo in range(0, N_QUERIES, bs):
        want = funnel.run(queries[lo:lo + bs], q_tok[lo:lo + bs])
        assert want.scores.dtype == torch.bfloat16
        for r in range(bs):
            got = rows[lo + r]
            assert got.scores.dtype == np.float32
            np.testing.assert_array_equal(got.indices, want.indices[r].numpy())
            np.testing.assert_array_equal(got.scores.view(np.int32), want.scores[r].float().numpy().view(np.int32))
