"""repro_torch.models.recsys held against repro.models.recsys on the CPU:
the EmbeddingBag substrate on ids at and past both ends of a table, the
user tower, logits and loss of all four kinds at their smoke configs (a
history that is all padding, multi-hot fields with pads), retrieval
scoring with planted ties, the init's shapes, axes and scales,
``interop.recsys_params``' refusals, and the served candidate funnel of
``examples/recsys_candidates.py`` against its offline batches.

Inputs are made once with numpy from a seed and fed to both packages; the
weights are ``repro``'s, carried by ``interop.recsys_params``.  Ids must
be equal; f32 values agree within ``F32_RTOL`` (2e-6) of the row's
largest |value| (the last axis; a batch of logits or a loss is one row):
the order of f32 sums and the last bits of ``exp``/``tanh``/``log1p``
differ between PyTorch's and XLA's CPU code.  NaN and zero rows of the
lookup must match exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.core import DenseSpace as JDense
from repro.core.pipeline import BruteForceGenerator as JGen, _reorder as j_reorder
from repro.distributed.sharding import ParallelCtx as JCtx
from repro.models import recsys as JR
from repro import serving as js
import repro_torch.configs as tc
from repro_torch import interop
from repro_torch.core.brute_force import exact_topk
from repro_torch.core.pipeline import BruteForceGenerator
from repro_torch.core.spaces import DenseSpace, FusedSpace, FusedVectors
from repro_torch.core.sparse import SparseVectors
from repro_torch.distributed.sharding import ParallelCtx
from repro_torch.models import recsys as TR
from repro_torch.serving import EndpointSpec, FunnelPipeline, RetrievalService, StageBudget

from _torch_parity import F32_RTOL, FrozenClock, np_of, serve_in_order

pytestmark = pytest.mark.torch

ARCHS = ["din", "dien", "bst", "wide-deep"]
JCTX, TCTX = JCtx(None, {}), ParallelCtx(None, {})


def assert_close(want, got, rtol=F32_RTOL, ctx=""):
    w = np.asarray(want, np.float64)
    g = (got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)).astype(np.float64)
    assert w.shape == g.shape, (w.shape, g.shape, ctx)
    assert np.all(np.isfinite(w)) and np.all(np.isfinite(g)), ctx
    w2, g2 = w.reshape(-1, w.shape[-1] if w.ndim else 1), g.reshape(-1, g.shape[-1] if g.ndim else 1)
    scale = np.maximum(np.abs(w2).max(axis=-1, keepdims=True), 1e-30)
    err = np.abs(g2 - w2)
    assert np.all(err <= rtol * scale), f"error {np.max(err / scale):.3g} of row scale > {rtol} {ctx}"


def model_pair(arch, seed=0):
    """(repro config, port config, repro params, the port's module)."""
    jcfg, tcfg = jc.get_smoke_config(arch), tc.get_smoke_config(arch)
    p, _ = JR.init_recsys(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, p, interop.recsys_params(jax.tree.map(np_of, p), tcfg, "cpu")


def batch_np(cfg, b=6, seed=0, n_cand=32):
    """``tests/test_models_smoke.py``'s batch, with row 0's history all
    padding, and pads in every multi-hot field's row 1."""
    rng = np.random.default_rng(seed)
    fields = {}
    for f in cfg.fields:
        if f.multi_hot > 1:
            x = rng.integers(0, f.vocab + 1, (b, f.multi_hot))
            x[1, ::2] = f.vocab
        else:
            x = rng.integers(0, f.vocab, b)
        fields[f.name] = x.astype(np.int32)
    hist = None
    if cfg.seq_len:
        hist = rng.integers(0, cfg.item_vocab + 1, (b, cfg.seq_len)).astype(np.int32)
        hist[0] = cfg.item_vocab
    return dict(fields=fields, history=hist,
                target_item=rng.integers(0, cfg.item_vocab, b).astype(np.int32),
                label=rng.integers(0, 2, b).astype(np.float32),
                candidates=rng.integers(0, cfg.item_vocab, (b, n_cand)).astype(np.int32))


def batches(cfg, **kw):
    raw = batch_np(cfg, **kw)
    conv = {"j": jnp.asarray, "t": torch.from_numpy}

    def make(lib, mod):
        c = conv[lib]
        return mod.RecBatch({k: c(v) for k, v in raw["fields"].items()},
                            None if raw["history"] is None else c(raw["history"]),
                            c(raw["target_item"]), c(raw["label"]), c(raw["candidates"]))

    return make("j", JR), make("t", TR)


# ---------------------------------------------------------------------------
# The EmbeddingBag substrate.
# ---------------------------------------------------------------------------

V, DIM = 5, 3
EDGE_IDS = np.array([-V - 1, -V, -1, 0, V - 1, V, V + 3], np.int32)


def _table():
    return np.arange(V * DIM, dtype=np.float32).reshape(V, DIM) + 1.0


def test_embedding_lookup_copies_jnp_take():
    """An id in [-V, 0) wraps, one below -V gives NaN, ids >= V give 0."""
    t = _table()
    want = np.asarray(JR.embedding_lookup(jnp.asarray(t), jnp.asarray(EDGE_IDS)))
    got = TR.embedding_lookup(torch.from_numpy(t), torch.from_numpy(EDGE_IDS)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert np.isnan(got[0]).all() and (got[1] == t[0]).all() and (got[2] == t[-1]).all()
    assert (got[5:] == 0).all()


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_repro(mode):
    t = _table()
    idx = np.stack([EDGE_IDS[1:], np.full(6, V, np.int32), np.array([0, 1, V, 2, V + 3, 4], np.int32),
                    np.array([-1, -V, 3, 3, 0, V], np.int32)])
    want = np.asarray(JR.embedding_bag(jnp.asarray(t), jnp.asarray(idx), mode))
    got = TR.embedding_bag(torch.from_numpy(t), torch.from_numpy(idx), mode)
    assert_close(want, got, ctx=mode)
    nan_row = np.asarray(JR.embedding_bag(jnp.asarray(t), jnp.asarray(EDGE_IDS[None]), mode))
    got_nan = TR.embedding_bag(torch.from_numpy(t), torch.from_numpy(EDGE_IDS[None]), mode).numpy()
    assert np.isnan(nan_row).all() and np.isnan(got_nan).all()


def test_embedding_bag_ragged_matches_repro():
    """Out-of-range bag ids (negative ones too) are dropped, as
    ``jax.ops.segment_sum`` drops them; an empty bag is zero."""
    t = _table()
    flat = np.array([0, 1, V, -1, 4, 2, -V, V + 3, 3], np.int32)
    bags = np.array([0, 0, 1, 1, 2, -1, 4, 2, 5], np.int32)
    want = np.asarray(JR.embedding_bag_ragged(jnp.asarray(t), jnp.asarray(flat), jnp.asarray(bags), 5))
    got = TR.embedding_bag_ragged(torch.from_numpy(t), torch.from_numpy(flat), torch.from_numpy(bags), 5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[3] == 0).all()


# ---------------------------------------------------------------------------
# Init: shapes, axes, scales.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_shapes_and_axes_match_repro(arch):
    jcfg, tcfg = jc.get_smoke_config(arch), tc.get_smoke_config(arch)
    shapes = jax.eval_shape(lambda k: JR.init_recsys(k, jcfg)[0], jax.random.PRNGKey(0))
    _, jaxes = JR.init_recsys(jax.random.PRNGKey(0), jcfg)
    model, axes = TR.init_recsys(tcfg, device="meta")
    assert axes == jaxes
    like = interop._like(model)
    flat_j = jax.tree_util.tree_leaves_with_path(shapes)
    flat_t = jax.tree_util.tree_leaves_with_path(like)
    assert [jax.tree_util.keystr(k) for k, _ in flat_j] == [jax.tree_util.keystr(k) for k, _ in flat_t]
    for (k, s), (_, t) in zip(flat_j, flat_t):
        assert tuple(s.shape) == tuple(t.shape) and t.dtype == torch.float32, jax.tree_util.keystr(k)


def test_full_din_shapes_on_meta():
    """The published DIN: 100M items, three field tables, 8.0 GB of f32 tables."""
    cfg = tc.get_config("din")
    model, _ = TR.init_recsys(cfg, device="meta")
    assert tuple(model.tables["item"].shape) == (100_000_000, 18)
    table_bytes = sum(t.numel() * 4 for t in model.tables.values())
    assert 7.9e9 < table_bytes < 8.1e9
    assert [tuple(l["w"].shape) for l in model.mlp] == [(90, 200), (200, 80), (80, 1)]
    assert [tuple(l["w"].shape) for l in model.att] == [(72, 80), (80, 40), (40, 1)]


@pytest.mark.parametrize("arch", ["bst", "wide-deep"])
def test_init_draws_at_reference_scales(arch):
    cfg = dataclasses.replace(tc.get_smoke_config(arch), item_vocab=20_000)
    model, _ = TR.init_recsys(cfg, seed=3, device="cpu")
    model.requires_grad_(False)
    item = model.tables["item"]
    assert abs(float(item.std()) - 0.01) < 5e-4 and abs(float(item.mean())) < 5e-4
    for layer in model.mlp:
        din = layer["w"].shape[0]
        assert abs(float(layer["w"].std()) * din ** 0.5 - 1.0) < 0.15
        assert not layer["b"].any()
    if arch == "wide-deep":
        assert not any(w.any() for w in model.wide.values())
    else:
        assert abs(float(model.pos.std()) - 0.01) < 3e-3
    again, _ = TR.init_recsys(cfg, seed=3, device="cpu")
    assert torch.equal(again.tables["item"], item)


def test_init_without_device_raises_off_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: None means the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TR.init_recsys(tc.get_smoke_config("din"))


# ---------------------------------------------------------------------------
# Forward passes.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["user_tower", "forward_logits"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_repro(arch, fn):
    jcfg, tcfg, p, model = model_pair(arch)
    jb, tb = batches(jcfg)
    want = getattr(JR, fn)(p, jcfg, jb, JCTX)
    with torch.no_grad():
        got = getattr(TR, fn)(model, tcfg, tb, TCTX)
        if fn == "forward_logits":
            assert torch.equal(model(tb), got)
    assert_close(want, got, ctx=f"{arch} {fn}")


@pytest.mark.parametrize("arch", ARCHS)
def test_bce_loss_matches_repro(arch):
    jcfg, tcfg, p, model = model_pair(arch, seed=1)
    jb, tb = batches(jcfg, seed=1)
    want, jm = JR.bce_loss(p, jcfg, jb, JCTX)
    with torch.no_grad():
        got, m = TR.bce_loss(model, tcfg, tb, TCTX)
    assert_close(np.float32(want), got.reshape(()), ctx=arch)
    assert set(m) == set(jm) == {"bce"} and got.dtype == torch.float32


def test_all_padding_history_attends_uniformly():
    """DIN's -1e9 mask: a history of pads only gives equal weights over
    zero rows, an interest of zeros (not NaN)."""
    jcfg, tcfg, p, model = model_pair("din")
    _, tb = batches(jcfg)
    with torch.no_grad():
        u = TR.user_tower(model, tcfg, tb, TCTX)
    d = tcfg.embed_dim
    interest = u[0, 3 * d:4 * d]
    assert torch.equal(interest, torch.zeros_like(interest))


def test_bst_pools_over_all_positions():
    """BST's pooled state is the mean over S + 1 positions, pads as zeros."""
    jcfg, tcfg, p, model = model_pair("bst")
    jb, tb = batches(jcfg)
    with torch.no_grad():
        u = TR.user_tower(model, tcfg, tb, TCTX)
    d, nf = tcfg.embed_dim, len(tcfg.fields)
    pooled = u[:, nf * d:(nf + 1) * d]
    assert_close(np.asarray(JR.user_tower(p, jcfg, jb, JCTX))[:, nf * d:(nf + 1) * d], pooled)


@pytest.mark.parametrize("arch", ARCHS)
def test_retrieval_scores_with_planted_ties(arch):
    """Candidates repeat item ids and item rows are duplicated, so the
    scores tie exactly; both packages keep the lower candidate position."""
    jcfg, tcfg, p, _ = model_pair(arch)
    p = jax.tree.map(np_of, p)
    item = np.array(p["tables"]["item"])
    item[1::2] = item[0::2][: len(item[1::2])]
    p["tables"]["item"] = item
    model = interop.recsys_params(p, tcfg, "cpu")
    raw = batch_np(jcfg, n_cand=40)
    cand = raw["candidates"]
    cand[:, 20:] = cand[:, :20]
    cand[:, 10:20] = cand[:, :10] ^ 1
    jb, tb = batches(jcfg)
    jb, tb = jb._replace(candidates=jnp.asarray(cand)), tb._replace(candidates=torch.from_numpy(cand))
    jp = jax.tree.map(jnp.asarray, p)
    ws, wi = JR.retrieval_scores(jp, jcfg, jb, JCTX, k=16)
    with torch.no_grad():
        gs, gi = TR.retrieval_scores(model, tcfg, tb, TCTX, k=16)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert_close(ws, gs, ctx=arch)
    assert gi.dtype == torch.int32 and (gs[:, :-1] >= gs[:, 1:]).all()


# ---------------------------------------------------------------------------
# interop.recsys_params refusals.
# ---------------------------------------------------------------------------

def _np_params(arch="din"):
    jcfg, tcfg = jc.get_smoke_config(arch), tc.get_smoke_config(arch)
    p, _ = JR.init_recsys(jax.random.PRNGKey(0), jcfg)
    return jax.tree.map(np_of, p), tcfg


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "dtype", "layers"])
def test_recsys_params_refuses(fault):
    p, cfg = _np_params()
    if fault == "missing":
        del p["tables"]["shop"]
    elif fault == "extra":
        p["wide"] = {}
    elif fault == "shape":
        p["mlp"][1]["w"] = p["mlp"][1]["w"][:, :-1]
    elif fault == "dtype":
        p["att"][0]["b"] = p["att"][0]["b"].astype(np.float64)
    else:
        p["att"] = p["att"][:-1]
    with pytest.raises(ValueError):
        interop.recsys_params(p, cfg, "cpu")


def test_recsys_params_carries_every_array():
    p, cfg = _np_params("dien")
    model = interop.recsys_params(p, cfg, "cpu")
    np.testing.assert_array_equal(model.gru1["uh"]["w"].detach().numpy(), p["gru1"]["uh"]["w"])
    np.testing.assert_array_equal(model.mlp[2]["b"].detach().numpy(), p["mlp"][2]["b"])
    assert sum(x.numel() for x in model.parameters()) == sum(a.size for a in jax.tree.leaves(p))


# ---------------------------------------------------------------------------
# The candidate-generation funnel of examples/recsys_candidates.py.
# ---------------------------------------------------------------------------

TAGS, N_USERS = 50, 12


def _din_funnel_inputs():
    """The example's inputs: DIN's user queries over all items, one tag an
    item and three a user, and the funnel payload (query ++ tags)."""
    jcfg, tcfg, p, model = model_pair("din")
    raw = batch_np(jcfg, b=N_USERS, n_cand=8)
    _, tb = batches(jcfg, b=N_USERS, n_cand=8)
    with torch.no_grad():
        uq = TR.user_query(model, tcfg, tb, TCTX)
    rng = np.random.default_rng(5)
    tag_of_item = rng.integers(0, TAGS, tcfg.item_vocab).astype(np.int32)
    user_tags = rng.integers(0, TAGS, (N_USERS, 3)).astype(np.int32)
    return jcfg, tcfg, p, model, raw, uq, tag_of_item, user_tags


def test_user_query_is_retrieval_projection():
    jcfg, tcfg, p, model, raw, uq, _, _ = _din_funnel_inputs()
    jb, _ = batches(jcfg, b=N_USERS, n_cand=8)
    want = JR.user_tower(p, jcfg, jb, JCTX) @ p["mlp"][0]["w"][:, :jcfg.embed_dim]
    assert_close(want, uq)


def test_fused_tag_space_ranks_as_repro():
    """Step 3 of the example: the fused space over items with one tag each
    (``FusedSpace(50, 1.0, 0.5)``), ids equal to repro's exact_topk."""
    from repro.core import FusedSpace as JF, FusedVectors as JFV, exact_topk as jexact
    from repro.core.sparse import SparseVectors as JSV

    _, tcfg, p, model, _, uq, tag_of_item, user_tags = _din_funnel_inputs()
    item = model.tables["item"].detach()
    n = item.shape[0]
    items = FusedVectors(item, SparseVectors(torch.from_numpy(tag_of_item[:, None]), torch.ones(n, 1)))
    users = FusedVectors(uq, SparseVectors(torch.from_numpy(user_tags), torch.ones(N_USERS, 3)))
    got = exact_topk(FusedSpace(TAGS, 1.0, 0.5), users, items, 20)
    want = jexact(JF(TAGS, w_dense=1.0, w_sparse=0.5),
                  JFV(jnp.asarray(uq.numpy()), JSV(jnp.asarray(user_tags), jnp.ones((N_USERS, 3)))),
                  JFV(jnp.asarray(item.numpy()), JSV(jnp.asarray(tag_of_item[:, None]), jnp.ones((n, 1)))), 20)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    assert_close(want.scores, got.scores)


class _JTagFusion:
    def __init__(self, tag_of_item, d):
        self.tag_of_item, self.d = jnp.asarray(tag_of_item), d

    def rerank(self, q_tokens, cands, keep):
        tags = q_tokens[:, self.d:].astype(jnp.int32)
        bias = 0.5 * (self.tag_of_item[cands.indices] == tags[:, :1]).astype(jnp.float32)
        return j_reorder(cands, jnp.where(jnp.isfinite(cands.scores), cands.scores + bias, -jnp.inf), keep)


class _JExactRescore:
    def __init__(self, table, d):
        self.table, self.d = table, d

    def rerank(self, q_tokens, cands, keep):
        scores = jnp.einsum("bd,bcd->bc", q_tokens[:, :self.d], self.table[cands.indices])
        return j_reorder(cands, jnp.where(jnp.isfinite(cands.scores), scores, -jnp.inf), keep)


def test_din_funnel_served_equals_offline_and_repro():
    """bf16 candidate generation, tag fusion, exact f32 rescore on one
    endpoint: every served answer equals its offline batch bit for bit;
    the offline funnel's ids equal repro's."""
    _, tcfg, p, model, _, uq, tag_of_item, user_tags = _din_funnel_inputs()
    d = tcfg.embed_dim
    item = model.tables["item"].detach()
    payload = torch.cat([uq, torch.from_numpy(user_tags).float()], dim=1)
    widths = dict(cand_qty=50, fusion_qty=30, rerank_keep=20)
    funnel = FunnelPipeline(BruteForceGenerator(DenseSpace("ip"), item, backend="cuda"),
                            fusion=TR.TagFusion(torch.from_numpy(tag_of_item), d),
                            rerank=TR.ExactRescore(item, d), **widths)
    spec = EndpointSpec(batch_size=4, max_wait_s=0.005, corpus_dtype="bfloat16",
                        budget=StageBudget(rerank_s=5.0))
    clock = FrozenClock()
    with RetrievalService(cache_size=0, time_fn=clock) as svc:
        svc.register_pipeline("recs", funnel, uq[0], payload[0], spec=spec)
        futs = serve_in_order(svc, "recs", list(uq), clock, q_tokens=list(payload))
        rows = [f.result() for f in futs]
        ep = svc.snapshot().endpoints["recs"]
    assert ep.stage_fallbacks["rerank"] == 0 and ep.corpus_dtype == "bfloat16"
    offline = funnel.with_corpus_dtype("bfloat16")
    want = [offline.run(uq[lo:lo + 4], payload[lo:lo + 4]) for lo in range(0, N_USERS, 4)]
    for i, row in enumerate(rows):
        w = want[i // 4]
        assert np.array_equal(row.indices, w.indices[i % 4].numpy())
        assert np.array_equal(np.asarray(row.scores).view(np.int32), w.scores[i % 4].numpy().view(np.int32))
    jtable = jnp.asarray(item.numpy())
    jf = js.FunnelPipeline(JGen(JDense("ip"), jtable.astype(jnp.bfloat16)),
                           fusion=_JTagFusion(tag_of_item, d), rerank=_JExactRescore(jtable, d), **widths)
    jwant = jf.run(jnp.asarray(uq.numpy()), jnp.asarray(payload.numpy()))
    got = offline.run(uq, payload)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(jwant.indices))
    assert_close(jwant.scores, got.scores)
