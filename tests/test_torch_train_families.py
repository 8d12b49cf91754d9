"""The port's train steps of the other families held against ``repro``'s
on the CPU, in f32: the MoE layer's gradient paths (``route``,
``sort_dispatch``, ``fill_buffers`` with its overflow row cut off, the
expert FFN, ``combine_buffers``) at a capacity that drops pairs; the four
recommendation kinds through ``bce_loss`` and ``make_recsys_train_step``
(dense table gradients, out-of-range ids that reach no row); SchNet's
molecules in batched form through ``schnet_loss`` and
``make_gnn_train_step``.

Tolerances are ``test_torch_train_step.py``'s (``TRAIN_TOL`` of each
leaf's scale; AdamW's parameters by ``assert_adamw_close``).  A gradient
that vanishes in exact arithmetic (DIN's attention-score bias, BST's key
bias: each shifts a softmax's logits alike) is rounding noise in both
packages; every gradient leaf is held against at least ``GRAD_FLOOR``
of the model's largest gradient (``_torch_parity.grad_floor``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jc
import repro_torch.configs as tc
from repro.distributed.sharding import ParallelCtx as JCtx
from repro.launch import steps as JST
from repro.models import moe as JM
from repro.models import recsys as JR
from repro.models import schnet as JS
from repro_torch import interop
from repro_torch.distributed.sharding import ParallelCtx
from repro_torch.launch import steps as TST
from repro_torch.models import moe as TM
from repro_torch.models import recsys as TR
from repro_torch.models import schnet as TS
from repro_torch.optim.optimizer import named_leaves

from _torch_parity import (GRAD_FLOOR, TRAIN_TOL, assert_adamw_close, assert_leaf_close, grad_floor, lm_configs,
                           lm_reference_params, np_of)

pytestmark = pytest.mark.torch


# ---------------------------------------------------------------------------
# The MoE layer's gradient paths.
# ---------------------------------------------------------------------------

def test_moe_layer_gradients_match_jax():
    """``moe_local`` (route, ``sort_dispatch``, ``fill_buffers`` with the
    overflow row cut off, the expert FFN, ``combine_buffers``): gradients
    of a weighted sum of its output plus the aux loss, with respect to the
    input, the router and every expert weight, at a capacity that drops
    pairs."""
    jcfg, tcfg = lm_configs("phi3.5-moe-42b-a6.6b", capacity_factor=0.5)
    p = lm_reference_params("phi3.5-moe-42b-a6.6b", "float32")
    jmoe = jax.tree.map(lambda a: a[0], p["blocks"]["moe"])
    rng = np.random.default_rng(4)
    x = rng.standard_normal((48, jcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((48, jcfg.d_model)).astype(np.float32)

    def jloss(mp, xx):
        y, aux = JM.moe_local(mp, xx, jcfg)
        return jnp.sum(y * w) + aux

    jl, (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(jmoe, jnp.asarray(x))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in jmoe.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = TM.moe_local(tp, tx, tcfg)
    tl = torch.sum(y * torch.from_numpy(w)) + aux
    tl.backward()
    assert_leaf_close(np.asarray(jl), tl, TRAIN_TOL, "loss")
    assert_leaf_close(np.asarray(jgx), tx.grad, TRAIN_TOL, "x")
    for k in jmoe:
        assert_leaf_close(np.asarray(jgp[k]), tp[k].grad, TRAIN_TOL, k)
    # some pairs were dropped at this capacity
    ids, _, _ = TM.route(tx.detach(), tp["wg"].detach(), tcfg.top_k)
    cap = TM._round_up(max(1, int(48 * tcfg.top_k / tcfg.n_experts * tcfg.capacity_factor)), 8)
    assert int(torch.bincount(ids.reshape(-1).long()).max()) > cap


# ---------------------------------------------------------------------------
# Recommendation and molecule families.
# ---------------------------------------------------------------------------

def assert_moments_close(want, got):
    """AdamW's moments after one step: ``m`` within ``TRAIN_TOL`` of its
    leaf's scale, ``v`` (a square of the gradient, whose relative error it
    doubles) within twice that; floored like the gradients (a vanishing
    gradient's moments are noise too)."""
    for field, tol, floor in (("m", TRAIN_TOL, grad_floor(want.m)),
                              ("v", 2 * TRAIN_TOL, grad_floor(want.v) * GRAD_FLOOR)):
        for k, v in getattr(want, field).items():
            assert_leaf_close(v.numpy(), getattr(got, field)[k], tol, f"{field} {k}", floor)


def recsys_batch_np(cfg, b=16, seed=0):
    """A training batch with pads in the multi-hot fields, one history all
    padding, and out-of-range ids (past the table and below -V), which
    send no gradient to any row."""
    rng = np.random.default_rng(seed)
    fields = {}
    for f in cfg.fields:
        if f.multi_hot > 1:
            x = rng.integers(0, f.vocab + 1, (b, f.multi_hot))
            x[1, ::2] = f.vocab
            x[2, 0] = f.vocab + 7
        else:
            x = rng.integers(0, f.vocab, b)
        fields[f.name] = x.astype(np.int32)
    hist = None
    if cfg.seq_len:
        hist = rng.integers(0, cfg.item_vocab + 1, (b, cfg.seq_len)).astype(np.int32)
        hist[0] = cfg.item_vocab
        hist[3, :2] = [cfg.item_vocab + 5, cfg.item_vocab + 1]
    return dict(fields=fields, history=hist, target_item=rng.integers(0, cfg.item_vocab, b).astype(np.int32),
                label=rng.integers(0, 2, b).astype(np.float32))


def recsys_batches(cfg, raw):
    def make(conv, mod):
        return mod.RecBatch({k: conv(v) for k, v in raw["fields"].items()},
                            None if raw["history"] is None else conv(raw["history"]),
                            conv(raw["target_item"]), conv(raw["label"]))

    return make(jnp.asarray, JR), make(torch.from_numpy, TR)


@pytest.mark.parametrize("arch", ["din", "dien", "bst", "wide-deep"])
def test_recsys_train_step_matches_repro(arch):
    """``bce_loss``'s gradients against ``jax.value_and_grad`` (dense table
    gradients; out-of-range ids touch no row), then one
    ``make_recsys_train_step`` step: loss, parameters and AdamW's moments."""
    jcfg, tcfg = jc.get_smoke_config(arch), tc.get_smoke_config(arch)
    p, _ = JR.init_recsys(jax.random.PRNGKey(0), jcfg)
    jb, tb = recsys_batches(jcfg, recsys_batch_np(jcfg))
    (jl, _), jg = jax.jit(jax.value_and_grad(lambda q, b: JR.bce_loss(q, jcfg, b, JCtx(None, {})),
                                             has_aux=True))(p, jb)
    model = interop.recsys_params(jax.tree.map(np_of, p), tcfg, "cpu")
    loss, _ = TR.bce_loss(model, tcfg, tb, ParallelCtx(None, {}))
    loss.backward()
    assert_leaf_close(np.asarray(jl), loss, TRAIN_TOL, "loss")
    want = named_leaves(interop.recsys_params(jax.tree.map(np_of, jg), tcfg, "cpu"))
    floor = grad_floor(want)
    for (k, g), (k2, prm) in zip(want.items(), named_leaves(model).items()):
        assert k == k2
        got = torch.zeros_like(prm) if prm.grad is None else prm.grad     # a table the kind never reads
        assert_leaf_close(g.detach().numpy(), got, TRAIN_TOL, k, floor)
    model.zero_grad()
    jstep, jopt = JST.make_recsys_train_step(jcfg, JCtx(None, {}), lr=1e-3)
    jp, js, jm = jax.jit(jstep)(p, jopt.init(p), jb)
    tstep, topt = TST.make_recsys_train_step(tcfg, ParallelCtx(None, {}), lr=1e-3)
    state = topt.init(model)
    _, _, tm = tstep(model, state, tb)
    assert_leaf_close(np.asarray(jm["loss"]), tm["loss"], TRAIN_TOL, "step loss")
    state_want = interop.adam_state(jax.tree.map(np_of, js), model, "cpu")
    assert_adamw_close(named_leaves(interop.recsys_params(jax.tree.map(np_of, jp), tcfg, "cpu")),
                       named_leaves(model), None, state_want, 1, 1e-3, "params", GRAD_FLOOR)
    assert_moments_close(state_want, state)


def test_out_of_range_ids_send_no_gradient():
    """``embedding_lookup``'s gradient is ``jnp.take``'s: the pad id, ids
    past the table and ids below -V add nothing to any row; an id in
    [-V, 0) reaches the row it wraps to."""
    table = torch.randn(5, 3, dtype=torch.float64, requires_grad=True)
    ids = torch.tensor([5, 9, -6, -8, 5])
    TR.embedding_lookup(table, ids).nan_to_num(0.0).sum().backward()
    assert torch.equal(table.grad, torch.zeros_like(table))
    table.grad = None
    TR.embedding_lookup(table, torch.tensor([-1, 2, 7])).sum().backward()
    want = torch.zeros(5, 3, dtype=torch.float64)
    want[4] = want[2] = 1.0
    assert torch.equal(table.grad, want)


def molecules_np(graphs=4, atoms=10, k=4, seed=0):
    rng = np.random.default_rng(seed)
    n, e = graphs * atoms, graphs * atoms * k
    senders = np.concatenate([g * atoms + rng.integers(0, atoms, atoms * k) for g in range(graphs)])
    receivers = np.concatenate([g * atoms + np.repeat(np.arange(atoms), k) for g in range(graphs)])
    mask = rng.uniform(size=e) > 0.1
    return dict(node_z=rng.integers(1, 10, n).astype(np.int32), senders=senders.astype(np.int32),
                receivers=receivers.astype(np.int32), distances=rng.uniform(0.8, 4.5, e).astype(np.float32),
                edge_mask=mask, graph_ids=np.repeat(np.arange(graphs), atoms).astype(np.int32),
                targets=rng.standard_normal(graphs).astype(np.float32))


def test_schnet_train_step_matches_repro():
    """SchNet on batched molecules (``segment_sum`` into nodes and into
    molecules, ``cfconv``): ``schnet_loss``'s gradients against
    ``jax.value_and_grad``, then one ``make_gnn_train_step`` step."""
    jcfg, tcfg = jc.get_smoke_config("schnet"), tc.get_smoke_config("schnet")
    p, _ = JS.init_schnet(jax.random.PRNGKey(1), jcfg)
    g = molecules_np()
    jb = JS.GraphBatch(**{k: jnp.asarray(v) for k, v in g.items()})
    tb = TS.GraphBatch(**{k: torch.from_numpy(v) for k, v in g.items()})
    (jl, _), jg = jax.jit(jax.value_and_grad(lambda q: JS.schnet_loss(q, jb, jcfg, JCtx(None, {}), 4),
                                             has_aux=True))(p)
    model = interop.schnet_params(jax.tree.map(np_of, p), tcfg, "cpu")
    loss, _ = TS.schnet_loss(model, tb, tcfg, ParallelCtx(None, {}), 4)
    loss.backward()
    assert_leaf_close(np.asarray(jl), loss, TRAIN_TOL, "loss")
    want = named_leaves(interop.schnet_params(jax.tree.map(np_of, jg), tcfg, "cpu"))
    floor = grad_floor(want)
    for (k, g), (k2, prm) in zip(want.items(), named_leaves(model).items()):
        assert k == k2
        assert_leaf_close(g.detach().numpy(), prm.grad, TRAIN_TOL, k, floor)
    model.zero_grad()
    jstep, jopt = JST.make_gnn_train_step(jcfg, JCtx(None, {}), lr=1e-3, n_graphs=4)
    jp, js, jm = jax.jit(jstep)(p, jopt.init(p), jb)
    tstep, topt = TST.make_gnn_train_step(tcfg, ParallelCtx(None, {}), lr=1e-3, n_graphs=4)
    state = topt.init(model)
    _, _, tm = tstep(model, state, tb)
    assert_leaf_close(np.asarray(jm["loss"]), tm["loss"], TRAIN_TOL, "step loss")
    state_want = interop.adam_state(jax.tree.map(np_of, js), model, "cpu")
    assert_adamw_close(named_leaves(interop.schnet_params(jax.tree.map(np_of, jp), tcfg, "cpu")),
                       named_leaves(model), None, state_want, 1, 1e-3, "params", GRAD_FLOOR)
    assert_moments_close(state_want, state)
