"""The recommendation and molecule models under a mesh: 8 gloo ranks on a
("data", "model") = (2, 4) mesh run the port's per-rank code, and every
rank's results are held against ``repro`` under the same rules on 8
forced host devices (``tests/_torch_mesh_ref.py``; parameters placed by
``params_sharding``) and against the port's one-device run, on the same
numpy weights.

Recommendation (``DEFAULT_RECSYS_RULES``): DIN, DIEN, BST and wide-deep
at their smoke configs with the item table (65,540 rows: JAX places only
a split that divides) and one field's table past the reference's
65,536-row threshold, so that they are row-sharded over "model"
(``"table_rows"``).  Held: ``user_tower``,
``forward_logits``, ``bce_loss`` and the gradient of every leaf on a
batch whose ids include -V (wraps: the last shard's row), -1 and V (the
pad: a zero row); ``forward_logits`` of a batch with an id at -V - 1 (a
NaN row, in that row only); and, under ``rules_for_shape``'s retrieval
rules, ``retrieval_scores`` over 512 candidates split over ("data",
"model"): the top-16 ids equal and their scores within tolerance.

SchNet (``DEFAULT_GNN_RULES``: edges over every axis): ``schnet_apply``,
``schnet_loss`` and its gradients, and one ``make_gnn_train_step`` step,
on a padded graph with out-of-range sender and receiver ids.

Tolerance: ``TRAIN_TOL`` (1e-5 of a leaf's largest |value|; a gradient
that vanishes in exact arithmetic against ``GRAD_FLOOR`` of the model's
largest), AdamW's
step with ``assert_adamw_close`` (the one-device step's moments), as in
``test_torch_train_step.py``.  The ranks run once for the module; this
module imports no JAX at the top: each rank imports it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import GRAD_FLOOR, TRAIN_TOL, ReproMesh, assert_adamw_close, assert_leaf_close, run_ranks

pytestmark = pytest.mark.torch

BIG = 65540
RECSYS = {   # name: (arch, the field whose table is row-sharded, config fields replaced)
    "din": ("din", "user", dict(item_vocab=BIG)),
    "dien": ("dien", "user", dict(item_vocab=BIG)),
    "bst": ("bst", "user", dict(item_vocab=BIG)),
    "wide-deep": ("wide-deep", "f0", {}),
}
B, N_CAND, K = 8, 512, 16
N_GRAPHS = 3


def _fields(arch, big_field):
    import repro_torch.configs as tc

    return [(f.name, BIG if f.name == big_field else f.vocab, f.multi_hot) for f in tc.get_smoke_config(arch).fields]


def _recsys_cfg(name):
    import repro_torch.configs as tc
    from repro_torch.configs.base import FieldSpec

    arch, big, kw = RECSYS[name]
    return dataclasses.replace(tc.get_smoke_config(arch), fields=tuple(FieldSpec(*f) for f in _fields(arch, big)),
                               **kw)


def _schnet_cfg():
    import repro_torch.configs as tc

    return tc.get_smoke_config("schnet")


def _batch_np(cfg, b, seed, n_cand=N_CAND):
    """Random ids with, in a batch of 8, the edge cases: in every field -V
    (wraps), -1 and V (a bag's pad); the history's pads, a whole row of
    them, and -V."""
    rng = np.random.default_rng(seed)
    edges = b >= 8
    fields = {}
    for f in cfg.fields:
        x = rng.integers(0, f.vocab, (b, f.multi_hot) if f.multi_hot > 1 else b).astype(np.int32)
        if not edges:
            pass
        elif f.multi_hot > 1:
            x[1, ::2] = f.vocab
            x[2, 0], x[3, 1] = -f.vocab, -1
        else:
            x[2], x[3] = -f.vocab, -1
        fields[f.name] = x
    hist = None
    iv = cfg.item_vocab
    if cfg.seq_len:
        hist = rng.integers(0, iv, (b, cfg.seq_len)).astype(np.int32)
        if edges:
            hist[0] = iv
            hist[1, :3] = [-iv, -1, iv]
    target = rng.integers(0, max(iv, 1), b).astype(np.int32)
    if iv and edges:
        target[4] = -iv
    return dict(fields=fields, history=hist, target_item=target,
                label=rng.integers(0, 2, b).astype(np.float32),
                candidates=rng.integers(0, max(iv, 1), (b, n_cand)).astype(np.int32))


def _recsys_inputs(name, seed=0):
    import jax

    import repro.configs as jc
    from _torch_parity import np_of
    from repro.configs.base import FieldSpec
    from repro.models import recsys as JR

    arch, big, kw = RECSYS[name]
    fields = _fields(arch, big)
    jcfg = dataclasses.replace(jc.get_smoke_config(arch), fields=tuple(FieldSpec(*f) for f in fields), **kw)
    params, _ = JR.init_recsys(jax.random.PRNGKey(seed), jcfg)
    # non-zero wide tables and biases, so that their gradients and values count
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(np_of(a)) + (0.01 * np.random.default_rng(len(str(path))).standard_normal(
            a.shape).astype(np.float32) if path[-1].key in ("b",) or (len(path) > 1 and path[0].key == "wide")
            else 0.0), params)
    cfg = _recsys_cfg(name)
    batch = _batch_np(cfg, B, seed)
    nan = _batch_np(cfg, B, seed + 1)
    first = cfg.fields[0]
    nan["fields"][first.name][(5, 0) if first.multi_hot > 1 else 5] = -first.vocab - 1
    ret = _batch_np(cfg, 2, seed + 2)
    return dict(kind="recsys", arch=arch, fields=fields, kw=kw, params=params, batch=batch, nan_batch=nan,
                ret_batch=ret, k=K)


def _graph_np(n=24, e=80, seed=0):
    rng = np.random.default_rng(seed)
    g = dict(node_z=rng.integers(1, 100, n).astype(np.int32),
             senders=rng.integers(0, n, e).astype(np.int32),
             receivers=rng.integers(0, n, e).astype(np.int32),
             distances=rng.uniform(0.5, 9.5, e).astype(np.float32),
             edge_mask=rng.uniform(size=e) > 0.15,
             graph_ids=np.sort(rng.integers(0, N_GRAPHS, n)).astype(np.int32),
             targets=rng.normal(size=N_GRAPHS).astype(np.float32))
    g["senders"][:2] = [n + 3, -2]
    g["receivers"][2:4] = [n, -1]
    return g


def _schnet_inputs(seed=0):
    import jax

    import repro.configs as jc
    from _torch_parity import np_of
    from repro.models import schnet as JS

    params, _ = JS.init_schnet(jax.random.PRNGKey(seed), jc.get_smoke_config("schnet"))
    return dict(kind="schnet", kw={}, params=jax.tree.map(np_of, params), graph=_graph_np(seed=seed),
                n_graphs=N_GRAPHS)


def _rec(raw):
    from repro_torch.models import recsys as R

    t = torch.from_numpy
    return R.RecBatch({k: t(v) for k, v in raw["fields"].items()},
                      None if raw["history"] is None else t(raw["history"]), t(raw["target_item"]),
                      t(raw["label"]), t(raw["candidates"]))


def _whole(x):
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import NamedSharding

    if isinstance(x, DTensor):
        x = C.gather_full(x.to_local().detach(), NamedSharding.of(x), x.shape)
    return x.detach().numpy().copy()     # a replicated block is the live tensor: copy it


def _run_recsys(name, c, mesh):
    """Every quantity the tests hold of a recommendation case; ``mesh``
    None runs on one device."""
    from repro_torch import interop
    from repro_torch.configs.base import RecSysShape
    from repro_torch.distributed.sharding import ParallelCtx
    from repro_torch.launch.steps import rules_for_shape
    from repro_torch.models import recsys as R

    cfg = _recsys_cfg(name)
    ctx = ParallelCtx(mesh, dict(cfg.rules))
    model = interop.recsys_params(c["params"], cfg, "cpu", ctx=ctx)
    batch = _rec(c["batch"])
    r = {"tower": _whole(R.user_tower(model, cfg, batch, ctx)),
         "logits": _whole(R.forward_logits(model, cfg, batch, ctx))}
    leaves = dict(model.named_parameters())
    loss, _ = R.bce_loss(model, cfg, batch, ctx)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)   # wide-deep reads no item table
    r["loss"] = float(loss)
    r["grads"] = {k: _whole(torch.zeros_like(p) if g is None else g) for (k, p), g in zip(leaves.items(), grads)}
    with torch.no_grad():
        r["nan_logits"] = _whole(R.forward_logits(model, cfg, _rec(c["nan_batch"]), ctx))
        if cfg.item_vocab:
            rrules = rules_for_shape(cfg, RecSysShape("retrieval_cand", 1, kind="retrieval"), mesh)
            rcfg = dataclasses.replace(cfg, rules=rrules)
            rctx = ParallelCtx(mesh, rrules)
            rmodel = interop.recsys_params(c["params"], rcfg, "cpu", ctx=rctx)
            vals, ids = R.retrieval_scores(rmodel, rcfg, _rec(c["ret_batch"]), rctx, k=c["k"])
            r["ret_vals"], r["ret_ids"] = _whole(vals), _whole(ids)
    if mesh is not None:
        item = model.tables["item"] if "item" in model.tables else None
        r["local_rows"] = None if item is None else tuple(item.to_local().shape)
    return r


def _run_schnet(c, mesh):
    from repro_torch import interop
    from repro_torch.distributed.sharding import ParallelCtx
    from repro_torch.launch.steps import make_gnn_train_step
    from repro_torch.models import schnet as S

    cfg = _schnet_cfg()
    ctx = ParallelCtx(mesh, dict(cfg.rules))
    model = interop.schnet_params(c["params"], cfg, "cpu", ctx=ctx)
    g = S.GraphBatch(**{k: torch.from_numpy(v) for k, v in c["graph"].items()})
    r = {"apply": _whole(S.schnet_apply(model, g, cfg, ctx))}
    leaves = dict(model.named_parameters())
    loss, _ = S.schnet_loss(model, g, cfg, ctx, c["n_graphs"])
    grads = torch.autograd.grad(loss, list(leaves.values()))
    r["loss"], r["grads"] = float(loss), {k: _whole(v) for k, v in zip(leaves, grads)}
    step, opt = make_gnn_train_step(cfg, ctx, n_graphs=c["n_graphs"])
    st = opt.init(model)
    _, _, m = step(model, st, g)
    r["step_loss"] = float(m["loss"])
    r["step_params"] = {k: _whole(p) for k, p in model.named_parameters()}
    r["step_m"] = {k: _whole(v) for k, v in st.m.items()}
    r["step_v"] = {k: _whole(v) for k, v in st.v.items()}
    return r


def _mesh_body(rank, world, cases):
    from repro_torch.distributed.mesh_utils import make_mesh

    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    return {name: (_run_schnet(c, mesh) if c["kind"] == "schnet" else _run_recsys(name, c, mesh))
            for name, c in cases.items()}


CASES = list(RECSYS) + ["schnet"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_models")
    cases = {name: _recsys_inputs(name) for name in RECSYS}
    cases["schnet"] = _schnet_inputs()
    ref = ReproMesh("models_reference", tmp, cases)
    ranks = run_ranks(_mesh_body, 8, tmp, cases, timeout=240.0)
    one = {name: (_run_schnet(c, None) if c["kind"] == "schnet" else _run_recsys(name, c, None))
           for name, c in cases.items()}
    return {"ranks": ranks, "repro": ref.result(), "one": one, "cases": cases}


def _port_names(tree, name):
    """``repro``'s tree of a model's shape as the port's ``{name: array}``."""
    from repro_torch import interop

    if name == "schnet":
        m = interop.schnet_params(tree, _schnet_cfg(), "cpu")
    else:
        m = interop.recsys_params(tree, _recsys_cfg(name), "cpu")
    return {k: v.detach().numpy() for k, v in m.named_parameters()}


REFS = ("repro", "one device")


def _want(runs, name, ref):
    if ref == "one device":
        return runs["one"][name]
    w = dict(runs["repro"][name])
    w["grads"] = _port_names(w["grads"], name)
    return w


def _close(want, got, ctx, floor=0.0):
    assert_leaf_close(want, torch.from_numpy(np.asarray(got)), TRAIN_TOL, ctx, floor)


def _floor(grads):
    """A gradient that vanishes in exact arithmetic (a bias in front of a
    softmax) is held against ``GRAD_FLOOR`` of the model's largest."""
    return GRAD_FLOOR * max(float(np.abs(g).max()) for g in grads.values())


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("name", list(RECSYS))
def test_recsys_forward_under_a_mesh(runs, name, ref):
    want = _want(runs, name, ref)
    for rank, r in enumerate(runs["ranks"]):
        _close(want["tower"], r[name]["tower"], f"{name} rank {rank} tower vs {ref}")
        _close(want["logits"], r[name]["logits"], f"{name} rank {rank} logits vs {ref}")


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("name", list(RECSYS))
def test_recsys_loss_and_every_gradient_under_a_mesh(runs, name, ref):
    want = _want(runs, name, ref)
    for rank, r in enumerate(runs["ranks"]):
        np.testing.assert_allclose(r[name]["loss"], want["loss"], rtol=TRAIN_TOL)
        assert list(r[name]["grads"]) == list(want["grads"])
        floor = _floor(want["grads"])
        for k, g in want["grads"].items():
            _close(g, r[name]["grads"][k], f"{name} rank {rank} d{k} vs {ref}", floor)


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("name", list(RECSYS))
def test_recsys_id_below_minus_v_is_a_nan_row_under_a_mesh(runs, name, ref):
    want = _want(runs, name, ref)["nan_logits"]
    assert np.isnan(want[5]) and np.isfinite(np.delete(want, 5)).all()
    for rank, r in enumerate(runs["ranks"]):
        got = r[name]["nan_logits"]
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        _close(np.delete(want, 5), np.delete(got, 5), f"{name} rank {rank} vs {ref}")


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("name", [n for n in RECSYS if RECSYS[n][0] != "wide-deep"])
def test_retrieval_scores_under_the_retrieval_rules(runs, name, ref):
    want = _want(runs, name, ref)
    for rank, r in enumerate(runs["ranks"]):
        np.testing.assert_array_equal(r[name]["ret_ids"], want["ret_ids"])
        _close(want["ret_vals"], r[name]["ret_vals"], f"{name} rank {rank} scores vs {ref}")


@pytest.mark.parametrize("name", [n for n in RECSYS if RECSYS[n][0] != "wide-deep"])
def test_item_table_rows_split_over_model(runs, name):
    """The item table's rows split over the 4 "model" ranks."""
    rows = _recsys_cfg(name).item_vocab
    per = -(-rows // 4)
    for rank, r in enumerate(runs["ranks"]):
        model_rank = rank % 4
        want = min(per, rows - per * model_rank)
        assert r[name]["local_rows"][0] == want


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("what", ["apply", "loss", "grads"])
def test_schnet_under_a_mesh(runs, what, ref):
    want = _want(runs, "schnet", ref)
    for rank, r in enumerate(runs["ranks"]):
        r = r["schnet"]
        if what == "loss":
            np.testing.assert_allclose(r["loss"], want["loss"], rtol=TRAIN_TOL)
        elif what == "apply":
            _close(want["apply"], r["apply"], f"rank {rank} apply vs {ref}")
        else:
            for k, g in want["grads"].items():
                _close(g, r["grads"][k], f"rank {rank} d{k} vs {ref}", _floor(want["grads"]))


@pytest.mark.parametrize("ref", REFS)
def test_schnet_train_step_under_a_mesh(runs, ref):
    """One AdamW step: the loss, and the parameters within AdamW's bound
    from the one-device step's moments."""
    from types import SimpleNamespace

    one = runs["one"]["schnet"]
    want = one if ref == "one device" else dict(runs["repro"]["schnet"],
                                                step_params=_port_names(runs["repro"]["schnet"]["step_params"],
                                                                        "schnet"))
    moments = SimpleNamespace(m={k: torch.from_numpy(v) for k, v in one["step_m"].items()},
                              v={k: torch.from_numpy(v) for k, v in one["step_v"].items()})
    wp = {k: torch.from_numpy(np.asarray(v)) for k, v in want["step_params"].items()}
    for rank, r in enumerate(runs["ranks"]):
        r = r["schnet"]
        np.testing.assert_allclose(r["step_loss"], want["step_loss"], rtol=TRAIN_TOL)
        assert_adamw_close(wp, {k: torch.from_numpy(v) for k, v in r["step_params"].items()}, None, moments, 1,
                           1e-3, f"rank {rank} vs {ref}")
