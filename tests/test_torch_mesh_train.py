"""Training under a mesh: 8 gloo ranks on a ("data", "model") = (2, 4)
mesh run ``make_lm_train_step`` over ``DTensor`` parameters placed by
``params_sharding``, held against ``repro``'s jitted step on 8 forced
host devices (its state placed as ``_lm_cell`` places it, ZeRO's plan
included) and against the port's one-device step, on the same numpy
weights:

* qwen2.5-3b with AdamW, no ZeRO, clipping active (the first step's
  global norm is above the clip);
* minicpm3-4b (MLA, 6 heads padded to 8, vocabulary 500 padded to 512)
  with Adafactor, ``grad_accum`` 4 and ZeRO-1;
* phi3.5-moe as configured (Adafactor, ``grad_accum`` 4, ZeRO-1, experts
  over "model"), against ``repro``'s mesh step only: under a mesh the
  balance loss is the mean of each rank's (``repro``'s ``pmean`` in its
  ``shard_map``), which one device does not compute
  (``test_torch_mesh_lm.py`` holds phi's gradients without it).

Each runs two steps from the initial state, and one step from
``repro``'s state after its first step, carried onto the mesh by
``interop.transformer_params(..., ctx=)`` and ``interop.mesh_opt_state``
(the ZeRO-placed state too).  Under ZeRO every rank's state block is
1/data of its leaf on the dim ``zero_axes_of`` picks.  ``train_lm`` over
the mesh (qwen2.5-3b under its own rules, here with Adafactor, whose
update is smooth in the gradient), from the carried weights (both sides'
``init_transformer`` patched to return them), against ``repro``'s
``train_lm`` over its mesh and against the port's one-device run: losses
and parameters of an unbroken run, of a resume from the checkpoint saved
at step 2 (and the last checkpoint restored into a fresh model bit for
bit), and of a run whose third step raises once (restart from the
checkpoint), each against the same run of each reference.  The rule
functions
(``rules_for_shape``, ``_fit_batch_rule``, ``zero_axes_of``,
``_opt_axes_safe``) equal ``repro``'s for every config on two meshes.

Tolerances are ``test_torch_train_step.py``'s: ``TRAIN_TOL`` of each
leaf's scale, AdamW's parameters with ``assert_adamw_close``.  The ranks
run twice for the module: from the initial weights while ``repro`` runs,
then the carried step from ``repro``'s state; each test asserts its own
case.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from _torch_parity import (TRAIN_TOL, ReproMesh, assert_leaf_close, assert_step_close, run_ranks)

pytestmark = pytest.mark.torch

PAD = dict(n_heads=6, n_kv_heads=6, pad_heads_to=8, vocab_size=500, pad_vocab_to=512)
CASES = {   # name: (arch, config fields replaced)
    "qwen2.5-3b adamw": ("qwen2.5-3b", {}),
    "minicpm3-4b adafactor zero accum4": ("minicpm3-4b", dict(PAD, optimizer="adafactor", zero_sharding=True,
                                                              grad_accum=4)),
    "phi3.5-moe zero accum4": ("phi3.5-moe-42b-a6.6b", {}),
}
ONE_DEVICE = ("qwen2.5-3b adamw", "minicpm3-4b adafactor zero accum4")
LR = 1e-3
B, S = 8, 64
TRAIN_ARCH, TRAIN_CFG = "qwen2.5-3b", dict(optimizer="adafactor")   # train_lm's model
TRAIN_STEPS = 4
TRAIN_LR = 3e-4     # train_lm's default, passed to both sides
# qwen's key bias shifts each query's logits alike, so its gradient vanishes in exact
# arithmetic and Adafactor turns rounding noise into an update whose RMS over the
# stacked leaf its clip (clip_thr = 1) holds to lr: after n steps two correct runs'
# key biases differ by an RMS of at most 2 n lr.  That leaf is held to this bound,
# every other to TRAIN_TOL.
NOISE_LEAF = "attn.bk"


def _cfg(name):
    import repro_torch.configs as tc

    arch, kw = CASES[name]
    return dataclasses.replace(tc.get_smoke_config(arch), **kw)


def _inputs(name, seed=0):
    import jax

    import repro.configs as jc
    from _torch_parity import lm_params, np_of

    arch, kw = CASES[name]
    jcfg = dataclasses.replace(jc.get_smoke_config(arch), **kw)
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(2):
        tok = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
        batches.append({"tokens": tok, "targets": np.roll(tok, -1, 1)})
    return dict(arch=arch, kw=kw, params=jax.tree.map(np_of, lm_params(jcfg, seed)), batches=batches, lr=LR)


def _train_lm_case(seed=0):
    import jax

    import repro.configs as jc
    from _torch_parity import lm_params, np_of

    jcfg = dataclasses.replace(jc.get_smoke_config(TRAIN_ARCH), **TRAIN_CFG)
    return dict(arch=TRAIN_ARCH, kw=TRAIN_CFG, params=jax.tree.map(np_of, lm_params(jcfg, seed)),
                steps=TRAIN_STEPS, batch_size=B, seq_len=S, lr=TRAIN_LR)


def _train_cfg():
    import repro_torch.configs as tc

    return dataclasses.replace(tc.get_smoke_config(TRAIN_ARCH), **TRAIN_CFG)


def _whole(x):
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import NamedSharding

    if isinstance(x, DTensor):
        x = C.gather_full(x.to_local().detach(), NamedSharding.of(x), x.shape)
    return x.detach().numpy().copy()     # a replicated block is the live tensor: copy it


def _state(st):
    return {f: ({k: _whole(v) for k, v in getattr(st, f).items()} if f != "step" else int(st.step))
            for f in st._fields}


def _steps(step, model, st, batches):
    out = {"losses": [], "params": [], "states": []}
    for b in batches:
        _, _, m = step(model, st, {k: torch.from_numpy(v) for k, v in b.items()})
        out["losses"].append(float(m["loss"]))
        out["params"].append({k: _whole(p) for k, p in model.named_parameters()})
        out["states"].append(_state(st))
    return out


def _mesh_step(name, c, mesh):
    from repro_torch.distributed.sharding import ParallelCtx
    from repro_torch.launch.steps import make_lm_train_step
    from repro_torch.models import transformer as T

    cfg = _cfg(name)
    ctx = ParallelCtx(mesh, dict(cfg.rules))
    _, axes = T.init_transformer(cfg, device="meta")
    return cfg, ctx, make_lm_train_step(cfg, ctx, lr=c["lr"], params_axes=axes)


def _train_body(rank, world, cases, train_case, ckpt_root):
    """Two steps of each case from its initial weights, and the train_lm runs."""
    from repro_torch import interop
    from repro_torch.distributed.mesh_utils import make_mesh

    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    out = {}
    for name, c in cases.items():
        cfg, ctx, (step, opt) = _mesh_step(name, c, mesh)
        model = interop.transformer_params(c["params"], cfg, "cpu", ctx=ctx)
        st = opt.init(model)
        r = _steps(step, model, st, c["batches"])
        upd = step.mesh_update(model)
        r["zero"] = {u.key: (u.zdim, tuple(u.shape),
                             {f: (tuple(getattr(st, f)[u.key].shape), tuple(getattr(st, f)[u.key].to_local().shape))
                              for f in st._fields[1:]})
                     for u in upd.units if u.zdim is not None}
        out[name] = r
    out["train_lm"] = _train_lm_runs(mesh, ckpt_root, train_case["params"])
    return out


def _carried_body(rank, world, cases, carried):
    """One step of each case from ``repro``'s parameters and state after its
    first step, carried onto the mesh by ``interop``."""
    from repro_torch import interop
    from repro_torch.distributed.mesh_utils import make_mesh

    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    out = {}
    for name, c in cases.items():
        cfg, ctx, (step, _) = _mesh_step(name, c, mesh)
        p1, s1 = carried[name]
        model = interop.transformer_params(p1, cfg, "cpu", ctx=ctx)
        st = interop.mesh_opt_state(s1, step.mesh_update(model), "cpu")
        out[name] = _steps(step, model, st, c["batches"][1:])
    return out


def _train_lm_runs(mesh, root, params):
    """train_lm from the carried weights ``params``: 4 steps with a
    checkpoint every 2; 2 steps, then a resumed run to 4; a run whose third
    step raises once (restarting from the checkpoint at step 2); the model
    restored from the last checkpoint."""
    from repro_torch import interop
    from repro_torch.models import transformer as T

    init = T.init_transformer

    def carried(cfg, seed=0, device=None):
        T.init_transformer = init      # interop builds the model through it
        try:
            return interop.transformer_params(params, cfg, device), init(cfg, device="meta")[1]
        finally:
            T.init_transformer = carried

    T.init_transformer = carried
    try:
        return _train_lm_calls(mesh, root, init)
    finally:
        T.init_transformer = init


def _train_lm_calls(mesh, root, init):
    import repro_torch.launch.train as TR
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.sharding import ParallelCtx, distribute_module

    cfg = _train_cfg()
    kw = dict(batch_size=B, seq_len=S, ckpt_interval=2, lr=TRAIN_LR, device="cpu")
    r = {}
    m, r["losses"] = TR.train_lm(cfg, mesh, TRAIN_STEPS, os.path.join(root, "a"), **kw)
    r["params"] = {k: _whole(p) for k, p in m.named_parameters()}
    m, first = TR.train_lm(cfg, mesh, 2, os.path.join(root, "b"), **kw)
    r["at2"] = {k: _whole(p) for k, p in m.named_parameters()}
    m, rest = TR.train_lm(cfg, mesh, TRAIN_STEPS, os.path.join(root, "b"), **kw)
    r["resumed_losses"] = first + rest
    r["resumed_params"] = {k: _whole(p) for k, p in m.named_parameters()}
    fresh, axes = init(cfg, seed=1, device="cpu")
    distribute_module(fresh, axes, ParallelCtx(mesh, dict(cfg.rules)))
    step, _ = CheckpointManager(os.path.join(root, "b")).restore_latest(
        {"params": fresh, "opt": TR.make_lm_train_step(cfg, ParallelCtx(mesh, dict(cfg.rules)))[1].init(fresh)})
    r["restored_step"] = step
    r["restored"] = {k: _whole(p) for k, p in fresh.named_parameters()}

    orig, calls = TR.make_lm_train_step, []

    def failing(*a, **k):
        step_fn, opt = orig(*a, **k)

        def once(*sa):
            calls.append(1)
            if len(calls) == 3:
                raise RuntimeError("an injected failure")
            return step_fn(*sa)
        return once, opt

    TR.make_lm_train_step = failing
    try:
        m, r["restart_losses"] = TR.train_lm(cfg, mesh, TRAIN_STEPS, os.path.join(root, "c"), **kw)
    finally:
        TR.make_lm_train_step = orig
    r["restart_params"] = {k: _whole(p) for k, p in m.named_parameters()}
    return r


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch import interop
    from repro_torch.distributed.sharding import ParallelCtx
    from repro_torch.launch.steps import make_lm_train_step

    tmp = tmp_path_factory.mktemp("mesh_train")
    cases = {name: _inputs(name) for name in CASES}
    train_case = _train_lm_case()
    rules = ReproMesh("rules_reference", tmp, _archs(), MESHES)
    ref = ReproMesh("train_reference", tmp, cases)
    ref_train_lm = ReproMesh("train_lm_reference", tmp, train_case, str(tmp))
    ranks = run_ranks(_train_body, 8, tmp, cases, train_case, str(tmp / "ckpt"), timeout=300.0)
    repro = ref.result()
    repro["train_lm"] = ref_train_lm.result()
    carried = {name: (repro[name]["params"][0], _ref_state(repro[name]["states"][0])) for name in CASES}
    for r, c in zip(ranks, run_ranks(_carried_body, 8, tmp, cases, carried, timeout=300.0)):
        for name in CASES:
            r[name]["carried"] = c[name]
    one = {}
    for name in ONE_DEVICE:
        cfg, c = _cfg(name), cases[name]
        step, opt = make_lm_train_step(cfg, ParallelCtx(None, dict(cfg.rules)), lr=LR)
        model = interop.transformer_params(c["params"], cfg, "cpu")
        one[name] = _steps(step, model, opt.init(model), c["batches"])
    one["train_lm"] = _train_lm_runs(None, str(tmp / "one"), train_case["params"])
    return {"ranks": ranks, "repro": repro, "one": one, "cases": cases, "rules": rules.result()}


def _ref_state(s):
    """``repro``'s state (a dict of its NamedTuple's fields) as an object
    with those fields."""
    from types import SimpleNamespace

    return SimpleNamespace(**s)


# ---- conversions of repro's trees to the port's names ----------------------

def _named(tree, name):
    from repro_torch import interop

    m = interop.transformer_params(tree, _cfg(name), "cpu")
    return {k: v.detach() for k, v in m.named_parameters()}


def _ref_state_leaf(state, field, key):
    from repro_torch.interop import _reference_array

    return _reference_array(state[field], key, ("blocks",))


def _moments(state, name):
    """A reference AdamW state as ``{m, v}`` of the port's names (for
    ``assert_adamw_close``)."""
    from types import SimpleNamespace

    return SimpleNamespace(m=_named(state["m"], name), v=_named(state["v"], name))


def _check_steps(got, want_params, want_states, want_losses, name, ctx, opt_name, start=0):
    for i, g_loss in enumerate(got["losses"]):
        np.testing.assert_allclose(g_loss, want_losses[i], rtol=TRAIN_TOL, err_msg=f"{ctx} loss {i}")
        wp = {k: torch.from_numpy(np.asarray(v)) for k, v in want_params[i].items()}
        gp = {k: torch.from_numpy(v) for k, v in got["params"][i].items()}
        step = start + i + 1
        if opt_name == "adamw" and i > 0:
            # AdamW moves a parameter of a tiny gradient far for a small move
            # of it: after a step the two sides' weights differ by that much,
            # so a later step is held where both start from the same weights
            # (the carried step) and here by its loss alone
            continue
        if opt_name == "adamw":
            old = None if start + i == 0 else _moments(want_states[i - 1] if i else want_states["before"], name)
            assert_step_close("adamw", wp, gp, old, _moments(want_states[i], name), step, LR, f"{ctx} step {step}")
        else:
            assert_step_close(opt_name, wp, gp, None, None, step, LR, f"{ctx} step {step}")
        for field, leaves in got["states"][i].items():
            if field == "step":
                assert leaves == step
                continue
            for key, v in leaves.items():
                assert_leaf_close(_ref_state_leaf(want_states[i], field, key), torch.from_numpy(v), TRAIN_TOL,
                                  f"{ctx} step {step} {field}.{key}")


def _repro_params(runs, name):
    return [_named(p, name) for p in runs["repro"][name]["params"]]


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_step_against_repro(runs, name):
    want = runs["repro"][name]
    if name.startswith("qwen"):
        assert want["norm"] > 1.0, "the clip must be active"
    for rank, r in enumerate(runs["ranks"]):
        _check_steps(r[name], _repro_params(runs, name), want["states"], want["losses"], name,
                     f"{name} rank {rank} vs repro", _cfg(name).optimizer)


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_step_from_repros_carried_state(runs, name):
    """Step 2 from ``repro``'s parameters and state after step 1, carried
    onto the mesh by ``interop``."""
    want = runs["repro"][name]
    states = {0: want["states"][1], "before": want["states"][0]}
    for rank, r in enumerate(runs["ranks"]):
        _check_steps(r[name]["carried"], _repro_params(runs, name)[1:], states, want["losses"][1:], name,
                     f"{name} rank {rank} carried", _cfg(name).optimizer, start=1)


@pytest.mark.parametrize("name", ONE_DEVICE)
def test_mesh_step_against_one_device(runs, name):
    one = runs["one"][name]
    for rank, r in enumerate(runs["ranks"]):
        for i in range(2):
            np.testing.assert_allclose(r[name]["losses"][i], one["losses"][i], rtol=TRAIN_TOL)
            if i and _cfg(name).optimizer == "adamw":
                continue    # as in _check_steps: the weights after AdamW's first step differ
            for k, v in one["params"][i].items():
                if _cfg(name).optimizer == "adamw":
                    continue   # AdamW's parameters against repro, with its moments (above)
                assert_leaf_close(v, torch.from_numpy(r[name]["params"][i][k]), TRAIN_TOL, f"{name} rank {rank} {k}")
            for field, leaves in one["states"][i].items():
                if field == "step":
                    continue
                for key, v in leaves.items():
                    got = r[name]["states"][i][field]
                    if key in got:
                        assert_leaf_close(v, torch.from_numpy(got[key]), TRAIN_TOL, f"{name} rank {rank} {field}.{key}")


@pytest.mark.parametrize("name", [n for n in CASES if _cfg(n).zero_sharding])
def test_zero_keeps_one_data_block_of_every_state_leaf(runs, name):
    """Every leaf that ``repro``'s ``zero_axes_of`` shards over "data" is
    ZeRO'd on that dim, and each rank's state block holds 1/2 of it there."""
    plan = runs["repro"][name]["zero_axes"]
    from repro_torch.launch.steps import _flatten

    want = {k: ax.index("data") for k, ax in _flatten(plan).items() if "data" in ax}
    assert want
    for r in runs["ranks"]:
        zero = r[name]["zero"]
        assert {k: z[0] for k, z in zero.items()} == want
        for key, (zdim, shape, fields) in zero.items():
            nd = len(shape)
            for f, (whole, local) in fields.items():
                # Adafactor's row factor drops the last dim, its column factor the second to last
                if f in ("m", "v"):
                    dim = zdim
                elif f == "vr":
                    dim = zdim if zdim < nd - 1 else None
                else:
                    dim = None if zdim == nd - 2 else min(zdim, nd - 2)
                if dim is not None:
                    assert local[dim] * 2 == whole[dim], (key, f, whole, local)


def _train_lm_want(runs, ref, run=""):
    """A run of ``ref`` (``run``: "" unbroken, "resumed_" or "restart_"):
    its losses and its parameters by the port's names."""
    if ref == "one device":
        one = runs["one"]["train_lm"]
        return one[run + "losses"], one[run + "params"]
    from repro_torch import interop

    want = runs["repro"]["train_lm"]
    model = interop.transformer_params(want[run + "params"], _train_cfg(), "cpu")
    return want[run + "losses"], {k: v.detach().numpy() for k, v in model.named_parameters()}


def _assert_train_lm_close(got_losses, got_params, want_losses, want_params, ctx):
    np.testing.assert_allclose(got_losses, want_losses, rtol=TRAIN_TOL, err_msg=ctx)
    noise = sorted(k for k in want_params if k.endswith(NOISE_LEAF))
    assert noise
    for k, v in want_params.items():
        if k not in noise:
            assert_leaf_close(v, torch.from_numpy(got_params[k]), TRAIN_TOL, f"{ctx} {k}")
    diff = np.stack([np.asarray(got_params[k], np.float64) - want_params[k] for k in noise])
    assert np.sqrt(np.mean(diff ** 2)) <= 2 * TRAIN_STEPS * TRAIN_LR, f"{ctx} {NOISE_LEAF}"


def _unbroken(runs, ref):
    """Every rank's losses and parameters after 4 steps are ``ref``'s."""
    losses, params = _train_lm_want(runs, ref)
    assert len(losses) == TRAIN_STEPS
    for rank, r in enumerate(runs["ranks"]):
        r = r["train_lm"]
        _assert_train_lm_close(r["losses"], r["params"], losses, params, f"rank {rank} vs {ref}")


def _resumed(runs, ref):
    """Resumed at step 2 (its data drawn again from the seed), the run
    follows ``ref``'s resumed run; its last checkpoint, restored into a
    fresh model over the mesh, equals the parameters it saved bit for bit."""
    losses, params = _train_lm_want(runs, ref, "resumed_")
    for rank, r in enumerate(runs["ranks"]):
        r = r["train_lm"]
        assert r["restored_step"] == TRAIN_STEPS
        _assert_train_lm_close(r["resumed_losses"], r["resumed_params"], losses, params,
                               f"rank {rank} resumed vs {ref}")
        for k, v in r["resumed_params"].items():
            np.testing.assert_array_equal(r["restored"][k], v)


def _restarted(runs, ref):
    """The third step raises; ``train_lm`` restores step 2's checkpoint and
    goes on with the next batch, on every rank alike, as ``ref``'s run
    with the same failure."""
    losses, params = _train_lm_want(runs, ref, "restart_")
    for rank, r in enumerate(runs["ranks"]):
        r = r["train_lm"]
        assert len(r["restart_losses"]) == TRAIN_STEPS
        _assert_train_lm_close(r["restart_losses"], r["restart_params"], losses, params,
                               f"rank {rank} restarted vs {ref}")


def test_train_lm_over_a_mesh_matches_one_device(runs):
    _unbroken(runs, "one device")


def test_train_lm_over_a_mesh_matches_repro(runs):
    _unbroken(runs, "repro")


def test_train_lm_resumes_over_a_mesh(runs):
    _resumed(runs, "one device")


def test_train_lm_resumes_over_a_mesh_as_repro(runs):
    _resumed(runs, "repro")


def test_train_lm_restarts_over_a_mesh(runs):
    _restarted(runs, "one device")


def test_train_lm_restarts_over_a_mesh_as_repro(runs):
    _restarted(runs, "repro")


# ---- the rule functions -----------------------------------------------------

MESHES = (((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")))


def _archs():
    import repro_torch.configs as tc

    return tc.all_archs()


def _stand_in(shape, axes):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape), mesh_dim_names=axes,
                      _init_backend=False, _rank=0)     # a stand-in: no process group, nothing communicates


@pytest.mark.parametrize("mesh", MESHES, ids=["data-model", "pod-data-model"])
@pytest.mark.parametrize("arch", _archs())
def test_rule_functions_equal_repros(runs, arch, mesh):
    import repro_torch.configs as tc
    from repro_torch.distributed.sharding import ParallelCtx
    from repro_torch.launch import steps as ST
    from repro_torch.models import recsys as R
    from repro_torch.models import schnet as S
    from repro_torch.models import transformer as T

    want = runs["rules"]
    key = (tuple(mesh[0]), tuple(mesh[1]))
    dm = _stand_in(*mesh)
    cfg = tc.get_config(arch)
    for s in cfg.shapes:
        assert ST.rules_for_shape(cfg, s, dm) == want[key, arch, s.name], (arch, s.name)
    for b in (1, 4, 6, 256):
        rules = dict(cfg.rules)
        ST._fit_batch_rule(rules, dm, b)
        assert rules == want[key, arch, "fit", b], (arch, b)
    if cfg.family == "lm":
        model, axes = T.init_transformer(cfg, device="meta")
        za = ST.zero_axes_of(ST.stacked_shapes(model), axes, ParallelCtx(dm, dict(cfg.rules)))
        assert za == want[key, arch, "zero"]
        shapes = ST.stacked_shapes(model)
        for opt in ("adamw", "adafactor"):
            assert tuple(ST._opt_axes_safe(opt, shapes, za)) == want[key, arch, "opt", opt]
    else:
        init = R.init_recsys if cfg.family == "recsys" else S.init_schnet
        model, axes = init(cfg, device="meta")
        assert tuple(ST._opt_axes_safe("adamw", None, axes)) == want[key, arch, "opt", "adamw"]
