"""The transformer under a mesh: 8 gloo ranks on a ("data", "model") =
(2, 4) mesh run the port's per-rank code for the smoke configs of
qwen2.5-3b (GQA, QKV biases), smollm-360m (pure data parallelism),
minicpm3-4b (MLA; here with 6 heads padded to 8 and a vocabulary of 500
padded to 512, so that the padding falls in the last shards) and
phi3.5-moe (experts over "model"), and every rank's results are held
against two references on the same numpy weights:

* ``repro`` under the same rules on 8 forced host devices in a
  subprocess (``tests/_torch_mesh_ref.py``), its parameters placed by
  ``params_sharding`` as ``train_lm`` and ``_lm_cell`` place them;
* the port's own ``mesh=None`` run in this process.

Held: ``backbone`` (hidden states and the MoE aux), ``block_apply`` on a
whole input, ``lm_loss`` and the
gradient of every leaf under the config's rules; a target outside
[0, Vp) (NaN); ``encode``; ``cross_encoder_score`` (against the
one-device run); ``prefill_step`` under ``rules_for_shape``'s
prefill rules; five ``decode_step`` calls (positions 0, 1, 2, 30 and
Smax + 2, whose write clamps) under its decode rules, the logits and the
final cache.  The batch holds an id past the padded vocabulary and a
negative one (``gather_rows`` wraps and clamps it before the range test
of the vocabulary-parallel embedding) and a negative target (it wraps:
into minicpm's padded columns, which the loss masks by global column id).

Tolerance: ``TRAIN_TOL`` (1e-5 of a leaf's largest |value|), a gradient
that vanishes in exact arithmetic against ``GRAD_FLOOR`` of the model's
largest, as in ``test_torch_train_step.py``.  With experts the balance
loss under a mesh is the mean of each rank's (the reference's
``pmean`` over its ``shard_map``): phi's loss and gradients are held
against ``repro``'s mesh run, and against the one-device run with the
aux term off (``aux_weight=0``; the routes agree, no capacity drops at
these sizes).

The ranks run once for the module; each test asserts its own case.  This
module imports no JAX at the top: each rank imports it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import GRAD_FLOOR, TRAIN_TOL, ReproMesh, assert_leaf_close, run_ranks

pytestmark = pytest.mark.torch

CASES = {
    "qwen2.5-3b": ("qwen2.5-3b", {}),
    "smollm-360m": ("smollm-360m", {}),
    "minicpm3-4b padded": ("minicpm3-4b", dict(n_heads=6, n_kv_heads=6, pad_heads_to=8, vocab_size=500,
                                               pad_vocab_to=512)),
    "phi3.5-moe": ("phi3.5-moe-42b-a6.6b", {}),
}
B, S, SMAX = 8, 64, 64
POSITIONS = (0, 1, 2, 30, SMAX + 2)


def _cfg(name):
    import repro_torch.configs as tc

    arch, kw = CASES[name]
    return dataclasses.replace(tc.get_smoke_config(arch), **kw)


def _inputs(name, seed=0):
    """Numpy weights in ``repro``'s tree and the token arrays of a case."""
    import jax

    import repro.configs as jc
    from _torch_parity import lm_params, np_of

    arch, kw = CASES[name]
    jcfg = dataclasses.replace(jc.get_smoke_config(arch), **kw)
    params = jax.tree.map(np_of, lm_params(jcfg, seed))
    vp, v = jcfg.padded_vocab, jcfg.vocab_size
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, v, (B, S)).astype(np.int32)
    targets = np.roll(tokens, -1, 1).copy()
    tokens[0, 3], tokens[1, 2] = vp + 5, -3      # clamps to the last row; wraps
    targets[2, 5] = -2                            # wraps to Vp - 2
    bad = targets.copy()
    bad[3, 7] = vp + 1                            # outside [0, Vp): NaN
    dec = rng.integers(0, v, (len(POSITIONS), B, 1)).astype(np.int32)
    dec[1, 0, 0] = vp + 2
    block_x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    return dict(arch=arch, kw=kw, params=params, tokens=tokens, targets=targets, bad_targets=bad,
                dec_tokens=dec, positions=list(POSITIONS), cache_len=SMAX, block_x=block_x)


def _run(model, c, cfg, ctx, pctx, dctx, pmodel, dmodel, whole):
    """Every quantity the tests hold, from the port, as numpy."""
    from repro_torch.models import encoder as E
    from repro_torch.models import transformer as T

    tok = torch.from_numpy(c["tokens"])
    batch = {"tokens": tok, "targets": torch.from_numpy(c["targets"])}
    r = {}
    hidden, aux = T.backbone(model, tok, cfg, ctx)
    r["hidden"], r["aux"] = whole(hidden).detach().numpy(), float(aux)
    leaves = dict(model.named_parameters())
    loss, m = T.lm_loss(model, batch, cfg, ctx)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    r["loss"], r["ce"] = float(loss), float(m["ce"])
    r["grads"] = {k: whole(g).numpy() for k, g in zip(leaves, grads)}
    x = torch.from_numpy(c["block_x"])
    pos = torch.arange(x.shape[1]).expand(x.shape[:2])
    with torch.no_grad():
        r["block"] = whole(T.block_apply(model.blocks[0], x, pos, cfg, ctx)[0]).numpy()
    if cfg.is_moe:
        loss, _ = T.lm_loss(model, batch, cfg, ctx, aux_weight=0.0)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        r["ce_grads"] = {k: whole(g).numpy() for k, g in zip(leaves, grads)}
    with torch.no_grad():
        r["bad_loss"] = float(T.lm_loss(model, {"tokens": tok, "targets": torch.from_numpy(c["bad_targets"])},
                                        cfg, ctx)[0])
        r["encode"] = whole(E.encode(model, tok, cfg, ctx)).numpy()
        r["cross"] = E.cross_encoder_score(model, tok[:, :S // 2], tok[:, S // 2:], cfg, ctx).numpy()
        r["prefill"] = T.prefill_step(pmodel, tok, pctx.cfg, pctx.ctx).numpy()
        dcfg = dctx.cfg
        cache = T.init_cache(dcfg, B, SMAX, "cpu", ctx=dctx.ctx if dctx.ctx.mesh is not None else None)
        logits = []
        for pos, t in zip(c["positions"], c["dec_tokens"]):
            lg, cache = T.decode_step(dmodel, cache, torch.from_numpy(t), int(pos), dcfg, dctx.ctx)
            logits.append(lg.numpy())
        r["decode"] = np.stack(logits)
        r["cache"] = {k: whole(v).numpy() for k, v in cache._asdict().items() if v is not None}
    return r


class _Rules:
    def __init__(self, cfg, kind, mesh):
        from repro_torch.configs.base import LMShape
        from repro_torch.distributed.sharding import ParallelCtx
        from repro_torch.launch.steps import rules_for_shape

        rules = rules_for_shape(cfg, LMShape(kind, SMAX if kind == "decode" else S, B, kind), mesh)
        self.cfg = dataclasses.replace(cfg, rules=rules)
        self.ctx = ParallelCtx(mesh, rules)


def _whole(x):
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import NamedSharding

    if isinstance(x, DTensor):
        x = C.gather_full(x.to_local().detach(), NamedSharding.of(x), x.shape)
    return x.detach().clone()     # a replicated block is the live tensor: copy it


def _mesh_body(rank, world, cases):
    from repro_torch import interop
    from repro_torch.distributed.mesh_utils import make_mesh
    from repro_torch.distributed.sharding import ParallelCtx

    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    out = {}
    for name, c in cases.items():
        cfg = _cfg(name)
        ctx = ParallelCtx(mesh, dict(cfg.rules))
        pctx, dctx = _Rules(cfg, "prefill", mesh), _Rules(cfg, "decode", mesh)
        model = interop.transformer_params(c["params"], cfg, "cpu", ctx=ctx)
        pmodel = interop.transformer_params(c["params"], pctx.cfg, "cpu", ctx=pctx.ctx)
        dmodel = interop.transformer_params(c["params"], dctx.cfg, "cpu", ctx=dctx.ctx)
        r = _run(model, c, cfg, ctx, pctx, dctx, pmodel, dmodel, _whole)
        r["prefill_rules"], r["decode_rules"] = dict(pctx.cfg.rules), dict(dctx.cfg.rules)
        r["local_embed"] = tuple(model.embed.to_local().shape)
        out[name] = r
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch import interop
    from repro_torch.distributed.sharding import ParallelCtx

    tmp = tmp_path_factory.mktemp("mesh_lm")
    cases = {name: _inputs(name) for name in CASES}
    ref = ReproMesh("lm_reference", tmp, cases)
    ranks = run_ranks(_mesh_body, 8, tmp, cases, timeout=240.0)
    one = {}
    for name, c in cases.items():
        cfg = _cfg(name)
        ctx = ParallelCtx(None, dict(cfg.rules))
        model = interop.transformer_params(c["params"], cfg, "cpu")
        plain = _Rules(cfg, "train", None)
        plain.ctx = ctx
        one[name] = _run(model, c, cfg, ctx, plain, plain, model, model, _whole)
    return {"ranks": ranks, "repro": ref.result(), "one": one, "cases": cases}


def _port_grads(jgrads, name):
    """``repro``'s gradient tree as the port's ``{name: array}``."""
    from repro_torch import interop

    model = interop.transformer_params(jgrads, _cfg(name), "cpu")
    return {k: v.detach().numpy() for k, v in model.named_parameters()}


def _each_rank(runs, name):
    return [(rank, r[name]) for rank, r in enumerate(runs["ranks"])]


def _want(runs, ref, name):
    if ref == "repro":
        w = dict(runs["repro"][name])
        w["grads"] = _port_grads(w["grads"], name)
        return w
    return runs["one"][name]


REFS = ("repro", "one device")


def _close(want, got, ctx, floor=0.0):
    assert_leaf_close(want, got, TRAIN_TOL, ctx, floor)


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("name", list(CASES))
def test_backbone_under_a_mesh(runs, name, ref):
    want = _want(runs, ref, name)
    for rank, r in _each_rank(runs, name):
        _close(want["hidden"], r["hidden"], f"{name} rank {rank} hidden vs {ref}")
        if ref == "repro" or not _cfg(name).is_moe:   # the mesh's aux is the mean of the ranks'
            np.testing.assert_allclose(r["aux"], want["aux"], rtol=TRAIN_TOL, atol=1e-12)


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("name", list(CASES))
def test_block_apply_under_a_mesh(runs, name, ref):
    """The first block on a whole input: every rank gets the whole output."""
    want = _want(runs, ref, name)
    for rank, r in _each_rank(runs, name):
        _close(want["block"], torch.from_numpy(r["block"]), f"{name} rank {rank} block vs {ref}")


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("name", list(CASES))
def test_lm_loss_under_a_mesh(runs, name, ref):
    want = _want(runs, ref, name)
    for rank, r in _each_rank(runs, name):
        np.testing.assert_allclose(r["ce"], want["ce"], rtol=TRAIN_TOL, err_msg=f"{name} rank {rank}")
        if ref == "repro" or not _cfg(name).is_moe:
            np.testing.assert_allclose(r["loss"], want["loss"], rtol=TRAIN_TOL, err_msg=f"{name} rank {rank}")
        assert np.isnan(r["bad_loss"]) and np.isnan(want["bad_loss"]), (name, rank)


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("name", list(CASES))
def test_every_gradient_under_a_mesh(runs, name, ref):
    want = _want(runs, ref, name)
    key = "ce_grads" if ref != "repro" and _cfg(name).is_moe else "grads"
    wg = want["grads"] if key == "grads" else runs["one"][name]["ce_grads"]
    floor = GRAD_FLOOR * max(float(np.abs(g).max()) for g in wg.values())
    for rank, r in _each_rank(runs, name):
        assert list(r[key]) == list(wg)
        for leaf, g in wg.items():
            _close(g, torch.from_numpy(r[key][leaf]), f"{name} rank {rank} d{leaf} vs {ref}", floor)


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("name", list(CASES))
def test_prefill_step_under_the_prefill_rules(runs, name, ref):
    want = _want(runs, ref, name)
    for rank, r in _each_rank(runs, name):
        _close(want["prefill"], torch.from_numpy(r["prefill"]), f"{name} rank {rank} prefill vs {ref}")
        assert r["prefill_rules"] == runs["repro"][name]["prefill_rules"]


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("name", list(CASES))
def test_decode_step_under_the_decode_rules(runs, name, ref):
    """The logits of the real vocabulary within tolerance, the padded
    columns at f32-min on both sides, and the cache each step wrote.
    Against ``repro``'s mesh run only the positions inside the cache
    count: its write at ``pos >= Smax`` is dropped under GSPMD (below)."""
    want = _want(runs, ref, name)
    v = _cfg(name).vocab_size
    inside = ref == "repro"
    for rank, r in _each_rank(runs, name):
        assert r["decode_rules"] == runs["repro"][name]["decode_rules"]
        for i, pos in enumerate(POSITIONS):
            if inside and pos >= SMAX:
                continue
            _close(want["decode"][i][:, :v], torch.from_numpy(r["decode"][i][:, :v]),
                   f"{name} rank {rank} decode at {pos} vs {ref}")
            np.testing.assert_array_equal(r["decode"][i][:, v:], want["decode"][i][:, v:])
        rows = slice(0, SMAX - 1) if inside else slice(None)
        for k, c in want["cache"].items():
            _close(c[:, :, rows], torch.from_numpy(r["cache"][k][:, :, rows]),
                   f"{name} rank {rank} cache.{k} vs {ref}")


@pytest.mark.parametrize("name", list(CASES))
def test_repro_under_gspmd_drops_a_clamped_decode_write(runs, name):
    """A reference caveat, not the port's: at ``pos = Smax + 2`` one device
    clamps the write to row ``Smax - 1`` (``dynamic_update_slice``), as the
    port does on one device and under the mesh, but ``repro``'s jitted step
    with the cache's sequence split over "model" writes no row at all."""
    last = {k: c[:, :, SMAX - 1] for k, c in runs["repro"][name]["cache"].items()}
    assert all(not np.any(c) for c in last.values())
    for r in [runs["one"][name]] + [rr[name] for rr in runs["ranks"]]:
        assert all(np.any(c[:, :, SMAX - 1]) for c in r["cache"].values())


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("name", list(CASES))
def test_encoder_under_a_mesh(runs, name, ref):
    want = _want(runs, ref, name)
    for rank, r in _each_rank(runs, name):
        _close(want["encode"], torch.from_numpy(r["encode"]), f"{name} rank {rank} encode vs {ref}")


@pytest.mark.parametrize("name", list(CASES))
def test_cross_encoder_under_a_mesh(runs, name):
    """``cross_encoder_score`` reads the head's first column from the
    vocabulary shard that holds it (the others give zeros): every rank's
    scores are the one-device run's."""
    want = runs["one"][name]
    for rank, r in _each_rank(runs, name):
        _close(want["cross"], torch.from_numpy(r["cross"]), f"{name} rank {rank} cross-encoder")


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_vocabulary_block(runs, name):
    """The embedding is split by the rules: over "model" but for
    smollm-360m, whose rules replicate the vocabulary."""
    cfg = _cfg(name)
    rows = cfg.padded_vocab if name == "smollm-360m" else cfg.padded_vocab // 4
    for r in runs["ranks"]:
        assert r[name]["local_embed"] == (rows, cfg.d_model)
