"""``repro``'s side of the mesh parity tests (``tests/test_torch_mesh_*.py``):
each function runs in a subprocess that sees 8 forced host devices
(``_torch_parity.ReproMesh``), builds a ("data", "model") = (2, 4)
mesh, places the parameters by ``params_sharding`` as ``train_lm`` and
``_lm_cell`` place them, runs the reference's jitted functions under the
same rules as the port, and returns numpy arrays.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

MESH = ((2, 4), ("data", "model"))


def _mesh(shape=MESH[0], axes=MESH[1]):
    from repro.distributed.mesh_utils import make_mesh

    return make_mesh(shape, axes)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _placed(tree, shardings):
    return jax.tree.map(lambda a, s: jax.device_put(jnp.asarray(a), s), tree, shardings)


def _lm_cfg(case):
    from repro import configs as jc

    return dataclasses.replace(jc.get_smoke_config(case["arch"]), **case["kw"])


def _axes(cfg):
    from repro.launch.steps import abstract_init
    from repro.models import transformer as T

    return abstract_init(T.init_transformer, jax.random.PRNGKey(0), cfg)


def lm_reference(cases):
    """Per case: the backbone's hidden states and aux, ``lm_loss`` and the
    gradients of every leaf, the loss of a batch with a target outside
    [0, Vp), the first block on ``block_x``, ``encode``, under the config's
    rules; ``prefill_step`` and a
    run of ``decode_step`` (logits and final cache) under
    ``rules_for_shape``'s."""
    from repro.configs.base import LMShape
    from repro.distributed.sharding import ParallelCtx, params_sharding
    from repro.launch.steps import rules_for_shape
    from repro.models import encoder as E
    from repro.models import transformer as T

    mesh = _mesh()
    out = {}
    for name, c in cases.items():
        cfg = _lm_cfg(c)
        _, axes = _axes(cfg)
        r = {}
        ctx = ParallelCtx(mesh, dict(cfg.rules))
        p = _placed(c["params"], params_sharding(axes, ctx))
        bsh = ctx.sharding("batch", None)
        tok = jax.device_put(c["tokens"], bsh)
        batch = {"tokens": tok, "targets": jax.device_put(c["targets"], bsh)}
        hidden, aux = jax.jit(lambda p, t: T.backbone(p, t, cfg, ctx))(p, tok)
        (loss, metrics), grads = jax.jit(jax.value_and_grad(lambda p, b: T.lm_loss(p, b, cfg, ctx), has_aux=True))(
            p, batch)
        r.update(hidden=np.asarray(hidden), aux=float(aux), loss=float(loss), ce=float(metrics["ce"]),
                 grads=_np(grads))
        bad = {"tokens": tok, "targets": jax.device_put(c["bad_targets"], bsh)}
        r["bad_loss"] = float(jax.jit(lambda p, b: T.lm_loss(p, b, cfg, ctx)[0])(p, bad))
        layer0 = jax.tree.map(lambda a: a[0], p["blocks"])
        x = jax.device_put(c["block_x"], ctx.sharding("batch", "seq_act", None))
        pos = jnp.broadcast_to(jnp.arange(x.shape[1]), x.shape[:2])
        y, _ = jax.jit(lambda bp, x, pos: T.block_apply(bp, x, pos, cfg, ctx))(layer0, x, pos)
        r["block"] = np.asarray(y)
        r["encode"] = np.asarray(jax.jit(lambda p, t: E.encode(p, t, cfg, ctx))(p, tok))

        b, s = c["tokens"].shape
        pcfg = dataclasses.replace(cfg, rules=rules_for_shape(cfg, LMShape("prefill", s, b, "prefill"), mesh))
        pctx = ParallelCtx(mesh, pcfg.rules)
        pp = _placed(c["params"], params_sharding(axes, pctx))
        r["prefill"] = np.asarray(jax.jit(lambda p, t: T.prefill_step(p, t, pcfg, pctx))(
            pp, jax.device_put(c["tokens"], pctx.sharding("batch", None))))
        r["prefill_rules"] = dict(pcfg.rules)

        smax = c["cache_len"]
        dcfg = dataclasses.replace(cfg, rules=rules_for_shape(cfg, LMShape("decode", smax, b, "decode"), mesh))
        dctx = ParallelCtx(mesh, dcfg.rules)
        dp = _placed(c["params"], params_sharding(axes, dctx))
        cache = T.init_cache(dcfg, b, smax)
        cache = jax.tree.map(lambda a, ax: jax.device_put(a, dctx.sharding(*ax)), cache, T.cache_axes(dcfg),
                             is_leaf=lambda x: isinstance(x, tuple) and all(e is None or isinstance(e, str) for e in x))
        step = jax.jit(lambda p, cache, t, pos: T.decode_step(p, cache, t, pos, dcfg, dctx), static_argnums=3)
        logits = []
        for pos, t in zip(c["positions"], c["dec_tokens"]):
            lg, cache = step(dp, cache, jax.device_put(t, dctx.sharding("batch", None)), int(pos))
            logits.append(np.asarray(lg))
        r["decode"] = np.stack(logits)
        r["cache"] = {k: np.asarray(v) for k, v in cache._asdict().items() if v is not None}
        r["decode_rules"] = dict(dcfg.rules)
        out[name] = r
    return out


def train_reference(cases):
    """Per case: ``make_lm_train_step`` over the mesh with the state placed
    as ``_lm_cell`` places it (ZeRO's plan when the config asks), run over
    ``batches``: each step's loss, the parameters and the state after each
    step, and the first step's global gradient norm."""
    from repro.distributed.sharding import ParallelCtx, params_sharding
    from repro.launch.steps import _opt_axes_safe, make_lm_train_step, zero_axes_of
    from repro.models import transformer as T
    from repro.optim.optimizer import global_norm

    mesh = _mesh()
    out = {}
    for name, c in cases.items():
        cfg = _lm_cfg(c)
        sds, axes = _axes(cfg)
        ctx = ParallelCtx(mesh, dict(cfg.rules))
        step, opt = make_lm_train_step(cfg, ctx, lr=c["lr"], params_axes=axes, params_sds=sds)
        p_shard = params_sharding(axes, ctx)
        state_axes = zero_axes_of(sds, axes, ctx) if cfg.zero_sharding else axes
        o_shard = params_sharding(_opt_axes_safe(cfg.optimizer, sds, state_axes), ctx)
        b_shard = {"tokens": ctx.sharding("batch", None), "targets": ctx.sharding("batch", None)}
        p = _placed(c["params"], p_shard)
        st = jax.jit(opt.init, out_shardings=o_shard)(p)
        first = {k: jax.device_put(v, b_shard[k]) for k, v in c["batches"][0].items()}
        grads = jax.jit(jax.grad(lambda p, b: T.lm_loss(p, b, cfg, ctx)[0]))(p, first)
        r = {"norm": float(global_norm(grads)), "losses": [], "params": [], "states": []}
        jstep = jax.jit(step, in_shardings=(p_shard, o_shard, b_shard), out_shardings=(p_shard, o_shard, None))
        for b in c["batches"]:
            p, st, m = jstep(p, st, {k: jax.device_put(v, b_shard[k]) for k, v in b.items()})
            r["losses"].append(float(m["loss"]))
            r["params"].append(_np(p))
            r["states"].append(_np(st._asdict()))
        r["zero_axes"] = zero_axes_of(sds, axes, ctx) if cfg.zero_sharding else None
        out[name] = r
    return out


def rules_reference(archs, meshes):
    """``rules_for_shape`` for every arch and shape, and ``zero_axes_of`` and
    ``_opt_axes_safe`` for the LM archs, on each mesh ``(shape, axes)``."""
    from repro import configs as jc
    from repro.distributed.sharding import ParallelCtx
    from repro.launch.steps import _fit_batch_rule, _opt_axes_safe, rules_for_shape, zero_axes_of
    from repro.models import recsys as R
    from repro.models import schnet as S

    out = {}
    for shape, axes in meshes:
        mesh = _mesh(shape, axes)
        key = (tuple(shape), tuple(axes))
        for arch in archs:
            cfg = jc.get_config(arch)
            for s in cfg.shapes:
                out[key, arch, s.name] = rules_for_shape(cfg, s, mesh)
            for b in (1, 4, 6, 256):
                rules = dict(cfg.rules)
                _fit_batch_rule(rules, mesh, b)
                out[key, arch, "fit", b] = rules
            if cfg.family == "lm":
                sds, ax = _axes(cfg)
                ctx = ParallelCtx(mesh, dict(cfg.rules))
                za = zero_axes_of(sds, ax, ctx)
                out[key, arch, "zero"] = za
                for opt in ("adamw", "adafactor"):
                    out[key, arch, "opt", opt] = tuple(_opt_axes_safe(opt, sds, za))
            else:
                init = R.init_recsys if cfg.family == "recsys" else S.init_schnet
                from repro.launch.steps import abstract_init

                sds, ax = abstract_init(init, jax.random.PRNGKey(0), cfg)
                out[key, arch, "opt", "adamw"] = tuple(_opt_axes_safe("adamw", sds, ax))
    return out


def models_reference(cases):
    """Per recommendation case: the user tower, the logits, ``bce_loss`` and
    its gradients under ``DEFAULT_RECSYS_RULES``, the logits of a batch with
    an id below -V, and ``retrieval_scores`` under the retrieval rules.
    Per SchNet case: ``schnet_apply``, ``schnet_loss`` and its gradients, and
    one ``make_gnn_train_step`` step."""
    from repro import configs as jc
    from repro.configs.base import FieldSpec, RecSysShape
    from repro.distributed.sharding import ParallelCtx, params_sharding
    from repro.launch.steps import abstract_init, make_gnn_train_step, rules_for_shape
    from repro.models import recsys as R
    from repro.models import schnet as S

    mesh = _mesh()
    out = {}
    for name, c in cases.items():
        r = {}
        if c["kind"] == "schnet":
            cfg = dataclasses.replace(jc.get_smoke_config("schnet"), **c["kw"])
            _, axes = abstract_init(S.init_schnet, jax.random.PRNGKey(0), cfg)
            ctx = ParallelCtx(mesh, dict(cfg.rules))
            p = _placed(c["params"], params_sharding(axes, ctx))
            g = S.GraphBatch(**{k: jnp.asarray(v) for k, v in c["graph"].items()})
            r["apply"] = np.asarray(jax.jit(lambda p, g: S.schnet_apply(p, g, cfg, ctx))(p, g))
            loss, grads = jax.jit(jax.value_and_grad(lambda p, g: S.schnet_loss(p, g, cfg, ctx, c["n_graphs"])[0]))(
                p, g)
            r["loss"], r["grads"] = float(loss), _np(grads)
            step, opt = make_gnn_train_step(cfg, ctx, n_graphs=c["n_graphs"])
            np_, _, m = jax.jit(step)(p, opt.init(p), g)
            r["step_params"], r["step_loss"] = _np(np_), float(m["loss"])
            out[name] = r
            continue
        base = jc.get_smoke_config(c["arch"])
        cfg = dataclasses.replace(base, fields=tuple(FieldSpec(*f) for f in c["fields"]), **c["kw"])
        _, axes = abstract_init(R.init_recsys, jax.random.PRNGKey(0), cfg)
        ctx = ParallelCtx(mesh, dict(cfg.rules))
        p = _placed(c["params"], params_sharding(axes, ctx))

        def rec(raw):
            return R.RecBatch({k: jnp.asarray(v) for k, v in raw["fields"].items()},
                              None if raw["history"] is None else jnp.asarray(raw["history"]),
                              jnp.asarray(raw["target_item"]), jnp.asarray(raw["label"]),
                              jnp.asarray(raw["candidates"]))

        batch = rec(c["batch"])
        r["tower"] = np.asarray(jax.jit(lambda p, b: R.user_tower(p, cfg, b, ctx))(p, batch))
        r["logits"] = np.asarray(jax.jit(lambda p, b: R.forward_logits(p, cfg, b, ctx))(p, batch))
        loss, grads = jax.jit(jax.value_and_grad(lambda p, b: R.bce_loss(p, cfg, b, ctx)[0]))(p, batch)
        r["loss"], r["grads"] = float(loss), _np(grads)
        r["nan_logits"] = np.asarray(jax.jit(lambda p, b: R.forward_logits(p, cfg, b, ctx))(p, rec(c["nan_batch"])))
        if cfg.item_vocab:
            rrules = rules_for_shape(cfg, RecSysShape("retrieval_cand", 1, kind="retrieval"), mesh)
            rcfg = dataclasses.replace(cfg, rules=rrules)
            rctx = ParallelCtx(mesh, rrules)
            rp = _placed(c["params"], params_sharding(axes, rctx))
            vals, ids = jax.jit(lambda p, b: R.retrieval_scores(p, rcfg, b, rctx, k=c["k"]))(rp, rec(c["ret_batch"]))
            r["ret_vals"], r["ret_ids"] = np.asarray(vals), np.asarray(ids)
        out[name] = r
    return out


def train_lm_reference(case, root):
    """``repro``'s ``train_lm`` over the mesh from the case's weights (its
    ``init_transformer`` patched to return them, as the port's side patches
    its own), with a checkpoint every 2 steps: ``steps`` steps; 2 steps,
    then a resumed run to ``steps`` (its data drawn again from the seed);
    a run whose third step raises once (``train_lm`` restores the
    checkpoint at step 2 and goes on with the next batch).  The losses and
    the final parameters of each."""
    import os

    import repro.launch.train as TR
    from repro.models import transformer as T

    cfg = _lm_cfg(case)
    _, axes = _axes(cfg)
    mesh = _mesh()
    kw = dict(batch_size=case["batch_size"], seq_len=case["seq_len"], ckpt_interval=2, lr=case["lr"])
    steps = case["steps"]
    init, calls = T.init_transformer, []

    class FailingJit:       # the third call of the jitted step raises, as the port's test injects it
        def __getattr__(self, name):
            return getattr(jax, name)

        @staticmethod
        def jit(fn, **jit_kw):
            compiled = jax.jit(fn, **jit_kw)

            def call(*args):
                calls.append(1)
                if len(calls) == 3:
                    raise RuntimeError("an injected failure")
                return compiled(*args)
            return call

    T.init_transformer = lambda key, c: (jax.tree.map(jnp.asarray, case["params"]), axes)
    try:
        r = {}
        p, r["losses"] = TR.train_lm(cfg, mesh, steps, os.path.join(root, "repro_a"), **kw)
        r["params"] = _np(p)
        _, first = TR.train_lm(cfg, mesh, 2, os.path.join(root, "repro_b"), **kw)
        p, rest = TR.train_lm(cfg, mesh, steps, os.path.join(root, "repro_b"), **kw)
        r["resumed_losses"], r["resumed_params"] = first + rest, _np(p)
        TR.jax = FailingJit()
        try:
            p, r["restart_losses"] = TR.train_lm(cfg, mesh, steps, os.path.join(root, "repro_c"), **kw)
        finally:
            TR.jax = jax
        r["restart_params"] = _np(p)
    finally:
        T.init_transformer = init
    return r
