"""Expert parallelism in repro_torch.models.moe on 8 gloo ranks, a (2, 4)
("data", "model") mesh: ``moe_apply`` with a mesh against ``repro``'s
``moe_local`` on ``repro``'s ``moe_init`` draws (the counterpart of
``tests/test_distributed.py::test_moe_ep_matches_oracle``): the outputs
within ``rtol=1e-4, atol=1e-5`` and every gradient, the replicated router
``wg`` too, within ``1e-3 * max(|g|, 1)``, in the three modes of that
test, with ``moe_token_chunks = 2``, with a sequence the tp axis cannot
split, and with ``DTensor`` weights and tokens.

The ranks run once for the module; each test asserts its own case.  This
module imports no JAX at the top: each rank imports it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import run_ranks

pytestmark = pytest.mark.torch

EP2D = {"experts": "data", "expert_ff": "model"}
CASES = {   # name: (ep_mode, rule overrides, moe_token_chunks, x shape)
    "model": ("model", {}, 1, (4, 16, 32)),
    "data": ("data", {}, 1, (4, 16, 32)),
    "2d": ("data", EP2D, 1, (4, 16, 32)),
    "2d chunks": ("data", EP2D, 2, (4, 16, 32)),
    "2d short seq": ("data", EP2D, 1, (4, 3, 32)),   # 3 positions over 4 tp ranks: tokens replicated, ff psum
}


def _cfg(base, name):
    """The reference test's layer in ``base``'s ``TransformerConfig``
    (``repro.configs.base`` or ``repro_torch.configs.base``)."""
    ep_mode, extra, chunks, _ = CASES[name]
    rules = dict(base.DEFAULT_LM_RULES)
    rules.update(extra)
    return base.TransformerConfig(name="t", n_layers=1, d_model=32, n_heads=4, n_kv_heads=4, d_ff=64,
                                  vocab_size=97, n_experts=8, top_k=2, moe_d_ff=48, capacity_factor=2.0,
                                  ep_mode=ep_mode, moe_token_chunks=chunks, dtype="float32", rules=rules)


def _ep_body(rank, world, params, xs):
    from repro_torch import interop
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.mesh_utils import make_mesh
    from repro_torch.distributed.sharding import NamedSharding, ParallelCtx, distribute, params_sharding
    from repro_torch.models import moe as M

    import repro_torch.configs.base as tb

    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    out = {}
    for name in CASES:
        cfg = _cfg(tb, name)
        ctx = ParallelCtx(mesh, cfg.rules)
        p = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
        x = torch.from_numpy(xs[name])
        y, aux = M.moe_apply(p, x, cfg, ctx)
        grads = torch.autograd.grad((y ** 2).sum(), list(p.values()))
        out[name] = (y.detach().numpy(), float(aux), {k: g.numpy() for k, g in zip(p, grads)})

    # DTensor weights (by params_sharding of moe_init's axes) and tokens, 2-D mode
    cfg = _cfg(tb, "2d")
    ctx = ParallelCtx(mesh, cfg.rules)
    _, axes = M.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32, "meta")
    shardings = params_sharding(axes, ctx)
    p = interop.sharded_tree(params, shardings, "cpu")
    for v in p.values():
        v.requires_grad_()
    x_sh = NamedSharding(mesh, ("data", "model", None))
    x = distribute(torch.from_numpy(xs["2d"]), x_sh)
    y, aux = M.moe_apply(p, x, cfg, ctx)
    grads = torch.autograd.grad((y.to_local() ** 2).sum(), list(p.values()))
    out["dtensor"] = (C.gather_full(y.to_local().detach(), x_sh, y.shape).numpy(), float(aux),
                      {k: C.gather_full(g.to_local(), shardings[k], g.shape).numpy() for k, g in zip(p, grads)},
                      {k: tuple(v.to_local().shape) for k, v in p.items()})

    # the fallback with DTensor tokens: 6 experts do not divide over the 4 model ranks
    cfg6 = dataclasses.replace(_cfg(tb, "model"), n_experts=6)
    p6, _ = M.moe_init(torch.Generator().manual_seed(2), cfg6, torch.float32, "cpu")
    whole = torch.from_numpy(xs["model"])
    y, _ = M.moe_apply(p6, distribute(whole, x_sh), cfg6, ParallelCtx(mesh, cfg6.rules))
    want, _ = M.moe_local(p6, whole.reshape(-1, 32), cfg6)
    out["fallback"] = (type(y).__name__, tuple(y.placements) == x_sh.placements,
                       float((C.gather_full(y.to_local(), x_sh, y.shape) - want.reshape(y.shape)).abs().max()))
    return out


@pytest.fixture(scope="module")
def reference():
    """``repro``'s draws and, per case, moe_local's output and gradients."""
    import jax
    import jax.numpy as jnp

    import repro.configs.base as jb
    from repro.models import moe as JM

    params, _ = JM.moe_init(jax.random.PRNGKey(0), _cfg(jb, "model"), jnp.float32)
    params_np = {k: np.asarray(v) for k, v in params.items()}
    xs, want = {}, {}
    for i, name in enumerate(CASES):
        shape = CASES[name][3]
        x = jax.random.normal(jax.random.PRNGKey(1 + i), shape)
        xs[name] = np.asarray(x)
        jcfg = _cfg(jb, name)
        d = shape[-1]
        y, _ = JM.moe_local(params, x.reshape(-1, d), jcfg)
        g = jax.grad(lambda p, xx: jnp.sum(JM.moe_local(p, xx.reshape(-1, d), jcfg)[0] ** 2))(params, x)
        want[name] = (np.asarray(y).reshape(shape), {k: np.asarray(v) for k, v in g.items()})
    return params_np, xs, want


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    params, xs, _ = reference
    return run_ranks(_ep_body, 8, tmp_path_factory.mktemp("moe_ep"), params, xs)


def _expected_aux(name, x, wg):
    """The mean over the ranks of ``route``'s loss on each rank's tokens
    (``repro.models.moe.route``): the 1-D bodies route a (data, model)
    block; the 2-D body a data block's whole sequence, chunk by chunk."""
    import jax.numpy as jnp

    from repro.models import moe as JM

    _, _, chunks, (b, s, d) = CASES[name]
    auxes = []
    for bi in range(2):
        rows = x[bi * b // 2:(bi + 1) * b // 2]
        if CASES[name][1]:                                    # 2-D: one route per data block (chunked)
            flat = rows.reshape(-1, d)
            parts = np.split(flat, chunks)
            auxes += [float(np.mean([float(JM.route(jnp.asarray(c), jnp.asarray(wg), 2)[2]) for c in parts]))] * 4
        else:
            for mi in range(4):
                blk = rows[:, mi * s // 4:(mi + 1) * s // 4].reshape(-1, d)
                auxes.append(float(JM.route(jnp.asarray(blk), jnp.asarray(wg), 2)[2]))
    return float(np.mean(auxes))


@pytest.mark.parametrize("name", list(CASES))
def test_moe_ep_matches_oracle(reference, ranks, name):
    params, xs, want = reference
    y_ref, g_ref = want[name]
    for r in ranks:
        y, aux, g = r[name]
        np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-5, err_msg=name)
        for k in g_ref:
            tol = 1e-3 * max(float(np.abs(g_ref[k]).max()), 1.0)
            assert float(np.abs(g_ref[k] - g[k]).max()) < tol, (name, k)
        assert aux == ranks[0][name][1]
    if name != "2d short seq":
        np.testing.assert_allclose(ranks[0][name][1], _expected_aux(name, xs[name], params["wg"]), rtol=1e-5)


def test_moe_ep_with_dtensor_leaves(reference, ranks):
    """``repro``'s draws placed by ``interop.sharded_tree`` on
    ``params_sharding`` of ``moe_init``'s axes (experts over data,
    ``expert_ff`` over model): each rank holds [4, 32, 12] and [4, 12, 32]
    expert blocks; the output and the gradients gathered whole equal
    ``moe_local``'s."""
    _, _, want = reference
    y_ref, g_ref = want["2d"]
    for r in ranks:
        y, _, g, shapes = r["dtensor"]
        assert shapes == {"wg": (32, 8), "w_in": (4, 32, 12), "w_gate": (4, 32, 12), "w_out": (4, 12, 32)}
        np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-5)
        for k in g_ref:
            assert float(np.abs(g_ref[k] - g[k]).max()) < 1e-3 * max(float(np.abs(g_ref[k]).max()), 1.0), k


def test_moe_apply_falls_back_with_dtensor_tokens(ranks):
    """Experts that do not divide over the expert axis (6 over 4): the
    whole tokens gathered through ``moe_local``, the answer laid out as
    the tokens came."""
    for r in ranks:
        assert r["fallback"] == ("DTensor", True, 0.0)


def test_moe_apply_falls_back_to_moe_local_where_the_reference_does():
    """No expert axis in the mesh, or experts that do not divide over it:
    ``moe_local`` on the whole tokens (no collective runs, so a one-rank
    stand-in mesh serves)."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed.sharding import ParallelCtx
    from repro_torch.models import moe as M

    import repro_torch.configs.base as tb

    cfg = _cfg(tb, "model")
    p, _ = M.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    x = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(1))
    want, want_aux = M.moe_local(p, x.reshape(-1, 32), cfg)
    for shape, axes in (((2,), ("data",)), ((3, 1), ("model", "data"))):
        mesh = DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape), mesh_dim_names=axes,
                          _init_backend=False, _rank=0)
        y, aux = M.moe_apply(p, x, cfg, ParallelCtx(mesh, cfg.rules))   # 8 experts % 3
        assert torch.equal(y, want.reshape(2, 8, 32)) and torch.equal(aux, want_aux)
