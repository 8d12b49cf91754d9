"""repro_torch.models.moe held against repro.models.moe on the same numpy
inputs and weights, at the smoke configs of phi3.5-moe (4 experts) and
arctic-480b (8 experts, a dense residual FFN beside them): ``route`` (ids
equal, planted ties and a NaN row in ``lax.top_k``'s order), the
capacity expression over a sweep of token counts, ``sort_dispatch`` (slots,
tokens and validity equal, a planted overflow), ``fill_buffers`` (with its
payload form) and ``combine_buffers``, ``moe_local`` and ``moe_apply``
(no mesh; a mesh raises), in f32 and bf16; the backbone with experts,
its aux term included; ``interop.transformer_params`` on MoE trees; the
port's own draws.

Tolerances, of each row's largest |value| (the last axis):

* f32: ``F32_RTOL`` = 1e-5, as ``test_torch_transformer.py``: only the
  order of f32 sums (the router's, the expert GEMMs') and the last bits
  of ``exp`` differ.  The aux loss is one f32 scalar: within ``F32_RTOL``
  of it.
* bf16: ``BF16_RTOL`` = 2^-5, as for a 2-layer backbone in
  ``test_torch_transformer.py``: the expert FFN rounds as SwiGLU does
  (four roundings), then the weight product and the combine's add.
  Routing is decided in f32 on the same bf16 inputs, so the ids are
  still equal.

End to end (the backbone), the residual stream reaching a router differs
by the dtype's rounding, which flips a decision whose two experts'
probabilities lie that close (in bf16 it does in random 2-layer backbones
of a few dozen tokens, a fraction of a percent of the token's largest
probability apart).  ``_torch_parity.PinnedRoutes`` asserts that every
differing decision is such a near-tie, within ``NEAR_TIE`` (the dtype's
tolerance) of the token's largest probability, and routes the port as
``repro`` did; the aux loss, a mean of f32 probabilities of those inputs,
is held within ``AUX_RTOL`` (f32: ``F32_RTOL``; bf16: one bf16 ULP,
2^-8).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.distributed.sharding import ParallelCtx as JCtx
from repro.models import moe as JM
from repro.models import transformer as JT
import repro_torch.configs as tc
from repro_torch import interop
from repro_torch.distributed.sharding import ParallelCtx
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT

from _torch_parity import PinnedRoutes, lm_model, lm_reference_params, np_of

pytestmark = pytest.mark.torch

F32_RTOL = 1e-5
BF16_RTOL = 2.0 ** -5
RTOL = {"float32": F32_RTOL, "bfloat16": BF16_RTOL}
NEAR_TIE = {"float32": F32_RTOL, "bfloat16": BF16_RTOL}
AUX_RTOL = {"float32": F32_RTOL, "bfloat16": 2.0 ** -8}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
MOE_ARCHS = ["phi3.5-moe-42b-a6.6b", "arctic-480b"]


def configs(arch, dtype="float32", **kw):
    """(repro config, port config) of ``arch``'s smoke config."""
    return (dataclasses.replace(jc.get_smoke_config(arch), dtype=dtype, **kw),
            dataclasses.replace(tc.get_smoke_config(arch), dtype=dtype, **kw))


def _pair(a, dtype):
    """One numpy array as (jnp array, CPU tensor) of ``dtype``; bf16 is
    rounded once by JAX and carried as its bits."""
    j = jnp.asarray(a, JDT[dtype])
    return j, interop.tensor(np_of(j), "cpu")


def moe_params(cfg, dtype, seed=0):
    """numpy expert weights of ``cfg`` at the reference's scales, as
    (jnp tree, tensor tree): the router in f32, the experts in ``dtype``."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    w = {"wg": (rng.standard_normal((d, e)) / np.sqrt(d), "float32"),
         "w_in": (rng.standard_normal((e, d, f)) / np.sqrt(d), dtype),
         "w_gate": (rng.standard_normal((e, d, f)) / np.sqrt(d), dtype),
         "w_out": (rng.standard_normal((e, f, d)) / np.sqrt(f), dtype)}
    pairs = {k: _pair(a, dt) for k, (a, dt) in w.items()}
    return {k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()}


def assert_close(want, got, rtol, ctx=""):
    w = np.asarray(np.asarray(want, np.float32), np.float64)
    g = got.detach().float().numpy().astype(np.float64)
    assert w.shape == g.shape, (w.shape, g.shape, ctx)
    assert np.all(np.isfinite(w)) and np.all(np.isfinite(g)), ctx
    scale = np.maximum(np.abs(w).max(axis=-1, keepdims=True), 1e-30)
    err = np.abs(g - w)
    assert np.all(err <= rtol * scale), f"error {np.max(err / scale):.3g} of row scale > {rtol:.3g} {ctx}"


def assert_dispatch_equal(want, got, ctx=""):
    for name in ("slot", "token", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(want, name)), getattr(got, name).numpy(),
                                      err_msg=f"{name} {ctx}")
    assert got.slot.dtype == got.token.dtype == torch.int32 and got.valid.dtype == torch.bool


# ---------------------------------------------------------------------------
# route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(RTOL))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_matches_repro(arch, dtype):
    jcfg, tcfg = configs(arch, dtype)
    jp, tp = moe_params(tcfg, dtype)
    jx, tx = _pair(np.random.default_rng(1).standard_normal((96, tcfg.d_model)), dtype)
    ids, w, aux = JM.route(jx, jp["wg"], tcfg.top_k)
    tids, tw, taux = TM.route(tx, tp["wg"], tcfg.top_k)
    assert tids.dtype == torch.int32 and tw.dtype == tx.dtype and taux.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(ids), tids.numpy())
    assert_close(w, tw, RTOL[dtype])
    assert abs(float(taux) - float(aux)) <= F32_RTOL * abs(float(aux))


def test_route_breaks_ties_toward_the_lower_expert():
    """Planted equal router logits (duplicate router columns) tie the
    probabilities exactly in both packages: ``lax.top_k`` takes the lower
    expert id first, and so must the port; a NaN token row orders by the
    NaN's bits (all equal: experts 0 and 1)."""
    jcfg, tcfg = configs("arctic-480b")
    rng = np.random.default_rng(2)
    wg = rng.standard_normal((tcfg.d_model, tcfg.n_experts)) / np.sqrt(tcfg.d_model)
    wg[:, 5] = wg[:, 2]          # experts 2 and 5 tie on every token
    wg[:, 7] = wg[:, 2]          # and 7
    wg[:, 6] = wg[:, 1]
    x = rng.standard_normal((64, tcfg.d_model))
    x[:, :] += 3.0 * np.outer(np.sign(rng.standard_normal(64)), wg[:, 2] / np.linalg.norm(wg[:, 2]))
    x[9] = np.nan
    (jwg, twg), (jx, tx) = _pair(wg, "float32"), _pair(x, "float32")
    ids, _, _ = JM.route(jx, jwg, 2)
    tids, _, _ = TM.route(tx, twg, 2)
    np.testing.assert_array_equal(np.asarray(ids), tids.numpy())
    top = tids.numpy()
    tied = (top[:, 0] == 2) | (top[:, 0] == 1)
    assert tied.sum() > 16 and tids[9].tolist() == [0, 1]
    # a tie among 2, 5 and 7 keeps the two lowest ids, in order
    assert all(r[1] == 5 for r in top[top[:, 0] == 2])


# ---------------------------------------------------------------------------
# capacity, sort_dispatch, fill_buffers, combine_buffers
# ---------------------------------------------------------------------------

class _Stop(Exception):
    pass


T_SWEEP = list(range(1, 129)) + list(range(129, 1025, 37))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_capacity_matches_repro_over_a_sweep_of_t(arch, monkeypatch):
    """The capacity that ``moe_local`` gives ``sort_dispatch`` in each
    package, for every token count from 1 to 128 and some to 1,024, and capacity factors whose
    products round in Python floats (1.1, 1.15), at the smoke config's
    expert count and the published one.  ``route`` is stubbed and the
    dispatch stops the call: only the expression runs (repro traced by
    ``jax.eval_shape``)."""
    seen = {"repro": [], "port": []}

    def stop(name):
        def record(bucket_ids, token_ids, weights, n_buckets, capacity):
            seen[name].append(capacity)
            raise _Stop
        return record

    monkeypatch.setattr(JM, "route", lambda x, wg, k: (jnp.zeros((x.shape[0], k), jnp.int32),
                                                        jnp.zeros((x.shape[0], k), x.dtype), 0.0))
    monkeypatch.setattr(TM, "route", lambda x, wg, k: (torch.zeros(x.shape[0], k, dtype=torch.int32),
                                                        torch.zeros(x.shape[0], k), 0.0))
    monkeypatch.setattr(JM, "sort_dispatch", stop("repro"))
    monkeypatch.setattr(TM, "sort_dispatch", stop("port"))
    n_cases = 0
    for experts in (tc.get_smoke_config(arch).n_experts, tc.get_config(arch).n_experts):
        for cf in (1.25, 2.0, 1.1, 1.15, 0.3):
            jcfg, tcfg = configs(arch, capacity_factor=cf, n_experts=experts, d_model=8)
            for t in T_SWEEP:
                with pytest.raises(_Stop):
                    jax.eval_shape(lambda x: JM.moe_local({"wg": None}, x, jcfg),
                                   jax.ShapeDtypeStruct((t, 8), jnp.float32))
                with pytest.raises(_Stop):
                    TM.moe_local({"wg": None}, torch.zeros(t, 8), tcfg)
                n_cases += 1
    assert seen["port"] == seen["repro"] and len(seen["port"]) == n_cases
    assert all(c % 8 == 0 and c >= 8 for c in seen["port"])


def _planted_buckets(n_pairs, n_buckets, seed):
    """Bucket ids where bucket 1 holds more than half the pairs (so it
    overflows a capacity of n_pairs / n_buckets) and the last is empty."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, n_buckets - 1, n_pairs)
    b[rng.random(n_pairs) < 0.55] = 1
    return b.astype(np.int32)


@pytest.mark.parametrize("capacity", [8, 16, 64])
def test_sort_dispatch_matches_repro(capacity):
    n_pairs, n_buckets = 96, 6
    b = _planted_buckets(n_pairs, n_buckets, 3)
    tok = np.repeat(np.arange(n_pairs // 2, dtype=np.int32), 2)
    w = np.random.default_rng(4).random(n_pairs).astype(np.float32)
    want = JM.sort_dispatch(jnp.asarray(b), jnp.asarray(tok), jnp.asarray(w), n_buckets, capacity)
    got = TM.sort_dispatch(torch.from_numpy(b), torch.from_numpy(tok), torch.from_numpy(w), n_buckets, capacity)
    assert_dispatch_equal(want, got, f"capacity {capacity}")
    np.testing.assert_array_equal(np.asarray(want.weight), got.weight.numpy())
    dropped = int((~got.valid).sum())
    assert (dropped > 0) == (capacity < np.bincount(b).max())
    assert bool((got.slot[~got.valid] == n_buckets * capacity).all())


@pytest.mark.parametrize("with_payload", [False, True])
@pytest.mark.parametrize("dtype", list(RTOL))
def test_fill_buffers_matches_repro(dtype, with_payload):
    """Buffers are copies of token rows: equal bit for bit, the overflowed
    pairs nowhere, empty slots zero (payload -1)."""
    n_pairs, n_buckets, cap, d = 64, 4, 8, 24
    b = _planted_buckets(n_pairs, n_buckets, 5)
    tok = np.repeat(np.arange(n_pairs // 2, dtype=np.int32), 2)
    jx, tx = _pair(np.random.default_rng(6).standard_normal((n_pairs // 2, d)), dtype)
    payload = (np.arange(n_pairs) % 5).astype(np.int32)
    disp_j = JM.sort_dispatch(jnp.asarray(b), jnp.asarray(tok), jnp.ones(n_pairs), n_buckets, cap)
    disp_t = TM.sort_dispatch(torch.from_numpy(b), torch.from_numpy(tok), torch.ones(n_pairs), n_buckets, cap)
    if with_payload:
        want, want_pl = JM.fill_buffers(disp_j, jx, n_buckets, cap, payload=jnp.asarray(payload))
        got, got_pl = TM.fill_buffers(disp_t, tx, n_buckets, cap, payload=torch.from_numpy(payload))
        np.testing.assert_array_equal(np.asarray(want_pl), got_pl.numpy())
        assert got_pl.dtype == torch.int32
    else:
        want = JM.fill_buffers(disp_j, jx, n_buckets, cap)
        got = TM.fill_buffers(disp_t, tx, n_buckets, cap)
    assert got.shape == (n_buckets, cap, d) and got.dtype == tx.dtype
    np.testing.assert_array_equal(np_of(want), np_of(got))


@pytest.mark.parametrize("dtype", list(RTOL))
def test_combine_buffers_matches_repro(dtype):
    """The weighted scatter-add in the buffers' dtype; two pairs a token
    (top 2), so the adds' order cannot matter: equal bit for bit."""
    n_tokens, n_buckets, cap, d = 40, 4, 16, 24
    b = _planted_buckets(2 * n_tokens, n_buckets, 7)
    tok = np.repeat(np.arange(n_tokens, dtype=np.int32), 2)
    rng = np.random.default_rng(8)
    jw, tw = _pair(rng.random(2 * n_tokens), dtype)
    jo, to = _pair(rng.standard_normal((n_buckets, cap, d)), dtype)
    disp_j = JM.sort_dispatch(jnp.asarray(b), jnp.asarray(tok), jw, n_buckets, cap)
    disp_t = TM.sort_dispatch(torch.from_numpy(b), torch.from_numpy(tok), tw, n_buckets, cap)
    assert int((~disp_t.valid).sum()) > 0
    want = JM.combine_buffers(disp_j, jo, n_tokens)
    got = TM.combine_buffers(disp_t, to, n_tokens)
    assert got.dtype == to.dtype
    np.testing.assert_array_equal(np_of(want), np_of(got))


# ---------------------------------------------------------------------------
# moe_local, moe_apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(RTOL))
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("t", [5, 200])
def test_moe_local_matches_repro(arch, dtype, t):
    jcfg, tcfg = configs(arch, dtype)
    jp, tp = moe_params(tcfg, dtype, seed=9)
    jx, tx = _pair(np.random.default_rng(10).standard_normal((t, tcfg.d_model)), dtype)
    want, aux = jax.jit(lambda p, x: JM.moe_local(p, x, jcfg))(jp, jx)
    got, taux = TM.moe_local(tp, tx, tcfg)
    assert got.dtype == tx.dtype
    assert_close(want, got, RTOL[dtype], f"{arch} {dtype} t={t}")
    assert abs(float(taux) - float(aux)) <= F32_RTOL * abs(float(aux))


def test_moe_local_with_capacity_drops_matches_repro():
    """A capacity factor of 0.3 drops most pairs: the dropped pairs
    contribute nothing, in both packages."""
    jcfg, tcfg = configs("phi3.5-moe-42b-a6.6b", capacity_factor=0.3)
    jp, tp = moe_params(tcfg, "float32", seed=11)
    jx, tx = _pair(np.random.default_rng(12).standard_normal((64, tcfg.d_model)), "float32")
    want, _ = jax.jit(lambda p, x: JM.moe_local(p, x, jcfg))(jp, jx)
    got, _ = TM.moe_local(tp, tx, tcfg)
    assert_close(want, got, F32_RTOL)
    assert int((got.abs().amax(1) == 0).sum()) > 0   # a token whose pairs were all dropped


@pytest.mark.parametrize("dtype", list(RTOL))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_repro(arch, dtype):
    jcfg, tcfg = configs(arch, dtype)
    jp, tp = moe_params(tcfg, dtype, seed=13)
    jx, tx = _pair(np.random.default_rng(14).standard_normal((3, 16, tcfg.d_model)), dtype)
    want, aux = jax.jit(lambda p, x: JM.moe_apply(p, x, jcfg, JCtx(None, jcfg.rules)))(jp, jx)
    got, taux = TM.moe_apply(tp, tx, tcfg, ParallelCtx(None, tcfg.rules))
    assert got.shape == (3, 16, tcfg.d_model)
    assert_close(want, got, RTOL[dtype])
    assert abs(float(taux) - float(aux)) <= F32_RTOL * abs(float(aux))


def test_moe_init_draws_the_reference_scales():
    _, tcfg = configs("arctic-480b", "bfloat16", d_model=256, moe_d_ff=384)
    p, a = TM.moe_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16, "cpu")
    jp, ja = JM.moe_init(jax.random.PRNGKey(0), jc.get_smoke_config("arctic-480b"), jnp.bfloat16)
    assert a == ja and set(p) == set(jp)
    assert p["wg"].dtype == torch.float32 and p["w_in"].dtype == torch.bfloat16
    assert p["w_out"].shape == (tcfg.n_experts, 384, 256)
    assert abs(float(p["wg"].std()) * 16 - 1) < 0.1
    assert abs(float(p["w_gate"].float().std()) * 16 - 1) < 0.05
    assert abs(float(p["w_out"].float().std()) * np.sqrt(384) - 1) < 0.05


# ---------------------------------------------------------------------------
# The backbone with experts; interop.transformer_params on MoE trees.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(RTOL))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_backbone_with_experts_matches_repro(arch, dtype, monkeypatch):
    """The 2-layer backbone on the reference's weights, routes pinned
    (``PinnedRoutes``: a decision may differ only on a near-tie, within
    ``NEAR_TIE`` of the token's largest probability).  The aux loss is a mean
    of f32 probabilities of inputs that differ by the dtype's rounding:
    within ``AUX_RTOL`` of it."""
    jcfg, tcfg = configs(arch, dtype)
    p = lm_reference_params(arch, dtype)
    model = lm_model(p, tcfg)
    tok = np.random.default_rng(15).integers(0, jcfg.vocab_size, size=(3, 32)).astype(np.int32)
    pins = PinnedRoutes(monkeypatch, NEAR_TIE[dtype])
    want, aux = JT.backbone(p, jnp.asarray(tok), jcfg, JCtx(None, jcfg.rules))
    with torch.no_grad():
        got, taux = TT.backbone(model, torch.from_numpy(tok), tcfg, ParallelCtx(None, tcfg.rules))
    pins.done()
    assert float(aux) > 0.5
    assert abs(float(taux) - float(aux)) <= AUX_RTOL[dtype] * abs(float(aux))
    assert_close(want, got, RTOL[dtype], f"{arch} {dtype}")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_transformer_params_carries_experts(arch):
    jcfg, tcfg = configs(arch, "bfloat16")
    p = jax.tree.map(np_of, lm_reference_params(arch, "bfloat16"))
    assert p["blocks"]["moe"]["wg"].dtype == np.float32 and p["blocks"]["moe"]["w_in"].dtype == np.uint16
    model = interop.transformer_params(p, tcfg, "cpu")
    for i, block in enumerate(model.blocks):
        assert block.moe["wg"].dtype == torch.float32 and block.moe["w_out"].dtype == torch.bfloat16
        np.testing.assert_array_equal(block.moe["wg"].detach().numpy(), p["blocks"]["moe"]["wg"][i])
        np.testing.assert_array_equal(interop.to_numpy(block.moe["w_gate"]), p["blocks"]["moe"]["w_gate"][i])
        assert ("ln3" in block._modules) == jcfg.dense_residual == ("ffn" in block._modules)
        if jcfg.dense_residual:
            np.testing.assert_array_equal(interop.to_numpy(block.ffn["w_in"]), p["blocks"]["ffn"]["w_in"][i])


@pytest.mark.parametrize("case", ["router in bf16 bits", "missing w_gate", "dense ffn on phi", "no ln3 on arctic",
                                  "transposed w_out"])
def test_transformer_params_refuses_a_wrong_moe_layout(case):
    arch = "arctic-480b" if case == "no ln3 on arctic" else "phi3.5-moe-42b-a6.6b"
    jcfg, tcfg = configs(arch, "bfloat16")
    p = jax.tree.map(np_of, lm_reference_params(arch, "bfloat16"))
    moe = p["blocks"]["moe"]
    if case == "router in bf16 bits":
        moe["wg"] = np_of(jnp.asarray(moe["wg"], jnp.bfloat16))
    elif case == "missing w_gate":
        del moe["w_gate"]
    elif case == "dense ffn on phi":
        p["blocks"]["ffn"] = {"w_in": np.zeros((jcfg.n_layers, jcfg.d_model, jcfg.d_ff), np.uint16)}
    elif case == "no ln3 on arctic":
        del p["blocks"]["ln3"]
    else:
        moe["w_out"] = np.ascontiguousarray(moe["w_out"].transpose(0, 1, 3, 2))
    with pytest.raises(ValueError):
        interop.transformer_params(p, tcfg, "cpu")
