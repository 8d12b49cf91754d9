"""repro_torch.optim held against repro.optim on the CPU: AdamW and
Adafactor over 1 and 5 updates on trees of f32 and bf16 leaves of rank 1,
2 and 3, with the global-norm clip active and idle; Adafactor on a model
whose layers the reference stacks; the tree order of the global norm;
``clip_by_global_norm``; ``cosine_schedule`` at every step; error-feedback
top-k with planted ties; int8 compression.

Inputs are drawn once with numpy and fed to both packages.  Each update
is the reference's arithmetic op for op, but the reductions (the global
norm, Adafactor's means) and ``pow`` differ from XLA's CPU code in their
last bits.  So: AdamW's moments (elementwise, from the clipped
gradients) within ``F32_ULPS`` units in the last place; Adafactor's
factors, means over up to 512 entries summed in another order, within
``FACTOR_ULPS``; f32 parameters within ``F32_ULPS`` ULPs of the leaf's
largest |value| (``p - lr*u`` cancels where ``p`` and ``lr*u`` are close,
so an element's own ULPs say nothing there); bf16 parameters within one
bf16 ULP (the f32 update rounded once).  Compression is bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as JC
from repro.optim import optimizer as JO
from repro_torch import interop
from repro_torch.optim import compression as TC
from repro_torch.optim import optimizer as TO

from _torch_parity import lm_configs, lm_model, lm_reference_params, np_of, ulp_diff

pytestmark = pytest.mark.torch

F32_ULPS = 4
FACTOR_ULPS = 32
BF16_ULPS = 1
F32_EPS = 2.0 ** -23
SHAPES = {"a": (5,), "b": (4, 6), "c": (2, 3, 4)}


def tree_np(seed=0):
    """f32 and bf16 leaves of rank 1, 2 and 3 (bf16 as uint16 bits, rounded from f32 draws)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in SHAPES.items():
        out[f"f32_{name}"] = rng.standard_normal(shape).astype(np.float32)
        out[f"bf16_{name}"] = np_of(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))
    return out


def to_jax(tree):
    return {k: jnp.asarray(v.view(jnp.bfloat16) if v.dtype == np.uint16 else v) for k, v in tree.items()}


def to_port(tree):
    return {k: interop.tensor(v, "cpu") for k, v in tree.items()}


def grads_np(params, scale, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in params.items():
        g = scale * rng.standard_normal(v.shape)
        out[k] = np_of(jnp.asarray(g, jnp.bfloat16)) if v.dtype == np.uint16 else g.astype(np.float32)
    return out


def assert_params_close(want, got, ctx=""):
    """want: repro's parameters ({name: jnp}); got: the port's {name: tensor}."""
    for k, w in want.items():
        w = np_of(w)
        if w.dtype == np.uint16:
            d = ulp_diff(w, got[k])
            assert d <= BF16_ULPS, f"{k}: {d} bf16 ULPs > {BF16_ULPS} {ctx}"
        else:
            err = float(np.abs(got[k].detach().numpy().astype(np.float64) - w).max())
            assert err <= F32_ULPS * F32_EPS * float(np.abs(w).max()), f"{k}: {err:.3g} {ctx}"


def assert_state_ulps(want, got, bound, ctx=""):
    """want: repro's state tree ({name: jnp}); got: the port's {name: tensor}."""
    for k, w in want.items():
        d = ulp_diff(np_of(w), got[k])
        assert d <= bound, f"{k}: {d} ULPs > {bound} {ctx}"


@pytest.mark.parametrize("clip", ["idle", "active"])
@pytest.mark.parametrize("updates", [1, 5])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_repro(name, updates, clip):
    """``updates`` steps of the optimizer (global-norm clip at 1.0: the
    gradients' norm about 0.3, or about 30) from ``init``; parameters and
    every state leaf within the ULP bounds, the step count equal."""
    p = tree_np()
    jp, tp = to_jax(p), to_port(p)
    jo, to = JO.make_optimizer(name), TO.make_optimizer(name)
    js, ts = jo.init(jp), to.init(tp)
    scale = 0.03 if clip == "idle" else 3.0
    for i in range(updates):
        g = grads_np(p, scale, seed=10 + i)
        jp, js = jo.step(to_jax(g), js, jp, 1e-2)
        out, ts2 = to.step(to_port(g), ts, tp, 1e-2)
        assert out is tp and ts2 is ts                      # updated in place
    assert_params_close(jp, tp, f"{name} params")
    assert int(ts.step) == int(js.step) == updates
    for field in ts._fields[1:]:
        assert_state_ulps(getattr(js, field), getattr(ts, field), F32_ULPS if name == "adamw" else FACTOR_ULPS,
                          f"{name} {field}")
        for k, v in getattr(ts, field).items():
            assert v.dtype == torch.float32, (field, k)


def test_adafactor_factors_the_reference_stacked_leaves():
    """phi3.5-moe's smoke model: the reference stacks the layers, so its
    Adafactor factors a layer's norm scale [d] over [L, d] with the other
    layers' and clips by the RMS of the whole stacked leaf.  The port keys
    its state by those leaves and takes the same 3 updates: parameters,
    ``vr`` and ``vc`` within the bounds above.  ``interop.adafactor_state``
    carries the reference's state unchanged."""
    arch = "phi3.5-moe-42b-a6.6b"
    jcfg, tcfg = lm_configs(arch)
    p = lm_reference_params(arch, "float32")
    model = lm_model(p, tcfg)
    jo, to = JO.make_optimizer("adafactor"), TO.make_optimizer("adafactor")
    js, ts = jo.init(p), to.init(model)
    assert set(ts.vr) == set(TO.reference_leaves(model))
    assert ts.vr["blocks.ln1.scale"].shape == (jcfg.n_layers,) and ts.vc["blocks.ln1.scale"].shape == (jcfg.d_model,)
    rng = np.random.default_rng(3)
    for _ in range(3):
        g = jax.tree.map(lambda a: np.asarray(rng.standard_normal(a.shape) * 0.05, np.float32), p)
        p, js = jo.step(jax.tree.map(jnp.asarray, g), js, p, 1e-2)
        to.step(interop_grads(g, model), ts, model, 1e-2)
    want = dict(lm_model(p, tcfg).named_parameters())
    assert list(want) == [k for k, _ in model.named_parameters()]
    assert_params_close(want, dict(model.named_parameters()), "phi3.5-moe")
    carried = interop.adafactor_state(jax.tree.map(np_of, js), model, "cpu")
    assert int(carried.step) == 3
    for field in ("vr", "vc"):
        assert_state_ulps(getattr(carried, field), getattr(ts, field), FACTOR_ULPS, field)


def interop_grads(g, model):
    """The reference's gradient tree ``g`` as the port's ``{name: tensor}``."""
    carried = interop.transformer_params(jax.tree.map(np_of, g), model.cfg, "cpu")
    return dict(carried.named_parameters())


def test_named_leaves_follow_the_reference_tree_order():
    """The global norm sums the leaves in the reference's order: the port's
    names, layer index dropped, run in the order of
    ``jax.tree_util.tree_flatten_with_path``, each stacked leaf's layers
    together."""
    arch = "minicpm3-4b"
    jcfg, tcfg = lm_configs(arch)
    p = lm_reference_params(arch, "float32")
    paths = [".".join(str(k.key) for k in path) for path, _ in jax.tree_util.tree_flatten_with_path(p)[0]]
    groups = TO.reference_leaves(lm_model(p, tcfg))
    assert list(groups) == paths
    assert groups["blocks.ln1.scale"] == [f"blocks.{i}.ln1.scale" for i in range(jcfg.n_layers)]
    assert list(TO.named_leaves(lm_model(p, tcfg))) == [n for names in groups.values() for n in names]


@pytest.mark.parametrize("scale", [0.03, 3.0])
def test_clip_by_global_norm_matches_repro(scale):
    p = tree_np(1)
    g = grads_np(p, scale, seed=5)
    (jt, jn), (tt, tn) = JO.clip_by_global_norm(to_jax(g), 1.0), TO.clip_by_global_norm(to_port(g), 1.0)
    assert ulp_diff(np.asarray(jn), tn) <= F32_ULPS
    assert_state_ulps(jt, tt, F32_ULPS if scale > 1 else 0, f"scale {scale}")
    assert ulp_diff(np.asarray(JO.global_norm(to_jax(g))), TO.global_norm(to_port(g))) <= F32_ULPS


def test_cosine_schedule_at_every_step():
    """Every step up to ``total``, within ``F32_ULPS`` ULPs of the base lr:
    ``cos`` differs from XLA's by an ULP, and ``1 + cos`` cancels near the
    end of the decay."""
    jf, tf = JO.cosine_schedule(3e-4, 10, 50), TO.cosine_schedule(3e-4, 10, 50)
    for step in range(51):
        w, g = np.asarray(jf(step), np.float32), tf(step)
        assert g.dtype == torch.float32 and g.shape == ()
        assert abs(float(g) - float(w)) <= F32_ULPS * F32_EPS * 3e-4, (step, float(w), float(g))
    assert ulp_diff(np.asarray(jf(5)), tf(5)) == 0                # the warm-up: one product, one division


def planted_ties(n=64, seed=0):
    """A gradient whose |values| tie in runs (equal magnitudes of both
    signs, and zeros), so that the top-k's order among ties decides."""
    rng = np.random.default_rng(seed)
    g = rng.choice([-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0], size=n).astype(np.float32)
    g[::7] = rng.standard_normal(len(g[::7])).astype(np.float32)
    return g.reshape(8, n // 8)


@pytest.mark.parametrize("ratio", [0.05, 0.25, 0.5])
def test_topk_compress_breaks_ties_as_lax_top_k(ratio):
    g = planted_ties()
    jc, tc = JC.topk_compress(jnp.asarray(g), ratio), TC.topk_compress(torch.from_numpy(g), ratio)
    np.testing.assert_array_equal(np.asarray(jc.indices), tc.indices.numpy())
    assert tc.indices.dtype == torch.int32 and tc.shape == jc.shape
    np.testing.assert_array_equal(np.asarray(jc.values), tc.values.numpy())
    np.testing.assert_array_equal(np.asarray(JC.topk_decompress(jc)), TC.topk_decompress(tc).numpy())


def test_error_feedback_matches_repro_bit_for_bit():
    """Four EF top-k rounds over a tree of tied gradients: the wire and the
    residual equal bit for bit at every round."""
    rng = np.random.default_rng(1)
    tree = {"w": planted_ties(64, 1), "b": rng.choice([-1.0, 0.0, 1.0], size=12).astype(np.float32)}
    jr, tr = JC.ef_init(to_jax(tree)), TC.ef_init(to_port(tree))
    for i in range(4):
        g = {k: planted_ties(64, 10 + i) if k == "w" else rng.choice([-1.0, 0.5, 1.0], size=12).astype(np.float32)
             for k in tree}
        (jw, jr), (tw, tr) = JC.ef_compress_tree(to_jax(g), jr, 0.1), TC.ef_compress_tree(to_port(g), tr, 0.1)
        for k in tree:
            np.testing.assert_array_equal(np.asarray(jw[k]).view(np.int32), tw[k].numpy().view(np.int32))
            np.testing.assert_array_equal(np.asarray(jr[k]).view(np.int32), tr[k].numpy().view(np.int32))


def test_int8_compression_bit_for_bit():
    """Quantised values (half-way cases round to even), scale and round
    trip equal bit for bit, an all-zero leaf included."""
    rng = np.random.default_rng(2)
    g = rng.standard_normal((6, 9)).astype(np.float32)
    g[0, :4] = [127.0, 0.5, -1.5, 2.5]          # halves at the scale 1: rounded to even
    for x in (g, np.zeros((4,), np.float32)):
        jc, tc = JC.int8_compress(jnp.asarray(x)), TC.int8_compress(torch.from_numpy(x))
        assert tc.q.dtype == torch.int8
        np.testing.assert_array_equal(np.asarray(jc.q), tc.q.numpy())
        np.testing.assert_array_equal(np.asarray(jc.scale).view(np.int32), tc.scale.numpy().view(np.int32))
        np.testing.assert_array_equal(np.asarray(JC.int8_decompress(jc)).view(np.int32),
                                      TC.int8_decompress(tc).numpy().view(np.int32))
    tree = {"a": g, "b": g[:2].astype(np.float32) * 3}
    jt, tt = JC.int8_roundtrip_tree(to_jax(tree)), TC.int8_roundtrip_tree(to_port(tree))
    for k in tree:
        np.testing.assert_array_equal(np.asarray(jt[k]).view(np.int32), tt[k].numpy().view(np.int32))
