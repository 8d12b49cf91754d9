"""repro_torch.models.transformer held against repro.models.transformer:
``backbone`` at the 2-layer smoke configs of smollm-360m, qwen2.5-3b (with
non-zero QKV biases) and minicpm3-4b (MLA, untied head), in f32 and bf16,
on the reference's weights carried by ``interop.transformer_params``;
out-of-range token ids; parameter shapes and dtypes at the full published
configs, the two with experts included (``jax.eval_shape`` against the
port on the ``meta`` device); ``interop.transformer_params``' layout
checks; and the port's own draws.  The experts, the loss and the decode
steps have files of their own (``test_torch_moe.py``,
``test_torch_decode.py``).

Tolerances, of each row's largest |hidden| (the last axis):

* f32: ``F32_RTOL`` = 1e-5, as ``test_torch_layers.py``: the order of f32
  sums and the last bits of ``exp``/``rsqrt``/``sin``/``cos``.
* bf16: ``BF16_RTOL`` = 2^-5.  ``test_torch_layers.py`` allows four
  one-ULP flips (2^-8 each) for an attention layer; a block adds the FFN
  (two more roundings before its output projection) and two residual
  adds, and the final norm rescales the stream; a 2-layer backbone chains
  about eight such flips on the residual stream: 8 x 2^-8.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.distributed.sharding import ParallelCtx as JCtx
from repro.models import transformer as JT
import repro_torch.configs as tc
from repro_torch import interop
from repro_torch.distributed.sharding import ParallelCtx
from repro_torch.models import transformer as TT

from _torch_parity import np_of

pytestmark = pytest.mark.torch

F32_RTOL = 1e-5
BF16_RTOL = 2.0 ** -5
RTOL = {"float32": F32_RTOL, "bfloat16": BF16_RTOL}
SMOKE_ARCHS = ["smollm-360m", "qwen2.5-3b", "minicpm3-4b"]


def configs(arch, dtype):
    """(repro config, port config) of ``arch``'s smoke config in ``dtype``."""
    return (dataclasses.replace(jc.get_smoke_config(arch), dtype=dtype),
            dataclasses.replace(tc.get_smoke_config(arch), dtype=dtype))


def reference_params(jcfg, seed=0):
    """repro's parameters for ``jcfg``; QKV biases (zeros at init) are
    drawn so that they count."""
    p, _ = JT.init_transformer(jax.random.PRNGKey(seed), jcfg)
    if jcfg.qkv_bias:
        keys = jax.random.split(jax.random.PRNGKey(seed + 1), 3)
        for key, name in zip(keys, ("bq", "bk", "bv")):
            b = p["blocks"]["attn"][name]
            p["blocks"]["attn"][name] = (0.1 * jax.random.normal(key, b.shape)).astype(b.dtype)
    return p


def carried(p, tcfg):
    return interop.transformer_params(jax.tree.map(np_of, p), tcfg, "cpu")


def assert_close(want, got, rtol, ctx=""):
    w = np.asarray(np.asarray(want, np.float32), np.float64)
    g = got.detach().float().numpy().astype(np.float64)
    assert w.shape == g.shape, (w.shape, g.shape, ctx)
    assert np.all(np.isfinite(w)) and np.all(np.isfinite(g)), ctx
    scale = np.maximum(np.abs(w).max(axis=-1, keepdims=True), 1e-30)
    err = np.abs(g - w)
    assert np.all(err <= rtol * scale), f"error {np.max(err / scale):.3g} of row scale > {rtol:.3g} {ctx}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_backbone_matches_repro(arch, dtype):
    jcfg, tcfg = configs(arch, dtype)
    p = reference_params(jcfg)
    model = carried(p, tcfg)
    tok = np.random.default_rng(0).integers(0, jcfg.vocab_size, size=(3, 64)).astype(np.int32)
    want, jaux = JT.backbone(p, jnp.asarray(tok), jcfg, JCtx(None, jcfg.rules))
    with torch.no_grad():
        got, aux = TT.backbone(model, torch.from_numpy(tok), tcfg, ParallelCtx(None, tcfg.rules))
    assert got.dtype == TT.torch_dtype(dtype) and float(aux) == float(jaux) == 0.0
    assert_close(want, got, RTOL[dtype], f"{arch} {dtype}")


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_out_of_range_token_ids_index_as_repro(arch):
    """``embed[tokens]`` follows JAX: a negative id wraps once, then ids
    clamp to the table; torch indexing would raise."""
    jcfg, tcfg = configs(arch, "float32")
    p = reference_params(jcfg)
    model = carried(p, tcfg)
    v = jcfg.vocab_size
    tok = np.array([[v, -1, -(v + 1), 3, v + 7, -v, 0, 5]], np.int32)
    want, _ = JT.backbone(p, jnp.asarray(tok), jcfg, JCtx(None, {}))
    with torch.no_grad():
        got, _ = TT.backbone(model, torch.from_numpy(tok), tcfg, ParallelCtx(None, {}))
    assert_close(want, got, F32_RTOL)


def test_gather_rows_follows_jax_indexing():
    table = np.arange(4 * 2, dtype=np.float32).reshape(4, 2)
    ids = np.array([4, 5, -1, -5, 2, -4], np.int32)
    np.testing.assert_array_equal(TT.gather_rows(torch.from_numpy(table), torch.from_numpy(ids)).numpy(),
                                  np.asarray(jnp.asarray(table)[jnp.asarray(ids)]))
    assert TT.gather_rows(torch.from_numpy(table), torch.from_numpy(ids))[:, 0].tolist() == [6, 6, 6, 0, 4, 0]


def test_forward_is_backbone():
    _, tcfg = configs("smollm-360m", "float32")
    model, _ = TT.init_transformer(tcfg, seed=3, device="cpu")
    tok = torch.arange(16).reshape(2, 8)
    with torch.no_grad():
        assert torch.equal(model(tok)[0], TT.backbone(model, tok, tcfg, ParallelCtx(None, {}))[0])


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2.5-3b", "minicpm3-4b", "phi3.5-moe-42b-a6.6b",
                                  "arctic-480b"])
def test_full_config_shapes_equal_repro(arch):
    """The published configs' parameter trees, traced by ``jax.eval_shape``
    against the port's on the ``meta`` device (no memory): every leaf's
    shape (the reference's with its leading layer axis) and dtype (the
    config's; the MoE router ``wg`` in f32)."""
    jcfg, tcfg = jc.get_config(arch), tc.get_config(arch)
    shapes = jax.eval_shape(lambda k: JT.init_transformer(k, jcfg)[0], jax.random.PRNGKey(0))
    model, _ = TT.init_transformer(tcfg, device="meta")
    assert model.embed.device.type == "meta" and len(model.blocks) == jcfg.n_layers
    got = {"embed": model.embed, "ln_f": model.ln_f, "blocks": model.blocks[0]}
    if model.lm_head is not None:
        got["lm_head"] = model.lm_head
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    for path, leaf in flat:
        keys = [k.key for k in path]
        node = got
        for k in keys:
            node = getattr(node, k) if isinstance(node, TT.Block) else node[k]
        shape = (jcfg.n_layers, *node.shape) if keys[0] == "blocks" else tuple(node.shape)
        dtype = "float32" if keys[-1] == "wg" else tcfg.dtype
        assert shape == leaf.shape and str(leaf.dtype) == dtype, keys
        assert node.dtype == TT.torch_dtype(dtype)
    assert sum(p.numel() for p in model.parameters()) == sum(int(np.prod(leaf.shape)) for _, leaf in flat)


def test_init_transformer_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TT.init_transformer(tc.get_smoke_config("smollm-360m"))


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_init_transformer_draws_the_reference_scales(arch):
    """Not repro's draws (torch cannot reproduce jax.random) but its
    distributions: embed and lm_head N(0, 0.02^2), a dense layer
    N(0, 1/in_dim), norms 1, biases 0; one seed, one model."""
    tcfg = dataclasses.replace(tc.get_smoke_config(arch), d_model=256, d_ff=512)
    model, axes = TT.init_transformer(tcfg, seed=11, device="cpu")
    model.requires_grad_(False)
    again, _ = TT.init_transformer(tcfg, seed=11, device="cpu")
    other, _ = TT.init_transformer(tcfg, seed=12, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))
    assert not torch.equal(model.embed, other.embed)
    assert abs(float(model.embed.std()) - 0.02) < 0.002
    ffn = model.blocks[1].ffn
    assert abs(float(ffn["w_in"].std()) * np.sqrt(tcfg.d_model) - 1) < 0.05
    assert abs(float(ffn["w_out"].std()) * np.sqrt(tcfg.d_ff) - 1) < 0.05
    assert torch.equal(model.ln_f["scale"], torch.ones(tcfg.d_model))
    if tcfg.qkv_bias:
        assert float(model.blocks[0].attn["bq"].abs().max()) == 0.0
    if model.lm_head is not None:
        assert abs(float(model.lm_head.std()) - 0.02) < 0.002
    assert set(axes) == {"embed", "blocks", "ln_f"} | ({"lm_head"} if model.lm_head is not None else set())


# ---------------------------------------------------------------------------
# interop.transformer_params: the carrying function and its layout checks.
# ---------------------------------------------------------------------------

def test_transformer_params_splits_the_layer_axis_without_transposing():
    jcfg, tcfg = configs("minicpm3-4b", "float32")
    p = jax.tree.map(np_of, reference_params(jcfg))
    model = interop.transformer_params(p, tcfg, "cpu")
    for i, block in enumerate(model.blocks):
        np.testing.assert_array_equal(block.attn["wq_b"].detach().numpy(), p["blocks"]["attn"]["wq_b"][i])
        np.testing.assert_array_equal(block.attn["wo"].detach().numpy(), p["blocks"]["attn"]["wo"][i])
        np.testing.assert_array_equal(block.attn["q_norm"]["scale"].detach().numpy(),
                                      p["blocks"]["attn"]["q_norm"]["scale"][i])
        np.testing.assert_array_equal(block.ffn["w_gate"].detach().numpy(), p["blocks"]["ffn"]["w_gate"][i])
    np.testing.assert_array_equal(model.lm_head.detach().numpy(), p["lm_head"])


def test_transformer_params_carries_bf16_bits():
    jcfg, tcfg = configs("smollm-360m", "bfloat16")
    p = jax.tree.map(np_of, reference_params(jcfg))
    assert p["embed"].dtype == np.uint16
    model = interop.transformer_params(p, tcfg, "cpu")
    assert model.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(interop.to_numpy(model.embed), p["embed"])
    np.testing.assert_array_equal(interop.to_numpy(model.blocks[1].attn["wk"]), p["blocks"]["attn"]["wk"][1])


def _broken(p, path, fn):
    q = jax.tree.map(lambda a: a, p)
    node = q
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = fn(node[path[-1]])
    return q


@pytest.mark.parametrize("case", ["transposed wq", "one layer short", "missing wv", "extra name",
                                  "f32 bits for a bf16 model", "lm_head on a tied model"])
def test_transformer_params_refuses_a_wrong_layout(case):
    dtype = "bfloat16" if case == "f32 bits for a bf16 model" else "float32"
    jcfg, tcfg = configs("smollm-360m", dtype)
    p = jax.tree.map(np_of, reference_params(jcfg))
    if case == "transposed wq":
        p = _broken(p, ("blocks", "attn", "wq"), lambda a: np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
    elif case == "one layer short":
        p = jax.tree.map(lambda a: a, p)
        p["blocks"] = jax.tree.map(lambda a: a[:-1], p["blocks"])
    elif case == "missing wv":
        del p["blocks"]["attn"]["wv"]
    elif case == "extra name":
        p["blocks"]["attn"]["bq"] = np.zeros((jcfg.n_layers, 3, 32), np.float32)
    elif case == "f32 bits for a bf16 model":
        p["embed"] = p["embed"].astype(np.float32)
    else:
        p["lm_head"] = np.zeros((jcfg.d_model, jcfg.vocab_size), np.float32)
    with pytest.raises(ValueError):
        interop.transformer_params(p, tcfg, "cpu")
