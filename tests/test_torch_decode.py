"""The port's KV-cache decode steps held against repro on the same numpy
inputs, at the smoke configs of all five LM architectures (smollm-360m,
qwen2.5-3b with non-zero QKV biases, minicpm3-4b's MLA, phi3.5-moe's and
arctic-480b's experts, arctic's heads padded 6 -> 8), in f32 and bf16, on
the reference's weights carried by ``interop.transformer_params`` and
caches carried by ``interop.kv_cache``:

* ``gqa_decode`` and ``mla_decode`` alone (MLA also with heads padded
  4 -> 6) at ``pos`` = 0, Smax - 1, Smax and Smax + 3: the clamped write
  lands where ``dynamic_update_slice`` puts it and no other cache row
  changes (bit for bit);
* the chunk-skipping GQA attention equal bit for bit to the full scan,
  and blind to what lies past the last valid chunk;
* an 8-step ``decode_step`` loop from ``pos`` = 0 (logits and caches),
  one step at the cache's edges from a random cache, ``init_cache`` and
  ``cache_axes``, the in-place cache, ``interop.kv_cache``.

The prefill step and the losses are in ``test_torch_lm_loss.py``.

Tolerances, of each row's largest |value| (the last axis), as in
``test_torch_layers.py`` and ``test_torch_transformer.py``: f32
``F32_RTOL`` = 1e-5 (the order of f32 sums, the last bits of ``exp``,
``rsqrt``, ``sin``, ``cos``); bf16 2^-6 for one layer (four one-ULP
flips of 2^-8) and 2^-5 for a 2-layer model (about eight).  With experts,
routes are pinned by ``_torch_parity.PinnedRoutes`` (a decision may
differ only on a near-tie, within the dtype's tolerance of the token's
largest probability; ``test_torch_moe.py`` says why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.distributed.sharding import ParallelCtx as JCtx
from repro.models import layers as JL
from repro.models import transformer as JT
import repro_torch.configs as tc
from repro_torch import interop
from repro_torch.distributed.sharding import ParallelCtx
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

from _torch_parity import PinnedRoutes, lm_configs, lm_model, lm_reference_params, np_of

pytestmark = pytest.mark.torch

F32_RTOL = 1e-5
LAYER_RTOL = {"float32": F32_RTOL, "bfloat16": 2.0 ** -6}
MODEL_RTOL = {"float32": F32_RTOL, "bfloat16": 2.0 ** -5}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
ARCHS = ["smollm-360m", "qwen2.5-3b", "minicpm3-4b", "phi3.5-moe-42b-a6.6b", "arctic-480b"]
DTYPES = list(MODEL_RTOL)
SMAX = 64            # two chunks of the smoke configs' attn_chunk_kv = 32
EDGES = [0, SMAX - 1, SMAX, SMAX + 3]


configs, reference_params, carried = lm_configs, lm_reference_params, lm_model


def tensors(tree):
    """A jnp tree -> the same tree of CPU tensors (bf16 as its bits)."""
    return jax.tree.map(lambda a: interop.tensor(np_of(a), "cpu"), tree)


def assert_close(want, got, rtol, ctx=""):
    w = np.asarray(np.asarray(want, np.float32), np.float64)
    g = got.detach().float().numpy().astype(np.float64)
    assert w.shape == g.shape, (w.shape, g.shape, ctx)
    fin = np.isfinite(w)
    np.testing.assert_array_equal(fin, np.isfinite(g), err_msg=ctx)
    w, g = np.where(fin, w, 0.0), np.where(fin, g, 0.0)
    scale = np.maximum(np.abs(w).max(axis=-1, keepdims=True), 1e-30)
    err = np.abs(g - w)
    assert np.all(err <= rtol * scale), f"error {np.max(err / scale):.3g} of row scale > {rtol:.3g} {ctx}"


def pins_for(arch, dtype, monkeypatch):
    """PinnedRoutes for a config with experts, else None."""
    return PinnedRoutes(monkeypatch, MODEL_RTOL[dtype]) if jc.get_smoke_config(arch).is_moe else None


def random_cache(jcfg, b, smax, seed, dtype):
    """repro's ``init_cache`` filled with N(0, 0.25) values in ``dtype``
    (a cache of earlier steps), as a jnp KVCache."""
    rng = np.random.default_rng(seed)
    zero = JT.init_cache(jcfg, b, smax)
    return JT.KVCache(*(None if a is None else jnp.asarray(0.5 * rng.standard_normal(a.shape), JDT[dtype])
                        for a in zero))


def port_cache(cache, tcfg):
    return interop.kv_cache(jax.tree.map(np_of, cache), tcfg, "cpu")


def assert_cache_matches(want, got, rtol, slots, ctx=""):
    """Rows at ``slots`` within ``rtol`` of their scale; every other row
    of the cache bit for bit."""
    for name in TT.KVCache._fields:
        w, g = getattr(want, name), getattr(got, name)
        assert (w is None) == (g is None), name
        if w is None:
            continue
        w, g = np_of(w), np_of(g)
        other = np.ones(w.shape[2], bool)
        other[list(slots)] = False
        np.testing.assert_array_equal(w[:, :, other], g[:, :, other], err_msg=f"{name} {ctx}")
        for s in slots:
            want_row = w[:, :, s].view(jnp.bfloat16) if w.dtype == np.uint16 else w[:, :, s]
            got_row = torch.from_numpy(g[:, :, s].view(np.int16).copy()).view(torch.bfloat16) \
                if g.dtype == np.uint16 else torch.from_numpy(g[:, :, s])
            assert_close(np.asarray(want_row, np.float32).reshape(-1, w.shape[-1]),
                         got_row.float().reshape(-1, w.shape[-1]), rtol, f"{name} row {s} {ctx}")


# ---------------------------------------------------------------------------
# gqa_decode, mla_decode: one layer.
# ---------------------------------------------------------------------------

LAYER_CASES = {
    "qwen2.5-3b": {},                          # GQA, QKV bias
    "arctic-480b": {},                         # GQA, heads padded 6 -> 8
    "minicpm3-4b": {},                         # MLA
    "minicpm3-4b-padded": {"pad_heads_to": 6},  # MLA, heads padded 4 -> 6
}


@pytest.mark.parametrize("pos", EDGES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_decode_layer_matches_repro(case, dtype, pos):
    arch = case.removesuffix("-padded")
    kw = LAYER_CASES[case]
    jcfg, tcfg = configs(arch, dtype, **kw)
    ap = jax.tree.map(lambda a: a[0], reference_params(arch, dtype, **kw)["blocks"]["attn"])
    cache = random_cache(jcfg, 2, SMAX, 1, dtype)
    rng = np.random.default_rng(2)
    jx = jnp.asarray(rng.standard_normal((2, 1, jcfg.d_model)), JDT[dtype])
    tx = interop.tensor(np_of(jx), "cpu")
    tcache = port_cache(cache, tcfg)
    if jcfg.attention == "mla":
        want, c1, c2 = JL.mla_decode(ap, jx, cache.ckv[0], cache.kpe[0], pos, jcfg, JCtx(None, {}))
        got, t1, t2 = TL.mla_decode(tensors(ap), tx, tcache.ckv[0], tcache.kpe[0], pos, tcfg, ParallelCtx(None, {}))
        assert t1.data_ptr() == tcache.ckv[0].data_ptr()
    else:
        want, c1, c2 = JL.gqa_decode(ap, jx, cache.k[0], cache.v[0], pos, jcfg, JCtx(None, {}))
        got, t1, t2 = TL.gqa_decode(tensors(ap), tx, tcache.k[0], tcache.v[0], pos, tcfg, ParallelCtx(None, {}))
        assert t1.data_ptr() == tcache.k[0].data_ptr()
    assert got.dtype == tx.dtype and got.shape == (2, 1, jcfg.d_model)
    assert_close(want, got, LAYER_RTOL[dtype], case)
    slot = min(pos, SMAX - 1)
    fields = ("ckv", "kpe") if jcfg.attention == "mla" else ("k", "v")
    assert_cache_matches(JT.KVCache(**{f: c[None] for f, c in zip(fields, (c1, c2))}),
                         TT.KVCache(**{f: c[None] for f, c in zip(fields, (t1, t2))}),
                         LAYER_RTOL[dtype], [slot], case)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("valid", [1, 31, 32, 33, 64, 70])
def test_decode_attention_skipping_equals_the_full_scan(dtype, valid):
    """Scanning through the last chunk that holds a valid key gives the
    full scan's result bit for bit, and what lies past that chunk (NaN
    here) is never read."""
    rng = np.random.default_rng(3)
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    q = torch.from_numpy(rng.standard_normal((2, 1, 8, 32))).to(dt)
    k, v = (torch.from_numpy(rng.standard_normal((2, 96, 2, 32))).to(dt) for _ in range(2))
    full = TL.decode_attention(q, k, v, valid, 32, n_chunks=3)
    got = TL.decode_attention(q, k, v, valid, 32)
    assert torch.equal(got, full) and got.dtype == dt
    used = min(3, -(-valid // 32)) * 32
    k[:, used:], v[:, used:] = torch.nan, torch.nan
    assert torch.equal(TL.decode_attention(q, k, v, valid, 32), full)


def test_decode_attention_matches_the_repeated_flash_attention():
    """Per KV group without the repeat: ``flash_attention`` over the
    repeated cache, as ``repro`` attends, on the same numbers."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((2, 1, 6, 16))).float()
    k, v = (torch.from_numpy(rng.standard_normal((2, 64, 2, 16))).float() for _ in range(2))
    want = TL.flash_attention(q, k.repeat_interleave(3, 2), v.repeat_interleave(3, 2), causal=False,
                              kv_valid_len=torch.tensor([40, 40]), chunk_q=1, chunk_kv=32)
    assert_close(want.numpy(), TL.decode_attention(q, k, v, 40, 32), F32_RTOL)


def test_decode_keeps_the_chunk_assertion():
    """A cache length that the chunk does not divide is refused, as the
    reference's ``flash_attention`` refuses it (no silent pad)."""
    _, tcfg = configs("smollm-360m")
    model, _ = TT.init_transformer(tcfg, device="cpu")
    cache = TT.init_cache(tcfg, 1, 48, device="cpu")
    with pytest.raises(AssertionError):
        TT.decode_step(model, cache, torch.zeros(1, 1, dtype=torch.long), 0, tcfg, ParallelCtx(None, {}))


# ---------------------------------------------------------------------------
# decode_step, init_cache, cache_axes.
# ---------------------------------------------------------------------------

def _jit_decode(jcfg):
    ctx = JCtx(None, jcfg.rules)
    return jax.jit(lambda p, c, t, pos: JT.decode_step(p, c, t, pos, jcfg, ctx))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_loop_matches_repro(arch, dtype, monkeypatch):
    """8 steps from an empty cache, each step's logits and the final cache."""
    jcfg, tcfg = configs(arch, dtype)
    p = reference_params(arch, dtype)
    model = carried(p, tcfg)
    pins = pins_for(arch, dtype, monkeypatch)
    step = _jit_decode(jcfg)
    tok = np.random.default_rng(5).integers(0, jcfg.vocab_size, size=(3, 8)).astype(np.int32)
    cache = JT.init_cache(jcfg, 3, SMAX)
    tcache = port_cache(cache, tcfg)
    ctx = ParallelCtx(None, tcfg.rules)
    for t in range(8):
        want, cache = step(p, cache, jnp.asarray(tok[:, t:t + 1]), t)
        with torch.no_grad():
            got, tcache2 = TT.decode_step(model, tcache, torch.from_numpy(tok[:, t:t + 1]), t, tcfg, ctx)
        assert tcache2 is tcache and got.dtype == torch.float32 and got.shape == (3, tcfg.padded_vocab)
        assert_close(want, got, MODEL_RTOL[dtype], f"{arch} {dtype} step {t}")
    assert_cache_matches(cache, tcache, MODEL_RTOL[dtype], range(8), f"{arch} {dtype}")
    if pins is not None:
        pins.done()


@pytest.mark.parametrize("pos", EDGES[1:])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_at_the_cache_edges_matches_repro(arch, pos, monkeypatch):
    """One step from a random cache at Smax - 1 (the last row), Smax and
    Smax + 3 (the write clamps to the last row; RoPE takes ``pos``; every
    row is valid)."""
    jcfg, tcfg = configs(arch)
    p = reference_params(arch, "float32")
    pins = pins_for(arch, "float32", monkeypatch)
    cache = random_cache(jcfg, 2, SMAX, 6, "float32")
    tcache = port_cache(cache, tcfg)
    tok = np.array([[3], [jcfg.vocab_size - 1]], np.int32)
    want, cache = _jit_decode(jcfg)(p, cache, jnp.asarray(tok), pos)
    with torch.no_grad():
        got, _ = TT.decode_step(carried(p, tcfg), tcache, torch.from_numpy(tok), pos, tcfg,
                                ParallelCtx(None, tcfg.rules))
    assert_close(want, got, F32_RTOL, f"{arch} pos {pos}")
    assert_cache_matches(cache, tcache, F32_RTOL, [SMAX - 1], f"{arch} pos {pos}")
    if pins is not None:
        pins.done()


def test_decode_step_writes_the_clamped_row_and_ropes_the_real_position():
    """At pos = Smax + 3 the new key lands in the last row, rotated for
    position Smax + 3 (not Smax - 1)."""
    _, tcfg = configs("smollm-360m")
    model, _ = TT.init_transformer(tcfg, seed=1, device="cpu")
    ctx = ParallelCtx(None, {})
    tok = torch.tensor([[7]])
    rows = {}
    for pos in (SMAX - 1, SMAX + 3):
        cache = TT.init_cache(tcfg, 1, SMAX, device="cpu")
        with torch.no_grad():
            TT.decode_step(model, cache, tok, pos, tcfg, ctx)
        assert float(cache.k[:, :, :SMAX - 1].abs().max()) == 0.0
        rows[pos] = cache.k[0, 0, SMAX - 1].clone()
    h = TL.rmsnorm(model.blocks[0].ln1, TT.gather_rows(model.embed, tok), tcfg.norm_eps)
    k = torch.einsum("bsd,dhk->bshk", h, model.blocks[0].attn["wk"])
    want = TL.apply_rope(k, torch.tensor([[SMAX + 3]]), tcfg.rope_theta)[0, 0]
    assert torch.equal(rows[SMAX + 3], want.detach()) and not torch.equal(rows[SMAX - 1], rows[SMAX + 3])


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_and_cache_axes_match_repro(arch):
    jcfg, tcfg = configs(arch, "bfloat16")
    want = JT.init_cache(jcfg, 3, SMAX)
    got = TT.init_cache(tcfg, 3, SMAX, device="cpu")
    for name in TT.KVCache._fields:
        w, g = getattr(want, name), getattr(got, name)
        assert (w is None) == (g is None), name
        if w is not None:
            assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16 and float(g.abs().max()) == 0.0
    assert tuple(TT.cache_axes(tcfg)) == tuple(JT.cache_axes(jcfg))


def test_init_cache_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TT.init_cache(tc.get_smoke_config("qwen2.5-3b"), 1, 32)


def test_kv_cache_carries_bf16_bits_and_refuses_a_wrong_layout():
    jcfg, tcfg = configs("minicpm3-4b", "bfloat16")
    cache = jax.tree.map(np_of, random_cache(jcfg, 2, SMAX, 7, "bfloat16"))
    got = interop.kv_cache(cache, tcfg, "cpu")
    assert got.k is None and got.ckv.dtype == torch.bfloat16
    np.testing.assert_array_equal(interop.to_numpy(got.kpe), cache.kpe)
    with pytest.raises(ValueError):      # GQA fields for an MLA config
        interop.kv_cache(JT.KVCache(k=cache.ckv, v=cache.ckv), tcfg, "cpu")
    with pytest.raises(ValueError):      # one layer short
        interop.kv_cache(cache._replace(ckv=cache.ckv[1:], kpe=cache.kpe[1:]), tcfg, "cpu")
    with pytest.raises(ValueError):      # f32 where the model keeps bf16
        interop.kv_cache(cache._replace(kpe=np.zeros(cache.kpe.shape, np.float32)), tcfg, "cpu")
    with pytest.raises(ValueError):      # kpe of another cache length
        interop.kv_cache(cache._replace(kpe=cache.kpe[:, :, :32]), tcfg, "cpu")
