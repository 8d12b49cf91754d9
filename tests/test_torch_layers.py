"""repro_torch.models.layers held against repro.models.layers on the same
numpy inputs and weights: ``rmsnorm``, ``apply_rope`` (1-D and 2-D
positions), ``swiglu_apply``, ``flash_attention`` (causal and not,
``q_offset``, several q and kv chunks, ``kv_valid_len``), ``gqa_apply``
(smollm-360m's and qwen2.5-3b's smoke configs, the latter with QKV bias,
and a ``pad_heads_to`` config) and ``mla_apply`` (minicpm3-4b's).

Tolerances, of each row's largest |value| (the last axis; a score-like
quantity summing to near zero must not turn a few ULPs into a large
ratio):

* f32: ``F32_RTOL`` = 1e-5.  Only the order of f32 sums differs (XLA's
  CPU dots against PyTorch's), plus ``exp``, ``rsqrt``, ``pow``, ``sin``
  and ``cos``, which neither library rounds correctly; a layer chains a
  few such steps.
* bf16: ``BF16_RTOL`` = 2^-6.  Both sides accumulate in f32 and round
  each op's result to bf16 (8 significant bits, so one rounding is at
  most 2^-9 of the value); the f32 sums' order differs, so a result next
  to a rounding boundary can round one way in one library and the other
  way in the other: one ULP, 2^-8 of the value's binade, and a flipped
  ULP in an input to the next op moves that op's output by about as much
  again.  A layer chains at most four such roundings (projection, RoPE,
  attention output, output projection), hence four ULPs of 2^-8.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.sharding import ParallelCtx as JCtx
from repro.models import layers as JL
import repro_torch.configs as tc
from repro_torch.distributed.sharding import ParallelCtx
from repro_torch.models import layers as TL

pytestmark = pytest.mark.torch

F32_RTOL = 1e-5
BF16_RTOL = 2.0 ** -6
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32, F32_RTOL),
          "bfloat16": (None, jnp.bfloat16, torch.bfloat16, BF16_RTOL)}


def _pair(a, dtype):
    """One numpy f32 array as (jnp array, CPU tensor) of ``dtype``: the
    bf16 values rounded once by JAX and carried as their bits."""
    j = jnp.asarray(a, DTYPES[dtype][1])
    t = torch.from_numpy(np.asarray(j, np.float32)).to(DTYPES[dtype][2])
    return j, t


def _params(tree, dtype):
    """A numpy tree -> (jnp tree, tensor tree) of ``dtype``."""
    if isinstance(tree, dict):
        pairs = {k: _params(v, dtype) for k, v in tree.items()}
        return {k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()}
    return _pair(tree, dtype)


def assert_close(want, got, rtol, ctx=""):
    w = np.asarray(np.asarray(want, np.float32), np.float64)
    g = got.detach().float().numpy().astype(np.float64)
    assert w.shape == g.shape, (w.shape, g.shape, ctx)
    assert np.all(np.isfinite(w)) and np.all(np.isfinite(g)), ctx
    scale = np.abs(w).max(axis=-1, keepdims=True)
    err = np.abs(g - w)
    assert np.all(err <= rtol * np.maximum(scale, 1e-30)), \
        f"error {np.max(err / np.maximum(scale, 1e-30)):.3g} of row scale > {rtol:.3g} {ctx}"


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_matches_repro(dtype):
    rng = _rng(1)
    x, scale = rng.standard_normal((3, 5, 48)) * 3, 1 + 0.1 * rng.standard_normal(48)
    jx, tx = _pair(x, dtype)
    jp, tp = _params({"scale": scale}, dtype)
    got = TL.rmsnorm(tp, tx, 1e-6)
    assert got.dtype == tx.dtype
    assert_close(JL.rmsnorm(jp, jx, 1e-6), got, DTYPES[dtype][3])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("pos_dims", [1, 2])
@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_apply_rope_matches_repro(dtype, pos_dims, theta):
    rng = _rng(2)
    x = rng.standard_normal((2, 40, 3, 32))
    pos = np.arange(7, 47, dtype=np.int32)
    if pos_dims == 2:
        pos = np.stack([pos, pos[::-1] + 100])
    jx, tx = _pair(x, dtype)
    got = TL.apply_rope(tx, torch.from_numpy(pos), theta)
    assert got.dtype == tx.dtype
    assert_close(JL.apply_rope(jx, jnp.asarray(pos), theta), got, DTYPES[dtype][3])


def test_apply_rope_is_half_split():
    """The first half of the head dim rotates with the second (not
    interleaved pairs): at one position the pair (i, i + D/2) turns by
    the angle of frequency i."""
    x = torch.zeros(1, 1, 1, 8)
    x[..., 1] = 1.0
    out = TL.apply_rope(x, torch.tensor([3]), 10000.0)[0, 0, 0]
    ang = 3 * (1.0 / 10000.0 ** (2 / 8))
    np.testing.assert_allclose(out[[1, 5]].numpy(), [np.cos(ang), np.sin(ang)], rtol=1e-6)
    assert float(out[[0, 2, 3, 4, 6, 7]].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_swiglu_matches_repro(dtype):
    rng = _rng(3)
    d, dff = 32, 80
    x = rng.standard_normal((2, 9, d))
    w = {"w_in": rng.standard_normal((d, dff)) / np.sqrt(d),
         "w_gate": rng.standard_normal((d, dff)) / np.sqrt(d),
         "w_out": rng.standard_normal((dff, d)) / np.sqrt(dff)}
    jx, tx = _pair(x, dtype)
    jp, tp = _params(w, dtype)
    assert_close(JL.swiglu_apply(jp, jx), TL.swiglu_apply(tp, tx), DTYPES[dtype][3])


FLASH_CASES = [
    # (sq, skv, chunk_q, chunk_kv, causal, q_offset, valid)
    (32, 32, 32, 32, True, 0, False),
    (64, 64, 16, 16, True, 0, False),
    (64, 64, 32, 16, False, 0, False),
    (16, 64, 8, 16, True, 48, False),
    (16, 64, 16, 32, False, 0, True),
    (48, 48, 16, 48, True, 0, True),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "sq{}-skv{}-cq{}-ckv{}-{}-off{}-{}".format(
    c[0], c[1], c[2], c[3], "causal" if c[4] else "full", c[5], "valid" if c[6] else "all"))
def test_flash_attention_matches_repro(dtype, case):
    sq, skv, cq, ckv, causal, q_offset, valid = case
    rng = _rng(4)
    b, h, dk, dv = 2, 3, 32, 16
    q, k, v = (rng.standard_normal((b, s, h, dd)) for s, dd in ((sq, dk), (skv, dk), (skv, dv)))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    kv_valid = np.array([skv - 5, 3], np.int32) if valid else None
    kw = dict(causal=causal, q_offset=q_offset, chunk_q=cq, chunk_kv=ckv)
    want = JL.flash_attention(jq, jk, jv, kv_valid_len=None if kv_valid is None else jnp.asarray(kv_valid), **kw)
    got = TL.flash_attention(tq, tk, tv, kv_valid_len=None if kv_valid is None else torch.from_numpy(kv_valid),
                             **kw)
    assert got.dtype == tv.dtype and got.shape == (b, sq, h, dv)
    assert_close(want, got, DTYPES[dtype][3])


def test_flash_attention_keeps_the_chunk_assertion():
    x = torch.zeros(1, 48, 1, 8)
    with pytest.raises(AssertionError):
        TL.flash_attention(x, x, x, chunk_q=32, chunk_kv=16)


def test_flash_attention_row_with_no_valid_key_matches_repro():
    """kv_valid_len 0: every score is f32-min, the row averages v
    uniformly in both packages (the mask is finfo.min, not -inf)."""
    rng = _rng(5)
    q, k, v = (rng.standard_normal((1, 8, 2, 8)) for _ in range(3))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, "float32") for a in (q, k, v))
    want = JL.flash_attention(jq, jk, jv, causal=False, kv_valid_len=jnp.asarray([0], jnp.int32))
    got = TL.flash_attention(tq, tk, tv, causal=False, kv_valid_len=torch.tensor([0]))
    assert_close(want, got, F32_RTOL)
    np.testing.assert_allclose(got[0, 0].numpy(), v[0].mean(0), rtol=1e-5)


def _attn_weights(cfg, rng):
    """numpy attention weights of ``cfg`` in the reference's layouts."""
    d, dh = cfg.d_model, cfg.resolved_head_dim
    hp, hkv = cfg.padded_heads, cfg.n_kv_heads
    if cfg.attention == "mla":
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        return {"wq_a": rng.standard_normal((d, qr)) / np.sqrt(d),
                "q_norm": {"scale": 1 + 0.1 * rng.standard_normal(qr)},
                "wq_b": rng.standard_normal((qr, hp, dn + dr)) / np.sqrt(qr),
                "wkv_a": rng.standard_normal((d, kvr + dr)) / np.sqrt(d),
                "kv_norm": {"scale": 1 + 0.1 * rng.standard_normal(kvr)},
                "wk_b": rng.standard_normal((kvr, hp, dn)) / np.sqrt(kvr),
                "wv_b": rng.standard_normal((kvr, hp, dv)) / np.sqrt(kvr),
                "wo": rng.standard_normal((hp, dv, d)) / np.sqrt(hp * dv)}
    w = {"wq": rng.standard_normal((d, hp, dh)) / np.sqrt(d),
         "wk": rng.standard_normal((d, hkv, dh)) / np.sqrt(d),
         "wv": rng.standard_normal((d, hkv, dh)) / np.sqrt(d),
         "wo": rng.standard_normal((hp, dh, d)) / np.sqrt(hp * dh)}
    if cfg.qkv_bias:
        w.update(bq=0.1 * rng.standard_normal((hp, dh)), bk=0.1 * rng.standard_normal((hkv, dh)),
                 bv=0.1 * rng.standard_normal((hkv, dh)))
    return w


def _padded_smollm():
    """smollm-360m's smoke config with 4 query heads over 2 KV heads
    padded to 6: each KV group of 3 slots holds 2 real heads."""
    return dataclasses.replace(tc.get_smoke_config("smollm-360m"), n_heads=4, n_kv_heads=2,
                               pad_heads_to=6)


ATTN_CONFIGS = {
    "smollm-360m": lambda: tc.get_smoke_config("smollm-360m"),
    "qwen2.5-3b": lambda: tc.get_smoke_config("qwen2.5-3b"),
    "smollm-padded": _padded_smollm,
    "minicpm3-4b": lambda: tc.get_smoke_config("minicpm3-4b"),
}


def _jax_cfg(tcfg):
    """repro's TransformerConfig with the port's field values."""
    from repro.configs.base import TransformerConfig

    return TransformerConfig(**{f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)})


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(ATTN_CONFIGS))
@pytest.mark.parametrize("causal", [True, False])
def test_attention_apply_matches_repro(name, dtype, causal):
    tcfg = dataclasses.replace(ATTN_CONFIGS[name](), dtype=dtype)
    jcfg = _jax_cfg(tcfg)
    rng = _rng(6)
    jp, tp = _params(_attn_weights(tcfg, rng), dtype)
    x = rng.standard_normal((2, 64, tcfg.d_model))
    jx, tx = _pair(x, dtype)
    pos = np.arange(64, dtype=np.int32)
    japply, tapply = (JL.mla_apply, TL.mla_apply) if tcfg.attention == "mla" else (JL.gqa_apply, TL.gqa_apply)
    want = japply(jp, jx, jnp.asarray(np.broadcast_to(pos, (2, 64))), jcfg, JCtx(None, {}), causal=causal)
    got = tapply(tp, tx, torch.from_numpy(pos).expand(2, 64), tcfg, ParallelCtx(None, {}), causal=causal)
    assert got.dtype == tx.dtype
    assert_close(want, got, DTYPES[dtype][3], name)


@pytest.mark.parametrize("name", ["smollm-padded", "minicpm3-4b"])
def test_head_mask_matches_repro(name):
    tcfg = ATTN_CONFIGS[name]()
    if name == "minicpm3-4b":
        tcfg = dataclasses.replace(tcfg, pad_heads_to=6)
    want = JL._head_mask(_jax_cfg(tcfg), jnp.float32)
    got = TL._head_mask(tcfg, torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if name == "smollm-padded":   # 2 real heads of 3 slots in each of 2 KV groups
        assert got.tolist() == [1, 1, 0, 1, 1, 0]


def test_head_mask_is_none_without_padding():
    assert TL._head_mask(tc.get_smoke_config("smollm-360m"), torch.float32) is None


def test_gqa_expands_kv_heads_in_place():
    """jnp.repeat's order: query head h reads KV head h // rep.  With
    every query projection equal, a KV head's values reach exactly the
    rep query heads of its group."""
    cfg = dataclasses.replace(tc.get_smoke_config("smollm-360m"), n_heads=4, n_kv_heads=2, head_dim=8,
                              d_model=16)
    rng = _rng(7)
    w = {k: torch.from_numpy(v).float() for k, v in _attn_weights(cfg, rng).items()}
    w["wv"] = torch.zeros_like(w["wv"])
    w["wv"][:, 1] = torch.eye(16)[:, :8]                # only KV head 1 carries values
    w["wo"] = torch.zeros(4, 8, 16)                     # head h writes output columns 4h..4h+3
    for h in range(4):
        w["wo"][h, :, 4 * h:4 * h + 4] = torch.eye(8)[:, :4]
    x = torch.from_numpy(rng.standard_normal((1, 8, 16))).float()
    out = TL.gqa_apply(w, x, torch.arange(8), cfg, ParallelCtx(None, {}))[0]
    assert float(out[:, :8].abs().max()) == 0.0        # heads 0, 1: KV head 0
    assert float(out[:, 8:].abs().max()) > 0.0         # heads 2, 3: KV head 1


@pytest.mark.parametrize("name", ["smollm-360m", "minicpm3-4b"])
def test_init_shapes_and_axes_equal_repro(name):
    import jax

    tcfg = ATTN_CONFIGS[name]()
    jcfg = _jax_cfg(tcfg)
    init_j, init_t = (JL.mla_init, TL.mla_init) if tcfg.attention == "mla" else (JL.gqa_init, TL.gqa_init)
    jp, ja = init_j(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp, ta = init_t(torch.Generator().manual_seed(0), tcfg, torch.float32)
    assert ta == ja
    assert jax.tree.map(lambda a: a.shape, jp) == {k: (tuple(v.shape) if not isinstance(v, dict) else
                                                       {kk: tuple(vv.shape) for kk, vv in v.items()})
                                                   for k, v in tp.items()}
