"""The port's prefill step and losses held against repro on the same numpy
inputs, at the smoke configs of all five LM architectures (smollm-360m,
qwen2.5-3b with non-zero QKV biases, minicpm3-4b's MLA, phi3.5-moe's and
arctic-480b's experts), in f32 and bf16, on the reference's weights
carried by ``interop.transformer_params``: ``prefill_step``, ``lm_loss``
with the MoE aux term, ``chunked_ce_loss`` over several chunks and with
targets outside the vocabulary (NaN, as ``jnp.take_along_axis`` reads
them), and a padded vocabulary (``decode_step`` masks it,
``prefill_step`` does not, ``chunked_ce_loss`` does).  The decode steps
are in ``test_torch_decode.py``.

Tolerances, of each row's largest |value| (the last axis), as in
``test_torch_transformer.py``: f32 ``F32_RTOL`` = 1e-5; bf16 2^-5 for a
2-layer model.  A loss is one f32 scalar: within the same tolerance of
it.  With experts, routes are pinned by ``_torch_parity.PinnedRoutes``
and the aux loss is held within ``AUX_RTOL`` (``test_torch_moe.py`` says
why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.distributed.sharding import ParallelCtx as JCtx
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.distributed.sharding import ParallelCtx
from repro_torch.models import transformer as TT

from _torch_parity import PinnedRoutes, lm_configs, lm_model, lm_reference_params, np_of

pytestmark = pytest.mark.torch

F32_RTOL = 1e-5
MODEL_RTOL = {"float32": F32_RTOL, "bfloat16": 2.0 ** -5}
AUX_RTOL = {"float32": F32_RTOL, "bfloat16": 2.0 ** -8}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
ARCHS = ["smollm-360m", "qwen2.5-3b", "minicpm3-4b", "phi3.5-moe-42b-a6.6b", "arctic-480b"]
DTYPES = list(MODEL_RTOL)

configs, reference_params, carried = lm_configs, lm_reference_params, lm_model


def assert_close(want, got, rtol, ctx=""):
    w = np.asarray(np.asarray(want, np.float32), np.float64)
    g = got.detach().float().numpy().astype(np.float64)
    assert w.shape == g.shape, (w.shape, g.shape, ctx)
    assert np.all(np.isfinite(w)) and np.all(np.isfinite(g)), ctx
    scale = np.maximum(np.abs(w).max(axis=-1, keepdims=True), 1e-30)
    err = np.abs(g - w)
    assert np.all(err <= rtol * scale), f"error {np.max(err / scale):.3g} of row scale > {rtol:.3g} {ctx}"


def assert_scalar_close(want, got, rtol, ctx=""):
    assert abs(float(got) - float(want)) <= rtol * abs(float(want)), (float(want), float(got), ctx)


def pins_for(arch, dtype, monkeypatch):
    """PinnedRoutes for a config with experts, else None."""
    return PinnedRoutes(monkeypatch, MODEL_RTOL[dtype]) if jc.get_smoke_config(arch).is_moe else None


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "minicpm3-4b"])
def test_padded_vocabulary_matches_repro(arch):
    """The vocabulary padded 512 -> 520: ``decode_step`` masks the padded
    logits at f32-min, ``prefill_step`` leaves them, ``chunked_ce_loss``
    masks them; as the reference does."""
    jcfg, tcfg = configs(arch, pad_vocab_to=520)
    p = reference_params(arch, "float32", pad_vocab_to=520)
    model = carried(p, tcfg)
    ctx, jctx = ParallelCtx(None, tcfg.rules), JCtx(None, jcfg.rules)
    tok = np.random.default_rng(8).integers(0, 512, size=(2, 16)).astype(np.int32)
    want, _ = JT.decode_step(p, JT.init_cache(jcfg, 2, 32), jnp.asarray(tok[:, :1]), 0, jcfg, jctx)
    with torch.no_grad():
        got, _ = TT.decode_step(model, TT.init_cache(tcfg, 2, 32, device="cpu"), torch.from_numpy(tok[:, :1]),
                                0, tcfg, ctx)
        assert bool((got[:, 512:] == torch.finfo(torch.float32).min).all())
        assert_close(np.asarray(want)[:, :512], got[:, :512], F32_RTOL)
        np.testing.assert_array_equal(np.asarray(want)[:, 512:], got[:, 512:].numpy())
        want = JT.prefill_step(p, jnp.asarray(tok), jcfg, jctx)
        got = TT.prefill_step(model, torch.from_numpy(tok), tcfg, ctx)
        assert float(got[:, 512:].abs().min()) > 0.0
        assert_close(want, got, F32_RTOL)
        hidden, _ = JT.backbone(p, jnp.asarray(tok), jcfg, jctx)
        want = JT.chunked_ce_loss(p, hidden, jnp.asarray(tok), jcfg, jctx, chunk=8)
        got = TT.chunked_ce_loss(model, torch.from_numpy(np.array(hidden)), torch.from_numpy(tok), tcfg, ctx,
                                 chunk=8)
        assert_scalar_close(want, got, F32_RTOL)


# ---------------------------------------------------------------------------
# prefill_step, chunked_ce_loss, lm_loss.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_repro(arch, dtype, monkeypatch):
    jcfg, tcfg = configs(arch, dtype)
    p = reference_params(arch, dtype)
    pins = pins_for(arch, dtype, monkeypatch)
    tok = np.random.default_rng(9).integers(0, jcfg.vocab_size, size=(2, 32)).astype(np.int32)
    want = JT.prefill_step(p, jnp.asarray(tok), jcfg, JCtx(None, jcfg.rules))
    with torch.no_grad():
        got = TT.prefill_step(carried(p, tcfg), torch.from_numpy(tok), tcfg, ParallelCtx(None, tcfg.rules))
    assert got.dtype == torch.float32 and got.shape == (2, tcfg.padded_vocab)
    assert_close(want, got, MODEL_RTOL[dtype], f"{arch} {dtype}")
    if pins is not None:
        pins.done()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_chunked_ce_loss_match_repro(arch, dtype, monkeypatch):
    """``lm_loss`` (``chunked_ce_loss`` at its default chunk over 32
    positions, plus 0.01 x aux), and ``chunked_ce_loss`` alone over 4
    chunks of 8 on the reference's hidden states."""
    jcfg, tcfg = configs(arch, dtype)
    p = reference_params(arch, dtype)
    model = carried(p, tcfg)
    pins = pins_for(arch, dtype, monkeypatch)
    rng = np.random.default_rng(10)
    tok = rng.integers(0, jcfg.vocab_size, size=(2, 32)).astype(np.int32)
    tgt = rng.integers(0, jcfg.vocab_size, size=(2, 32)).astype(np.int32)
    ctx, jctx = ParallelCtx(None, tcfg.rules), JCtx(None, jcfg.rules)
    want, parts = JT.lm_loss(p, {"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt)}, jcfg, jctx)
    with torch.no_grad():
        got, tparts = TT.lm_loss(model, {"tokens": torch.from_numpy(tok), "targets": torch.from_numpy(tgt)},
                                 tcfg, ctx)
    assert got.dtype == torch.float32
    assert_scalar_close(parts["ce"], tparts["ce"], MODEL_RTOL[dtype], "ce")
    if jcfg.is_moe:
        assert float(parts["aux"]) > 0.5
        assert_scalar_close(parts["aux"], tparts["aux"], AUX_RTOL[dtype], "aux")
        pins.done()
    else:
        assert float(tparts["aux"]) == float(parts["aux"]) == 0.0
    assert_scalar_close(want, got, MODEL_RTOL[dtype], "loss")
    hidden = np.asarray(jnp.asarray(rng.standard_normal((2, 32, jcfg.d_model)), JDT[dtype]).astype(jnp.float32))
    jh = jnp.asarray(hidden, JDT[dtype])
    want = JT.chunked_ce_loss(p, jh, jnp.asarray(tgt), jcfg, jctx, chunk=8)
    with torch.no_grad():
        got = TT.chunked_ce_loss(model, interop.tensor(np_of(jh), "cpu"), torch.from_numpy(tgt), tcfg, ctx, chunk=8)
    assert_scalar_close(want, got, MODEL_RTOL[dtype], "chunked")


def test_chunked_ce_loss_reads_targets_outside_the_vocabulary_as_repro():
    """``jnp.take_along_axis`` wraps a negative target once and reads NaN
    for one still outside ``[0, Vp)``: the loss is NaN then, in both
    packages; targets -1 and -Vp wrap."""
    jcfg, tcfg = configs("smollm-360m")
    p = reference_params("smollm-360m", "float32")
    model = carried(p, tcfg)
    v = jcfg.vocab_size
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((2, 6, v)).astype(np.float32)
    t = np.array([[v, -1, -v, -(v + 1), 3, v + 9], [0, v - 1, 2 * v, -2, 5, 1]], np.int32)
    want = np.asarray(jnp.take_along_axis(jnp.asarray(logits), jnp.asarray(t)[..., None], axis=-1)[..., 0])
    got = TT._take_target(torch.from_numpy(logits), torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(np.isnan(want), np.isnan(got))
    np.testing.assert_array_equal(want[~np.isnan(want)], got[~np.isnan(got)])
    hidden = rng.standard_normal((2, 8, jcfg.d_model)).astype(np.float32)
    ctx, jctx = ParallelCtx(None, {}), JCtx(None, {})
    model.requires_grad_(False)
    for tgt in (np.full((2, 8), -1, np.int32), np.full((2, 8), v, np.int32)):
        want = JT.chunked_ce_loss(p, jnp.asarray(hidden), jnp.asarray(tgt), jcfg, jctx, chunk=4)
        got = TT.chunked_ce_loss(model, torch.from_numpy(hidden), torch.from_numpy(tgt), tcfg, ctx, chunk=4)
        assert np.isnan(float(want)) == np.isnan(float(got))
        if not np.isnan(float(want)):
            assert_scalar_close(want, got, F32_RTOL)
    with pytest.raises(AssertionError):
        TT.chunked_ce_loss(model, torch.from_numpy(hidden), torch.zeros(2, 8, dtype=torch.long), tcfg, ctx, chunk=3)
