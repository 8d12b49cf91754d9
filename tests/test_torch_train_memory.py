"""The port's LM backward on the CPU: remat against none (bit for bit,
MoE routes included), ``grad_accum`` k against the whole batch, and the
backward's memory contract (the reference's ``jax.checkpoint`` of each
layer, of each attention tile and, beyond it, one loss chunk's logits
live at a time), read through ``saved_tensors_hooks`` and a dispatch
mode that sees every op of the forward and the backward.
"""

import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.distributed.sharding import ParallelCtx
from repro_torch.launch import steps as TST
from repro_torch.models import transformer as TT

from _torch_parity import TRAIN_TOL, assert_leaf_close, lm_batch, lm_configs

pytestmark = pytest.mark.torch


# ---------------------------------------------------------------------------
# Remat, gradient accumulation, and the backward's memory contract.
# ---------------------------------------------------------------------------

def fresh_model(tcfg, seed=0):
    model, _ = TT.init_transformer(tcfg, seed=seed, device="cpu")
    return model


def test_remat_matches_no_remat_bit_for_bit(monkeypatch):
    """With ``cfg.remat`` every block runs twice (its forward, then its
    recompute in the backward) and the gradients equal those without,
    bit for bit: the recompute routes MoE tokens as the first pass did."""
    for arch in ("smollm-360m", "arctic-480b"):
        _, tcfg = lm_configs(arch)
        batch = {k: torch.from_numpy(v) for k, v in lm_batch(tcfg.vocab_size, b=2).items()}
        grads = {}
        for remat in (False, True):
            cfg = dataclasses.replace(tcfg, remat=remat)
            model = fresh_model(cfg)
            calls = []
            orig = TT._block_rank     # a layer's body, which the backbone runs (and remat reruns)
            monkeypatch.setattr(TT, "_block_rank", lambda *a, **k: calls.append(1) or orig(*a, **k))
            loss, _ = TT.lm_loss(model, batch, cfg, ParallelCtx(None, cfg.rules))
            loss.backward()
            monkeypatch.setattr(TT, "_block_rank", orig)
            assert len(calls) == cfg.n_layers * (2 if remat else 1), (arch, remat, len(calls))
            grads[remat] = {n: p.grad for n, p in model.named_parameters()}
        for n in grads[False]:
            assert torch.equal(grads[False][n], grads[True][n]), (arch, n)


@pytest.mark.parametrize("arch", ["smollm-360m", "minicpm3-4b"])
def test_grad_accum_matches_the_whole_batch(arch):
    """k = 4 microbatches with their gradients summed == one step on the
    whole batch, by linearity (the loss within ``TRAIN_TOL``, the
    parameters within 2e-3 of their scale, as the reference's own test
    holds them: Adam's first step normalises each gradient element, so a
    tiny one's sign decides).  Without experts: the MoE aux loss is a
    product of batch means, not linear in the batch."""
    _, tcfg = lm_configs(arch)
    batch = {k: torch.from_numpy(v) for k, v in lm_batch(tcfg.vocab_size, seed=5).items()}
    out = {}
    for k in (1, 4):
        cfg = dataclasses.replace(tcfg, grad_accum=k)
        model = fresh_model(cfg)
        step, opt = TST.make_lm_train_step(cfg, ParallelCtx(None, cfg.rules), lr=1e-3)
        _, _, m = step(model, opt.init(model), batch)
        out[k] = (m["loss"], dict(model.named_parameters()))
    assert_leaf_close(out[1][0].numpy(), out[4][0], TRAIN_TOL, "loss")
    for n, p in out[1][1].items():
        assert_leaf_close(p.detach().numpy(), out[4][1][n], 2e-3, n)


class _LargestOutput(TorchDispatchMode):
    """Records the largest tensor any op produces, forward and backward."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


def test_backward_keeps_the_memory_contract(monkeypatch):
    """smollm's smoke config with remat at 1,024 positions: attention tiles
    of 256 x 256 (16 a layer), loss chunks of 512.  What autograd saves
    (``saved_tensors_hooks``), in the model and inside one block's
    recompute and one loss chunk's: nothing as large as a layer's
    ``[B, H, S, S]`` scores or the ``[B, S, Vp]`` logits, the largest no
    larger than one tile or one chunk.  And no op of the forward or the
    backward produces a tensor that large."""
    _, tcfg = lm_configs("smollm-360m")
    cfg = dataclasses.replace(tcfg, remat=True, attn_chunk_q=256, attn_chunk_kv=256)
    b, s = 1, 1024
    h, vp = cfg.padded_heads, cfg.padded_vocab
    tile, chunk = b * h * 256 * 256, b * 512 * vp
    scores, logits = b * h * s * s, b * s * vp
    model = fresh_model(cfg)
    batch = {k: torch.from_numpy(v) for k, v in lm_batch(cfg.vocab_size, b=b, s=s).items()}
    ctx = ParallelCtx(None, cfg.rules)
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    # the recomputed regions, each under the hooks on its own
    x = TT.gather_rows(model.embed, batch["tokens"]).detach().requires_grad_()
    pos = torch.arange(s).expand(b, s)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        TT.block_apply(model.blocks[0], x, pos, cfg, ctx)[0].sum()
        TT._ce_chunk(x[:, :512], model.embed.T, batch["targets"][:, :512], None)
        inner = max(saved)
        saved.clear()
        loss, _ = TT.lm_loss(model, batch, cfg, ctx)
        largest = _LargestOutput()
        with largest:
            loss.backward()
    outer = max(saved)
    assert max(inner, outer) <= max(tile, chunk) < min(scores, logits), (inner, outer, tile, chunk)
    assert 0 < largest.numel < min(scores, logits), largest.numel
    assert all(p.grad is not None for p in model.parameters())
