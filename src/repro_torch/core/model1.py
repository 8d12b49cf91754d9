"""IBM Model 1, a lexical translation model trained by EM (counterpart of
``repro/core/model1.py``; Berger et al. 2000, paper §3.3).

FlexNeuART trains Model 1 on a *bitext* of (query, document chunk) pairs
and uses the alignment log-probability P(q | d) as a ranking feature that
bridges the query/document vocabulary gap.  The EM loop is batched:

  E-step: for every pair and every query token s, the alignment posterior
          over document tokens j is p(j) ∝ T[s, d_j]; expected counts
          accumulate by an accumulating ``index_put_`` into [Vq, Vd].
  M-step: column-normalise (T[s, t] = P(s | t), Σ_s T[s, t] = 1) with
          additive smoothing.

The translation table is dense [Vq, Vd].  Each EM step runs as a plain
function on the device of its inputs (the reference ``jax.jit``s it);
with ``batch_block`` the row blocks are folded in order, as the
reference's ``lax.scan`` folds them.  The counts are an f32 sum whose
order differs from the reference's (atomics on the card), so tables
agree within a tolerance, not bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.device import resolve_device

__all__ = ["init_ttable", "em_step", "train_model1", "model1_logprob"]


def init_ttable(vq: int, vd: int, device=None) -> torch.Tensor:
    """The uniform table [Vq, Vd] of 1 / Vq on ``device`` (None = cuda)."""
    return torch.full((vq, vd), 1.0 / vq, dtype=torch.float32,
                      device=resolve_device(device))


def _pair_posteriors(ttable, q_toks, d_toks, vq, vd):
    """Alignment posteriors [B, LQ, LD] + validity masks."""
    q_valid = q_toks < vq
    d_valid = d_toks < vd
    qs = torch.clamp(q_toks, max=vq - 1).long()
    ds = torch.clamp(d_toks, max=vd - 1).long()
    t = ttable[qs[:, :, None], ds[:, None, :]]              # [B, LQ, LD]
    t = torch.where(d_valid[:, None, :], t, torch.zeros_like(t))
    denom = torch.clamp(torch.sum(t, dim=-1, keepdim=True), min=1e-30)
    post = t / denom
    post = torch.where(q_valid[:, :, None], post, torch.zeros_like(post))
    return post, denom[..., 0], q_valid, ds


def em_step(ttable: torch.Tensor, q_toks: torch.Tensor, d_toks: torch.Tensor,
            smoothing: float = 1e-6,
            batch_block: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One EM iteration over a bitext batch (``q_toks`` i32[B, LQ] padded
    with >= Vq, ``d_toks`` i32[B, LD] padded with >= Vd).  Returns
    (new_ttable, mean per-pair log-likelihood before the update).  The
    counts buffer becomes the new table in place, so a step holds two
    tables, not three."""
    vq, vd = ttable.shape
    counts = torch.zeros((vq, vd), dtype=torch.float32, device=ttable.device)
    ll = torch.zeros((), dtype=torch.float32, device=ttable.device)
    nq = torch.zeros((), dtype=torch.float32, device=ttable.device)
    if batch_block and q_toks.shape[0] % batch_block == 0:
        blocks = zip(q_toks.split(batch_block), d_toks.split(batch_block))
    else:
        blocks = [(q_toks, d_toks)]
    for qb, db in blocks:
        post, denom, q_valid, ds = _pair_posteriors(ttable, qb, db, vq, vd)
        qs = torch.clamp(qb, max=vq - 1).long()
        counts.index_put_((qs[:, :, None].expand_as(post), ds[:, None, :].expand_as(post)),
                          post, accumulate=True)
        d_len = torch.clamp(torch.sum(db < vd, dim=-1), min=1)
        lp = torch.log(denom / d_len[:, None])
        ll = ll + torch.sum(torch.where(q_valid, lp, torch.zeros_like(lp)))
        nq = nq + torch.sum(q_valid)
    counts += smoothing
    counts /= torch.sum(counts, dim=0, keepdim=True)
    return counts, ll / torch.clamp(nq, min=1.0)


def train_model1(q_toks: torch.Tensor, d_toks: torch.Tensor, vq: int, vd: int,
                 iters: int = 5, smoothing: float = 1e-6, batch_block: int = 0):
    """Full EM training on the device of the bitext.  Returns (ttable,
    per-iteration mean log-likelihoods f32[iters])."""
    t = init_ttable(vq, vd, q_toks.device)
    lls = []
    for _ in range(iters):
        t, ll = em_step(t, q_toks, d_toks, smoothing, batch_block)
        lls.append(float(ll))
    return t, torch.tensor(lls, dtype=torch.float32, device=t.device)


def model1_logprob(ttable: torch.Tensor, background: torch.Tensor,
                   q_toks: torch.Tensor, d_toks: torch.Tensor, d_len: torch.Tensor,
                   vocab_size: int, lam: float = 0.1) -> torch.Tensor:
    """log P(q | d) = Σ_s log( (1-λ)·(1/|d|)·Σ_t T[s, t∈d] + λ·P_c(s) )
    for ``q_toks`` i32[B, LQ], ``d_toks`` i32[B, LD], ``d_len`` i32[B] and
    the collection model ``background`` f32[Vq]."""
    vq, vd = ttable.shape
    q_valid = q_toks < vocab_size
    d_valid = d_toks < vocab_size
    qs = torch.clamp(q_toks, max=vq - 1).long()
    ds = torch.clamp(d_toks, max=vd - 1).long()
    t = ttable[qs[:, :, None], ds[:, None, :]]              # [B, LQ, LD]
    t = torch.where(d_valid[:, None, :], t, torch.zeros_like(t))
    mean_t = torch.sum(t, dim=-1) / torch.clamp(d_len[:, None], min=1)
    bg = background[qs]
    lp = torch.log(torch.clamp((1 - lam) * mean_t + lam * bg, min=1e-30))
    return torch.sum(torch.where(q_valid, lp, torch.zeros_like(lp)), dim=-1)
