"""Recall metric shared by every gate (counterpart of
``repro/core/fusion.py: topk_recall``).  Learning the mixing weights is
not ported yet; weights learned by ``repro`` reach the port through
``repro_torch.interop``."""

from __future__ import annotations

import numpy as np

__all__ = ["topk_recall"]


def topk_recall(oracle_indices, got_indices) -> float:
    """Mean per-row overlap of two top-k id lists, as sets (order inside
    a list does not count).  Host-side: it compares results."""
    oracle = np.asarray(_host(oracle_indices))
    got = np.asarray(_host(got_indices))
    if oracle.shape != got.shape:
        raise ValueError(f"shapes differ: {oracle.shape} vs {got.shape}")
    if oracle.ndim == 1:
        oracle, got = oracle[None], got[None]
    k = oracle.shape[-1]
    hits = [len(set(o.tolist()) & set(g.tolist())) / k
            for o, g in zip(oracle.reshape(-1, k), got.reshape(-1, k))]
    return float(np.mean(hits))


def _host(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else x
