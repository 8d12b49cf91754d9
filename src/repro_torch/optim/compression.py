"""Gradient compression for cross-pod data parallelism (counterpart of
``repro/optim/compression.py``).

  * ``topk``: magnitude top-k sparsification with error feedback (Stich et
    al. 2018): the untransmitted residual is added back into the next
    step's gradient.  The k largest ``|g|`` are chosen in ``lax.top_k``'s
    order (``core.brute_force.select_topk``: ties toward the lower index),
    which ``torch.topk`` does not promise.
  * ``int8``: per-leaf symmetric int8 quantisation with an f32 scale;
    ``torch.round`` rounds half to even, as ``jnp.round`` does.

Trees are flattened by ``optim.optimizer.named_leaves`` and come back as
``{name: tensor}``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.brute_force import select_topk
from repro_torch.optim.optimizer import named_leaves

__all__ = ["TopKCompressed", "topk_compress", "topk_decompress", "ef_topk_step", "ef_init",
           "ef_compress_tree", "Int8Compressed", "int8_compress", "int8_decompress", "int8_roundtrip_tree"]


class TopKCompressed(NamedTuple):
    values: torch.Tensor
    indices: torch.Tensor      # i32
    shape: tuple


def topk_compress(g: torch.Tensor, ratio: float) -> TopKCompressed:
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * ratio))
    _, idx = select_topk(flat.abs(), k)
    return TopKCompressed(flat[idx], idx.to(torch.int32), tuple(g.shape))


def topk_decompress(c: TopKCompressed) -> torch.Tensor:
    n = 1
    for s in c.shape:
        n *= s
    flat = torch.zeros((n,), dtype=c.values.dtype, device=c.values.device)
    flat[c.indices.long()] = c.values
    return flat.reshape(c.shape)


def ef_topk_step(g: torch.Tensor, residual: torch.Tensor, ratio: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback top-k: (transmitted gradient, new residual)."""
    corrected = g + residual
    wire = topk_decompress(topk_compress(corrected, ratio))
    return wire, corrected - wire


def ef_init(params):
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in named_leaves(params).items()}


def ef_compress_tree(grads, residuals, ratio: float):
    res = named_leaves(residuals)
    out = {k: ef_topk_step(g.float(), res[k], ratio) for k, g in named_leaves(grads).items()}
    return {k: w for k, (w, _) in out.items()}, {k: r for k, (_, r) in out.items()}


class Int8Compressed(NamedTuple):
    q: torch.Tensor            # i8
    scale: torch.Tensor        # f32 scalar


def int8_compress(g: torch.Tensor) -> Int8Compressed:
    scale = torch.clamp_min(torch.max(torch.abs(g)), 1e-12) / 127.0
    return Int8Compressed(torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8), scale)


def int8_decompress(c: Int8Compressed) -> torch.Tensor:
    return c.q.to(torch.float32) * c.scale


def int8_roundtrip_tree(grads):
    return {k: int8_decompress(int8_compress(g.float())) for k, g in named_leaves(grads).items()}
