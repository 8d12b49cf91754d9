"""Roofline terms of the serving scan on one H100 (counterpart of the
cost-model half of ``repro/launch/roofline.py``).

The reference's constants describe a TPU v5e; these describe the card the
port runs on.  The HLO half of the reference (``collective_bytes_from_hlo``,
``analyze``, ``model_flops_for``) reads compiled XLA artifacts and has no
counterpart yet.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["PEAK_FLOPS", "HBM_BW", "SMEM_BYTES", "topk_tile_seconds",
           "serving_scan_seconds", "serving_visit_seconds"]

# NVIDIA H100 SXM data sheet: f32 on the CUDA cores (the scan kernels run
# with TF32 off), dense rate, at the full 700 W power limit.
PEAK_FLOPS = 67e12
# NVIDIA H100 SXM data sheet: HBM3 bandwidth.
HBM_BW = 3.35e12
# CUDA C++ Programming Guide, compute capability 9.0: shared memory one
# thread block may use (of the SM's 228 KB), the on-chip working set a
# tile has to fit, where the TPU model had its VMEM.
SMEM_BYTES = 227 * 1024


def topk_tile_seconds(tile_n: int, *, b: int, k: int, bytes_per_row: float,
                      flops_per_row: float) -> float:
    """Roofline seconds for ONE corpus tile of a score + select scan:
    ``tile_n`` rows streamed from HBM (``bytes_per_row`` each) and scored
    (``flops_per_row`` each), then folded into the running top-k with K
    rounds of compare and select over the ``[B, K + tile_n]``
    concatenation.  The tile's time is the larger of the compute and the
    HBM term, the quantity ``core.backends.auto_tile_n`` minimises per
    corpus row."""
    compute = (flops_per_row * tile_n + b * k * (k + tile_n)) / PEAK_FLOPS
    memory = (bytes_per_row * tile_n) / HBM_BW
    return max(compute, memory)


def serving_scan_seconds(n_rows: int, *, b: int, k: int, bytes_per_row: float,
                         flops_per_row: float, tile_n: Optional[int] = None,
                         n_shards: int = 1) -> float:
    """Roofline seconds for one batched exact top-k scan over ``n_rows``
    rows, split across ``n_shards`` scanned in parallel (the slowest
    shard sets the scan term), each shard streamed in ``tile_n``-row tiles
    (:func:`topk_tile_seconds` per tile), and the per-shard lists merged
    afterwards (a ``[B, K * n_shards]`` select).  ``bytes_per_row``
    carries the corpus residency dtype."""
    if n_rows <= 0:
        return 0.0
    n_shards = max(1, int(n_shards))
    shard_rows = -(-n_rows // n_shards)          # ceil
    if tile_n is None or tile_n <= 0:
        tile_n = min(shard_rows, 8192)
    tile_n = min(tile_n, shard_rows)
    n_tiles = -(-shard_rows // tile_n)
    scan = n_tiles * topk_tile_seconds(tile_n, b=b, k=k,
                                       bytes_per_row=bytes_per_row,
                                       flops_per_row=flops_per_row)
    merge = (b * k * n_shards * (k + 1.0)) / PEAK_FLOPS if n_shards > 1 else 0.0
    return scan + merge


def serving_visit_seconds(n_visits: float, *, b: int, bytes_per_row: float,
                          flops_per_visit: float) -> float:
    """Roofline seconds for a batched graph traversal that scores
    ``n_visits`` candidates per query: the rows are gathered, not
    streamed, so every visit pays its full ``bytes_per_row`` from HBM."""
    if n_visits <= 0:
        return 0.0
    compute = (b * n_visits * flops_per_visit) / PEAK_FLOPS
    memory = (b * n_visits * bytes_per_row) / HBM_BW
    return max(compute, memory)
