"""Fused dense+sparse scores ``[B, N]`` (B4), the counterpart of
``repro/kernels/sparse_dense.py: fused_score_pallas``:

    score[b, n] = w_dense * <q_dense[b], c_dense[n]>
                + w_sparse * sum_k qdensified[b, c_idx[n, k]] * c_val[n, k]

Both parts are required and both weights always apply (weight 0.0 still
multiplies), as in the TPU kernel.  Three routes, fixed by the arrays'
shapes, dtypes and alignment before the launch (:func:`route`):

- **box** (``csrc/fused_score.cu``, ``fused_score_launch``): B2's fused
  ring (``ring.cuh`` ``fused_kernel``, ``fused_topk.ring_layout``'s box
  layout: MS MARCO's D = 768 and nnz = 128) with an epilogue that stores
  every score, a block a group of 16 queries at every B (B2's clusters
  lost to it on the NAPP build's 128 pivots: ``PERF.md``);
- **rows** (the same entry point): the ring's row layout (D <= 32 even,
  nnz <= 32: DIN's items with their tags), a block a group;
- **row_kernel** (``csrc/topk_large.cu``, ``topk_large_rows_launch``): what
  no ring layout takes (D above 32 off 16 bytes, odd D, a base off 16
  bytes, dense and values of two dtypes), one warp a row.

The ring reads the sparse part through a query-term index per group of 16
queries (``kernels/query_index.py``) and the dense queries grouped as its
stages copy them, both built here on the card
(``fused_topk.ring_queries``).  For tensors on the CPU the wrapper runs
the plain version (``ref.fused_score_ref``); for CUDA tensors it launches
a kernel or raises: nothing falls back to another route.  ``launches``
counts B4's launches on any route, ``ring_launches`` the ring's (either
layout), ``row_launches`` the ring's row layout's; the rest,
``launches - ring_launches``, are row_kernel's.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.fused_topk import fused_grid, ring_layout, ring_queries
from repro_torch.kernels.mips_topk import _DTYPES, TILE, _sms, cdiv, ptr, require_cuda

launches = 0
ring_launches = 0
row_launches = 0


def _declare(lib):
    fn = lib.fused_score_launch
    if fn.argtypes is None:
        v, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [v, v, i, v, v, v, v, i, i, i, i, i, i, f, f, i, i, v, v]
        fn.restype = ctypes.c_int
    return fn


def route(c_dense, c_idx, c_val, vocab: int) -> str:
    """B4's route for the corpus arrays, before any launch: the fused
    ring's ``"box"`` or ``"rows"`` layout (``fused_topk.ring_layout``), or
    ``"row_kernel"``.  ``vocab`` is the query table's V (its width less
    one)."""
    return ring_layout(c_dense, c_idx, c_val, vocab) or "row_kernel"


def fused_score(qdensified, q_dense, c_idx, c_val, c_dense, w_dense: float = 1.0,
                w_sparse: float = 1.0) -> torch.Tensor:
    """f32 scores [B, N].  ``qdensified`` [B, V+1] is the densified query
    table with its zero trash column last, ``q_dense`` [B, Dd]; the
    corpus is ``c_idx`` i32 / ``c_val`` [N, NNZ] (pad id V) and
    ``c_dense`` [N, Dd], values f32 or bf16.  Any N: nothing is padded."""
    global launches, ring_launches, row_launches
    if c_dense.device.type == "cpu":
        return ref.fused_score_ref(qdensified, q_dense, c_idx, c_val, c_dense,
                                   w_dense, w_sparse)
    if c_dense.device.type != "cuda":
        raise ValueError(f"fused_score runs on cpu or cuda, not {c_dense.device}")
    dev = c_dense.device
    q = q_dense.float().contiguous()      # upcast before the first multiply
    require_cuda("q_dense", q, (torch.float32,), 2, dev)
    require_cuda("c_dense", c_dense, _DTYPES, 2, dev)
    require_cuda("c_idx", c_idx, (torch.int32,), 2, dev)
    require_cuda("c_val", c_val, _DTYPES, 2, dev)
    require_cuda("qdensified", qdensified, _DTYPES, 2, dev)
    (b, d), (n, nnz) = q.shape, c_idx.shape
    vocab = qdensified.shape[1] - 1
    if c_dense.shape != (n, d) or c_val.shape != (n, nnz):
        raise ValueError(f"corpus shapes disagree: c_dense {tuple(c_dense.shape)}, c_idx "
                         f"{tuple(c_idx.shape)}, c_val {tuple(c_val.shape)}, q_dense {tuple(q.shape)}")
    if qdensified.shape[0] != b:
        raise ValueError(f"qdensified has {qdensified.shape[0]} rows, expected {b}")
    way = route(c_dense, c_idx, c_val, vocab)
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    if way == "row_kernel":
        from repro_torch.kernels import topk_large   # imported here: topk_large imports this module
        qd = qdensified.float().contiguous()
        lib = topk_large.library()
        with torch.cuda.device(dev), _build.LAUNCH_LOCK:
            topk_large.launch_rows(lib, qd, q, c_idx, c_val, c_dense, "ip", True, float(w_dense),
                                   float(w_sparse), out)
            launches += 1
        return out
    lib = _build.load("fused_score")
    bf16 = c_dense.dtype == torch.bfloat16
    grid = fused_grid(b, way, _sms(dev), cluster=False)
    qg, words, table = ring_queries(q, qdensified, grid)
    fn = _declare(lib)
    with torch.cuda.device(dev), _build.LAUNCH_LOCK:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptr(qg), ptr(c_dense), d, ptr(words), ptr(table), ptr(c_idx), ptr(c_val), nnz, vocab,
                 int(bf16), int(way == "rows"), b, n, float(w_dense), float(w_sparse),
                 max(1, min(cdiv(n, TILE), grid.blocks)), grid.rows, ptr(out),
                 ctypes.c_void_p(stream))
        _build.check(err, "fused_score_launch")
        launches += 1
        ring_launches += 1
        row_launches += int(way == "rows")
    return out
