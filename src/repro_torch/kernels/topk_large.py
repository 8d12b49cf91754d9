"""Exact top-k for k beyond the scan kernels' ``MAX_K`` through the CUDA
kernels in ``csrc/topk_large.cu`` (``topk_large_launch``): the
counterpart of ``repro/kernels/mips_topk.py: mips_topk_pallas`` and
``repro/kernels/fused_topk.py: fused_topk_pallas`` at such k, which the
reference's kernel backend serves as it serves any k.

The kernels score the first ``n_valid`` rows into a [B, n_valid] buffer
(one warp per row, the graph hop's per-row arithmetic) and select each
query's top k from it (a radix select, then a sort of the k rows).  Rows
at or past ``n_valid`` are not scored: with k <= n_valid they never reach
the reference backend's top k.

For tensors on the CPU the wrapper runs the plain version (the plain scan
of ``ref`` over the first ``n_valid`` rows); for CUDA tensors it launches
the kernels or raises.  ``launches`` counts calls of
``topk_large_launch`` (a score and a select kernel each), nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.fused_topk import _weights
from repro_torch.kernels.mips_topk import _DTYPES, _sms, ptr, require_cuda

_SCORE_BLOCKS_PER_SM = 8   # 256-thread score blocks to aim for, per SM

launches = 0


def _declare(lib):
    fn = lib.topk_large_launch
    if fn.argtypes is None:
        v, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [v, i, v, i, v, v, i, i, v, i, i, i, f, f, i, i, i, i, i,
                       v, v, v, v, v, v]
        fn.restype = ctypes.c_int
    return fn


def topk_large(qdensified, q_dense, c_idx, c_val, c_dense, k: int,
               w_dense=None, w_sparse=None, n_valid: int | None = None,
               dense_kind: str = "ip"):
    """(scores f32[B, k], ids i32[B, k]) over rows [0, n_valid), score
    descending, ties toward the lower row id, NaN first.  Components and
    weights follow ``fused_topk``: ``qdensified`` [B, V+1] (zero trash
    column last) with ``c_idx`` i32 / ``c_val`` [N, NNZ], ``q_dense``
    [B, Dd] with ``c_dense`` [N, Dd]; ``None`` drops a part; sparse and
    fused spaces take ``dense_kind='ip'`` only.  Requires
    1 <= k <= n_valid."""
    global launches
    has_dense, has_sparse = c_dense is not None, c_idx is not None
    if not (has_dense or has_sparse):
        raise ValueError("topk_large: no components to score")
    if dense_kind not in ("ip", "l2") or (has_sparse and dense_kind != "ip"):
        raise ValueError(f"topk_large serves dense ip/l2 and sparse/fused ip, not {dense_kind!r}")
    weighted, wd, ws = _weights(w_dense, w_sparse, has_dense, has_sparse)
    lead = c_dense if has_dense else c_idx
    n = lead.shape[0]
    n_valid = n if n_valid is None else max(0, min(int(n_valid), n))
    if not 1 <= k <= n_valid:
        raise ValueError(f"k={k} outside 1..n_valid={n_valid}")
    if lead.device.type == "cpu":
        cut = lambda x: None if x is None else x[:n_valid]
        return ref.fused_topk_table_ref(qdensified, q_dense, cut(c_idx), cut(c_val), cut(c_dense),
                                        k, w_dense=w_dense, w_sparse=w_sparse,
                                        dense_kind=dense_kind)
    if lead.device.type != "cuda":
        raise ValueError(f"topk_large runs on cpu or cuda, not {lead.device}")
    dev = lead.device
    qd = qdt = None
    b = d = nnz = vp1 = 0
    if has_dense:
        qdt = q_dense.float().contiguous()     # upcast before the first multiply
        require_cuda("q_dense", qdt, (torch.float32,), 2, dev)
        require_cuda("c_dense", c_dense, _DTYPES, 2, dev)
        b, d = qdt.shape
        if c_dense.shape[1] != d:
            raise ValueError(f"q_dense {tuple(qdt.shape)} and c_dense {tuple(c_dense.shape)} disagree")
    if has_sparse:
        qd = qdensified.float().contiguous()
        require_cuda("qdensified", qd, (torch.float32,), 2, dev)
        require_cuda("c_idx", c_idx, (torch.int32,), 2, dev)
        require_cuda("c_val", c_val, _DTYPES, 2, dev)
        nnz, vp1 = c_idx.shape[1], qd.shape[1]
        if c_val.shape != c_idx.shape or (has_dense and c_idx.shape[0] != n) or \
                (has_dense and qd.shape[0] != b):
            raise ValueError("sparse shapes disagree: qdensified "
                             f"{tuple(qd.shape)}, c_idx {tuple(c_idx.shape)}, "
                             f"c_val {tuple(c_val.shape)}")
        b = qd.shape[0]
    pow2 = 1 << (k - 1).bit_length()
    scores = torch.empty((b, n_valid), dtype=torch.float32, device=dev)
    sort_s = torch.empty((b, pow2), dtype=torch.float32, device=dev)
    sort_i = torch.empty((b, pow2), dtype=torch.int32, device=dev)
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    blocks = max(1, min(-(-n_valid // 8), _SCORE_BLOCKS_PER_SM * _sms(dev)))
    fn = _declare(_build.load("topk_large"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptr(qd), vp1, ptr(qdt), d, ptr(c_idx), ptr(c_val if has_sparse else None),
                 int(has_sparse and c_val.dtype == torch.bfloat16), nnz, ptr(c_dense),
                 int(has_dense and c_dense.dtype == torch.bfloat16), int(dense_kind == "l2"),
                 int(weighted), wd, ws, b, n_valid, k, pow2, blocks, ptr(scores), ptr(sort_s),
                 ptr(sort_i), ptr(out_s), ptr(out_i), ctypes.c_void_p(stream))
    _build.check(err, "topk_large_launch")
    launches += 1
    return out_s, out_i
