"""Fused dense+sparse scores ``[B, N]`` through the CUDA kernel in
``csrc/fused_score.cu`` (``fused_score_launch``), the counterpart of
``repro/kernels/sparse_dense.py: fused_score_pallas``:

    score[b, n] = w_dense * <q_dense[b], c_dense[n]>
                + w_sparse * sum_k qdensified[b, c_idx[n, k]] * c_val[n, k]

Both parts are required and both weights always apply (weight 0.0 still
multiplies), as in the TPU kernel.  For tensors on the CPU the wrapper
runs the plain version (``ref.fused_score_ref``); for CUDA tensors it
launches the kernel or raises.  ``launches`` counts kernel launches,
nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.mips_topk import _DTYPES, cdiv, ptr, require_cuda

QUERIES_PER_BLOCK = 16   # QB in fused_score.cu: the table's columns pad to it

launches = 0


def _declare(lib):
    fn = lib.fused_score_launch
    if fn.argtypes is None:
        v, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [v, i, v, v, i, i, i, v, v, i, i, i, i, f, f, v, v]
        fn.restype = ctypes.c_int
    return fn


def fused_score(qdensified, q_dense, c_idx, c_val, c_dense, w_dense: float = 1.0,
                w_sparse: float = 1.0) -> torch.Tensor:
    """f32 scores [B, N].  ``qdensified`` [B, V+1] is the densified query
    table with its zero trash column last, ``q_dense`` [B, Dd]; the
    corpus is ``c_idx`` i32 / ``c_val`` [N, NNZ] (pad id V) and
    ``c_dense`` [N, Dd], values f32 or bf16.  Any N: nothing is padded."""
    global launches
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
    # the kernel reads the table transposed, [V+1, b_pad]: the queries of
    # one block for one term id are contiguous and 16-byte aligned
    b_pad = cdiv(b, QUERIES_PER_BLOCK) * QUERIES_PER_BLOCK
    qdt = torch.zeros((vocab + 1, b_pad), dtype=torch.float32, device=dev)
    qdt[:, :b] = qdensified.float().T
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    fn = _declare(_build.load("fused_score"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptr(qdt), b_pad, ptr(c_idx), ptr(c_val), _DTYPES[c_val.dtype], nnz, vocab,
                 ptr(q), ptr(c_dense), _DTYPES[c_dense.dtype], d, b, n, float(w_dense),
                 float(w_sparse), ptr(out), ctypes.c_void_p(stream))
    _build.check(err, "fused_score_launch")
    launches += 1
    return out
