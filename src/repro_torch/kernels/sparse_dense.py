"""Fused dense+sparse scores ``[B, N]`` through the CUDA kernel in
``csrc/fused_score.cu`` (``fused_score_launch``), the counterpart of
``repro/kernels/sparse_dense.py: fused_score_pallas``:

    score[b, n] = w_dense * <q_dense[b], c_dense[n]>
                + w_sparse * sum_k qdensified[b, c_idx[n, k]] * c_val[n, k]

Both parts are required and both weights always apply (weight 0.0 still
multiplies), as in the TPU kernel.  The kernel reads the sparse part
through a query-term index per group of 16 queries
(``kernels/query_index.py``) and the dense queries from a transposed copy
(``query_columns``), both built here on the card.  For tensors on the CPU
the wrapper runs the plain version (``ref.fused_score_ref``); for CUDA
tensors it launches the kernel or raises.  ``launches`` counts kernel
launches, nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.mips_topk import _DTYPES, ptr, require_cuda
from repro_torch.kernels.query_index import build_index

INDEX_GROUP = 16          # kGroup in fused_score.cu: queries per index group
QUERIES_PER_BLOCK = 16    # kNarrowQB: queries per block for B <= 32
WIDE_QUERIES_PER_BLOCK = 64   # kWideQB: B > 32 (the NAPP build's 128 pivots)

launches = 0


def _declare(lib):
    fn = lib.fused_score_launch
    if fn.argtypes is None:
        v, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [v, v, v, v, i, i, i, v, i, v, i, i, i, i, i, f, f, v, v]
        fn.restype = ctypes.c_int
    return fn


def block_queries(b: int) -> int:
    """Queries per block for a batch of ``b``: 64 above 32 queries (a
    corpus tile is then read by ceil(b / 64) blocks, not ceil(b / 16)),
    else 16."""
    return WIDE_QUERIES_PER_BLOCK if b > 2 * QUERIES_PER_BLOCK else QUERIES_PER_BLOCK


def query_columns(q: torch.Tensor, qb: int) -> torch.Tensor:
    """The dense queries [B, D] as the kernel reads them: transposed to
    [D, b_pad] (zero columns past B), each block's ``qb`` columns ordered
    so that a thread's queries 4*qg.. and, at qb = 64, qb/2 + 4*qg.. lie
    where its one or two 16-byte shared-memory reads find them (thread qg
    holds queries 4*qg..4*qg+3 at qb = 16, 8*qg..8*qg+7 at qb = 64)."""
    b, d = q.shape
    b_pad = -(-b // qb) * qb
    q_t = torch.zeros((d, b_pad), dtype=torch.float32, device=q.device)
    if qb == QUERIES_PER_BLOCK:   # query order: two PyTorch calls on the NAPP probe's host path
        q_t[:, :b] = q.T
        return q_t
    j = torch.arange(qb, device=q.device)
    pos = (j // 8) * 4 + torch.where(j % 8 < 4, 0, qb // 2) + j % 4
    q_ids = torch.arange(b, device=q.device)
    q_t[:, q_ids - q_ids % qb + pos[q_ids % qb]] = q.T
    return q_t


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
    qb = block_queries(b)
    q_t = query_columns(q, qb)
    words, table = build_index(qdensified, INDEX_GROUP, qb)
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    fn = _declare(_build.load("fused_score"))
    with torch.cuda.device(dev), _build.LAUNCH_LOCK:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptr(words), ptr(table), ptr(c_idx), ptr(c_val), _DTYPES[c_val.dtype], nnz,
                 vocab, ptr(q_t), q_t.shape[1], ptr(c_dense), _DTYPES[c_dense.dtype], d, b, n, qb,
                 float(w_dense), float(w_sparse), ptr(out), ctypes.c_void_p(stream))
        _build.check(err, "fused_score_launch")
        launches += 1
    return out
