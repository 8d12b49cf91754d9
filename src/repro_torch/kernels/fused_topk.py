"""One-pass fused dense+sparse score and top-k through the CUDA kernel in
``csrc/topk_scan.cu`` (``fused_topk_launch``), the counterpart of
``repro/kernels/fused_topk.py: fused_topk_pallas``.  It shares the scan,
the selection and the launch plan with ``mips_topk``.

For tensors on the CPU the wrapper runs the plain version
(``ref.fused_topk_table_ref``); for CUDA tensors it launches the kernel
or raises.  ``launches`` counts kernel launches, nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.mips_topk import (_DTYPES, _sms, check_k, plan, ptr,
                                           require_cuda)
from repro_torch.kernels.query_index import build_index

launches = 0


def _declare(lib):
    fn = lib.fused_topk_launch
    if fn.argtypes is None:
        v, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [v, v, v, v, i, i, i, v, v, i, i, i, i, i, i, i, i, f, f,
                       v, v, i, i, i, i, v, v, v]
        fn.restype = ctypes.c_int
    return fn


def _weights(w_dense, w_sparse, has_dense: bool, has_sparse: bool):
    """(weighted, w_dense, w_sparse) under the reference's rules: ``None``
    weights leave a single part unscaled; two parts need both weights."""
    present = ([w_dense] if has_dense else []) + ([w_sparse] if has_sparse else [])
    weighted = any(w is not None for w in present)
    if weighted and any(w is None for w in present):
        raise ValueError("give weights for all present components or none")
    if not weighted and len(present) > 1:
        raise ValueError("mixing two components requires w_dense and "
                         "w_sparse (pass 1.0 explicitly for an unweighted sum)")
    return weighted, float(w_dense or 0.0), float(w_sparse or 0.0)


def fused_topk(qdensified, q_dense, c_idx, c_val, c_dense, k: int,
               w_dense=None, w_sparse=None, n_valid: int | None = None,
               dense_kind: str = "ip"):
    """(scores f32[B, K], ids i32[B, K]), score descending, ties toward the
    lower row id.

    ``qdensified`` [B, V+1] (zero trash column last) with ``c_idx`` i32 /
    ``c_val`` [N, NNZ] form the sparse part; ``q_dense`` [B, Dd] with
    ``c_dense`` [N, Dd] the dense one; ``None`` drops a part.  Values are
    f32 or bf16.  Rows at or past ``n_valid`` score f32-min on the card
    (-inf in the plain version, as in the reference's oracle)."""
    global launches
    has_dense, has_sparse = c_dense is not None, c_idx is not None
    if not (has_dense or has_sparse):
        raise ValueError("fused_topk: no components to score")
    corpus = c_dense if has_dense else c_idx
    if corpus.device.type == "cpu":
        return ref.fused_topk_table_ref(
            qdensified, q_dense, c_idx, c_val, c_dense, k, w_dense=w_dense,
            w_sparse=w_sparse, dense_kind=dense_kind, n_valid=n_valid)
    if corpus.device.type != "cuda":
        raise ValueError(f"fused_topk runs on cpu or cuda, not {corpus.device}")
    if dense_kind not in ("ip", "l2"):
        raise ValueError(f"fused_topk serves dense ip/l2, not {dense_kind!r}")
    weighted, wd, ws = _weights(w_dense, w_sparse, has_dense, has_sparse)
    dev = corpus.device
    n = corpus.shape[0]
    check_k(k, n)
    n_valid = n if n_valid is None else max(0, min(int(n_valid), n))
    b = (q_dense if has_dense else qdensified).shape[0]
    qb, buf, n_splits, rows = plan(b, n, k, _sms(dev))

    q = words = table = None
    d = nnz = vocab = 0
    if has_dense:
        q = q_dense.float().contiguous()   # upcast before the first multiply
        require_cuda("q_dense", q, (torch.float32,), 2, dev)
        require_cuda("c_dense", c_dense, _DTYPES, 2, dev)
        d = c_dense.shape[1]
        if q.shape != (b, d) or c_dense.shape[0] != n:
            raise ValueError("dense shapes disagree: q_dense "
                             f"{tuple(q.shape)}, c_dense {tuple(c_dense.shape)}")
    if has_sparse:
        require_cuda("c_idx", c_idx, (torch.int32,), 2, dev)
        require_cuda("c_val", c_val, _DTYPES, 2, dev)
        require_cuda("qdensified", qdensified, _DTYPES, 2, dev)
        nnz = c_idx.shape[1]
        vocab = qdensified.shape[1] - 1
        if c_val.shape != c_idx.shape or c_idx.shape[0] != n:
            raise ValueError("COO shapes disagree: c_idx "
                             f"{tuple(c_idx.shape)}, c_val {tuple(c_val.shape)}")
        if qdensified.shape[0] != b:
            raise ValueError(f"qdensified has {qdensified.shape[0]} rows, "
                             f"expected {b}")
        # the kernel reads the sparse part through a query-term index per
        # block's group of qb queries, built here on the card
        words, table = build_index(qdensified, qb)
    part_s = torch.empty((b, n_splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, n_splits, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    fn = _declare(_build.load("topk_scan"))
    with torch.cuda.device(dev), _build.LAUNCH_LOCK:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptr(words), ptr(table), ptr(c_idx if has_sparse else None),
                 ptr(c_val if has_sparse else None),
                 _DTYPES[c_val.dtype] if has_sparse else 0, nnz, vocab,
                 ptr(q), ptr(c_dense), _DTYPES[c_dense.dtype] if has_dense else 0,
                 d, b, n, n_valid, k, int(dense_kind == "l2"), int(weighted),
                 wd, ws, ptr(part_s), ptr(part_i), n_splits, rows, qb, buf,
                 ptr(out_s), ptr(out_i), ctypes.c_void_p(stream))
        _build.check(err, "fused_topk_launch")
        launches += 1
    return out_s, out_i
