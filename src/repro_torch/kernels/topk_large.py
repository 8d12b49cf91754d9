"""Exact top-k for k beyond the scan kernels' ``MAX_K`` through the CUDA
kernels in ``csrc/topk_large.cu``: the counterpart of
``repro/kernels/mips_topk.py: mips_topk_pallas`` and
``repro/kernels/fused_topk.py: fused_topk_pallas`` at such k, which the
reference's kernel backend serves as it serves any k.

Two steps.  :func:`large_scores` scores the first ``n_valid`` rows into a
[B, n_valid] buffer: a dense corpus that allows 16-byte copies through
``topk_large_dense_launch`` (register tiles fed by a ring of tensor-map
copies), a
fused corpus through B4 (``sparse_dense.fused_score``, which counts its own
launches: the fused ring with the same store-every-score epilogue, a block
a group, or this file's row kernel where no ring layout takes it), any
other through ``topk_large_rows_launch`` (one warp a row).  :func:`select_large` takes
each row's top k through ``topk_large_select_launch`` (radix passes over
every SM, then a sort of a short list per query).  Rows at or past
``n_valid`` are not scored: with k <= n_valid they never reach the
reference backend's top k (unless valid rows score a NaN with the sign
bit set, which ranks below the reference's -inf mask).

The dense ring takes a batch of more than 16 queries as thread-block
clusters (``mips_topk.ring_grid``): up to 8 groups of 16 queries share one
read of each corpus stage.

For tensors on the CPU the wrappers run the plain versions
(``ref.fused_table_scores``, ``select_topk``, and for :func:`topk_large`
the plain scan of ``ref`` over the first ``n_valid`` rows); for CUDA
tensors they launch the kernels or raise.  ``launches`` counts calls of
the three C entry points, nowhere else: two per request on the card;
``cluster_launches`` the dense ring's launches in clusters.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.brute_force import select_topk
from repro_torch.kernels import _build, ref
from repro_torch.kernels import sparse_dense as _score
from repro_torch.kernels.fused_topk import _weights
from repro_torch.kernels.mips_topk import (_DTYPES, RING_BLOCKS_PER_SM, _sms, cdiv, cluster_fit, ptr,
                                           query_groups, require_cuda, ring_grid)

SORT_SMEM = 16384          # kSortSmem: list entries the finish kernel sorts in shared memory
MIN_CAPACITY = 2048        # rows of the k-th key's bin collected without refining, at the least
PASS_ROWS = 2048           # kPassRows: a pass block's rows are a multiple of this
_PASS_BLOCKS_PER_SM = 8    # (query, chunk) blocks of a selection pass, per SM
_ROW_BLOCKS_PER_SM = 8     # 256-thread blocks of the one-warp-a-row kernel, per SM
HIST_INTS = 4096 + 2 * 1024 + 8    # kHistInts + State, per query

launches = 0
cluster_launches = 0


def _declare(lib):
    v, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    for name, args in (
            ("topk_large_dense_launch", [v, v, i, i, i, i, i, i, f, i, i, i, v, v]),
            ("topk_large_rows_launch", [v, i, v, i, v, v, i, i, v, i, i, i, f, f, i, i, i, v, v]),
            ("topk_large_select_launch", [v, i, i, i, i, i, i, ll, v, v, v, v, v, v])):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def library():
    """``csrc/topk_large.cu``'s library, its entry points declared."""
    return _declare(_build.load("topk_large"))


def launch_rows(lib, qd, q_dense, c_idx, c_val, c_dense, dense_kind: str, weighted: bool, wd: float, ws: float,
                scores: torch.Tensor):
    """One launch of row_kernel (``topk_large_rows_launch``: any space, one
    warp a row) into ``scores`` [B, n_valid] on its card's current stream:
    ``qd`` the densified queries f32 [B, V+1] with ``c_idx`` / ``c_val``,
    ``q_dense`` f32 [B, D] with ``c_dense``, each pair or None, contiguous.
    The caller holds ``_build.LAUNCH_LOCK`` under the card's device and
    counts the launch."""
    b, n_valid = scores.shape
    dev = scores.device
    d = 0 if q_dense is None else q_dense.shape[1]
    nnz, vp1 = (0, 0) if c_idx is None else (c_idx.shape[1], qd.shape[1])
    blocks = max(1, min(cdiv(n_valid, 8), _ROW_BLOCKS_PER_SM * _sms(dev)))
    err = lib.topk_large_rows_launch(
        ptr(qd), vp1, ptr(q_dense), d, ptr(c_idx), ptr(c_val), int(c_val is not None and c_val.dtype == torch.bfloat16),
        nnz, ptr(c_dense), int(c_dense is not None and c_dense.dtype == torch.bfloat16), int(dense_kind == "l2"),
        int(weighted), wd, ws, b, n_valid, blocks, ptr(scores),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(err, "topk_large_rows_launch")


def capacity(k: int) -> int:
    """Rows of the k-th key's bin that the selection collects without
    refining: enough that the list (at most k - 1 + capacity entries)
    fills the finish kernel's shared-memory sort, at least MIN_CAPACITY."""
    return max(SORT_SMEM - k, MIN_CAPACITY)


def select_shape(b: int, n: int, k: int, n_sms: int):
    """The selection's launch shape over a [b, n] buffer: (capacity, rows
    a pass block, pass blocks a query, list entries a query)."""
    cap = capacity(k)
    per_query = max(1, _PASS_BLOCKS_PER_SM * n_sms // b)
    chunk_rows = cdiv(cdiv(n, per_query), PASS_ROWS) * PASS_ROWS
    return cap, chunk_rows, cdiv(n, chunk_rows), 1 << (k + cap - 1).bit_length()


def _check(qdensified, q_dense, c_idx, c_dense, w_dense, w_sparse, n_valid, dense_kind):
    has_dense, has_sparse = c_dense is not None, c_idx is not None
    if not (has_dense or has_sparse):
        raise ValueError("topk_large: no components to score")
    if dense_kind not in ("ip", "l2") or (has_sparse and dense_kind != "ip"):
        raise ValueError(f"topk_large serves dense ip/l2 and sparse/fused ip, not {dense_kind!r}")
    weighted, wd, ws = _weights(w_dense, w_sparse, has_dense, has_sparse)
    n = (c_dense if has_dense else c_idx).shape[0]
    n_valid = n if n_valid is None else max(0, min(int(n_valid), n))
    return has_dense, has_sparse, weighted, wd, ws, n_valid


def large_scores(qdensified, q_dense, c_idx, c_val, c_dense, w_dense=None, w_sparse=None,
                 n_valid: int | None = None, dense_kind: str = "ip", *, cluster: bool = True) -> torch.Tensor:
    """f32 scores [B, n_valid] of the first ``n_valid`` rows, with
    ``topk_large``'s conventions.  ``cluster=False`` launches the dense
    ring a block a group (the checks' only: the answer is the same)."""
    global launches, cluster_launches
    has_dense, has_sparse, weighted, wd, ws, n_valid = _check(
        qdensified, q_dense, c_idx, c_dense, w_dense, w_sparse, n_valid, dense_kind)
    if n_valid < 1:
        raise ValueError("topk_large: no valid rows")
    lead = c_dense if has_dense else c_idx
    cut = lambda x: None if x is None else x[:n_valid]
    if lead.device.type == "cpu":
        return ref.fused_table_scores(qdensified, q_dense, cut(c_idx), cut(c_val), cut(c_dense),
                                      w_dense, w_sparse, dense_kind)
    if lead.device.type != "cuda":
        raise ValueError(f"topk_large runs on cpu or cuda, not {lead.device}")
    dev = lead.device
    if has_dense and has_sparse:   # B4 computes this function
        return _score.fused_score(qdensified, q_dense, cut(c_idx), cut(c_val), cut(c_dense), wd, ws)
    qdt = qd = None
    b = d = 0
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
        if c_val.shape != c_idx.shape:
            raise ValueError("sparse shapes disagree: qdensified "
                             f"{tuple(qd.shape)}, c_idx {tuple(c_idx.shape)}, "
                             f"c_val {tuple(c_val.shape)}")
        b = qd.shape[0]
    scores = torch.empty((b, n_valid), dtype=torch.float32, device=dev)
    lib = library()
    bf16 = has_dense and c_dense.dtype == torch.bfloat16
    l2 = dense_kind == "l2"
    ring = has_dense and d % (8 if bf16 else 4) == 0 and c_dense.data_ptr() % 16 == 0
    if ring:
        grid = ring_grid(b, RING_BLOCKS_PER_SM * _sms(dev), cluster,
                         cluster_fit(lib, "topk_large_dense_clusters", dev, bf16, d, l2))
        qg = query_groups(qdt, grid.padded)
    with torch.cuda.device(dev), _build.LAUNCH_LOCK:
        if ring:
            stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
            err = lib.topk_large_dense_launch(ptr(qg), ptr(c_dense), int(bf16), d, b, n_valid, int(l2),
                                              int(weighted), wd, max(1, min(cdiv(n_valid, 256), grid.blocks)),
                                              grid.width, grid.rows, ptr(scores), stream)
            _build.check(err, "topk_large_dense_launch")
            cluster_launches += int(grid.width > 1)
        else:
            launch_rows(lib, qd, qdt, c_idx, c_val if has_sparse else None, c_dense, dense_kind, weighted, wd, ws,
                        scores)
        launches += 1
    return scores


def select_large(scores: torch.Tensor, k: int):
    """(values f32[B, k], ids i32[B, k]): each row's top k in ``lax.top_k``'s
    order."""
    global launches
    b, n = scores.shape
    if not 1 <= k <= n:
        raise ValueError(f"k={k} outside 1..n_valid={n}")
    if scores.device.type == "cpu":
        vals, pos = select_topk(scores, k)
        return vals, pos.to(torch.int32)
    dev = scores.device
    require_cuda("scores", scores, (torch.float32,), 2, dev)
    cap, chunk_rows, chunks, list_cap = select_shape(b, n, k, _sms(dev))
    ws = torch.empty((b * (HIST_INTS + chunks),), dtype=torch.int32, device=dev)
    list_s = torch.empty((b, list_cap), dtype=torch.float32, device=dev)
    list_i = torch.empty((b, list_cap), dtype=torch.int32, device=dev)
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    lib = _declare(_build.load("topk_large"))
    with torch.cuda.device(dev), _build.LAUNCH_LOCK:
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        err = lib.topk_large_select_launch(ptr(scores), b, n, k, cap, chunk_rows, chunks, list_cap,
                                           ptr(ws), ptr(list_s), ptr(list_i), ptr(out_s), ptr(out_i),
                                           stream)
        _build.check(err, "topk_large_select_launch")
        launches += 1
    return out_s, out_i


def topk_large(qdensified, q_dense, c_idx, c_val, c_dense, k: int,
               w_dense=None, w_sparse=None, n_valid: int | None = None,
               dense_kind: str = "ip", *, cluster: bool = True):
    """(scores f32[B, k], ids i32[B, k]) over rows [0, n_valid) in
    ``lax.top_k``'s order (ties toward the lower row id).  Components and
    weights follow ``fused_topk``: ``qdensified`` [B, V+1] (zero trash
    column last) with ``c_idx`` i32 / ``c_val`` [N, NNZ], ``q_dense``
    [B, Dd] with ``c_dense`` [N, Dd]; ``None`` drops a part; sparse and
    fused spaces take ``dense_kind='ip'`` only.  Requires
    1 <= k <= n_valid.  ``cluster``: :func:`large_scores`'."""
    has_dense, has_sparse, _, _, _, nv = _check(qdensified, q_dense, c_idx, c_dense, w_dense,
                                                w_sparse, n_valid, dense_kind)
    if not 1 <= k <= nv:
        raise ValueError(f"k={k} outside 1..n_valid={nv}")
    lead = c_dense if has_dense else c_idx
    if lead.device.type == "cpu":
        cut = lambda x: None if x is None else x[:nv]
        return ref.fused_topk_table_ref(qdensified, q_dense, cut(c_idx), cut(c_val), cut(c_dense),
                                        k, w_dense=w_dense, w_sparse=w_sparse,
                                        dense_kind=dense_kind)
    scores = large_scores(qdensified, q_dense, c_idx, c_val, c_dense, w_dense, w_sparse, nv,
                          dense_kind, cluster=cluster)
    return select_large(scores, k)
