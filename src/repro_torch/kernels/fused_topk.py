"""Exact fused dense+sparse top-k (B2), the counterpart of
``repro/kernels/fused_topk.py: fused_topk_pallas``.  Three cases, fixed by
the shape, dtype and alignment of ``c_dense``, ``c_idx`` and ``c_val``
before the launch (:func:`ring_layout`):

- **ring, box layout** (``csrc/fused_topk.cu``, ``fused_filter_launch``):
  16-byte aligned arrays whose rows are multiples of 16 bytes (MS MARCO's
  D = 768 and nnz = 128, f32 and bf16).  B1's route (``mips_topk.py``) on
  the fused ring: a sample of tiles scored and its top k taken, one scan
  of every other tile keeping the rows ahead of each block's threshold,
  one merge a query; the dense part in tensor-map boxes of 32 columns, the
  COO slots in boxes of 16 slots, 16 queries a block at every k, one
  block an SM.  From 17 to ``CLUSTER_QUERIES`` queries the blocks of the
  groups run as one thread-block cluster (``mips_topk.ring_grid``, two
  blocks an SM) that reads each stage once, multicast into all of them;
  above that a block a group, which was measured ahead there
  (:func:`fused_grid`).  Plan: ``mips_topk.filter_plan``.
- **ring, row layout** (the same entry point): arrays of at most 32
  columns (D even) and 32 slots whose rows no tensor map describes (DIN's
  items, D = 18, with one tag): a tile's dense rows, ids and values by one
  bulk copy each, two blocks an SM, a block a group.
- **scan** (``csrc/topk_scan.cu``, ``fused_topk_launch``): anything else
  (D = 61, an odd D of at most 32, a base off 16 bytes such as a shard
  view at an odd row of D = 18 f32, a dense and a value array of two
  dtypes).  Each block scans a row range and keeps a candidate list per
  query in shared memory (:func:`mips_topk.plan`).

For tensors on the CPU the wrappers run the plain versions
(``ref.fused_topk_table_ref``; ``ref.fused_filter_ref`` for the ring's
plan, either layout); for CUDA tensors they launch a kernel or raise:
nothing falls back to another route, and a cluster that does not launch
raises.  ``launches`` counts B2's launches on any route, ``ring_launches``
the ring's (either layout), ``row_launches`` the row layout's,
``cluster_launches`` the ring's launches in clusters and
``scan_launches`` the scan route's, nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.mips_topk import (_DTYPES, ROW_BLOCKS_PER_SM, ROW_COLS, TILE, RingGrid, _sms, check_k,
                                           cluster_fit, filter_buffers, filter_plan, plan, ptr, query_groups,
                                           require_cuda, ring_grid)
from repro_torch.kernels.query_index import build_index, query_index

ROW_SLOTS = 32               # the row layout's widest COO row (ring.cuh kRowSlots)
_ROW_SMEM = 112 * 1024       # a row-layout block's shared memory (ring.cuh RowStage::kSmem)
_QUERY_BYTES = 32 * 16 * 4   # its queries' columns, ahead of the ring (kQStage)
_WORDS_SMEM_CAP = 32768      # index words staged in shared memory up to this (topk_scan.cuh kWordsSmemCap)
GROUP = 16                   # queries of a block, and of a query-term index group (ring.cuh kQB)
BOX_BLOCKS_PER_SM = 1        # the box layout's blocks an SM, a block a group (ring.cuh BoxOne)
CLUSTER_QUERIES = 64         # B2's clusters up to this batch, a block a group above (PERF.md: measured ahead)

launches = 0
ring_launches = 0
row_launches = 0
cluster_launches = 0
scan_launches = 0


def _declare(lib, name):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        v, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        fn.argtypes = {
            "fused_topk_launch": [v, v, v, v, i, i, i, v, v, i, i, i, i, i, i, i, i, f, f,
                                  v, v, i, i, i, i, v, v, v],
            "fused_filter_launch": [v, v, i, i, v, v, v, v, i, i, i, i, i, i, i, i, i, i, f, f,
                                    i, i, i, i, v, v, i, i, i, ll, v, v, v, v, i, i, v, v, v, v, v, i, i, v]}[name]
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


def ring_layout(c_dense, c_idx, c_val, vocab: int) -> str | None:
    """The ring's tile layout for the present arrays: ``"box"`` (tensor
    maps: each array's rows a multiple of 16 bytes), ``"rows"`` (whole rows
    by bulk copies: D <= 32 and even, nnz <= 32, the stage at least twice
    in a row-layout block beside the index words), or None (the scan
    route).  Both need every array 16-byte aligned, and two parts of one
    dtype.  ``vocab`` is the query table's V (its width less one)."""
    arrays = [t for t in (c_dense, c_idx, c_val) if t is not None]
    if any(t.dim() != 2 or t.data_ptr() % 16 for t in arrays):
        return None
    dense, sparse = c_dense is not None, c_idx is not None
    if dense and sparse and c_dense.dtype != c_val.dtype:
        return None
    d, de = (c_dense.shape[1], c_dense.element_size()) if dense else (0, 4)
    nnz, ve = (c_idx.shape[1], c_val.element_size()) if sparse else (0, 4)
    if (not dense or d * de % 16 == 0) and (not sparse or (nnz * 4 % 16 == 0 and nnz * ve % 16 == 0)):
        return "box"
    if (dense and (d > ROW_COLS or d % 2)) or (sparse and nnz > ROW_SLOTS):
        return None
    words = (vocab // 32 + 1) * 8 if sparse else 0
    words = -(-words // 16) * 16 if words <= _WORDS_SMEM_CAP else 0   # staged in shared memory, 16-byte aligned
    stage = TILE * (d * de + nnz * (4 + ve))
    fit = (_ROW_SMEM - (_QUERY_BYTES if dense else 0) - words - 16) // stage
    return "rows" if fit >= 2 else None


def ring_blocks(layout: str | None, n_sms: int) -> int:
    """The fused ring's persistent blocks, a block a group, on a card of
    ``n_sms`` SMs: one an SM on the box layout (``ring.cuh`` BoxOne), two on
    the row layout (RowTile).  Clusters (BoxCluster, two blocks an SM) take
    as many as ``cudaOccupancyMaxActiveClusters`` gives
    (``mips_topk.ring_grid``)."""
    return n_sms * (ROW_BLOCKS_PER_SM if layout == "rows" else BOX_BLOCKS_PER_SM)


def fused_grid(b: int, layout: str | None, n_sms: int, cluster: bool | None = None, fit=None) -> RingGrid:
    """B2's grid for ``b`` queries (``mips_topk.ring_grid``): clusters on
    the box layout from 17 to ``CLUSTER_QUERIES`` queries, a block a group
    elsewhere; ``cluster=True`` asks for clusters at any B on the box
    layout, ``cluster=False`` for a block a group (the checks' and the
    timings' only: the answer is the same bit for bit)."""
    clustered = layout == "box" and (b <= CLUSTER_QUERIES if cluster is None else cluster)
    return ring_grid(b, ring_blocks(layout, n_sms), clustered, fit)


def ring_queries(q, qdensified, grid: RingGrid):
    """The queries as the fused ring's blocks read them for ``grid``: the
    dense ones grouped (``mips_topk.query_groups``) and the query-term index
    of each group of 16 (``query_index.build_index`` on the card, its plain
    version ``query_index`` elsewhere), each for ``grid.padded`` groups,
    those past the batch zero; None for an absent part."""
    qg = None if q is None else query_groups(q, grid.padded)
    if qdensified is None:
        return qg, None, None
    index = build_index if qdensified.device.type == "cuda" else query_index
    words, table = index(qdensified, GROUP, GROUP * grid.width)
    assert words.shape[0] == grid.padded, (words.shape, grid)
    return qg, words, table


def _args(qdensified, q_dense, c_idx, c_val, c_dense, k, w_dense, w_sparse, n_valid, dense_kind):
    """Checked arguments of a CUDA launch: (b, n, n_valid, d, nnz, vocab,
    queries f32, weighted, w_dense, w_sparse)."""
    has_dense, has_sparse = c_dense is not None, c_idx is not None
    if not (has_dense or has_sparse):
        raise ValueError("fused_topk: no components to score")
    corpus = c_dense if has_dense else c_idx
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
    q = None
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
    return b, n, n_valid, d, nnz, vocab, q, weighted, wd, ws


def fused_filter(qdensified, q_dense, c_idx, c_val, c_dense, k: int, w_dense=None, w_sparse=None,
                 n_valid: int | None = None, dense_kind: str = "ip", *, stride: int | None = None,
                 blocks: int | None = None, cluster: bool | None = None):
    """The ring route: (scores f32[B, K], ids i32[B, K], stats i32[B, 2]),
    stats holding per query the filter's list sorts and the candidates
    merged.  ``stride`` and ``blocks`` override ``filter_plan``;
    ``cluster`` as :func:`fused_grid`'s.  On the CPU: the plain emulation
    (``ref.fused_filter_ref``) of the same plan, its blocks those of
    :func:`fused_grid` at 132 SMs (with clusters ``persistent // width``,
    where the card asks ``cudaOccupancyMaxActiveClusters``)."""
    global launches, ring_launches, row_launches, cluster_launches
    has_dense, has_sparse = c_dense is not None, c_idx is not None
    corpus = c_dense if has_dense else c_idx
    vocab = qdensified.shape[1] - 1 if has_sparse else 0
    layout = ring_layout(c_dense, c_idx, c_val, vocab)
    if corpus is not None and corpus.device.type == "cpu":
        n = corpus.shape[0]
        nv = n if n_valid is None else max(0, min(int(n_valid), n))
        check_k(k, n)
        grid = fused_grid((q_dense if has_dense else qdensified).shape[0], layout, 132, cluster)
        p = filter_plan(n, nv, k, grid.blocks, stride, blocks)
        return ref.fused_filter_ref(qdensified, q_dense, c_idx, c_val, c_dense, k, p, w_dense=w_dense,
                                    w_sparse=w_sparse, dense_kind=dense_kind, n_valid=nv)
    b, n, n_valid, d, nnz, vocab, q, weighted, wd, ws = _args(
        qdensified, q_dense, c_idx, c_val, c_dense, k, w_dense, w_sparse, n_valid, dense_kind)
    if layout is None:
        raise ValueError("the ring route needs 16-byte aligned arrays of one dtype whose rows are multiples of "
                         f"16 bytes, or at most {ROW_COLS} even columns and {ROW_SLOTS} slots")
    dev = corpus.device
    lib = _build.load("fused_topk")
    bf16, l2 = (c_dense if has_dense else c_val).dtype == torch.bfloat16, dense_kind == "l2"
    grid = fused_grid(b, layout, _sms(dev), cluster,
                      cluster_fit(lib, "fused_ring_clusters", dev, has_dense, has_sparse, bf16, d, nnz, vocab, l2))
    p = filter_plan(n, n_valid, k, grid.blocks, stride, blocks)
    # the sparse part through the query-term index of each block's 16 queries, built here on the card
    qg, words, table = ring_queries(q, qdensified if has_sparse else None, grid)
    buf = filter_buffers(b, k, p, dev)
    fn = _declare(lib, "fused_filter_launch")
    with torch.cuda.device(dev), _build.LAUNCH_LOCK:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptr(qg), ptr(c_dense), _DTYPES[c_dense.dtype] if has_dense else 0, d, ptr(words), ptr(table),
                 ptr(c_idx), ptr(c_val), _DTYPES[c_val.dtype] if has_sparse else 0, nnz, vocab,
                 int(layout == "rows"), b, n, n_valid, k, int(l2), int(weighted), wd, ws,
                 *buf.args(p), grid.width, grid.rows, ctypes.c_void_p(stream))
        _build.check(err, "fused_filter_launch")
        launches += 1
        ring_launches += 1
        row_launches += int(layout == "rows")
        cluster_launches += int(grid.width > 1)
    return buf.out_s, buf.out_i, buf.stats


def fused_scan(qdensified, q_dense, c_idx, c_val, c_dense, k: int, w_dense=None, w_sparse=None,
               n_valid: int | None = None, dense_kind: str = "ip"):
    """The scan route (``topk_scan.cu``'s ``fused_topk_launch``), for any
    input: what :func:`fused_topk` runs where :func:`ring_layout` is None."""
    global launches, scan_launches
    corpus = c_dense if c_dense is not None else c_idx
    if corpus is not None and corpus.device.type == "cpu":
        return ref.fused_topk_table_ref(qdensified, q_dense, c_idx, c_val, c_dense, k, w_dense=w_dense,
                                        w_sparse=w_sparse, dense_kind=dense_kind, n_valid=n_valid)
    b, n, n_valid, d, nnz, vocab, q, weighted, wd, ws = _args(
        qdensified, q_dense, c_idx, c_val, c_dense, k, w_dense, w_sparse, n_valid, dense_kind)
    has_dense, has_sparse = c_dense is not None, c_idx is not None
    dev = corpus.device
    qb, buf, n_splits, rows = plan(b, n, k, _sms(dev))
    # the kernel reads the sparse part through a query-term index per block's group of qb queries
    words, table = build_index(qdensified, qb) if has_sparse else (None, None)
    part_s = torch.empty((b, n_splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, n_splits, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    fn = _declare(_build.load("topk_scan"), "fused_topk_launch")
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
        scan_launches += 1
    return out_s, out_i


def fused_topk(qdensified, q_dense, c_idx, c_val, c_dense, k: int,
               w_dense=None, w_sparse=None, n_valid: int | None = None,
               dense_kind: str = "ip"):
    """(scores f32[B, K], ids i32[B, K]), score descending, ties toward the
    lower row id.

    ``qdensified`` [B, V+1] (zero trash column last) with ``c_idx`` i32 /
    ``c_val`` [N, NNZ] form the sparse part; ``q_dense`` [B, Dd] with
    ``c_dense`` [N, Dd] the dense one; ``None`` drops a part.  Values are
    f32 or bf16.  Rows at or past ``n_valid`` score f32-min on the card
    (-inf in the plain version, as in the reference's oracle).  CUDA
    tensors take the ring route where :func:`ring_layout` gives a layout,
    else the scan route."""
    has_dense, has_sparse = c_dense is not None, c_idx is not None
    if not (has_dense or has_sparse):
        raise ValueError("fused_topk: no components to score")
    corpus = c_dense if has_dense else c_idx
    if corpus.device.type == "cpu":
        return ref.fused_topk_table_ref(
            qdensified, q_dense, c_idx, c_val, c_dense, k, w_dense=w_dense,
            w_sparse=w_sparse, dense_kind=dense_kind, n_valid=n_valid)
    vocab = qdensified.shape[1] - 1 if has_sparse else 0
    if corpus.device.type == "cuda" and ring_layout(c_dense, c_idx, c_val, vocab) is not None:
        return fused_filter(qdensified, q_dense, c_idx, c_val, c_dense, k, w_dense, w_sparse, n_valid,
                            dense_kind)[:2]
    return fused_scan(qdensified, q_dense, c_idx, c_val, c_dense, k, w_dense, w_sparse, n_valid, dense_kind)
