"""Exact dense ip / l2 top-k (B1), the counterpart of
``repro/kernels/mips_topk.py: mips_topk_pallas``.  Three cases, fixed by
the corpus's shape, dtype and alignment before the launch
(:func:`ring_layout`):

- **ring, tensor-map layout** (``csrc/mips_topk.cu``,
  ``mips_filter_launch``): a 16-byte aligned corpus whose rows are a
  multiple of 16 bytes (D = 768).  A sample of tiles is scored and its top
  k taken; its k-th (score, row) is a threshold no row of the answer lies
  behind; one scan of every other tile keeps only the rows ahead of each
  block's threshold in per-block lists, sorted in place when one could
  overflow; one block a query merges the sample's top k, the lists and the
  masked rows.  Plan: :func:`filter_plan`.
- **ring, row layout** (the same entry point): a 16-byte aligned corpus of
  at most 32 columns whose rows no tensor map can describe (DIN's and
  DIEN's D = 18, f32 and bf16).  The same plan, sample, filter and merge;
  the ring's stages take a tile's whole rows by one bulk copy.
- **scan** (``csrc/topk_scan.cu``, ``mips_topk_launch``): any other corpus
  (D = 61, a sliced view 4 bytes off).  Each block scans a row range and
  keeps a candidate list per query in shared memory; B2 (``fused_topk``)
  shares this kernel and its plan (:func:`plan`).

The tensor-map layout takes a batch of more than 16 queries as
thread-block clusters (:func:`ring_grid`): the blocks of up to 8 groups of
16 queries share one read of each corpus stage, multicast into all of
them, so the corpus is read once for every 128 queries and not once a
group.  The row layout keeps a block a group: its consumers, not its
bytes, bound it (PERF.md).

For tensors on the CPU the wrappers run the plain versions
(``ref.mips_topk_ref``; ``ref.mips_filter_ref`` for the ring's plan, either
layout); for CUDA tensors they launch a kernel or raise: nothing falls back
to another route, and a cluster that does not launch raises.  ``launches``
counts B1's launches on any route, ``ring_launches`` the ring's (either
layout), ``row_launches`` the row layout's, ``cluster_launches`` the ring's
launches in clusters (more than 16 queries) and ``scan_launches`` the scan
route's, nowhere else.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref

MAX_K = 2048
TILE = 256          # corpus rows per tile: the scan kernels' kRows, the ring's kTileRows
ROW_COLS = 32       # the ring's row layout: at most this many columns (its kChunk) ...
ROW_BLOCKS_PER_SM = 2   # ... and two of its blocks an SM (ring.cuh RowStage::kBlocksPerSM; B2's too)
RING_BLOCKS_PER_SM = 2  # B1's blocks an SM on either layout (ring.cuh Stage and RowStage kBlocksPerSM)
_BLOCKS_PER_SM = 4  # scan route: scan blocks to aim for, per SM
SAMPLE_STRIDE = 16  # ring route: at most every 16th tile is the sample's ...
SAMPLE_PER_K = 32   # ... and the sample holds at least 32 k rows where the corpus allows
GROUP = 16          # queries of a ring block (ring.cuh kQB)
MAX_CLUSTER = 8     # query groups of a cluster (ring.cuh kMaxCluster): 128 queries share a read
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
ring_launches = 0
row_launches = 0
cluster_launches = 0
scan_launches = 0


def check_k(k: int, n: int):
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside 1..{MAX_K}: the scan route's shared-"
                         "memory candidate lists hold at most "
                         f"{MAX_K} results per query (k above it is topk_large's)")
    if k > n:
        raise ValueError(f"k={k} exceeds the {n} corpus rows")


def plan(b: int, n: int, k: int, n_sms: int):
    """The scan route's launch shape (B1 on corpora neither ring layout
    takes, and B2): (queries per block, candidate-list slots, corpus
    splits, rows per split).  The list holds k plus one tile, rounded up
    to a power of two for the bitonic sort; 16 queries share a block
    while their lists stay within 64 KB of shared memory, else 4."""
    buf = 1 << (k + TILE - 1).bit_length()
    qb = 16 if buf <= 512 else 4
    target = cdiv(_BLOCKS_PER_SM * n_sms, cdiv(b, qb))
    n_splits = max(1, min(cdiv(n, 4 * TILE), target))
    rows = cdiv(cdiv(n, n_splits), TILE) * TILE
    return qb, buf, cdiv(n, rows), rows


class RingGrid(NamedTuple):
    """The ring's launch shape for a batch (``ring.cuh`` Grid)."""
    groups: int   # G = ceil(B / 16): the batch's groups of 16 queries
    width: int    # blocks of a cluster, one a group (1: no cluster, a block a group)
    rows: int     # rows of clusters along y: the corpus is read this many times
    blocks: int   # along x: the clusters of a row that fit the card at once (width 1: the persistent blocks)

    @property
    def padded(self) -> int:
        """The groups the launch holds, rows x width: those past the batch are zero."""
        return self.rows * self.width


def ring_grid(b: int, persistent: int, cluster: bool = True, fit=None) -> RingGrid:
    """The ring's grid for ``b`` queries on a card where ``persistent``
    blocks run at once (:func:`_ring_blocks`).  G = ceil(b / 16)
    groups; above one group, clusters of ``width = ceil(G / rows)`` blocks in
    ``rows = ceil(G / 8)`` rows, so that each row of clusters reads the corpus
    once for up to 128 queries; along x, ``fit(width)`` clusters (on the card
    ``cudaOccupancyMaxActiveClusters``; by default ``persistent // width``).
    ``cluster=False`` gives one group a block in G rows, each reading the
    whole corpus (the launch of one group; only the checks ask for it)."""
    if b < 1:
        raise ValueError(f"the ring needs at least one query, got {b}")
    groups = cdiv(b, GROUP)
    if not cluster or groups == 1:
        return RingGrid(groups, 1, groups, persistent)
    rows = cdiv(groups, MAX_CLUSTER)
    width = cdiv(groups, rows)
    blocks = persistent // width if fit is None else int(fit(width))
    if blocks < 1:
        raise RuntimeError(f"no cluster of {width} ring blocks fits the card")
    return RingGrid(groups, width, rows, blocks)


_FITS: dict = {}


def cluster_fit(lib, entry: str, device: torch.device, *shape):
    """``fit(width)`` for :func:`ring_grid` on the card: the clusters of that
    width of the kernel behind ``entry`` (``mips_ring_clusters``,
    ``topk_large_dense_clusters`` or ``fused_ring_clusters``: ``shape`` is
    its integer arguments before ``width``) that fit at once, asked once a
    shape."""
    def fit(width: int) -> int:
        key = (entry, *shape, width, device.index)
        if key not in _FITS:
            fn = getattr(lib, entry)
            if fn.argtypes is None:
                fn.argtypes = [ctypes.c_int] * (len(shape) + 1) + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
            out = ctypes.c_int(0)
            with torch.cuda.device(device):
                _build.check(fn(*(int(x) for x in shape), width, ctypes.byref(out)), entry)
            _FITS[key] = out.value
        return _FITS[key]
    return fit


class FilterPlan(NamedTuple):
    stride: int          # the sample is tiles 0, stride, 2 * stride, ...
    cols: int            # its rows below n_valid: the sample buffer's width
    k_sample: int        # the sample's top list, min(k, cols); at stride 1 every sampled row, cols
    sample_blocks: int   # ring blocks of the sample pass
    blocks: int          # ring blocks of the filter pass (0: every tile is the sample's)
    slots: int           # a filter block's list per query: a power of two >= k + TILE
    masked: int          # rows past n_valid that may enter the answer: min(k, n - n_valid)


def filter_plan(n: int, n_valid: int, k: int, n_sms: int, stride: int | None = None,
                blocks: int | None = None) -> FilterPlan:
    """The ring route's plan.  The sample takes every ``stride``-th tile,
    ``stride`` at most SAMPLE_STRIDE and at most n_valid / (32 k), so that
    the sample holds 32 k rows where it can (every row of a small corpus);
    on exchangeable data about k * (stride - 1) rows a query then pass the
    filter.  A filter block's list holds k plus one tile, rounded up to a
    power of two: sorted down to k, it has room for the next tile.
    ``n_sms`` is the ring's blocks along x (:func:`ring_grid`'s ``blocks``:
    the persistent blocks, :func:`_ring_blocks`, or in a cluster launch the
    clusters of a row; the blocks of a cluster share their tiles and each
    keeps its own queries' lists).  ``stride`` and ``blocks`` (the filter's
    blocks, at most ``n_sms`` by default) may be given, as the checks do to
    make the lists overflow."""
    tiles = cdiv(n_valid, TILE)
    if stride is None:
        stride = max(1, min(SAMPLE_STRIDE, n_valid // (SAMPLE_PER_K * k)))
    sampled = cdiv(tiles, stride)
    cols = 0 if tiles == 0 else (sampled - 1) * TILE + min(TILE, n_valid - (sampled - 1) * stride * TILE)
    units = tiles - sampled
    blocks = min(n_sms if blocks is None else blocks, units)
    slots = 1 << (k + TILE - 1).bit_length()
    k_sample = cols if stride == 1 else min(k, cols)
    return FilterPlan(stride, cols, k_sample, min(n_sms, sampled), blocks, slots, min(k, n - n_valid))


class FilterBuffers(NamedTuple):
    """The device buffers of one ring-route call (B1's and B2's): the
    sample's scores, the selection's workspace, lists and top list, the
    filter's lists, counts and stats, and the answer."""
    sample: torch.Tensor
    ws: torch.Tensor | None
    sel: tuple              # (cap, chunk_rows, chunks, list_cap)
    sel_s: torch.Tensor | None
    sel_i: torch.Tensor | None
    top_s: torch.Tensor | None
    top_i: torch.Tensor | None
    lists: torch.Tensor
    counts: torch.Tensor
    stats: torch.Tensor
    out_s: torch.Tensor
    out_i: torch.Tensor

    def args(self, p: FilterPlan):
        """The plan and buffer arguments of ``mips_filter_launch`` and
        ``fused_filter_launch``, in their order (from ``stride`` on)."""
        cap, chunk_rows, chunks, list_cap = self.sel
        return (p.stride, p.cols, p.k_sample, p.sample_blocks, ptr(self.sample), ptr(self.ws), cap, chunk_rows,
                chunks, list_cap, ptr(self.sel_s), ptr(self.sel_i), ptr(self.top_s), ptr(self.top_i), p.blocks,
                p.slots, ptr(self.lists), ptr(self.counts), ptr(self.stats), ptr(self.out_s), ptr(self.out_i))


def filter_buffers(b: int, k: int, p: FilterPlan, dev: torch.device) -> FilterBuffers:
    """The ring route's buffers for ``b`` queries under plan ``p``."""
    f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32, device=dev)
    ks = p.k_sample
    ws = sel_s = sel_i = top_s = top_i = None
    sel = (0, 0, 0, 0)
    if p.stride > 1:   # the sample's top k through topk_large's selection (imported here:
        # topk_large imports this module); at stride 1 the merge reads the sample
        from repro_torch.kernels.topk_large import HIST_INTS, select_shape
        sel = select_shape(b, p.cols, ks, _sms(dev))
        ws = torch.empty((b * (HIST_INTS + sel[2]),), **i32)
        sel_s, sel_i = torch.empty((b, sel[3]), **f32), torch.empty((b, sel[3]), **i32)
        top_s, top_i = torch.empty((b, ks), **f32), torch.empty((b, ks), **i32)
    return FilterBuffers(torch.empty((b, p.cols), **f32), ws, sel, sel_s, sel_i, top_s, top_i,
                         torch.empty((b, p.blocks, p.slots), dtype=torch.int64, device=dev),
                         torch.empty((b, p.blocks), **i32), torch.empty((b, 2), **i32),
                         torch.empty((b, k), **f32), torch.empty((b, k), **i32))


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def require_cuda(name: str, t: torch.Tensor, dtypes, ndim: int,
                 device: torch.device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of "
                         f"{tuple(dtypes)}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def query_groups(q: torch.Tensor, groups: int | None = None) -> torch.Tensor:
    """The dense queries [B, D] as the ring's stages copy them:
    [groups, D rounded up to 32, 16] (``groups`` at least ceil(B / 16), the
    grid's :attr:`RingGrid.padded`), a group's 16 values of a column
    contiguous, zero past B and D."""
    b, d = q.shape
    groups, d_pad = max(cdiv(b, GROUP), groups or 0), cdiv(d, 32) * 32
    out = torch.zeros((groups * 16, d_pad), dtype=torch.float32, device=q.device)
    out[:b, :d] = q
    return out.view(groups, 16, d_pad).transpose(1, 2).contiguous()


def ring_layout(corpus: torch.Tensor) -> str | None:
    """The ring's stage layout for the corpus's rows: ``"box"`` (a tensor
    map: rows of a multiple of 16 bytes), ``"rows"`` (whole rows by bulk
    copies: at most ROW_COLS columns), or None (the scan route).  Both need
    a 16-byte aligned base."""
    if corpus.dim() != 2 or corpus.data_ptr() % 16:
        return None
    if corpus.shape[1] * corpus.element_size() % 16 == 0:
        return "box"
    return "rows" if corpus.shape[1] <= ROW_COLS else None


def _ring_blocks(corpus: torch.Tensor, n_sms: int) -> int:
    """B1's persistent ring blocks on a card of ``n_sms`` SMs:
    RING_BLOCKS_PER_SM on either layout."""
    return n_sms * RING_BLOCKS_PER_SM


def ring_fits(corpus: torch.Tensor) -> bool:
    """Whether B1's ring route takes the corpus (either layout)."""
    return ring_layout(corpus) is not None


def _declare(lib, name):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        v, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = {
            "mips_topk_launch": [v, v, i, i, i, i, i, i, i, v, v, i, i, i, i, v, v, v],
            "mips_filter_launch": [v, v, i, i, i, i, i, i, i, i, i, i, i, v, v, i, i, i, ll, v, v, v, v,
                                   i, i, v, v, v, v, v, i, i, v]}[name]
        fn.restype = ctypes.c_int
    return fn


def _check(queries, corpus, k, n_valid, space):
    if corpus.device.type != "cuda":
        raise ValueError(f"mips_topk runs on cpu or cuda, not {corpus.device}")
    if space not in ("ip", "l2"):
        raise ValueError(f"mips_topk serves ip/l2, not {space!r}")
    dev = corpus.device
    n, d = corpus.shape
    check_k(k, n)
    n_valid = n if n_valid is None else max(0, min(int(n_valid), n))
    q = queries.float().contiguous()      # upcast before the first multiply
    require_cuda("queries", q, (torch.float32,), 2, dev)
    require_cuda("corpus", corpus, _DTYPES, 2, dev)
    if q.shape[1] != d:
        raise ValueError(f"queries have {q.shape[1]} dims, corpus {d}")
    return q, n_valid


def mips_filter(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                n_valid: int | None = None, space: str = "ip", *, stride: int | None = None,
                blocks: int | None = None, cluster: bool = True):
    """The ring route: (scores f32[B, K], ids i32[B, K], stats i32[B, 2]),
    stats holding per query the filter's list sorts and the candidates
    merged.  ``stride`` and ``blocks`` override :func:`filter_plan`;
    ``cluster=False`` launches a block a group where the tensor-map layout
    would launch clusters (the checks' only: the answer is the same).  On
    the CPU: the plain emulation (``ref.mips_filter_ref``) of the same plan,
    its blocks those of :func:`ring_grid` at 132 SMs (with clusters
    ``persistent // width``, where the card asks
    ``cudaOccupancyMaxActiveClusters``); no cluster runs there."""
    global launches, ring_launches, row_launches, cluster_launches
    layout = ring_layout(corpus)
    cluster = cluster and layout == "box"
    if corpus.device.type == "cpu":
        n = corpus.shape[0]
        nv = n if n_valid is None else max(0, min(int(n_valid), n))
        check_k(k, n)
        grid = ring_grid(queries.shape[0], _ring_blocks(corpus, 132), cluster)
        p = filter_plan(n, nv, k, grid.blocks, stride, blocks)
        return ref.mips_filter_ref(queries, corpus, k, p, n_valid=nv, space=space)
    q, n_valid = _check(queries, corpus, k, n_valid, space)
    if layout is None:
        raise ValueError("the ring route needs a 16-byte aligned corpus whose rows are a multiple of 16 "
                         f"bytes or at most {ROW_COLS} columns")
    dev = corpus.device
    n, d = corpus.shape
    b = q.shape[0]
    lib = _build.load("mips_topk")
    bf16, l2 = corpus.dtype == torch.bfloat16, space == "l2"
    grid = ring_grid(b, _ring_blocks(corpus, _sms(dev)), cluster,
                     cluster_fit(lib, "mips_ring_clusters", dev, bf16, d, l2))
    p = filter_plan(n, n_valid, k, grid.blocks, stride, blocks)
    qg = query_groups(q, grid.padded)
    buf = filter_buffers(b, k, p, dev)
    fn = _declare(lib, "mips_filter_launch")
    with torch.cuda.device(dev), _build.LAUNCH_LOCK:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptr(qg), ptr(corpus), _DTYPES[corpus.dtype], d, b, n, n_valid, k, int(l2),
                 *buf.args(p), grid.width, grid.rows, ctypes.c_void_p(stream))
        _build.check(err, "mips_filter_launch")
        launches += 1
        ring_launches += 1
        row_launches += int(layout == "rows")
        cluster_launches += int(grid.width > 1)
    return buf.out_s, buf.out_i, buf.stats


def mips_scan(queries: torch.Tensor, corpus: torch.Tensor, k: int,
              n_valid: int | None = None, space: str = "ip"):
    """The scan route (``topk_scan.cu``), for any corpus: what
    :func:`mips_topk` runs where :func:`ring_fits` is false."""
    global launches, scan_launches
    if corpus.device.type == "cpu":
        return ref.mips_topk_ref(queries, corpus, k, n_valid=n_valid, space=space)
    q, n_valid = _check(queries, corpus, k, n_valid, space)
    dev = corpus.device
    n, d = corpus.shape
    b = q.shape[0]
    qb, buf, n_splits, rows = plan(b, n, k, _sms(dev))
    part_s = torch.empty((b, n_splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, n_splits, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    fn = _declare(_build.load("topk_scan"), "mips_topk_launch")
    with torch.cuda.device(dev), _build.LAUNCH_LOCK:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptr(q), ptr(corpus), _DTYPES[corpus.dtype], b, n, d,
                 n_valid, k, int(space == "l2"), ptr(part_s), ptr(part_i),
                 n_splits, rows, qb, buf, ptr(out_s), ptr(out_i),
                 ctypes.c_void_p(stream))
        _build.check(err, "mips_topk_launch")
        launches += 1
        scan_launches += 1
    return out_s, out_i


def mips_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int,
              n_valid: int | None = None, space: str = "ip"):
    """queries [B, D], corpus [N, D] (f32 or bf16) -> (scores f32[B, K],
    ids i32[B, K]), score descending, ties toward the lower row id.  Rows
    at or past ``n_valid`` score f32-min.  Any N: no padding needed."""
    if corpus.device.type == "cpu":
        return ref.mips_topk_ref(queries, corpus, k, n_valid=n_valid,
                                 space=space)
    if corpus.device.type == "cuda" and ring_fits(corpus):
        return mips_filter(queries, corpus, k, n_valid, space)[:2]
    return mips_scan(queries, corpus, k, n_valid, space)
