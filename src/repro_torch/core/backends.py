"""Execution backends (counterpart of ``repro/core/backends.py``): the
exact tier and the approximate one.

Every corpus-scoring call goes through one seam::

    backend.topk(space, query_repr, corpus, k, n_valid) -> TopK

with these registered implementations:

  * ``reference`` -- one-shot ``exact_topk`` over the full [B, N] score
    matrix; serves every space and is the semantic ground truth;
  * ``streaming`` -- ``streaming_topk`` over row tiles with a running
    top-k, bounded memory, any row-major corpus;
  * ``cuda`` -- the hand-written score+top-k kernels: ``mips_topk`` for
    dense ip/l2 corpora, ``fused_topk`` for fused/sparse ip corpora, f32
    or bf16.  The name ``"pallas"`` resolves to it too, so descriptors
    written by ``repro`` still name a backend.  On CPU tensors the
    kernel wrappers run their plain versions;
  * ``graph_ann`` -- approximate top-k by beam search over a proximity
    graph (``core.graph_ann``), under the measured-recall tier; with
    ``kernel=True`` the hops run through the beam-hop kernel;
  * ``napp`` -- approximate top-k by pivot-permutation filtering and an
    exact re-rank (``core.napp``), under the same tier.

:func:`resolve_backend` falls back to ``reference`` for a space outside
the kernel's ``supports`` matrix (cosine, say), as ``repro`` does, and
``"auto"`` (or ``None``) picks an exact backend by size and device.
Inside the matrix there is no fallback: a kernel that fails to build or
launch raises.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Callable, Dict, Optional, Protocol, runtime_checkable

import torch

from repro_torch.core.brute_force import TopK, exact_topk, pad_corpus, streaming_topk
from repro_torch.core.sparse import SparseVectors
from repro_torch.core.spaces import (DenseSpace, FusedSpace, FusedVectors,
                                     SparseSpace, map_tensors, tensor_leaves)

__all__ = [
    "ExecutionBackend",
    "ReferenceBackend",
    "StreamingBackend",
    "CudaBackend",
    "GraphANNBackend",
    "NappBackend",
    "ANN_RECALL_TARGET",
    "AUTO_PALLAS_MIN_ROWS",
    "AUTO_STREAMING_MIN_ROWS",
    "ann_index_cache_info",
    "clear_ann_index_cache",
    "invalidate_ann_index_entries",
    "register_backend",
    "available_backends",
    "make_backend",
    "resolve_backend",
    "backend_identity",
    "legal_tile",
    "auto_tile_n",
    "tile_cache_info",
    "clear_tile_cache",
]

# The measured-recall tier: an approximate backend's recall@k against the
# exact oracle, at its declared budget, must reach this.
ANN_RECALL_TARGET = 0.95

# "auto": the kernel backend (``pallas`` in repro) from this many rows,
# the streaming scan from this many once the kernel cannot serve.
AUTO_PALLAS_MIN_ROWS = 4096
AUTO_STREAMING_MIN_ROWS = 32768


@runtime_checkable
class ExecutionBackend(Protocol):
    """The seam every corpus-scoring call flows through."""

    name: str

    @property
    def identity(self) -> str:
        """Stable configuration string (folded into serving cache keys)."""
        ...

    def supports(self, space, corpus) -> Optional[str]:
        """None if this backend can serve (space, corpus); else the reason."""
        ...

    def topk(self, space, query_repr, corpus, k: int,
             n_valid: Optional[int] = None) -> TopK:
        ...


def legal_tile(n_rows: int, requested: int) -> int:
    """Clamp a requested tile to the corpus: a tile never exceeds N."""
    return max(1, min(requested, n_rows))


# Warm tile cache: the sweep is pure in its arguments, so it runs once per
# distinct (rows, batch, k, bytes and flops per row, resident bytes) and
# every later call is a dict hit.  Under a lock, because served endpoints
# ask from batcher worker threads at once; the sweep is a handful of
# closed-form evaluations, cheap enough to run under it, which keeps the
# counters exact (each call is one hit or one miss).
_TILE_CACHE: Dict[tuple, int] = {}
_TILE_CACHE_LOCK = threading.Lock()
_TILE_CACHE_HITS = 0
_TILE_CACHE_MISSES = 0


def tile_cache_info() -> Dict[str, int]:
    """Entry count and lifetime hit/miss counters of the tile cache."""
    with _TILE_CACHE_LOCK:
        return {"size": len(_TILE_CACHE), "hits": _TILE_CACHE_HITS,
                "misses": _TILE_CACHE_MISSES}


def clear_tile_cache():
    """Drop every warm tile and zero the counters."""
    global _TILE_CACHE_HITS, _TILE_CACHE_MISSES
    with _TILE_CACHE_LOCK:
        _TILE_CACHE.clear()
        _TILE_CACHE_HITS = 0
        _TILE_CACHE_MISSES = 0


def auto_tile_n(n_rows: int, *, b: int, k: int, bytes_per_row: float,
                flops_per_row: float, resident_bytes: float = 0.0) -> int:
    """The legal tile (a power of two from 128 to 16384, clamped to the
    corpus) with the least estimated seconds per corpus row on the H100
    model (``launch.roofline.topk_tile_seconds``), among the tiles whose
    working set fits half a block's shared memory: the resident operands
    (``resident_bytes``), the streamed tile double-buffered and the
    ``[B, tile]`` f32 score block.  Ties go to the larger tile.  With no
    tile fitting, 128.

    The CUDA kernels choose their own launch shape and the streaming
    backend keeps its fixed tile, as ``repro``'s does; the sweep is kept
    so that snapshots carry the same warm-cache counters
    (:func:`tile_cache_info`)."""
    global _TILE_CACHE_HITS, _TILE_CACHE_MISSES
    key = (int(n_rows), int(b), int(k), float(bytes_per_row),
           float(flops_per_row), float(resident_bytes))
    with _TILE_CACHE_LOCK:
        cached = _TILE_CACHE.get(key)
        if cached is not None:
            _TILE_CACHE_HITS += 1
            return cached
        from repro_torch.launch.roofline import SMEM_BYTES, topk_tile_seconds

        budget = SMEM_BYTES // 2      # headroom for the compiler's own use
        best, best_cost = 128, None
        tile = 128
        while tile <= 16384:
            if resident_bytes + tile * (2 * bytes_per_row + 4 * b) <= budget:
                cost = topk_tile_seconds(
                    tile, b=b, k=k, bytes_per_row=bytes_per_row,
                    flops_per_row=flops_per_row) / tile
                if best_cost is None or cost <= best_cost:
                    best, best_cost = tile, cost
            tile *= 2
        result = legal_tile(n_rows, best)
        _TILE_CACHE[key] = result
        _TILE_CACHE_MISSES += 1
        return result


def _dense_rows(corpus) -> Optional[int]:
    """Row count if ``corpus`` is a dense [N, D] tensor, else None."""
    if isinstance(corpus, torch.Tensor) and corpus.dim() == 2:
        return int(corpus.shape[0])
    return None


def _rows(corpus) -> Optional[int]:
    """Row count of a row-major corpus (tensor, ``SparseVectors``,
    ``FusedVectors``) whose leaves agree on ``shape[0]``, else None."""
    try:
        leaves = tensor_leaves(corpus)
    except TypeError:
        return None
    rows = {int(t.shape[0]) for t in leaves if t.dim() >= 1}
    if not leaves or len(rows) != 1 or any(t.dim() < 1 for t in leaves):
        return None
    return rows.pop()


def _batch_rows(query_repr) -> int:
    return int(tensor_leaves(query_repr)[0].shape[0])


def _device(query_repr) -> torch.device:
    return tensor_leaves(query_repr)[0].device


def _reference_tail(head: TopK, b: int, k: int, n_valid: int) -> TopK:
    """Extend a ``min(k, n_valid)``-column result to ``k`` columns with the
    reference path's degenerate tail: -inf scores and ids continuing from
    the first masked row (n_valid, n_valid + 1, ...)."""
    dev = head.scores.device
    pad = k - head.scores.shape[1]
    scores = torch.cat([head.scores, torch.full((b, pad), -torch.inf,
                                                dtype=torch.float32, device=dev)], dim=1)
    ids = n_valid + torch.arange(pad, dtype=torch.int32, device=dev)
    indices = torch.cat([head.indices, ids.expand(b, pad)], dim=1)
    return TopK(scores, indices)


def _empty_topk(b: int, device) -> TopK:
    return TopK(torch.zeros((b, 0), dtype=torch.float32, device=device),
                torch.zeros((b, 0), dtype=torch.int32, device=device))


@dataclasses.dataclass(frozen=True)
class ReferenceBackend:
    """One-shot exact top-k (``exact_topk``): the ground-truth path."""

    name = "reference"

    @property
    def identity(self) -> str:
        return "reference"

    def supports(self, space, corpus) -> Optional[str]:
        return None

    def topk(self, space, query_repr, corpus, k: int,
             n_valid: Optional[int] = None) -> TopK:
        return exact_topk(space, query_repr, corpus, k, n_valid)


@dataclasses.dataclass(frozen=True)
class StreamingBackend:
    """Tiled exact top-k (``streaming_topk``): bounded memory, any
    row-major corpus, each tile scored through the space's own
    ``score_batch``.  A corpus that is not a multiple of the tile is
    zero-padded up to it; the padding rows score -inf through the valid
    count."""

    tile_n: int = 8192
    name = "streaming"

    @property
    def identity(self) -> str:
        return f"streaming(tile_n={self.tile_n})"

    def supports(self, space, corpus) -> Optional[str]:
        if _rows(corpus) is None:
            return ("streaming backend needs a row-major corpus "
                    "(tensor, SparseVectors or FusedVectors)")
        return None

    def topk(self, space, query_repr, corpus, k: int,
             n_valid: Optional[int] = None) -> TopK:
        n = _rows(corpus)
        tile = legal_tile(n, self.tile_n)
        n_valid = n if n_valid is None else min(n_valid, n)
        k_eff = min(k, n_valid)   # the heap's (-inf, 0) start slots must
        b = _batch_rows(query_repr)   # never displace the reference's tail
        if not k_eff:
            head = _empty_topk(b, _device(query_repr))
        else:
            corpus, _ = pad_corpus(corpus, tile)
            head = streaming_topk(space, query_repr, corpus, k_eff, tile_n=tile,
                                  n_valid=n_valid)
        return head if k_eff == k else _reference_tail(head, b, k, n_valid)


_DTYPES = (torch.float32, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class CudaBackend:
    """The hand-written score+top-k kernels: ``kernels.mips_topk`` for
    dense spaces, ``kernels.fused_topk`` for fused/sparse spaces, with the
    space's learned ``w_dense``/``w_sparse`` passed to the launch.  A k
    beyond their ``MAX_K`` goes to ``kernels.topk_large``, whose kernels
    serve any k."""

    name = "cuda"

    @property
    def identity(self) -> str:
        return "cuda"

    def supports(self, space, corpus) -> Optional[str]:
        if isinstance(space, DenseSpace):
            if space.kind not in ("ip", "l2"):
                return f"cuda kernel serves ip/l2, not {space.kind!r}"
            if _dense_rows(corpus) is None:
                return "cuda kernel needs a dense [N, D] corpus tensor"
            if corpus.dtype not in _DTYPES:
                return f"cuda kernel serves f32/bf16 corpora, not {corpus.dtype}"
            return None
        if isinstance(space, SparseSpace):
            if space.kind != "ip":
                return f"cuda fused kernel serves sparse ip only, not {space.kind!r}"
            if not isinstance(corpus, SparseVectors):
                return "cuda fused kernel needs a SparseVectors corpus"
            if corpus.values.dtype not in _DTYPES:
                return ("cuda fused kernel serves f32/bf16 sparse values, "
                        f"not {corpus.values.dtype}")
            return None
        if isinstance(space, FusedSpace):
            if not isinstance(corpus, FusedVectors):
                return "cuda fused kernel needs a FusedVectors corpus"
            if corpus.dense is None and corpus.sparse is None:
                return "fused corpus has no components"
            if corpus.dense is not None:
                # the same matrix as the reference's kernel backend
                if space.dense_kind != "ip":
                    return ("cuda fused kernel serves dense_kind 'ip', "
                            f"not {space.dense_kind!r}")
                if corpus.dense.dtype not in _DTYPES:
                    return ("cuda fused kernel serves f32/bf16 dense "
                            f"components, not {corpus.dense.dtype}")
            if (corpus.sparse is not None
                    and corpus.sparse.values.dtype not in _DTYPES):
                return ("cuda fused kernel serves f32/bf16 sparse values, "
                        f"not {corpus.sparse.values.dtype}")
            return None
        return (f"cuda kernels serve dense/sparse/fused spaces, "
                f"not {type(space).__name__}")

    def topk(self, space, query_repr, corpus, k: int,
             n_valid: Optional[int] = None) -> TopK:
        from repro_torch.kernels import ops   # kernels import core
        from repro_torch.kernels.mips_topk import MAX_K

        n = _rows(corpus)
        n_valid = n if n_valid is None else min(n_valid, n)
        k_eff = min(k, n_valid)   # the kernel masks with f32-min, not -inf:
        b = _batch_rows(query_repr)   # keep its output to valid rows
        if not k_eff:
            head = _empty_topk(b, _device(query_repr))
        elif k_eff > MAX_K:
            # beyond the scan kernels' candidate lists: the large-k kernels,
            # so that any k is served, as repro's kernel backend serves it
            if isinstance(space, DenseSpace):
                head = ops.topk_large(None, query_repr, None, corpus, 0, k_eff,
                                      dense_kind=space.kind, n_valid=n_valid)
            elif isinstance(space, SparseSpace):
                head = ops.topk_large(query_repr, None, corpus, None, space.vocab_size,
                                      k_eff, n_valid=n_valid)
            else:
                head = ops.topk_large(
                    query_repr.sparse, query_repr.dense, corpus.sparse, corpus.dense,
                    space.vocab_size, k_eff, w_dense=space.w_dense,
                    w_sparse=space.w_sparse, dense_kind=space.dense_kind,
                    n_valid=n_valid)
        elif isinstance(space, DenseSpace):
            head = ops.mips_topk(query_repr, corpus, k_eff, space=space.kind,
                                 n_valid=n_valid)
        elif isinstance(space, SparseSpace):
            # SparseSpace rides the fused kernel: no dense part, unscaled
            head = ops.fused_topk(query_repr, None, corpus, None,
                                  space.vocab_size, k_eff, n_valid=n_valid)
        else:
            head = ops.fused_topk(
                query_repr.sparse, query_repr.dense, corpus.sparse,
                corpus.dense, space.vocab_size, k_eff,
                w_dense=space.w_dense, w_sparse=space.w_sparse,
                dense_kind=space.dense_kind, n_valid=n_valid)
        return head if k_eff == k else _reference_tail(head, b, k, n_valid)


# ---------------------------------------------------------------------------
# Approximate backends: lazy per-(space, corpus) index cache.
# ---------------------------------------------------------------------------

# ANN indexes are built at the first search and kept here, because
# generators re-resolve string backends per call and a served endpoint
# calls topk per batch.  Keys use the identity of (space, corpus), plus
# the n_valid slice and every build parameter; values hold strong
# references to the keyed objects so that a recycled id never aliases
# another corpus.  A bounded LRU under a lock: builds run outside it and
# are deterministic in their key, so a duplicate race costs time only.
_ANN_INDEX_CACHE: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
_ANN_INDEX_LOCK = threading.Lock()
_ANN_INDEX_CAPACITY = 16
_ANN_INDEX_HITS = 0
_ANN_INDEX_MISSES = 0


def ann_index_cache_info() -> Dict[str, int]:
    """Entry count and lifetime hit/miss counters of the ANN index cache."""
    with _ANN_INDEX_LOCK:
        return {"size": len(_ANN_INDEX_CACHE), "hits": _ANN_INDEX_HITS,
                "misses": _ANN_INDEX_MISSES}


def clear_ann_index_cache():
    """Drop every cached ANN index and zero the counters."""
    global _ANN_INDEX_HITS, _ANN_INDEX_MISSES
    with _ANN_INDEX_LOCK:
        _ANN_INDEX_CACHE.clear()
        _ANN_INDEX_HITS = 0
        _ANN_INDEX_MISSES = 0


def invalidate_ann_index_entries(corpus) -> int:
    """Drop the cached indexes built over exactly this corpus object (all
    kinds, parameters and n_valid slices of it); every other entry
    stays.  Returns the number dropped."""
    with _ANN_INDEX_LOCK:
        doomed = [key for key, val in _ANN_INDEX_CACHE.items()
                  if val[1] is corpus]
        for key in doomed:
            del _ANN_INDEX_CACHE[key]
    return len(doomed)


def _cached_ann_index(kind: str, space, corpus, n_valid: int, params: tuple,
                      build):
    """Memoise ``build()`` per (backend kind, space, corpus, n_valid,
    build parameters)."""
    global _ANN_INDEX_HITS, _ANN_INDEX_MISSES
    key = (kind, id(space), id(corpus), int(n_valid), params)
    with _ANN_INDEX_LOCK:
        hit = _ANN_INDEX_CACHE.get(key)
        if hit is not None and hit[0] is space and hit[1] is corpus:
            _ANN_INDEX_CACHE.move_to_end(key)
            _ANN_INDEX_HITS += 1
            return hit[2]
    value = build()
    dev = tensor_leaves(corpus)[0].device
    if dev.type == "cuda":
        # batcher workers run on streams of their own: the build must be
        # complete before another stream can find it in the cache
        torch.cuda.current_stream(dev).synchronize()
    with _ANN_INDEX_LOCK:
        _ANN_INDEX_MISSES += 1
        _ANN_INDEX_CACHE[key] = (space, corpus, value)
        _ANN_INDEX_CACHE.move_to_end(key)
        while len(_ANN_INDEX_CACHE) > _ANN_INDEX_CAPACITY:
            _ANN_INDEX_CACHE.popitem(last=False)
    return value


def _slice_rows(corpus, n_valid: int):
    return map_tensors(lambda x: x[:n_valid], corpus)


@dataclasses.dataclass(frozen=True)
class GraphANNBackend:
    """Approximate top-k through a navigable proximity graph: NN-descent
    build (``graph_ann.nn_descent``) and fixed-hop batched beam search,
    the paper's SW-graph method.

    The index is built at the first search per (space, corpus, n_valid)
    and memoised (:func:`ann_index_cache_info`).  ``ef`` is the declared
    search budget: ``k > ef`` raises instead of losing recall quietly.
    ``hops=None`` uses ``max(4, 2 ln N)``.  Held to the measured-recall
    tier (recall@k >= :data:`ANN_RECALL_TARGET` against the exact
    oracle), not the exact tiers' contract.

    ``kernel=True`` runs the hops through the beam-hop kernel
    (``kernels/beam_topk.py``) over a packed visited mask, and scores the
    entry set through the exact kernels, so it takes the ``cuda``
    backend's capability matrix: what that refuses, this refuses, and
    ``resolve_backend`` falls back to reference.  ``ef * degree`` is
    capped by the kernel's candidate budget
    (``beam_topk.MAX_BEAM_CANDIDATES``); an oversized budget raises when
    the search starts.  On CUDA tensors each search's traversal is one
    kernel launch."""

    degree: int = 16
    rounds: int = 6
    ef: int = 64
    hops: Optional[int] = None
    entry_count: Optional[int] = None
    seed: int = 0
    kernel: bool = False
    name = "graph_ann"

    @property
    def identity(self) -> str:
        hops = "auto" if self.hops is None else self.hops
        entries = "auto" if self.entry_count is None else self.entry_count
        return (f"graph_ann(degree={self.degree},rounds={self.rounds},"
                f"ef={self.ef},hops={hops},entries={entries},"
                f"seed={self.seed},"
                f"kernel={'on' if self.kernel else 'off'})")

    def supports(self, space, corpus) -> Optional[str]:
        if _rows(corpus) is None:
            return ("graph_ann backend needs a materialized row-major "
                    "corpus (tensor, SparseVectors or FusedVectors)")
        if self.kernel:
            why = CudaBackend().supports(space, corpus)
            if why is not None:
                return f"graph_ann kernel path: {why}"
        return None

    def _index(self, space, corpus, n_valid: int):
        from repro_torch.core import graph_ann

        n_total = _rows(corpus)
        # kernel in the key: the graph is the same either way, but the
        # LRU must never serve one traversal's entry to the other
        params = (self.degree, self.rounds, self.entry_count, self.seed,
                  self.kernel)

        def build():
            search_corpus = (corpus if n_valid == n_total
                             else _slice_rows(corpus, n_valid))
            dev = tensor_leaves(corpus)[0].device
            index = graph_ann.nn_descent(
                space, search_corpus, n_valid, degree=self.degree,
                rounds=self.rounds,
                generator=torch.Generator(dev).manual_seed(self.seed),
                entry_count=self.entry_count)
            return search_corpus, index

        return _cached_ann_index("graph_ann", space, corpus, n_valid, params,
                                 build)

    def topk(self, space, query_repr, corpus, k: int,
             n_valid: Optional[int] = None) -> TopK:
        from repro_torch.core import graph_ann

        n = _rows(corpus)
        n_valid = n if n_valid is None else min(n_valid, n)
        b = _batch_rows(query_repr)
        k_eff = min(k, n_valid)
        if k_eff > self.ef:
            raise ValueError(
                f"graph_ann declared search budget ef={self.ef} cannot "
                f"produce top-{k_eff}; raise ef or lower k")
        if not k_eff:
            empty = _empty_topk(b, _device(query_repr))
            return _reference_tail(empty, b, k, n_valid) if k else empty
        if self.kernel:
            from repro_torch.kernels.beam_topk import check_beam_budget
            check_beam_budget(self.ef, self.degree)
        search_corpus, index = self._index(space, corpus, n_valid)
        search = graph_ann.kernel_beam_search if self.kernel else graph_ann.beam_search
        head = search(space, query_repr, search_corpus, index, n_valid,
                      k=k_eff, ef=self.ef, hops=self.hops)
        return head if k_eff == k else _reference_tail(head, b, k, n_valid)


@dataclasses.dataclass(frozen=True)
class NappBackend:
    """Approximate top-k by NAPP (``core.napp``): pivot-intersection
    counting as one matrix product, then an exact re-rank of the best
    ``rerank_qty`` candidates, the paper's permutation-family method.

    The pivot index is built at the first search per (space, corpus,
    n_valid) and memoised in the ANN index cache; pivot scoring runs
    through the fused score kernel where it computes the space's
    function (``napp.fused_kernel_serves``).  ``rerank_qty`` is the
    declared budget: ``k > rerank_qty`` raises.  Pivot counts clamp to
    the corpus without changing the identity.  Measured-recall tier;
    never selected by ``"auto"``."""

    num_pivots: int = 128
    num_index: int = 8
    num_search: int = 8
    min_times: int = 2
    rerank_qty: int = 256
    seed: int = 0
    name = "napp"

    @property
    def identity(self) -> str:
        return (f"napp(pivots={self.num_pivots},index={self.num_index},"
                f"search={self.num_search},min_times={self.min_times},"
                f"rerank_qty={self.rerank_qty},seed={self.seed})")

    def supports(self, space, corpus) -> Optional[str]:
        if _rows(corpus) is None:
            return ("napp backend needs a materialized row-major corpus "
                    "(tensor, SparseVectors or FusedVectors)")
        return None

    def _index(self, space, corpus, n_valid: int):
        from repro_torch.core import napp

        n_total = _rows(corpus)
        params = (self.num_pivots, self.num_index, self.seed)

        def build():
            search_corpus = (corpus if n_valid == n_total
                             else _slice_rows(corpus, n_valid))
            p = min(self.num_pivots, n_valid)
            dev = tensor_leaves(corpus)[0].device
            index = napp.build_napp(
                space, search_corpus, n_valid, num_pivots=p,
                num_index=min(self.num_index, p),
                generator=torch.Generator(dev).manual_seed(self.seed))
            return search_corpus, index

        return _cached_ann_index("napp", space, corpus, n_valid, params, build)

    def topk(self, space, query_repr, corpus, k: int,
             n_valid: Optional[int] = None) -> TopK:
        from repro_torch.core import napp

        n = _rows(corpus)
        n_valid = n if n_valid is None else min(n_valid, n)
        b = _batch_rows(query_repr)
        k_eff = min(k, n_valid)
        if k_eff > self.rerank_qty:
            raise ValueError(
                f"napp declared re-rank budget rerank_qty={self.rerank_qty} "
                f"cannot produce top-{k_eff}; raise rerank_qty or lower k")
        if not k_eff:
            empty = _empty_topk(b, _device(query_repr))
            return _reference_tail(empty, b, k, n_valid) if k else empty
        search_corpus, index = self._index(space, corpus, n_valid)
        p = int(index.pivot_ids.shape[0])
        head = napp.napp_search(space, query_repr, search_corpus, index, k=k_eff,
                                num_search=min(self.num_search, p),
                                min_times=self.min_times,
                                rerank_qty=min(self.rerank_qty, n_valid))
        return head if k_eff == k else _reference_tail(head, b, k, n_valid)


_REGISTRY: Dict[str, Callable[..., ExecutionBackend]] = {}


def register_backend(name: str, factory: Callable[..., ExecutionBackend]):
    """Register a backend factory under ``name`` (overwrites allowed)."""
    _REGISTRY[name] = factory


def available_backends():
    return tuple(sorted(_REGISTRY))


def make_backend(name: str, **kwargs) -> ExecutionBackend:
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; registered: {available_backends()}"
        ) from None
    return factory(**kwargs)


register_backend("reference", ReferenceBackend)
register_backend("streaming", StreamingBackend)
register_backend("cuda", CudaBackend)
register_backend("pallas", CudaBackend)   # descriptors written by repro
register_backend("graph_ann", GraphANNBackend)
register_backend("napp", NappBackend)


def _auto(space, corpus, tile_n: Optional[int] = None) -> ExecutionBackend:
    """Size and device policy, the reference's with "on a TPU" read as
    "the corpus lies on a CUDA device".

    Dense corpora: the ``cuda`` kernels on the card from
    :data:`AUTO_PALLAS_MIN_ROWS` rows; off the card the plain paths
    serve, streaming once the [B, N] score matrix grows
    (:data:`AUTO_STREAMING_MIN_ROWS`), reference below.  Fused and
    sparse corpora take the ``cuda`` backend from
    :data:`AUTO_PALLAS_MIN_ROWS` rows wherever it serves them (the only
    bounded-memory fused scan and select; its plain version off the
    card), streaming what it refuses.  Approximate backends are never
    chosen: trading recall for time is the caller's explicit choice."""
    n = _rows(corpus)
    if n is None:
        return ReferenceBackend()
    cuda = CudaBackend()
    cuda_ok = cuda.supports(space, corpus) is None
    if _dense_rows(corpus) is not None:
        if corpus.device.type == "cuda" and n >= AUTO_PALLAS_MIN_ROWS and cuda_ok:
            return cuda
    elif n >= AUTO_PALLAS_MIN_ROWS and cuda_ok:
        return cuda
    if n >= AUTO_STREAMING_MIN_ROWS:
        streaming = StreamingBackend(tile_n) if tile_n else StreamingBackend()
        if streaming.supports(space, corpus) is None:
            return streaming
    return ReferenceBackend()


def resolve_backend(backend="auto", space=None, corpus=None,
                    **kwargs) -> ExecutionBackend:
    """Name, ``"auto"`` (``None`` means it too) or instance -> a backend
    that can serve (space, corpus).  One whose capability check refuses
    the pair falls back to ``reference``; with ``space``/``corpus``
    omitted the check is skipped.  ``kwargs`` reach the named backend's
    constructor; ``"auto"`` reads ``tile_n`` for the streaming scan."""
    if backend is None:
        backend = "auto"
    if backend == "auto":
        return _auto(space, corpus, tile_n=kwargs.get("tile_n"))
    resolved = make_backend(backend, **kwargs) if isinstance(backend, str) else backend
    if space is not None and corpus is not None:
        if resolved.supports(space, corpus) is not None:
            return ReferenceBackend()
    return resolved


def backend_identity(backend) -> Optional[str]:
    """Identity string for stats/cache: None stays None, strings pass
    through, instances report ``identity``."""
    if backend is None or isinstance(backend, str):
        return backend
    return getattr(backend, "identity", None)
