"""Sharded-corpus serving: K corpus shards behind one batcher endpoint
(counterpart of ``repro/serving/sharded.py``).

NMSLIB scales its query server by splitting the collection across servers
and merging per-server result lists; this module is that idea inside one
process and, with a mesh, across the ranks of a process group:

  * :func:`shard_corpus` partitions any row-major corpus (dense ``[N, D]``
    tensors, ``SparseVectors``, ``FusedVectors``) into K *contiguous row
    ranges*.  Each shard is a view of the corpus, not a copy (a copy of a
    corpus that fills most of the card would not fit beside it).  With a
    ``ParallelCtx`` carrying a ``DeviceMesh``, the rank at coordinate c
    along the axis that ``axis`` maps to holds the shards whose slot
    ``i % n_slots == c``; the others keep their offset and row count and
    hold no rows there.  The reference puts a slot on the first device
    along the other axes; here every rank along them holds it, so that
    every rank can answer.
  * :class:`ShardedPipeline` runs one candidate generator per shard it
    holds (exact brute force by default; graph-ANN or NAPP via
    ``generator_factory``), host-parallel (one thread per shard, all
    launching on the calling thread's CUDA stream), rebases local row ids
    by the shard offset, merges the K candidate lists in shard order with
    :func:`~repro_torch.core.brute_force.merge_topk` (over a mesh, after an
    all-gather of the ranks' lists), and applies the usual reranker tail
    once over the merged global candidates.  Over a mesh every rank calls
    ``generate``/``run`` with the same queries and returns the same
    answer.  The per-shard execution path is pluggable: ``from_corpus(...,
    backend=...)`` / :meth:`ShardedPipeline.with_backend` resolve a
    :mod:`repro_torch.core.backends` backend against each shard's slice.

Identity: contiguous shards concatenated in row order preserve the
tie-break toward the lower global row id, and every per-row score is
computed from the same values as the unsharded scan, so for exact
generators the sharded ids equal the unsharded ``RetrievalPipeline.run``
ids (verified in ``tests/test_torch_sharded.py`` and by ``chip_smoke.py``
"serve full").

A ``ShardedPipeline`` exposes ``run(query_repr, q_tokens)`` and
``generate(query_repr, k)``, so it registers behind a single
:class:`~repro_torch.serving.batcher.ContinuousBatcher` endpoint via
``RetrievalService.register_pipeline`` and also slots into a larger
:class:`~repro_torch.core.pipeline.RetrievalPipeline` as a candidate
generator.
"""

from __future__ import annotations

import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core.backends import resolve_backend
from repro_torch.core.brute_force import TopK, concat_topk, merge_topk
from repro_torch.core.pipeline import (BruteForceGenerator, apply_rerankers,
                                       pin_snapshot)
from repro_torch.core.spaces import canonical_dtype, cast_corpus, map_tensors, tensor_leaves
from repro_torch.distributed.collectives import all_gather, axis_names

__all__ = ["CorpusShard", "shard_corpus", "ShardedPipeline"]


@dataclasses.dataclass(frozen=True)
class CorpusShard:
    """One contiguous row range of the corpus: local rows ``[0, n_rows)``
    correspond to global rows ``[offset, offset + n_rows)``.  ``corpus``
    is None on a rank of a mesh that does not hold the shard."""

    corpus: Any
    offset: int
    n_rows: int


def _corpus_rows(corpus) -> int:
    return int(tensor_leaves(corpus)[0].shape[0])


def _placement(ctx, axis: str):
    """(mesh, its axes along which slots run, this rank's slot, slots) for
    a ``ctx`` with a mesh, else None.  Slots run along the mesh axes that
    logical ``axis`` maps to, in row-major order of their coordinates; in
    flat mesh order when it maps to nothing."""
    from torch.distributed.device_mesh import DeviceMesh

    mesh = getattr(ctx, "mesh", None) if ctx is not None else None
    if mesh is None:
        return None
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"placing shards needs a torch.distributed DeviceMesh, not a "
                        f"{type(mesh).__name__}")
    names = axis_names(ctx.mesh_axes(axis)) or tuple(mesh.mesh_dim_names)
    slot, n_slots = 0, 1
    for a in names:
        size = mesh.size(mesh.mesh_dim_names.index(a))
        slot, n_slots = slot * size + mesh.get_local_rank(a), n_slots * size
    return mesh, names, slot, n_slots


def shard_corpus(corpus, n_shards: int, *, ctx=None,
                 axis: str = "corpus") -> Tuple[CorpusShard, ...]:
    """Partition a corpus into ``n_shards`` contiguous row ranges, each a
    view of ``corpus`` (no copy).

    Row order across shards equals global row order — load-bearing for the
    merge's tie-break (see module docstring).  ``ctx`` with a mesh places
    shard ``i`` on the ranks of slot ``i % n_slots`` along the mesh axes
    that logical ``axis`` maps to: every rank calls this with the same
    corpus, and a shard it does not hold has ``corpus=None``.  Without a
    mesh the views stay where the corpus lives.
    """
    placed = _placement(ctx, axis)
    n = _corpus_rows(corpus)
    if not 1 <= n_shards <= n:
        raise ValueError(f"n_shards={n_shards} must be in [1, {n}]")
    bounds = [n * i // n_shards for i in range(n_shards + 1)]
    return tuple(CorpusShard(None if placed is not None and i % placed[3] != placed[2] else
                             map_tensors(lambda x, lo=lo, hi=hi: x[lo:hi], corpus), lo, hi - lo)
                 for i, (lo, hi) in enumerate(zip(bounds, bounds[1:])))


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedPipeline:
    """Drop-in for ``RetrievalPipeline.run`` over a K-way sharded corpus.

    Each shard's generator sees only its slice (local row ids); offsets
    rebase to global ids, ``merge_topk`` folds the K lists into the global
    top-``cand_qty``, and the rerankers run once on the merged candidates.
    Build with :meth:`from_corpus`.
    """

    shards: Tuple[CorpusShard, ...]
    generators: Tuple[Any, ...]
    intermediate: Optional[Any] = None
    final: Optional[Any] = None
    cand_qty: int = 100
    interm_qty: int = 50
    final_qty: int = 10
    executor: Optional[ThreadPoolExecutor] = None
    # over a mesh: (mesh, slot axes, this rank's slot, slots); generators
    # of the shards this rank does not hold are None
    placement: Optional[tuple] = None

    @classmethod
    def from_corpus(
        cls, space, corpus, n_shards: int, *, ctx=None, axis: str = "corpus",
        generator_factory: Optional[Callable[[CorpusShard], Any]] = None,
        backend=None, corpus_dtype: Optional[str] = None,
        intermediate=None, final=None,
        cand_qty: int = 100, interm_qty: int = 50, final_qty: int = 10,
        host_parallel: bool = True,
    ) -> "ShardedPipeline":
        """Shard ``corpus`` K ways and build one generator per shard.

        ``generator_factory(shard) -> CandidateGenerator`` defaults to exact
        ``BruteForceGenerator(space, shard.corpus)``; pass a factory building
        per-shard ``GraphANNGenerator`` / ``NappGenerator`` for approximate
        search (merged results are then the union-of-shards approximation,
        not bit-identical to a global index).

        ``backend`` selects the execution path of the default per-shard
        generators (a :mod:`repro_torch.core.backends` name, ``"auto"``, or
        instance), resolved per shard against that shard's slice — a
        backend that cannot serve the space falls back to reference shard
        by shard.  Mutually exclusive with ``generator_factory`` (a custom
        factory owns its generators' execution entirely).

        ``corpus_dtype`` casts the corpus to a residency dtype *before*
        sharding (``"bfloat16"`` halves every shard's footprint; scores
        stay f32 — the precision contract in ``core.spaces``).  Casting
        commutes with row-slicing, so a bf16 sharded pipeline stays
        bit-identical to the unsharded bf16 scan.

        ``ctx`` with a mesh: every rank of it calls this with the same
        arguments and builds the generators of the shards it holds
        (:func:`shard_corpus`).
        """
        if backend is not None and generator_factory is not None:
            raise ValueError(
                "pass either backend= or generator_factory=, not both: a "
                "custom factory owns its generators' execution path")
        if corpus_dtype is not None:
            corpus = cast_corpus(corpus, canonical_dtype(corpus_dtype))
        shards = shard_corpus(corpus, n_shards, ctx=ctx, axis=axis)
        if generator_factory is None:
            def generator_factory(shard: CorpusShard):
                resolved = (None if backend is None else
                            resolve_backend(backend, space, shard.corpus))
                return BruteForceGenerator(space, shard.corpus,
                                           backend=resolved)
        held = sum(s.corpus is not None for s in shards)
        executor = (ThreadPoolExecutor(max_workers=held,
                                       thread_name_prefix="shard")
                    if host_parallel and held > 1 else None)
        return cls(shards=shards,
                   generators=tuple(None if s.corpus is None else generator_factory(s)
                                    for s in shards),
                   intermediate=intermediate, final=final, cand_qty=cand_qty,
                   interm_qty=interm_qty, final_qty=final_qty,
                   executor=executor, placement=_placement(ctx, axis))

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def _fresh_pool(self) -> Optional[ThreadPoolExecutor]:
        if self.executor is None:
            return None
        held = sum(g is not None for g in self.generators)
        return ThreadPoolExecutor(max_workers=held, thread_name_prefix="shard")

    @property
    def corpus_dtype(self) -> Optional[str]:
        """The shards' common corpus residency dtype (None when the
        per-shard generators disagree or carry no dtype seam)."""
        dts = {getattr(g, "corpus_dtype", None) for g in self.generators if g is not None}
        if len(dts) == 1 and (d := dts.pop()) is not None:
            return d
        return None

    def with_corpus_dtype(self, dtype) -> "ShardedPipeline":
        """Same shards, different corpus residency dtype: every per-shard
        generator is recast (casting commutes with the row-slicing that
        built the shards, so merged results equal an unsharded cast
        corpus bit for bit).  The rebound pipeline owns a fresh
        host-parallel pool — close it separately.  Raises TypeError when
        a shard generator has no dtype seam (e.g. per-shard graph-ANN)."""
        for g in self.generators:
            if g is not None and not hasattr(g, "with_corpus_dtype"):
                raise TypeError(
                    f"shard generator {type(g).__name__} does not take a "
                    "corpus residency dtype")
        generators = tuple(None if g is None else g.with_corpus_dtype(dtype)
                           for g in self.generators)
        shards = tuple(
            dataclasses.replace(s, corpus=getattr(g, "corpus", s.corpus))
            for s, g in zip(self.shards, generators))
        executor = self._fresh_pool()
        return dataclasses.replace(self, shards=shards,
                                   generators=generators, executor=executor)

    def with_backend(self, backend) -> "ShardedPipeline":
        """Same shards, different execution path: every per-shard generator
        is rebound onto ``backend`` (resolved against its own slice, so an
        incapable backend falls back to reference shard by shard).  The
        rebound pipeline owns a fresh host-parallel pool — close it
        separately.  Raises TypeError when a shard generator has no
        backend seam (e.g. per-shard graph-ANN)."""
        for g in self.generators:
            if g is not None and not hasattr(g, "with_backend"):
                raise TypeError(
                    f"shard generator {type(g).__name__} does not take an "
                    "execution backend")
        executor = self._fresh_pool()
        return dataclasses.replace(
            self,
            generators=tuple(None if g is None else g.with_backend(backend)
                             for g in self.generators),
            executor=executor)

    # CandidateGenerator protocol: a ShardedPipeline can itself feed a
    # larger RetrievalPipeline as its (sharded) candidate stage.
    def generate(self, query_repr, k: Optional[int] = None) -> TopK:
        """Global top-k candidates from the sharded generator stage."""
        k = self.cand_qty if k is None else k
        # Live-corpus shard generators are pinned up front, before the
        # fan-out, so one batch sees a mutually consistent set of
        # per-shard states even while writers and compactors race the
        # query threads (the pin_snapshot seam shared with
        # RetrievalPipeline and the serving funnel).
        held = [(g, s) for g, s in zip(self.generators, self.shards) if g is not None]
        generators = [pin_snapshot(g) for g, _ in held]
        shards = [s for _, s in held]

        # the pool's threads launch on the caller's stream (a batcher
        # worker's own): the queries were made there, and the merge below
        # reads the shards' results there
        dev = tensor_leaves(query_repr)[0].device
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None

        def one(gen, shard: CorpusShard) -> TopK:
            scope = (torch.cuda.stream(stream) if stream is not None
                     else contextlib.nullcontext())
            with scope:
                local = gen.generate(query_repr, min(k, shard.n_rows))
                return TopK(local.scores, local.indices + shard.offset)

        if self.executor is not None:
            parts = list(self.executor.map(one, generators, shards))
        else:
            parts = [one(g, s) for g, s in zip(generators, shards)]
        if self.placement is not None:
            parts = self._gather_parts(parts, k, tensor_leaves(query_repr)[0])
        cat = concat_topk(parts)
        return merge_topk(cat, min(k, cat.scores.shape[1]))

    def _gather_parts(self, parts, k: int, queries: torch.Tensor):
        """Every shard's list, in shard order, on every rank: each rank
        packs the lists of the shards it holds side by side, padded to the
        widest pack; the packs are all-gathered over the slot axes and cut
        back into shard order (not rank order: a rank's shards are not
        adjacent when there are more shards than slots)."""
        mesh, names, slot, n_slots = self.placement
        widths = [min(k, s.n_rows) for s in self.shards]
        packs = [sum(widths[i::n_slots]) for i in range(n_slots)]
        b, pad = int(queries.shape[0]), max(packs) - packs[slot]
        scores = torch.cat([p.scores.float() for p in parts] + [torch.zeros(b, pad, device=queries.device)], 1)
        ids = torch.cat([p.indices.to(torch.int32) for p in parts]
                        + [torch.zeros(b, pad, dtype=torch.int32, device=queries.device)], 1)
        all_s, all_i = _gather_slots(scores, mesh, names), _gather_slots(ids, mesh, names)
        out, at = [], [0] * n_slots
        for i, w in enumerate(widths):
            c = i % n_slots
            out.append(TopK(all_s[c][:, at[c]:at[c] + w], all_i[c][:, at[c]:at[c] + w]))
            at[c] += w
        return out

    def run(self, query_repr, q_tokens=None) -> TopK:
        cands = self.generate(query_repr, self.cand_qty)
        return apply_rerankers(
            cands, q_tokens, intermediate=self.intermediate, final=self.final,
            interm_qty=self.interm_qty, final_qty=self.final_qty)

    # -- lifecycle ----------------------------------------------------------
    def close(self):
        """Shut down the host-parallel worker pool (no-op when serial).
        Long-lived processes that rebuild pipelines (index refresh, shard
        sweeps) should close retired ones; ``run`` after close falls back
        to serial execution."""
        if self.executor is not None:
            self.executor.shutdown(wait=True)
            object.__setattr__(self, "executor", None)

    def __enter__(self) -> "ShardedPipeline":
        return self

    def __exit__(self, *exc):
        self.close()


def _gather_slots(x: torch.Tensor, mesh, names) -> torch.Tensor:
    """``[n_slots, ...]``: every slot's ``x``, in row-major order of the
    slot axes ``names``."""
    shape = x.shape
    for a in reversed(names):
        x = torch.stack(all_gather(x, mesh.get_group(a)), 0)
    return x.reshape(-1, *shape)
