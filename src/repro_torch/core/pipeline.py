"""Multi-stage retrieval pipeline (counterpart of
``repro/core/pipeline.py``).

A candidate generator produces ``cand_qty`` documents; optional
intermediate and final re-rankers narrow them to ``final_qty``.  Ported
so far: the brute-force and streaming generators, the graph-ANN and NAPP
generators, the live-snapshot seam (:func:`pin_snapshot`), and the
funnel tail for the no-reranker case; any object with
``rerank(q_tokens, cands, keep)`` still slots in as a re-ranker.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol

from repro_torch.core import graph_ann, napp
from repro_torch.core.backends import ReferenceBackend, StreamingBackend, resolve_backend
from repro_torch.core.brute_force import TopK
from repro_torch.core.spaces import canonical_dtype, cast_corpus, corpus_dtype

__all__ = [
    "CandidateGenerator",
    "BruteForceGenerator",
    "StreamingGenerator",
    "GraphANNGenerator",
    "NappGenerator",
    "Reranker",
    "apply_rerankers",
    "pin_snapshot",
    "RetrievalPipeline",
]


def pin_snapshot(generator: "CandidateGenerator") -> "CandidateGenerator":
    """Resolve the live-corpus snapshot seam once for a unit of work.

    A live-corpus generator (``repro_torch.serving.live.LiveGenerator``)
    exposes ``bind_snapshot()``, which pins one immutable snapshot: the
    candidate stage and every later stage that reads its row ids see one
    corpus state while writers and the compactor race.  A frozen
    generator has no such seam and is returned as it is."""
    bind = getattr(generator, "bind_snapshot", None)
    return generator if bind is None else bind()


class CandidateGenerator(Protocol):
    def generate(self, query_repr, k: int) -> TopK: ...


class Reranker(Protocol):
    def rerank(self, q_tokens, cands: TopK, keep: int) -> TopK: ...


def _settle_residency(gen):
    """Cast a generator's corpus to its ``corpus_dtype`` once, or record
    the dtype the corpus is resident in when none was asked for."""
    if gen.corpus_dtype is not None:
        dtype = canonical_dtype(gen.corpus_dtype)
        object.__setattr__(gen, "corpus_dtype", dtype)
        object.__setattr__(gen, "corpus", cast_corpus(gen.corpus, dtype))
    else:
        object.__setattr__(gen, "corpus_dtype", corpus_dtype(gen.corpus))


@dataclasses.dataclass(frozen=True)
class BruteForceGenerator:
    """Exact top-k over a dense, sparse or fused space.

    ``backend`` is an execution backend instance or name; ``None`` keeps
    the one-shot reference path.  ``corpus_dtype="bfloat16"`` casts the
    corpus once at construction (scores stay f32); ``None`` reports the
    dtype the corpus is resident in."""

    space: object
    corpus: object
    n_valid: Optional[int] = None
    backend: Optional[object] = None
    corpus_dtype: Optional[str] = None

    def __post_init__(self):
        _settle_residency(self)

    def generate(self, query_repr, k: int) -> TopK:
        backend = self.backend
        if backend is None:
            backend = ReferenceBackend()
        elif isinstance(backend, str):
            backend = resolve_backend(backend, self.space, self.corpus)
        return backend.topk(self.space, query_repr, self.corpus, k, self.n_valid)

    def with_backend(self, backend) -> "BruteForceGenerator":
        """Same space/corpus, another execution path, resolved against this
        corpus (an incapable backend falls back to reference)."""
        return dataclasses.replace(
            self, backend=resolve_backend(backend, self.space, self.corpus))

    def with_corpus_dtype(self, dtype) -> "BruteForceGenerator":
        """Same space, another residency dtype; a bound backend instance is
        re-resolved against the cast corpus."""
        replaced = dataclasses.replace(self, corpus_dtype=dtype)
        if self.backend is not None and not isinstance(self.backend, str):
            replaced = replaced.with_backend(self.backend)
        return replaced


@dataclasses.dataclass(frozen=True)
class StreamingGenerator:
    """Tiled exact top-k, bounded memory: ``BruteForceGenerator`` with the
    streaming backend pinned at ``tile_n``."""

    space: object
    corpus: object
    tile_n: int = 8192
    n_valid: Optional[int] = None
    corpus_dtype: Optional[str] = None

    def __post_init__(self):
        _settle_residency(self)

    def generate(self, query_repr, k: int) -> TopK:
        return StreamingBackend(tile_n=self.tile_n).topk(
            self.space, query_repr, self.corpus, k, self.n_valid)

    def with_backend(self, backend) -> BruteForceGenerator:
        """A ``BruteForceGenerator`` on another path; a tiled target
        (``"streaming"``, or ``"auto"`` when it picks streaming) keeps
        this generator's tile, which was chosen to bound memory."""
        kwargs = ({"tile_n": self.tile_n}
                  if isinstance(backend, str) and backend in ("streaming", "auto") else {})
        return BruteForceGenerator(
            self.space, self.corpus, self.n_valid,
            backend=resolve_backend(backend, self.space, self.corpus, **kwargs))

    def with_corpus_dtype(self, dtype) -> "StreamingGenerator":
        return dataclasses.replace(self, corpus_dtype=dtype)


@dataclasses.dataclass(frozen=True)
class GraphANNGenerator:
    """NSW/HNSW-style beam search over a given index (``core.graph_ann``)."""

    space: object
    corpus: object
    index: graph_ann.GraphIndex
    n_items: int
    ef: int = 64
    hops: Optional[int] = None

    def generate(self, query_repr, k: int) -> TopK:
        return graph_ann.beam_search(
            self.space, query_repr, self.corpus, self.index, self.n_items,
            k=k, ef=max(self.ef, k), hops=self.hops)


@dataclasses.dataclass(frozen=True)
class NappGenerator:
    """NAPP probe over a given index (``core.napp``); the re-rank budget
    grows to ``k`` when a caller asks for more."""

    space: object
    corpus: object
    index: napp.NappIndex
    num_search: int = 8
    min_times: int = 2
    rerank_qty: int = 256

    def generate(self, query_repr, k: int) -> TopK:
        return napp.napp_search(
            self.space, query_repr, self.corpus, self.index, k=k,
            num_search=self.num_search, min_times=self.min_times,
            rerank_qty=max(self.rerank_qty, k))


def apply_rerankers(cands: TopK, q_tokens=None, *,
                    intermediate: Optional[Reranker] = None,
                    final: Optional[Reranker] = None,
                    interm_qty: int = 50, final_qty: int = 10) -> TopK:
    """The funnel tail: candidates -> (intermediate) -> (final) -> result."""
    if intermediate is not None:
        cands = intermediate.rerank(q_tokens, cands, interm_qty)
    if final is not None:
        return final.rerank(q_tokens, cands, final_qty)
    keep = min(final_qty, cands.scores.shape[1])
    return TopK(cands.scores[:, :keep], cands.indices[:, :keep])


@dataclasses.dataclass(frozen=True)
class RetrievalPipeline:
    """candidate generator -> (optional) intermediate -> (optional) final."""

    generator: CandidateGenerator
    intermediate: Optional[Reranker] = None
    final: Optional[Reranker] = None
    cand_qty: int = 100
    interm_qty: int = 50
    final_qty: int = 10

    def generate_candidates(self, query_repr, k: Optional[int] = None) -> TopK:
        """The candidate stage alone, with the live-snapshot seam resolved
        (:func:`pin_snapshot`)."""
        return pin_snapshot(self.generator).generate(
            query_repr, self.cand_qty if k is None else k)

    def run(self, query_repr, q_tokens=None) -> TopK:
        cands = self.generate_candidates(query_repr)
        return apply_rerankers(
            cands, q_tokens, intermediate=self.intermediate, final=self.final,
            interm_qty=self.interm_qty, final_qty=self.final_qty)

    @property
    def backend(self):
        return getattr(self.generator, "backend", None)

    @property
    def corpus_dtype(self):
        return getattr(self.generator, "corpus_dtype", None)

    def with_backend(self, backend) -> "RetrievalPipeline":
        if not hasattr(self.generator, "with_backend"):
            raise TypeError(f"generator {type(self.generator).__name__} does "
                            "not take an execution backend")
        return dataclasses.replace(
            self, generator=self.generator.with_backend(backend))

    def with_corpus_dtype(self, dtype) -> "RetrievalPipeline":
        if not hasattr(self.generator, "with_corpus_dtype"):
            raise TypeError(f"generator {type(self.generator).__name__} does "
                            "not take a corpus residency dtype")
        return dataclasses.replace(
            self, generator=self.generator.with_corpus_dtype(dtype))
