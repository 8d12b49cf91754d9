"""Multi-stage retrieval pipeline (counterpart of
``repro/core/pipeline.py``; paper Fig. 1 / §3.2).

A candidate generator produces ``cand_qty`` documents; optional
intermediate and final re-rankers narrow them to ``final_qty``.
Generators: brute force and streaming over any execution backend, graph
ANN, NAPP and the inverted file (:class:`InvertedIndexGenerator`, exact
BM25, Lucene's role).  Re-rankers: a composite FlexNeuART extractor
(``core.scorers``) feeding a linear LETOR model (:class:`LinearReranker`)
or a LambdaMART ensemble (:class:`TreeReranker`); any object with
``rerank(q_tokens, cands, keep)`` slots in too.  The paper's Fig. 4
experiment descriptor maps onto :meth:`RetrievalPipeline.from_descriptor`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol

import torch

from repro_torch.core import graph_ann, napp
from repro_torch.core.backends import ReferenceBackend, StreamingBackend, resolve_backend
from repro_torch.core.brute_force import TopK, select_topk
from repro_torch.core.inverted_index import InvertedIndex, daat_topk
from repro_torch.core.scorers import CompositeExtractor
from repro_torch.core.spaces import canonical_dtype, cast_corpus, corpus_dtype

__all__ = [
    "CandidateGenerator",
    "BruteForceGenerator",
    "StreamingGenerator",
    "GraphANNGenerator",
    "NappGenerator",
    "InvertedIndexGenerator",
    "Reranker",
    "LinearReranker",
    "TreeReranker",
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


@dataclasses.dataclass(frozen=True)
class InvertedIndexGenerator:
    """Lucene's role in the paper: exact sparse scoring via inverted file."""

    index: InvertedIndex

    def generate(self, query_repr, k: int) -> TopK:
        return daat_topk(self.index, query_repr, k)


# ---------------------------------------------------------------------------
# Re-rankers: composite features -> model score -> reorder candidates.
# ---------------------------------------------------------------------------

def _reorder(cands: TopK, new_scores: torch.Tensor, keep: int) -> TopK:
    """The ``keep`` best candidates by ``new_scores`` in ``lax.top_k``'s
    order (ties toward the earlier candidate)."""
    vals, pos = select_topk(new_scores, keep)
    return TopK(vals, torch.gather(cands.indices, 1, pos))


def _masked(cands: TopK, scores: torch.Tensor) -> torch.Tensor:
    """-inf at candidates whose generator score is not finite."""
    return torch.where(torch.isfinite(cands.scores), scores,
                       torch.full_like(scores, -torch.inf))


@dataclasses.dataclass(frozen=True)
class LinearReranker:
    """Composite extractor + linear LETOR model (coordinate-ascent output)."""

    extractor: CompositeExtractor
    weights: torch.Tensor   # f32[F]

    def rerank(self, q_tokens, cands: TopK, keep: int) -> TopK:
        return self.rerank_features(cands, self.extractor.extract(q_tokens, cands.indices), keep)

    def rerank_features(self, cands: TopK, feats: torch.Tensor, keep: int) -> TopK:
        """The model and the selection on ``feats`` f32[Q, C, F] of ``cands``."""
        s = torch.einsum("qcf,f->qc", feats, self.weights.to(feats))
        return _reorder(cands, _masked(cands, s), keep)


@dataclasses.dataclass(frozen=True)
class TreeReranker:
    """Composite extractor + LambdaMART oblivious-tree ensemble."""

    extractor: CompositeExtractor
    ensemble: object   # fusion.ObliviousTreeEnsemble

    def rerank(self, q_tokens, cands: TopK, keep: int) -> TopK:
        return self.rerank_features(cands, self.extractor.extract(q_tokens, cands.indices), keep)

    def rerank_features(self, cands: TopK, feats: torch.Tensor, keep: int) -> TopK:
        """The model and the selection on ``feats`` f32[Q, C, F] of ``cands``."""
        return _reorder(cands, _masked(cands, self.ensemble.predict(feats)), keep)


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

    # Historical descriptors spelled the execution-backend keys
    # inconsistently with the rest of the camelCase vocabulary: lowercase
    # "backend" and "backendParams".  They are still read (and rewritten)
    # so that archived experiment descriptors keep loading.
    _LEGACY_DESCRIPTOR_KEYS = {"backend": "execBackend",
                               "backendParams": "execBackendParams"}

    @classmethod
    def canonicalize_descriptor(cls, desc: dict) -> dict:
        """Rewrite legacy descriptor keys to their canonical camelCase
        spellings (``backend`` -> ``execBackend``, ``backendParams`` ->
        ``execBackendParams``).  A descriptor carrying both spellings
        with different values is ambiguous and rejected."""
        canon = dict(desc)
        for old, new in cls._LEGACY_DESCRIPTOR_KEYS.items():
            if old in canon:
                if new in canon and canon[new] != canon[old]:
                    raise ValueError(
                        f"descriptor carries both {old!r} and its canonical "
                        f"spelling {new!r} with different values")
                canon[new] = canon.pop(old)
        return canon

    @property
    def descriptor(self) -> dict:
        """The canonical experiment descriptor for this pipeline: the
        canonicalized source descriptor of a pipeline built by
        :meth:`from_descriptor`; for a hand-built one the funnel
        quantities, the generator's execution-backend identity and its
        corpus residency dtype."""
        stored = getattr(self, "_descriptor", None)
        if stored is not None:
            return dict(stored)
        from repro_torch.core.backends import backend_identity

        desc = {"candQty": self.cand_qty, "intermQty": self.interm_qty,
                "finalQty": self.final_qty}
        label = backend_identity(self.backend)
        if label is not None:
            desc["execBackend"] = label
        if self.corpus_dtype is not None:
            desc["corpusDtype"] = self.corpus_dtype
        return desc

    @classmethod
    def from_descriptor(cls, desc: dict, context: dict) -> "RetrievalPipeline":
        """Paper Fig. 4 experiment descriptor.  Keys: candProv (name into
        ``context``), execBackend (the candidate stage's execution
        backend; legacy ``backend``), execBackendParams (constructor
        kwargs for the named backend, requires execBackend; legacy
        ``backendParams``), corpusDtype, extrType / extrTypeInterm
        (extractor configs), model / modelInterm (names into ``context``
        of weight vectors or ensembles), candQty / intermQty / finalQty."""
        from repro_torch.core.backends import make_backend
        from repro_torch.core.fusion import ObliviousTreeEnsemble

        desc = cls.canonicalize_descriptor(desc)
        gen = context[desc.get("candProv", "candidate_provider")]
        if "corpusDtype" in desc:            # cast before backend resolution
            gen = gen.with_corpus_dtype(desc["corpusDtype"])
        params = desc.get("execBackendParams")
        if params and "execBackend" not in desc:
            raise ValueError("descriptor key 'execBackendParams' (legacy "
                             "spelling 'backendParams') requires "
                             "'execBackend' to name the backend it "
                             "configures")
        if "execBackend" in desc:
            gen = gen.with_backend(
                make_backend(desc["execBackend"], **params)
                if params else desc["execBackend"])

        def build(extr_key, model_key):
            if extr_key not in desc:
                return None
            extractor = CompositeExtractor.from_config(desc[extr_key], **context)
            model = context[desc[model_key]]
            if isinstance(model, ObliviousTreeEnsemble):
                return TreeReranker(extractor, model)
            return LinearReranker(extractor, torch.as_tensor(model, dtype=torch.float32))

        pipe = cls(
            generator=gen,
            intermediate=build("extrTypeInterm", "modelInterm"),
            final=build("extrType", "model"),
            cand_qty=int(desc.get("candQty", 100)),
            interm_qty=int(desc.get("intermQty", 50)),
            final_qty=int(desc.get("finalQty", 10)),
        )
        # remember the canonical source descriptor so that .descriptor
        # round-trips exactly (frozen dataclass: bypass __setattr__)
        object.__setattr__(pipe, "_descriptor", dict(desc))
        return pipe
