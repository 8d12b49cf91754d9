"""The serving config genome and tuned profiles (counterpart of the genome
half of ``repro/serving/autotune.py``).

* :class:`ServingConfig` — a typed genome over every serving knob, with
  per-knob legality (:func:`check_config`) derived from the capability
  matrix in :mod:`repro_torch.core.backends`.
* :class:`MeasuredPoint` — one load-tested genome and the identity string
  of the path that served it.
* :class:`TunedProfile` — a serializable front row that
  ``RetrievalService.register_pipeline(profile=...)`` /
  ``register_runner(profile=...)`` accept; a profile written by ``repro``
  loads here (same fields, same ``tag``).

The gene ``"pallas"`` stays legal and names the ``cuda`` backend, which
answers to it.  One rule differs from ``repro`` on purpose: a ``tile_n``
gene on ``"pallas"`` is refused, because the CUDA kernels choose their own
launch shape.  The search half (``random_config``, ``mutate``,
``crossover``, ``proxy_objectives``, the non-dominated sort,
``roofline_prune``, ``pareto_front``, ``measure_config``, ``autotune``)
has no counterpart yet.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Optional, Tuple

from repro_torch.core import backends as backends_lib
from repro_torch.core.backends import (CudaBackend, GraphANNBackend, NappBackend,
                                       ReferenceBackend, StreamingBackend)
from repro_torch.core.spaces import CORPUS_DTYPES, canonical_dtype, cast_corpus
from repro_torch.serving.batcher import OVERLOAD_POLICIES

__all__ = ["ServingConfig", "check_config", "MeasuredPoint", "TunedProfile"]

# Knob domains the genome operators sample from (search menus, not
# legality bounds: legality is check_config).
GENOME_BACKENDS = ("reference", "streaming", "pallas", "graph_ann", "napp")
GENOME_TILES = (None, 512, 1024, 2048, 4096, 8192)
GENOME_SHARDS = (1, 2, 4)
GENOME_BATCH_SIZES = (1, 2, 4, 8, 16, 32, 64, 128)
GENOME_WAITS_S = (0.0005, 0.001, 0.002, 0.005, 0.01)
GENOME_CACHE_SIZES = (0, 1024, 4096)
GENOME_QUEUES = (None, 32, 128)
GENOME_EFS = (16, 32, 64, 128)
GENOME_HOPS = (None, 2, 4, 8)
GENOME_NUM_SEARCH = (4, 8, 16)
GENOME_RERANK = (64, 128, 256)
# Funnel knobs (only sampled for funnel endpoints — plain genomes keep
# them None so a pipeline config can never differ in dead funnel genes):
GENOME_RERANK_KEEP = (10, 20, 50)
GENOME_RERANK_BUDGETS_MS = (None, 2.0, 5.0, 20.0)

# GraphANNBackend's default graph degree: the kernel beam-budget legality
# check needs it.
_GRAPH_DEGREE = 16

# The genes that name the CUDA kernels (``"pallas"`` in repro's profiles).
_KERNEL_GENES = ("pallas", "cuda")
# The residency dtypes the kernels serve, by name.
_KERNEL_DTYPES = tuple(canonical_dtype(d) for d in backends_lib._DTYPES)


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """One point in the serving config space — the autotuner's genome.

    Backend-scoped knobs are ``None`` (or False) when inapplicable:
    ``tile_n`` exists for streaming, ``ef``/``hops``/``kernel`` for
    graph_ann, ``num_search``/``rerank_qty`` for napp —
    :func:`check_config` rejects out-of-scope knobs, so two configs that
    serve identically can never differ in dead genes.  The fields, their
    order and defaults are ``repro``'s, so that a profile's ``tag`` (a
    digest of :meth:`to_dict`) is the same in both packages."""

    backend: str = "reference"
    tile_n: Optional[int] = None
    corpus_dtype: str = "float32"
    n_shards: int = 1
    batch_size: int = 16
    max_wait_s: float = 0.01
    cache_size: int = 0
    max_queue: Optional[int] = None
    overload: str = "block"
    ef: Optional[int] = None
    hops: Optional[int] = None
    kernel: bool = False
    num_search: Optional[int] = None
    rerank_qty: Optional[int] = None
    # funnel genes (FunnelPipeline endpoints): rerank_keep = served width
    # of the rerank stage, rerank_budget_ms = its soft stage deadline
    # (skip-and-degrade past it).  Both None for plain serving configs.
    rerank_keep: Optional[int] = None
    rerank_budget_ms: Optional[float] = None

    def key(self) -> tuple:
        """Canonical hashable identity (dedup across generations)."""
        return dataclasses.astuple(self)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ServingConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def make_backend(self):
        """The ExecutionBackend instance this genome declares."""
        if self.backend == "reference":
            return ReferenceBackend()
        if self.backend == "streaming":
            return (StreamingBackend(tile_n=self.tile_n)
                    if self.tile_n is not None else StreamingBackend())
        if self.backend in _KERNEL_GENES:
            if self.tile_n is not None:
                raise ValueError(_kernel_tile_reason(self.backend))
            return CudaBackend()
        if self.backend == "graph_ann":
            return GraphANNBackend(ef=self.ef, hops=self.hops,
                                   kernel=self.kernel)
        if self.backend == "napp":
            # min_times=1, as repro's genome: at small corpus sizes the
            # stricter default intersection threshold empties candidate sets
            return NappBackend(num_search=self.num_search,
                               min_times=1, rerank_qty=self.rerank_qty)
        raise ValueError(f"unknown backend {self.backend!r}")


def _kernel_tile_reason(backend: str) -> str:
    return (f"tile_n does not apply to {backend}: the CUDA kernels choose "
            "their own launch shape")


def check_config(cfg: ServingConfig, k: int, space=None,
                 corpus=None) -> Optional[str]:
    """None if ``cfg`` is a legal genome for top-``k`` serving, else the
    reason — derived from the backend capability matrix, never restated.

    With ``space``/``corpus`` supplied the actual capability check runs
    against the corpus cast to the genome's residency dtype (exactly
    what registration will scan), so a config that would silently fall
    back to reference at registration is illegal here."""
    if cfg.backend not in backends_lib.available_backends():
        return (f"unknown backend {cfg.backend!r}; registered: "
                f"{backends_lib.available_backends()}")
    if cfg.corpus_dtype not in CORPUS_DTYPES:
        return (f"corpus_dtype {cfg.corpus_dtype!r} outside the precision "
                f"contract {CORPUS_DTYPES}")
    if cfg.n_shards < 1:
        return "n_shards must be >= 1"
    if cfg.batch_size < 1:
        return "batch_size must be >= 1"
    if cfg.max_wait_s <= 0:
        return "max_wait_s must be positive"
    if cfg.cache_size < 0:
        return "cache_size must be >= 0"
    if cfg.max_queue is not None and cfg.max_queue < 1:
        return "max_queue must be >= 1 (or None for unbounded)"
    if cfg.overload not in OVERLOAD_POLICIES:
        return f"overload {cfg.overload!r} not in {OVERLOAD_POLICIES}"
    if cfg.max_queue is not None and cfg.max_queue < cfg.batch_size:
        return ("max_queue below batch_size starves the batcher of full "
                "batches")

    if cfg.tile_n is not None:
        if cfg.backend in _KERNEL_GENES:
            return _kernel_tile_reason(cfg.backend)
        if cfg.backend != "streaming":
            # repro's wording: the genome's tile gene is shared with it
            return f"tile_n applies to streaming/pallas, not {cfg.backend}"
        if cfg.tile_n < 1:
            return "tile_n must be >= 1"

    graph = cfg.backend == "graph_ann"
    if (cfg.ef is not None or cfg.hops is not None or cfg.kernel) and not graph:
        return f"ef/hops/kernel apply to graph_ann, not {cfg.backend}"
    if graph:
        if cfg.ef is None:
            return "graph_ann needs a declared ef budget"
        if k > cfg.ef:
            return (f"graph_ann declared search budget ef={cfg.ef} cannot "
                    f"produce top-{k}")
        if cfg.hops is not None and cfg.hops < 1:
            return "hops must be >= 1 (or None for the auto default)"
        if cfg.kernel:
            from repro_torch.kernels.beam_topk import check_beam_budget
            try:
                check_beam_budget(cfg.ef, _GRAPH_DEGREE)
            except ValueError as exc:
                return str(exc)
            if cfg.corpus_dtype not in _KERNEL_DTYPES:
                return (f"graph_ann kernel path serves {_KERNEL_DTYPES} "
                        f"corpora, not {cfg.corpus_dtype}")

    napp = cfg.backend == "napp"
    if (cfg.num_search is not None or cfg.rerank_qty is not None) and not napp:
        return f"num_search/rerank_qty apply to napp, not {cfg.backend}"
    if napp:
        if cfg.rerank_qty is None:
            return "napp needs a declared rerank_qty budget"
        if k > cfg.rerank_qty:
            return (f"napp declared re-rank budget rerank_qty="
                    f"{cfg.rerank_qty} cannot produce top-{k}")
        if cfg.num_search is None or cfg.num_search < 1:
            return "napp needs num_search >= 1"

    if cfg.backend in ("graph_ann", "napp") and cfg.n_shards != 1:
        return ("approximate backends tune against one global index "
                "(sharding would measure the union-of-shards "
                "approximation and rebuild per-shard indexes per config)")
    if cfg.backend in _KERNEL_GENES and cfg.corpus_dtype not in _KERNEL_DTYPES:
        return (f"{cfg.backend} serves {_KERNEL_DTYPES} corpora, "
                f"not {cfg.corpus_dtype}")

    if cfg.rerank_keep is not None and cfg.rerank_keep < k:
        return (f"funnel rerank_keep={cfg.rerank_keep} cannot serve "
                f"top-{k}")
    if cfg.rerank_budget_ms is not None and not cfg.rerank_budget_ms > 0:
        return "rerank_budget_ms must be positive (or None for unbounded)"

    if space is not None and corpus is not None:
        test_corpus = cast_corpus(corpus, canonical_dtype(cfg.corpus_dtype))
        why = cfg.make_backend().supports(space, test_corpus)
        if why is not None:
            return why
    return None


@dataclasses.dataclass(frozen=True)
class MeasuredPoint:
    """One load-tested genome: measured objectives + the endpoint
    identity that proves which path actually served."""

    config: ServingConfig
    qps: float
    p50_ms: float
    p99_ms: float
    recall: float
    identity: str
    corpus_dtype: Optional[str] = None

    def objectives(self) -> Tuple[float, float, float]:
        """Maximization vector: (qps, -p99_ms, recall)."""
        return (self.qps, -self.p99_ms, self.recall)

    def to_row(self) -> Dict[str, Any]:
        return {"config": self.config.to_dict(),
                "backend": self.config.backend,
                "identity": self.identity,
                "corpus_dtype": self.corpus_dtype,
                "qps": self.qps, "p50_ms": self.p50_ms,
                "p99_ms": self.p99_ms, "recall": self.recall}

    @classmethod
    def from_row(cls, row: Dict[str, Any]) -> "MeasuredPoint":
        return cls(config=ServingConfig.from_dict(row["config"]),
                   qps=row["qps"], p50_ms=row["p50_ms"],
                   p99_ms=row["p99_ms"], recall=row["recall"],
                   identity=row["identity"],
                   corpus_dtype=row.get("corpus_dtype"))


@dataclasses.dataclass(frozen=True)
class TunedProfile:
    """A serializable Pareto-front row: the genome plus its measured
    objectives and the identity string of the path that produced them.

    ``RetrievalService.register_pipeline(profile=...)`` /
    ``register_runner(profile=...)`` rebind backend, corpus dtype and
    batching/admission knobs from the profile in one shot; the profile's
    ``tag`` lands in :class:`~repro_torch.serving.stats.EndpointSnapshot`
    and the endpoint's cache keys.  ``cache_size`` is a *service*-level
    knob: pass ``profile.config.cache_size`` to the ``RetrievalService``
    constructor."""

    config: ServingConfig
    qps: float = 0.0
    p50_ms: float = 0.0
    p99_ms: float = 0.0
    recall: float = 1.0
    identity: str = ""
    source: str = "autotune"

    @property
    def tag(self) -> str:
        """Short stable digest of the genome — the provenance string,
        equal to ``repro``'s for the same genome."""
        payload = json.dumps(self.config.to_dict(), sort_keys=True,
                             separators=(",", ":"))
        digest = hashlib.blake2b(payload.encode(),
                                 digest_size=6).hexdigest()
        return f"profile:{digest}"

    @classmethod
    def from_point(cls, point: MeasuredPoint,
                   source: str = "autotune") -> "TunedProfile":
        return cls(config=point.config, qps=point.qps, p50_ms=point.p50_ms,
                   p99_ms=point.p99_ms, recall=point.recall,
                   identity=point.identity, source=source)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["tag"] = self.tag
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TunedProfile":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        kw["config"] = ServingConfig.from_dict(d["config"])
        return cls(**kw)

    def to_spec(self):
        """This profile as a :class:`~repro_torch.serving.spec.EndpointSpec`:
        backend instance, corpus dtype, batching/admission knobs and — for
        funnel genomes — the ``rerank_keep`` width and rerank stage
        budget, with the profile itself carried for provenance."""
        from repro_torch.serving.funnel import StageBudget
        from repro_torch.serving.spec import EndpointSpec

        cfg = self.config
        budget = (StageBudget(rerank_s=cfg.rerank_budget_ms / 1e3)
                  if cfg.rerank_budget_ms is not None else None)
        return EndpointSpec(
            batch_size=cfg.batch_size, max_wait_s=cfg.max_wait_s,
            max_queue=cfg.max_queue, overload=cfg.overload,
            backend=cfg.make_backend(), corpus_dtype=cfg.corpus_dtype,
            profile=self, budget=budget, rerank_keep=cfg.rerank_keep)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "TunedProfile":
        return cls.from_dict(json.loads(text))
