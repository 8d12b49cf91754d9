"""Roofline-pruned Pareto autotuner over the serving config space
(counterpart of ``repro/serving/autotune.py``).

* :class:`ServingConfig` — a typed genome over every serving knob, with
  per-knob legality (:func:`check_config`) derived from the capability
  matrix in :mod:`repro_torch.core.backends`.
* Genome operators (:func:`random_config`, :func:`mutate`,
  :func:`crossover`), deterministic in their ``np.random.Generator``.
* A zero-cost **roofline proxy** (:func:`proxy_objectives`, on the Hopper
  model of :mod:`repro_torch.launch.roofline`) estimates each genome's
  (throughput, latency, recall); candidates are pruned to a measurement
  budget by non-dominated proxy rank + crowding (:func:`roofline_prune`).
* :func:`measure_config` load-tests a survivor under a fresh
  :class:`~repro_torch.serving.service.RetrievalService` and checks, from
  the endpoint snapshot's identity, that the declared path served.
* :func:`autotune` evolves the population (mutation + crossover +
  NSGA-II-style non-dominated sorting) toward the measured
  latency/throughput/recall Pareto front.
* :class:`TunedProfile` — a serializable front row that
  ``RetrievalService.register_pipeline(profile=...)`` /
  ``register_runner(profile=...)`` accept; a profile written by ``repro``
  loads here (same fields, same ``tag``).

The gene ``"pallas"`` stays legal and names the ``cuda`` backend, which
answers to it.  Differences from ``repro``, on purpose:

* a ``tile_n`` gene on a kernel genome is refused, because the CUDA
  kernels choose their own launch shape.  The operators still draw it
  where ``repro``'s draw it, and :func:`_repair` drops it, so both
  packages consume a generator alike: every genome on which the two
  legality rules agree is drawn equal.  The sequences part where
  :func:`mutate` picks the ``tile_n`` gene of a kernel genome (here the
  repaired genome equals its parent and the loop draws again), where
  :func:`crossover` gives a streaming child a kernel parent's tile
  (``repro``'s child keeps it), and where ``autotune`` deduplicates
  kernel genomes that ``repro`` tells apart by their tile;
* :func:`measure_config` accepts the identity ``"cuda"`` for a kernel
  genome (``CudaBackend`` serves ``"pallas"``), and only for one;
* :func:`measure_config` takes queries of any row-major form (a tensor,
  ``SparseVectors`` or ``FusedVectors``) and sends row ``i`` of every
  leaf as request ``i``; ``repro`` indexes a dense array only.

The proxy's modelling constants (:data:`_PROXY_BATCH_OVERHEAD_S`,
:data:`_PROXY_FLOOD_BACKLOG`) are ``repro``'s: model constants, not
measurements.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import backends as backends_lib
from repro_torch.core.backends import (CudaBackend, GraphANNBackend, NappBackend,
                                       ReferenceBackend, StreamingBackend)
from repro_torch.core.spaces import (CORPUS_DTYPES, canonical_dtype, cast_corpus,
                                     map_tensors, tensor_leaves)
from repro_torch.serving.batcher import OVERLOAD_POLICIES, ServiceOverloaded

__all__ = [
    "ServingConfig",
    "check_config",
    "random_config",
    "mutate",
    "crossover",
    "proxy_objectives",
    "roofline_prune",
    "dominates",
    "pareto_front",
    "nondominated_sort",
    "crowding_distance",
    "MeasuredPoint",
    "measure_config",
    "autotune",
    "AutotuneResult",
    "TunedProfile",
]

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

# GraphANNBackend's default graph degree: the proxy's candidate-visit
# count and the kernel beam-budget legality check both need it.
_GRAPH_DEGREE = 16

# Model constants of the proxy, repro's: the host's per-batch overhead
# folded into the proxy's batch time (without it the ranking would be
# driven by differences no measurement can reproduce), and the queue depth
# in batches assumed for an unbounded admission queue under a flood.
_PROXY_BATCH_OVERHEAD_S = 1e-3
_PROXY_FLOOD_BACKLOG = 8.0

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


# ---------------------------------------------------------------------------
# Genome operators (mutation / crossover), deterministic in their rng.
# ---------------------------------------------------------------------------

_TILED_GENES = ("streaming",) + _KERNEL_GENES   # the genomes repro gives a tile gene


def _choice(rng: np.random.Generator, domain: Sequence):
    return domain[int(rng.integers(len(domain)))]


def _knobs_for(backend: str, funnel: bool = False) -> List[str]:
    """The genes :func:`mutate` may pick, ``repro``'s list: a kernel
    genome keeps its ``tile_n`` entry, so that the pick draws alike."""
    knobs = ["backend", "corpus_dtype", "n_shards", "batch_size",
             "max_wait_s", "cache_size", "max_queue", "overload"]
    if backend in _TILED_GENES:
        knobs.append("tile_n")
    if backend == "graph_ann":
        knobs += ["ef", "hops", "kernel"]
    if backend == "napp":
        knobs += ["num_search", "rerank_qty"]
    if funnel:
        knobs += ["rerank_keep", "rerank_budget_ms"]
    return knobs


def _resample(knob: str, rng: np.random.Generator, k: int):
    if knob == "backend":
        return _choice(rng, GENOME_BACKENDS)
    if knob == "corpus_dtype":
        return _choice(rng, CORPUS_DTYPES)
    if knob == "n_shards":
        return _choice(rng, GENOME_SHARDS)
    if knob == "batch_size":
        return _choice(rng, GENOME_BATCH_SIZES)
    if knob == "max_wait_s":
        return _choice(rng, GENOME_WAITS_S)
    if knob == "cache_size":
        return _choice(rng, GENOME_CACHE_SIZES)
    if knob == "max_queue":
        return _choice(rng, GENOME_QUEUES)
    if knob == "overload":
        return _choice(rng, OVERLOAD_POLICIES)
    if knob == "tile_n":
        return _choice(rng, GENOME_TILES)
    if knob == "ef":
        return _choice(rng, [e for e in GENOME_EFS if e >= k])
    if knob == "hops":
        return _choice(rng, GENOME_HOPS)
    if knob == "kernel":
        return bool(rng.integers(2))
    if knob == "num_search":
        return _choice(rng, GENOME_NUM_SEARCH)
    if knob == "rerank_qty":
        return _choice(rng, [r for r in GENOME_RERANK if r >= k])
    if knob == "rerank_keep":
        return _choice(rng, [r for r in GENOME_RERANK_KEEP if r >= k])
    if knob == "rerank_budget_ms":
        return _choice(rng, GENOME_RERANK_BUDGETS_MS)
    raise KeyError(knob)


def _repair(d: Dict[str, Any], rng: np.random.Generator,
            k: int) -> Optional[ServingConfig]:
    """Re-scope backend-specific genes after a backend flip / crossover,
    then run the full legality check.  Returns None when irreparable.
    The tile gene survives on streaming only (repro keeps it on
    ``"pallas"`` too); dropping it draws nothing."""
    backend = d["backend"]
    if backend != "streaming":
        d["tile_n"] = None
    if backend != "graph_ann":
        d["ef"], d["hops"], d["kernel"] = None, None, False
    else:
        if d["ef"] is None or d["ef"] < k:
            d["ef"] = _resample("ef", rng, k)
    if backend != "napp":
        d["num_search"], d["rerank_qty"] = None, None
    else:
        if d["num_search"] is None:
            d["num_search"] = _resample("num_search", rng, k)
        if d["rerank_qty"] is None or d["rerank_qty"] < k:
            d["rerank_qty"] = _resample("rerank_qty", rng, k)
    if backend in ("graph_ann", "napp"):
        d["n_shards"] = 1
    if d["max_queue"] is not None and d["max_queue"] < d["batch_size"]:
        d["max_queue"] = None
    if d.get("rerank_keep") is None:
        # a stage budget without a rerank stage is a dead gene
        d["rerank_budget_ms"] = None
    elif d["rerank_keep"] < k:
        d["rerank_keep"] = _resample("rerank_keep", rng, k)
    cfg = ServingConfig(**d)
    return cfg if check_config(cfg, k) is None else None


def random_config(rng: np.random.Generator, k: int) -> ServingConfig:
    """One uniformly-sampled legal genome."""
    for _ in range(128):
        d = {knob: _resample(knob, rng, k)
             for knob in ("backend", "corpus_dtype", "n_shards",
                          "batch_size", "max_wait_s", "cache_size",
                          "max_queue", "overload")}
        d.update(tile_n=None, ef=None, hops=None, kernel=False,
                 num_search=None, rerank_qty=None,
                 rerank_keep=None, rerank_budget_ms=None)
        if d["backend"] in _TILED_GENES:
            d["tile_n"] = _resample("tile_n", rng, k)
        if d["backend"] == "graph_ann":
            d["ef"] = _resample("ef", rng, k)
            d["hops"] = _resample("hops", rng, k)
            d["kernel"] = _resample("kernel", rng, k)
        if d["backend"] == "napp":
            d["num_search"] = _resample("num_search", rng, k)
            d["rerank_qty"] = _resample("rerank_qty", rng, k)
        cfg = _repair(d, rng, k)
        if cfg is not None:
            return cfg
    raise RuntimeError("could not sample a legal serving config")


def mutate(cfg: ServingConfig, rng: np.random.Generator,
           k: int) -> ServingConfig:
    """Resample one applicable knob (repairing scoped genes); returns a
    legal genome, falling back to ``cfg`` itself if 64 attempts fail."""
    for _ in range(64):
        knob = _choice(rng, _knobs_for(cfg.backend,
                                       funnel=cfg.rerank_keep is not None))
        d = cfg.to_dict()
        d[knob] = _resample(knob, rng, k)
        new = _repair(d, rng, k)
        if new is not None and new != cfg:
            return new
    return cfg


def crossover(a: ServingConfig, b: ServingConfig, rng: np.random.Generator,
              k: int) -> ServingConfig:
    """Uniform crossover: each gene from either parent, then repair.
    Falls back to parent ``a`` when the blend is irreparable."""
    da, db = a.to_dict(), b.to_dict()
    d = {key: (da[key] if rng.integers(2) else db[key]) for key in da}
    new = _repair(d, rng, k)
    return new if new is not None else a


# ---------------------------------------------------------------------------
# Zero-cost roofline proxy.
# ---------------------------------------------------------------------------

def proxy_objectives(cfg: ServingConfig, *, n_docs: int, dim: int, k: int,
                     repeat_fraction: float = 0.0) -> Tuple[float, float, float]:
    """Estimated maximization objectives ``(qps, -latency_s, recall)`` for
    one genome from the roofline model alone, ``repro``'s formulas on the
    Hopper terms of :mod:`repro_torch.launch.roofline`.

    Exact backends: the whole-config scan
    (:func:`~repro_torch.launch.roofline.serving_scan_seconds`).
    graph_ann: ``sqrt(N) + hops * ef * degree`` candidate visits through
    the gather roofline
    (:func:`~repro_torch.launch.roofline.serving_visit_seconds`).  napp:
    the pivot-count pass plus the exact re-rank of ``rerank_qty`` rows.
    Proxy recall is 1 for exact paths and falls as ``k`` nears the
    declared budget for approximate ones (a rank signal, not a
    calibration).  A cache makes the repeated fraction of the workload
    free; an unbounded queue backs up :data:`_PROXY_FLOOD_BACKLOG`
    batches under a flood, a bounded one ``max_queue / batch_size``."""
    from repro_torch.launch.roofline import serving_scan_seconds, serving_visit_seconds

    itemsize = 2 if cfg.corpus_dtype == "bfloat16" else 4
    bytes_per_row = float(dim * itemsize)
    b = cfg.batch_size
    if cfg.backend == "graph_ann":
        hops = (cfg.hops if cfg.hops is not None
                else max(4, int(2 * math.log(max(n_docs, 2)))))
        visits = math.sqrt(n_docs) + hops * cfg.ef * _GRAPH_DEGREE
        batch_s = serving_visit_seconds(visits, b=b, bytes_per_row=bytes_per_row,
                                        flops_per_visit=2.0 * dim)
        recall = 1.0 - 0.5 * k / cfg.ef
    elif cfg.backend == "napp":
        # count pass: every row contributes one num_search-wide integer
        # dot against the query's pivot set (4 bytes of posting data per
        # row), then rerank_qty gathered rows are scored exactly
        count_s = serving_scan_seconds(
            n_docs, b=b, k=k, bytes_per_row=4.0,
            flops_per_row=2.0 * b * cfg.num_search)
        rerank_s = serving_visit_seconds(
            cfg.rerank_qty, b=b, bytes_per_row=bytes_per_row,
            flops_per_visit=2.0 * dim)
        batch_s = count_s + rerank_s
        recall = 1.0 - 0.5 * k / cfg.rerank_qty
    else:
        batch_s = serving_scan_seconds(
            n_docs, b=b, k=k, bytes_per_row=bytes_per_row,
            flops_per_row=2.0 * b * dim, tile_n=cfg.tile_n,
            n_shards=cfg.n_shards)
        recall = 1.0
    step_s = batch_s + _PROXY_BATCH_OVERHEAD_S
    miss = 1.0 - (repeat_fraction if cfg.cache_size > 0 else 0.0)
    qps = b / (step_s * max(miss, 0.05))
    backlog = (cfg.max_queue / b if cfg.max_queue is not None
               else _PROXY_FLOOD_BACKLOG)
    latency_s = cfg.max_wait_s + (1.0 + backlog) * step_s
    return (qps, -latency_s, recall)


# ---------------------------------------------------------------------------
# Non-dominated sorting + crowding (NSGA-II machinery).
# ---------------------------------------------------------------------------

def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """True iff maximization vector ``a`` Pareto-dominates ``b``: no
    worse on every objective, strictly better on at least one."""
    return (all(x >= y for x, y in zip(a, b))
            and any(x > y for x, y in zip(a, b)))


def nondominated_sort(objectives: Sequence[Sequence[float]]) -> List[List[int]]:
    """Fast non-dominated sort: list of fronts (index lists), front 0
    first.  Deterministic — indices keep input order within a front."""
    n = len(objectives)
    dominated_by = [0] * n            # how many points dominate i
    dominates_set: List[List[int]] = [[] for _ in range(n)]
    for i in range(n):
        for j in range(i + 1, n):
            if dominates(objectives[i], objectives[j]):
                dominates_set[i].append(j)
                dominated_by[j] += 1
            elif dominates(objectives[j], objectives[i]):
                dominates_set[j].append(i)
                dominated_by[i] += 1
    fronts = [[i for i in range(n) if dominated_by[i] == 0]]
    while fronts[-1]:
        nxt = []
        for i in fronts[-1]:
            for j in dominates_set[i]:
                dominated_by[j] -= 1
                if dominated_by[j] == 0:
                    nxt.append(j)
        fronts.append(sorted(nxt))
    return fronts[:-1]


def crowding_distance(objectives: Sequence[Sequence[float]],
                      front: Sequence[int]) -> Dict[int, float]:
    """Per-index crowding distance within one front.  Boundary points of
    every objective get +inf, so budget truncation keeps each axis's
    extreme before filling in the middle."""
    dist = {i: 0.0 for i in front}
    if len(front) <= 2:
        return {i: math.inf for i in front}
    n_obj = len(objectives[front[0]])
    for m in range(n_obj):
        order = sorted(front, key=lambda i: objectives[i][m])
        lo, hi = objectives[order[0]][m], objectives[order[-1]][m]
        dist[order[0]] = dist[order[-1]] = math.inf
        if hi == lo:
            continue
        for pos in range(1, len(order) - 1):
            gap = (objectives[order[pos + 1]][m]
                   - objectives[order[pos - 1]][m])
            dist[order[pos]] += gap / (hi - lo)
    return dist


def _rank_order(objectives: Sequence[Sequence[float]]) -> List[int]:
    """All indices, best-first: by front rank, then crowding distance
    (descending), ties by index — the NSGA-II survivor ordering."""
    order: List[int] = []
    for front in nondominated_sort(objectives):
        dist = crowding_distance(objectives, front)
        order.extend(sorted(front, key=lambda i: (-dist[i], i)))
    return order


def roofline_prune(configs: Sequence[ServingConfig], budget: int, *,
                   n_docs: int, dim: int, k: int,
                   repeat_fraction: float = 0.0,
                   ) -> Tuple[List[ServingConfig], int]:
    """Keep the ``budget`` best candidates by proxy Pareto rank +
    crowding; returns (kept, n_pruned).  No measurement happens here."""
    if len(configs) <= budget:
        return list(configs), 0
    objs = [proxy_objectives(c, n_docs=n_docs, dim=dim, k=k,
                             repeat_fraction=repeat_fraction)
            for c in configs]
    keep = _rank_order(objs)[:budget]
    return [configs[i] for i in keep], len(configs) - budget


# ---------------------------------------------------------------------------
# Measurement under the real load generator.
# ---------------------------------------------------------------------------

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


def pareto_front(points: Sequence[MeasuredPoint]) -> List[MeasuredPoint]:
    """The non-dominated subset of measured points, best-qps first."""
    objs = [p.objectives() for p in points]
    front = nondominated_sort(objs)[0] if points else []
    return [points[i] for i in sorted(front, key=lambda i: -objs[i][0])]


def _served_as_declared(cfg: ServingConfig, identity: Optional[str]) -> bool:
    """Whether an endpoint's backend identity names the genome's path:
    ``repro``'s prefix rule, and ``"cuda"`` for a kernel genome."""
    identity = identity or ""
    return (identity.startswith(cfg.backend)
            or (cfg.backend in _KERNEL_GENES and identity.startswith("cuda")))


def _measure_once(cfg: ServingConfig, *, space, corpus, queries,
                  warmup_queries, workload, k: int, passes: int,
                  check_n: int):
    """One cold load test: fresh pipeline + service, warm-up off the
    clock, ``passes`` replays of the workload (futures drained between
    passes so that pass 2+ hits a warm cache), then a one-at-a-time
    spot-check retrieval.  Returns None when the config served nothing,
    else ``(qps, p50_ms, p99_ms, identity, corpus_dtype, got_indices)``."""
    from repro_torch.core.pipeline import BruteForceGenerator, RetrievalPipeline
    from repro_torch.serving.service import RetrievalService
    from repro_torch.serving.sharded import ShardedPipeline

    def row(batch, i):
        return map_tensors(lambda x: x[i], batch)

    backend = cfg.make_backend()
    if cfg.n_shards > 1:
        pipe = ShardedPipeline.from_corpus(space, corpus, cfg.n_shards,
                                           cand_qty=k, final_qty=k)
    else:
        pipe = RetrievalPipeline(BruteForceGenerator(space, corpus),
                                 cand_qty=k, final_qty=k)
    n_unique = int(tensor_leaves(queries)[0].shape[0])
    try:
        svc = RetrievalService(cache_size=cfg.cache_size)
        svc.register_pipeline(
            "tuned", pipe, row(queries, 0),
            batch_size=cfg.batch_size, max_wait_s=cfg.max_wait_s,
            max_queue=cfg.max_queue, overload=cfg.overload,
            backend=backend, corpus_dtype=cfg.corpus_dtype)
        with svc:
            # warm-up off the clock (index builds, kernel builds); one
            # request at a time, so that a small queue bound cannot reject
            n_warm = int(tensor_leaves(warmup_queries)[0].shape[0])
            for i in range(min(cfg.batch_size, n_warm)):
                svc.retrieve([row(warmup_queries, i)], endpoint="tuned")
            svc.reset_stats()
            t0 = time.perf_counter()
            served = 0
            for _ in range(passes):
                futs = []
                for i in workload:
                    try:
                        futs.append(svc.submit(row(queries, int(i) % n_unique),
                                               endpoint="tuned"))
                    except ServiceOverloaded:
                        pass      # counted in the endpoint's rejected stat
                for f in futs:
                    try:
                        f.result()
                        served += 1
                    except ServiceOverloaded:
                        pass      # shed_oldest eviction
            wall = time.perf_counter() - t0
            snap = svc.snapshot()
            ep = snap.endpoints["tuned"]
            if served == 0 or ep.e2e.count == 0:
                return None
            # recall spot-check after the timing window, one request at a
            # time (stays under any admission bound)
            m = min(check_n, n_unique)
            got = np.stack([
                np.asarray(svc.retrieve([row(queries, i)], endpoint="tuned")[0].indices)
                for i in range(m)])
    finally:
        if hasattr(pipe, "close"):
            pipe.close()
    if not _served_as_declared(cfg, ep.backend):
        raise RuntimeError(
            f"config requested backend {cfg.backend!r} but the endpoint "
            f"served {ep.backend!r} — refusing to publish a fallback "
            f"measurement")
    if ep.corpus_dtype != cfg.corpus_dtype:
        raise RuntimeError(
            f"config requested corpus_dtype {cfg.corpus_dtype!r} but the "
            f"endpoint served {ep.corpus_dtype!r}")
    return (served / wall, ep.e2e.p50_ms, ep.e2e.p99_ms, ep.backend,
            ep.corpus_dtype, got)


def measure_config(cfg: ServingConfig, *, space, corpus, queries,
                   warmup_queries, workload, k: int, oracle_indices,
                   check_n: int = 16, passes: int = 2,
                   repeats: int = 1) -> Optional[MeasuredPoint]:
    """Load-test one genome under a real RetrievalService.

    Builds the genome's pipeline (sharded when ``n_shards > 1``),
    registers it with the genome's backend instance / dtype / batching /
    admission knobs, replays the hot-set ``workload`` (indices into the
    rows of ``queries``) ``passes`` times per cold run, then measures
    recall@k against ``oracle_indices`` on the first ``check_n`` queries
    (submitted one at a time).  ``repeats`` cold runs are aggregated by
    per-objective median.

    Returns None when the config served nothing in any repeat.  Raises if
    the endpoint snapshot shows another backend or dtype than the genome
    declared: a capability fallback never publishes a measurement under
    the requested path's name."""
    from repro_torch.core.fusion import topk_recall

    samples = []
    for _ in range(max(repeats, 1)):
        sample = _measure_once(cfg, space=space, corpus=corpus, queries=queries,
                               warmup_queries=warmup_queries, workload=workload,
                               k=k, passes=passes, check_n=check_n)
        if sample is None:
            return None
        samples.append(sample)
    qps = float(np.median([s[0] for s in samples]))
    p50 = float(np.median([s[1] for s in samples]))
    p99 = float(np.median([s[2] for s in samples]))
    identity, corpus_dtype, got = samples[-1][3], samples[-1][4], samples[-1][5]
    m = got.shape[0]
    oracle = oracle_indices.cpu().numpy() if hasattr(oracle_indices, "cpu") else oracle_indices
    recall = float(topk_recall(np.asarray(oracle)[:m], got))
    return MeasuredPoint(config=cfg, qps=qps, p50_ms=p50, p99_ms=p99,
                         recall=recall, identity=identity,
                         corpus_dtype=corpus_dtype)


# ---------------------------------------------------------------------------
# The evolution loop.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AutotuneResult:
    front: List[MeasuredPoint]
    archive: List[MeasuredPoint]
    counts: Dict[str, int]          # generated / measured / pruned


def autotune(measure_fn: Callable[[ServingConfig], Optional[MeasuredPoint]],
             *, k: int, n_docs: int, dim: int, seed: int = 0,
             generations: int = 3, population: int = 32,
             measure_budget: int = 8, repeat_fraction: float = 0.0,
             seed_points: Sequence[MeasuredPoint] = (),
             explore_configs: Sequence[ServingConfig] = (),
             space=None, corpus=None,
             log: Optional[Callable[[str], None]] = None) -> AutotuneResult:
    """Evolve the measured latency/throughput/recall Pareto front.

    Per generation: ``population`` unique legal candidates (generation 0
    from ``explore_configs`` + uniform sampling; later from crossover +
    mutation of front-ranked archive parents), pruned to
    ``measure_budget`` by the roofline proxy (:func:`roofline_prune`),
    the survivors measured with ``measure_fn`` and folded into the
    archive.  ``seed_points`` (already measured) start the archive.

    Deterministic in ``seed`` for a deterministic ``measure_fn``: every
    random draw flows from one ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    archive: List[MeasuredPoint] = list(seed_points)
    seen = {p.config.key() for p in archive}
    generated = len(archive)
    measured = len(archive)
    pruned = 0
    for gen in range(generations):
        pool: List[ServingConfig] = []
        ranked: List[MeasuredPoint] = []
        if archive:
            objs = [p.objectives() for p in archive]
            ranked = [archive[i] for i in _rank_order(objs)]
        if gen == 0:
            for cfg in explore_configs:
                if (check_config(cfg, k, space, corpus) is None
                        and cfg.key() not in seen):
                    seen.add(cfg.key())
                    pool.append(cfg)
        tries = 0
        while len(pool) < population and tries < population * 40:
            tries += 1
            if gen == 0 or not ranked or rng.random() < 0.25:
                cand = random_config(rng, k)
            else:
                # tournament-of-ranked parents: earlier archive rows are
                # better (front rank, then crowding)
                half = max(1, len(ranked) // 2)
                pa = ranked[int(rng.integers(half))]
                pb = ranked[int(rng.integers(len(ranked)))]
                cand = mutate(crossover(pa.config, pb.config, rng, k), rng, k)
            if check_config(cand, k, space, corpus) is not None:
                continue
            if cand.key() in seen:
                continue
            seen.add(cand.key())
            pool.append(cand)
        generated += len(pool)
        kept, n_pruned = roofline_prune(
            pool, measure_budget, n_docs=n_docs, dim=dim, k=k,
            repeat_fraction=repeat_fraction)
        pruned += n_pruned
        if log:
            log(f"gen {gen}: {len(pool)} candidates, "
                f"{n_pruned} proxy-pruned, measuring {len(kept)}")
        for cfg in kept:
            point = measure_fn(cfg)
            measured += 1
            if point is not None:
                archive.append(point)
    front = pareto_front(archive)
    counts = {"generated": generated, "measured": measured, "pruned": pruned}
    assert counts["pruned"] + counts["measured"] == counts["generated"]
    return AutotuneResult(front=front, archive=archive, counts=counts)


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
