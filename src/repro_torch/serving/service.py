"""RetrievalService — the async serving facade (counterpart of
``repro/serving/service.py``)::

    submit() --cache hit--> future (already resolved)
        \\--miss--> Router --> per-endpoint ContinuousBatcher
                                   |  bounded admission queue
                                   |  (overflow: block | reject | shed)
                                   |  size/deadline close, pad, stack,
                                   |  one copy to the endpoint's device
                                   v
                          batched runner (RetrievalPipeline.run /
                                          ShardedPipeline.run /
                                          FunnelPipeline.run_timed)
                                   |  on the worker's CUDA stream;
                                   |  one copy of the result to the host
                                   v
                          slice rows, fill cache, record stats
                                   v
                            per-request Future (numpy rows)

Endpoints register either a :class:`~repro_torch.core.pipeline.RetrievalPipeline`,
a :class:`~repro_torch.serving.sharded.ShardedPipeline` (K corpus shards
behind this one endpoint), a :class:`~repro_torch.serving.funnel.FunnelPipeline`,
a live corpus, or any batched runner ``fn(query_repr, q_tokens) -> result``.
Results delivered through futures are numpy (one row of the batched
output), bit-identical to an offline ``pipeline.run`` of the same batch —
verified in ``tests/test_torch_serving.py`` on the CPU and by
``chip_smoke.py``'s "serve full" phase on the card.

Execution backends are per endpoint: ``register_pipeline(...,
backend=...)`` rebinds the pipeline's candidate stage onto the named
:mod:`repro_torch.core.backends` path (reference / streaming / cuda
(also named ``pallas``) / auto), so the same corpus can be served behind
several endpoints that differ only in how they execute — the backend
identity shows up in stats snapshots and is part of the endpoint's cache
keys.  Corpus residency dtype is per endpoint the same way
(``corpus_dtype="bfloat16"``; scores stay f32).

Admission control is per endpoint: ``max_queue`` bounds the endpoint's
queue depth, ``overload`` picks the at-limit policy (``"block"`` —
backpressure the submitter, ``"reject"`` — raise
:class:`~repro_torch.serving.batcher.ServiceOverloaded`, ``"shed_oldest"``
— evict the stalest queued request).  Cache hits bypass the queue
entirely and are served even when the endpoint is saturated.

Nothing falls back: a batch whose kernel fails to build or launch fails
its futures with the error.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future
from typing import Any, Callable, Iterable, List, Optional

from repro_torch.core.backends import backend_identity
from repro_torch.serving.batcher import ContinuousBatcher, Request
from repro_torch.serving.cache import QueryCache
from repro_torch.serving.router import Router
from repro_torch.serving.spec import EndpointSpec
from repro_torch.serving.stats import ServiceSnapshot, ServingStats

__all__ = ["RetrievalService"]

# defaults of the legacy keyword registration surface: used to detect a
# kwarg passed alongside spec= (ambiguous — the spec carries every knob)
_KWARG_DEFAULTS = dict(batch_size=16, max_wait_s=0.01, jit=False,
                       max_queue=None, overload="block", backend=None,
                       corpus_dtype=None, profile=None, live=None,
                       budget=None, rerank_keep=None)


def _no_kwargs_alongside_spec(**kwargs):
    clashes = sorted(k for k, v in kwargs.items() if v != _KWARG_DEFAULTS[k])
    if clashes:
        raise ValueError(
            f"spec= carries every registration knob; also passing "
            f"{', '.join(clashes)} is ambiguous — set them on the "
            f"EndpointSpec (dataclasses.replace) instead")


def _pipeline_backend_label(pipeline) -> Optional[str]:
    """Execution-backend identity of a pipeline's generator stage (None
    when the pipeline has no backend seam — e.g. graph-ANN generators)."""
    label = backend_identity(getattr(pipeline, "backend", None))
    if label is not None:
        return label
    gens = getattr(pipeline, "generators", None)    # ShardedPipeline
    if gens is None:                                # funnel over sharded
        gens = getattr(getattr(pipeline, "generator", None),
                       "generators", None)
    if gens:
        ids = sorted({lbl for g in gens
                      if (lbl := backend_identity(getattr(g, "backend",
                                                          None))) is not None})
        if len(ids) == 1:
            return ids[0]
        if ids:
            return "mixed(" + ",".join(ids) + ")"
    return None


def _pipeline_corpus_dtype(pipeline) -> Optional[str]:
    """Corpus residency dtype behind a pipeline's generator stage (None
    when there is no dtype seam or per-shard generators disagree).

    A pipeline exposing ``corpus_dtype`` is trusted as-is — including a
    None that means "my shards disagree" (``ShardedPipeline`` already
    aggregates honestly).  The per-generator fallback, for duck-typed
    sharded pipelines, treats a seamless generator (dtype None) next to
    a typed one as *unknown*, never as the typed tier: claiming a
    uniform precision tier the endpoint doesn't have would poison stats
    attribution and cache keying."""
    if hasattr(pipeline, "corpus_dtype"):
        return pipeline.corpus_dtype
    gens = getattr(pipeline, "generators", None)    # duck-typed sharded
    if gens:
        dts = {getattr(g, "corpus_dtype", None) for g in gens}
        if len(dts) == 1 and (d := dts.pop()) is not None:
            return d
        if None not in dts and len(dts) > 1:
            return "mixed(" + ",".join(sorted(dts)) + ")"
    return None


class RetrievalService:
    """Multi-endpoint async retrieval with continuous batching + caching.

    ``cache_size=0`` disables the result cache entirely (every request
    goes through the funnel) — the bench's cache-off baseline."""

    def __init__(self, *, cache_size: int = 4096, cache_decimals: int = 6,
                 time_fn: Callable[[], float] = time.monotonic):
        self._time_fn = time_fn
        self.stats = ServingStats(time_fn=time_fn)
        self.cache = (QueryCache(cache_size, cache_decimals)
                      if cache_size > 0 else None)
        self.router = Router()
        # pipelines this service created itself (backend rebinds at
        # registration) and therefore must close: a rebound
        # ShardedPipeline owns a fresh host-parallel pool the caller
        # never sees
        self._owned_pipelines: List[Any] = []
        # endpoint name -> (LiveCorpus, served-generation reader) for
        # endpoints registered with register_pipeline(live=...): submit
        # stamps the current generation into cache keys, _on_result
        # re-keys to the generation the batch actually served
        self._live_endpoints: dict = {}
        self._closed = False

    # -- endpoint registration ----------------------------------------------
    def register_runner(
        self, name: str, run_fn: Callable[[Any, Optional[Any]], Any],
        pad_query_repr: Any, pad_q_tokens: Optional[Any] = None, *,
        spec: Optional[EndpointSpec] = None,
        batch_size: int = 16, max_wait_s: float = 0.01, jit: bool = False,
        max_queue: Optional[int] = None, overload: str = "block",
        backend: Optional[Any] = None, corpus_dtype: Optional[str] = None,
        profile: Optional[Any] = None,
    ) -> "RetrievalService":
        """``spec`` (an :class:`~repro_torch.serving.spec.EndpointSpec`)
        carries every registration knob as one validated value — the
        canonical surface.  The loose keywords below remain as a shim
        that builds the same spec.

        ``backend`` (a name, identity string, or ExecutionBackend
        instance) declares the execution path behind ``run_fn``;
        ``corpus_dtype`` declares its corpus residency dtype (the
        precision tier).  Both are surfaced in stats snapshots and keyed
        into this endpoint's cache entries.  For opaque runners they are
        labels only — the runner is not rewritten (use
        :meth:`register_pipeline` for that).

        ``profile`` (a :class:`~repro_torch.serving.autotune.TunedProfile`)
        binds the endpoint's batching/admission knobs — batch size,
        deadline, queue bound, overload policy — from an autotuned
        Pareto-front row in one shot, and declares the profile's backend
        identity and corpus dtype when no explicit labels are given.
        The profile's ``tag`` is surfaced in snapshots and folded into
        this endpoint's cache keys (provenance).  Note
        ``profile.config.cache_size`` is a *service*-level knob — pass
        it to the :class:`RetrievalService` constructor."""
        if spec is not None:
            _no_kwargs_alongside_spec(
                batch_size=batch_size, max_wait_s=max_wait_s, jit=jit,
                max_queue=max_queue, overload=overload, backend=backend,
                corpus_dtype=corpus_dtype, profile=profile)
        elif profile is not None:
            # historical register_runner asymmetry, kept: explicit
            # backend/corpus_dtype *labels* override the profile's
            # (the runner is opaque — nothing is rebound either way)
            overrides: dict = {"jit": jit}
            if backend is not None:
                overrides["backend"] = backend
            if corpus_dtype is not None:
                overrides["corpus_dtype"] = corpus_dtype
            spec = dataclasses.replace(profile.to_spec(), **overrides)
        else:
            spec = EndpointSpec.from_kwargs(
                batch_size=batch_size, max_wait_s=max_wait_s, jit=jit,
                max_queue=max_queue, overload=overload, backend=backend,
                corpus_dtype=corpus_dtype)
        if spec.live is not None:
            raise ValueError(
                "live endpoints register through register_pipeline: the "
                "service must own the snapshot-pinning run path")
        batcher = ContinuousBatcher(
            name, run_fn, pad_query_repr, pad_q_tokens,
            batch_size=spec.batch_size, max_wait_s=spec.max_wait_s,
            max_queue=spec.max_queue, overload=spec.overload,
            backend=backend_identity(spec.backend),
            corpus_dtype=spec.corpus_dtype,
            profile=None if spec.profile is None else spec.profile.tag,
            stats=self.stats, on_result=self._on_result,
            time_fn=self._time_fn)
        self.router.register(batcher)
        return self

    def register_pipeline(
        self, name: str, pipeline, pad_query_repr: Any,
        pad_q_tokens: Optional[Any] = None, *,
        spec: Optional[EndpointSpec] = None,
        batch_size: int = 16, max_wait_s: float = 0.01, jit: bool = False,
        max_queue: Optional[int] = None, overload: str = "block",
        backend: Optional[Any] = None, corpus_dtype: Optional[str] = None,
        profile: Optional[Any] = None, live: Optional[Any] = None,
        budget: Optional[Any] = None, rerank_keep: Optional[int] = None,
    ) -> "RetrievalService":
        """Serve a :class:`RetrievalPipeline`, a
        :class:`~repro_torch.serving.sharded.ShardedPipeline`, or a
        :class:`~repro_torch.serving.funnel.FunnelPipeline` (anything with a
        batched ``run(query_repr, q_tokens)``) as endpoint ``name``.

        ``spec`` (an :class:`~repro_torch.serving.spec.EndpointSpec`) is the
        canonical registration surface: every knob below, as one frozen
        validated value.  The loose keywords remain as a shim that
        builds the same spec (same mutual-exclusion rules).

        A funnel endpoint (the pipeline has ``run_timed``) additionally
        gets per-stage treatment: each batch's candgen/fusion/rerank
        stage is timed into the endpoint snapshot's ``stages`` summary,
        ``budget`` (a :class:`~repro_torch.serving.funnel.StageBudget`) and
        ``rerank_keep`` rebind the funnel's budgets and served width at
        registration, and the batcher hands the batch's queue wait to
        the funnel so the end-to-end budget can degrade the rerank stage
        (skip-and-serve-fused, counted as ``stage_fallbacks`` — never an
        error).

        ``backend`` selects the execution path for the pipeline's
        candidate stage (``"reference"`` / ``"streaming"`` / ``"cuda"``
        (or ``"pallas"``) / ``"auto"`` / an ExecutionBackend instance): the pipeline is
        rebound via ``with_backend`` before registration, so one corpus
        can be served as several endpoints differing only in backend.
        ``corpus_dtype`` rebinds the corpus residency dtype the same way
        (via ``with_corpus_dtype``, applied *before* backend resolution
        so capability checks see the dtype that will actually be
        scanned): ``corpus_dtype="bfloat16"`` serves the same funnel
        from a half-footprint corpus on the bounded-error precision tier.
        The resolved identity and dtype land in stats snapshots and
        cache keys.  A pipeline without the corresponding seam (no
        ``with_backend`` / ``with_corpus_dtype``) is rejected here — use
        :meth:`register_runner` for label-only declarations, so stats
        never claim a path that is not actually executing.

        ``profile`` (a :class:`~repro_torch.serving.autotune.TunedProfile`)
        rebinds backend, corpus dtype, batching and admission control
        from an autotuned Pareto-front row in one shot — mutually
        exclusive with explicit ``backend``/``corpus_dtype`` (a profile
        IS those choices; overriding half of one silently would serve a
        point nobody measured).  The pipeline's shard count must match
        the profile's genome for the same reason.  The profile tag lands
        in snapshots and cache keys; ``profile.config.cache_size`` is a
        service-level knob (the :class:`RetrievalService` constructor).

        ``live`` (a :class:`~repro_torch.serving.live.LiveCorpus`) serves a
        *mutable* corpus: pass ``pipeline=None`` to serve the live
        corpus's candidate stage directly, or a
        :class:`~repro_torch.core.pipeline.RetrievalPipeline` whose generator
        is a ``LiveGenerator`` over the same corpus for custom funnel
        depths.  Mutually exclusive with ``backend`` / ``corpus_dtype``
        / ``profile`` — the live corpus declares its own
        backends and dtype, and its run path is snapshot-pinning host
        code.  Every batch is pinned to one snapshot; the snapshot
        generation is length-framed into this endpoint's cache keys
        (stored under the generation that produced the result), so a
        mutation or compaction can never surface a stale hit.  Endpoint
        snapshots gain segment row counts, tombstones, compaction
        latency, and snapshot age."""
        if spec is not None:
            _no_kwargs_alongside_spec(
                batch_size=batch_size, max_wait_s=max_wait_s, jit=jit,
                max_queue=max_queue, overload=overload, backend=backend,
                corpus_dtype=corpus_dtype, profile=profile, live=live,
                budget=budget, rerank_keep=rerank_keep)
        else:
            spec = EndpointSpec.from_kwargs(
                batch_size=batch_size, max_wait_s=max_wait_s, jit=jit,
                max_queue=max_queue, overload=overload, backend=backend,
                corpus_dtype=corpus_dtype, profile=profile, live=live,
                budget=budget, rerank_keep=rerank_keep)
        if spec.live is not None:
            from repro_torch.core.pipeline import RetrievalPipeline
            from repro_torch.serving.live import LiveGenerator

            live = spec.live
            if pipeline is None:
                pipeline = RetrievalPipeline(generator=LiveGenerator(live))
            generator = getattr(pipeline, "generator", None)
            if not isinstance(generator, LiveGenerator) \
                    or generator.live is not live:
                raise ValueError(
                    "live= requires pipeline=None or a RetrievalPipeline "
                    "/ FunnelPipeline whose generator is a LiveGenerator "
                    "over the same LiveCorpus")
            pipeline, is_funnel = self._bind_funnel_knobs(pipeline, spec)
            run_fn = (self._funnel_run_fn(name, pipeline) if is_funnel
                      else pipeline.run)
            self.register_runner(
                name, run_fn, pad_query_repr, pad_q_tokens,
                spec=dataclasses.replace(
                    spec, live=None,
                    backend=backend_identity(live.main_backend),
                    corpus_dtype=live.corpus_dtype))
            self.stats.register_endpoint(name, live_fn=live.live_stats)
            self._live_endpoints[name] = (
                live, lambda: generator.last_served_generation)
            return self
        if spec.profile is not None:
            n_shards = getattr(pipeline, "n_shards", 1)
            if n_shards != spec.profile.config.n_shards:
                raise ValueError(
                    f"profile was tuned for n_shards="
                    f"{spec.profile.config.n_shards} but the pipeline has "
                    f"{n_shards} shard(s)")
        pipeline, is_funnel = self._bind_funnel_knobs(pipeline, spec)
        original = pipeline
        if spec.corpus_dtype is not None:
            if not hasattr(pipeline, "with_corpus_dtype"):
                raise TypeError(
                    f"pipeline {type(pipeline).__name__} does not take a "
                    "corpus residency dtype (no with_corpus_dtype); "
                    "register it via register_runner(corpus_dtype=...) if "
                    "you only want the label in stats/cache keys")
            pipeline = pipeline.with_corpus_dtype(spec.corpus_dtype)
        if spec.backend is not None:
            if not hasattr(pipeline, "with_backend"):
                raise TypeError(
                    f"pipeline {type(pipeline).__name__} does not take an "
                    "execution backend (no with_backend); register it via "
                    "register_runner(backend=...) if you only want the "
                    "label in stats/cache keys")
            intermediate = pipeline
            pipeline = pipeline.with_backend(spec.backend)
            # a dtype rebind of a sharded pipeline owns a worker pool the
            # backend rebind replaced: retire the intermediate now
            if intermediate is not original and hasattr(intermediate,
                                                        "close"):
                intermediate.close()
        if pipeline is not original and hasattr(pipeline, "close"):
            self._owned_pipelines.append(pipeline)
        label = _pipeline_backend_label(pipeline)
        if label is None:
            label = backend_identity(spec.backend)
        dtype_label = _pipeline_corpus_dtype(pipeline)
        if dtype_label is None:
            dtype_label = spec.corpus_dtype

        if is_funnel:
            run_fn = self._funnel_run_fn(name, pipeline)
        else:
            def run_fn(query_repr, q_tokens):
                return pipeline.run(query_repr, q_tokens)
        return self.register_runner(
            name, run_fn, pad_query_repr, pad_q_tokens,
            spec=dataclasses.replace(spec, backend=label,
                                     corpus_dtype=dtype_label))

    @staticmethod
    def _bind_funnel_knobs(pipeline, spec: EndpointSpec):
        """Apply the spec's funnel knobs (``rerank_keep`` width, stage
        ``budget``) to a :class:`~repro_torch.serving.funnel.FunnelPipeline`;
        returns ``(pipeline, is_funnel)``.  Non-funnel pipelines reject
        funnel knobs so a budget can never be silently inert."""
        is_funnel = hasattr(pipeline, "run_timed")
        if not is_funnel:
            if spec.budget is not None or spec.rerank_keep is not None:
                raise ValueError(
                    "budget= / rerank_keep= are funnel knobs: they apply "
                    "to FunnelPipeline endpoints (this pipeline has no "
                    "run_timed stage seam)")
            return pipeline, False
        if spec.rerank_keep is not None:
            pipeline = pipeline.with_rerank_keep(spec.rerank_keep)
        if spec.budget is not None:
            pipeline = pipeline.with_budget(spec.budget)
        return pipeline, True

    def _funnel_run_fn(self, name: str, funnel):
        """The batched runner for a funnel endpoint: runs the staged
        funnel and records per-stage seconds / fallbacks / overruns into
        this service's stats.  Marked ``budget_aware`` so the batcher
        hands over the batch's queue wait (``elapsed_s``) — budget
        enforcement starts at batch close, not at stage one."""
        stats = self.stats

        def run_fn(query_repr, q_tokens, *, elapsed_s: float = 0.0):
            out, trace = funnel.run_timed(query_repr, q_tokens,
                                          elapsed_s=elapsed_s)
            stats.record_stage(name, "candgen", trace.candgen_s,
                               overrun="candgen" in trace.overruns)
            if trace.fusion_s is not None:
                stats.record_stage(name, "fusion", trace.fusion_s,
                                   overrun="fusion" in trace.overruns)
            if trace.rerank_s is not None:
                stats.record_stage(name, "rerank", trace.rerank_s,
                                   overrun="rerank" in trace.overruns)
            elif trace.fallback:
                stats.record_stage(name, "rerank", None, fallback=True)
            return out

        run_fn.budget_aware = True
        return run_fn

    def endpoints(self):
        return self.router.endpoints()

    # -- request path --------------------------------------------------------
    def submit(self, query_repr: Any, q_tokens: Optional[Any] = None,
               endpoint: Optional[str] = None) -> Future:
        """Admit one query; returns a Future of its per-query result.

        On an endpoint with ``overload="reject"`` at its depth limit this
        raises :class:`~repro_torch.serving.batcher.ServiceOverloaded`
        synchronously (the rejection is counted in the endpoint's stats);
        with ``"shed_oldest"`` the evicted request's future fails with the
        same exception instead.  ``n_requests`` counts every admission
        attempt, served or rejected."""
        if self._closed:
            raise RuntimeError("service is closed")
        batcher = self.router.resolve(endpoint)
        t_admit = self._time_fn()
        self.stats.record_request(batcher.name)
        key = None
        live_entry = self._live_endpoints.get(batcher.name)
        generation = (live_entry[0].generation
                      if live_entry is not None else None)
        if self.cache is not None:
            key = self.cache.key(batcher.name, (query_repr, q_tokens),
                                 backend=batcher.backend,
                                 corpus_dtype=batcher.corpus_dtype,
                                 profile=batcher.profile,
                                 generation=generation)
            hit = self.cache.get(key)
            if hit is not None:
                self.stats.record_cache(True)
                fut: Future = Future()
                self.stats.record_e2e(batcher.name,
                                      self._time_fn() - t_admit)
                fut.set_result(hit)
                return fut
        fut = Future()
        self.router.dispatch(Request(
            query_repr=query_repr, q_tokens=q_tokens, endpoint=batcher.name,
            future=fut, t_admit=t_admit, cache_key=key,
            generation=generation))
        # counted only after dispatch succeeds: a rejected submit is not a
        # cache miss, so hit-rate keeps meaning "share of admitted requests
        # answered from cache" even under overload
        if self.cache is not None:
            self.stats.record_cache(False)
        return fut

    def submit_many(self, queries: Iterable[Any],
                    q_tokens: Optional[Iterable[Any]] = None,
                    endpoint: Optional[str] = None) -> List[Future]:
        qs = list(queries)
        ts = list(q_tokens) if q_tokens is not None else [None] * len(qs)
        return [self.submit(q, t, endpoint) for q, t in zip(qs, ts)]

    def retrieve(self, queries: Iterable[Any],
                 q_tokens: Optional[Iterable[Any]] = None,
                 endpoint: Optional[str] = None) -> List[Any]:
        """Blocking convenience: submit everything, wait, return results."""
        return [f.result() for f in
                self.submit_many(queries, q_tokens, endpoint)]

    def _on_result(self, request: Request, result: Any):
        if self.cache is not None and request.cache_key is not None:
            key = request.cache_key
            entry = self._live_endpoints.get(request.endpoint)
            if entry is not None:
                # Store under the generation that actually produced the
                # result: the batch may have closed after a mutation
                # landed between submit and execution.  The pinned
                # generation is read from the generator on this same
                # batcher worker thread, right after the batch ran, so
                # it cannot race a later batch.  Lookups always key the
                # *current* generation, so a hit is by construction a
                # result computed at the generation it claims.
                live, served_generation = entry
                served = served_generation()
                if served is not None and served != request.generation:
                    batcher = self.router.resolve(request.endpoint)
                    key = self.cache.key(
                        request.endpoint,
                        (request.query_repr, request.q_tokens),
                        backend=batcher.backend,
                        corpus_dtype=batcher.corpus_dtype,
                        profile=batcher.profile, generation=served)
            self.cache.put(key, result)

    # -- lifecycle / observability -------------------------------------------
    def snapshot(self) -> ServiceSnapshot:
        return self.stats.snapshot()

    def reset_stats(self):
        """Zero counters after warm-up so snapshots cover only real load."""
        self.stats.reset()

    def close(self):
        if not self._closed:
            self._closed = True
            self.router.close()
            # batcher workers are joined by now, so no in-flight batch
            # can still be using these
            for pipeline in self._owned_pipelines:
                pipeline.close()

    def __enter__(self) -> "RetrievalService":
        return self

    def __exit__(self, *exc):
        self.close()
