"""Per-stage serving instrumentation (counterpart of
``repro/serving/stats.py``).

Every stage of the serving funnel (admission queue wait, batch execution,
end-to-end request latency) records into a bounded reservoir; a
:meth:`ServingStats.snapshot` call freezes everything into plain
dataclasses with p50/p99/mean, batch-occupancy and close-reason counters,
cache hit-rate, and live queue depth — the numbers ``chip_smoke.py``'s
"serve full" phase reports per endpoint.

Overload observability: endpoints with a bounded admission queue also
report their depth limit and exact rejected/shed totals, so a dashboard
can tell "p99 is high because we're queueing" from "p99 is fine because
we're dropping load" — the e2e percentiles cover only *served* requests;
rejected/shed requests never reach the latency reservoirs.

Endpoints registered with an execution backend also surface its identity
string in snapshots, so a latency regression can be attributed to the
path (reference / streaming / cuda) actually serving the endpoint.

All recorders are thread-safe: requests are admitted from client threads
while batcher worker threads record execution.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np

__all__ = ["LatencySummary", "EndpointSnapshot", "ServiceSnapshot",
           "ServingStats"]

_RESERVOIR = 8192


@dataclasses.dataclass(frozen=True)
class LatencySummary:
    """Percentiles over the (bounded) most recent samples of one stage."""

    count: int = 0
    mean_ms: float = 0.0
    p50_ms: float = 0.0
    p99_ms: float = 0.0

    @staticmethod
    def from_samples(samples_s) -> "LatencySummary":
        if not samples_s:
            return LatencySummary()
        ms = 1e3 * np.asarray(samples_s, dtype=np.float64)
        return LatencySummary(
            count=int(ms.size),
            mean_ms=float(ms.mean()),
            p50_ms=float(np.percentile(ms, 50)),
            p99_ms=float(np.percentile(ms, 99)),
        )


@dataclasses.dataclass(frozen=True)
class EndpointSnapshot:
    name: str
    n_requests: int
    n_batches: int
    mean_batch_fill: float          # served slots / capacity, in [0, 1]
    closed_by_size: int
    closed_by_deadline: int
    closed_by_drain: int
    queue_depth: int                # live depth at snapshot time
    queue_wait: LatencySummary      # admission -> batch close
    execute: LatencySummary         # batch assembly + pipeline run
    e2e: LatencySummary             # admission -> result available
    # exact lifetime sums (the percentile reservoirs are bounded)
    queue_wait_total_s: float = 0.0
    execute_total_s: float = 0.0
    # admission control (exact lifetime counters)
    depth_limit: Optional[int] = None   # None = unbounded queue
    rejected: int = 0               # submits refused under policy "reject"
    shed: int = 0                   # queued requests evicted ("shed_oldest")
    # execution-backend identity serving this endpoint (None = opaque
    # runner / no backend declared at registration)
    backend: Optional[str] = None
    # corpus residency dtype behind this endpoint ("float32"/"bfloat16";
    # None = opaque runner / no dtype declared) — the precision tier a
    # latency or quality delta should be attributed to
    corpus_dtype: Optional[str] = None
    # tuned-profile tag when the endpoint was registered with
    # register_pipeline(profile=...) / register_runner(profile=...) —
    # provenance for every number above (None = hand-configured)
    profile: Optional[str] = None
    # process-wide warm-cache counters at snapshot time ({size, hits,
    # misses}): the tile auto-tune cache and the ANN index LRU.
    # Shared across endpoints (the caches are module-level), surfaced
    # here so the autotuner — and operators — can tell a warm
    # measurement from one paying cold builds/tuning sweeps.
    tile_cache: Optional[Dict[str, int]] = None
    ann_index_cache: Optional[Dict[str, int]] = None
    # live-corpus freshness (None on frozen endpoints): the snapshot
    # generation currently served, per-segment row counts
    # ({"main": ..., "append": ...}), resident tombstoned rows, lifetime
    # compaction count + latency percentiles, and how long ago the
    # served snapshot was swapped in — the numbers that tell "results
    # are fresh" from "the compactor is falling behind the write rate"
    generation: Optional[int] = None
    segment_rows: Optional[Dict[str, int]] = None
    tombstones: Optional[int] = None
    compactions: Optional[int] = None
    compaction: Optional[LatencySummary] = None
    snapshot_age_s: Optional[float] = None
    # staged-funnel observability (None on endpoints that don't record
    # stages): per-stage latency percentiles over batch executions
    # ({"candgen": ..., "fusion": ..., "rerank": ...}), exact lifetime
    # fallback counters (a stage was *skipped* under its budget — the
    # batch was served from the previous stage's output), exact lifetime
    # overrun counters (the stage ran but blew its soft deadline), and
    # per-stage batch occupancy — the fraction of batches that executed
    # the stage (a rerank occupancy of 0.7 with fallbacks covering the
    # other 0.3 is a funnel degrading under load, never silently)
    stages: Optional[Dict[str, LatencySummary]] = None
    stage_fallbacks: Optional[Dict[str, int]] = None
    stage_overruns: Optional[Dict[str, int]] = None
    stage_occupancy: Optional[Dict[str, float]] = None


@dataclasses.dataclass(frozen=True)
class ServiceSnapshot:
    endpoints: Dict[str, EndpointSnapshot]
    n_requests: int
    cache_hits: int
    cache_misses: int
    uptime_s: float

    @property
    def cache_hit_rate(self) -> float:
        n = self.cache_hits + self.cache_misses
        return self.cache_hits / n if n else 0.0

    @property
    def qps(self) -> float:
        return self.n_requests / self.uptime_s if self.uptime_s > 0 else 0.0


class _EndpointStats:
    def __init__(self, name: str):
        self.name = name
        self.n_requests = 0
        self.n_batches = 0
        self.fill_sum = 0.0
        self.closed_by = collections.Counter()
        self.queue_wait = collections.deque(maxlen=_RESERVOIR)
        self.execute = collections.deque(maxlen=_RESERVOIR)
        self.e2e = collections.deque(maxlen=_RESERVOIR)
        self.queue_wait_total_s = 0.0
        self.execute_total_s = 0.0
        self.overload = collections.Counter()   # "rejected" / "shed"
        # staged-funnel recorders, keyed by stage name ("candgen" /
        # "fusion" / "rerank"): latency reservoirs, exact execution /
        # fallback / overrun counters
        self.stage_lat: Dict[str, collections.deque] = {}
        self.stage_runs = collections.Counter()
        self.stage_fallbacks = collections.Counter()
        self.stage_overruns = collections.Counter()


class ServingStats:
    """Thread-safe recorder; ``snapshot()`` is the only read path."""

    def __init__(self, time_fn: Callable[[], float] = time.monotonic):
        self._lock = threading.Lock()
        self._time_fn = time_fn
        self._t0 = time_fn()
        self._endpoints: Dict[str, _EndpointStats] = {}
        self._depth_fns: Dict[str, Callable[[], int]] = {}
        self._depth_limits: Dict[str, int] = {}
        self._backends: Dict[str, str] = {}
        self._corpus_dtypes: Dict[str, str] = {}
        self._profiles: Dict[str, str] = {}
        self._live_fns: Dict[str, Callable[[], Dict]] = {}
        self.cache_hits = 0
        self.cache_misses = 0

    # -- wiring -------------------------------------------------------------
    def register_endpoint(self, name: str,
                          depth_fn: Optional[Callable[[], int]] = None,
                          depth_limit: Optional[int] = None,
                          backend: Optional[str] = None,
                          corpus_dtype: Optional[str] = None,
                          profile: Optional[str] = None,
                          live_fn: Optional[Callable[[], Dict]] = None):
        """``live_fn`` (``LiveCorpus.live_stats``) makes this endpoint
        report live-corpus freshness in its snapshots."""
        with self._lock:
            self._endpoints.setdefault(name, _EndpointStats(name))
            if depth_fn is not None:
                self._depth_fns[name] = depth_fn
            if depth_limit is not None:
                self._depth_limits[name] = depth_limit
            if backend is not None:
                self._backends[name] = backend
            if corpus_dtype is not None:
                self._corpus_dtypes[name] = corpus_dtype
            if profile is not None:
                self._profiles[name] = profile
            if live_fn is not None:
                self._live_fns[name] = live_fn

    def _ep(self, name: str) -> _EndpointStats:
        return self._endpoints.setdefault(name, _EndpointStats(name))

    def reset(self):
        """Zero all counters/reservoirs (e.g. after a warm-up phase) while
        keeping endpoint registrations and depth probes."""
        with self._lock:
            for name in self._endpoints:
                self._endpoints[name] = _EndpointStats(name)
            self.cache_hits = 0
            self.cache_misses = 0
            self._t0 = self._time_fn()

    # -- recorders ----------------------------------------------------------
    def record_request(self, endpoint: str):
        with self._lock:
            self._ep(endpoint).n_requests += 1

    def record_cache(self, hit: bool):
        with self._lock:
            if hit:
                self.cache_hits += 1
            else:
                self.cache_misses += 1

    def record_batch(self, endpoint: str, *, served: int, capacity: int,
                     closed_by: str, queue_waits_s, exec_s: float):
        with self._lock:
            ep = self._ep(endpoint)
            ep.n_batches += 1
            ep.fill_sum += served / capacity
            ep.closed_by[closed_by] += 1
            ep.queue_wait.extend(queue_waits_s)
            ep.execute.append(exec_s)
            ep.queue_wait_total_s += sum(queue_waits_s)
            ep.execute_total_s += exec_s

    def record_e2e(self, endpoint: str, seconds: float):
        with self._lock:
            self._ep(endpoint).e2e.append(seconds)

    def record_overload(self, endpoint: str, kind: str):
        """``kind`` is ``"rejected"`` or ``"shed"``."""
        with self._lock:
            self._ep(endpoint).overload[kind] += 1

    def record_stage(self, endpoint: str, stage: str,
                     seconds: Optional[float] = None, *,
                     fallback: bool = False, overrun: bool = False):
        """One funnel stage's outcome for one batch.  ``seconds`` set
        means the stage executed (latency sample + occupancy count);
        ``fallback`` means it was skipped under its budget and the batch
        was served from the previous stage's output; ``overrun`` means it
        ran but exceeded its soft deadline.  Called from batcher worker
        threads via the funnel run wrapper."""
        with self._lock:
            ep = self._ep(endpoint)
            if seconds is not None:
                ep.stage_lat.setdefault(
                    stage, collections.deque(maxlen=_RESERVOIR)
                ).append(seconds)
                ep.stage_runs[stage] += 1
            if fallback:
                ep.stage_fallbacks[stage] += 1
            if overrun:
                ep.stage_overruns[stage] += 1

    # -- read path ----------------------------------------------------------
    def snapshot(self) -> ServiceSnapshot:
        # outside the lock: the warm-cache counters have their own locks,
        # and backends is a lazy import so stats stays numpy-only until a
        # snapshot is actually taken
        from repro_torch.core.backends import (ann_index_cache_info,
                                              tile_cache_info)

        tile_cache = tile_cache_info()
        ann_cache = ann_index_cache_info()
        # live-corpus probes outside the stats lock too: they read the
        # corpus's atomically-swapped snapshot, no lock ordering to trip
        live_now = {name: fn() for name, fn in list(self._live_fns.items())}
        with self._lock:
            endpoints = {}
            total = 0
            for name, ep in self._endpoints.items():
                depth = self._depth_fns.get(name, lambda: 0)()
                live = live_now.get(name, {})
                staged = bool(ep.stage_lat or ep.stage_fallbacks
                              or ep.stage_overruns)
                stage_names = (set(ep.stage_lat) | set(ep.stage_runs)
                               | set(ep.stage_fallbacks)
                               | set(ep.stage_overruns))
                endpoints[name] = EndpointSnapshot(
                    name=name,
                    n_requests=ep.n_requests,
                    n_batches=ep.n_batches,
                    mean_batch_fill=(ep.fill_sum / ep.n_batches
                                     if ep.n_batches else 0.0),
                    closed_by_size=ep.closed_by["size"],
                    closed_by_deadline=ep.closed_by["deadline"],
                    closed_by_drain=ep.closed_by["drain"],
                    queue_depth=depth,
                    queue_wait=LatencySummary.from_samples(ep.queue_wait),
                    execute=LatencySummary.from_samples(ep.execute),
                    e2e=LatencySummary.from_samples(ep.e2e),
                    queue_wait_total_s=ep.queue_wait_total_s,
                    execute_total_s=ep.execute_total_s,
                    depth_limit=self._depth_limits.get(name),
                    rejected=ep.overload["rejected"],
                    shed=ep.overload["shed"],
                    backend=self._backends.get(name),
                    corpus_dtype=self._corpus_dtypes.get(name),
                    profile=self._profiles.get(name),
                    tile_cache=tile_cache,
                    ann_index_cache=ann_cache,
                    generation=live.get("generation"),
                    segment_rows=live.get("segment_rows"),
                    tombstones=live.get("tombstones"),
                    compactions=live.get("compactions"),
                    compaction=(LatencySummary.from_samples(
                        live["compaction_s"])
                        if "compaction_s" in live else None),
                    snapshot_age_s=live.get("snapshot_age_s"),
                    stages=({s: LatencySummary.from_samples(d)
                             for s, d in ep.stage_lat.items()}
                            if staged else None),
                    stage_fallbacks=({s: ep.stage_fallbacks[s]
                                      for s in stage_names}
                                     if staged else None),
                    stage_overruns=({s: ep.stage_overruns[s]
                                     for s in stage_names}
                                    if staged else None),
                    stage_occupancy=({s: (ep.stage_runs[s] / ep.n_batches
                                          if ep.n_batches else 0.0)
                                      for s in stage_names}
                                     if staged else None),
                )
                total += ep.n_requests
            return ServiceSnapshot(
                endpoints=endpoints,
                n_requests=total,
                cache_hits=self.cache_hits,
                cache_misses=self.cache_misses,
                uptime_s=self._time_fn() - self._t0,
            )
