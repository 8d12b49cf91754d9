"""Batched retrieval serving entry point — DEPRECATED COMPAT SHIM (counterpart
of ``repro/launch/serve.py``).

The real serving subsystem lives in :mod:`repro_torch.serving`
(admission queue -> continuous batcher -> pipeline -> cache -> stats).
This module keeps the original
``BatchingServer`` / ``ServeStats`` surface for existing callers: a
synchronous ``serve(queries)`` loop backed by a single-endpoint
:class:`~repro_torch.serving.RetrievalService` with the result cache disabled
(the old server had none).

Deprecated: construct a :class:`~repro_torch.serving.RetrievalService`
and register endpoints with an :class:`~repro_torch.serving.EndpointSpec`
instead —
that surface carries every knob this shim hides (admission control,
caching, profiles, funnel budgets) and serves multiple endpoints.
Instantiating :class:`BatchingServer` emits a ``DeprecationWarning``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Sequence

from repro_torch.serving import EndpointSpec, RetrievalService

__all__ = ["ServeStats", "BatchingServer"]


@dataclasses.dataclass
class ServeStats:
    n_requests: int = 0
    n_batches: int = 0
    total_wait_s: float = 0.0
    total_exec_s: float = 0.0

    @property
    def mean_latency_ms(self) -> float:
        if not self.n_batches:
            return 0.0
        return 1e3 * (self.total_wait_s + self.total_exec_s) / self.n_batches


class BatchingServer:
    """Wraps a batched ``fn(batch_queries) -> TopK`` with request batching.

    ``pad_query`` produces the padding query (scored but discarded).
    ``window_s`` is the continuous-batching deadline (the batch closes
    early when it fills).  ``backend`` optionally declares the execution
    backend behind ``fn`` (a :mod:`repro_torch.core.backends` name or
    instance) so it shows up in the underlying service's stats."""

    def __init__(self, fn: Callable, batch_size: int, pad_query,
                 window_s: float = 0.005, backend=None):
        warnings.warn(
            "launch.serve.BatchingServer is deprecated: register the "
            "runner on a repro_torch.serving.RetrievalService with an "
            "EndpointSpec (register_runner(..., spec=EndpointSpec(...)))",
            DeprecationWarning, stacklevel=2)
        self.fn = fn
        self.batch_size = batch_size
        self.pad_query = pad_query
        self.window_s = window_s
        self.stats = ServeStats()
        self._service = RetrievalService(cache_size=0)
        self._service.register_runner(
            "default", lambda batch, _tokens: fn(batch),
            pad_query_repr=pad_query,
            spec=EndpointSpec(batch_size=batch_size, max_wait_s=window_s,
                              backend=backend))

    def serve(self, queries: Sequence):
        """Serve a stream of single queries; returns per-query results."""
        futures = self._service.submit_many(queries, endpoint="default")
        out = [f.result() for f in futures]
        ep = self._service.snapshot().endpoints["default"]
        self.stats.n_requests = ep.n_requests
        self.stats.n_batches = ep.n_batches
        # per-batch wait = mean per-request queue wait (batch assembly
        # window); keeps mean_latency_ms ~ one request's life like before
        if ep.n_requests:
            self.stats.total_wait_s = (ep.queue_wait_total_s / ep.n_requests
                                       * ep.n_batches)
        self.stats.total_exec_s = ep.execute_total_s
        return out

    def close(self):
        self._service.close()

    # the pre-async BatchingServer needed no lifecycle management; keep
    # that contract for old callers by reaping the worker thread on GC
    def __del__(self):
        try:
            self.close()
        except Exception:       # noqa: BLE001 — interpreter teardown
            pass

    def __enter__(self) -> "BatchingServer":
        return self

    def __exit__(self, *exc):
        self.close()
