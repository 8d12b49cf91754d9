"""Endpoint router: request -> the right pipeline's batcher (counterpart
of ``repro/serving/router.py``).

The paper's three spaces (dense, sparse, fused) become live endpoints of
one service; each endpoint owns a :class:`ContinuousBatcher` with its own
batch-size / deadline / admission-control knobs, so a cheap sparse lookup
and an expensive fused funnel never share a batch (or a queue limit).

A sharded corpus is invisible here: a ``ShardedPipeline`` registers as
one ordinary endpoint, so routing, caching, and stats never learn how
many shards sit behind it.
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch.serving.batcher import ContinuousBatcher, Request

__all__ = ["Router"]


class Router:
    def __init__(self):
        self._batchers: Dict[str, ContinuousBatcher] = {}

    def register(self, batcher: ContinuousBatcher):
        if batcher.name in self._batchers:
            raise ValueError(f"endpoint {batcher.name!r} already registered")
        self._batchers[batcher.name] = batcher

    def endpoints(self):
        return tuple(self._batchers)

    def resolve(self, endpoint: Optional[str]) -> ContinuousBatcher:
        """``None`` resolves to the sole endpoint when only one exists."""
        if endpoint is None:
            if len(self._batchers) == 1:
                return next(iter(self._batchers.values()))
            raise ValueError(
                f"endpoint required: service has {sorted(self._batchers)}")
        try:
            return self._batchers[endpoint]
        except KeyError:
            raise KeyError(
                f"unknown endpoint {endpoint!r}; "
                f"registered: {sorted(self._batchers)}") from None

    def dispatch(self, request: Request):
        self.resolve(request.endpoint).submit(request)

    def close(self):
        for b in self._batchers.values():
            b.close()
