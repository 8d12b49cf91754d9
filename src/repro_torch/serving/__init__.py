"""Serving layer of the port (counterpart of ``repro/serving``).  Ported
so far: the query-result cache and live corpora; the batcher, router,
service, sharding, funnel and autotuner are still to come."""

from repro_torch.serving.cache import QueryCache, quantized_key
from repro_torch.serving.live import LiveCorpus, LiveGenerator, SnapshotGenerator

__all__ = [
    "QueryCache",
    "quantized_key",
    "LiveCorpus",
    "LiveGenerator",
    "SnapshotGenerator",
]
