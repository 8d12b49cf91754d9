"""Serving layer of the port (counterpart of ``repro/serving``): bounded
admission queue -> continuous batcher (one CUDA stream per endpoint) ->
(optionally sharded or staged) pipeline -> cache -> stats.  The
autotuner's genome and tuned profiles are ported; its search half
(``autotune``, ``measure_config``, ``pareto_front``, ``proxy_objectives``,
``roofline_prune``) is still to come."""

from repro_torch.serving.autotune import (MeasuredPoint, ServingConfig,
                                          TunedProfile, check_config)
from repro_torch.serving.batcher import (OVERLOAD_POLICIES, ContinuousBatcher,
                                         Request, ServiceOverloaded)
from repro_torch.serving.cache import QueryCache, quantized_key
from repro_torch.serving.funnel import (FUNNEL_STAGES, FunnelPipeline, StageBudget,
                                        StageTrace)
from repro_torch.serving.live import LiveCorpus, LiveGenerator, SnapshotGenerator
from repro_torch.serving.router import Router
from repro_torch.serving.service import RetrievalService
from repro_torch.serving.sharded import CorpusShard, ShardedPipeline, shard_corpus
from repro_torch.serving.spec import EndpointSpec
from repro_torch.serving.stats import (EndpointSnapshot, LatencySummary,
                                       ServiceSnapshot, ServingStats)

__all__ = [
    "ContinuousBatcher",
    "EndpointSpec",
    "FunnelPipeline",
    "FUNNEL_STAGES",
    "StageBudget",
    "StageTrace",
    "Request",
    "ServiceOverloaded",
    "OVERLOAD_POLICIES",
    "QueryCache",
    "quantized_key",
    "LiveCorpus",
    "LiveGenerator",
    "SnapshotGenerator",
    "Router",
    "RetrievalService",
    "CorpusShard",
    "ShardedPipeline",
    "shard_corpus",
    "ServingStats",
    "ServiceSnapshot",
    "EndpointSnapshot",
    "LatencySummary",
    "ServingConfig",
    "TunedProfile",
    "MeasuredPoint",
    "check_config",
]
