"""Serving layer: throughput-oriented inference over arbitrary request
streams — shape bucketing, dynamic micro-batching, a replica pool,
warmup, serving observability, and the HTTP front door
(``waternet_tpu_torch.serving.server``, imported explicitly, not
re-exported, so library users of the batcher never touch the gateway).
The port of the JAX package's ``serving/`` (docs/SERVING.md); its stream
sessions and fleet router are ROADMAP Queue A item 6's next part.
"""

from waternet_tpu_torch.serving.batcher import (
    DeadlineExpired,
    DynamicBatcher,
    ExactShapeBatcher,
    QueueFull,
    RequestCancelled,
    UnknownTier,
    fit_ladder_to_engine,
    resolve_ladder,
)
from waternet_tpu_torch.serving.bucketing import (
    RECEPTIVE_RADIUS,
    BucketLadder,
    derive_buckets,
    pad_to_bucket,
    padding_overhead,
    parse_buckets,
    scan_shapes,
)
from waternet_tpu_torch.serving.replicas import (
    ReplicaPool,
    ReplicaUnavailable,
    SupervisionConfig,
    engine_jit_cache_size,
    resolve_replicas,
)
from waternet_tpu_torch.serving.stats import ServingStats
from waternet_tpu_torch.serving.warmup import warmup

__all__ = [
    "RECEPTIVE_RADIUS",
    "BucketLadder",
    "DeadlineExpired",
    "DynamicBatcher",
    "ExactShapeBatcher",
    "QueueFull",
    "ReplicaPool",
    "ReplicaUnavailable",
    "RequestCancelled",
    "ServingStats",
    "SupervisionConfig",
    "UnknownTier",
    "derive_buckets",
    "engine_jit_cache_size",
    "fit_ladder_to_engine",
    "pad_to_bucket",
    "padding_overhead",
    "parse_buckets",
    "resolve_ladder",
    "resolve_replicas",
    "scan_shapes",
    "warmup",
]
