"""Serving front end over the plan/execute engine.

``AnalyticsService`` is the single-engine core; the mesh-scale layer
(``DistributedAnalyticsService``, serve/distributed.py) runs one of it
per replica group of the planner's ``MeshLayout``."""

from repro_torch.serve.distributed import (
    DistributedAnalyticsService,
    HashRing,
    sharded_engine_factory,
)
from repro_torch.serve.service import (
    AnalyticsService,
    ServiceOverloaded,
    ServiceStats,
)

__all__ = [
    "AnalyticsService",
    "DistributedAnalyticsService",
    "HashRing",
    "ServiceOverloaded",
    "ServiceStats",
    "sharded_engine_factory",
]
