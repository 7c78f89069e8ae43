"""Serving front end over the plan/execute engine.

``AnalyticsService`` is the single-engine core.  The mesh-scale layer of
the reference (``DistributedAnalyticsService``, ``HashRing``) is
multi-GPU work, ROADMAP 1.7."""

from repro_torch.serve.service import (
    AnalyticsService,
    ServiceOverloaded,
    ServiceStats,
)

__all__ = ["AnalyticsService", "ServiceOverloaded", "ServiceStats"]
