"""Logical-axis sharding rules for the model zoo (port of
``repro/sharding``)."""

from repro_torch.sharding.rules import (
    NamedSharding,
    PartitionSpec,
    ShardingRules,
    cache_shardings,
    constrain,
    current_context,
    param_shardings,
    sharding_context,
)

__all__ = [
    "NamedSharding", "PartitionSpec", "ShardingRules", "cache_shardings",
    "constrain", "param_shardings", "sharding_context", "current_context",
]
