from repro_torch.distributed.sharding import (
    AxisRules,
    axis_rules,
    current_rules,
    logical_to_pspec,
    shard_as,
    spec_tree_to_shardings,
)

__all__ = [
    "AxisRules",
    "axis_rules",
    "current_rules",
    "logical_to_pspec",
    "shard_as",
    "spec_tree_to_shardings",
]
