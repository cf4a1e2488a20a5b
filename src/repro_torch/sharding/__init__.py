"""Logical-axis -> mesh sharding rules (DP/TP/EP/SP + pod axis), as
DTensor placements on a ``DeviceMesh``."""

from .ctx import activation_sharding, shard
from .rules import (
    FSDP_TP_RULES,
    PRESETS,
    SP_SERVE_RULES,
    TP_DP_RULES,
    ShardingRules,
    batch_axes_tree,
    resolve_spec,
    state_axes_tree,
    tree_shardings,
)

__all__ = [
    "activation_sharding",
    "shard",
    "FSDP_TP_RULES",
    "PRESETS",
    "SP_SERVE_RULES",
    "TP_DP_RULES",
    "ShardingRules",
    "batch_axes_tree",
    "resolve_spec",
    "state_axes_tree",
    "tree_shardings",
]
