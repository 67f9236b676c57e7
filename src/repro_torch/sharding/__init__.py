"""Logical-axis sharding on a DeviceMesh (the port's ``repro/sharding``)."""

from repro_torch.sharding.logical import (
    AxisRules,
    NamedSharding,
    P,
    constrain,
    current_rules,
    default_rules,
    distribute_params,
    gather_params,
    is_distributed,
    param_sharding,
    placements,
    resolve_spec,
    split_heads,
    use_rules,
)

__all__ = [
    "AxisRules",
    "NamedSharding",
    "P",
    "constrain",
    "current_rules",
    "default_rules",
    "distribute_params",
    "gather_params",
    "is_distributed",
    "param_sharding",
    "placements",
    "resolve_spec",
    "split_heads",
    "use_rules",
]
