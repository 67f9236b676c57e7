"""PDN topology and telemetry inputs (host-side numpy)."""

from repro_torch.pdn.telemetry import TelemetrySim, TraceConfig
from repro_torch.pdn.tree import (
    FlatPDN,
    PDNNode,
    build_datacenter,
    build_from_level_sizes,
    check_caps_fund_minimums,
    flatten,
)

__all__ = [
    "FlatPDN",
    "PDNNode",
    "TelemetrySim",
    "TraceConfig",
    "build_datacenter",
    "build_from_level_sizes",
    "check_caps_fund_minimums",
    "flatten",
]
