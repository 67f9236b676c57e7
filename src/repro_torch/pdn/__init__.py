"""PDN topology and telemetry inputs (host-side numpy)."""

from repro_torch.pdn.telemetry import TelemetrySim, TraceConfig
from repro_torch.pdn.tenants import (
    TenantLayout,
    appendix_b_layout,
    assign_cross_domain_tenants,
    assign_tenants,
)
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
    "TenantLayout",
    "TraceConfig",
    "appendix_b_layout",
    "assign_cross_domain_tenants",
    "assign_tenants",
    "build_datacenter",
    "build_from_level_sizes",
    "check_caps_fund_minimums",
    "flatten",
]
