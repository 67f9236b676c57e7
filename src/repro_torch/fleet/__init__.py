"""repro_torch.fleet — multi-domain fleet orchestration.

The fleet layer shards the monolithic allocator into per-power-domain
engines coordinated by an inter-domain budget planner:

* :mod:`repro_torch.fleet.partition` — cut the PDN tree at a level into K
  independent domains + the coordinator tree above the cut;
* :mod:`repro_torch.fleet.coordinator` — rebalance the global supply across
  domains between steps (waterfill over the coordinator tree);
* :mod:`repro_torch.fleet.orchestrator` — per-domain engines served as K
  lanes of one solve, each over its own domain's topology (``stacked``), an
  engine loop (``loop``), or the stacked lanes split over the ranks of a
  process group (``sharded``), with per-domain warm carry;
* :mod:`repro_torch.fleet.sharded` — the sharded step: one all-reduce of
  the domains' demand, the coordinator plan replicated on every rank, one
  all-gather of the result;
* :mod:`repro_torch.fleet.lifecycle` — churn-tolerant re-pins (device
  join/leave, supply derating) and double-buffered telemetry ingestion.
"""

from repro_torch.fleet.coordinator import BudgetCoordinator, split_entitlements
from repro_torch.fleet.lifecycle import FleetLifecycle, TelemetryDoubleBuffer
from repro_torch.fleet.orchestrator import FleetOrchestrator, FleetStepResult
from repro_torch.fleet.partition import (
    DomainSpec,
    FleetPartition,
    FleetSla,
    build_fleet_sla,
    split_pdn,
)

__all__ = [
    "BudgetCoordinator",
    "DomainSpec",
    "FleetLifecycle",
    "FleetOrchestrator",
    "FleetPartition",
    "FleetSla",
    "FleetStepResult",
    "TelemetryDoubleBuffer",
    "build_fleet_sla",
    "split_entitlements",
    "split_pdn",
]
