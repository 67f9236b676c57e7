"""nvPAX core: the paper's allocator in PyTorch."""

from repro_torch.core.batched import (
    BatchedAllocResult,
    PhaseCostModel,
    calibrate_iter_cost,
    calibrate_phase_cost,
    optimize_batched,
    stack_problems,
)
from repro_torch.core.greedy import greedy_allocate, static_allocate
from repro_torch.core.nvpax import AllocResult, NvpaxOptions, optimize
from repro_torch.core.problem import AllocProblem, FleetTopology, StepProblem
from repro_torch.core.solver import SolveStats, SolverOptions, SolverState
from repro_torch.core.treeops import SlaTopo, TreeTopo
from repro_torch.core.waterfill import waterfill_arrays

__all__ = [
    "AllocProblem",
    "AllocResult",
    "BatchedAllocResult",
    "PhaseCostModel",
    "calibrate_iter_cost",
    "calibrate_phase_cost",
    "optimize_batched",
    "stack_problems",
    "FleetTopology",
    "NvpaxOptions",
    "SlaTopo",
    "SolveStats",
    "SolverOptions",
    "SolverState",
    "StepProblem",
    "TreeTopo",
    "greedy_allocate",
    "optimize",
    "static_allocate",
    "waterfill_arrays",
]
