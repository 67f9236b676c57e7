"""nvPAX core: the paper's allocator in PyTorch."""

from repro_torch.core.nvpax import AllocResult, NvpaxOptions, optimize
from repro_torch.core.problem import AllocProblem, FleetTopology, StepProblem
from repro_torch.core.solver import SolveStats, SolverOptions, SolverState
from repro_torch.core.treeops import SlaTopo, TreeTopo
from repro_torch.core.waterfill import waterfill_arrays

__all__ = [
    "AllocProblem",
    "AllocResult",
    "FleetTopology",
    "NvpaxOptions",
    "SlaTopo",
    "SolveStats",
    "SolverOptions",
    "SolverState",
    "StepProblem",
    "TreeTopo",
    "optimize",
    "waterfill_arrays",
]
