"""Matrix-free primal-dual solver (PDHG / PDLP-lite) for nvPAX programs.

A Chambolle-Pock primal-dual iteration whose only non-elementwise work is
the structured constraint matvec of :mod:`repro_torch.core.treeops` (cumsum
+ gathers + segment sums), or its CUDA kernels under
``SolverOptions(use_pallas_tree=True)``.

* :mod:`~repro_torch.core.solver.options` — :class:`SolverOptions` /
  :class:`SolverState` / :class:`SolveStats`;
* :mod:`~repro_torch.core.solver.scaling` — metric scaling, pinned-column
  fold-out and the diagonal Pock-Chambolle step sizes;
* :mod:`~repro_torch.core.solver.restarts` — PDLP-style adaptive restarts
  and primal-weight re-estimation;
* :mod:`~repro_torch.core.solver.termination` — KKT residuals and the
  no-progress/optimal-vertex certificate;
* :mod:`~repro_torch.core.solver.loop` — the chunked solve loop;
* :mod:`~repro_torch.core.solver.certify` — the certify-first pass of
  incremental stepping (the carried solution checked before a solve).
"""

from repro_torch.core.solver.certify import (
    CertifyDecision,
    IncrementalCarry,
    certify_step,
    make_carry,
    update_carry,
)
from repro_torch.core.solver.loop import solve
from repro_torch.core.solver.options import (
    KKT_HIST_BUCKETS,
    KKT_HIST_LO_EXP,
    SolveStats,
    SolverOptions,
    SolverState,
)
from repro_torch.core.solver.scaling import (
    Scales,
    StepSizes,
    estimate_norm,
    make_scales,
    pc_step_sizes,
    uniform_step_sizes,
)
from repro_torch.core.solver.termination import kkt_residuals, polish_t, primal_residual

__all__ = [
    "KKT_HIST_BUCKETS",
    "KKT_HIST_LO_EXP",
    "SolverOptions",
    "SolverState",
    "SolveStats",
    "solve",
    "kkt_residuals",
    "primal_residual",
    "polish_t",
    "IncrementalCarry",
    "CertifyDecision",
    "certify_step",
    "make_carry",
    "update_carry",
    "Scales",
    "StepSizes",
    "make_scales",
    "pc_step_sizes",
    "uniform_step_sizes",
    "estimate_norm",
]
