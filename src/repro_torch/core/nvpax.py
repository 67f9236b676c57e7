"""nvPAX — Algorithm 3: the full three-phase power allocation policy.

``optimize()`` is the entry point a closed-loop power controller calls every
control step.  It is deterministic, always returns a feasible allocation
(exact repair, see :func:`repro_torch.core.phases.repair`), and supports warm
starting across control steps through :class:`~repro_torch.core.phases.WarmCarry`.
It runs on the device of the problem's tensors (see
``AllocProblem.build(..., device=)``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.core import phases
from repro_torch.core import solver as solver_mod
from repro_torch.core.problem import AllocProblem
from repro_torch.obs.stats import StepStats

__all__ = ["AllocResult", "NvpaxOptions", "optimize"]


@dataclass(frozen=True)
class NvpaxOptions:
    eps: float = 1e-5  # paper's regularization weight
    solver: solver_mod.SolverOptions = field(default_factory=solver_mod.SolverOptions)
    run_phase2: bool = True
    run_phase3: bool = True
    max_rounds: int = phases.MAX_ROUNDS
    # exact water-filling fast path for the max-min phases on SLA-free
    # problems (beyond-paper optimization; equals the iterated-LP limit)
    use_waterfill: bool = True
    # Anytime / deadline-aware mode: every phase boundary is a valid,
    # feasible allocation, so when the elapsed wall time exceeds the
    # deadline the remaining refinement phases (II: active surplus, III:
    # idle surplus) are skipped and the best-so-far allocation is returned
    # with stats["truncated"]=True.  Phase I always runs.
    deadline_s: float | None = None
    # Incremental re-solve (certify the carried solution first) is not
    # ported yet: ``incremental=True`` raises NotImplementedError.
    incremental: bool = False


@dataclass
class AllocResult:
    allocation: np.ndarray  # [n] final feasible allocation (phase III output)
    phase1: np.ndarray
    phase2: np.ndarray
    warm_state: Any  # phases.WarmCarry for the next control step
    wall_time_s: float
    stats: dict[str, Any]


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def optimize(
    ap: AllocProblem,
    options: NvpaxOptions = NvpaxOptions(),
    warm: phases.WarmCarry | None = None,
) -> AllocResult:
    """Run Algorithm 3 on one control step's problem.

    ``warm`` is the per-phase carry returned as ``AllocResult.warm_state``
    by the previous control step; it is an optimization, not a correctness
    dependency — warm and cold steps agree to solver tolerance.  The solve
    runs in the problem's dtype: ``AllocProblem.build(..., dtype=)``, where
    ``repro_torch.compat.float_dtype(x64)`` gives the reference's choice.
    """
    if options.incremental:
        raise NotImplementedError(
            "incremental=True (certify-first stepping) is not ported yet "
            "(ROADMAP Queue 1 item 9)"
        )
    t0 = time.perf_counter()

    def in_budget() -> bool:
        return options.deadline_s is None or time.perf_counter() - t0 < options.deadline_s

    truncated = False
    x1, state, s1 = phases.phase1(
        ap, options.solver, options.eps, warm.p1 if warm else None
    )
    carry1 = state
    x2 = x1
    s2 = phases.PhaseStats(0, 0, True, 0.0)
    state = phases.merge_warm(state, warm.p2 if warm else None)
    if options.run_phase2 and in_budget():
        x2, state, s2 = phases.run_maxmin_phase(
            ap, x1, ap.active, ap.idle, options.solver, options.eps, state,
            options.max_rounds, use_waterfill=options.use_waterfill,
        )
    elif options.run_phase2:
        truncated = True
    carry2 = state
    x3 = x2
    s3 = phases.PhaseStats(0, 0, True, 0.0)
    state = phases.merge_warm(state, warm.p3 if warm else None)
    if options.run_phase3 and in_budget():
        empty = torch.zeros_like(ap.active)
        x3, state, s3 = phases.run_maxmin_phase(
            ap, x2, ap.idle, empty, options.solver, options.eps, state,
            options.max_rounds, use_waterfill=options.use_waterfill,
        )
    elif options.run_phase3:
        truncated = True
    carry3 = state
    allocation = _host(x3)  # waits for the device
    wall = time.perf_counter() - t0
    return AllocResult(
        allocation=allocation,
        phase1=_host(x1),
        phase2=_host(x2),
        warm_state=phases.WarmCarry(carry1, carry2, carry3),
        wall_time_s=wall,
        stats=StepStats.build(
            solves=s1.solves + s2.solves + s3.solves,
            iterations=s1.iterations + s2.iterations + s3.iterations,
            phase_iterations=[s1.iterations, s2.iterations, s3.iterations],
            converged=s1.converged and s2.converged and s3.converged,
            skipped=False,
            certify_pass=False,
            kkt_certified=s1.kkt_certified and s2.kkt_certified and s3.kkt_certified,
            truncated=truncated,
            phase1=s1._asdict(),
            phase2=s2._asdict(),
            phase3=s3._asdict(),
        ),
    )
