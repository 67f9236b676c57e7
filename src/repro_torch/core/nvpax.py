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
    # Incremental re-solve: certify the carried solution against the new
    # step before solving (see repro_torch.core.solver.certify).  When
    # enabled, callers thread ``AllocResult.carry`` back in and get
    # stats["skipped"]/stats["certify_pass"] on every path.  ``certify_tol``
    # is the "unchanged" comparison tolerance in watts; ``certify_margin``
    # is the slack margin below which a demand/cap move forces a full solve.
    incremental: bool = False
    certify_tol: float = 1e-9
    certify_margin: float = 1e-2


@dataclass
class AllocResult:
    allocation: np.ndarray  # [n] final feasible allocation (phase III output)
    phase1: np.ndarray
    phase2: np.ndarray
    warm_state: Any  # phases.WarmCarry for the next control step
    wall_time_s: float
    stats: dict[str, Any]
    # incremental-mode anchor for the next step's certify pass (None unless
    # options.incremental; see repro_torch.core.solver.certify.IncrementalCarry)
    carry: Any = None


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def optimize(
    ap: AllocProblem,
    options: NvpaxOptions = NvpaxOptions(),
    warm: phases.WarmCarry | None = None,
    carry: Any = None,
) -> AllocResult:
    """Run Algorithm 3 on one control step's problem.

    ``warm`` is the per-phase carry returned as ``AllocResult.warm_state``
    by the previous control step; it is an optimization, not a correctness
    dependency — warm and cold steps agree to solver tolerance.  The solve
    runs in the problem's dtype: ``AllocProblem.build(..., dtype=)``, where
    ``repro_torch.compat.float_dtype(x64)`` gives the reference's choice.

    ``carry`` (with ``options.incremental``) is the previous step's
    :class:`~repro_torch.core.solver.certify.IncrementalCarry` anchor: the
    carried solution is certified against the new step first, and on success
    the solve is skipped entirely (``stats["skipped"]``) or restarted after
    Phase I (``stats["certify_pass"]``).
    """
    t0 = time.perf_counter()

    def in_budget() -> bool:
        return options.deadline_s is None or time.perf_counter() - t0 < options.deadline_s

    truncated = False
    skipped = p1_reused = False
    if options.incremental and carry is not None:
        dec = solver_mod.certify_step(
            ap,
            carry,
            ap.n_tree_depths(),
            tol=options.certify_tol,
            margin=options.certify_margin,
            opts=options.solver,
        )
        skipped, p1_reused = dec.flags()
    if skipped:
        allocation = _host(dec.x_snap)
        zero = phases.PhaseStats(0, 0, True, 0.0)
        return AllocResult(
            allocation=allocation,
            phase1=_host(carry.x1),
            phase2=allocation.copy(),
            warm_state=warm,
            wall_time_s=time.perf_counter() - t0,
            stats=StepStats.build(
                solves=0,
                iterations=0,
                phase_iterations=[0, 0, 0],
                converged=True,
                skipped=True,
                certify_pass=True,
                kkt_certified=True,
                truncated=False,
                phase1=zero._asdict(),
                phase2=zero._asdict(),
                phase3=zero._asdict(),
            ),
            carry=carry,
        )
    if p1_reused:
        x1 = carry.x1
        s1 = phases.PhaseStats(0, 0, True, 0.0)
        if warm:
            w1 = warm.p1
        else:
            w1 = solver_mod.SolverState.zeros(
                ap.n, ap.tree.m, ap.sla.k, ap.l.dtype, ap.l.device
            )
        state = w1._replace(x=x1)
    else:
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
    new_carry = None
    if options.incremental:
        if p1_reused:
            new_carry = carry._replace(
                x=x3, cap=ap.tree.cap, sla_lo=ap.sla.lo, sla_hi=ap.sla.hi
            )
        else:
            new_carry = solver_mod.make_carry(ap, x1, x3)
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
            certify_pass=p1_reused,
            kkt_certified=s1.kkt_certified and s2.kkt_certified and s3.kkt_certified,
            truncated=truncated,
            phase1=s1._asdict(),
            phase2=s2._asdict(),
            phase3=s3._asdict(),
        ),
        carry=new_carry,
    )
