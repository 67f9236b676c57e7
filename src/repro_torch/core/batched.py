"""The three-phase allocation program for one scenario (Algorithm 3), the
engine's step.

The reference expresses the policy as a fixed-shape jax program (a
``lax.scan`` over priority levels, ``lax.while_loop`` saturation rounds),
jitted once and ``vmap``-ed over K scenarios.  The port runs the same
program eagerly on one scenario, with the reference's control flow made
Python control flow:

* the Phase I priority sweep walks the engine's pinned levels
  (:class:`BatchMeta`) and skips the levels with no active device; which
  levels those are is worked out on the host by the caller from its numpy
  priority and activity arrays, so the skip costs no device transfer;
* the Phase II/III saturation rounds (:func:`_maxmin_loop`) bring each
  round's exit test to the host in one transfer;
* the SLA-free max-min fast path is the water-fill on the device,
  :func:`repro_torch.core.waterfill.waterfill_torch`.

Every step-problem builder (``qp_step``, ``lp_step``, ``saturated_mask``,
``repair``) comes from :mod:`repro_torch.core.phases`, as in the reference,
so the host driver (:func:`repro_torch.core.nvpax.optimize`) and this
program build the same convex programs and differ only in orchestration.

With an incremental ``carry`` the certify pass runs first
(:mod:`repro_torch.core.solver.certify`); its two flags come to the host in
one transfer and choose which phases run, where the reference gates its
loops with traced predicates.  The outputs, warm carry included, are the
reference's.

Not ported yet (ROADMAP Queue 1 item 8b): ``stack_problems``,
``optimize_batched`` and the calibration helpers of the K > 1 path.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import phases, solver
from repro_torch.core.nvpax import NvpaxOptions
from repro_torch.core.problem import AllocProblem
from repro_torch.core.solver.options import KKT_HIST_BUCKETS
from repro_torch.core.waterfill import waterfill_torch

__all__ = [
    "BatchMeta",
    "BatchedStepState",
    "PhaseCostModel",
    "active_levels",
    "batch_meta",
    "solve_three_phase",
]


class BatchMeta(NamedTuple):
    """Static metadata of one engine: fixed for its life, derived from the
    fleet and the options by :func:`batch_meta` (or the engine's
    constructor, from the full priority layout)."""

    levels: tuple[int, ...]  # descending distinct priority values
    n_depths: int  # PDN tree depth count (repair trips)
    pin_free: bool  # Phase I free-device pinning (paper 4.3.1)
    max_rounds: int  # Phase II/III saturation-round bound
    use_waterfill: bool  # SLA-free max-min fast path
    run_phase2: bool
    run_phase3: bool
    eps: float  # regularization weight
    # incremental certify-first stepping tolerances (watts; see
    # repro_torch.core.solver.certify); only consulted when a carry is passed
    certify_tol: float = 1e-9
    certify_margin: float = 1e-2


class BatchedStepState(NamedTuple):
    """State of one phase of the program (one scenario's solve).  Counts and
    flags are host values; the residual and histogram stay on the device."""

    x: torch.Tensor  # [n] current allocation
    solver: solver.SolverState  # warm-started inner-solver state
    mask: torch.Tensor  # [n] bool: finalized set (P1) / optimized set (P2, P3)
    solves: int  # inner solves executed
    iterations: int  # cumulative PDHG iterations
    converged: bool  # all executed solves converged
    certified: bool  # all executed solves KKT-certified
    done: bool  # early-exit flag (max-min rounds)
    kkt_res: torch.Tensor  # 0-d: worst KKT residual over executed solves
    restarts: int
    kkt_hist: torch.Tensor  # [KKT_HIST_BUCKETS] int32


def batch_meta(ap: AllocProblem, options: NvpaxOptions) -> BatchMeta:
    """Static metadata from a problem (levels present among its active
    devices)."""
    return BatchMeta(
        levels=ap.priority_levels(active_only=True),
        n_depths=ap.n_tree_depths(),
        pin_free=ap.pin_free_ok(),
        max_rounds=options.max_rounds,
        use_waterfill=options.use_waterfill,
        run_phase2=options.run_phase2,
        run_phase3=options.run_phase3,
        eps=options.eps,
        certify_tol=options.certify_tol,
        certify_margin=options.certify_margin,
    )


def active_levels(priority: np.ndarray, active: np.ndarray) -> frozenset[int]:
    """The priority levels present among active devices, from host arrays:
    the Phase I sweep skips every other level."""
    return frozenset(int(p) for p in np.unique(np.asarray(priority)[np.asarray(active, bool)]))


def _empty_state(x, sol, mask, done: bool) -> BatchedStepState:
    return BatchedStepState(
        x=x,
        solver=sol,
        mask=mask,
        solves=0,
        iterations=0,
        converged=True,
        certified=True,
        done=done,
        kkt_res=x.new_zeros(()),
        restarts=0,
        kkt_hist=torch.zeros(KKT_HIST_BUCKETS, dtype=torch.int32, device=x.device),
    )


def _after_solve(st: BatchedStepState, stats: solver.SolveStats, **kw) -> BatchedStepState:
    res = torch.maximum(torch.maximum(stats.primal_res, stats.dual_res), stats.comp_res)
    return st._replace(
        solves=st.solves + 1,
        iterations=st.iterations + stats.iterations,
        converged=st.converged and stats.converged,
        certified=st.certified and stats.certified,
        kkt_res=torch.maximum(st.kkt_res, res),
        restarts=st.restarts + stats.restarts,
        kkt_hist=st.kkt_hist + stats.score_hist,
        **kw,
    )


def _phase1_scan(
    ap: AllocProblem,
    meta: BatchMeta,
    opts: solver.SolverOptions,
    warm: solver.SolverState,
    present: frozenset[int],
) -> BatchedStepState:
    """Algorithm 1 over the pinned levels, skipping those with no active
    device (``present`` comes from the caller's host arrays)."""
    st = _empty_state(ap.l, warm, torch.zeros_like(ap.active), False)
    for p in meta.levels:
        if p not in present:
            continue
        mask_a = ap.active & (ap.priority == p)
        prob = phases.qp_step(ap, st.x, mask_a, st.mask, meta.eps, pin_free=meta.pin_free)
        sol = solver.SolverState(
            st.x, st.solver.t, st.solver.y_tree, st.solver.y_sla, st.solver.y_imp
        )
        sol, stats = solver.solve(prob, ap.tree, ap.sla, sol, opts)
        x = phases.repair(sol.x, ap, meta.n_depths)
        st = _after_solve(st, stats, x=x, solver=sol, mask=st.mask | mask_a)
    return st


def _maxmin_loop(
    ap: AllocProblem,
    x: torch.Tensor,
    opt_set: torch.Tensor,
    free_set: torch.Tensor,
    meta: BatchMeta,
    opts: solver.SolverOptions,
    warm: solver.SolverState,
    iters_before: int = 0,
    budget: int | None = None,
) -> BatchedStepState:
    """Algorithm 2 (Phase II/III shared driver), the reference's
    ``lax.while_loop`` as a Python loop.

    ``budget`` (with ``iters_before``, the PDHG iterations spent by earlier
    phases) is the anytime mode: the loop stops as soon as the cumulative
    count crosses the budget.  Every round ends with the exact repair, so a
    cut allocation is feasible.
    """
    if meta.use_waterfill and ap.sla.k == 0:
        x_wf = waterfill_torch(x, opt_set, ap.tree, ap.u)
        return _empty_state(x_wf, warm, torch.zeros_like(opt_set), True)

    # freeze devices with no slack at entry (see phases.run_maxmin_phase)
    mask = opt_set & ~phases.saturated_mask(x, ap, opt_set)
    st = _empty_state(x, warm, mask, False)
    live = bool(mask.any())
    zero = x.new_zeros(())
    while live and st.solves < meta.max_rounds:
        if budget is not None and iters_before + st.iterations >= budget:
            break
        mask_f = ~(st.mask | free_set)
        prob = phases.lp_step(ap, st.x, st.mask, mask_f, free_set, meta.eps)
        sol = solver.SolverState(
            st.x, zero, st.solver.y_tree, st.solver.y_sla, st.solver.y_imp
        )
        sol, stats = solver.solve(prob, ap.tree, ap.sla, sol, opts)
        # monotone non-decrease on non-free devices (mirrors
        # phases.run_maxmin_phase): a truncated solve cannot undo Phase I
        x_cand = torch.where(free_set, sol.x, torch.maximum(sol.x, st.x))
        x_new = phases.repair(x_cand, ap, meta.n_depths)
        sat = phases.saturated_mask(x_new, ap, st.mask)
        mask = st.mask & ~sat
        # the round's exit test, in one transfer: no measurable head-room
        # left and nothing newly saturated, or nothing left to optimize
        no_room, any_sat, live = torch.stack(
            [sol.t <= phases.SAT_TOL, torch.any(sat), torch.any(mask)]
        ).tolist()
        done = no_room and not any_sat
        st = _after_solve(st, stats, x=x_new, solver=sol, mask=mask, done=done)
        live = live and not done
    return st


def solve_three_phase(
    ap: AllocProblem,
    meta: BatchMeta,
    opts: solver.SolverOptions,
    warm: phases.WarmCarry | None = None,
    iter_budget: int | None = None,
    carry: solver.IncrementalCarry | None = None,
    *,
    present: frozenset[int] | None = None,
):
    """One scenario's full Algorithm 3.

    ``warm`` is the per-phase carry from the previous control step (see
    :class:`repro_torch.core.phases.WarmCarry`): each phase warm-starts its
    duals from the same phase's previous end state, with the primal chained
    through the current step — the host driver's semantics.

    ``iter_budget`` is the deadline/anytime mode in iteration space: Phase I
    always runs, and each refinement phase (II: active surplus, III: idle
    surplus) starts only if the cumulative PDHG iteration count is still
    under budget, then stops at the first saturation round that crosses it.

    ``present`` is the set of priority levels with an active device, worked
    out on the host by the caller (:func:`active_levels`); without it the
    problem's tensors are read back once to find them.

    ``carry`` (incremental mode) is the previous accepted step's
    :class:`~repro_torch.core.solver.certify.IncrementalCarry`: the certify
    pass runs first, and on success the carried point stands in for the
    whole program (full skip: Phases II/III return their initial states and
    ``x_snap``) or for Phase I only (Phase I skip).

    Returns ``(x1, x2, x3, warm_carry, stats)``; ``stats`` has the
    reference's keys, with ``stats["truncated"]`` True when refinement work
    was skipped or cut short by the budget, and ``stats["skipped"]`` /
    ``stats["certify_pass"]`` the certify decision (False without a carry).
    """
    n, m, k = ap.n, ap.tree.m, ap.sla.k
    if warm is None:
        w1 = solver.SolverState.zeros(n, m, k, ap.l.dtype, ap.l.device)
    else:
        w1 = warm.p1
    if present is None:
        present = frozenset(ap.priority_levels(active_only=True))

    skip = skip_p1 = False
    if carry is not None:
        dec = solver.certify_step(
            ap, carry, meta.n_depths, tol=meta.certify_tol, margin=meta.certify_margin,
            opts=opts,
        )
        skip, skip_p1 = dec.flags()
    if skip or skip_p1:
        # the carried Phase I point stands in for the sweep (both tiers)
        carried = solver.SolverState(carry.x1, w1.t, w1.y_tree, w1.y_sla, w1.y_imp)
        p1 = _empty_state(carry.x1, carried, torch.zeros_like(ap.active), False)
    else:
        p1 = _phase1_scan(ap, meta, opts, w1, present)
    x1 = p1.x
    truncated = False

    def refine(x, sol, opt_set, free_set, iters_before):
        """One budget-gated max-min phase; returns (state, truncated).  A
        full skip runs no round and is not a truncation; its allocation is
        the carried one after the repair."""
        if skip:
            return _empty_state(dec.x_snap, sol, torch.zeros_like(ap.active), False), False
        if iter_budget is None:
            return _maxmin_loop(ap, x, opt_set, free_set, meta, opts, sol), False
        if iters_before >= iter_budget:  # the phase never starts
            return _empty_state(x, sol, torch.zeros_like(ap.active), False), True
        st = _maxmin_loop(
            ap, x, opt_set, free_set, meta, opts, sol, iters_before, iter_budget
        )
        # cut short: the loop exited on the budget test with unsaturated
        # optimizable devices still holding head-room
        work_left = (not st.done) and st.solves < meta.max_rounds and bool(st.mask.any())
        return st, work_left and iters_before + st.iterations >= iter_budget

    def idle_phase(st: BatchedStepState, sol) -> BatchedStepState:
        return _empty_state(st.x, sol, st.mask, st.done)

    w2 = phases.merge_warm(p1.solver, warm.p2 if warm is not None else None)
    if meta.run_phase2:
        p2, cut2 = refine(x1, w2, ap.active, ap.idle, p1.iterations)
        truncated = truncated or cut2
    else:
        p2 = idle_phase(p1, w2)
    x2 = p2.x

    w3 = phases.merge_warm(p2.solver, warm.p3 if warm is not None else None)
    if meta.run_phase3:
        empty = torch.zeros_like(ap.active)
        p3, cut3 = refine(x2, w3, ap.idle, empty, p1.iterations + p2.iterations)
        truncated = truncated or cut3
    else:
        p3 = idle_phase(p2, w3)
    x3 = p3.x

    stats = {
        "solves": p1.solves + p2.solves + p3.solves,
        "iterations": p1.iterations + p2.iterations + p3.iterations,
        "iterations_p1": p1.iterations,
        "iterations_p2": p2.iterations,
        "iterations_p3": p3.iterations,
        "converged": p1.converged and p2.converged and p3.converged,
        "kkt_certified": p1.certified and p2.certified and p3.certified,
        "truncated": truncated,
        "kkt_res": torch.maximum(torch.maximum(p1.kkt_res, p2.kkt_res), p3.kkt_res),
        "restarts": p1.restarts + p2.restarts + p3.restarts,
        "kkt_hist": p1.kkt_hist + p2.kkt_hist + p3.kkt_hist,
        # incremental certify outcome (False without a carry)
        "skipped": skip,
        "certify_pass": skip or skip_p1,
    }
    return x1, x2, x3, phases.WarmCarry(p1.solver, p2.solver, p3.solver), stats


class PhaseCostModel(NamedTuple):
    """Per-phase seconds-per-PDHG-iteration estimates.

    ``p1_s`` prices a Phase I (priority-sweep QP) iteration, ``p23_s`` a
    Phase II/III (saturation-round max-min LP) iteration.  ``mix`` is the
    (phase-1 fraction, phase-2+3 fraction) of iterations observed at
    calibration; callers with fresher information (e.g. the engine's
    last-step ``stats["phase_iterations"]``) pass their own mix.
    """

    p1_s: float
    p23_s: float
    mix: tuple[float, float]

    def cost_per_iter(self, mix: tuple[float, float] | None = None) -> float:
        f1, f23 = self.mix if mix is None else mix
        tot = max(f1 + f23, 1e-9)
        return (f1 * self.p1_s + f23 * self.p23_s) / tot

    def budget(self, deadline_s: float, mix: tuple[float, float] | None = None) -> int:
        """Wall-clock deadline -> cumulative PDHG iteration budget."""
        return max(int(float(deadline_s) / self.cost_per_iter(mix)), 0)

    @classmethod
    def fit(
        cls,
        wall_p1: float,
        phases_p1: Sequence[int],
        wall_full: float,
        phases_full: Sequence[int],
    ) -> "PhaseCostModel":
        """Fit two probes: a Phase-I-only probe prices the QP sweep
        directly; the Phase II/III price is the full probe's residual wall
        time at that QP price, floored at half of it so a noisy subtraction
        cannot produce a near-zero price (and an exploding budget)."""
        c1 = wall_p1 / max(phases_p1[0], 1)
        it23 = phases_full[1] + phases_full[2]
        if it23 > 0:
            c23 = max(max(wall_full - c1 * phases_full[0], 0.0) / it23, 0.5 * c1)
        else:
            c23 = c1
        tot = max(sum(phases_full), 1)
        return cls(p1_s=c1, p23_s=c23, mix=(phases_full[0] / tot, it23 / tot))
