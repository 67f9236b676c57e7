"""The three-phase allocation program (Algorithm 3): the engine's step for
one scenario, and K scenarios in one solve.

The reference expresses the policy as a fixed-shape jax program (a
``lax.scan`` over priority levels, ``lax.while_loop`` saturation rounds),
jitted once and ``vmap``-ed over K scenarios.  The port runs the same
program eagerly, with the reference's control flow made Python control
flow, on one scenario (``[n]`` fleet leaves) or on K lanes at once
(``[K, n]``, :func:`optimize_batched`): every phase, solve and kernel launch
covers all K lanes (:mod:`repro_torch.core.lanes`), and the host decisions
one scenario takes with ``if`` become per-lane masks:

* the Phase I priority sweep walks the engine's pinned levels
  (:class:`BatchMeta`) and skips the levels with no active device; which
  levels those are is worked out on the host by the caller from its numpy
  priority and activity arrays, so the skip costs no device transfer (with
  lanes, a level runs for the lanes that have it and the others hold);
* the Phase II/III saturation rounds (:func:`_maxmin_loop`) bring each
  round's exit test to the host in one transfer (one per lane with lanes,
  each lane stopping on its own);
* the SLA-free max-min fast path is the water-fill on the device,
  :func:`repro_torch.core.waterfill.waterfill_torch`.

Every step-problem builder (``qp_step``, ``lp_step``, ``saturated_mask``,
``repair``) comes from :mod:`repro_torch.core.phases`, as in the reference,
so the host driver (:func:`repro_torch.core.nvpax.optimize`) and this
program build the same convex programs and differ only in orchestration.

With an incremental ``carry`` the certify pass runs first
(:mod:`repro_torch.core.solver.certify`); its two flags come to the host in
one transfer and choose which phases run, where the reference gates its
loops with traced predicates.  With lanes, an all-skip batch is assembled
from the carry without a solve, as the reference's ``lax.cond`` does.  The
outputs, warm carry included, are the reference's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import phases, solver
from repro_torch.core.lanes import column, lane_any, lane_scalar, select
from repro_torch.core.nvpax import NvpaxOptions
from repro_torch.core.problem import AllocProblem
from repro_torch.core.solver.options import KKT_HIST_BUCKETS
from repro_torch.core.waterfill import waterfill_torch
from repro_torch.obs import recorder as obs_recorder
from repro_torch.obs.stats import StepStats

__all__ = [
    "BatchMeta",
    "BatchedAllocResult",
    "BatchedStepState",
    "PhaseCostModel",
    "active_levels",
    "batch_meta",
    "calibrate_iter_cost",
    "calibrate_phase_cost",
    "optimize_batched",
    "solve_three_phase",
    "stack_problems",
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
    """State of one phase of the program.  Counts and flags are host values
    (numpy arrays of K entries with lanes); the residual and histogram stay
    on the device (``[K, 1]`` and ``[K, buckets]`` with lanes)."""

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


@dataclass
class BatchedAllocResult:
    """K scenarios' worth of :class:`repro_torch.core.nvpax.AllocResult`."""

    allocation: np.ndarray  # [K, n] final feasible allocations
    phase1: np.ndarray  # [K, n]
    phase2: np.ndarray  # [K, n]
    warm_state: Any  # phases.WarmCarry with [K, ...] leaves (t a [K, 1] column)
    wall_time_s: float
    stats: dict[str, Any]  # per-scenario arrays: solves/iterations/converged ...
    # incremental-mode anchor for the next batched step ([K, ...] leaves;
    # None unless a carry was threaded in or options.incremental)
    carry: Any = None
    # the flight record (repro_torch.obs.recorder.RecorderState with [K, ...]
    # leaves) that was passed in, advanced in place; None unless one was
    recorder: Any = None


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


def active_levels(priority: np.ndarray, active: np.ndarray):
    """The priority levels present among active devices, from host arrays:
    the Phase I sweep skips every other level.  For ``[K, n]`` arrays, one
    set per lane."""
    priority, active = np.asarray(priority), np.asarray(active, bool)
    if active.ndim == 2:
        return [active_levels(p, a) for p, a in zip(np.broadcast_to(priority, active.shape),
                                                     active)]
    return frozenset(int(p) for p in np.unique(priority[active]))


def stack_problems(aps: Sequence[AllocProblem]) -> AllocProblem:
    """Stack K control-step problems into one with ``[K, n]`` fleet leaves.

    All scenarios must share the PDN and SLA topology (same datacenter,
    different telemetry/activity/priorities): that is what lets the K
    scenarios run as one program.  Raises ``ValueError`` on topology
    mismatch; leaves that are one object (a shared prebuilt topology, the
    controller's path) are not compared.
    """
    if not aps:
        raise ValueError("need at least one AllocProblem")
    ref = aps[0]
    for i, ap in enumerate(aps[1:], start=1):
        for name, a, b in [
            ("tree.start", ref.tree.start, ap.tree.start),
            ("tree.end", ref.tree.end, ap.tree.end),
            ("tree.cap", ref.tree.cap, ap.tree.cap),
            ("tree.depth", ref.tree.depth, ap.tree.depth),
            ("sla.dev", ref.sla.dev, ap.sla.dev),
            ("sla.ten", ref.sla.ten, ap.sla.ten),
            ("sla.lo", ref.sla.lo, ap.sla.lo),
            ("sla.hi", ref.sla.hi, ap.sla.hi),
        ]:
            if a is b:  # shared topology object: no device compare
                continue
            if a.shape != b.shape or not torch.equal(a, b.to(a.device)):
                raise ValueError(f"scenario {i} differs from scenario 0 in {name}")

    def stk(leaf):
        return torch.stack([getattr(ap, leaf) for ap in aps])

    return ref._replace(
        l=stk("l"),
        u=stk("u"),
        r=stk("r"),
        priority=stk("priority"),
        active=stk("active"),
        weight_scale=stk("weight_scale"),
    )


def _empty_state(x, sol, mask, done) -> BatchedStepState:
    if x.ndim == 2:  # lanes: host counts per lane
        k = x.shape[0]
        return BatchedStepState(
            x=x,
            solver=sol,
            mask=mask,
            solves=np.zeros(k, np.int64),
            iterations=np.zeros(k, np.int64),
            converged=np.ones(k, bool),
            certified=np.ones(k, bool),
            done=np.broadcast_to(np.asarray(done, bool), (k,)).copy(),
            kkt_res=x.new_zeros(k, 1),
            restarts=np.zeros(k, np.int64),
            kkt_hist=torch.zeros(k, KKT_HIST_BUCKETS, dtype=torch.int32, device=x.device),
        )
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
        converged=st.converged & stats.converged,
        certified=st.certified & stats.certified,
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
    present,
    run: np.ndarray | None = None,
) -> BatchedStepState:
    """Algorithm 1 over the pinned levels, skipping those with no active
    device (``present`` comes from the caller's host arrays: one set, or one
    per lane).  With lanes a level solves the lanes that have it among
    ``run`` (default all) and the others hold their state."""
    lanes = ap.l.ndim == 2
    st = _empty_state(ap.l, warm, torch.zeros_like(ap.active), False)
    for p in meta.levels:
        at_level = None
        if lanes:
            at_level = np.array([p in pres for pres in present])
            if run is not None:
                at_level &= run
            if not at_level.any():
                continue
        elif p not in present:
            continue
        mask_a = ap.active & (ap.priority == p)
        prob = phases.qp_step(ap, st.x, mask_a, st.mask, meta.eps, pin_free=meta.pin_free)
        sol = solver.SolverState(
            st.x, st.solver.t, st.solver.y_tree, st.solver.y_sla, st.solver.y_imp
        )
        sol, stats = solver.solve(prob, ap.tree, ap.sla, sol, opts, live=at_level)
        x = phases.repair(sol.x, ap, meta.n_depths)
        new = _after_solve(st, stats, x=x, solver=sol, mask=st.mask | mask_a)
        st = new if at_level is None or at_level.all() else select(at_level, new, st)
    return st


def _maxmin_loop(
    ap: AllocProblem,
    x: torch.Tensor,
    opt_set: torch.Tensor,
    free_set: torch.Tensor,
    meta: BatchMeta,
    opts: solver.SolverOptions,
    warm: solver.SolverState,
    iters_before=0,
    budget: int | None = None,
    run: np.ndarray | None = None,
) -> BatchedStepState:
    """Algorithm 2 (Phase II/III shared driver), the reference's
    ``lax.while_loop`` as a Python loop.

    ``budget`` (with ``iters_before``, the PDHG iterations spent by earlier
    phases) is the anytime mode: the loop stops as soon as the cumulative
    count crosses the budget.  Every round ends with the exact repair, so a
    cut allocation is feasible.

    With lanes every lane runs its own rounds (``iters_before`` one count per
    lane), and only the lanes in ``run`` (default all) enter the loop; a
    lane that stops holds its state while the others go on.
    """
    lanes = x.ndim == 2
    if lanes and run is not None and not run.all():
        opt_set = opt_set & column(run, x.device)
    if meta.use_waterfill and ap.sla.k == 0:
        x_wf = waterfill_torch(x, opt_set, ap.tree, ap.u)
        return _empty_state(x_wf, warm, torch.zeros_like(opt_set), True)

    # freeze devices with no slack at entry (see phases.run_maxmin_phase)
    mask = opt_set & ~phases.saturated_mask(x, ap, opt_set)
    st = _empty_state(x, warm, mask, False)
    if lanes:
        live = lane_any(mask).reshape(-1).cpu().numpy()
    else:
        live = bool(mask.any())
    zero = lane_scalar(x, 0.0)
    while True:
        if lanes:
            live = live & (st.solves < meta.max_rounds)
            if budget is not None:
                live &= iters_before + st.iterations < budget
            if not live.any():
                break
        elif not (live and st.solves < meta.max_rounds) or (
            budget is not None and iters_before + st.iterations >= budget
        ):
            break
        mask_f = ~(st.mask | free_set)
        prob = phases.lp_step(ap, st.x, st.mask, mask_f, free_set, meta.eps)
        sol = solver.SolverState(
            st.x, zero, st.solver.y_tree, st.solver.y_sla, st.solver.y_imp
        )
        sol, stats = solver.solve(prob, ap.tree, ap.sla, sol, opts,
                                  live=live if lanes else None)
        # monotone non-decrease on non-free devices (mirrors
        # phases.run_maxmin_phase): a truncated solve cannot undo Phase I
        x_cand = torch.where(free_set, sol.x, torch.maximum(sol.x, st.x))
        x_new = phases.repair(x_cand, ap, meta.n_depths)
        sat = phases.saturated_mask(x_new, ap, st.mask)
        mask = st.mask & ~sat
        # the round's exit test, in one transfer: no measurable head-room
        # left and nothing newly saturated, or nothing left to optimize
        flags = torch.stack([sol.t <= phases.SAT_TOL, lane_any(sat), lane_any(mask)])
        if lanes:
            no_room, any_sat, any_mask = flags.reshape(3, -1).cpu().numpy()
            done = no_room & ~any_sat
            new = _after_solve(st, stats, x=x_new, solver=sol, mask=mask, done=done)
            st = new if live.all() else select(live, new, st)
            live = live & any_mask & ~done
        else:
            no_room, any_sat, live = flags.tolist()
            done = no_room and not any_sat
            st = _after_solve(st, stats, x=x_new, solver=sol, mask=mask, done=done)
            live = live and not done
    return st


def _lane_present(ap: AllocProblem):
    """The levels present among each lane's active devices, from one host
    copy of the priorities and activity."""
    return active_levels(ap.priority.cpu().numpy(), ap.active.cpu().numpy())


def solve_three_phase(
    ap: AllocProblem,
    meta: BatchMeta,
    opts: solver.SolverOptions,
    warm: phases.WarmCarry | None = None,
    iter_budget: int | None = None,
    carry: solver.IncrementalCarry | None = None,
    *,
    present=None,
    decision: solver.CertifyDecision | None = None,
):
    """Algorithm 3 on one scenario, or on K lanes (``[K, n]`` fleet leaves).

    ``warm`` is the per-phase carry from the previous control step (see
    :class:`repro_torch.core.phases.WarmCarry`): each phase warm-starts its
    duals from the same phase's previous end state, with the primal chained
    through the current step — the host driver's semantics.

    ``iter_budget`` is the deadline/anytime mode in iteration space: Phase I
    always runs, and each refinement phase (II: active surplus, III: idle
    surplus) starts only if the cumulative PDHG iteration count is still
    under budget, then stops at the first saturation round that crosses it.

    ``present`` is the set of priority levels with an active device (one
    per lane with lanes), worked out on the host by the caller
    (:func:`active_levels`); without it the problem's tensors are read back
    once to find them.

    ``carry`` (incremental mode) is the previous accepted step's
    :class:`~repro_torch.core.solver.certify.IncrementalCarry`: the certify
    pass runs first (or its ``decision`` is passed in), and on success the
    carried point stands in for the whole program (full skip: Phases II/III
    return their initial states and ``x_snap``) or for Phase I only (Phase I
    skip).  With lanes each lane takes its own decision.

    Returns ``(x1, x2, x3, warm_carry, stats)``; ``stats`` has the
    reference's keys, with ``stats["truncated"]`` True when refinement work
    was skipped or cut short by the budget, and ``stats["skipped"]`` /
    ``stats["certify_pass"]`` the certify decision (False without a carry);
    with lanes the counts and flags are numpy arrays of K entries.
    """
    n, m, k = ap.n, ap.tree.m, ap.sla.k
    lanes = ap.l.shape[0] if ap.l.ndim == 2 else None
    if warm is None:
        w1 = solver.SolverState.zeros(n, m, k, ap.l.dtype, ap.l.device, lanes=lanes)
    else:
        w1 = warm.p1
    if present is None:
        present = (_lane_present(ap) if lanes
                   else frozenset(ap.priority_levels(active_only=True)))

    skip = skip_p1 = False if lanes is None else np.zeros(lanes, bool)
    dec = decision
    if carry is not None:
        if dec is None:
            dec = solver.certify_step(
                ap, carry, meta.n_depths, tol=meta.certify_tol, margin=meta.certify_margin,
                opts=opts,
            )
        skip, skip_p1 = dec.flags()
    skip_any = skip | skip_p1
    empty = torch.zeros_like(ap.active)

    def carried() -> BatchedStepState:
        """The carried Phase I point, standing in for the sweep (both tiers)."""
        sol = solver.SolverState(carry.x1, w1.t, w1.y_tree, w1.y_sla, w1.y_imp)
        return _empty_state(carry.x1, sol, empty, False)

    if lanes is None:
        p1 = carried() if skip_any else _phase1_scan(ap, meta, opts, w1, present)
    else:
        p1 = _phase1_scan(ap, meta, opts, w1, present, run=~skip_any)
        if skip_any.any():
            p1 = select(skip_any, carried(), p1)
    x1 = p1.x
    truncated = False if lanes is None else np.zeros(lanes, bool)

    def refine(x, sol, opt_set, free_set, iters_before):
        """One budget-gated max-min phase; returns (state, truncated).  A
        full skip runs no round and is not a truncation; its allocation is
        the carried one after the repair."""
        if lanes is not None:
            return refine_lanes(x, sol, opt_set, free_set, iters_before)
        if skip:
            return _empty_state(dec.x_snap, sol, empty, False), False
        if iter_budget is None:
            return _maxmin_loop(ap, x, opt_set, free_set, meta, opts, sol), False
        if iters_before >= iter_budget:  # the phase never starts
            return _empty_state(x, sol, empty, False), True
        st = _maxmin_loop(
            ap, x, opt_set, free_set, meta, opts, sol, iters_before, iter_budget
        )
        # cut short: the loop exited on the budget test with unsaturated
        # optimizable devices still holding head-room
        work_left = (not st.done) and st.solves < meta.max_rounds and bool(st.mask.any())
        return st, work_left and iters_before + st.iterations >= iter_budget

    def refine_lanes(x, sol, opt_set, free_set, iters_before):
        run = ~skip
        start_ok = np.ones(lanes, bool)
        if iter_budget is not None:
            start_ok = iters_before < iter_budget
            run = run & start_ok
        st = _maxmin_loop(
            ap, x, opt_set, free_set, meta, opts, sol, iters_before, iter_budget, run=run
        )
        if not run.all():  # the lanes that never started hold the phase's start
            st = select(run, st, _empty_state(x, sol, empty, False))
        if skip.any():
            st = select(skip, _empty_state(dec.x_snap, sol, empty, False), st)
        if iter_budget is None:
            return st, np.zeros(lanes, bool)
        work_left = ~st.done & (st.solves < meta.max_rounds) & lane_any(
            st.mask).reshape(-1).cpu().numpy()
        cut = ~start_ok | (work_left & (iters_before + st.iterations >= iter_budget))
        return st, cut & ~skip

    def idle_phase(st: BatchedStepState, sol) -> BatchedStepState:
        return _empty_state(st.x, sol, st.mask, st.done)

    w2 = phases.merge_warm(p1.solver, warm.p2 if warm is not None else None)
    if meta.run_phase2:
        p2, cut2 = refine(x1, w2, ap.active, ap.idle, p1.iterations)
        truncated = truncated | cut2
    else:
        p2 = idle_phase(p1, w2)
    x2 = p2.x

    w3 = phases.merge_warm(p2.solver, warm.p3 if warm is not None else None)
    if meta.run_phase3:
        p3, cut3 = refine(x2, w3, ap.idle, empty, p1.iterations + p2.iterations)
        truncated = truncated | cut3
    else:
        p3 = idle_phase(p2, w3)
    x3 = p3.x

    stats = {
        "solves": p1.solves + p2.solves + p3.solves,
        "iterations": p1.iterations + p2.iterations + p3.iterations,
        "iterations_p1": p1.iterations,
        "iterations_p2": p2.iterations,
        "iterations_p3": p3.iterations,
        "converged": p1.converged & p2.converged & p3.converged,
        "kkt_certified": p1.certified & p2.certified & p3.certified,
        "truncated": truncated,
        "kkt_res": torch.maximum(torch.maximum(p1.kkt_res, p2.kkt_res), p3.kkt_res),
        "restarts": p1.restarts + p2.restarts + p3.restarts,
        "kkt_hist": p1.kkt_hist + p2.kkt_hist + p3.kkt_hist,
        # incremental certify outcome (False without a carry)
        "skipped": skip,
        "certify_pass": skip_any,
    }
    return x1, x2, x3, phases.WarmCarry(p1.solver, p2.solver, p3.solver), stats


def _solve_batched(
    stacked: AllocProblem,
    meta: BatchMeta,
    opts: solver.SolverOptions,
    warm: phases.WarmCarry | None,
    iter_budget: int | None = None,
    carry: solver.IncrementalCarry | None = None,
):
    """The K-lane program of :func:`optimize_batched`: Algorithm 3 on every
    lane in one solve, the next incremental anchor beside it.

    With a ``carry`` (``[K, ...]`` leaves) and a warm state, the certify
    pass runs on every lane first; when every lane certifies a full skip,
    the outputs are assembled from the carry without running the program
    (the reference's all-skip ``lax.cond``, here one host read of the K
    flags); otherwise each lane takes its own decision inside the program.
    Returns ``(x1, x2, x3, warm_carry, stats, new_carry)``.
    """
    present = _lane_present(stacked)
    dec = None
    if carry is not None and warm is not None:
        dec = solver.certify_step(
            stacked, carry, meta.n_depths, tol=meta.certify_tol, margin=meta.certify_margin,
            opts=opts,
        )
        skip, skip_p1 = dec.flags()
        if skip.all():
            # every scenario certified: the exact all-skip outputs the
            # program would produce, without running it
            kk = skip.shape[0]
            p1_sol = warm.p1._replace(x=carry.x1)
            w2 = phases.merge_warm(p1_sol, warm.p2)
            w3 = phases.merge_warm(w2, warm.p3)
            zi = np.zeros(kk, np.int64)
            yes = np.ones(kk, bool)
            stats = {
                "solves": zi,
                "iterations": zi,
                "iterations_p1": zi,
                "iterations_p2": zi,
                "iterations_p3": zi,
                "converged": yes,
                "kkt_certified": yes,
                "truncated": np.zeros(kk, bool),
                "skipped": skip,
                "certify_pass": skip | skip_p1,
                "kkt_res": stacked.l.new_zeros(kk, 1),
                "restarts": zi,
                "kkt_hist": torch.zeros(kk, KKT_HIST_BUCKETS, dtype=torch.int32,
                                        device=stacked.l.device),
            }
            wcarry = phases.WarmCarry(p1_sol, w2, w3)
            return carry.x1, dec.x_snap, dec.x_snap, wcarry, stats, carry
    x1, x2, x3, wcarry, stats = solve_three_phase(
        stacked, meta, opts, warm, iter_budget, carry, present=present, decision=dec
    )
    new_carry = solver.update_carry(
        carry, stacked, x1, x3, stats["skipped"], stats["certify_pass"] & ~stats["skipped"]
    )
    return x1, x2, x3, wcarry, stats, new_carry


def _record_batch(cfg, rec, stats: dict, alloc: torch.Tensor, stacked: AllocProblem):
    """Append one flight-record row per lane, all K lanes in one update (in
    place; see :mod:`repro_torch.obs.recorder`).  The satisfaction ratio's
    request is the shaped one on active devices and 0 on idle ones."""
    r_eff = torch.where(stacked.active, torch.clamp(stacked.r, stacked.l, stacked.u), 0.0)
    return obs_recorder.record(cfg, rec, stats, alloc, r_eff, stacked.sla)


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


# per-(shape, dtype, device, meta, opts) phase cost models
_ITER_COST_CACHE: dict[Any, PhaseCostModel] = {}

# effectively-unbounded budget: the full-solve probe runs the budgeted
# program the deadline path serves
_PROBE_FULL_BUDGET = 2**31 - 1


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def calibrate_phase_cost(
    stacked: AllocProblem,
    meta: BatchMeta,
    opts: solver.SolverOptions,
) -> PhaseCostModel:
    """Measured per-phase seconds per PDHG iteration of the K-lane program.

    Two probes, each run twice and timed on the second run, ending in a
    device synchronize:

    * budget 1 — Phase I only (both refinement phases skipped): prices the
      QP sweep directly;
    * unbounded budget — the full three-phase program: the Phase II/III
      price is the residual wall time after subtracting the Phase I
      iterations at the QP price.

    Iterations are the slowest lane's.  Estimates include per-solve overhead
    (scaling setup, KKT checks), which biases costs high and therefore
    derived budgets low: deadline truncation errs on the early side.
    Cached per (shape, dtype, device, meta, opts).
    """
    dev = stacked.l.device
    key = (tuple(stacked.l.shape), str(stacked.l.dtype), str(dev), meta, opts)
    if key not in _ITER_COST_CACHE:
        def probe(budget):
            _solve_batched(stacked, meta, opts, None, budget)
            _sync(dev)
            t0 = time.perf_counter()
            stats = _solve_batched(stacked, meta, opts, None, budget)[4]
            _sync(dev)
            wall = time.perf_counter() - t0
            return wall, [int(np.max(stats[f"iterations_p{i}"])) for i in (1, 2, 3)]

        wall1, phases1 = probe(1)
        wall_f, phases_f = probe(_PROBE_FULL_BUDGET)
        _ITER_COST_CACHE[key] = PhaseCostModel.fit(wall1, phases1, wall_f, phases_f)
    return _ITER_COST_CACHE[key]


def calibrate_iter_cost(
    stacked: AllocProblem,
    meta: BatchMeta,
    opts: solver.SolverOptions,
) -> float:
    """Mix-weighted scalar seconds-per-iteration (:func:`calibrate_phase_cost`)."""
    return calibrate_phase_cost(stacked, meta, opts).cost_per_iter()


def optimize_batched(
    aps: Sequence[AllocProblem] | AllocProblem,
    options: NvpaxOptions = NvpaxOptions(),
    warm: phases.WarmCarry | None = None,
    *,
    meta: BatchMeta | None = None,
    iter_budget: int | None = None,
    carry: Any = None,
    rec: Any = None,
    rec_cfg: Any = None,
) -> BatchedAllocResult:
    """Run Algorithm 3 on K scenarios as one solve: every kernel launch and
    torch op covers all K lanes.

    ``aps`` is either a sequence of per-scenario :class:`AllocProblem`\\ s
    sharing PDN/SLA topology, or an already-stacked problem with ``[K, n]``
    fleet leaves (see :func:`stack_problems`).  ``warm`` optionally carries
    a batched solver state from a previous batched call (``[K, ...]``
    leaves).

    ``meta`` pins the program's static metadata (e.g. a topology-pinned
    :class:`repro_torch.core.engine.AllocEngine` passes its construction-time
    metadata); by default it is derived from the stacked problem.

    Deadline mode: ``options.deadline_s`` is honoured by translating the
    wall-clock deadline into a PDHG iteration budget per scenario via
    :func:`calibrate_phase_cost` (once per shape) — Phase I always runs,
    refinement phases are skipped or cut at saturation-round granularity,
    and ``stats["truncated"]`` reports per-scenario truncation.
    ``iter_budget`` passes an explicit budget instead (overrides
    ``deadline_s``).

    Incremental mode: ``carry`` threads the previous batched step's
    ``BatchedAllocResult.carry`` back in; per-scenario certify flags land in
    ``stats["skipped"]``/``stats["certify_pass"]`` as ``[K]`` arrays, and an
    all-skip batch collapses to the certify pass.

    Flight recorder: ``rec``/``rec_cfg`` take a per-lane
    :class:`repro_torch.obs.recorder.RecorderState` (``[K, ...]`` leaves, see
    :func:`repro_torch.obs.recorder.init_batch`), which gets one row per lane
    after the solve, the all-skip batch included, in place; it comes back as
    ``BatchedAllocResult.recorder``.

    Each lane's output is the one-scenario program's on that lane
    (``tests/test_torch_batched.py``).
    """
    t0 = time.perf_counter()
    stacked = aps if isinstance(aps, AllocProblem) else stack_problems(aps)
    if stacked.l.ndim != 2:
        raise ValueError(f"expected stacked [K, n] fleet leaves, got shape {tuple(stacked.l.shape)}")
    if meta is None:
        meta = batch_meta(stacked, options)
    if iter_budget is None and options.deadline_s is not None:
        iter_budget = calibrate_phase_cost(stacked, meta, options.solver).budget(
            options.deadline_s)
    x1, x2, x3, sol_state, stats, new_carry = _solve_batched(
        stacked, meta, options.solver, warm, iter_budget, carry
    )
    if rec is not None and rec_cfg is not None:
        _record_batch(rec_cfg, rec, stats, x3, stacked)
    allocation = x3.cpu().numpy()  # waits for the device
    wall = time.perf_counter() - t0
    return BatchedAllocResult(
        allocation=allocation,
        phase1=x1.cpu().numpy(),
        phase2=x2.cpu().numpy(),
        warm_state=sol_state,
        wall_time_s=wall,
        carry=new_carry if carry is not None or options.incremental else None,
        recorder=rec,
        stats=StepStats.from_lanes(
            stats, iter_budget=iter_budget, n_scenarios=int(stacked.l.shape[0])
        ),
    )
