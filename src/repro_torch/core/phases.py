"""The three nvPAX phases (paper section 4.3) + feasibility repair and
saturation detection.

Orchestration is host-level Python (priority sweep, saturation rounds); the
inner convex solves are :func:`repro_torch.core.solver.solve`, warm-started
across rounds.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import solver
from repro_torch.core.problem import INF, AllocProblem, StepProblem
from repro_torch.core.treeops import sla_matvec, sla_rmatvec, tree_matvec, tree_rmatvec
from repro_torch.core.waterfill import waterfill_arrays

__all__ = [
    "PhaseStats",
    "WarmCarry",
    "merge_warm",
    "repair",
    "saturated_mask",
    "qp_step",
    "lp_step",
    "phase1",
    "run_maxmin_phase",
]

# Tolerance (watts) for saturation detection, matching the paper's "no
# positive slack" test at control-loop precision.
SAT_TOL = 1e-3
# Max saturation rounds; each round freezes >= 1 device or the loop exits on
# no-progress, so this is a safety net, not a truncation.
MAX_ROUNDS = 40


class PhaseStats(NamedTuple):
    solves: int
    iterations: int
    converged: bool
    max_primal_res: float
    # every inner solve exited KKT-certified (False when any solve exited on
    # the no-progress/optimal-vertex certificate — see solver.termination)
    kkt_certified: bool = True


class WarmCarry(NamedTuple):
    """Per-phase warm-start carry across control steps.

    Each phase warm-starts its *duals* from the same phase's end state at the
    previous control step, while the primal chains through the current
    step's phases (the phase-matched carry of the reference).
    """

    p1: solver.SolverState
    p2: solver.SolverState
    p3: solver.SolverState

    @classmethod
    def zeros(cls, n: int, m: int, k: int, dtype, device) -> "WarmCarry":
        z = solver.SolverState.zeros(n, m, k, dtype, device)
        return cls(z, z, z)


def merge_warm(
    chain: solver.SolverState, carry: solver.SolverState | None
) -> solver.SolverState:
    """Phase-matched warm start: primal (and t) chain within the step; duals
    come from the same phase's end state at the previous control step."""
    if carry is None:
        return chain
    return solver.SolverState(chain.x, chain.t, carry.y_tree, carry.y_sla, carry.y_imp)


# ---------------------------------------------------------------------------
# exact feasibility repair
# ---------------------------------------------------------------------------


def repair(x: torch.Tensor, ap: AllocProblem, n_depths: int | None = None) -> torch.Tensor:
    """Project solver output onto exact feasibility for box + tenant-max +
    tree constraints by monotone scale-downs toward ``l``.

    The solver's prox keeps ``x`` in the box exactly; remaining violations
    are O(solver tolerance) overshoots of aggregate rows.  Scale-downs never
    violate box bounds (caps >= subtree minimums is validated at build) and
    processing tree levels top-down cannot re-violate an ancestor.
    """
    if n_depths is None:
        n_depths = ap.n_tree_depths()
    l = ap.l
    n = x.shape[0]
    # -- tenant upper bounds --
    if ap.sla.k > 0:
        sums = sla_matvec(x, ap.sla)
        lmin = sla_matvec(l, ap.sla)
        hi = torch.where(torch.isfinite(ap.sla.hi), ap.sla.hi, INF)
        over = sums > hi
        denom = torch.clamp_min(sums - lmin, 1e-30)
        fac_t = torch.where(over, torch.clamp_min(hi - lmin, 0.0) / denom, 1.0)
        # per-device factor: min over covering tenants
        fac_dev = torch.ones_like(x).scatter_reduce_(
            0, ap.sla.dev, fac_t[ap.sla.ten], reduce="amin"
        )
        x = l + (x - l) * fac_dev
    # -- tree caps, one level at a time (ranges at equal depth are disjoint) --
    tree = ap.tree
    lmin_node = tree_matvec(l, tree)
    for d in range(n_depths):
        level = tree.depth == d
        sums = tree_matvec(x, tree)
        over = level & (sums > tree.cap)
        denom = torch.clamp_min(sums - lmin_node, 1e-30)
        fac_node = torch.where(
            over, torch.clamp_min(tree.cap - lmin_node, 0.0) / denom, 1.0
        )
        # broadcast factors onto (disjoint) ranges via a difference array
        diff = x.new_zeros(n + 1)
        diff.index_add_(0, tree.start, fac_node - 1.0)
        diff.index_add_(0, tree.end, -(fac_node - 1.0))
        fac_dev = 1.0 + torch.cumsum(diff, 0)[:n]
        x = l + (x - l) * fac_dev
    return torch.clamp(x, ap.l, ap.u)


# ---------------------------------------------------------------------------
# saturation detection (Algorithm 2, line 5)
# ---------------------------------------------------------------------------


def saturated_mask(
    x: torch.Tensor, ap: AllocProblem, opt_mask: torch.Tensor, tol: float = SAT_TOL
) -> torch.Tensor:
    """Devices in ``opt_mask`` with no positive slack to receive more power:
    at their own upper bound, under a tight PDN node, or in a tenant whose
    upper budget is tight."""
    at_u = ap.u - x <= tol
    tree_slack = ap.tree.cap - tree_matvec(x, ap.tree)
    tight_tree = (tree_slack <= tol).to(x.dtype)
    under_tight = tree_rmatvec(tight_tree, ap.tree, x.shape[0]) > 0.5
    if ap.sla.k > 0:
        sla_slack = torch.where(
            torch.isfinite(ap.sla.hi), ap.sla.hi - sla_matvec(x, ap.sla), INF
        )
        tight_sla = (sla_slack <= tol).to(x.dtype)
        in_tight_sla = sla_rmatvec(tight_sla, ap.sla, x.shape[0]) > 0.5
    else:
        in_tight_sla = torch.zeros_like(at_u)
    return opt_mask & (at_u | under_tight | in_tight_sla)


# ---------------------------------------------------------------------------
# step-problem builders
# ---------------------------------------------------------------------------


def _boxes(ap: AllocProblem, pinned: torch.Tensor, pin_val: torch.Tensor):
    lo = torch.where(pinned, pin_val, ap.l)
    hi = torch.where(pinned, pin_val, ap.u)
    return lo, hi


def _scalar(like: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full((), value, dtype=like.dtype, device=like.device)


def qp_step(
    ap: AllocProblem,
    a_cur: torch.Tensor,
    mask_a: torch.Tensor,
    mask_f: torch.Tensor,
    eps: float,
    pin_free: bool = False,
) -> StepProblem:
    """Phase I level QP (eq. 4): track requests on A, regularize L to l,
    pin F at previously-determined values.

    ``pin_free=True`` applies the paper's simplification for fleets with no
    tenant lower-bound SLAs: devices in L are fixed at ``l`` and the
    eps-regularizer is dropped (section 4.3.1).
    """
    mask_l = ~(mask_a | mask_f)
    ws2 = ap.weight_scale**2
    if pin_free:
        w = torch.where(mask_a, ws2, 0.0)
    else:
        w = torch.where(mask_a, ws2, torch.where(mask_l, eps * ws2, 0.0))
    target = torch.where(mask_a, ap.r, ap.l)
    pinned = mask_f | (mask_l if pin_free else torch.zeros_like(mask_f))
    pin_val = torch.where(mask_f, a_cur, ap.l)
    lo, hi = _boxes(ap, pinned, pin_val)
    return StepProblem(
        w=w,
        target=target,
        c=torch.zeros_like(ap.l),
        c_t=_scalar(ap.l, 0.0),
        lo=lo,
        hi=hi,
        t_lo=_scalar(ap.l, 0.0),
        t_hi=_scalar(ap.l, 0.0),
        tree_hi=ap.tree.cap,
        sla_lo=ap.sla.lo,
        sla_hi=ap.sla.hi,
        imp_lo=torch.full_like(ap.l, -INF),
    )


def lp_step(
    ap: AllocProblem,
    base: torch.Tensor,
    mask_a: torch.Tensor,
    mask_f: torch.Tensor,
    mask_free: torch.Tensor,
    eps: float,
) -> StepProblem:
    """Phase II/III max-min LP (eqs. 5/6): ``max t + eps*sum_A a - eps*sum_L a``
    with ``a_i - base_i >= t`` on A, F pinned at ``base``."""
    zeros = torch.zeros_like(ap.l)
    # explicit tensors: torch.where on Python scalars would build float32
    c = torch.where(
        mask_a,
        torch.full_like(ap.l, -eps),
        torch.where(mask_free, torch.full_like(ap.l, eps), zeros),
    )
    lo, hi = _boxes(ap, mask_f, base)
    # max-min raise can never exceed the largest device range
    t_hi = torch.max(ap.u - ap.l)
    return StepProblem(
        w=zeros,
        target=zeros,
        c=c,
        c_t=_scalar(ap.l, -1.0),
        lo=lo,
        hi=hi,
        t_lo=_scalar(ap.l, 0.0),
        t_hi=t_hi,
        tree_hi=ap.tree.cap,
        sla_lo=ap.sla.lo,
        sla_hi=ap.sla.hi,
        imp_lo=torch.where(mask_a, base, -INF),
    )


# ---------------------------------------------------------------------------
# phase drivers
# ---------------------------------------------------------------------------


def _zeros_state(ap: AllocProblem) -> solver.SolverState:
    return solver.SolverState.zeros(ap.n, ap.tree.m, ap.sla.k, ap.l.dtype, ap.l.device)


def phase1(
    ap: AllocProblem,
    opts: solver.SolverOptions,
    eps: float = 1e-5,
    warm: solver.SolverState | None = None,
) -> tuple[torch.Tensor, solver.SolverState, PhaseStats]:
    """Algorithm 1: priority-ordered request satisfaction."""
    state = warm if warm is not None else _zeros_state(ap)
    x = ap.l
    finalized = torch.zeros_like(ap.active)
    levels = ap.priority_levels(active_only=True)
    pin_free = ap.pin_free_ok()
    n_depths = ap.n_tree_depths()
    solves = iters = 0
    conv = cert = True
    maxres = 0.0
    for p in levels:
        mask_a = ap.active & (ap.priority == p)
        prob = qp_step(ap, x, mask_a, finalized, eps, pin_free=pin_free)
        state = solver.SolverState(x, state.t, state.y_tree, state.y_sla, state.y_imp)
        state, stats = solver.solve(prob, ap.tree, ap.sla, state, opts)
        x = repair(state.x, ap, n_depths)
        finalized = finalized | mask_a
        solves += 1
        iters += stats.iterations
        conv &= stats.converged
        cert &= stats.certified
        maxres = max(maxres, float(stats.primal_res))
    return x, state, PhaseStats(solves, iters, conv, maxres, cert)


def run_maxmin_phase(
    ap: AllocProblem,
    x: torch.Tensor,
    opt_set: torch.Tensor,
    free_set: torch.Tensor,
    opts: solver.SolverOptions,
    eps: float = 1e-5,
    warm: solver.SolverState | None = None,
    max_rounds: int = MAX_ROUNDS,
    use_waterfill: bool = True,
) -> tuple[torch.Tensor, solver.SolverState, PhaseStats]:
    """Algorithm 2: iterated max-min LP with saturation detection.

    Phase II: ``opt_set`` = active, ``free_set`` = idle.
    Phase III: ``opt_set`` = idle, ``free_set`` = empty (active pinned).

    When no tenant SLAs are present the iterated-LP limit is the
    lexicographic max-min allocation, which the exact water-filling sweep
    computes directly on the host (``use_waterfill=True``).  With SLAs the
    LP path is required — tenant rows couple devices across subtrees.
    """
    if use_waterfill and ap.sla.k == 0:
        x_wf = waterfill_arrays(
            ap.tree.start.cpu().numpy(),
            ap.tree.end.cpu().numpy(),
            ap.tree.cap.cpu().numpy(),
            ap.u.cpu().numpy(),
            x.cpu().numpy(),
            opt_set.cpu().numpy(),
        )
        state = warm if warm is not None else _zeros_state(ap)
        x_wf = torch.as_tensor(x_wf, dtype=ap.l.dtype, device=ap.l.device)
        return x_wf, state, PhaseStats(0, 0, True, 0.0)
    state = warm if warm is not None else _zeros_state(ap)
    zero = _scalar(ap.l, 0.0)
    # Devices with no slack at entry must be frozen before the first round —
    # otherwise they force t* = 0 and the eps-term would distribute surplus
    # arbitrarily instead of max-min fairly.
    mask_a = opt_set & ~saturated_mask(x, ap, opt_set)
    n_depths = ap.n_tree_depths()
    solves = iters = 0
    conv = cert = True
    maxres = 0.0
    for _ in range(max_rounds):
        if not bool(mask_a.any()):
            break
        mask_f = ~(mask_a | free_set)
        prob = lp_step(ap, x, mask_a, mask_f, free_set, eps)
        state = solver.SolverState(x, zero, state.y_tree, state.y_sla, state.y_imp)
        state, stats = solver.solve(prob, ap.tree, ap.sla, state, opts)
        # The dualized improvement rows only guarantee x >= base at
        # convergence; clamp non-free devices to their round-entry value
        # before the repair so a truncated solve cannot undo Phase I.
        x_cand = torch.where(free_set, state.x, torch.maximum(state.x, x))
        x_new = repair(x_cand, ap, n_depths)
        solves += 1
        iters += stats.iterations
        conv &= stats.converged
        cert &= stats.certified
        maxres = max(maxres, float(stats.primal_res))
        sat = saturated_mask(x_new, ap, mask_a)
        t_star = float(state.t)
        no_new_sat = not bool(sat.any())
        x = x_new
        if t_star <= SAT_TOL and no_new_sat:
            break  # no measurable head-room left and nothing to freeze
        mask_a = mask_a & ~sat
    return x, state, PhaseStats(solves, iters, conv, maxres, cert)
