"""Termination criteria: KKT certification, primal feasibility, and the
no-progress / optimal-vertex certificate.

* **KKT certified** — primal residual, dual residual and complementarity all
  below tolerance in the original metric (tolerances mean watts).

* **Optimal vertex reached** (:func:`polish_t` + the no-progress counter in
  the loop) — on degenerate max-min LPs the primal lands on the optimal
  vertex while the duals tug-of-war and the KKT residuals stop moving.  When
  the primal iterate has been motionless for ``noprogress_patience``
  consecutive checks and the t-polished point is primal-feasible, the solver
  exits with ``converged=True, certified=False``.  ``t`` is exact at the
  exit: given the settled ``x``, the max-min LP's optimal scalar is
  ``clip(min_i(x_i - imp_lo_i), t_lo, t_hi)`` in closed form.

All results are 0-d tensors on the solve's device, or ``[K, 1]`` lane
columns for a step problem of K lanes.
"""

from __future__ import annotations

import torch

from repro_torch.core.lanes import lane_any, lane_max, lane_min, lane_sum
from repro_torch.core.problem import StepProblem
from repro_torch.core.solver.options import SolverState
from repro_torch.core.treeops import (
    SlaTopo,
    TreeTopo,
    sla_matvec,
    sla_rmatvec,
    tree_matvec,
    tree_rmatvec,
)

__all__ = ["kkt_residuals", "primal_residual", "polish_t"]

_INF = float("inf")


def _viol(kx, lo, hi):
    return torch.clamp_min(torch.maximum(kx - hi, lo - kx), 0.0)


def _pmax(v):
    if v.shape[-1]:
        return lane_max(v)
    return v.new_zeros(v.shape[:-1] + (1,) if v.ndim > 1 else ())


def kkt_residuals(state: SolverState, prob: StepProblem, tree: TreeTopo, sla: SlaTopo):
    """(primal, dual, complementarity) infinity-norm residuals, relative.

    ``state`` holds original-space primal and duals.
    """
    n = prob.n
    x, t = state.x, state.t
    yt, ys, yi = state.y_tree, state.y_sla, state.y_imp

    kx_tree = tree_matvec(x, tree)
    kx_sla = sla_matvec(x, sla)
    kx_imp = x - t

    p_tree = _viol(kx_tree, -_INF, prob.tree_hi)
    p_sla = _viol(kx_sla, prob.sla_lo, prob.sla_hi) if sla.k else x.new_zeros(0)
    p_imp = _viol(kx_imp, prob.imp_lo, _INF)

    primal = torch.maximum(torch.maximum(_pmax(p_tree), _pmax(p_sla)), _pmax(p_imp))
    p_scale = 1.0 + torch.maximum(
        lane_max(torch.abs(kx_tree)),
        lane_max(torch.abs(kx_imp)),
    )

    # dual stationarity on x: s = w (x - target) + c + K^T y, projected on box
    gx = tree_rmatvec(yt, tree, n) + sla_rmatvec(ys, sla, n) + yi
    gt = -lane_sum(yi)
    s = prob.w * (x - prob.target) + prob.c + gx
    tol = 1e-9 * (1.0 + torch.abs(prob.hi))
    at_lo = x <= prob.lo + tol
    at_hi = x >= prob.hi - tol
    dual_x = torch.where(
        at_lo & at_hi,
        0.0,  # pinned variable: any multiplier works
        torch.where(
            at_lo,
            torch.clamp_min(-s, 0.0),
            torch.where(at_hi, torch.clamp_min(s, 0.0), torch.abs(s)),
        ),
    )
    s_t = prob.c_t + gt
    t_at_lo = t <= prob.t_lo + 1e-12
    t_at_hi = t >= prob.t_hi - 1e-12
    dual_t = torch.where(
        t_at_lo & t_at_hi,
        0.0,
        torch.where(
            t_at_lo,
            torch.clamp_min(-s_t, 0.0),
            torch.where(t_at_hi, torch.clamp_min(s_t, 0.0), torch.abs(s_t)),
        ),
    )
    dual = torch.maximum(lane_max(dual_x), dual_t)
    d_scale = (
        1.0
        + lane_max(torch.abs(prob.w * (x - prob.target) + prob.c))
        + lane_max(torch.abs(gx))
    )

    # complementarity: y+ pairs with hi slack, y- with lo slack.  Slack is
    # clamped to the primal scale so rows with effectively-unbounded caps
    # (slack >> |Kx|) don't demand y == 0 to machine precision.
    def _comp(y, kx, lo, hi):
        if y.shape[-1] == 0:
            return _pmax(y)
        slack_cap = 1.0 + torch.abs(kx)
        hi_slack = torch.where(
            torch.isfinite(hi),
            torch.minimum(torch.clamp_min(hi - kx, 0.0), slack_cap),
            0.0,
        )
        lo_slack = torch.where(
            torch.isfinite(lo),
            torch.minimum(torch.clamp_min(kx - lo, 0.0), slack_cap),
            0.0,
        )
        c = torch.clamp_min(y, 0.0) * hi_slack + torch.clamp_min(-y, 0.0) * lo_slack
        return lane_max(c)

    comp = torch.maximum(
        torch.maximum(
            _comp(yt, kx_tree, torch.full_like(prob.tree_hi, -_INF), prob.tree_hi),
            _comp(ys, kx_sla, prob.sla_lo, prob.sla_hi),
        ),
        _comp(yi, kx_imp, prob.imp_lo, torch.full_like(prob.imp_lo, _INF)),
    )
    c_scale = p_scale * (
        1.0 + torch.maximum(lane_max(torch.abs(yt)), lane_max(torch.abs(yi)))
    )
    return primal / p_scale, dual / d_scale, comp / c_scale


def primal_residual(x, t, prob: StepProblem, tree: TreeTopo, sla: SlaTopo):
    """Relative primal (feasibility) residual alone, same scaling as
    :func:`kkt_residuals` — the certificate test for a polished iterate."""
    kx_tree = tree_matvec(x, tree)
    kx_sla = sla_matvec(x, sla)
    kx_imp = x - t
    primal = torch.maximum(
        torch.maximum(
            _pmax(_viol(kx_tree, -_INF, prob.tree_hi)),
            _pmax(_viol(kx_sla, prob.sla_lo, prob.sla_hi)) if sla.k else _pmax(kx_sla),
        ),
        _pmax(_viol(kx_imp, prob.imp_lo, _INF)),
    )
    p_scale = 1.0 + torch.maximum(
        lane_max(torch.abs(kx_tree)), lane_max(torch.abs(kx_imp))
    )
    return primal / p_scale


def polish_t(x, t, prob: StepProblem):
    """Exact epigraph polish: the largest feasible ``t`` given ``x``.

    ``t`` appears only in the improvement rows ``x_i - t >= imp_lo_i`` and
    its own box, so given the primal the optimum of the max-min objective
    (``c_t < 0``) over ``t`` alone is closed-form.  Returns ``t`` unchanged
    when ``t`` is pinned (QP phases) or no improvement row is live.
    """
    fin = torch.isfinite(prob.imp_lo)
    any_fin = lane_any(fin)
    t_max = lane_min(torch.where(fin, x - prob.imp_lo, _INF))
    t_new = torch.clamp(t_max, prob.t_lo, prob.t_hi)
    movable = (prob.t_hi - prob.t_lo > 0) & any_fin & (prob.c_t < 0)
    return torch.where(movable, t_new, t)
