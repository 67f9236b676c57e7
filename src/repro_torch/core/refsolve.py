"""Reference solvers for cross-validation (the paper's solver stack).

The paper solves Phase I with Clarabel (interior-point QP) and Phases II/III
with HiGHS.  scipy's ``linprog`` *is* HiGHS, so the LP reference here is the
paper's own engine; the QP reference uses ``scipy.optimize.minimize``
(trust-constr) on the same constraint set.  The port's
:class:`~repro_torch.core.problem.StepProblem` and topologies are moved to
numpy first, so any device works.  Dense matrices — small/medium n only.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.problem import StepProblem
from repro_torch.core.treeops import SlaTopo, TreeTopo

__all__ = ["dense_constraints", "ref_solve", "HAVE_SCIPY"]

try:
    import scipy.optimize as sopt

    HAVE_SCIPY = True
except ImportError:  # pragma: no cover
    HAVE_SCIPY = False


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def dense_constraints(
    tree: TreeTopo, sla: SlaTopo, n: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense K over z = (x, t) plus row bounds (lo, hi)."""
    start = _np(tree.start)
    end = _np(tree.end)
    cap = _np(tree.cap)
    m = start.shape[0]
    sdev, sten = _np(sla.dev), _np(sla.ten)
    sla_lo, sla_hi = _np(sla.lo), _np(sla.hi)
    k = int(sla_lo.shape[0])
    rows = []
    lo = []
    hi = []
    for j in range(m):
        row = np.zeros(n + 1)
        row[start[j] : end[j]] = 1.0
        rows.append(row)
        lo.append(-np.inf)
        hi.append(float(cap[j]))
    for t in range(k):
        row = np.zeros(n + 1)
        row[sdev[sten == t]] = 1.0
        rows.append(row)
        lo.append(float(sla_lo[t]))
        hi.append(float(sla_hi[t]))
    return np.asarray(rows), np.asarray(lo), np.asarray(hi)


def ref_solve(prob: StepProblem, tree: TreeTopo, sla: SlaTopo) -> np.ndarray:
    """Solve one unified StepProblem with scipy.  Returns z = (x, t)."""
    if not HAVE_SCIPY:  # pragma: no cover
        raise RuntimeError("scipy unavailable")
    n = prob.n
    w = _np(prob.w).astype(np.float64)
    target = _np(prob.target).astype(np.float64)
    c = np.concatenate([_np(prob.c).astype(np.float64), [float(prob.c_t)]])
    lo = np.concatenate([_np(prob.lo).astype(np.float64), [float(prob.t_lo)]])
    hi = np.concatenate([_np(prob.hi).astype(np.float64), [float(prob.t_hi)]])
    K, row_lo, row_hi = dense_constraints(tree, sla, n)
    # improvement rows x_i - t >= imp_lo_i (finite only)
    imp_lo = _np(prob.imp_lo).astype(np.float64)
    fin = np.isfinite(imp_lo)
    if fin.any():
        extra = np.zeros((fin.sum(), n + 1))
        extra[np.arange(fin.sum()), np.nonzero(fin)[0]] = 1.0
        extra[:, n] = -1.0
        K = np.vstack([K, extra]) if K.size else extra
        row_lo = np.concatenate([row_lo, imp_lo[fin]])
        row_hi = np.concatenate([row_hi, np.full(fin.sum(), np.inf)])

    is_lp = not (w > 0).any()
    if is_lp:
        # HiGHS via scipy: minimize c.z s.t. row_lo <= Kz <= row_hi, lo<=z<=hi
        A_ub, b_ub = [], []
        if K.size:
            fin_hi = np.isfinite(row_hi)
            fin_lo = np.isfinite(row_lo)
            A_ub = np.vstack([K[fin_hi], -K[fin_lo]])
            b_ub = np.concatenate([row_hi[fin_hi], -row_lo[fin_lo]])
        res = sopt.linprog(
            c,
            A_ub=A_ub if len(A_ub) else None,
            b_ub=b_ub if len(b_ub) else None,
            bounds=list(zip(lo, hi)),
            method="highs",
        )
        if not res.success:  # pragma: no cover
            raise RuntimeError(f"reference LP failed: {res.message}")
        return res.x

    # QP via trust-constr
    wz = np.concatenate([w, [0.0]])
    tz = np.concatenate([target, [0.0]])

    def f(z):
        return 0.5 * np.sum(wz * (z - tz) ** 2) + c @ z

    def grad(z):
        return wz * (z - tz) + c

    constraints = []
    if K.size:
        constraints.append(sopt.LinearConstraint(K, row_lo, row_hi))
    res = sopt.minimize(
        f,
        x0=np.clip(tz, lo, hi),
        jac=grad,
        bounds=sopt.Bounds(lo, hi),
        constraints=constraints,
        method="trust-constr",
        options={"gtol": 1e-10, "xtol": 1e-12, "maxiter": 3000},
    )
    return res.x
