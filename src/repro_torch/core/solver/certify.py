"""Certify-first incremental stepping.

Power telemetry is strongly autocorrelated between control intervals, so
before running the PDHG loop one feasibility/optimality pass checks whether
the *carried* solution still solves the new step; if it does, the solve is
skipped in O(matvec).

The certificate has two tiers:

* **full skip** — the carried final allocation is returned unchanged.
  Sound when the binding-set fingerprint is unchanged — same active mask,
  box edges, tree caps and SLA rows within ``certify_tol`` watts — and
  every shaped demand is held within ``certify_tol`` of the anchor value it
  was solved against.  The bar is deliberately exact-match: the max-min
  refinement raises allocations by a *uniform increment over the Phase I
  point* (``lp_step``'s ``a_i - base_i >= t`` rows), so even a device
  holding large surplus has a final allocation that tracks its request
  ~1:1, and a "demand moved but stays under slack" relaxation would be
  unsound (relaxing it once cost a 66 W parity blow-up in the reference).
  The carried point is also passed through the exact repair projection and
  a primal-feasibility residual (one tree matvec, and one tenant matvec
  with tenants, through the CUDA kernels under ``use_pallas_tree``) before
  it is accepted.
* **Phase I skip** — demands are unchanged but tree caps moved (a budget
  grant drifting).  If every changed cap keeps at least ``certify_margin``
  watts of Phase I slack under both its old and new value, the carried
  Phase I point is still optimal and only the Phase II/III refinement
  re-runs against the new caps.

Both tiers are conservative by construction.  The decision flags are 0-d
bool tensors on the problem's device; the callers bring both to the host in
one transfer and branch.  A problem of K lanes (``[K, n]``) is certified
lane by lane: the flags are ``[K, 1]`` columns, its carry has ``[K, ...]``
leaves, and the host decisions are numpy arrays of K entries.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

import numpy as np

from repro_torch.core import phases, treeops
from repro_torch.core.lanes import column, lane_all, lane_max
from repro_torch.core.problem import AllocProblem
from repro_torch.core.solver.options import SolverOptions
from repro_torch.kernels import tree_matvec as tk

__all__ = ["IncrementalCarry", "CertifyDecision", "make_carry", "certify_step", "update_carry"]

# watts: the carried point's largest primal-feasibility violation after the
# repair for a full skip
FEAS_TOL = 1e-7


class IncrementalCarry(NamedTuple):
    """Accepted-step snapshot the certificate is checked against.

    ``r``/``x1``/``lo``/``hi`` are the *anchor* values actually solved
    against — held-demand drift accumulates against the anchor, so a chain
    of skips cannot creep away from the certified point by more than
    ``certify_tol`` in total.
    """

    x1: torch.Tensor  # [n] Phase I allocation of the anchor solve
    x: torch.Tensor  # [n] final feasible allocation
    r: torch.Tensor  # [n] shaped requests the anchor was solved against
    active: torch.Tensor  # [n] bool activity mask
    lo: torch.Tensor  # [n] box lower bounds
    hi: torch.Tensor  # [n] box upper bounds
    cap: torch.Tensor  # [m] tree node caps
    sla_lo: torch.Tensor  # [k] tenant minimums
    sla_hi: torch.Tensor  # [k] tenant caps


class CertifyDecision(NamedTuple):
    """Outcome of one certify pass (0-d tensors on the problem's device)."""

    skip: torch.Tensor  # bool: carried allocation still optimal — skip all
    skip_p1: torch.Tensor  # bool: carried Phase I reusable — re-run II/III only
    x_snap: torch.Tensor  # [n] carried allocation after the repair projection
    feas_res: torch.Tensor  # max primal-feasibility violation of x_snap (watts)

    def flags(self):
        """(skip, skip_p1) on the host, in one transfer: two bools, or with
        K lanes two bool arrays of K entries."""
        if self.skip.ndim:
            skip, skip_p1 = torch.stack([self.skip, self.skip_p1]).reshape(2, -1).cpu().numpy()
            return skip, skip_p1
        skip, skip_p1 = torch.stack([self.skip, self.skip_p1]).tolist()
        return skip, skip_p1


def make_carry(ap: AllocProblem, x1: torch.Tensor, x3: torch.Tensor) -> IncrementalCarry:
    """Snapshot a freshly solved step as the next certify anchor (with K
    lanes shared caps and tenant bounds are repeated per lane; per-lane
    ones, a stacked fleet's, are kept as they are)."""
    lead = ap.l.shape[:-1]

    def per_lane(v):
        return v.expand(lead + v.shape) if lead and v.ndim < ap.l.ndim else v

    return IncrementalCarry(
        x1=x1,
        x=x3,
        r=ap.r,
        active=ap.active,
        lo=ap.l,
        hi=ap.u,
        cap=per_lane(ap.tree.cap),
        sla_lo=per_lane(ap.sla.lo),
        sla_hi=per_lane(ap.sla.hi),
    )


def _tree_sums(x, tree: treeops.TreeTopo, opts: SolverOptions | None):
    """Subtree sums, through the ``tree_matvec`` kernel under
    ``use_pallas_tree`` (the solver loop's routing); the tenant sums take
    their kernel on a card in any case (:func:`treeops.sla_matvec`)."""
    if opts is not None and opts.use_pallas_tree:
        return tk.tree_matvec(x, tree.index)
    return treeops.tree_matvec(x, tree)


def certify_step(
    ap: AllocProblem,
    carry: IncrementalCarry,
    n_depths: int,
    *,
    tol: float,
    margin: float,
    opts: SolverOptions | None = None,
) -> CertifyDecision:
    """One certificate pass of the carried solution against ``ap``.

    ``ap.r`` must already be shaped (clipped to the box, floored for idle
    devices), as the engine and ``AllocProblem.build`` leave it.
    """

    def close(a, b):
        # exact equality first: inf == inf must count as unchanged
        return (a == b) | (torch.abs(a - b) <= tol)

    act_same = lane_all(ap.active == carry.active)
    box_same = lane_all(close(ap.l, carry.lo)) & lane_all(close(ap.u, carry.hi))
    sla_same = lane_all(close(ap.sla.lo, carry.sla_lo)) & lane_all(
        close(ap.sla.hi, carry.sla_hi)
    )
    cap_close = close(ap.tree.cap, carry.cap)
    base_same = act_same & box_same & sla_same

    # demand fingerprint: every shaped request must match its anchor (no
    # sound "surplus-held" relaxation exists, see the module docstring)
    all_held = lane_all(torch.abs(ap.r - carry.r) <= tol)

    # snap: exact repair projection of the carried point against the new
    # problem, then its primal-feasibility residual
    x_snap = phases.repair(carry.x, ap, n_depths)
    snap_ok = lane_max(torch.abs(x_snap - carry.x)) <= margin
    kx = _tree_sums(x_snap, ap.tree, opts)
    feas_res = torch.maximum(
        torch.clamp_min(lane_max(kx - ap.tree.cap), 0.0),
        torch.maximum(
            torch.clamp_min(lane_max(x_snap - ap.u), 0.0),
            torch.clamp_min(lane_max(ap.l - x_snap), 0.0),
        ),
    )
    if ap.sla.k:
        sx = treeops.sla_matvec(x_snap, ap.sla)
        feas_res = torch.maximum(
            feas_res,
            torch.maximum(
                torch.clamp_min(lane_max(ap.sla.lo - sx), 0.0),
                torch.clamp_min(lane_max(sx - ap.sla.hi), 0.0),
            ),
        )
    feas_ok = feas_res <= FEAS_TOL

    skip = base_same & lane_all(cap_close) & all_held & snap_ok & feas_ok

    # Phase I skip tier: frozen demands, caps moved but with Phase I slack
    # >= margin under both the old and the new value
    p1_load = _tree_sums(carry.x1, ap.tree, opts)
    p1_slack_ok = p1_load <= torch.minimum(ap.tree.cap, carry.cap) - margin
    skip_p1 = base_same & all_held & lane_all(cap_close | p1_slack_ok) & ~skip
    return CertifyDecision(skip=skip, skip_p1=skip_p1, x_snap=x_snap, feas_res=feas_res)


def update_carry(
    carry: IncrementalCarry | None,
    ap: AllocProblem,
    x1: torch.Tensor,
    x3: torch.Tensor,
    skipped: bool,
    p1_reused: bool,
) -> IncrementalCarry:
    """Next-step anchor: frozen on a full skip, Phase-I-anchored on a Phase I
    skip (new caps + new final allocation), fresh after a full solve.
    ``skipped``/``p1_reused`` are the host flags of this step's decision
    (with K lanes, bool arrays: each lane's anchor follows its own)."""
    fresh = make_carry(ap, x1, x3)
    if carry is None:
        return fresh
    if isinstance(skipped, np.ndarray):
        anchor = _pick(skipped | p1_reused, carry, fresh)
        final = _pick(skipped, carry, fresh)
        return anchor._replace(x=final.x, active=fresh.active, cap=final.cap,
                               sla_lo=final.sla_lo, sla_hi=final.sla_hi)
    keep_p1 = skipped or p1_reused
    anchor = carry if keep_p1 else fresh
    final = carry if skipped else fresh
    return IncrementalCarry(
        x1=anchor.x1,
        x=final.x,
        r=anchor.r,
        active=fresh.active,
        lo=anchor.lo,
        hi=anchor.hi,
        cap=final.cap,
        sla_lo=final.sla_lo,
        sla_hi=final.sla_hi,
    )


def _pick(mask: np.ndarray, a: IncrementalCarry, b: IncrementalCarry) -> IncrementalCarry:
    """Lane by lane ``a`` where ``mask`` else ``b``."""
    col = column(mask, a.x.device)
    return IncrementalCarry(*(torch.where(col, u, v) for u, v in zip(a, b)))
