"""Inter-domain budget coordination: the upper level of the two-level solve.

Between control steps the coordinator redistributes the global supply
across power domains from their aggregate demands — a hot domain borrows
headroom a cold domain is not using (CloudPowerCap's partition-budget
redistribution, arXiv:1403.1289, and the per-domain operation of
fleet-scale capping in arXiv:2010.15388).  The feasible set is exactly the
coordinator tree from :mod:`repro_torch.fleet.partition`: per-domain grant boxes
``[min_draw_k, cap_k]`` plus every above-the-cut capacity row.  That is the
same box + tree geometry as the device-level max-min phases, so it reuses
:func:`repro_torch.core.waterfill.waterfill_arrays` (the numpy copy of the
reference's sweep) — domains are the "devices" of a miniature allocation
problem.  Like the reference's, this is host work over K domains.

Two sweeps per plan:

1. *demand pass* — raise grants max-min fairly toward
   ``min(demand_k, cap_k)``: under global shortage, demand is satisfied
   progressively (small demands fully, large demands capped at the uniform
   water level) instead of proportionally starving small domains;
2. *headroom pass* — distribute whatever supply remains up to each
   domain's own capacity, so per-domain engines keep the paper's
   surplus-redistribution behavior (Phases II/III raise allocations beyond
   requests) and an under-forecast demand spike inside a domain is absorbed
   locally without waiting a coordinator round.

When nothing above the cut binds (``sum(cap_k)`` within every ancestor
cap), the headroom pass raises every grant to ``cap_k`` — each domain gets
its full subtree budget and the fleet solve is exactly the monolithic
solve (parity asserted in ``tests/test_torch_fleet.py``).

With cross-cut tenants (a :class:`repro_torch.fleet.partition.FleetSla` on
the partition), :meth:`BudgetCoordinator.plan_sla` additionally enforces
*tenant entitlements* at the coordinator level every step: each cross-cut
tenant's contractual ``[b_min, b_max]`` is split into per-domain slice
sub-budgets by a small water-filling projection (tenants are the
"nodes" of a one-level forest over their slices), domain grant floors are
raised so every feed simultaneously respects the above-cut caps AND funds
every tenant's minimum, and the excess is split by the existing headroom
pass.  The sub-budgets are handed to the per-domain engines as ordinary
SLA boxes, keeping contract enforcement on the per-step hot path rather
than as an offline admission test (cf. CloudPowerCap's coordinator-level
reconciliation, arXiv:1403.1289).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.treeops import TreeTopo
from repro_torch.core.waterfill import waterfill_arrays, waterfill_torch
from repro_torch.fleet.partition import FleetPartition, FleetSla
from repro_torch.obs import spans
from repro_torch.pdn.tree import check_caps_fund_minimums

__all__ = ["BudgetCoordinator", "check_tenants_deliverable", "split_entitlements"]


def check_tenants_deliverable(
    sla: FleetSla,
    slice_floor: np.ndarray,
    slice_umax: np.ndarray,
    tol: float = 1e-9,
) -> None:
    """Every cross-cut tenant's contract must be deliverable by its slices:
    ``sum(umax) >= b_min`` (the minimum can be funded at all) and
    ``sum(floor) <= b_max`` (the slices' own floors do not bust the
    maximum).  Shared by the per-step plan and by every orchestrator
    mutation path (churn, derates, grant changes), so violations surface at
    the mutation boundary, not one step later."""
    csf = np.concatenate([[0.0], np.cumsum(np.asarray(slice_floor, np.float64))])
    csu = np.concatenate([[0.0], np.cumsum(np.asarray(slice_umax, np.float64))])
    floor_t = csf[sla.ten_end] - csf[sla.ten_start]
    umax_t = csu[sla.ten_end] - csu[sla.ten_start]
    b_min_t = sla.b_min[sla.cross_ids]
    b_max_t = sla.b_max[sla.cross_ids]
    bad = np.nonzero(umax_t < b_min_t - tol)[0]
    if bad.size:
        i = int(bad[0])
        raise ValueError(
            f"cross-cut tenant {int(sla.cross_ids[i])} minimum "
            f"{b_min_t[i]:.1f} W exceeds its slices' deliverable maximum "
            f"{umax_t[i]:.1f} W; restore devices or relax the SLA"
        )
    bad = np.nonzero(floor_t > b_max_t + tol)[0]
    if bad.size:
        i = int(bad[0])
        raise ValueError(
            f"cross-cut tenant {int(sla.cross_ids[i])} slice floors "
            f"{floor_t[i]:.1f} W exceed its contractual maximum "
            f"{b_max_t[i]:.1f} W"
        )


def _sweep(base, forest: TreeTopo, u):
    """The water-fill over a forest of tenants (every slice optimized)."""
    return waterfill_torch(base, torch.ones(base.shape[-1], dtype=torch.bool), forest, u)


def split_entitlements(
    sla: FleetSla,
    slice_floor: np.ndarray,
    slice_umax: np.ndarray,
    slice_demand: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Split every cross-cut tenant's ``[b_min, b_max]`` into per-slice
    sub-budgets ``[lo_s, hi_s]`` (three water-filling sweeps over the forest
    whose nodes are the tenants and whose devices are their slices).

    Guarantees, per cross-cut tenant ``t`` with slices ``S_t``:

    * ``floor_s <= lo_s <= hi_s <= umax_s`` for every slice;
    * ``sum(lo_s) = max(b_min_t, sum(floor_s))`` (clipped at what the
      slices can deliver) — so domains that enforce their slice ``lo``
      jointly honor the tenant's contractual minimum;
    * ``sum(hi_s) = min(b_max_t, sum(umax_s))`` — so domains that cap at
      their slice ``hi`` jointly honor the contractual maximum, with the
      budget steered toward the slices that request it (``slice_demand``).

    The reference sweeps with its jitted ``waterfill_jax``; the port sweeps
    with its twin, :func:`repro_torch.core.waterfill.waterfill_torch`, on
    the CPU in float64 (a few dozen slices: host work, like the rest of the
    coordinator).  That sweep also freezes the node whose rate set a
    round's raise, which the reference's does not; on the forests of
    ``tests/test_torch_fleet_sla.py`` (8 slices of 2 tenants, 200 random
    draws) it gives the reference's split bit for bit, as does the numpy
    sweep.
    """
    if sla.n_slices == 0:
        return np.zeros(0), np.zeros(0)

    def vec(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float64)

    floor, umax = vec(slice_floor), vec(slice_umax)
    # the tenants as the roots of a one-level forest over their slices,
    # capped at b_min (minimum split) and at b_max (maximum split)
    zeros = np.zeros(sla.cross_ids.shape[0], np.int64)

    def forest(cap):
        return TreeTopo.make(sla.ten_start, sla.ten_end, cap, zeros, sla.n_slices,
                             dtype=torch.float64, device="cpu")

    forest_min = forest(sla.b_min[sla.cross_ids])
    forest_max = forest(sla.b_max[sla.cross_ids])
    # minimum split: demand-free max-min raise of the slice floors until
    # each tenant row reaches b_min (stable across steps, so churn
    # validation agrees with the next plan exactly)
    lo = _sweep(floor, forest_min, umax)
    # maximum split: demand-shaped first (hot slices get budget), then
    # headroom so the sub-budgets always sum to min(b_max, sum(umax))
    hi = _sweep(lo, forest_max, torch.clamp(vec(slice_demand), lo, umax))
    hi = _sweep(hi, forest_max, umax)
    return lo.numpy(), hi.numpy()


_MODES = ("waterfill", "subtree", "static")


class BudgetCoordinator:
    """Plans per-domain budget grants from per-domain aggregate demand.

    Modes:

    * ``"waterfill"`` (default) — demand pass + headroom pass (see module
      docstring); the production policy.
    * ``"subtree"`` — demand-oblivious: every domain gets its own subtree
      capacity, clipped by the ancestors (headroom pass only).  Matches the
      monolithic solve when nothing above the cut binds.
    * ``"static"`` — equal per-device share of the root feed (the paper's
      Static baseline lifted to domain granularity), clipped to domain
      capacity and ancestor caps.  Benchmark baseline, not a policy.
    """

    def __init__(self, partition: FleetPartition, mode: str = "waterfill"):
        if mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
        self.mode = mode
        self.k = partition.k
        self.start = partition.coord_start.copy()
        self.end = partition.coord_end.copy()
        self.cap = partition.coord_cap.copy()
        self.domain_cap = partition.domain_cap
        # grants below the subtree minimum draw would make the domain's own
        # problem infeasible; the partition's PDN validation guarantees the
        # coordinator tree can fund all minimums simultaneously
        self.domain_min = np.array(
            [d.pdn.subtree_min_power()[0] for d in partition.domains]
        )
        self.domain_n = np.array([d.n for d in partition.domains], np.int64)

    def _fill(self, base: np.ndarray, u: np.ndarray, cap: np.ndarray) -> np.ndarray:
        return waterfill_arrays(
            self.start, self.end, cap, u, base, np.ones(self.k, bool)
        )

    @spans.traced("coordinator.plan")
    def plan(
        self,
        demand: np.ndarray,
        *,
        domain_cap: np.ndarray | None = None,
        coord_cap: np.ndarray | None = None,
        domain_min: np.ndarray | None = None,
        domain_n: np.ndarray | None = None,
    ) -> np.ndarray:
        """[K] aggregate demand (watts) -> [K] budget grants (watts).

        ``domain_cap``/``coord_cap`` override the partition-time capacities
        (brownout: a domain feed or the utility feed derated this step);
        ``domain_min`` overrides the per-domain minimum draw and
        ``domain_n`` the per-domain device counts (device churn or a domain
        rebuild changed them).  Grants always satisfy
        ``min_k <= grant_k <= cap_k`` and every coordinator-tree row.
        """
        demand = np.asarray(demand, np.float64)
        if demand.shape != (self.k,):
            raise ValueError(f"demand shape {demand.shape} != ({self.k},)")
        dcap = self.domain_cap if domain_cap is None else np.asarray(domain_cap)
        ccap = self.cap if coord_cap is None else np.asarray(coord_cap)
        dmin = self.domain_min if domain_min is None else np.asarray(domain_min)
        dn = self.domain_n if domain_n is None else np.asarray(domain_n)
        return self._grants(demand, dmin, dcap, ccap, dn)

    def _grants(
        self,
        demand: np.ndarray,
        dmin: np.ndarray,
        dcap: np.ndarray,
        ccap: np.ndarray,
        dn: np.ndarray,
    ) -> np.ndarray:
        """Demand + headroom waterfill passes over validated floors."""
        if (dmin > dcap + 1e-9).any():
            k = int(np.nonzero(dmin > dcap + 1e-9)[0][0])
            raise ValueError(
                f"domain {k} minimum draw {dmin[k]:.1f} W exceeds its "
                f"(possibly derated) capacity {dcap[k]:.1f} W; mask devices "
                "out first (FleetLifecycle.device_leave)"
            )
        # the floor itself must fit under every coordinator row, else the
        # waterfill would return grants that silently violate the feed
        check_caps_fund_minimums(
            self.start, self.end, ccap, dmin, what="coordinator row"
        )
        grants = dmin.copy()
        if self.mode == "waterfill":
            grants = self._fill(grants, np.clip(demand, dmin, dcap), ccap)
        elif self.mode == "static":
            share = ccap[0] / max(int(dn.sum()), 1)
            grants = self._fill(grants, np.clip(share * dn, dmin, dcap), ccap)
            return grants  # static never redistributes leftover headroom
        # headroom pass (waterfill + subtree modes)
        grants = self._fill(grants, dcap, ccap)
        return grants

    @spans.traced("coordinator.plan_sla")
    def plan_sla(
        self,
        demand: np.ndarray,
        *,
        sla: FleetSla,
        slice_floor: np.ndarray,
        slice_umax: np.ndarray,
        slice_demand: np.ndarray,
        local_lift: np.ndarray | None = None,
        domain_cap: np.ndarray | None = None,
        coord_cap: np.ndarray | None = None,
        domain_min: np.ndarray | None = None,
        domain_n: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Budget rebalance WITH tenant entitlement rows (the SLA hot path).

        Returns ``(grants, slice_lo, slice_hi)``: per-domain budget grants
        plus per-slice sub-budgets for every cross-cut tenant (see
        :func:`split_entitlements`).  ``slice_floor``/``slice_umax``/
        ``slice_demand`` are the current per-slice aggregates (sums of the
        slice devices' ``l``/``u``/shaped requests); ``local_lift`` is each
        domain's extra minimum draw from its *domain-local* tenant minimums
        (``sum_t max(b_min_t - floor_t, 0)``).

        Domain grant floors are raised by the tenant lifts, so the returned
        grants simultaneously respect every above-cut capacity row and fund
        every cross-cut tenant's contractual minimum; the excess is split by
        the same demand/headroom passes as the SLA-free plan.  Raises
        ``ValueError`` when a tenant minimum is no longer deliverable (its
        slices' capacity sum fell below ``b_min``, e.g. after masking too
        many of its devices out) or a contractual maximum is below the
        slices' floor sum.
        """
        demand = np.asarray(demand, np.float64)
        if demand.shape != (self.k,):
            raise ValueError(f"demand shape {demand.shape} != ({self.k},)")
        slice_floor = np.asarray(slice_floor, np.float64)
        slice_umax = np.asarray(slice_umax, np.float64)
        slice_demand = np.asarray(slice_demand, np.float64)
        S = sla.n_slices
        for arr, name in (
            (slice_floor, "slice_floor"),
            (slice_umax, "slice_umax"),
            (slice_demand, "slice_demand"),
        ):
            if arr.shape != (S,):
                raise ValueError(f"{name} shape {arr.shape} != ({S},)")
        dcap = self.domain_cap if domain_cap is None else np.asarray(domain_cap)
        ccap = self.cap if coord_cap is None else np.asarray(coord_cap)
        dmin = self.domain_min if domain_min is None else np.asarray(domain_min)
        dn = self.domain_n if domain_n is None else np.asarray(domain_n)
        # per-tenant deliverability before splitting anything
        check_tenants_deliverable(sla, slice_floor, slice_umax)
        slice_lo, slice_hi = split_entitlements(
            sla, slice_floor, slice_umax, slice_demand
        )
        lift = np.zeros(self.k)
        if S:
            np.add.at(lift, sla.slice_domain, slice_lo - slice_floor)
        if local_lift is not None:
            lift = lift + np.asarray(local_lift, np.float64)
        grants = self._grants(demand, dmin + lift, dcap, ccap, dn)
        return grants, slice_lo, slice_hi

    def domain_dirtiness(
        self,
        demand: np.ndarray,
        grants: np.ndarray,
        prev_demand: np.ndarray | None,
        prev_grants: np.ndarray | None,
        *,
        tol: float = 1e-9,
    ) -> np.ndarray:
        """[K] bool: which domains must re-enter the solver this step.

        A domain is *clean* — its frozen allocation can be served without a
        solve — only when both its aggregate demand and its budget grant are
        within ``tol`` watts of the anchor step that allocation was solved
        against; with no anchor yet every domain is dirty.  Aggregate
        equality alone cannot prove per-device equality, so the orchestrator
        layers per-device telemetry and SLA-bound checks on top (see
        ``FleetOrchestrator._step_loop``); this helper owns the
        coordinator-visible half of the dirtiness decision.
        """
        demand = np.asarray(demand, np.float64)
        grants = np.asarray(grants, np.float64)
        if demand.shape != (self.k,):
            raise ValueError(f"demand shape {demand.shape} != ({self.k},)")
        if prev_demand is None or prev_grants is None:
            return np.ones(self.k, bool)
        prev_demand = np.asarray(prev_demand, np.float64)
        prev_grants = np.asarray(prev_grants, np.float64)
        return (
            (np.abs(demand - prev_demand) > tol)
            | (np.abs(grants - prev_grants) > tol)
            # NaN anchors (domains never solved) compare False above
            | np.isnan(prev_demand)
            | np.isnan(prev_grants)
        )

    def check(
        self, grants: np.ndarray, coord_cap: np.ndarray | None = None, tol: float = 1e-6
    ) -> None:
        """Assert grants respect every above-the-cut capacity row."""
        ccap = self.cap if coord_cap is None else np.asarray(coord_cap)
        csum = np.concatenate([[0.0], np.cumsum(grants)])
        sums = csum[self.end] - csum[self.start]
        bad = np.nonzero(sums > ccap + tol)[0]
        if bad.size:
            a = int(bad[0])
            raise AssertionError(
                f"coordinator row {a} violated: {sums[a]:.3f} W > "
                f"{ccap[a]:.3f} W"
            )
