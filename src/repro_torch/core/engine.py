"""Persistent allocation engine: construct once per fleet, step many times
without rebuilding.

:class:`AllocEngine` is the serving shape of the allocator.  It is built
once per fleet — PDN tree + tenant SLA topology + priority layout — and
then serves every control step from telemetry alone:

* construction makes everything shape-static: the
  :class:`~repro_torch.core.problem.FleetTopology` device tensors with the
  kernels' index tables (the tree CSR and the tenant CSR), and the
  :class:`~repro_torch.core.batched.BatchMeta` (priority levels from the
  *full* priority layout, tree-depth count, the pin-free simplification);
* :meth:`step` runs the one-scenario program
  (:func:`~repro_torch.core.batched.solve_three_phase`) on telemetry
  pre-processed on the device, warm-started from the previous step;
* deadlines run in iteration space, from a calibrated per-iteration cost.

The reference pins one compiled program and counts its traces
(``trace_count``).  PyTorch runs eagerly, so the port's form of "compile
once" is "build once": :meth:`AllocEngine.rebuild_count` counts the times
this engine built its device topology and index tables.  Re-pins
(:meth:`repin`, :meth:`set_root_cap`, :meth:`set_sla_bounds`,
:meth:`rescale_supply`) swap values — caps, boxes, tenant bounds — on the
built structure and leave the count where it was.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.core import phases
from repro_torch.core.batched import (
    BatchMeta,
    PhaseCostModel,
    active_levels,
    solve_three_phase,
)
from repro_torch.core.nvpax import AllocResult, NvpaxOptions
from repro_torch.core.problem import AllocProblem, FleetTopology
from repro_torch.obs.stats import StepStats
from repro_torch.pdn.tree import FlatPDN, check_caps_fund_minimums

__all__ = ["AllocEngine"]

_UNSET = object()

# an effectively unbounded budget: the full calibration probe runs the
# budgeted program the deadline path serves
_PROBE_FULL_BUDGET = 2**31 - 1


def _engine_solve(fleet: FleetTopology, r, priority, active, warm, iter_budget, *, meta, opts,
                  present):
    """The whole control step: request pre-processing on the device (paper
    section 5.2: clip to the device box, idle devices request ``l``) and the
    three-phase program with its exact feasibility repair."""
    r = torch.where(active, torch.clamp(r, fleet.l, fleet.u), fleet.l)
    ap = AllocProblem(
        l=fleet.l,
        u=fleet.u,
        r=r,
        priority=priority,
        active=active,
        tree=fleet.tree,
        sla=fleet.sla,
        weight_scale=fleet.weight_scale,
    )
    return solve_three_phase(ap, meta, opts, warm, iter_budget, present=present)


class AllocEngine:
    """Construct-once / step-many allocation runtime for one fleet.

    Parameters mirror ``AllocProblem.build``: the PDN, optional tenant SLA
    topology (a :class:`~repro_torch.core.treeops.SlaTopo` or any object
    with host ``dev``/``ten``/``lo``/``hi`` arrays), a fixed priority
    layout and ``NvpaxOptions``.  ``device=None`` means ``cuda``.  ``step``
    takes only telemetry (+ an optional scheduler active mask) and returns
    the same :class:`~repro_torch.core.nvpax.AllocResult` as the host path.
    """

    def __init__(
        self,
        pdn: FlatPDN,
        *,
        sla=None,
        priority: np.ndarray | None = None,
        options: NvpaxOptions | None = None,
        idle_threshold: float = 150.0,
        normalized: bool = False,
        dtype=torch.float64,
        pin_free: bool | None = None,
        recorder=None,
        device=None,
    ):
        if recorder:
            raise NotImplementedError(
                "the flight recorder is not ported yet (ROADMAP Queue 1 item 10)"
            )
        self.options = options or NvpaxOptions()
        if self.options.incremental:
            raise NotImplementedError(
                "incremental=True (certify-first stepping) is not ported yet "
                "(ROADMAP Queue 1 item 9)"
            )
        self.pdn = pdn
        self.idle_threshold = float(idle_threshold)
        self.dtype = dtype
        self.device = resolve_device(device)
        self._rebuilds = 0
        self.fleet = self._build_fleet(sla, normalized)
        if priority is None:
            priority = np.ones((pdn.n,), np.int32)
        self.priority_np = np.asarray(priority, np.int32)
        if (self.priority_np < 1).any():
            raise ValueError("priorities must be >= 1")
        self.priority = torch.as_tensor(self.priority_np, device=self.device)
        if pin_free is None:
            # auto: safe iff no tenant minimum can force a pinned-free device
            # upward.  Callers that raise SLA lower bounds later
            # (set_sla_bounds with lo > 0) must pass False (paper 4.3.1).
            pin_free = self.fleet.sla.k == 0 or not bool(
                (self.fleet.sla.lo.cpu().numpy() > 0).any()
            )
        # levels from the full priority layout, not the per-step active set:
        # a step skips the levels with no active device
        self.meta = BatchMeta(
            levels=tuple(sorted({int(p) for p in self.priority_np}, reverse=True)),
            n_depths=int(pdn.node_depth.max()) + 1 if pdn.m else 0,
            pin_free=pin_free,
            max_rounds=self.options.max_rounds,
            use_waterfill=self.options.use_waterfill,
            run_phase2=self.options.run_phase2,
            run_phase3=self.options.run_phase3,
            eps=self.options.eps,
        )
        # construction-time caps: rescale_supply scales are absolute vs these
        self._node_cap0 = np.asarray(pdn.node_cap, np.float64).copy()
        # host mirrors of the pinned caps and the subtree minimum draws, so
        # set_root_cap needs no device readback and no O(n) revalidation
        self._node_cap_np = self._node_cap0.copy()
        self._subtree_lmin = pdn.subtree_min_power()
        self._warm: phases.WarmCarry | None = None
        self._cost_model: PhaseCostModel | None = None
        self.history: list[dict[str, Any]] = []

    def _build_fleet(self, sla, normalized: bool) -> FleetTopology:
        """Device topology and the kernels' index tables: the one rebuild."""
        fleet = FleetTopology.from_pdn(
            self.pdn, sla=sla, normalized=normalized, dtype=self.dtype, device=self.device
        )
        self._rebuilds += 1
        return fleet

    @property
    def n(self) -> int:
        return self.pdn.n

    def rebuild_count(self) -> int:
        """How many times this engine built its device topology and index
        tables: 1 after construction, unchanged by re-pins."""
        return self._rebuilds

    def reset_warm(self) -> None:
        """Drop carried solver state (the next step cold-starts)."""
        self._warm = None

    def _vec(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64), dtype=self.dtype, device=self.device)

    # -- in-place re-pins (no rebuild) -------------------------------------

    def repin(
        self,
        *,
        dev_l: np.ndarray | None = None,
        dev_u: np.ndarray | None = None,
        node_cap: np.ndarray | None = None,
        reset_warm: bool = True,
    ) -> None:
        """Swap same-shape topology values: device boxes and node caps (a
        left device gets a zero-width ``[0, 0]`` box).  Feasibility (caps >=
        subtree minimum draw) is revalidated on the host.  ``reset_warm``
        drops carried duals — keep it for geometry changes."""
        fleet = self.fleet
        l_np, u_np, cap_np = None, None, self._node_cap_np
        if node_cap is not None:
            cap_np = np.asarray(node_cap, np.float64)
            if cap_np.shape != (self.pdn.m,):
                raise ValueError(f"node_cap shape {cap_np.shape} != ({self.pdn.m},)")
            fleet = fleet._replace(tree=fleet.tree._replace(cap=self._vec(cap_np)))
        if dev_l is not None:
            l_np = np.asarray(dev_l, np.float64)
            if l_np.shape != (self.n,):
                raise ValueError(f"dev_l shape {l_np.shape} != ({self.n},)")
            fleet = fleet._replace(l=self._vec(l_np))
        if dev_u is not None:
            u_np = np.asarray(dev_u, np.float64)
            if u_np.shape != (self.n,):
                raise ValueError(f"dev_u shape {u_np.shape} != ({self.n},)")
            fleet = fleet._replace(u=self._vec(u_np))
        l_np = fleet.l.cpu().numpy() if l_np is None else l_np
        u_np = fleet.u.cpu().numpy() if u_np is None else u_np
        if (l_np < 0).any() or (l_np > u_np + 1e-12).any():
            raise ValueError("device limits must satisfy 0 <= l <= u")
        lmin = check_caps_fund_minimums(
            self.pdn.node_start, self.pdn.node_end, cap_np, l_np, what="re-pinned node"
        )
        self.fleet = fleet
        self._node_cap_np = cap_np
        self._subtree_lmin = lmin
        if reset_warm:
            self.reset_warm()

    def set_root_cap(self, cap: float, *, reset_warm: bool = False) -> None:
        """Re-pin only the root node's capacity (a coordinator's per-step
        budget grant).  Carries warm state by default; validated against
        the cached subtree minimum only."""
        cap = float(cap)
        if cap < self._subtree_lmin[0] - 1e-9:
            raise ValueError(
                f"root cap {cap:.1f} W < sum of device minimums "
                f"{self._subtree_lmin[0]:.1f} W"
            )
        self._node_cap_np = self._node_cap_np.copy()
        self._node_cap_np[0] = cap
        self.fleet = self.fleet._replace(
            tree=self.fleet.tree._replace(cap=self._vec(self._node_cap_np))
        )
        if reset_warm:
            self.reset_warm()

    def set_sla_bounds(self, lo: np.ndarray, hi: np.ndarray, *, reset_warm: bool = False) -> None:
        """Re-pin the tenant SLA aggregate bounds; the incidence and its
        kernel index stay.  Carries warm state by default."""
        lo = np.asarray(lo, np.float64)
        hi = np.asarray(hi, np.float64)
        k = self.fleet.sla.k
        if lo.shape != (k,) or hi.shape != (k,):
            raise ValueError(f"sla bounds shapes {lo.shape}/{hi.shape} != ({k},)")
        if (lo > hi + 1e-9).any():
            raise ValueError("sla bounds must satisfy lo <= hi")
        if self.meta.pin_free and (lo > 0).any():
            # the engine pins free devices at l (paper 4.3.1), which is
            # unsound once a tenant minimum can force them upward
            raise ValueError(
                "engine was built with the pin-free simplification (no positive "
                "SLA lower bounds at construction); rebuild the engine to raise "
                "tenant minimums above zero"
            )
        self.fleet = self.fleet.with_sla_bounds(lo, hi)
        if reset_warm:
            self.reset_warm()

    def rescale_supply(self, scale: float, *, reset_warm: bool = True) -> None:
        """Scale all node capacities to ``scale`` x their construction-time
        values (absolute, not compounding)."""
        self.repin(node_cap=self._node_cap0 * float(scale), reset_warm=reset_warm)

    # -- host-side request pre-processing (numpy, O(n)) --------------------

    def _preprocess(self, telemetry, active):
        req = np.asarray(telemetry, dtype=np.float64)
        if req.shape[-1] != self.n:
            raise ValueError(f"telemetry shape {req.shape} != (..., {self.n})")
        if active is None:
            active = req >= self.idle_threshold
        return req, np.asarray(active, dtype=bool)

    def _solve(self, req, act, warm, budget):
        return _engine_solve(
            self.fleet,
            torch.as_tensor(req, dtype=self.dtype, device=self.device),
            self.priority,
            torch.as_tensor(act, device=self.device),
            warm,
            budget,
            meta=self.meta,
            opts=self.options.solver,
            present=active_levels(self.priority_np, act),
        )

    # -- deadline calibration ----------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _budget(self, deadline_s):
        if deadline_s is _UNSET:
            deadline_s = self.options.deadline_s
        if deadline_s is None:
            return None
        if self._cost_model is None:
            self._cost_model = self._calibrate()
        # price the budget with the phase mix last served
        mix = None
        if self.history:
            pi = self.history[-1].get("phase_iterations")
            if pi and sum(pi) > 0:
                tot = float(sum(pi))
                mix = (pi[0] / tot, (pi[1] + pi[2]) / tot)
        return self._cost_model.budget(float(deadline_s), mix)

    def _calibrate(self) -> PhaseCostModel:
        """Per-phase seconds per PDHG iteration of this engine's step: a
        Phase-I-only probe (budget 1) and a full probe on neutral telemetry
        (every device requesting its maximum), each timed on its second run
        and ending in a device synchronize.  Estimates include per-solve
        overhead, so deadline budgets err short."""
        req, act = self._preprocess(np.asarray(self.pdn.dev_u, np.float64), None)

        def probe(budget: int):
            self._solve(req, act, None, budget)
            self._sync()
            t0 = time.perf_counter()
            out = self._solve(req, act, None, budget)
            self._sync()
            wall = time.perf_counter() - t0
            return wall, [int(out[4][f"iterations_p{i}"]) for i in (1, 2, 3)]

        wall1, phases1 = probe(1)
        wall_f, phases_f = probe(_PROBE_FULL_BUDGET)
        return PhaseCostModel.fit(wall1, phases1, wall_f, phases_f)

    # -- control steps -------------------------------------------------------

    def step(
        self,
        telemetry: np.ndarray,
        *,
        active: np.ndarray | None = None,
        deadline_s: float | None = _UNSET,  # type: ignore[assignment]
    ) -> AllocResult:
        """One control step: telemetry [n] watts -> allocation (caps), warm
        started from the previous step.  Returns host numpy arrays."""
        req, act = self._preprocess(telemetry, active)
        budget = self._budget(deadline_s)
        t0 = time.perf_counter()
        x1, x2, x3, warm, stats = self._solve(req, act, self._warm, budget)
        allocation = x3.cpu().numpy()  # waits for the device
        wall = time.perf_counter() - t0
        self._warm = warm
        res = AllocResult(
            allocation=allocation,
            phase1=x1.cpu().numpy(),
            phase2=x2.cpu().numpy(),
            warm_state=warm,
            wall_time_s=wall,
            stats=StepStats.from_tensors(stats, iter_budget=budget),
        )
        self.history.append(
            {
                "wall_s": wall,
                "converged": res.stats["converged"],
                "solves": res.stats["total_solves"],
                "iterations": res.stats["total_iterations"],
                "phase_iterations": res.stats["phase_iterations"],
                "truncated": res.stats["truncated"],
                "skipped": res.stats["skipped"],
            }
        )
        return res

    def step_batched(self, telemetry_batch, **kw):
        raise NotImplementedError(
            "step_batched (K scenarios in one solve) is not ported yet "
            "(ROADMAP Queue 1 item 8b)"
        )
