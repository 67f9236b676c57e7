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
  pre-processed on the device, warm-started from the previous step, and
  with ``NvpaxOptions(incremental=True)`` certified first against the last
  accepted step's anchor (:mod:`repro_torch.core.solver.certify`);
* :meth:`step_batched` runs K scenarios as one solve
  (:func:`~repro_torch.core.batched.optimize_batched`), with its own warm
  carry and incremental anchor per batch size K;
* deadlines run in iteration space, from a calibrated per-iteration cost;
* with ``recorder=`` every step appends one row per lane to a flight record
  on the device (:mod:`repro_torch.obs.recorder`), updated in place.

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
    BatchedAllocResult,
    BatchMeta,
    PhaseCostModel,
    active_levels,
    optimize_batched,
    solve_three_phase,
)
from repro_torch.core.nvpax import AllocResult, NvpaxOptions
from repro_torch.core.problem import AllocProblem, FleetTopology
from repro_torch.core.solver import certify
from repro_torch.obs import recorder as obs_recorder
from repro_torch.obs.stats import StepStats
from repro_torch.pdn.tree import FlatPDN, check_caps_fund_minimums

__all__ = ["AllocEngine"]

_UNSET = object()

# an effectively unbounded budget: the full calibration probe runs the
# budgeted program the deadline path serves
_PROBE_FULL_BUDGET = 2**31 - 1


def _engine_solve(fleet: FleetTopology, r, priority, active, warm, iter_budget, carry=None,
                  rec=None, *, meta, opts, present, rec_cfg=None):
    """The whole control step: request pre-processing on the device (paper
    section 5.2: clip to the device box, idle devices request ``l``), the
    certify-first gate when a ``carry`` is given, the three-phase program
    with its exact feasibility repair and, given ``rec`` and ``rec_cfg``,
    the flight-record append (in place).  Returns the program's
    ``(x1, x2, x3, warm, stats)`` and the next incremental anchor."""
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
    x1, x2, x3, sol, stats = solve_three_phase(
        ap, meta, opts, warm, iter_budget, carry, present=present
    )
    new_carry = certify.update_carry(
        carry, ap, x1, x3, stats["skipped"], stats["certify_pass"] and not stats["skipped"]
    )
    if rec is not None and rec_cfg is not None:
        # idle devices request l by shaping; zero them out of the
        # satisfaction denominator (they have no demand to satisfy)
        obs_recorder.record(rec_cfg, rec, stats, x3, torch.where(active, r, 0.0), fleet.sla)
    return x1, x2, x3, sol, stats, new_carry


class AllocEngine:
    """Construct-once / step-many allocation runtime for one fleet.

    Parameters mirror ``AllocProblem.build``: the PDN, optional tenant SLA
    topology (a :class:`~repro_torch.core.treeops.SlaTopo` or any object
    with host ``dev``/``ten``/``lo``/``hi`` arrays), a fixed priority
    layout and ``NvpaxOptions``.  ``device=None`` means ``cuda``.  ``step``
    takes only telemetry (+ an optional scheduler active mask) and returns
    the same :class:`~repro_torch.core.nvpax.AllocResult` as the host path.
    ``recorder`` (True, or a :class:`~repro_torch.obs.recorder.RecorderConfig`
    for the ring's shape) turns on the flight recorder; drain it with
    :meth:`flush_recorder`.
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
        self.options = options or NvpaxOptions()
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
            certify_tol=self.options.certify_tol,
            certify_margin=self.options.certify_margin,
        )
        # construction-time caps: rescale_supply scales are absolute vs these
        self._node_cap0 = np.asarray(pdn.node_cap, np.float64).copy()
        # host mirrors of the pinned caps and the subtree minimum draws, so
        # set_root_cap needs no device readback and no O(n) revalidation
        self._node_cap_np = self._node_cap0.copy()
        self._subtree_lmin = pdn.subtree_min_power()
        self._warm: phases.WarmCarry | None = None
        # the incremental (certify-first) anchor, carried only when
        # options.incremental — see repro_torch.core.solver.certify
        self._inc_carry: certify.IncrementalCarry | None = None
        self._cost_model: PhaseCostModel | None = None
        # the K-scenario path's warm carry and incremental anchor, per K
        self._batched_warm: dict[int, phases.WarmCarry] = {}
        self._inc_batched_carry: dict[int, certify.IncrementalCarry] = {}
        # the flight recorder: made on the first step of each path (step()
        # keeps one lane, step_batched one [K, ...] state per batch size)
        if recorder is True:
            recorder = obs_recorder.RecorderConfig()
        self._rec_cfg: obs_recorder.RecorderConfig | None = recorder or None
        self._rec_state: obs_recorder.RecorderState | None = None
        self._rec_batched: dict[int, obs_recorder.RecorderState] = {}
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
        """Drop carried solver state and the incremental anchors, of
        :meth:`step` and of :meth:`step_batched` (the next step cold-starts
        and certifies nothing).  The flight record is telemetry, not solver
        state: it stays."""
        self._warm = None
        self._inc_carry = None
        self._batched_warm.clear()
        self._inc_batched_carry.clear()

    def _vec(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64), dtype=self.dtype, device=self.device)

    # -- flight recorder -----------------------------------------------------

    @property
    def recorder_config(self) -> obs_recorder.RecorderConfig | None:
        return self._rec_cfg

    def flush_recorder(self, *, reset: bool = False) -> dict[str, Any] | None:
        """The flight record(s) as host numpy (the recorder's only transfer
        to the host): ``{"step": flush, "batched": {K: [per-lane flushes]}}``
        with a key only for the paths that stepped; ``None`` when the engine
        was built without a recorder.  ``reset`` drops the records after."""
        if self._rec_cfg is None:
            return None
        out: dict[str, Any] = {}
        if self._rec_state is not None:
            out["step"] = obs_recorder.flush(self._rec_state, self._rec_cfg)
        if self._rec_batched:
            out["batched"] = {
                K: obs_recorder.flush_lanes(st, self._rec_cfg)
                for K, st in self._rec_batched.items()
            }
        if reset:
            self._rec_state = None
            self._rec_batched.clear()
        return out

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

    def _solve(self, req, act, warm, budget, carry=None, rec=None):
        return _engine_solve(
            self.fleet,
            torch.as_tensor(req, dtype=self.dtype, device=self.device),
            self.priority,
            torch.as_tensor(act, device=self.device),
            warm,
            budget,
            carry,
            rec,
            meta=self.meta,
            opts=self.options.solver,
            present=active_levels(self.priority_np, act),
            rec_cfg=self._rec_cfg,
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
        started from the previous step and, with ``options.incremental``,
        certified first against the last accepted step (a held step skips
        the solve).  Returns host numpy arrays."""
        req, act = self._preprocess(telemetry, active)
        budget = self._budget(deadline_s)
        incremental = self.options.incremental
        t0 = time.perf_counter()
        if self._rec_cfg is not None and self._rec_state is None:
            self._rec_state = obs_recorder.init_state(self._rec_cfg, self.n, self.dtype,
                                                      self.device)
        # the anchor stays None unless options.incremental
        x1, x2, x3, warm, stats, new_carry = self._solve(
            req, act, self._warm, budget, self._inc_carry, self._rec_state
        )
        allocation = x3.cpu().numpy()  # waits for the device
        wall = time.perf_counter() - t0
        self._warm = warm
        if incremental:
            self._inc_carry = new_carry
        res = AllocResult(
            allocation=allocation,
            phase1=x1.cpu().numpy(),
            phase2=x2.cpu().numpy(),
            warm_state=warm,
            wall_time_s=wall,
            stats=StepStats.from_tensors(stats, iter_budget=budget),
            carry=new_carry if incremental else None,
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

    def step_batched(
        self,
        telemetry_batch: np.ndarray,
        *,
        active: np.ndarray | None = None,
        carry_warm: bool = True,
    ) -> BatchedAllocResult:
        """K scenarios in one solve, warm-carried across steps.

        ``telemetry_batch`` is ``[K, n]`` watts; ``active`` is ``[n]``
        (shared placement) or ``[K, n]``.  The batched solver state is
        carried per batch size K across consecutive calls (``carry_warm``),
        and with ``options.incremental`` so is the per-lane certify anchor;
        disable it for independent what-if sweeps.  ``options.deadline_s``
        is honoured via the batched iteration-budget mode.  Does not touch
        :meth:`step`'s state or history.
        """
        tb = np.asarray(telemetry_batch, dtype=np.float64)
        if tb.ndim != 2 or tb.shape[0] == 0:
            raise ValueError(f"telemetry_batch must be [K, n] with K >= 1, got {tb.shape}")
        K, n = tb.shape
        if n != self.n:
            raise ValueError(f"telemetry_batch n {n} != fleet n {self.n}")
        if active is not None:
            active = np.asarray(active, bool)
            if active.shape == (n,):
                active = np.broadcast_to(active, (K, n))
            elif active.shape != (K, n):
                raise ValueError(f"active must be [{n}] or [{K}, {n}], got {active.shape}")
        req, act = self._preprocess(tb, active)
        fl = self.fleet
        act_dev = torch.as_tensor(np.ascontiguousarray(act), device=self.device)
        r = torch.as_tensor(req, dtype=self.dtype, device=self.device)

        def lanes(v):
            return v.expand(K, n).contiguous()

        stacked = AllocProblem(
            l=lanes(fl.l),
            u=lanes(fl.u),
            r=torch.where(act_dev, torch.clamp(r, fl.l, fl.u), fl.l),
            priority=lanes(self.priority),
            active=act_dev,
            tree=fl.tree,
            sla=fl.sla,
            weight_scale=lanes(fl.weight_scale),
        )
        incremental = self.options.incremental and carry_warm
        if self._rec_cfg is not None and K not in self._rec_batched:
            self._rec_batched[K] = obs_recorder.init_batch(self._rec_cfg, K, n, self.dtype,
                                                           self.device)
        res = optimize_batched(
            stacked,
            self.options,
            warm=self._batched_warm.get(K) if carry_warm else None,
            meta=self.meta,
            carry=self._inc_batched_carry.get(K) if incremental else None,
            rec=self._rec_batched.get(K),
            rec_cfg=self._rec_cfg,
        )
        if carry_warm:
            self._batched_warm[K] = res.warm_state
            if self.options.incremental:
                self._inc_batched_carry[K] = res.carry
        return res
