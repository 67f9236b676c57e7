"""Multi-domain fleet orchestrator: one allocation engine per power domain,
coordinated by an inter-domain budget planner.

:class:`FleetOrchestrator` is the fleet-scale serving shape of the
allocator.  The monolithic :class:`repro_torch.core.engine.AllocEngine`
solves the whole datacenter as one problem; the orchestrator cuts the PDN at
a chosen level (:func:`repro_torch.fleet.partition.split_pdn`) and runs the
control step as a two-level hierarchical solve:

1. the :class:`repro_torch.fleet.coordinator.BudgetCoordinator` turns
   per-domain aggregate demand into per-domain budget grants, respecting
   every capacity row above the cut (waterfill on the coordinator tree);
2. each domain solves its own three-phase problem with its grant as the
   domain root capacity.

Per-domain solves dispatch in one of three modes:

* ``stacked`` — all K domains padded to a common ``(N, M, E, T)`` shape and
  solved as K lanes of ONE solve
  (:func:`repro_torch.core.batched.solve_three_phase` on ``[K, N]`` fleet
  leaves), each lane over its own domain's topology: the tree and tenant
  topology carry a lane axis (``[K, M]`` rows, ``[K, E]`` edges), and the
  kernels read each lane's index through its lane strides, so every kernel
  launch of the solve covers all K domains.  The padded topology and its
  kernel index tables are built once (:meth:`FleetOrchestrator.rebuild_count`);
  per-step grants, supply derates, device join and leave, tenant re-bounds
  and same-shape structural rebuilds of one domain swap values in place;
* ``loop`` — one persistent :class:`AllocEngine` per domain, stepped in
  sequence, with the reference's dirty-domain dispatch in incremental mode;
* ``sharded`` — the stacked solve split over the ranks of a
  ``torch.distributed`` process group (:mod:`repro_torch.fleet.sharded`):
  each rank holds K/d domains as the lanes of its own stacked solve,
  padded to the global shape, and a step makes one all-reduce of the
  demand (the coordinator plan is then computed on every rank) and one
  all-gather of the result.

``mode="auto"`` picks ``stacked`` when the domains are homogeneous enough
that padding waste is small, else ``loop``.

Warm starts are carried per domain in both modes (a batched
:class:`repro_torch.core.phases.WarmCarry` with ``[K, ...]`` leaves, or each
engine's own carry); churn resets only the affected domain's carry.

**Tenant SLAs** (``tenants=`` at construction) work across the cut: the
partition classifies tenants as domain-local (their contractual row is an
ordinary SLA box inside one domain) or *cross-cut* (devices in several
domains).  Every step the coordinator splits each cross-cut tenant's
``[b_min, b_max]`` into per-domain slice sub-budgets
(:meth:`BudgetCoordinator.plan_sla`), raises the domain grant floors so
every feed funds its share of the tenant minimums, and the orchestrator
threads the sub-budgets into the per-domain solves as SLA row bounds —
stacked and loop dispatch alike, so grant changes and churn re-pins
rebuild nothing.
"""

from __future__ import annotations

import dataclasses
import time
import types
from typing import Any

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.core import phases
from repro_torch.core.batched import BatchMeta, _record_batch, _solve_batched
from repro_torch.core.engine import AllocEngine
from repro_torch.core.nvpax import NvpaxOptions
from repro_torch.core.problem import AllocProblem
from repro_torch.core.solver.options import KKT_HIST_BUCKETS
from repro_torch.core.treeops import SlaTopo, TreeTopo
from repro_torch.fleet import sharded as shd
from repro_torch.fleet.coordinator import (
    BudgetCoordinator,
    check_tenants_deliverable,
    split_entitlements,
)
from repro_torch.fleet.partition import (
    FleetPartition,
    FleetSla,
    build_fleet_sla,
    split_pdn,
)
from repro_torch.kernels.tree_matvec import sla_index_update, tree_index_update
from repro_torch.obs import recorder as obs_recorder
from repro_torch.obs import spans
from repro_torch.obs.stats import StepStats
from repro_torch.pdn.tree import FlatPDN, check_caps_fund_minimums

__all__ = ["FleetOrchestrator", "FleetStepResult"]


class _DomainBatch:
    """The padded ``[K, ...]`` per-domain tensors of the stacked dispatch,
    built once: the device boxes, deviation scales and priorities, and the
    tree and tenant topology with their lane-axis kernel indexes.  Caps and
    tenant row bounds change every step with the coordinator grants and
    are put in per step (:meth:`problem`)."""

    def __init__(self, l, u, ws, pri, start, end, depth, sla_dev, sla_ten, n_rows, *,
                 cover_capacity, dtype, device):
        K, N = l.shape
        self.l = torch.as_tensor(l, dtype=dtype, device=device)
        self.u = torch.as_tensor(u, dtype=dtype, device=device)
        self.weight_scale = torch.as_tensor(ws, dtype=dtype, device=device)
        self.priority = torch.as_tensor(pri, device=device)
        self.tree = TreeTopo.make(start, end, np.full(start.shape, np.inf), depth, N,
                                  dtype=dtype, device=device, cover_capacity=cover_capacity)
        self.sla = SlaTopo.make(sla_dev, sla_ten, np.zeros((K, n_rows)),
                                np.full((K, n_rows), np.inf), n=N, dtype=dtype, device=device)

    def set_lane(self, k, l, u, pri, start, end, depth, sla_dev, sla_ten) -> None:
        """Rewrite domain ``k``'s lane in place (same buffers, no other lane
        touched): its boxes and priorities, its tree rows and covering-rows
        index, and its tenant edges and their index."""
        for buf, host in ((self.l, l), (self.u, u), (self.priority, pri)):
            buf[k].copy_(torch.as_tensor(host, dtype=buf.dtype))
        for buf, host in ((self.tree.start, start), (self.tree.end, end),
                          (self.tree.depth, depth)):
            buf[k].copy_(torch.as_tensor(host, dtype=buf.dtype))
        tree_index_update(self.tree.index, k, start, end)
        if self.sla.dev.shape[-1]:
            self.sla.dev[k].copy_(torch.as_tensor(sla_dev, dtype=self.sla.dev.dtype))
            self.sla.ten[k].copy_(torch.as_tensor(sla_ten, dtype=self.sla.ten.dtype))
            sla_index_update(self.sla.index, k, sla_dev, sla_ten)

    def problem(self, r, active, cap, sla_lo, sla_hi) -> AllocProblem:
        """The K-lane control-step problem of one step: requests shaped as
        the engine shapes them (paper section 5.2: clipped to the device
        box, idle devices request ``l``)."""
        return AllocProblem(
            l=self.l,
            u=self.u,
            r=torch.where(active, torch.clamp(r, self.l, self.u), self.l),
            priority=self.priority,
            active=active,
            tree=self.tree._replace(cap=cap),
            sla=self.sla._replace(lo=sla_lo, hi=sla_hi),
            weight_scale=self.weight_scale,
        )


@dataclasses.dataclass
class FleetStepResult:
    """One fleet control step: global allocation + coordinator decisions."""

    allocation: np.ndarray  # [n] global device order (domain concatenation)
    grants: np.ndarray  # [K] coordinator budget grants (watts)
    demand: np.ndarray  # [K] per-domain aggregate shaped demand (watts)
    wall_time_s: float
    stats: dict[str, Any]  # per-domain solves/iterations/converged arrays


class FleetOrchestrator:
    """Construct-once / step-many fleet runtime over K power domains.

    Parameters
    ----------
    pdn : the full datacenter tree.
    level : cut depth; every node at this depth roots one domain.
    mode : ``"auto"`` | ``"stacked"`` | ``"loop"`` | ``"sharded"`` (see
        module docstring); ``sharded`` takes the ``waterfill`` and
        ``subtree`` coordinators.
    coordinator_mode : budget policy, see
        :class:`repro_torch.fleet.coordinator.BudgetCoordinator`.
    group : in ``sharded`` mode, the process group whose ranks share the
        domains (every rank builds the orchestrator with the same
        arguments and steps it with the same telemetry); ``None`` means
        the default group when ``torch.distributed`` is initialised, else
        a one-rank group of this process (see
        :mod:`repro_torch.fleet.sharded`).
    tenants : optional tenant SLA layout (anything with
        ``tenant_of``/``b_min``/``b_max``, e.g.
        :class:`repro_torch.pdn.tenants.TenantLayout`); tenants may span the
        domain cut (see module docstring).  ``priority`` defaults to the
        layout's priorities when it carries them.
    pad_factor : in ``auto`` mode, use the stacked dispatch when padding
        every domain to the largest one wastes at most this factor in both
        device and node counts.
    device : ``None`` means ``cuda`` (raises without a card); the tests pass
        ``"cpu"``.
    recorder : True or a :class:`repro_torch.obs.recorder.RecorderConfig`
        turns on the flight recorder: stacked mode keeps one ``[K, ...]``
        state and records the K domains in one update, loop mode each
        domain engine's own; :meth:`flush_recorder` drains it.
    """

    def __init__(
        self,
        pdn: FlatPDN,
        *,
        level: int = 1,
        options: NvpaxOptions | None = None,
        priority: np.ndarray | None = None,
        tenants=None,
        idle_threshold: float = 150.0,
        coordinator_mode: str = "waterfill",
        mode: str = "auto",
        pad_factor: float = 2.0,
        dtype=torch.float64,
        recorder=None,
        device=None,
        group=None,
    ):
        if mode not in ("auto", "stacked", "loop", "sharded"):
            raise ValueError(f"mode must be auto/stacked/loop/sharded, got {mode!r}")
        if mode == "sharded" and coordinator_mode not in ("waterfill", "subtree"):
            raise ValueError(
                "sharded dispatch supports waterfill/subtree coordinators, "
                f"got {coordinator_mode!r}"
            )
        self.device = resolve_device(device)
        self.partition: FleetPartition = split_pdn(pdn, level, tenants=tenants)
        self._sla: FleetSla | None = self.partition.sla
        self.coordinator = BudgetCoordinator(self.partition, mode=coordinator_mode)
        self.options = options or NvpaxOptions()
        self.idle_threshold = float(idle_threshold)
        self.dtype = dtype
        K = self.partition.k
        if priority is None and tenants is not None:
            priority = getattr(tenants, "priority", None)
        if priority is None:
            priority = np.ones((pdn.n,), np.int32)
        priority = np.asarray(priority, np.int32)
        if priority.shape != (pdn.n,):
            raise ValueError(f"priority shape {priority.shape} != ({pdn.n},)")
        if (priority < 1).any():
            raise ValueError("priorities must be >= 1")
        # mutable per-domain state (survives churn/rebuilds; global device
        # order is always the domain concatenation in domain index order)
        self._local_pdn: list[FlatPDN] = [d.pdn for d in self.partition.domains]
        self._priority: list[np.ndarray] = [
            priority[d.dev_lo : d.dev_hi].copy() for d in self.partition.domains
        ]
        self._dev_l: list[np.ndarray] = [p.dev_l.copy() for p in self._local_pdn]
        self._dev_u: list[np.ndarray] = [p.dev_u.copy() for p in self._local_pdn]
        self._node_cap: list[np.ndarray] = [p.node_cap.copy() for p in self._local_pdn]
        self._domain_supply = np.ones(K)
        self._feed_scale = 1.0
        if mode == "auto":
            ns = np.array([p.n for p in self._local_pdn])
            ms = np.array([p.m for p in self._local_pdn])
            homogeneous = (
                ns.max() <= pad_factor * ns.min()
                and ms.max() <= pad_factor * ms.min()
            )
            mode = "stacked" if homogeneous else "loop"
        self.mode = mode
        # sharded: this rank's domains [lo, hi); stacked holds all K
        self._shard: shd.ShardLayout | None = (
            shd.shard_layout(K, group, self.device) if mode == "sharded" else None
        )
        self._rebuilds = 0
        self._engines: list[AllocEngine] | None = None
        self._warm: phases.WarmCarry | None = None
        # incremental mode (options.incremental): stacked keeps a batched
        # certify anchor ([K, ...] leaves); loop mode keeps the host anchor
        # of the dirty-domain dispatch (frozen per-domain allocations plus
        # the demand/grant/telemetry values they were solved against)
        self._inc_carry: Any = None
        self._loop_prev: dict[str, Any] | None = None
        # the flight recorder: stacked mode keeps one [K, ...] state (made on
        # the first step), sharded mode one of its own lanes; loop mode
        # delegates to each domain engine's own
        if recorder is True:
            recorder = obs_recorder.RecorderConfig()
        self._rec_cfg: obs_recorder.RecorderConfig | None = recorder or None
        self._rec_state: obs_recorder.RecorderState | None = None
        self._rec_steps = 0  # sharded: recorded steps (every rank counts)
        self.history: list[dict[str, Any]] = []
        if self._sla is not None:
            # fail fast: contracts must be deliverable and fundable under
            # the nameplate feeds before the first step
            self._check_effective_floors()
        if mode in ("stacked", "sharded"):
            # pad to the largest domain; static metadata is the union over
            # domains so per-domain differences stay per lane (each rank of
            # a sharded fleet pads to the global shape: its lanes are the
            # stacked program's)
            self._N = int(max(p.n for p in self._local_pdn))
            self._M = int(max(p.m for p in self._local_pdn))
            # SLA pads: one extra always-inert row receives the padded
            # incidence edges, so every real row keeps exact semantics
            self._E = self._sla.max_edges if self._sla is not None else 0
            self._T = self._sla.max_rows + 1 if self._sla is not None else 0
            self.meta = BatchMeta(
                levels=tuple(sorted({int(p) for p in priority}, reverse=True)),
                n_depths=int(max(p.node_depth.max() for p in self._local_pdn)) + 1,
                # tenant minimums can force pinned-free devices upward, so
                # the pin-free simplification (paper 4.3.1) is SLA-free only
                pin_free=self._sla is None,
                max_rounds=self.options.max_rounds,
                use_waterfill=self.options.use_waterfill,
                run_phase2=self.options.run_phase2,
                run_phase3=self.options.run_phase3,
                eps=self.options.eps,
            )
            self._upload()
        else:
            rb = self._initial_row_bounds() if self._sla is not None else None
            self._engines = [
                self._build_engine(k, p, rb)
                for k, p in enumerate(self._local_pdn)
            ]

    # -- geometry ----------------------------------------------------------

    @property
    def k(self) -> int:
        return self.partition.k

    @property
    def domain_sizes(self) -> np.ndarray:
        return np.array([p.n for p in self._local_pdn], np.int64)

    @property
    def n(self) -> int:
        """Current total device count (changes on structural rebuilds)."""
        return int(self.domain_sizes.sum())

    def _offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.domain_sizes)])

    def device_bounds(self) -> np.ndarray:
        """[n] current global lower bounds (domain concatenation order)."""
        return np.concatenate(self._dev_l)

    def device_caps(self) -> np.ndarray:
        return np.concatenate(self._dev_u)

    def rebuild_count(self) -> int:
        """How many times the orchestrator built device topology and kernel
        index tables: in stacked mode the padded ``[K, ...]`` batch (1 after
        construction) and each :meth:`rebuild_domain` lane rewrite; in
        sharded mode the same, on every rank, for its own lanes and the
        coordinator tree and tenant forest of the replicated plan; in loop
        mode each domain engine built (K after construction).  Grants,
        derates, re-pins and tenant re-bounds leave it unchanged — the
        port's form of the reference's ``trace_count``."""
        return self._rebuilds

    def _lane(self, k: int) -> int | None:
        """Domain ``k``'s lane in this process's domain batch (``None``
        when another rank of a sharded fleet holds it)."""
        return k if self._shard is None else self._shard.lane(k)

    @property
    def _local(self) -> range:
        """The domains whose lanes this process holds."""
        return range(self.k) if self._shard is None else range(self._shard.lo, self._shard.hi)

    # -- stacked-mode tensor management -------------------------------------

    def _lane_arrays(self, k: int):
        """Domain ``k``'s padded host arrays: (l, u, priority, start, end,
        depth, sla_dev, sla_ten).  Padded devices have ``l = u = 0``; padded
        rows are the empty range ``[N, N)`` (cap ``inf``, set per step);
        padded tenant edges point device 0 at the always-inert row
        ``T - 1``, bounded ``[0, inf)``."""
        N, M, E, T = self._N, self._M, self._E, self._T
        p = self._local_pdn[k]
        l = np.zeros(N)
        u = np.zeros(N)
        pri = np.ones(N, np.int32)
        start = np.full(M, N, np.int64)
        end = np.full(M, N, np.int64)
        depth = np.zeros(M, np.int64)
        l[: p.n] = self._dev_l[k]
        u[: p.n] = self._dev_u[k]
        pri[: p.n] = self._priority[k]
        start[: p.m] = p.node_start
        end[: p.m] = p.node_end
        depth[: p.m] = p.node_depth
        sla_dev = np.zeros(E, np.int64)
        sla_ten = np.full(E, max(T - 1, 0), np.int64)
        if self._sla is not None:
            dev, ten = self._sla.edges(k)
            sla_dev[: dev.shape[0]] = dev
            sla_ten[: ten.shape[0]] = ten
        return l, u, pri, start, end, depth, sla_dev, sla_ten

    def _upload(self) -> None:
        """Build the padded [K, ...] device tensors and their kernel indexes
        from the host mirrors (once, at construction): all K lanes, or a
        sharded rank's own (none on a rank past the shard count), and in
        sharded mode the replicated plan's trees."""
        K, M = self.k, self._M
        # host mirror of the caps (all K domains); row 0 gets the grants
        self._cap_np = np.full((K, M), np.inf)
        for k, c in enumerate(self._node_cap):
            self._cap_np[k, : c.shape[0]] = c
        self._dom: _DomainBatch | None = None
        if len(self._local):
            lanes = [self._lane_arrays(k) for k in self._local]
            l, u, pri, start, end, depth, sla_dev, sla_ten = (np.stack(a) for a in zip(*lanes))
            self._dom = _DomainBatch(
                l, u, np.ones_like(l), pri, start, end, depth, sla_dev, sla_ten, self._T,
                # the longest covering-rows list a domain within the padding
                # can have, so that rebuild_domain rewrites a lane in place
                cover_capacity=self._N * self.meta.n_depths,
                dtype=self.dtype, device=self.device,
            )
        if self._shard is not None:
            co = self.coordinator
            self._ctree = TreeTopo.make(co.start, co.end, co.cap, np.zeros_like(co.start), K,
                                        dtype=self.dtype, device=self.device)
            self._forest_key = None
            self._forest = self._forest_for(self._sla)
        self._rebuilds += 1

    def _forest_for(self, sla: FleetSla | None) -> TreeTopo | None:
        """The cross-cut tenants over their slices (the sharded plan's
        entitlement forest), built again only when the slice structure
        changes."""
        if sla is None or not sla.n_slices:
            self._forest_key = None
            return None
        key = (sla.n_slices, sla.ten_start.tobytes(), sla.ten_end.tobytes())
        if key != self._forest_key:
            self._forest_key = key
            self._forest = TreeTopo.make(
                sla.ten_start, sla.ten_end, sla.b_max[sla.cross_ids],
                np.zeros_like(sla.ten_start), sla.n_slices, dtype=self.dtype,
                device=self.device)
        return self._forest

    def _vec(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64), dtype=self.dtype, device=self.device)

    # -- tenant SLA plumbing -----------------------------------------------

    def _build_engine(self, k: int, p: FlatPDN, row_bounds=None) -> AllocEngine:
        """Loop-mode per-domain engine, with its local SLA structure.
        ``row_bounds`` (all domains' initial SLA bounds) avoids recomputing
        the entitlement split per engine when building K at once."""
        sla_topo = None
        if self._sla is not None and self._sla.n_rows(k):
            dev, ten = self._sla.edges(k)
            if row_bounds is None:
                row_bounds = self._initial_row_bounds()
            lo, hi = row_bounds[k]
            sla_topo = types.SimpleNamespace(dev=dev, ten=ten, lo=lo, hi=hi)
        engine = AllocEngine(
            p,
            sla=sla_topo,
            priority=self._priority[k],
            options=self.options,
            idle_threshold=self.idle_threshold,
            # SLA lower bounds are re-pinned per step (tenant sub-budgets,
            # runtime grant changes) and may rise above zero later; the
            # pin-free simplification must stay off for SLA domains
            pin_free=False if sla_topo is not None else None,
            dtype=self.dtype,
            recorder=self._rec_cfg,
            device=self.device,
        )
        self._rebuilds += engine.rebuild_count()
        return engine

    def _slice_aggregates(
        self,
        dev_l: list[np.ndarray],
        dev_u: list[np.ndarray],
        shaped: np.ndarray | None = None,
        sla: FleetSla | None = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-slice (floor, umax, demand) sums over the given boxes."""
        sla = sla or self._sla
        S = sla.n_slices
        sf = np.zeros(S)
        su = np.zeros(S)
        sd = np.zeros(S)
        offs = np.concatenate([[0], np.cumsum([l.shape[0] for l in dev_l])])
        for s in range(S):
            k = int(sla.slice_domain[s])
            idx = sla.row_dev[k][int(sla.slice_row[s])]
            sf[s] = dev_l[k][idx].sum()
            su[s] = dev_u[k][idx].sum()
            if shaped is not None:
                sd[s] = shaped[offs[k] : offs[k + 1]][idx].sum()
        return sf, su, sd

    def _local_lift(
        self,
        dev_l: list[np.ndarray],
        dev_u: list[np.ndarray],
        sla: FleetSla | None = None,
    ) -> np.ndarray:
        """[K] extra minimum draw from *domain-local* tenant minimums, with
        per-tenant deliverability validation (umax funds b_min, floors stay
        under b_max)."""
        sla = sla or self._sla
        lift = np.zeros(self.k)
        for k in range(self.k):
            for r, t in enumerate(sla.rows[k]):
                if sla.row_slice[k][r] >= 0:
                    continue
                idx = sla.row_dev[k][r]
                floor = float(dev_l[k][idx].sum())
                umax = float(dev_u[k][idx].sum())
                if umax < sla.b_min[t] - 1e-9:
                    raise ValueError(
                        f"tenant {int(t)} minimum {sla.b_min[t]:.1f} W exceeds "
                        f"its deliverable maximum {umax:.1f} W in domain {k}; "
                        "restore devices or relax the SLA"
                    )
                if floor > sla.b_max[t] + 1e-9:
                    raise ValueError(
                        f"tenant {int(t)} device floors {floor:.1f} W exceed "
                        f"its contractual maximum {sla.b_max[t]:.1f} W"
                    )
                lift[k] += max(float(sla.b_min[t]) - floor, 0.0)
        return lift

    def _sla_lifts(
        self,
        dev_l: list[np.ndarray],
        dev_u: list[np.ndarray],
        sla: FleetSla | None = None,
    ) -> np.ndarray:
        """[K] total tenant minimum-draw lift (local + cross-cut) under the
        given boxes.  The cross-cut part uses the demand-free entitlement
        split, which is exactly what the next ``plan_sla`` will enforce, so
        mutation-time validation and step-time behavior agree."""
        sla = sla or self._sla
        if sla is None:
            return np.zeros(self.k)
        # a tenant with a positive contractual minimum must own at least one
        # device somewhere — otherwise (e.g. a rebuild_domain that dropped
        # its last devices) the contract would go silently unenforced
        present = np.zeros(sla.n_tenants, bool)
        for rows in sla.rows:
            present[rows] = True
        orphan = np.nonzero(~present & (sla.b_min > 1e-12))[0]
        if orphan.size:
            t = int(orphan[0])
            raise ValueError(
                f"tenant {t} has a contractual minimum {sla.b_min[t]:.1f} W "
                "but no devices; relax the contract "
                "(set_tenant_bounds(b_min=0)) before removing its last "
                "devices"
            )
        lift = self._local_lift(dev_l, dev_u, sla)
        if sla.n_slices:
            sf, su, _ = self._slice_aggregates(dev_l, dev_u, sla=sla)
            check_tenants_deliverable(sla, sf, su)
            slice_lo, _ = split_entitlements(sla, sf, su, sf)
            np.add.at(lift, sla.slice_domain, slice_lo - sf)
        return lift

    def _sla_row_bounds(
        self,
        slice_lo: np.ndarray,
        slice_hi: np.ndarray,
        sla: FleetSla | None = None,
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Per-domain SLA row bounds: contractual rows for domain-local
        tenants, coordinator sub-budgets for cross-cut slices."""
        sla = sla or self._sla
        out = []
        for k in range(self.k):
            R = sla.n_rows(k)
            lo = np.zeros(R)
            hi = np.zeros(R)
            for r, t in enumerate(sla.rows[k]):
                s = int(sla.row_slice[k][r])
                if s >= 0:
                    lo[r], hi[r] = slice_lo[s], slice_hi[s]
                else:
                    lo[r], hi[r] = sla.b_min[t], sla.b_max[t]
            out.append((lo, hi))
        return out

    def _initial_row_bounds(self) -> list[tuple[np.ndarray, np.ndarray]]:
        """Demand-free row bounds from current mirrors (construction and
        engine rebuilds; every step re-pins the real ones)."""
        sf, su, _ = self._slice_aggregates(self._dev_l, self._dev_u)
        slice_lo, slice_hi = split_entitlements(self._sla, sf, su, sf)
        return self._sla_row_bounds(slice_lo, slice_hi)

    def _tenant_of_list(self) -> list[np.ndarray]:
        """Per-domain local tenant membership, reconstructed from the
        layout (the inverse of ``build_fleet_sla``'s input)."""
        out = []
        for k in range(self.k):
            t_of = np.full(self._dev_l[k].shape[0], -1, np.int32)
            for r, t in enumerate(self._sla.rows[k]):
                t_of[self._sla.row_dev[k][r]] = t
            out.append(t_of)
        return out

    def set_tenant_bounds(
        self,
        tenant: int,
        *,
        b_min: float | None = None,
        b_max: float | None = None,
    ) -> None:
        """Change one tenant's contractual ``[b_min, b_max]`` at runtime.

        Pure coordinator-level state: the new bounds flow into the next
        step's entitlement split and per-domain SLA rows as values —
        nothing is rebuilt.  The whole change is validated (deliverability,
        derated feeds still fund the shifted minimums) before any state is
        committed.
        """
        sla = self._sla
        if sla is None:
            raise ValueError("orchestrator was built without tenants")
        if not 0 <= int(tenant) < sla.n_tenants:
            raise ValueError(f"tenant {tenant} out of range [0, {sla.n_tenants})")
        new_min = sla.b_min.copy()
        new_max = sla.b_max.copy()
        if b_min is not None:
            new_min[tenant] = float(b_min)
        if b_max is not None:
            new_max[tenant] = float(b_max)
        if new_min[tenant] < 0 or new_min[tenant] > new_max[tenant] + 1e-9:
            raise ValueError("tenant bounds must satisfy 0 <= b_min <= b_max")
        candidate = dataclasses.replace(sla, b_min=new_min, b_max=new_max)
        self._check_effective_floors(sla=candidate)
        self._sla = candidate

    def _reset_domain_warm(self, k: int) -> None:
        if self.mode == "loop":
            if self._engines is not None:
                self._engines[k].reset_warm()
        elif self._warm is not None and self._lane(k) is not None:
            j = self._lane(k)

            def zero_lane(a):
                a = a.clone()
                a[j] = 0
                return a

            self._warm = phases.WarmCarry(*(
                type(s)(*(zero_lane(a) for a in s)) for s in self._warm
            ))
        self._invalidate_incremental(k)

    def _invalidate_incremental(self, k: int) -> None:
        """Poison domain ``k``'s incremental anchor after a re-pin/rebuild:
        an infinite anchor demand fails every certify tier, forcing a full
        solve for that domain on the next step (the other K-1 anchors keep
        skipping)."""
        if self._inc_carry is not None and self._lane(k) is not None:
            r = self._inc_carry.r.clone()
            r[self._lane(k)] = float("inf")
            self._inc_carry = self._inc_carry._replace(r=r)
        if self._loop_prev is not None:
            self._loop_prev["alloc"][k] = None

    # -- lifecycle: supply + churn re-pins ---------------------------------

    def set_domain_supply(self, k: int, scale: float) -> None:
        """Derate (or restore) one domain's feed: the coordinator caps that
        domain's grant at ``scale`` x its subtree capacity from the next
        step on.  Pure coordinator state — nothing is rebuilt, and the
        freed budget is redistributed to the other domains.

        The derated feed must still fund the domain's current minimum draw
        (grants below it make the domain's own problem infeasible); for a
        deeper derate — including a full outage — mask devices out first
        (:meth:`repro_torch.fleet.lifecycle.FleetLifecycle.device_leave`).
        ``scale`` is capped at 1.0: the PDN caps are physical limits, not a
        planning knob (1.0 restores the nameplate feed).
        """
        if not 0.0 <= scale <= 1.0:
            raise ValueError(f"scale must be in [0, 1], got {scale}")
        dcap_eff = np.array([c[0] for c in self._node_cap]) * self._domain_supply
        dcap_eff[k] = float(self._node_cap[k][0]) * float(scale)
        self._check_effective_floors(dcap_eff=dcap_eff)
        self._domain_supply[k] = float(scale)

    def set_feed_scale(self, scale: float) -> None:
        """Derate every capacity above the cut (utility feed event).  Like
        :meth:`set_domain_supply`, the derated rows must still fund the
        fleet's current minimum draw and ``scale`` cannot exceed 1.0."""
        if not 0.0 <= scale <= 1.0:
            raise ValueError(f"scale must be in [0, 1], got {scale}")
        self._check_effective_floors(feed_scale=float(scale))
        self._feed_scale = float(scale)

    def _check_effective_floors(
        self,
        dev_l: list[np.ndarray] | None = None,
        dev_u: list[np.ndarray] | None = None,
        dcap_eff: np.ndarray | None = None,
        feed_scale: float | None = None,
        sla: FleetSla | None = None,
    ) -> None:
        """The *derated* feeds (domain supplies + feed scale) must fund the
        per-domain minimum draws — device floors plus tenant minimum lifts —
        under the given (possibly prospective) boxes, derates and SLA
        bounds.  Shared by every mutation path (supply derates, box
        re-pins, rejoins, tenant grant changes) so a rejected change leaves
        all state untouched."""
        dev_l = self._dev_l if dev_l is None else dev_l
        dev_u = self._dev_u if dev_u is None else dev_u
        dmin = np.array([l.sum() for l in dev_l])
        dmin = dmin + self._sla_lifts(dev_l, dev_u, sla or self._sla)
        if dcap_eff is None:
            dcap_eff = np.array([c[0] for c in self._node_cap]) * self._domain_supply
        bad = np.nonzero(dmin > dcap_eff + 1e-9)[0]
        if bad.size:
            k = int(bad[0])
            raise ValueError(
                f"domain {k} minimum draw {dmin[k]:.1f} W exceeds its "
                f"derated feed {dcap_eff[k]:.1f} W; restore the supply "
                "(set_domain_supply) or mask devices out first "
                "(FleetLifecycle.device_leave)"
            )
        scale = self._feed_scale if feed_scale is None else feed_scale
        check_caps_fund_minimums(
            self.coordinator.start,
            self.coordinator.end,
            self.coordinator.cap * scale,
            dmin,
            what="derated coordinator row",
        )

    def repin_domain(
        self,
        k: int,
        *,
        dev_l: np.ndarray | None = None,
        dev_u: np.ndarray | None = None,
        node_cap: np.ndarray | None = None,
        reset_warm: bool = True,
    ) -> None:
        """Swap same-shape values of ONE domain (device join/leave masks,
        cap trims).  The other K-1 domains are untouched in both modes; in
        stacked mode only domain ``k``'s lane of the box tensors is written
        and nothing is rebuilt.

        The whole re-pin is validated (box ordering, caps >= subtree
        minimum draw — the same checks as ``AllocEngine.repin``) before any
        orchestrator state changes, so a rejected re-pin leaves mirrors,
        engines and device tensors consistent.
        """
        p = self._local_pdn[k]
        new_l = self._dev_l[k] if dev_l is None else np.asarray(dev_l, np.float64)
        new_u = self._dev_u[k] if dev_u is None else np.asarray(dev_u, np.float64)
        new_cap = (
            self._node_cap[k] if node_cap is None
            else np.asarray(node_cap, np.float64)
        )
        if new_l.shape != (p.n,) or new_u.shape != (p.n,):
            raise ValueError(
                f"dev_l/dev_u shapes {new_l.shape}/{new_u.shape} != ({p.n},)"
            )
        if new_cap.shape != (p.m,):
            raise ValueError(f"node_cap shape {new_cap.shape} != ({p.m},)")
        if (new_l < 0).any() or (new_l > new_u + 1e-12).any():
            raise ValueError("device limits must satisfy 0 <= l <= u")
        check_caps_fund_minimums(
            p.node_start,
            p.node_end,
            new_cap,
            new_l,
            what=f"domain {k} node",
        )
        # an active derate must also still fund the (possibly raised) floor
        # — including tenant minimum lifts — otherwise the failure would
        # surface one step later in plan()
        dev_l_new = list(self._dev_l)
        dev_u_new = list(self._dev_u)
        dev_l_new[k] = new_l
        dev_u_new[k] = new_u
        dcap_eff = np.array([c[0] for c in self._node_cap]) * self._domain_supply
        dcap_eff[k] = new_cap[0] * self._domain_supply[k]
        self._check_effective_floors(
            dev_l=dev_l_new, dev_u=dev_u_new, dcap_eff=dcap_eff
        )
        self._dev_l[k] = new_l.copy()
        self._dev_u[k] = new_u.copy()
        self._node_cap[k] = new_cap.copy()
        if self.mode == "loop":
            assert self._engines is not None
            # always pass the nameplate caps: the engine's live root cap
            # still holds the previous step's coordinator grant, which
            # could spuriously fail a join that the next grant would fund
            # (the grant is re-applied by set_root_cap on the next step)
            self._engines[k].repin(
                dev_l=new_l,
                dev_u=new_u,
                node_cap=new_cap,
                reset_warm=reset_warm,
            )
            self._invalidate_incremental(k)
        else:
            # write only lane k of the built tensors (O(N) host work and a
            # one-lane copy, on the rank that holds it); nothing is rebuilt
            j = self._lane(k)
            if j is not None and (dev_l is not None or dev_u is not None):
                row_l = np.zeros(self._N)
                row_u = np.zeros(self._N)
                row_l[: p.n] = self._dev_l[k]
                row_u[: p.n] = self._dev_u[k]
                self._dom.l[j].copy_(self._vec(row_l))
                self._dom.u[j].copy_(self._vec(row_u))
            if node_cap is not None:
                self._cap_np[k, : p.m] = self._node_cap[k]
            if reset_warm:
                self._reset_domain_warm(k)
        if not reset_warm:
            # the certify anchors compare boxes/caps and would catch the
            # re-pin anyway; poisoning keeps the frozen-allocation paths
            # trivially sound without relying on that comparison
            self._invalidate_incremental(k)

    def rebuild_domain(
        self,
        k: int,
        new_pdn: FlatPDN,
        *,
        priority: np.ndarray | None = None,
        tenant_of: np.ndarray | None = None,
    ) -> None:
        """Replace one domain's topology (structural churn: servers added or
        decommissioned).  Only this domain's engine (loop) or lane (stacked)
        is rebuilt; the other K-1 domains keep their tensors and warm state.
        In stacked mode the new topology must fit the padded shape and the
        static metadata (device/node counts, tree depth, priority levels,
        SLA row/edge counts); its lane of every tensor and kernel index is
        then rewritten in place, one rebuild counted.

        ``tenant_of`` maps the new domain's local devices to global tenant
        ids (-1 unassigned; default: the rebuilt domain carries no tenant
        devices).  Cross-cut tenant membership is updated atomically with
        the topology: the whole change — shapes, tenant deliverability
        under the new boxes, derated feeds funding the shifted minimum
        lifts — is validated before any state is committed, and a tenant
        whose devices now all live in one domain reverts to an ordinary
        domain-local SLA row.
        """
        new_pdn.validate()
        if priority is None:
            priority = np.ones((new_pdn.n,), np.int32)
        priority = np.asarray(priority, np.int32)
        if priority.shape != (new_pdn.n,):
            raise ValueError(f"priority shape {priority.shape} != ({new_pdn.n},)")
        candidate_sla = self._sla
        if self._sla is not None:
            if tenant_of is None:
                tenant_of = np.full(new_pdn.n, -1, np.int32)
            tenant_of = np.asarray(tenant_of, np.int32)
            if tenant_of.shape != (new_pdn.n,):
                raise ValueError(f"tenant_of shape {tenant_of.shape} != ({new_pdn.n},)")
            lists = self._tenant_of_list()
            lists[k] = tenant_of
            candidate_sla = build_fleet_sla(lists, self._sla.b_min, self._sla.b_max)
        elif tenant_of is not None:
            raise ValueError("orchestrator was built without tenants")
        if self.mode in ("stacked", "sharded"):
            if new_pdn.n > self._N or new_pdn.m > self._M:
                raise ValueError(
                    f"domain {k} rebuild ({new_pdn.n} devices, {new_pdn.m} "
                    f"nodes) exceeds the padded shape ({self._N}, {self._M}); "
                    "rebuild the orchestrator"
                )
            if int(new_pdn.node_depth.max()) + 1 > self.meta.n_depths:
                raise ValueError("rebuild deepens the tree; rebuild the orchestrator")
            if not set(int(x) for x in np.unique(priority)) <= set(self.meta.levels):
                raise ValueError(
                    "rebuild introduces new priority levels; rebuild the orchestrator"
                )
            if candidate_sla is not None and (
                candidate_sla.max_rows > self._T - 1
                or candidate_sla.max_edges > self._E
            ):
                raise ValueError(
                    "rebuild exceeds the padded SLA row/edge shape; rebuild "
                    "the orchestrator"
                )
        if candidate_sla is not None:
            dev_l_new = list(self._dev_l)
            dev_u_new = list(self._dev_u)
            dev_l_new[k] = new_pdn.dev_l
            dev_u_new[k] = new_pdn.dev_u
            dcap_eff = np.array([c[0] for c in self._node_cap]) * self._domain_supply
            dcap_eff[k] = new_pdn.node_cap[0] * self._domain_supply[k]
            self._check_effective_floors(
                dev_l=dev_l_new,
                dev_u=dev_u_new,
                dcap_eff=dcap_eff,
                sla=candidate_sla,
            )
        self._local_pdn[k] = new_pdn
        self._priority[k] = priority.copy()
        self._dev_l[k] = new_pdn.dev_l.copy()
        self._dev_u[k] = new_pdn.dev_u.copy()
        self._node_cap[k] = new_pdn.node_cap.copy()
        self._sla = candidate_sla
        if self.mode == "loop":
            assert self._engines is not None
            self._engines[k] = self._build_engine(k, new_pdn)
            self._invalidate_incremental(k)
        else:
            # only lane k's edges can change: the other domains' rows and
            # edges depend on their own membership alone (a sharded rank
            # rewrites the lane if it holds it, and the tenant forest if the
            # slice structure moved)
            if self._lane(k) is not None:
                self._dom.set_lane(self._lane(k), *self._lane_arrays(k))
            if self._shard is not None:
                self._forest_for(self._sla)
            self._cap_np[k] = np.inf
            self._cap_np[k, : new_pdn.m] = self._node_cap[k]
            self._rebuilds += 1
            self._reset_domain_warm(k)

    def reset_warm(self) -> None:
        self._warm = None
        self._inc_carry = None
        self._loop_prev = None
        if self._engines is not None:
            for e in self._engines:
                e.reset_warm()

    # -- the control step --------------------------------------------------

    def _effective_domain_caps(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(domain_cap, coord_cap, domain_min) under current supply state."""
        dcap = np.array([c[0] for c in self._node_cap]) * self._domain_supply
        ccap = self.coordinator.cap * self._feed_scale
        dmin = np.array([l.sum() for l in self._dev_l])
        return dcap, ccap, dmin

    def _plan(self, demand: np.ndarray, shaped: np.ndarray | None = None):
        """(grants, per-domain SLA row bounds | None, slice_lo, slice_hi)."""
        dcap, ccap, dmin = self._effective_domain_caps()
        if self._sla is None:
            grants = self.coordinator.plan(
                demand,
                domain_cap=dcap,
                coord_cap=ccap,
                domain_min=dmin,
                domain_n=self.domain_sizes,
            )
            return grants, None, None, None
        sf, su, sd = self._slice_aggregates(self._dev_l, self._dev_u, shaped)
        grants, slo, shi = self.coordinator.plan_sla(
            demand,
            sla=self._sla,
            slice_floor=sf,
            slice_umax=su,
            slice_demand=sd if shaped is not None else sf,
            local_lift=self._local_lift(self._dev_l, self._dev_u),
            domain_cap=dcap,
            coord_cap=ccap,
            domain_min=dmin,
            domain_n=self.domain_sizes,
        )
        return grants, self._sla_row_bounds(slo, shi), slo, shi

    def plan(self, demand: np.ndarray) -> np.ndarray:
        """Coordinator grants for a demand vector under current supply
        (with tenants: entitlement rows enforced, demand-free slice split)."""
        return self._plan(demand)[0]

    def step(
        self,
        telemetry: np.ndarray,
        *,
        active: np.ndarray | None = None,
    ) -> FleetStepResult:
        """One fleet control step: telemetry [n] watts -> allocation [n].

        Telemetry and the returned allocation are in global device order
        (domain concatenation).  Host-side work is O(n) request shaping,
        the O(K + m_above_cut) coordinator plan, and the scatter/gather
        into the per-domain layout; the solves run on the device.
        """
        n = self.n
        req = np.asarray(telemetry, np.float64)
        if req.shape != (n,):
            raise ValueError(f"telemetry shape {req.shape} != ({n},)")
        if active is None:
            active = req >= self.idle_threshold
        active = np.asarray(active, bool)
        if active.shape != (n,):
            raise ValueError(f"active shape {active.shape} != ({n},)")
        offs = self._offsets()
        if self.mode == "sharded":
            # demand aggregation and the coordinator plan run inside the
            # sharded step (the one cross-rank reduction); the host only
            # lays out this rank's lanes and the demand-free plan inputs
            t0 = time.perf_counter()
            with spans.span("fleet.dispatch"):
                res, grants, demand, slice_lo, slice_hi = self._step_sharded(req, active, offs)
            wall = time.perf_counter() - t0
        else:
            with spans.span("fleet.shape"):
                l_all = self.device_bounds()
                u_all = self.device_caps()
                shaped = np.where(active, np.clip(req, l_all, u_all), l_all)
                demand = np.array(
                    [shaped[offs[k] : offs[k + 1]].sum() for k in range(self.k)]
                )
            with spans.span("fleet.plan"):
                grants, row_bounds, slice_lo, slice_hi = self._plan(demand, shaped)
            t0 = time.perf_counter()
            with spans.span("fleet.dispatch"):
                if self.mode == "stacked":
                    res = self._step_stacked(req, active, grants, offs, row_bounds)
                else:
                    res = self._step_loop(req, active, grants, offs, row_bounds, demand)
            wall = time.perf_counter() - t0
        if slice_lo is not None:
            res[1]["slice_lo"] = slice_lo
            res[1]["slice_hi"] = slice_hi
        out = FleetStepResult(
            allocation=res[0],
            grants=grants,
            demand=demand,
            wall_time_s=wall,
            stats=res[1],
        )
        self.history.append(
            {
                "wall_s": wall,
                "converged": bool(np.all(out.stats["converged"])),
                "solves": int(np.sum(out.stats["solves"])),
                "iterations": int(np.sum(out.stats["iterations"])),
                "granted_W": float(grants.sum()),
                "demand_W": float(demand.sum()),
                "skipped": int(np.sum(out.stats.get("skipped", False))),
            }
        )
        return out

    @property
    def recorder_config(self) -> obs_recorder.RecorderConfig | None:
        return self._rec_cfg

    def flush_recorder(self, *, reset: bool = False) -> dict[str, Any] | None:
        """The flight record as host numpy: ``{"mode", "lanes"}`` with one
        per-domain flush dict per lane (see
        :func:`repro_torch.obs.recorder.flush`), or ``None`` when recording
        is off.  Stacked mode flushes the orchestrator's own ``[K, ...]``
        state; sharded mode gathers every rank's lanes (one all-gather, the
        only place the shards' records meet, so every rank of the group
        must call it) and gives all K in domain order; loop mode each domain
        engine's (``{}`` for an engine that has not stepped).
        ``reset=True`` drops the records after the gather."""
        if self._rec_cfg is None:
            return None
        if self.mode == "sharded":
            lanes = []
            if self._rec_steps:
                lanes = shd.flush_lanes(self._shard, self._rec_state, self._rec_cfg, self._N,
                                        self.dtype)
            if reset:
                self._rec_state = None
                self._rec_steps = 0
        elif self.mode == "stacked":
            lanes: list[dict[str, Any]] = []
            if self._rec_state is not None:
                lanes = obs_recorder.flush_lanes(self._rec_state, self._rec_cfg)
            if reset:
                self._rec_state = None
        else:
            lanes = []
            for eng in self._engines or []:
                f = eng.flush_recorder(reset=reset)
                lanes.append(f["step"] if f is not None and "step" in f else {})
        return {"mode": self.mode, "lanes": lanes}

    def _lane_telemetry(self, req, active, offs) -> tuple[np.ndarray, np.ndarray]:
        """This process's lanes of the telemetry and activity mask, padded
        to ``[lanes, N]``."""
        local = self._local
        r = np.zeros((len(local), self._N))
        act = np.zeros((len(local), self._N), bool)
        for j, k in enumerate(local):
            r[j, : offs[k + 1] - offs[k]] = req[offs[k] : offs[k + 1]]
            act[j, : offs[k + 1] - offs[k]] = active[offs[k] : offs[k + 1]]
        return r, act

    def _step_stacked(self, req, active, grants, offs, row_bounds=None):
        K, N = self.k, self._N
        r, act = self._lane_telemetry(req, active, offs)
        cap = self._cap_np.copy()
        cap[:, 0] = grants
        # per-step SLA rows: real rows get contract/sub-budget bounds, pad
        # rows stay [0, inf) (inert)
        sla_lo = np.zeros((K, self._T))
        sla_hi = np.full((K, self._T), np.inf)
        if row_bounds is not None:
            for k, (lo_k, hi_k) in enumerate(row_bounds):
                sla_lo[k, : lo_k.shape[0]] = lo_k
                sla_hi[k, : hi_k.shape[0]] = hi_k
        inc = self._inc_carry if self.options.incremental else None
        ap = self._dom.problem(
            self._vec(r), torch.as_tensor(act, device=self.device), self._vec(cap),
            self._vec(sla_lo), self._vec(sla_hi),
        )
        x1, x2, x3, warm_c, stats, new_inc = _solve_batched(
            ap, self.meta, self.options.solver, self._warm, None, inc
        )
        if self._rec_cfg is not None:
            if self._rec_state is None:
                self._rec_state = obs_recorder.init_batch(self._rec_cfg, K, N, self.dtype,
                                                          self.device)
            # all K domains in one update, over the padded lanes (pad
            # devices and the inert pad row included, as in the reference)
            _record_batch(self._rec_cfg, self._rec_state, stats, x3, ap)
        x3 = x3.cpu().numpy()  # waits for the device
        self._warm = warm_c
        if self.options.incremental:
            # update_carry(None, ...) seeds a fresh anchor on the first
            # step, so new_inc is a [K, ...]-leaf carry on every path
            self._inc_carry = new_inc
        alloc = np.concatenate([x3[k, : int(self.domain_sizes[k])] for k in range(K)])
        return alloc, StepStats.from_lanes(stats, mode="stacked")

    def _sharded_plan(self) -> tuple[shd.PlanRep, shd.RowMaps | None]:
        """(PlanRep, RowMaps | None): the demand-independent planning
        tensors of the sharded step, from the same host mirrors (and with
        the same per-step checks) as the stacked planner."""
        dcap, ccap, dmin = self._effective_domain_caps()
        sla = self._sla
        S = sla.n_slices if sla is not None else 0
        rowmap = None
        slice_lo = np.zeros(0)
        slice_umax = np.zeros(0)
        forest = None
        if sla is not None:
            sf, su, _ = self._slice_aggregates(self._dev_l, self._dev_u)
            lift = self._local_lift(self._dev_l, self._dev_u)
            if S:
                check_tenants_deliverable(sla, sf, su)
                slice_lo, _ = split_entitlements(sla, sf, su, sf)
                slice_umax = su
                forest = self._forest_for(sla)._replace(cap=self._vec(sla.b_max[sla.cross_ids]))
                np.add.at(lift, sla.slice_domain, slice_lo - sf)
            dmin = dmin + lift
            # [K/d, T] row routing of this rank's lanes: slice rows gather
            # the coordinator split, local rows carry their contract, pad
            # rows stay [0, inf)
            local, T = self._local, self._T
            idx = np.full((len(local), T), S, np.int64)
            lo_local = np.zeros((len(local), T))
            hi_local = np.full((len(local), T), np.inf)
            for j, k in enumerate(local):
                for r, t in enumerate(sla.rows[k]):
                    s = int(sla.row_slice[k][r])
                    if s >= 0:
                        idx[j, r] = s
                    else:
                        lo_local[j, r] = sla.b_min[t]
                        hi_local[j, r] = sla.b_max[t]
            lane, row = np.nonzero(idx < S)

            def index(a):
                return torch.as_tensor(a, dtype=torch.int64, device=self.device)

            rowmap = shd.RowMaps(
                slice_idx=index(idx), lo_local=self._vec(lo_local), hi_local=self._vec(hi_local),
                lane=index(lane), row=index(row), slot=index(idx[lane, row]),
            )
        # the host coordinator's own fail-fast checks
        bad = np.nonzero(dmin > dcap + 1e-9)[0]
        if bad.size:
            k = int(bad[0])
            raise ValueError(
                f"domain {k} minimum draw {dmin[k]:.1f} W exceeds its "
                f"(possibly derated) capacity {dcap[k]:.1f} W; mask devices "
                "out first (FleetLifecycle.device_leave)"
            )
        check_caps_fund_minimums(
            self.coordinator.start, self.coordinator.end, ccap, dmin, what="coordinator row"
        )
        rep = shd.PlanRep(
            dmin_tot=self._vec(dmin),
            dcap=self._vec(dcap),
            ctree=self._ctree._replace(cap=self._vec(ccap)),
            slice_lo=self._vec(slice_lo),
            slice_umax=self._vec(slice_umax),
            forest=forest,
        )
        return rep, rowmap

    def _step_sharded(self, req, active, offs):
        local, N = self._local, self._N
        r, act = self._lane_telemetry(req, active, offs)
        inc = self._inc_carry if self.options.incremental else None
        if self._rec_cfg is not None and self._rec_state is None and self._dom is not None:
            self._rec_state = obs_recorder.init_batch(self._rec_cfg, len(local), N, self.dtype,
                                                      self.device)
        rep, rowmap = self._sharded_plan()
        out = shd.step(
            self._dom,
            self._vec(self._cap_np[local.start : local.stop]),
            self._vec(r),
            torch.as_tensor(act, device=self.device),
            rowmap,
            self._warm,
            inc,
            rep,
            self._rec_state,
            layout=self._shard,
            meta=self.meta,
            opts=self.options.solver,
            coord_mode=self.coordinator.mode,
            rec_cfg=self._rec_cfg,
        )
        self._warm = out.warm
        if self.options.incremental:
            self._inc_carry = out.carry
        if self._rec_cfg is not None:
            self._rec_steps += 1
        alloc = np.concatenate([out.x3[k, : int(self.domain_sizes[k])] for k in range(self.k)])
        has_slices = self._sla is not None and self._sla.n_slices > 0
        return (
            (alloc, StepStats.from_lanes(out.stats, mode="sharded")),
            out.grants,
            out.demand,
            out.slice_lo if has_slices else None,
            out.slice_hi if has_slices else None,
        )

    def _loop_domain_clean(self, k, prev, rk, ak, grant_k, rb_k, tol) -> bool:
        """Host-level dirtiness of one loop-mode domain: clean only when the
        per-device telemetry, activity mask, budget grant and SLA row bounds
        are all within ``tol`` of the anchor step whose frozen allocation we
        would serve.  Comparisons are against the *anchor* (not last step),
        so tol-sized drift cannot creep across a chain of skips."""
        if prev["alloc"][k] is None:
            return False
        if abs(float(grant_k) - float(prev["grants"][k])) > tol:
            return False
        if not np.array_equal(ak, prev["active"][k]):
            return False
        if float(np.max(np.abs(rk - prev["req"][k]), initial=0.0)) > tol:
            return False
        prev_rb = prev["row_bounds"][k]
        if (rb_k is None) != (prev_rb is None):
            return False
        if rb_k is not None and not (
            np.allclose(rb_k[0], prev_rb[0], rtol=0.0, atol=tol)
            and np.allclose(rb_k[1], prev_rb[1], rtol=0.0, atol=tol, equal_nan=False)
        ):
            return False
        return True

    def _step_loop(self, req, active, grants, offs, row_bounds=None, demand=None):
        assert self._engines is not None
        inc = self.options.incremental
        tol = self.options.certify_tol
        if inc and self._loop_prev is None:
            K = self.k
            self._loop_prev = {
                "alloc": [None] * K,
                "req": [None] * K,
                "active": [None] * K,
                "demand": np.full(K, np.nan),
                "grants": np.full(K, np.nan),
                "row_bounds": [None] * K,
            }
        prev = self._loop_prev
        dirty = (
            self.coordinator.domain_dirtiness(
                demand,
                grants,
                prev["demand"],
                prev["grants"],
                tol=tol,
            )
            if inc and demand is not None
            else np.ones(self.k, bool)
        )
        allocs, solves, iters, phase_iters, conv = [], [], [], [], []
        skipped, certify = [], []
        certified, truncated, kkt_res, restarts, kkt_hist = [], [], [], [], []
        for k, eng in enumerate(self._engines):
            rk = req[offs[k] : offs[k + 1]]
            ak = active[offs[k] : offs[k + 1]]
            rb_k = (
                row_bounds[k]
                if row_bounds is not None and row_bounds[k][0].shape[0]
                else None
            )
            if (
                inc
                and not dirty[k]
                and self._loop_domain_clean(k, prev, rk, ak, grants[k], rb_k, tol)
            ):
                # clean domain: serve the frozen allocation, skip the engine
                # dispatch entirely (the anchor values stay frozen too)
                allocs.append(prev["alloc"][k])
                solves.append(0)
                iters.append(0)
                phase_iters.append([0, 0, 0])
                conv.append(True)
                skipped.append(True)
                certify.append(True)
                certified.append(True)
                truncated.append(False)
                kkt_res.append(0.0)
                restarts.append(0)
                kkt_hist.append(np.zeros(KKT_HIST_BUCKETS, np.int32))
                continue
            eng.set_root_cap(grants[k])  # a cap value swap: no rebuild
            if rb_k is not None:
                # an SLA-bound value swap: tenant sub-budgets, no rebuild
                eng.set_sla_bounds(rb_k[0], rb_k[1])
            res = eng.step(rk, active=ak)
            allocs.append(res.allocation)
            solves.append(res.stats["total_solves"])
            iters.append(res.stats["total_iterations"])
            phase_iters.append(res.stats["phase_iterations"])
            conv.append(res.stats["converged"])
            skipped.append(bool(res.stats.get("skipped", False)))
            certify.append(bool(res.stats.get("certify_pass", False)))
            certified.append(bool(res.stats.get("kkt_certified", False)))
            truncated.append(bool(res.stats.get("truncated", False)))
            kkt_res.append(float(res.stats.get("kkt_res", 0.0)))
            restarts.append(int(res.stats.get("restarts", 0)))
            kkt_hist.append(
                np.asarray(
                    res.stats.get("kkt_hist", np.zeros(KKT_HIST_BUCKETS, np.int32))
                )
            )
            if inc:
                prev["alloc"][k] = res.allocation
                prev["req"][k] = rk.copy()
                prev["active"][k] = ak.copy()
                if demand is not None:
                    prev["demand"][k] = float(demand[k])
                prev["grants"][k] = float(grants[k])
                prev["row_bounds"][k] = (
                    (rb_k[0].copy(), rb_k[1].copy()) if rb_k is not None else None
                )
        stats = StepStats.build(
            solves=np.asarray(solves),
            iterations=np.asarray(iters),
            phase_iterations=np.asarray(phase_iters),
            converged=np.asarray(conv),
            skipped=np.asarray(skipped),
            certify_pass=np.asarray(certify),
            kkt_certified=np.asarray(certified),
            truncated=np.asarray(truncated),
            kkt_res=np.asarray(kkt_res),
            restarts=np.asarray(restarts),
            kkt_hist=np.stack(kkt_hist, axis=0),
            mode="loop",
        )
        return np.concatenate(allocs), stats
