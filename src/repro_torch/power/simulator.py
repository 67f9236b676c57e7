"""Trace-driven datacenter simulation: telemetry -> controller -> caps ->
job throughput.  The experiment harness behind the paper's section 5
(Figure 2: satisfaction ratio and wall per interval over a telemetry trace,
nvPAX against the Static and Greedy baselines), with the performance
feedback loop the paper motivates: caps map to clocks (DVFS) and
synchronous jobs run at their slowest member's clock.

Two control planes:

* **monolithic** — one :class:`repro_torch.power.PowerController` over the
  whole PDN (the paper's deployment shape);
* **fleet** — a :class:`repro_torch.fleet.FleetOrchestrator`: per-power-domain
  engines plus the inter-domain budget coordinator (``fleet_level=`` in
  :meth:`DatacenterSim.build`, or pass an orchestrator directly).

``run(prefetch=True)`` overlaps telemetry decode with the solve through the
fleet layer's double-buffered ingestion (valid in both modes; telemetry is
a pure function of the timestamp, so the results are the same).
``recorder=`` turns on the flight recorder of the control plane that
:meth:`DatacenterSim.build` makes; :meth:`DatacenterSim.flush_flight`
drains it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core.greedy import greedy_allocate, static_allocate
from repro_torch.core.metrics import satisfaction_ratio
from repro_torch.fleet import FleetOrchestrator, TelemetryDoubleBuffer
from repro_torch.obs import spans
from repro_torch.pdn.hierarchy_gen import homogeneous_fleet
from repro_torch.pdn.telemetry import TelemetrySim, TraceConfig
from repro_torch.pdn.tenants import TenantLayout, assign_cross_domain_tenants
from repro_torch.pdn.tree import FlatPDN
from repro_torch.power.controller import PowerController
from repro_torch.power.power_model import DvfsModel
from repro_torch.power.straggler import straggler_report

__all__ = ["DatacenterSim"]


@dataclasses.dataclass
class DatacenterSim:
    pdn: FlatPDN
    trace: TelemetrySim
    controller: PowerController | None = None
    orchestrator: FleetOrchestrator | None = None
    tenants: TenantLayout | None = None
    dvfs: DvfsModel = dataclasses.field(default_factory=DvfsModel)

    @classmethod
    def build(cls, pdn: FlatPDN, *, seed: int = 0,
              controller: PowerController | None = None,
              orchestrator: FleetOrchestrator | None = None,
              fleet_level: int | None = None,
              tenants: TenantLayout | None = None,
              trace_cfg: TraceConfig | None = None,
              recorder=None,
              device=None) -> "DatacenterSim":
        """A simulation of ``pdn`` on the telemetry trace of ``seed``.

        ``fleet_level`` switches to fleet mode: the PDN is cut at that depth
        into power domains served by a :class:`FleetOrchestrator` on
        ``device`` (waterfill budget coordination); pass ``orchestrator``
        instead for a custom-configured one.  Otherwise ``controller``
        defaults to a :class:`PowerController` on ``device`` (``None``
        means ``cuda``) with the default options.  ``tenants`` attaches a
        tenant SLA layout to whichever control plane is built — tenants may
        span the fleet cut (the coordinator splits their entitlements per
        step) — and enables the per-step SLA margin metrics in :meth:`run`.
        ``recorder`` (True or a :class:`repro_torch.obs.recorder.RecorderConfig`)
        turns on the flight recorder of whichever control plane is built
        here; drain it with :meth:`flush_flight`."""
        trace = TelemetrySim(trace_cfg or TraceConfig(n_devices=pdn.n, seed=seed))
        if controller is not None and (orchestrator is not None or fleet_level is not None):
            raise ValueError(
                "controller and orchestrator/fleet_level are mutually exclusive control planes"
            )
        if orchestrator is None and fleet_level is not None:
            orchestrator = FleetOrchestrator(pdn, level=fleet_level, tenants=tenants,
                                             recorder=recorder, device=device)
        if orchestrator is None and controller is None:
            if tenants is not None:
                controller = PowerController(
                    pdn, sla=tenants.sla_topo(device=device), priority=tenants.priority,
                    recorder=recorder, device=device,
                )
            else:
                controller = PowerController(pdn, recorder=recorder, device=device)
        return cls(pdn=pdn, trace=trace, controller=controller, orchestrator=orchestrator,
                   tenants=tenants)

    @classmethod
    def cross_tenant(cls, *, n_domains: int = 4, seed: int = 0,
                     lo_frac: float = 0.5, hi_frac: float = 0.8, device=None,
                     **tenant_kw) -> "DatacenterSim":
        """Cross-tenant scenario generator: a homogeneous K-domain fleet
        whose tenants deliberately span the domain cut, served by a
        :class:`FleetOrchestrator` with coordinator-level SLA enforcement
        (the multi-tenant half of the paper's title at fleet scale)."""
        pdn = homogeneous_fleet(n_domains)
        tenants = assign_cross_domain_tenants(
            pdn, 1, lo_frac=lo_frac, hi_frac=hi_frac, seed=seed, **tenant_kw
        )
        return cls.build(pdn, seed=seed, fleet_level=1, tenants=tenants, device=device)

    @property
    def _idle_threshold(self) -> float:
        if self.orchestrator is not None:
            return self.orchestrator.idle_threshold
        return self.controller.config.idle_threshold

    def _step_alloc(self, power, active):
        """Dispatch one control step; returns (allocation, wall_s, truncated)."""
        if self.orchestrator is not None:
            res = self.orchestrator.step(power, active=active)
            return res.allocation, res.wall_time_s, False
        res = self.controller.step(power, active=active)
        wall = self.controller.history[-1]["wall_s"]
        return res.allocation, wall, bool(res.stats.get("truncated", False))

    def flush_flight(self, *, reset: bool = False):
        """Drain the control plane's flight record to the host (``None``
        when the sim was built without ``recorder=``)."""
        plane = self.orchestrator or self.controller
        if plane is None:
            return None
        return plane.flush_recorder(reset=reset)

    def run(self, steps: int, *, start: int = 0, baselines: bool = True,
            use_scheduler_state: bool = True,
            prefetch: bool = False) -> dict[str, Any]:
        """Run ``steps`` control intervals; returns per-step metric arrays:
        ``S_nvpax`` (and with ``baselines`` ``S_static``, ``S_greedy``),
        ``wall_ms`` (the control plane's step wall), ``straggler_tax``,
        ``truncated`` and, with tenants, the worst tenant lower-SLA margins.

        ``prefetch`` decodes step ``t + 1``'s telemetry on a background
        worker while step ``t`` solves (double-buffered ingestion; same
        results, lower per-step host time).
        """
        out: dict[str, list] = {
            "S_nvpax": [], "S_static": [], "S_greedy": [],
            "wall_ms": [], "straggler_tax": [], "truncated": [],
            "sla_min_margin": [], "sla_min_margin_static": [],
        }

        def _min_margin(alloc: np.ndarray) -> float:
            """Worst tenant lower-SLA margin (watts); >= 0 = all honored."""
            lay = self.tenants
            sums = np.bincount(
                lay.tenant_of[lay.tenant_of >= 0],
                weights=alloc[lay.tenant_of >= 0],
                minlength=lay.n_tenants,
            )
            return float((sums - lay.b_min).min())

        # the static baseline is request-independent: one allocation serves
        # every step (hoisted out of the loop)
        static_alloc = static_allocate(self.pdn) if baselines else None
        fetch = self.trace.power
        buf = None
        if prefetch:
            buf = TelemetryDoubleBuffer(self.trace.power)
            fetch = buf.fetch
        try:
            for t in range(start, start + steps):
                with spans.span("sim.telemetry"):
                    power = fetch(t)
                    active = self.trace.active_mask(t) if use_scheduler_state else None
                with spans.span("sim.control"):
                    alloc, wall, truncated = self._step_alloc(power, active)
                with spans.span("sim.metrics"):
                    r = np.clip(power, self.pdn.dev_l, self.pdn.dev_u)
                    r = np.where(
                        active if active is not None else power >= self._idle_threshold,
                        r, self.pdn.dev_l,
                    )
                    out["S_nvpax"].append(satisfaction_ratio(r, alloc))
                    out["wall_ms"].append(1000 * wall)
                    out["truncated"].append(truncated)
                    rep = straggler_report(alloc, self.trace.job_of, self.dvfs)
                    out["straggler_tax"].append(rep["mean_tax"])
                    if self.tenants is not None:
                        out["sla_min_margin"].append(_min_margin(alloc))
                        if baselines:
                            out["sla_min_margin_static"].append(_min_margin(static_alloc))
                    if baselines:
                        out["S_static"].append(satisfaction_ratio(r, static_alloc))
                        out["S_greedy"].append(
                            satisfaction_ratio(r, greedy_allocate(self.pdn, power))
                        )
        finally:
            if buf is not None:
                buf.close()
        return {k: np.asarray(v) for k, v in out.items() if v}
