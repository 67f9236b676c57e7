"""Trace-driven datacenter simulation: telemetry -> controller -> caps ->
job throughput.  The experiment harness behind the paper's section 5
(Figure 2: satisfaction ratio and wall per interval over a telemetry trace,
nvPAX against the Static and Greedy baselines), with the performance
feedback loop the paper motivates: caps map to clocks (DVFS) and
synchronous jobs run at their slowest member's clock.

The control plane is one :class:`repro_torch.power.PowerController` over
the whole PDN (the paper's deployment shape, "monolithic" in the
reference).  The reference's fleet mode (per-power-domain engines under a
budget coordinator), its double-buffered telemetry prefetch and its flight
recorder are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core.greedy import greedy_allocate, static_allocate
from repro_torch.core.metrics import satisfaction_ratio
from repro_torch.obs import spans
from repro_torch.pdn.telemetry import TelemetrySim, TraceConfig
from repro_torch.pdn.tenants import TenantLayout
from repro_torch.pdn.tree import FlatPDN
from repro_torch.power.controller import PowerController
from repro_torch.power.power_model import DvfsModel
from repro_torch.power.straggler import straggler_report

__all__ = ["DatacenterSim"]

_FLEET = "ROADMAP Queue 1 item 11"
_RECORDER = "ROADMAP Queue 1 item 10"


def _fleet_unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} needs fleet/, which is not ported yet ({_FLEET})")


@dataclasses.dataclass
class DatacenterSim:
    pdn: FlatPDN
    trace: TelemetrySim
    controller: PowerController | None = None
    orchestrator: Any = None
    tenants: TenantLayout | None = None
    dvfs: DvfsModel = dataclasses.field(default_factory=DvfsModel)

    def __post_init__(self):
        if self.orchestrator is not None:
            raise _fleet_unported("a fleet orchestrator")
        if self.controller is None:
            raise ValueError("DatacenterSim needs a controller (see DatacenterSim.build)")

    @classmethod
    def build(cls, pdn: FlatPDN, *, seed: int = 0,
              controller: PowerController | None = None,
              orchestrator: Any = None,
              fleet_level: int | None = None,
              tenants: TenantLayout | None = None,
              trace_cfg: TraceConfig | None = None,
              recorder=None,
              device=None) -> "DatacenterSim":
        """A simulation of ``pdn`` on the telemetry trace of ``seed``.

        ``controller`` defaults to a :class:`PowerController` on ``device``
        (``None`` means ``cuda``) with the default options, over
        ``tenants``' SLA layout when one is given (which also enables the
        per-step SLA margin metrics in :meth:`run`).  ``orchestrator`` and
        ``fleet_level`` (fleet mode) and ``recorder`` are the reference's
        and raise ``NotImplementedError`` here."""
        if orchestrator is not None or fleet_level is not None:
            raise _fleet_unported("fleet mode (orchestrator=, fleet_level=)")
        if recorder:
            raise NotImplementedError(f"the flight recorder is not ported yet ({_RECORDER})")
        trace = TelemetrySim(trace_cfg or TraceConfig(n_devices=pdn.n, seed=seed))
        if controller is None:
            if tenants is not None:
                controller = PowerController(
                    pdn, sla=tenants.sla_topo(device=device), priority=tenants.priority,
                    device=device,
                )
            else:
                controller = PowerController(pdn, device=device)
        return cls(pdn=pdn, trace=trace, controller=controller, tenants=tenants)

    @classmethod
    def cross_tenant(cls, **kw) -> "DatacenterSim":
        """The reference's cross-tenant fleet scenario (tenants spanning a
        power-domain cut under a fleet orchestrator)."""
        raise _fleet_unported("the cross-tenant scenario")

    def flush_flight(self, *, reset: bool = False):
        """The control plane's flight record: ``None`` while the port has no
        recorder."""
        return self.controller.flush_recorder(reset=reset)

    def run(self, steps: int, *, start: int = 0, baselines: bool = True,
            use_scheduler_state: bool = True,
            prefetch: bool = False) -> dict[str, Any]:
        """Run ``steps`` control intervals; returns per-step metric arrays:
        ``S_nvpax`` (and with ``baselines`` ``S_static``, ``S_greedy``),
        ``wall_ms`` (the controller's step wall), ``straggler_tax``,
        ``truncated`` and, with tenants, the worst tenant lower-SLA margins.
        """
        if prefetch:
            raise _fleet_unported("double-buffered telemetry (prefetch=True)")
        ctrl = self.controller
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
        for t in range(start, start + steps):
            with spans.span("sim.telemetry"):
                power = self.trace.power(t)
                active = self.trace.active_mask(t) if use_scheduler_state else None
            with spans.span("sim.control"):
                res = ctrl.step(power, active=active)
                alloc = res.allocation
                wall = ctrl.history[-1]["wall_s"]
                truncated = bool(res.stats.get("truncated", False))
            with spans.span("sim.metrics"):
                r = np.clip(power, self.pdn.dev_l, self.pdn.dev_u)
                r = np.where(
                    active if active is not None
                    else power >= ctrl.config.idle_threshold,
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
        return {k: np.asarray(v) for k, v in out.items() if v}
