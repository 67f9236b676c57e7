"""Closed-loop power controller (the paper's deployment shape, section 3).

Every control interval (30 s in the paper) the controller:
  1. collects per-device power telemetry (or job-model predictions),
  2. classifies active/idle (scheduler info when available, else the
     150 W power threshold),
  3. hands the pre-processed requests to the persistent allocation engine
     (:class:`repro_torch.core.engine.AllocEngine`) — built once per fleet
     topology, serving every step without rebuilding, warm-started,
  4. returns enforceable per-device caps.

``ControllerConfig(use_engine=False)`` selects the rebuild-every-step path
(``AllocProblem.build`` + ``nvpax.optimize`` per step); the engine path
matches it to solver tolerance.

Faults follow the paper: device failures and supply drops are handled by
the next cycle (failed devices request nothing and are pinned at ``l``; a
supply drop rescales node capacities, which re-pins the engine).  No
controller state must survive a crash: the warm start is an optimization,
not a correctness dependency.

``device=None`` means ``cuda``; pass ``device="cpu"`` to run on the CPU.
``recorder=`` (True or a :class:`repro_torch.obs.recorder.RecorderConfig`)
turns on the engine's flight recorder; :meth:`PowerController.flush_recorder`
drains it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np

from repro_torch.compat import resolve_device
from repro_torch.core.batched import optimize_batched
from repro_torch.core.engine import AllocEngine
from repro_torch.core.nvpax import AllocResult, NvpaxOptions, optimize
from repro_torch.core.problem import AllocProblem, FleetTopology
from repro_torch.pdn.tree import FlatPDN, check_caps_fund_minimums

__all__ = ["ControllerConfig", "PowerController"]


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    idle_threshold: float = 150.0
    interval_s: float = 30.0
    options: NvpaxOptions = dataclasses.field(default_factory=NvpaxOptions)
    # request headroom: caps are set slightly above measured power so jobs
    # can ramp between control steps (PRS-style reservation steering)
    request_margin: float = 1.05
    # serve steps from the persistent engine (False = rebuild-every-step
    # host path, kept for A/B comparison)
    use_engine: bool = True


class PowerController:
    def __init__(
        self,
        pdn: FlatPDN,
        *,
        sla=None,
        priority: np.ndarray | None = None,
        config: ControllerConfig | None = None,
        recorder=None,
        device=None,
    ):
        self.pdn = pdn
        self.sla = sla
        self.priority = priority
        self.config = config or ControllerConfig()
        # flight-recorder config forwarded to the engine (True = defaults);
        # engine path only
        self.recorder = recorder
        self.device = resolve_device(device)
        self._warm = None
        self._engine: AllocEngine | None = None
        self._topology: FleetTopology | None = None
        self.failed = np.zeros(pdn.n, dtype=bool)
        self.supply_scale = 1.0
        self.history: list[dict[str, Any]] = []

    # -- fault events ------------------------------------------------------

    def fail_devices(self, idx) -> None:
        """Mark devices failed; they are excluded from allocation (pinned at
        ``l`` with no request) starting next control step."""
        self.failed[np.asarray(idx)] = True
        self.reset_warm()  # geometry changed; cold-start next solve

    def restore_devices(self, idx) -> None:
        self.failed[np.asarray(idx)] = False
        self.reset_warm()

    def set_supply_scale(self, scale: float) -> None:
        """Utility feed reduction (e.g. a grid event): all node capacities
        are scaled starting next step.  The existing engine is re-pinned in
        place (``AllocEngine.rescale_supply``), with no rebuild; the legacy
        path's prebuilt topology is rebuilt lazily."""
        scale = float(scale)
        # validate before committing any state
        check_caps_fund_minimums(
            self.pdn.node_start,
            self.pdn.node_end,
            self.pdn.node_cap * scale,
            self.pdn.dev_l,
            what=f"supply scale {scale}: node",
        )
        self.supply_scale = scale
        self.reset_warm()
        if self._engine is not None:
            self._engine.rescale_supply(self.supply_scale)
        self._topology = None

    def reset_warm(self) -> None:
        """Drop carried solver state: the next step cold-starts."""
        self._warm = None
        if self._engine is not None:
            self._engine.reset_warm()

    def rebuild_count(self) -> int:
        """The engine's :meth:`~repro_torch.core.engine.AllocEngine.rebuild_count`
        (0 before its first step)."""
        return 0 if self._engine is None else self._engine.rebuild_count()

    # -- problem construction (the legacy step path) -----------------------

    def _effective_pdn(self) -> FlatPDN:
        if self.supply_scale == 1.0:
            return self.pdn
        return dataclasses.replace(self.pdn, node_cap=self.pdn.node_cap * self.supply_scale)

    def _preprocess(self, telemetry: np.ndarray, active: np.ndarray | None):
        """Controller-level request shaping: ramp margin + failure masking."""
        requests = np.asarray(telemetry, dtype=np.float64) * self.config.request_margin
        req = np.where(self.failed, 0.0, requests)
        if active is not None:
            active = np.asarray(active, bool) & ~self.failed
        return req, active

    def _get_topology(self) -> FleetTopology:
        if self._topology is None:
            self._topology = FleetTopology.from_pdn(
                self._effective_pdn(), sla=self.sla, device=self.device
            )
        return self._topology

    def _build_problem(self, telemetry: np.ndarray, active: np.ndarray | None) -> AllocProblem:
        req, active = self._preprocess(telemetry, active)
        return AllocProblem.build(
            self._effective_pdn(),
            req,
            active=active,
            idle_threshold=self.config.idle_threshold,
            priority=self.priority,
            topology=self._get_topology(),
        )

    def _get_engine(self) -> AllocEngine:
        if self._engine is None:
            # build from the unscaled PDN and re-pin: rescale_supply scales
            # are absolute vs construction-time caps
            self._engine = AllocEngine(
                self.pdn,
                sla=self.sla,
                priority=self.priority,
                options=self.config.options,
                idle_threshold=self.config.idle_threshold,
                recorder=self.recorder,
                device=self.device,
            )
            if self.supply_scale != 1.0:
                self._engine.rescale_supply(self.supply_scale, reset_warm=False)
        return self._engine

    def flush_recorder(self, *, reset: bool = False):
        """The engine's flight record as host numpy (see
        :meth:`repro_torch.core.engine.AllocEngine.flush_recorder`); ``None``
        when recording is off or no engine step has run yet."""
        if self._engine is None:
            return None
        return self._engine.flush_recorder(reset=reset)

    # -- main loop ---------------------------------------------------------

    def step(self, telemetry: np.ndarray, *, active: np.ndarray | None = None) -> AllocResult:
        """One control step: telemetry [n] watts -> allocation (caps).

        Failed devices are forced idle by zeroing their request; their box
        stays [l, u] to keep the PDN feasible, so they are pinned at l.
        """
        cfg = self.config
        if cfg.use_engine:
            req, act = self._preprocess(telemetry, active)
            engine = self._get_engine()
            res = engine.step(req, active=act)
            self.history.append(engine.history[-1])
            return res
        ap = self._build_problem(telemetry, active)
        t0 = time.perf_counter()
        res = optimize(ap, cfg.options, warm=self._warm)
        wall = time.perf_counter() - t0
        self._warm = res.warm_state
        self.history.append(
            {
                "wall_s": wall,
                "converged": res.stats["converged"],
                "solves": res.stats["total_solves"],
                "iterations": res.stats["total_iterations"],
            }
        )
        return res

    # -- batched what-if evaluation ----------------------------------------

    def step_batched(
        self,
        telemetry_batch: np.ndarray,
        *,
        active: np.ndarray | None = None,
        carry_warm: bool = True,
    ):
        """Evaluate K candidate telemetry scenarios in one solve.

        ``telemetry_batch`` is ``[K, n]`` watts (e.g. MPC candidate futures,
        per-tenant perturbations, robustness samples); ``active`` is either
        ``[n]`` (shared job placement across scenarios) or ``[K, n]``.

        Applies the same request pre-processing, failure masking and supply
        scaling as :meth:`step` but does NOT advance the controller's
        allocation state or history.  With ``carry_warm`` (default), the
        batched solver warm start is carried across consecutive calls of the
        same batch size — an iteration-count optimization that preserves
        solution *quality* but, on tenant-SLA fleets, may pick a different
        equal-quality vertex of the eps-degenerate max-min LPs.  Use
        :meth:`what_if` (``carry_warm=False``) when call-to-call determinism
        matters.  Returns a
        :class:`repro_torch.core.batched.BatchedAllocResult` with ``[K, n]``
        feasible allocations.
        """
        telemetry_batch = np.asarray(telemetry_batch, dtype=np.float64)
        if telemetry_batch.ndim != 2 or telemetry_batch.shape[0] == 0:
            raise ValueError(
                f"telemetry_batch must be [K, n] with K >= 1, got {telemetry_batch.shape}"
            )
        K, n = telemetry_batch.shape
        if active is not None:
            active = np.asarray(active, bool)
            if active.shape not in ((n,), (K, n)):
                raise ValueError(f"active must be [{n}] or [{K}, {n}], got {active.shape}")
        if self.config.use_engine:
            req = np.where(self.failed, 0.0, telemetry_batch * self.config.request_margin)
            if active is not None:
                active = active & ~self.failed
            return self._get_engine().step_batched(req, active=active, carry_warm=carry_warm)
        if active is None:
            act_rows = [None] * K
        elif active.shape == (n,):
            act_rows = [active] * K
        else:
            act_rows = [active[k] for k in range(K)]
        # the prebuilt topology is shared across scenarios, so per-scenario
        # builds are telemetry-only and stacking skips the equality compare
        aps = [self._build_problem(telemetry_batch[k], act_rows[k]) for k in range(K)]
        return optimize_batched(aps, self.config.options)

    def what_if(self, telemetry_batch: np.ndarray, **kw):
        """Strictly stateless :meth:`step_batched` (MPC / scenario-sweep
        reads): no warm carry, so identical inputs give identical outputs."""
        kw.setdefault("carry_warm", False)
        return self.step_batched(telemetry_batch, **kw)
