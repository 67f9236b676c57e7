"""Observability of the port: the flight recorder, per-step statistics,
host spans and exporters.

- :mod:`repro_torch.obs.recorder` — the fixed-shape ring of per-step
  telemetry on the device, updated in place by every control plane (engine,
  K-lane batch, controller, fleet, simulator).
- :mod:`repro_torch.obs.stats` — the typed :class:`StepStats` record every
  solve path emits.
- :mod:`repro_torch.obs.spans` — nestable host wall-clock spans.
- :mod:`repro_torch.obs.export` — JSONL / Prometheus exposition / summaries.
- :mod:`repro_torch.obs.report` — the ``python -m repro_torch.obs.report``
  flight-record CLI.
"""

from repro_torch.obs.recorder import (
    FIELDS,
    RecorderConfig,
    RecorderState,
    StepMetrics,
    flush,
    flush_lanes,
    init_batch,
    init_state,
    record_step,
    step_metrics,
)
from repro_torch.obs.stats import StepStats
from repro_torch.obs import spans

__all__ = [
    "FIELDS",
    "RecorderConfig",
    "RecorderState",
    "StepMetrics",
    "StepStats",
    "flush",
    "flush_lanes",
    "init_batch",
    "init_state",
    "record_step",
    "step_metrics",
    "spans",
]
