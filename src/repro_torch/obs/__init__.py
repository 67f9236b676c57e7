"""Host-side observability of the port: per-step statistics and host
wall-clock spans."""

from repro_torch.obs import spans
from repro_torch.obs.stats import StepStats

__all__ = ["StepStats", "spans"]
