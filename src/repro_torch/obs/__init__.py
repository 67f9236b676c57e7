"""Host-side observability of the port (per-step statistics)."""

from repro_torch.obs.stats import StepStats

__all__ = ["StepStats"]
