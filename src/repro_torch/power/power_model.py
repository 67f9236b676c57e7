"""Device power <-> performance models (the port's copy of
``repro/power/power_model.py``, numpy only).

``DvfsModel`` maps a power cap to the achievable clock and therefore to a
step-time multiplier: dynamic power scales ~f^3 (P = P_static + c * f^3),
throughput scales ~f.  This is what couples nvPAX's allocations back into
the training loop: a capped device runs slower, and in synchronous data-
parallel training the JOB runs at the slowest device's speed (the paper's
straggler motivation, section 1).

``arch_power_profile`` gives per-architecture-family demand shapes used by
the datacenter simulator: MoE dispatch is bursty, SSD is steady, decode is
memory-bound (lower draw), dense training pins near TDP.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DvfsModel", "arch_power_profile"]


@dataclasses.dataclass(frozen=True)
class DvfsModel:
    """P(f) = p_static + (p_peak - p_static) * f^3, f in [f_min, 1]."""

    p_peak: float = 700.0  # W at f = 1
    p_static: float = 90.0  # W leakage + HBM refresh
    f_min: float = 0.4

    def freq_at_cap(self, cap: np.ndarray) -> np.ndarray:
        """Max sustainable normalized clock under a cap (vectorized)."""
        frac = (np.asarray(cap) - self.p_static) / (self.p_peak - self.p_static)
        f = np.cbrt(np.clip(frac, 0.0, 1.0))
        return np.clip(f, self.f_min, 1.0)

    def power_at_freq(self, f: np.ndarray) -> np.ndarray:
        f = np.clip(f, self.f_min, 1.0)
        return self.p_static + (self.p_peak - self.p_static) * f**3

    def step_time_multiplier(self, cap: np.ndarray) -> np.ndarray:
        """Relative step time at a cap vs uncapped (>= 1)."""
        return 1.0 / self.freq_at_cap(cap)


_PROFILES = {
    # (mean draw fraction of TDP, burst amplitude, burst prob per step)
    "dense": (0.88, 0.06, 0.05),
    "moe": (0.74, 0.22, 0.25),  # expert dispatch spikes
    "ssm": (0.82, 0.04, 0.02),  # steady SSD pipeline
    "hybrid": (0.80, 0.15, 0.15),
    "vlm": (0.86, 0.08, 0.08),
    "audio": (0.55, 0.05, 0.02),  # small model, input-bound
    "decode": (0.45, 0.10, 0.10),  # HBM-bound token generation
    "idle": (0.14, 0.0, 0.0),
}


def arch_power_profile(family: str, *, tdp: float = 700.0):
    """(mean_watts, burst_watts, burst_prob) for a family."""
    mean, amp, prob = _PROFILES.get(family, _PROFILES["dense"])
    return mean * tdp, amp * tdp, prob
