"""Per-device power telemetry of a training job, one sample a control
step: the draw rule of ``src/repro_torch/launch/train.py`` (``--power-managed``,
commit d455ed1), ``mean + burst * (U(0, 1) < p)`` per device, with the
profile of the job's model family (``power_model.arch_power_profile``, the
same commit) and the seed taken from ``--seed``."""

from __future__ import annotations

import numpy as np

from portbench.gen.traffic import seed_seq

# power_model._PROFILES, frozen: family -> (mean draw and burst amplitude as
# fractions of TDP, burst probability a device a step)
PROFILES = {
    "dense": (0.88, 0.06, 0.05),
    "moe": (0.74, 0.22, 0.25),
    "ssm": (0.82, 0.04, 0.02),
    "hybrid": (0.80, 0.15, 0.15),
    "vlm": (0.86, 0.08, 0.08),
    "audio": (0.55, 0.05, 0.02),
    "decode": (0.45, 0.10, 0.10),
    "idle": (0.14, 0.0, 0.0),
}


class Telemetry:
    def __init__(self, family: str, tdp_w: float, n: int, seed: int):
        mean, burst, prob = PROFILES.get(family, PROFILES["dense"])
        self.mean = mean * tdp_w
        self.burst = burst * tdp_w
        self.prob = prob
        self.n = n
        self.rng = np.random.default_rng(seed_seq(seed, 3))

    def draw(self) -> np.ndarray:
        """The next sample [n] in watts."""
        return self.mean + self.burst * (self.rng.random(self.n) < self.prob)
