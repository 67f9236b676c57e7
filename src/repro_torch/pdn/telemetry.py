"""Synthetic GPU power telemetry with the marginals of the paper's trace.

The paper's evaluation (section 5) uses proprietary H100 telemetry: >12,000
GPUs across 4 halls, sampled every 30 s for three days (8,523 timestamps),
device limits l=200 W / u=700 W, idle threshold 150 W.  We reproduce the
*statistics that drive the policy* rather than the raw watts.  The paper's
headline numbers pin the shape of the demand distribution:

* mean Static satisfaction 81.30% -> a large minority of devices request far
  above the equal share C_root/n ~= 430 W (busy training jobs near TDP);
* mean nvPAX satisfaction 98.92% -> aggregate demand sits at or slightly
  below the root budget at most timestamps;
* min nvPAX satisfaction 96.49% -> occasional global/local shortage
  (synchronized busy jobs + diurnal peaks + placement concentration).

We therefore model a fleet of *jobs* (devices in a job draw synchronized
power — the paper's straggler motivation) drawn from a busy/moderate
mixture, with a diurnal envelope, job churn, heavy bursts, and a
deterministic idle fraction.

Determinism: everything is a pure function of (seed, timestamp index), so
tests, benchmarks and the closed-loop controller see identical traces.

A copy of the reference's ``repro.pdn.telemetry``, kept here so the port
never imports it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TraceConfig", "TelemetrySim"]

_DAY_STEPS = 2880  # 24 h at 30 s cadence


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    n_devices: int
    seed: int = 0
    # power bands (H100 defaults, paper section 5.1)
    idle_low: float = 60.0
    idle_high: float = 140.0
    busy_low: float = 560.0
    busy_high: float = 690.0
    moderate_low: float = 210.0
    moderate_high: float = 370.0
    busy_fraction: float = 0.45  # fraction of running jobs near TDP
    # workload mixture
    mean_job_size: int = 64  # devices per distributed job
    idle_fraction: float = 0.12  # fraction of idle jobs (deterministic)
    diurnal_amplitude: float = 0.08  # fleet envelope
    burst_prob: float = 0.02  # per-job chance of a power burst per step
    burst_gain: float = 1.12
    epoch_len: int = 240  # steps between job churn events (~2 h)


class TelemetrySim:
    """Deterministic synthetic telemetry stream.

    ``power(t)`` returns the measured per-device power (watts) at timestamp
    index ``t``; this is what the controller treats as the request signal
    (the paper uses measured power as the request, section 5.2).
    """

    def __init__(self, cfg: TraceConfig):
        self.cfg = cfg
        root = np.random.default_rng(cfg.seed)
        n = cfg.n_devices
        # Partition the fleet into jobs of geometric-ish sizes.
        sizes = []
        left = n
        while left > 0:
            s = int(root.geometric(1.0 / cfg.mean_job_size))
            s = max(1, min(s, left))
            sizes.append(s)
            left -= s
        self.job_of = np.repeat(np.arange(len(sizes)), sizes)
        self.n_jobs = len(sizes)
        self.job_phase = root.uniform(0, 2 * np.pi)  # fleet-wide diurnal phase
        # per-job uniform draw reused across epochs for its band position
        self.job_u = root.random(self.n_jobs)
        # Device-level jitter scale (telemetry noise, VRM differences).
        self.dev_jitter = root.uniform(0.5, 1.5, n)
        self._seed = cfg.seed

    # -- helpers -----------------------------------------------------------

    def _step_rng(self, t: int) -> np.random.Generator:
        return np.random.default_rng((self._seed * 1_000_003 + t) & 0x7FFFFFFF)

    def _epoch_rng(self, epoch: int) -> np.random.Generator:
        return np.random.default_rng((self._seed * 2_000_003 + epoch) & 0x7FFFFFFF)

    def _epoch_assignments(self, t: int) -> tuple[np.ndarray, np.ndarray]:
        """(job_active, job_busy) for the epoch containing step ``t``.

        Exactly ``round(idle_fraction * n_jobs)`` jobs are idle each epoch
        (deterministic count — small fleets keep a nonzero idle set), and
        ``busy_fraction`` of the running jobs are near-TDP.
        """
        cfg = self.cfg
        epoch = t // cfg.epoch_len
        rng = self._epoch_rng(epoch)
        perm = rng.permutation(self.n_jobs)
        n_idle = int(round(cfg.idle_fraction * self.n_jobs))
        active = np.ones(self.n_jobs, bool)
        active[perm[:n_idle]] = False
        busy = rng.random(self.n_jobs) < cfg.busy_fraction
        return active, busy

    # -- public API --------------------------------------------------------

    def power(self, t: int) -> np.ndarray:
        """Measured per-device power (watts) at timestamp index ``t``."""
        cfg = self.cfg
        rng = self._step_rng(t)
        diurnal = 1.0 + cfg.diurnal_amplitude * np.sin(
            2 * np.pi * t / _DAY_STEPS + self.job_phase
        )
        active_jobs, busy_jobs = self._epoch_assignments(t)
        burst = np.where(rng.random(self.n_jobs) < cfg.burst_prob, cfg.burst_gain, 1.0)
        base_busy = cfg.busy_low + self.job_u * (cfg.busy_high - cfg.busy_low)
        base_mod = cfg.moderate_low + self.job_u * (
            cfg.moderate_high - cfg.moderate_low
        )
        job_power = np.where(busy_jobs, base_busy, base_mod) * diurnal * burst
        p_job = job_power[self.job_of]
        active_dev = active_jobs[self.job_of]
        # Synchronized jobs: small per-device jitter around the job level.
        jitter = rng.normal(0.0, 8.0, cfg.n_devices) * self.dev_jitter
        active_power = p_job + jitter
        idle_power = rng.uniform(cfg.idle_low, cfg.idle_high, cfg.n_devices)
        return np.where(active_dev, active_power, idle_power)

    def active_mask(self, t: int) -> np.ndarray:
        """Scheduler ground truth: which devices belong to a running job."""
        active_jobs, _ = self._epoch_assignments(t)
        return active_jobs[self.job_of]

    def trace(self, n_steps: int, start: int = 0) -> np.ndarray:
        """[n_steps, n] matrix of measured power."""
        return np.stack([self.power(start + t) for t in range(n_steps)])
