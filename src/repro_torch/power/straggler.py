"""Straggler analysis for synchronous multi-device jobs under power caps.

End-to-end progress of a data-parallel job is the min over its devices'
throughput (paper section 1).  nvPAX's max-min Phase II is an
anti-straggler mechanism: it equalizes headroom within a priority class.
``straggler_report`` quantifies that: per job, slowdown = max step-time
multiplier across the job's devices, and the job-level loss against a
perfectly uniform allocation of the same aggregate power.
"""

from __future__ import annotations

import numpy as np

from repro_torch.power.power_model import DvfsModel

__all__ = ["job_slowdowns", "straggler_report"]


def job_slowdowns(caps: np.ndarray, job_of: np.ndarray,
                  dvfs: DvfsModel | None = None) -> np.ndarray:
    """Per-job synchronous slowdown: max step-time multiplier of members."""
    dvfs = dvfs or DvfsModel()
    mult = dvfs.step_time_multiplier(caps)
    n_jobs = int(job_of.max()) + 1
    out = np.ones(n_jobs)
    np.maximum.at(out, job_of, mult)
    return out


def straggler_report(caps: np.ndarray, job_of: np.ndarray,
                     dvfs: DvfsModel | None = None) -> dict:
    """Compare actual job speed against the uniform-power ideal.

    For each job: ideal = multiplier at the job's MEAN cap (same total
    power, evenly spread); actual = multiplier at the job's MIN cap (sync
    barrier).  straggler_tax = actual / ideal - 1 (0 = perfectly fair)."""
    dvfs = dvfs or DvfsModel()
    n_jobs = int(job_of.max()) + 1
    caps = np.asarray(caps, dtype=np.float64)
    sums = np.zeros(n_jobs)
    counts = np.zeros(n_jobs)
    np.add.at(sums, job_of, caps)
    np.add.at(counts, job_of, 1.0)
    mean_cap = sums / np.maximum(counts, 1.0)
    min_cap = np.full(n_jobs, np.inf)
    np.minimum.at(min_cap, job_of, caps)

    actual = dvfs.step_time_multiplier(min_cap)
    ideal = dvfs.step_time_multiplier(mean_cap)
    tax = actual / ideal - 1.0
    return {
        "mean_tax": float(tax.mean()),
        "max_tax": float(tax.max()),
        "p99_tax": float(np.quantile(tax, 0.99)),
        "jobs": n_jobs,
        "tax": tax,
    }
