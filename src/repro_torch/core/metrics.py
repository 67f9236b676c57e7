"""Evaluation metrics (paper sections 5.4 and B.2), host numpy: a copy of
the reference's metrics module."""

from __future__ import annotations

import numpy as np

__all__ = [
    "useful_utilization",
    "satisfaction_ratio",
    "relative_improvement",
    "tenant_satisfaction",
    "sla_margin",
]


def useful_utilization(requests: np.ndarray, alloc: np.ndarray) -> float:
    """U = sum_i min(r_i, a_i): allocated power capped by request."""
    return float(np.minimum(requests, alloc).sum())


def satisfaction_ratio(requests: np.ndarray, alloc: np.ndarray) -> float:
    """S = U / sum_i r_i; S = 1 means every device got at least its request."""
    tot = float(requests.sum())
    if tot <= 0:
        return 1.0
    return useful_utilization(requests, alloc) / tot


def relative_improvement(
    requests: np.ndarray, alloc: np.ndarray, baseline: np.ndarray
) -> float:
    """Delta-U vs a baseline allocation, in percent of the baseline."""
    ub = useful_utilization(requests, baseline)
    if ub <= 0:
        return 0.0
    return 100.0 * (useful_utilization(requests, alloc) - ub) / ub


def tenant_satisfaction(
    requests: np.ndarray, alloc: np.ndarray, tenant_of: np.ndarray, n_tenants: int
) -> np.ndarray:
    """Per-tenant S_k; ``tenant_of[i] = -1`` for unassigned devices."""
    out = np.ones((n_tenants,))
    for k in range(n_tenants):
        sel = tenant_of == k
        tot = requests[sel].sum()
        out[k] = 1.0 if tot <= 0 else np.minimum(requests[sel], alloc[sel]).sum() / tot
    return out


def sla_margin(
    alloc: np.ndarray,
    tenant_of: np.ndarray,
    n_tenants: int,
    b_min: np.ndarray,
    b_max: np.ndarray,
) -> np.ndarray:
    """M_k = (sum_Tk a - B_min) / (B_max - B_min); >= 0 means SLA satisfied."""
    out = np.zeros((n_tenants,))
    for k in range(n_tenants):
        tot = alloc[tenant_of == k].sum()
        out[k] = (tot - b_min[k]) / max(b_max[k] - b_min[k], 1e-12)
    return out
