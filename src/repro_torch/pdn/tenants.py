"""Tenant domains and SLA constraint generation (paper Appendix B setup).

A numpy copy of the reference's tenant module: the same RNG calls, so a
seed gives the same layout, array for array.

Tenants are horizontal: a tenant's device set may span arbitrary branches of
the PDN.  Appendix B's construction: 100 tenants x 100 GPUs each, SLA bounds
at 40%-80% of the tenant's aggregate maximum power; devices owned by tenants
get random priorities in {1, 2, 3}; unassigned devices keep priority 1.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.core.treeops import SlaTopo
from repro_torch.pdn.tree import FlatPDN

__all__ = [
    "TenantLayout",
    "assign_tenants",
    "assign_cross_domain_tenants",
    "appendix_b_layout",
]


@dataclasses.dataclass(frozen=True)
class TenantLayout:
    tenant_of: np.ndarray  # [n] int32, -1 for unassigned devices
    n_tenants: int
    b_min: np.ndarray  # [k] aggregate lower bounds (watts)
    b_max: np.ndarray  # [k] aggregate upper bounds (watts)
    priority: np.ndarray  # [n] int32 device priorities

    def sla_topo(self, dtype=torch.float64, device=None) -> SlaTopo:
        """Incidence-list SlaTopo for the solver, with its kernel index, on
        ``device`` (``None`` means ``cuda``)."""
        dev = np.nonzero(self.tenant_of >= 0)[0].astype(np.int32)
        ten = self.tenant_of[dev].astype(np.int32)
        return SlaTopo.make(
            dev,
            ten,
            self.b_min,
            self.b_max,
            n=self.tenant_of.shape[0],
            dtype=dtype,
            device=resolve_device(device),
        )


def assign_tenants(
    pdn: FlatPDN,
    *,
    n_tenants: int,
    devices_per_tenant: int,
    lo_frac: float = 0.4,
    hi_frac: float = 0.8,
    priorities: tuple[int, ...] = (1, 2, 3),
    scattered: bool = True,
    seed: int = 0,
) -> TenantLayout:
    """Assign ``n_tenants`` disjoint tenants of ``devices_per_tenant`` devices.

    ``scattered=True`` samples devices uniformly across the whole PDN (the
    horizontal-coupling case the paper emphasizes); ``False`` takes
    contiguous DFS ranges (tenants aligned with subtrees — the easy case).
    SLA bounds are ``[lo_frac, hi_frac] * devices_per_tenant * u``.
    """
    n = pdn.n
    need = n_tenants * devices_per_tenant
    if need > n:
        raise ValueError(f"{need} tenant devices > {n} fleet devices")
    rng = np.random.default_rng(seed)
    tenant_of = np.full(n, -1, dtype=np.int32)
    if scattered:
        perm = rng.permutation(n)[:need]
    else:
        perm = np.arange(need)
    for k in range(n_tenants):
        tenant_of[perm[k * devices_per_tenant : (k + 1) * devices_per_tenant]] = k

    # Aggregate bound construction mirrors Appendix B: fractions of the
    # tenant's maximum aggregate power.
    b_min = np.zeros(n_tenants)
    b_max = np.zeros(n_tenants)
    for k in range(n_tenants):
        umax = pdn.dev_u[tenant_of == k].sum()
        b_min[k] = lo_frac * umax
        b_max[k] = hi_frac * umax

    priority = np.ones(n, dtype=np.int32)
    owned = tenant_of >= 0
    priority[owned] = rng.choice(np.asarray(priorities, np.int32), owned.sum())
    return TenantLayout(tenant_of, n_tenants, b_min, b_max, priority)


def assign_cross_domain_tenants(
    pdn: FlatPDN,
    level: int = 1,
    *,
    n_cross: int = 2,
    per_domain: int = 2,
    n_local_per_domain: int = 1,
    local_size: int = 3,
    lo_frac: float = 0.4,
    hi_frac: float = 0.8,
    priorities: tuple[int, ...] = (1, 2, 3),
    seed: int = 0,
) -> TenantLayout:
    """Tenant layout that deliberately spans a fleet partition cut.

    Every *cross* tenant takes ``per_domain`` devices from EACH subtree
    rooted at depth ``level`` (the power domains of
    the reference's ``fleet.split_pdn(pdn, level)``), so its SLA row couples all
    domains — the case the fleet coordinator's entitlement split exists
    for.  Each domain additionally hosts ``n_local_per_domain`` contiguous
    *domain-local* tenants of ``local_size`` devices (the easy case that
    nests inside one engine).  Bounds are ``[lo_frac, hi_frac]`` of each
    tenant's aggregate maximum power, as in :func:`assign_tenants`.
    """
    cut = np.nonzero(pdn.node_depth == level)[0]
    if cut.size < 2:
        raise ValueError(f"need >= 2 domains at depth {level}, got {cut.size}")
    ranges = [(int(pdn.node_start[j]), int(pdn.node_end[j])) for j in cut]
    need = n_cross * per_domain + n_local_per_domain * local_size
    small = min(hi - lo for lo, hi in ranges)
    if need > small:
        raise ValueError(
            f"{need} tenant devices per domain > smallest domain ({small})"
        )
    rng = np.random.default_rng(seed)
    tenant_of = np.full(pdn.n, -1, np.int32)
    n_tenants = n_cross + n_local_per_domain * len(ranges)
    for k, (lo, hi) in enumerate(ranges):
        pick = rng.permutation(np.arange(lo, hi))[:need]
        pos = 0
        for t in range(n_cross):
            tenant_of[pick[pos : pos + per_domain]] = t
            pos += per_domain
        for j in range(n_local_per_domain):
            t = n_cross + k * n_local_per_domain + j
            tenant_of[pick[pos : pos + local_size]] = t
            pos += local_size
    b_min = np.zeros(n_tenants)
    b_max = np.zeros(n_tenants)
    for t in range(n_tenants):
        umax = pdn.dev_u[tenant_of == t].sum()
        b_min[t] = lo_frac * umax
        b_max[t] = hi_frac * umax
    priority = np.ones(pdn.n, np.int32)
    owned = tenant_of >= 0
    priority[owned] = rng.choice(np.asarray(priorities, np.int32), owned.sum())
    return TenantLayout(tenant_of, n_tenants, b_min, b_max, priority)


def appendix_b_layout(pdn: FlatPDN, seed: int = 0) -> TenantLayout:
    """The paper's Appendix B construction: 100 tenants x 100 GPUs,
    SLA = [40%, 80%] of aggregate max (28 kW / 56 kW at u = 700 W)."""
    return assign_tenants(
        pdn,
        n_tenants=100,
        devices_per_tenant=100,
        lo_frac=0.4,
        hi_frac=0.8,
        seed=seed,
    )
