"""Partition a datacenter PDN into independent power domains.

A numpy copy of the reference's partition module (host-only bookkeeping:
no tensor is made here).  The fleet orchestrator shards the monolithic allocation problem by cutting the PDN tree at
a chosen depth: every node at ``level`` becomes the root of one *power
domain* — an independent subtree with its own allocation engine.  Because
devices are DFS-ordered (see :mod:`repro_torch.pdn.tree`), each domain owns a
contiguous device range and a contiguous node range, so splitting is pure
array slicing and the global allocation is the concatenation of the
per-domain allocations.

What remains above the cut — the root feed and any intermediate nodes at
depth < ``level`` — becomes the *coordinator tree*: a small tree whose
leaves are the domains themselves.  The inter-domain budget coordinator
(:mod:`repro_torch.fleet.coordinator`) solves a miniature allocation problem over
it (domains as "devices", their aggregate demands as "requests"), which is
the two-level hierarchical solve the paper motivates: per-domain solvers
respect intra-domain caps, the coordinator respects every cap above the
cut.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.pdn.tree import FlatPDN

__all__ = [
    "DomainSpec",
    "FleetPartition",
    "FleetSla",
    "build_fleet_sla",
    "split_pdn",
]


@dataclasses.dataclass(frozen=True)
class DomainSpec:
    """One power domain: a subtree cut out of the fleet PDN.

    ``pdn`` is the rebased local topology (domain root = local node 0,
    local device 0 = global device ``dev_lo``).  The local root capacity
    equals the cut node's capacity; the coordinator may grant less (never
    more than ancestors allow).
    """

    index: int
    node_lo: int  # global node range [node_lo, node_hi)
    node_hi: int
    dev_lo: int  # global device range [dev_lo, dev_hi)
    dev_hi: int
    pdn: FlatPDN  # rebased local topology

    @property
    def n(self) -> int:
        return self.dev_hi - self.dev_lo

    @property
    def m(self) -> int:
        return self.node_hi - self.node_lo

    @property
    def cap(self) -> float:
        return float(self.pdn.node_cap[0])


@dataclasses.dataclass(frozen=True)
class FleetSla:
    """Tenant SLA layout over a domain cut (the coordinator-level SLA view).

    Tenants whose devices all live in one domain are *domain-local*: their
    contractual ``[b_min, b_max]`` row is handed to that domain's engine
    verbatim.  Tenants spanning the cut are *cross-cut*: each per-domain
    device subset becomes one *slice*, and the coordinator splits the
    tenant's contractual bounds into per-slice sub-budgets every control
    step (:meth:`repro_torch.fleet.coordinator.BudgetCoordinator.plan_sla`), so
    each domain engine sees its slice as an ordinary SLA box.

    Structure is pure bookkeeping over *local* device indices — it stays
    valid across box re-pins (join/leave masks) and is rebuilt only when
    membership itself changes (``FleetOrchestrator.rebuild_domain``).

    Per-domain rows are ordered by ascending global tenant id; slices are
    grouped by cross-cut tenant (``ten_start``/``ten_end`` ranges over the
    slice arrays), so the entitlement split can treat tenants as the
    "nodes" of a one-level forest and reuse the water-filling kernels.
    """

    n_tenants: int
    b_min: np.ndarray  # [T] contractual aggregate lower bounds (watts)
    b_max: np.ndarray  # [T] contractual aggregate upper bounds (watts)
    cross: np.ndarray  # [T] bool: tenant spans >1 domain
    # per-domain SLA rows (tuples indexed by domain)
    rows: tuple[np.ndarray, ...]  # [R_k] global tenant id per row, ascending
    row_dev: tuple[tuple[np.ndarray, ...], ...]  # [k][r] local device indices
    row_slice: tuple[np.ndarray, ...]  # [R_k] global slice index, -1 if local
    # cross-cut slices, grouped by tenant
    slice_tenant: np.ndarray  # [S] global tenant id
    slice_domain: np.ndarray  # [S] domain index
    slice_row: np.ndarray  # [S] row index within the owning domain
    ten_start: np.ndarray  # [Tc] slice range start per cross-cut tenant
    ten_end: np.ndarray  # [Tc]
    cross_ids: np.ndarray  # [Tc] global tenant id per cross-cut tenant

    @property
    def n_slices(self) -> int:
        return int(self.slice_tenant.shape[0])

    @property
    def k(self) -> int:
        return len(self.rows)

    def n_rows(self, k: int) -> int:
        return int(self.rows[k].shape[0])

    def n_edges(self, k: int) -> int:
        return int(sum(d.shape[0] for d in self.row_dev[k]))

    @property
    def max_rows(self) -> int:
        return max((self.n_rows(k) for k in range(self.k)), default=0)

    @property
    def max_edges(self) -> int:
        return max((self.n_edges(k) for k in range(self.k)), default=0)

    def edges(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        """(dev, ten) incidence edge list of domain ``k``'s SLA rows, in
        local device indices / local row indices (``SlaTopo`` layout)."""
        if self.n_rows(k) == 0:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        dev = np.concatenate(self.row_dev[k]).astype(np.int32)
        ten = np.concatenate(
            [np.full(d.shape[0], r, np.int32) for r, d in enumerate(self.row_dev[k])]
        )
        return dev, ten


def build_fleet_sla(
    tenant_of_domains: Sequence[np.ndarray],
    b_min: np.ndarray,
    b_max: np.ndarray,
) -> FleetSla:
    """Classify tenants against a domain cut and build the SLA layout.

    ``tenant_of_domains[k]`` maps domain ``k``'s local devices to global
    tenant ids (-1 for unassigned).  Tenancy must be disjoint (each device
    belongs to at most one tenant), which this representation guarantees.
    """
    b_min = np.asarray(b_min, np.float64)
    b_max = np.asarray(b_max, np.float64)
    if b_min.shape != b_max.shape or b_min.ndim != 1:
        raise ValueError(f"b_min/b_max shapes {b_min.shape}/{b_max.shape} malformed")
    T = int(b_min.shape[0])
    if (b_min < 0).any() or (b_min > b_max + 1e-9).any():
        raise ValueError("tenant bounds must satisfy 0 <= b_min <= b_max")
    K = len(tenant_of_domains)
    rows: list[np.ndarray] = []
    row_dev: list[tuple[np.ndarray, ...]] = []
    n_domains_of = np.zeros(T, np.int64)
    for k in range(K):
        t_of = np.asarray(tenant_of_domains[k], np.int32)
        if t_of.ndim != 1:
            raise ValueError(f"domain {k} tenant_of must be 1-D")
        if (t_of >= T).any() or (t_of < -1).any():
            raise ValueError(f"domain {k} tenant ids outside [-1, {T})")
        present = np.unique(t_of[t_of >= 0])
        rows.append(present.astype(np.int32))
        row_dev.append(
            tuple(np.nonzero(t_of == t)[0].astype(np.int32) for t in present)
        )
        n_domains_of[present] += 1
    cross = n_domains_of > 1
    cross_ids = np.nonzero(cross)[0].astype(np.int32)
    # slices grouped by tenant: iterate cross-cut tenants in id order, and
    # for each, its domains in index order
    slice_tenant: list[int] = []
    slice_domain: list[int] = []
    slice_row: list[int] = []
    ten_start = np.zeros(cross_ids.shape[0], np.int32)
    ten_end = np.zeros(cross_ids.shape[0], np.int32)
    row_slice = [np.full(r.shape[0], -1, np.int32) for r in rows]
    for i, t in enumerate(cross_ids):
        ten_start[i] = len(slice_tenant)
        for k in range(K):
            r = int(np.searchsorted(rows[k], t))
            if r < rows[k].shape[0] and rows[k][r] == t:
                row_slice[k][r] = len(slice_tenant)
                slice_tenant.append(int(t))
                slice_domain.append(k)
                slice_row.append(r)
        ten_end[i] = len(slice_tenant)
    return FleetSla(
        n_tenants=T,
        b_min=b_min.copy(),
        b_max=b_max.copy(),
        cross=cross,
        rows=tuple(rows),
        row_dev=tuple(row_dev),
        row_slice=tuple(row_slice),
        slice_tenant=np.asarray(slice_tenant, np.int32),
        slice_domain=np.asarray(slice_domain, np.int32),
        slice_row=np.asarray(slice_row, np.int32),
        ten_start=ten_start,
        ten_end=ten_end,
        cross_ids=cross_ids,
    )


@dataclasses.dataclass(frozen=True)
class FleetPartition:
    """A fleet PDN split into K domains + the coordinator tree above them.

    The coordinator tree is expressed in *domain index space*: node ``a``
    covers domains ``[coord_start[a], coord_end[a])``, with capacity
    ``coord_cap[a]``.  Node 0 is the root feed.  It has the same
    DFS-contiguity invariant as the device-level tree, so the same
    water-filling code applies to both levels.
    """

    pdn: FlatPDN  # the full fleet
    level: int  # cut depth (domain roots have this depth globally)
    domains: tuple[DomainSpec, ...]
    coord_start: np.ndarray  # [m_anc] int32, in domain indices
    coord_end: np.ndarray  # [m_anc] int32
    coord_cap: np.ndarray  # [m_anc] float64
    coord_depth: np.ndarray  # [m_anc] int32
    sla: FleetSla | None = None  # tenant layout over the cut (if any)

    @property
    def k(self) -> int:
        return len(self.domains)

    @property
    def domain_cap(self) -> np.ndarray:
        """[K] cut-node capacities (each domain's own subtree budget)."""
        return np.array([d.cap for d in self.domains])

    def domain_of_device(self) -> np.ndarray:
        """[n] domain index of every device."""
        out = np.empty(self.pdn.n, np.int32)
        for d in self.domains:
            out[d.dev_lo : d.dev_hi] = d.index
        return out

    def split_device_array(self, x: np.ndarray) -> list[np.ndarray]:
        """Slice a global ``[..., n]`` device array into per-domain views."""
        return [x[..., d.dev_lo : d.dev_hi] for d in self.domains]


def _extract_domain(pdn: FlatPDN, index: int, node_lo: int, node_hi: int) -> DomainSpec:
    dev_lo = int(pdn.node_start[node_lo])
    dev_hi = int(pdn.node_end[node_lo])
    node_sl = slice(node_lo, node_hi)
    parent = pdn.node_parent[node_sl] - node_lo
    parent[0] = -1
    local = FlatPDN(
        node_start=(pdn.node_start[node_sl] - dev_lo).astype(np.int32),
        node_end=(pdn.node_end[node_sl] - dev_lo).astype(np.int32),
        node_cap=pdn.node_cap[node_sl].copy(),
        node_parent=parent.astype(np.int32),
        node_depth=(pdn.node_depth[node_sl] - pdn.node_depth[node_lo]).astype(np.int32),
        dev_l=pdn.dev_l[dev_lo:dev_hi].copy(),
        dev_u=pdn.dev_u[dev_lo:dev_hi].copy(),
        dev_node=(pdn.dev_node[dev_lo:dev_hi] - node_lo).astype(np.int32),
        dev_depth=(pdn.dev_depth[dev_lo:dev_hi] - pdn.node_depth[node_lo]).astype(
            np.int32
        ),
    )
    local.validate()
    return DomainSpec(
        index=index,
        node_lo=node_lo,
        node_hi=node_hi,
        dev_lo=dev_lo,
        dev_hi=dev_hi,
        pdn=local,
    )


def split_pdn(pdn: FlatPDN, level: int, *, tenants=None) -> FleetPartition:
    """Cut the fleet tree at depth ``level`` into independent power domains.

    Every node at ``level`` roots one domain.  Devices must all live at or
    below the cut — a device attached directly to an ancestor node would
    belong to no domain, which is a partitioning error, not a degenerate
    case (put the cut above it instead).

    ``tenants`` (anything with ``tenant_of``/``b_min``/``b_max``, e.g. a
    :class:`repro_torch.pdn.tenants.TenantLayout`) attaches the tenant SLA layout:
    tenants are classified domain-local vs cross-cut against this cut and
    the coordinator-level slice structure is emitted as ``partition.sla``
    (see :class:`FleetSla`).
    """
    if level < 1:
        raise ValueError(f"cut level must be >= 1, got {level}")
    depth = pdn.node_depth
    cut_nodes = np.nonzero(depth == level)[0]
    if cut_nodes.size == 0:
        raise ValueError(
            f"no nodes at depth {level} (tree depth max {int(depth.max())})"
        )
    shallow = depth[pdn.dev_node] < level
    if shallow.any():
        i = int(np.nonzero(shallow)[0][0])
        raise ValueError(
            f"device {i} is attached to node {int(pdn.dev_node[i])} above the "
            f"cut (depth {int(depth[pdn.dev_node[i]])} < {level}); choose a "
            "deeper attachment or a shallower cut"
        )
    # subtree node range of cut node j: [j, next node with depth <= level)
    domains = []
    for idx, j in enumerate(cut_nodes):
        after = np.nonzero(depth[j + 1 :] <= level)[0]
        j_hi = int(j + 1 + after[0]) if after.size else pdn.m
        domains.append(_extract_domain(pdn, idx, int(j), j_hi))
    # domains must tile the device range exactly
    lo = 0
    for d in domains:
        if d.dev_lo != lo:
            raise ValueError(
                f"domains do not tile the device range at {lo} (domain "
                f"{d.index} starts at {d.dev_lo})"
            )
        lo = d.dev_hi
    if lo != pdn.n:
        raise ValueError(f"domains cover {lo} of {pdn.n} devices")
    # coordinator tree: nodes above the cut, ranges rebased to domain indices
    anc = np.nonzero(depth < level)[0]
    dom_lo = np.array([d.dev_lo for d in domains])
    coord_start = np.searchsorted(dom_lo, pdn.node_start[anc], side="left")
    coord_end = np.searchsorted(dom_lo, pdn.node_end[anc] - 1, side="right")
    sla = None
    if tenants is not None:
        tenant_of = np.asarray(tenants.tenant_of, np.int32)
        if tenant_of.shape != (pdn.n,):
            raise ValueError(f"tenant_of shape {tenant_of.shape} != ({pdn.n},)")
        sla = build_fleet_sla(
            [tenant_of[d.dev_lo : d.dev_hi] for d in domains],
            tenants.b_min,
            tenants.b_max,
        )
    return FleetPartition(
        pdn=pdn,
        level=level,
        domains=tuple(domains),
        coord_start=coord_start.astype(np.int32),
        coord_end=coord_end.astype(np.int32),
        coord_cap=pdn.node_cap[anc].copy(),
        coord_depth=depth[anc].copy(),
        sla=sla,
    )
