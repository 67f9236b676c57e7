"""Power-distribution-network (PDN) topology: construction and flattening.

The PDN is a rooted tree: utility feed -> halls -> racks -> servers ->
devices.  Internal nodes carry power capacities; devices (leaves) carry
``[l, u]`` power limits, requests, priorities and active/idle state.

The key representation decision (see DESIGN.md section 2): devices are
numbered in DFS order so that the device set of every subtree is a
*contiguous range* ``[start, end)``.  All hierarchical capacity constraints
then reduce to prefix-sum differences, which is what makes the constrained
solves matrix-free and TPU-friendly.

Everything in this module is host-side numpy; the flattened arrays are
handed to torch in :mod:`repro_torch.core.problem`.  It is a copy of the
reference's ``repro.pdn.tree``, kept here so the port never imports it.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np

__all__ = [
    "PDNNode",
    "FlatPDN",
    "flatten",
    "build_datacenter",
    "build_from_level_sizes",
    "check_caps_fund_minimums",
]


def check_caps_fund_minimums(
    start: np.ndarray,
    end: np.ndarray,
    cap: np.ndarray,
    lower: np.ndarray,
    *,
    what: str = "node",
    tol: float = 1e-9,
) -> np.ndarray:
    """Necessary-feasibility check shared by every capacity re-pin path.

    For DFS-contiguous ranges ``[start_j, end_j)`` over per-leaf lower
    bounds ``lower``, verify each range's capacity can fund the covered
    minimum draw; raise ``ValueError`` naming the first violated row
    otherwise.  Works at both levels of the hierarchy: device-level PDN
    nodes (``lower`` = device minimums) and the fleet coordinator tree
    (``lower`` = per-domain minimum draws).  Returns the per-row minimum
    draws for callers that cache them.
    """
    csum = np.concatenate([[0.0], np.cumsum(np.asarray(lower, np.float64))])
    lmin = csum[end] - csum[start]
    bad = np.nonzero(lmin > np.asarray(cap, np.float64) + tol)[0]
    if bad.size:
        j = int(bad[0])
        raise ValueError(
            f"infeasible: {what} {j} cap {float(cap[j]):.1f} W < covered "
            f"minimum draw {lmin[j]:.1f} W"
        )
    return lmin


@dataclasses.dataclass
class PDNNode:
    """One internal node of the PDN tree.

    ``capacity`` is the node's power capacity in watts.  ``n_devices``
    devices may be attached *directly* to the node (in addition to child
    nodes); device limits are supplied at flatten time or default to the
    tree-wide defaults.
    """

    capacity: float
    children: list["PDNNode"] = dataclasses.field(default_factory=list)
    n_devices: int = 0
    # Optional per-node overrides for directly-attached devices.
    device_l: float | None = None
    device_u: float | None = None
    name: str = ""

    def add(self, child: "PDNNode") -> "PDNNode":
        self.children.append(child)
        return child

    def iter_nodes(self) -> Iterator["PDNNode"]:
        """Pre-order iteration (iterative: depth can be arbitrary)."""
        stack = [self]
        while stack:
            node = stack.pop()
            yield node
            stack.extend(reversed(node.children))


@dataclasses.dataclass
class FlatPDN:
    """DFS-flattened PDN.

    Nodes are in pre-order; devices in DFS order so each node's device set
    is ``[node_start[j], node_end[j])``.  Node 0 is always the root.
    """

    # --- nodes ---
    node_start: np.ndarray  # [m] int32, device-range start (inclusive)
    node_end: np.ndarray  # [m] int32, device-range end (exclusive)
    node_cap: np.ndarray  # [m] float, watts
    node_parent: np.ndarray  # [m] int32, -1 for root
    node_depth: np.ndarray  # [m] int32, root depth 0
    # --- devices ---
    dev_l: np.ndarray  # [n] float
    dev_u: np.ndarray  # [n] float
    dev_node: np.ndarray  # [n] int32: node each device is attached to
    dev_depth: np.ndarray  # [n] int32: ancestor count (rows covering the device)

    @property
    def n(self) -> int:
        return int(self.dev_l.shape[0])

    @property
    def m(self) -> int:
        return int(self.node_cap.shape[0])

    def validate(self) -> None:
        """Check structural invariants + necessary feasibility conditions."""
        n, m = self.n, self.m
        if not (self.node_start <= self.node_end).all():
            raise ValueError("node ranges malformed (start > end)")
        if self.node_start[0] != 0 or self.node_end[0] != n:
            raise ValueError("root must cover all devices")
        # child ranges nested within parent range
        for j in range(1, m):
            p = self.node_parent[j]
            if not (
                self.node_start[p] <= self.node_start[j]
                and self.node_end[j] <= self.node_end[p]
            ):
                raise ValueError(f"node {j} range not nested in parent {p}")
        if (self.dev_l < 0).any() or (self.dev_l > self.dev_u).any():
            raise ValueError("device limits must satisfy 0 <= l <= u")
        # necessary feasibility: minimum draw must fit under every cap
        csum = np.concatenate([[0.0], np.cumsum(self.dev_l)])
        lmin = csum[self.node_end] - csum[self.node_start]
        bad = np.nonzero(lmin > self.node_cap + 1e-9)[0]
        if bad.size:
            j = int(bad[0])
            raise ValueError(
                f"infeasible PDN: node {j} cap {self.node_cap[j]:.1f} W < "
                f"sum of device minimums {lmin[j]:.1f} W"
            )

    def subtree_min_power(self) -> np.ndarray:
        csum = np.concatenate([[0.0], np.cumsum(self.dev_l)])
        return csum[self.node_end] - csum[self.node_start]

    def subtree_max_power(self) -> np.ndarray:
        csum = np.concatenate([[0.0], np.cumsum(self.dev_u)])
        return csum[self.node_end] - csum[self.node_start]

    def oversubscription_ratio(self) -> float:
        """Total device max power over root capacity (paper reports ~1.63)."""
        return float(self.dev_u.sum() / self.node_cap[0])


def flatten(
    root: PDNNode, *, default_l: float = 200.0, default_u: float = 700.0
) -> FlatPDN:
    """DFS-flatten a PDN tree into contiguous-range arrays."""
    node_start: list[int] = []
    node_end: list[int] = []
    node_cap: list[float] = []
    node_parent: list[int] = []
    node_depth: list[int] = []
    dev_l: list[float] = []
    dev_u: list[float] = []
    dev_node: list[int] = []
    dev_depth: list[int] = []

    # Iterative DFS with explicit post-processing to fill node_end.
    # Stack entries: (node, parent_idx, depth, state) where state 0 = enter.
    stack: list[tuple[PDNNode, int, int, int]] = [(root, -1, 0, 0)]
    enter_order: list[PDNNode] = []
    idx_of: dict[int, int] = {}
    while stack:
        node, parent, depth, state = stack.pop()
        if state == 0:
            j = len(node_cap)
            idx_of[id(node)] = j
            enter_order.append(node)
            node_start.append(len(dev_l))
            node_end.append(-1)  # patched on exit
            node_cap.append(float(node.capacity))
            node_parent.append(parent)
            node_depth.append(depth)
            # devices attached directly to this node come first
            dl = node.device_l if node.device_l is not None else default_l
            du = node.device_u if node.device_u is not None else default_u
            for _ in range(node.n_devices):
                dev_l.append(float(dl))
                dev_u.append(float(du))
                dev_node.append(j)
                dev_depth.append(depth + 1)
            stack.append((node, parent, depth, 1))  # exit marker
            for child in reversed(node.children):
                stack.append((child, j, depth + 1, 0))
        else:
            node_end[idx_of[id(node)]] = len(dev_l)

    flat = FlatPDN(
        node_start=np.asarray(node_start, dtype=np.int32),
        node_end=np.asarray(node_end, dtype=np.int32),
        node_cap=np.asarray(node_cap, dtype=np.float64),
        node_parent=np.asarray(node_parent, dtype=np.int32),
        node_depth=np.asarray(node_depth, dtype=np.int32),
        dev_l=np.asarray(dev_l, dtype=np.float64),
        dev_u=np.asarray(dev_u, dtype=np.float64),
        dev_node=np.asarray(dev_node, dtype=np.int32),
        dev_depth=np.asarray(dev_depth, dtype=np.int32),
    )
    flat.validate()
    return flat


def build_datacenter(
    *,
    n_halls: int = 4,
    racks_per_hall: int = 24,
    servers_per_rack: int = 16,
    gpus_per_server: int = 8,
    l: float = 200.0,
    u: float = 700.0,
    oversubscription: float = 0.85,
) -> FlatPDN:
    """The paper's production geometry (section 5.1).

    Capacities are computed bottom-up: server cap = gpus * u (no server-level
    oversubscription); every higher level's cap = oversubscription * (sum of
    child caps).  With the defaults this yields total-device-max / root-cap
    = 1 / 0.85**3 ~= 1.628, matching the paper's ~1.63.
    """
    server_cap = gpus_per_server * u
    rack_cap = oversubscription * servers_per_rack * server_cap
    hall_cap = oversubscription * racks_per_hall * rack_cap
    dc_cap = oversubscription * n_halls * hall_cap
    root = PDNNode(capacity=dc_cap, name="dc")
    for h in range(n_halls):
        hall = root.add(PDNNode(capacity=hall_cap, name=f"hall{h}"))
        for r in range(racks_per_hall):
            rack = hall.add(PDNNode(capacity=rack_cap, name=f"hall{h}/rack{r}"))
            for s in range(servers_per_rack):
                rack.add(
                    PDNNode(
                        capacity=server_cap,
                        n_devices=gpus_per_server,
                        name=f"hall{h}/rack{r}/srv{s}",
                    )
                )
    return flatten(root, default_l=l, default_u=u)


def build_from_level_sizes(
    level_sizes: Sequence[int],
    *,
    gpus_per_server: int = 8,
    l: float = 200.0,
    u: float = 700.0,
    oversubscription: float = 0.85,
) -> FlatPDN:
    """Uniform tree with given branching factors per level (root first)."""

    def make(level: int) -> PDNNode:
        if level == len(level_sizes):
            return PDNNode(capacity=gpus_per_server * u, n_devices=gpus_per_server)
        node = PDNNode(capacity=0.0)
        for _ in range(level_sizes[level]):
            node.add(make(level + 1))
        node.capacity = oversubscription * sum(c.capacity for c in node.children)
        return node

    return flatten(make(0), default_l=l, default_u=u)
