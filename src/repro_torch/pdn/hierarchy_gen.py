"""Random hierarchy generation for the scaling benchmark (paper section 5.6)
and for property-based tests.

The paper benchmarks nvPAX on "synthetic randomly generated hierarchies"
with n in {1e3, 5e3, 1e4, 2.5e4, 5e4, 1e5}.  ``random_hierarchy`` grows a
tree with randomized branching and per-level oversubscription;
``nonuniform_example`` builds the exact Appendix A counter-example hierarchy
(Figure 4) where Greedy proportional allocation loses 9.32 points of
satisfaction to nvPAX.
"""

from __future__ import annotations

import numpy as np

from repro_torch.pdn.tree import FlatPDN, PDNNode, flatten

__all__ = [
    "random_hierarchy",
    "nonuniform_example",
    "homogeneous_fleet",
    "NONUNIFORM_REQUESTS",
]


def random_hierarchy(
    n_devices: int,
    *,
    seed: int = 0,
    depth: int = 4,
    l: float = 200.0,
    u: float = 700.0,
    oversub_range: tuple[float, float] = (0.75, 0.95),
    max_branch: int = 12,
) -> FlatPDN:
    """Random tree with ~``n_devices`` leaves (exact count is honored).

    Branching factors are sampled per node; oversubscription factors are
    sampled per node from ``oversub_range``, so capacities are non-uniform —
    the regime where global optimization beats local heuristics.
    """
    rng = np.random.default_rng(seed)

    # Decide devices per server so that depth levels of branching roughly
    # produce n_devices; then distribute the remainder.
    def build(level: int, budget: int) -> PDNNode:
        if level == depth or budget <= max_branch:
            node = PDNNode(capacity=budget * u, n_devices=budget)
            return node
        k = int(rng.integers(2, max_branch + 1))
        k = min(k, budget)
        # random composition of `budget` into k parts >= 1
        cuts = np.sort(rng.choice(np.arange(1, budget), size=k - 1, replace=False))
        parts = np.diff(np.concatenate([[0], cuts, [budget]])).astype(int)
        node = PDNNode(capacity=0.0)
        for p in parts:
            if p > 0:
                node.add(build(level + 1, int(p)))
        f = rng.uniform(*oversub_range)
        node.capacity = f * sum(c.capacity for c in node.children)
        return node

    root = build(0, int(n_devices))
    return flatten(root, default_l=l, default_u=u)


def homogeneous_fleet(
    n_domains: int = 4,
    *,
    racks_per_domain: int = 2,
    servers_per_rack: int = 2,
    gpus_per_server: int = 4,
    l: float = 200.0,
    u: float = 700.0,
    domain_oversub: float = 0.85,
    root_oversub: float = 1.0,
) -> FlatPDN:
    """K identical power domains under one utility feed (fleet-mode fixture).

    Each domain is a hall-like subtree (racks -> servers -> devices) with
    ``domain_oversub`` applied at the rack and domain levels.  The root feed
    carries ``root_oversub * sum(domain caps)``: at the default 1.0 the root
    row can never bind, which is the regime where the two-level fleet solve
    (per-domain engines + subtree-budget grants) is *exactly* the monolithic
    solve — the parity case asserted in the fleet tests.  Values
    < 1.0 make the feed scarce so the inter-domain coordinator has real
    borrowing decisions to make (the benchmark's brownout scenarios).
    """
    server_cap = gpus_per_server * u
    rack_cap = domain_oversub * servers_per_rack * server_cap
    dom_cap = domain_oversub * racks_per_domain * rack_cap
    root = PDNNode(capacity=root_oversub * n_domains * dom_cap, name="feed")
    for d in range(n_domains):
        dom = root.add(PDNNode(capacity=dom_cap, name=f"dom{d}"))
        for r in range(racks_per_domain):
            rack = dom.add(PDNNode(capacity=rack_cap, name=f"dom{d}/rack{r}"))
            for s in range(servers_per_rack):
                rack.add(
                    PDNNode(
                        capacity=server_cap,
                        n_devices=gpus_per_server,
                        name=f"dom{d}/rack{r}/srv{s}",
                    )
                )
    return flatten(root, default_l=l, default_u=u)


# ---------------------------------------------------------------------------
# Appendix A: the non-uniform hierarchy where Greedy fails
# ---------------------------------------------------------------------------

# Requests in kW per device group (Figure 4): six 0.75 kW devices under the
# tight server S_A1, three 0.15 kW under S_A2, ten 0.35 kW under each of
# racks B and C's 6 kW servers.  All active, priority 1.
NONUNIFORM_REQUESTS = np.concatenate(
    [
        np.full(6, 750.0),  # S_A1 devices
        np.full(3, 150.0),  # S_A2 devices
        np.full(10, 350.0),  # rack B
        np.full(10, 350.0),  # rack C
    ]
)


def nonuniform_example(l: float = 0.0, u: float = 1000.0) -> FlatPDN:
    """Appendix A / Figure 4 hierarchy (capacities in watts).

    Datacenter cap 10 kW; rack A holds S_A1 (cap 2.5 kW, 6 devices
    requesting 0.75 kW each) and S_A2 (3 devices at 0.15 kW); racks B and C
    each hold one 6 kW server with ten 0.35 kW devices.  Total request
    11.95 kW > 10 kW root cap.  Device boxes are [0, 1000] W so the box
    never binds — the gap is purely hierarchical.
    """
    root = PDNNode(capacity=10_000.0, name="dc")
    rack_a = root.add(PDNNode(capacity=10_000.0, name="rackA"))
    rack_a.add(PDNNode(capacity=2_500.0, n_devices=6, name="S_A1"))
    rack_a.add(PDNNode(capacity=1_000.0, n_devices=3, name="S_A2"))
    for name in ("rackB", "rackC"):
        rack = root.add(PDNNode(capacity=6_000.0, name=name))
        rack.add(PDNNode(capacity=6_000.0, n_devices=10, name=f"{name}/srv"))
    return flatten(root, default_l=l, default_u=u)
