"""Greedy proportional allocation baseline (paper Algorithms 4 & 5) and the
static equal share.

A fast top-down heuristic mimicking industry-standard proportional sharing
(SHIP-style): each node's extra budget is split among its children in
proportion to their feasible extra weights, recursing to the devices.  It
cannot encode horizontal tenant SLAs and makes only local decisions
(Appendix A analyses the failure mode on non-uniform hierarchies).

Host-side numpy: these are baselines the simulator and the benchmarks
compare nvPAX against, not the serving path.
"""

from __future__ import annotations

import numpy as np

from repro_torch.pdn.tree import FlatPDN

__all__ = ["greedy_allocate", "static_allocate"]


def greedy_allocate(pdn: FlatPDN, requests: np.ndarray) -> np.ndarray:
    """Algorithm 4 + 5.  ``requests`` are raw power requests in watts."""
    n, m = pdn.n, pdn.m
    l, u = pdn.dev_l, pdn.dev_u
    d = np.clip(requests, l, u)  # clip request to [l, u]
    e = d - l  # extra demand above minimum
    a = l.copy()  # allocate minimum

    # --- bottom-up aggregation (prefix sums over the DFS ranges) ---
    lcs = np.concatenate([[0.0], np.cumsum(l)])
    ecs = np.concatenate([[0.0], np.cumsum(e)])
    L = lcs[pdn.node_end] - lcs[pdn.node_start]  # sum of minimums per node
    E = ecs[pdn.node_end] - ecs[pdn.node_start]  # sum of extra demands
    X = np.maximum(0.0, pdn.node_cap - L)  # extra capacity above minimums
    W = np.minimum(E, X)  # feasible extra weight

    # children / attached-device lists
    children: list[list[int]] = [[] for _ in range(m)]
    for j in range(1, m):
        children[pdn.node_parent[j]].append(j)
    devices_at: list[list[int]] = [[] for _ in range(m)]
    for i in range(n):
        devices_at[pdn.dev_node[i]].append(i)

    # --- top-down distribution (Algorithm 5) ---
    stack: list[tuple[int, float]] = [(0, float(W[0]))]
    while stack:
        v, b = stack.pop()
        if b <= 0:
            continue
        w_tot = sum(W[c] for c in children[v]) + sum(e[i] for i in devices_at[v])
        if w_tot <= 0:
            continue
        for c in children[v]:
            bc = min(b * W[c] / w_tot, W[c])
            stack.append((c, bc))
            b -= bc
            w_tot -= W[c]
            if w_tot <= 0:
                break
        if w_tot > 0:
            for i in devices_at[v]:
                si = min(b * e[i] / w_tot, e[i])
                a[i] += si
                b -= si
                w_tot -= e[i]
                if w_tot <= 0:
                    break
    return a


def static_allocate(pdn: FlatPDN, requests: np.ndarray | None = None) -> np.ndarray:
    """Static equal share: every device gets ``C_root / n`` (clipped to its
    physical box), no redistribution of unused power (paper section 5.3).
    ``requests`` is accepted for a common signature and ignored."""
    share = pdn.node_cap[0] / pdn.n
    return np.clip(np.full((pdn.n,), share), pdn.dev_l, pdn.dev_u)
