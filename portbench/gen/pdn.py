"""The paper's datacenter PDN (section 5.1) as flat arrays: a frozen copy
of ``build_datacenter`` and ``flatten`` from ``src/repro_torch/pdn/tree.py``
at commit d455ed1 (numpy only; the validation and the node class trimmed to
what the uniform tree needs).

Devices are numbered in depth-first order, so every node's devices are a
contiguous range ``[start, end)``; nodes are in pre-order, node 0 the root.
"""

from __future__ import annotations

import numpy as np


def build_datacenter(*, n_halls: int = 4, racks_per_hall: int = 24,
                     servers_per_rack: int = 16, gpus_per_server: int = 8,
                     l: float = 200.0, u: float = 700.0,
                     oversubscription: float = 0.85) -> dict:
    """node_start, node_end, node_cap, node_parent, node_depth (per node)
    and dev_l, dev_u, dev_node, dev_depth (per device), as the port's
    ``FlatPDN`` holds them.  Server cap = gpus * u; every higher level's cap
    = oversubscription * the sum of its children's."""
    server_cap = gpus_per_server * u
    rack_cap = oversubscription * servers_per_rack * server_cap
    hall_cap = oversubscription * racks_per_hall * rack_cap
    dc_cap = oversubscription * n_halls * hall_cap
    # (capacity, devices attached, children) in pre-order
    server = (server_cap, gpus_per_server, [])
    rack = (rack_cap, 0, [server] * servers_per_rack)
    hall = (hall_cap, 0, [rack] * racks_per_hall)
    root = (dc_cap, 0, [hall] * n_halls)

    start, end, cap, parent, depth = [], [], [], [], []
    dev_node, dev_depth = [], []
    stack = [(root, -1, 0, False)]
    open_ids = []
    while stack:
        node, par, d, leaving = stack.pop()
        if leaving:
            end[open_ids.pop()] = len(dev_node)
            continue
        j = len(cap)
        open_ids.append(j)
        start.append(len(dev_node))
        end.append(-1)
        cap.append(float(node[0]))
        parent.append(par)
        depth.append(d)
        dev_node += [j] * node[1]
        dev_depth += [d + 1] * node[1]
        stack.append((node, par, d, True))
        for child in reversed(node[2]):
            stack.append((child, j, d + 1, False))
    n = len(dev_node)
    return {
        "node_start": np.asarray(start, np.int32),
        "node_end": np.asarray(end, np.int32),
        "node_cap": np.asarray(cap, np.float64),
        "node_parent": np.asarray(parent, np.int32),
        "node_depth": np.asarray(depth, np.int32),
        "dev_l": np.full(n, float(l)),
        "dev_u": np.full(n, float(u)),
        "dev_node": np.asarray(dev_node, np.int32),
        "dev_depth": np.asarray(dev_depth, np.int32),
    }
