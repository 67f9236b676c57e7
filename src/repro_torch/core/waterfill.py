"""Exact tree water-filling: a combinatorial oracle (and fast path) for the
max-min phases when no tenant SLAs are present.

Progressive filling: raise all unsaturated devices in the optimized set at a
uniform rate; when a device bound or node capacity binds, freeze the affected
devices; repeat.  For box + tree-capacity feasible sets this produces the
lexicographically max-min optimal allocation — the same limit the paper's
iterated LP sequence (Algorithm 2) converges to.  It is the fast path of the
host phase drivers for SLA-free problems.

Per-round cost is O(n + m); the number of rounds is bounded by the number of
distinct binding events (<= number of nodes + 1), and in practice is ~tree
depth.  :func:`waterfill_arrays` is a numpy copy of the reference's, for the
host phase drivers; :func:`waterfill_torch` ports the reference's
``waterfill_jax`` for the engine's one-scenario program, on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import tree_matvec as tk

__all__ = ["waterfill_arrays", "waterfill_torch"]


def waterfill_arrays(
    start: np.ndarray,
    end: np.ndarray,
    cap: np.ndarray,
    u: np.ndarray,
    base: np.ndarray,
    opt_mask: np.ndarray,
    max_rounds: int = 10_000,
) -> np.ndarray:
    """Max-min raise of ``base`` over devices in ``opt_mask``; all other
    devices stay fixed at ``base``.  Requires no tenant constraints.

    ``start``/``end``/``cap`` describe DFS-contiguous tree nodes; ``u`` is
    the per-device upper limit.
    """
    n = base.shape[0]
    x = np.asarray(base, dtype=np.float64).copy()
    live = np.asarray(opt_mask, dtype=bool).copy()

    for _ in range(max_rounds):
        if not live.any():
            break
        lv = live.astype(np.float64)
        ccs = np.concatenate([[0.0], np.cumsum(lv)])
        n_live = ccs[end] - ccs[start]  # live devices under each node
        xcs = np.concatenate([[0.0], np.cumsum(x)])
        sums = xcs[end] - xcs[start]
        slack = cap - sums
        with np.errstate(divide="ignore", invalid="ignore"):
            node_rate = np.where(n_live > 0, slack / np.maximum(n_live, 1), np.inf)
        dev_rate = np.where(live, u - x, np.inf)
        t = min(node_rate.min(), dev_rate.min())
        t = max(t, 0.0)
        if not np.isfinite(t):
            break
        x = np.where(live, x + t, x)
        # freeze: devices at u, or under any node now tight
        xcs = np.concatenate([[0.0], np.cumsum(x)])
        sums = xcs[end] - xcs[start]
        tight = (cap - sums <= 1e-9) & (n_live > 0)
        under_tight = np.zeros(n + 1)
        np.add.at(under_tight, start[tight], 1.0)
        np.add.at(under_tight, end[tight], -1.0)
        under_tight = np.cumsum(under_tight)[:n] > 0
        newly = live & ((u - x <= 1e-9) | under_tight)
        if not newly.any():
            break  # unbounded direction fully absorbed (all at u) or stalled
        live &= ~newly
    return x



def waterfill_torch(base, opt_mask, tree, u, max_rounds: int = 10_000):
    """The port of the reference's ``waterfill_jax``: the progressive-filling
    sweep of :func:`waterfill_arrays` as a loop over the port's tree ops on
    the tensors' device (on a card, the tree matvec kernels).

    ``tree`` is a :class:`repro_torch.core.treeops.TreeTopo`; semantics and
    freezing order mirror the reference's loop body exactly.  Each round
    brings its exit test to the host in one transfer.
    """
    x = base
    dtype = x.dtype
    live = opt_mask.to(torch.bool)
    inf = torch.full((), float("inf"), dtype=dtype, device=x.device)
    if not bool(live.any()):
        return x
    for _ in range(max_rounds):
        lv = live.to(dtype)
        n_live = tk.tree_matvec(lv, tree.index)
        slack = tree.cap - tk.tree_matvec(x, tree.index)
        node_rate = torch.where(n_live > 0, slack / torch.clamp_min(n_live, 1.0), inf)
        dev_rate = torch.where(live, u - x, inf)
        t = torch.clamp_min(torch.minimum(torch.min(node_rate), torch.min(dev_rate)), 0.0)
        finite = torch.isfinite(t)
        # the numpy sweep stops BEFORE applying a non-finite raise
        x = torch.where(live & finite, x + t, x)
        # freeze: devices at u, or under any node now tight
        tight = (tree.cap - tk.tree_matvec(x, tree.index) <= 1e-9) & (n_live > 0)
        under_tight = tk.tree_rmatvec(tight.to(dtype), tree.index) > 0.5
        newly = live & ((u - x <= 1e-9) | under_tight)
        done = (~finite) | (~torch.any(newly))  # absorbed or stalled
        live = torch.where(finite, live & ~newly, live)
        stop, any_live = torch.stack([done, torch.any(live)]).tolist()
        if stop or not any_live:
            break
    return x
