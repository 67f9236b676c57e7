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
depth.  A numpy copy of the reference's ``waterfill_arrays``; the
trace-safe ``waterfill_jax`` of the batched engine comes with that engine.
"""

from __future__ import annotations

import numpy as np

__all__ = ["waterfill_arrays"]


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

