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

from repro_torch.core.lanes import column, lane_any, lane_min
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
    freezing order mirror the reference's loop body, with one addition: a
    round also freezes the devices under the node(s) whose rate set its
    raise.  Without it, whether that node tests tight after the raise
    (``cap - sums <= 1e-9``) depends on the rounding of its prefix-sum
    difference, about 1e-9 W at the paper fleet's ~5 MW: where it does not,
    nothing freezes and the sweep exits early, leaving the rest of the
    budget to Phase III's idle devices.  The reference's ``waterfill_jax``
    and numpy sweep add their prefix sums in other orders and part ways
    there by up to 330 W per device at paper scale; with the addition the
    port's sweep gives the reference engine's allocations on the CPU and on
    a card alike.  Wherever the reference's sweep does not exit early, the
    nodes added are ones it finds tight too, up to the rounding of a
    prefix-sum difference.  Each round brings its exit test to the host in
    one transfer.

    With K lanes (``[K, n]`` ``base`` and ``opt_mask``) every lane sweeps
    its own rounds in the same launches: a lane that stops keeps its
    allocation while the others go on, and a round's transfer is the K
    lanes' exit tests.
    """
    x = base
    dtype = x.dtype
    live = opt_mask.to(torch.bool)
    inf = torch.full((), float("inf"), dtype=dtype, device=x.device)
    lanes = x.ndim == 2
    if lanes:
        # the lanes still sweeping; a lane that stopped applies no raise
        going = lane_any(live).reshape(-1).cpu().numpy()
        if not going.any():
            return x
        going_col = column(going, x.device)
    elif not bool(live.any()):
        return x
    for _ in range(max_rounds):
        lv = live.to(dtype)
        n_live = tk.tree_matvec(lv, tree.index)
        slack = tree.cap - tk.tree_matvec(x, tree.index)
        node_rate = torch.where(n_live > 0, slack / torch.clamp_min(n_live, 1.0), inf)
        dev_rate = torch.where(live, u - x, inf)
        t = torch.clamp_min(torch.minimum(lane_min(node_rate), lane_min(dev_rate)), 0.0)
        finite = torch.isfinite(t)
        if lanes:
            finite = finite & going_col
        # the numpy sweep stops BEFORE applying a non-finite raise
        x = torch.where(live & finite, x + t, x)
        # freeze: devices at u, or under any node now tight or whose rate
        # set the raise (tight by construction, whatever the rounding)
        tight = ((tree.cap - tk.tree_matvec(x, tree.index) <= 1e-9) | (node_rate <= t)) & (
            n_live > 0
        )
        under_tight = tk.tree_rmatvec(tight.to(dtype), tree.index) > 0.5
        newly = live & ((u - x <= 1e-9) | under_tight)
        done = (~finite) | (~lane_any(newly))  # absorbed or stalled
        live = torch.where(finite, live & ~newly, live)
        if lanes:
            stop, any_live = torch.stack([done, lane_any(live)]).reshape(2, -1).cpu().numpy()
            going &= ~stop & any_live
            if not going.any():
                break
            going_col = column(going, x.device)
        else:
            stop, any_live = torch.stack([done, torch.any(live)]).tolist()
            if stop or not any_live:
                break
    return x
