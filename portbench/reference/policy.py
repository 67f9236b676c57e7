"""A plain reference of nvPAX's three-phase policy (paper Algorithm 3) on a
fleet without tenant contracts, in NumPy, solved exactly rather than by a
first-order method.

- Requests: telemetry x margin; a device is active at or above the idle
  threshold; its target is its request clipped to [l, u], ``l`` when idle.
- Phase I (per priority level, highest first): the active devices of the
  level take the Euclidean projection of their targets onto the box and the
  node caps left by the devices already placed; the others sit at ``l``.
  With equal weights the projection's multiplier of a device is the largest
  of the levels of the nodes above it, and each node's level is found by
  bisection, deepest nodes first (a node binds at the level where its
  subtree, under its descendants' levels, just fills its cap).
- Phases II and III: progressive filling (equal raises, freezing a device
  at its upper bound or under a full node) of the active, then the idle
  devices: the lexicographic max-min of the paper's iterated LPs.
"""

from __future__ import annotations

import numpy as np

BISECTIONS = 100


def targets(pdn: dict, telemetry, margin: float, idle_threshold: float):
    req = np.asarray(telemetry, np.float64) * margin
    active = req >= idle_threshold
    r = np.where(active, np.clip(req, pdn["dev_l"], pdn["dev_u"]), pdn["dev_l"])
    return r, active


def _ancestor_at(pdn: dict, depth: int) -> np.ndarray:
    """Each device's covering node at ``depth`` (-1 where none)."""
    anc = np.full(pdn["dev_l"].shape[0], -1, np.int64)
    for j in np.nonzero(pdn["node_depth"] == depth)[0]:
        anc[pdn["node_start"][j]:pdn["node_end"][j]] = j
    return anc


def project(pdn: dict, r, free, x, dtype=np.float64):
    """``x`` with the devices in ``free`` at the projection of their
    targets ``r`` onto the box and the caps left by the others."""
    l, u = pdn["dev_l"].astype(dtype), pdn["dev_u"].astype(dtype)
    r, x = np.asarray(r, dtype), np.asarray(x, dtype).copy()
    cap = pdn["node_cap"].astype(dtype)
    m = cap.shape[0]
    level = np.zeros(x.shape[0], dtype)  # largest level of the nodes done so far
    hi = dtype(float(np.max(r - l)) + 1.0)
    for depth in range(int(pdn["node_depth"].max()), -1, -1):
        anc = _ancestor_at(pdn, depth)
        cov = anc >= 0
        fixed = np.bincount(anc[cov & ~free], weights=x[cov & ~free], minlength=m).astype(dtype)
        sel = cov & free

        def load(lam):  # node sums with every node's level at lam[node]
            v = np.clip(r[sel] - np.maximum(lam[anc[sel]], level[sel]), l[sel], u[sel])
            return np.bincount(anc[sel], weights=v, minlength=m).astype(dtype) + fixed

        nodes = pdn["node_depth"] == depth
        lo_l = np.zeros(m, dtype)
        hi_l = np.where(nodes & (load(lo_l) > cap), hi, dtype(0))
        binding = hi_l > 0
        for _ in range(BISECTIONS):
            mid = (lo_l + hi_l) / 2
            over = load(mid) > cap
            lo_l = np.where(binding & over, mid, lo_l)
            hi_l = np.where(binding & ~over, mid, hi_l)
        level[sel] = np.maximum(level[sel], hi_l[anc[sel]])
    x[free] = np.clip(r[free] - level[free], l[free], u[free])
    return x


def fill(pdn: dict, x, opt, tol: float = 1e-9, dtype=np.float64):
    """Progressive filling of the devices in ``opt`` from ``x``."""
    x = np.asarray(x, dtype).copy()
    u = pdn["dev_u"].astype(dtype)
    cap = pdn["node_cap"].astype(dtype)
    start, end = pdn["node_start"], pdn["node_end"]
    up = opt.copy()
    while up.any():
        csum = np.concatenate([[0.0], np.cumsum(x)])
        slack = cap - (csum[end] - csum[start])
        cnt = np.concatenate([[0], np.cumsum(up)])
        n_up = cnt[end] - cnt[start]
        full = slack <= tol
        under_full = np.zeros(x.shape[0], bool)
        for j in np.nonzero(full & (n_up > 0))[0]:
            under_full[start[j]:end[j]] = True
        up &= ~under_full & (u - x > tol)
        if not up.any():
            break
        cnt = np.concatenate([[0], np.cumsum(up)])
        n_up = cnt[end] - cnt[start]
        rows = n_up > 0
        t = min(float(np.min(u[up] - x[up])), float(np.min(slack[rows] / n_up[rows])))
        x[up] += t
    return x


def allocate(pdn: dict, telemetry, *, margin: float, idle_threshold: float,
             priority=None, dtype=np.float64) -> np.ndarray:
    """The three phases' allocation [n] for one telemetry sample."""
    r, active = targets(pdn, telemetry, margin, idle_threshold)
    pri = np.ones(r.shape[0], np.int64) if priority is None else np.asarray(priority)
    x = pdn["dev_l"].astype(dtype).copy()
    for p in sorted(set(pri[active].tolist()), reverse=True):
        x = project(pdn, r, active & (pri == p), x, dtype)
    x = fill(pdn, x, active, dtype=dtype)
    return fill(pdn, x, ~active, dtype=dtype)
