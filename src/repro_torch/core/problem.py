"""Problem containers for the nvPAX allocator.

Two levels:

* :class:`AllocProblem` — the *control-step* problem: fleet state (limits,
  requests, priorities, active/idle), PDN topology, tenant SLAs.  Built once
  per control step from host-side numpy (see :mod:`repro_torch.pdn`).
* :class:`StepProblem` — one convex program in the unified QP/LP form solved
  by :mod:`repro_torch.core.solver`:

      minimize   0.5 * sum_i w_i (x_i - target_i)^2  +  c.x  +  c_t * t
      subject to lo <= x <= hi,  t_lo <= t <= t_hi,
                 tree subtree sums        <= cap,
                 sla_lo <= tenant sums    <= sla_hi,
                 x_i - t                  >= imp_lo_i   (vacuous if -inf).

  Phase I instantiates the QP (w > 0, t pinned to 0, improvement rows
  vacuous); Phases II/III instantiate the max-min LP (w = 0, c_t = -1,
  improvement rows active on the optimized set).  Scalars (``c_t``, ``t_lo``,
  ``t_hi``) are 0-d tensors on the problem's device.

Both also come stacked, K scenarios of the K-scenario program over one
topology: the fleet leaves (``l``, ``u``, ``r``, ``priority``, ``active``,
``weight_scale``; a step problem's vectors) are ``[K, n]`` and the step
problem's scalars ``[K, 1]`` lane columns, while the tree and tenant
topology and the row bounds stay shared (:mod:`repro_torch.core.lanes`,
:func:`repro_torch.core.batched.stack_problems`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.core.treeops import SlaTopo, TreeTopo
from repro_torch.pdn.tree import FlatPDN

__all__ = ["AllocProblem", "FleetTopology", "StepProblem", "INF"]

INF = float("inf")


class FleetTopology(NamedTuple):
    """Shape-static fleet data pre-converted to device tensors.

    Everything in :class:`AllocProblem` that does not change between control
    steps — PDN tree, tenant SLA topology, device boxes, deviation scales —
    lives here so the per-step build is only telemetry -> device tensors.
    Construct once per fleet with :meth:`from_pdn` and pass to
    ``AllocProblem.build(..., topology=...)``.
    """

    tree: TreeTopo
    sla: SlaTopo
    l: torch.Tensor  # [n]
    u: torch.Tensor  # [n]
    weight_scale: torch.Tensor  # [n]

    @property
    def n(self) -> int:
        return self.l.shape[0]

    @property
    def device(self) -> torch.device:
        return self.l.device

    @classmethod
    def from_pdn(
        cls,
        pdn: FlatPDN,
        *,
        sla=None,
        normalized: bool = False,
        dtype=torch.float64,
        device=None,
    ) -> "FleetTopology":
        """``sla`` is a :class:`SlaTopo` or any object with host
        ``dev``/``ten``/``lo``/``hi`` arrays (e.g. a tenant layout's)."""
        device = resolve_device(device)
        if sla is None:
            sla = SlaTopo.empty(pdn.n, dtype, device)
        else:
            sla = SlaTopo.make(
                *(_host(getattr(sla, f)) for f in ("dev", "ten", "lo", "hi")),
                n=pdn.n,
                dtype=dtype,
                device=device,
            )
        weight_scale = (1.0 / pdn.dev_u) if normalized else np.ones((pdn.n,))

        def vec(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=device)

        return cls(
            tree=TreeTopo.make(
                pdn.node_start,
                pdn.node_end,
                pdn.node_cap,
                pdn.node_depth,
                pdn.n,
                dtype=dtype,
                device=device,
            ),
            sla=sla,
            l=vec(pdn.dev_l),
            u=vec(pdn.dev_u),
            weight_scale=vec(weight_scale),
        )


    def with_sla_bounds(self, lo, hi) -> "FleetTopology":
        """Same topology with re-pinned tenant SLA row bounds: the incidence
        and its kernel index are kept, only the ``[lo, hi]`` values change
        (the engine's ``set_sla_bounds``)."""
        sla = self.sla
        lo = torch.as_tensor(np.asarray(lo, np.float64), dtype=sla.lo.dtype, device=self.device)
        hi = torch.as_tensor(np.asarray(hi, np.float64), dtype=sla.hi.dtype, device=self.device)
        if lo.shape != sla.lo.shape or hi.shape != sla.hi.shape:
            raise ValueError(
                f"sla bounds shapes {tuple(lo.shape)}/{tuple(hi.shape)} != ({sla.k},)"
            )
        return self._replace(sla=sla._replace(lo=lo, hi=hi))


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


class AllocProblem(NamedTuple):
    """One control step's allocation problem (tensors on one device); the
    fleet leaves are ``[n]``, or ``[K, n]`` for K stacked scenarios."""

    # fleet
    l: torch.Tensor  # [n] device minimum power
    u: torch.Tensor  # [n] device maximum power
    r: torch.Tensor  # [n] requests, clipped to [l, u]; r = l for idle
    priority: torch.Tensor  # [n] int32 in {1..P}, higher = more important
    active: torch.Tensor  # [n] bool
    # constraints
    tree: TreeTopo
    sla: SlaTopo
    # options
    weight_scale: torch.Tensor  # [n] per-device deviation scale (1 or 1/u_i)

    @property
    def n(self) -> int:
        return self.l.shape[-1]

    @property
    def idle(self) -> torch.Tensor:
        return ~self.active

    # -- precomputed level metadata (host-side) --

    def priority_levels(self, active_only: bool = True) -> tuple[int, ...]:
        """Distinct priority values, descending (Algorithm 1 sweep order).

        ``active_only`` restricts to levels present among active devices —
        the host driver's behavior.
        """
        pri = _host(self.priority)
        if active_only:
            pri = pri[_host(self.active)]
        return tuple(sorted({int(p) for p in pri}, reverse=True))

    def n_tree_depths(self) -> int:
        """Number of distinct PDN tree levels (root depth 0 included)."""
        depth = _host(self.tree.depth)
        return int(depth.max()) + 1 if depth.size else 0

    def pin_free_ok(self) -> bool:
        """True when free devices can be pinned at ``l`` in Phase I: no
        tenant lower-bound SLA could force an idle device upward (paper
        section 4.3.1)."""
        return self.sla.k == 0 or not bool((_host(self.sla.lo) > 0).any())

    @classmethod
    def build(
        cls,
        pdn: FlatPDN,
        requests: np.ndarray,
        *,
        active: np.ndarray | None = None,
        priority: np.ndarray | None = None,
        idle_threshold: float = 150.0,
        sla=None,
        normalized: bool = False,
        dtype=torch.float64,
        topology: FleetTopology | None = None,
        device=None,
    ) -> "AllocProblem":
        """Assemble a control-step problem from a flattened PDN + telemetry.

        Mirrors the paper's request pre-processing (section 5.2): requests
        are clipped to ``[l, u]``; a device is idle if its raw request is
        below ``idle_threshold`` (unless an explicit ``active`` mask, e.g.
        from the job scheduler, is given); idle devices request ``l``.

        ``topology`` is the zero-rebuild fast path: a prebuilt
        :class:`FleetTopology` whose device tensors are reused as-is (its
        device wins; ``sla``/``normalized`` must then not be passed).
        """
        n = pdn.n
        requests = np.asarray(requests, dtype=np.float64)
        if requests.shape != (n,):
            raise ValueError(f"requests shape {requests.shape} != ({n},)")
        if active is None:
            active = requests >= idle_threshold
        active = np.asarray(active, dtype=bool)
        r = np.clip(requests, pdn.dev_l, pdn.dev_u)
        r = np.where(active, r, pdn.dev_l)
        if priority is None:
            priority = np.ones((n,), dtype=np.int32)
        priority = np.asarray(priority, dtype=np.int32)
        if (priority < 1).any():
            raise ValueError("priorities must be >= 1")
        if topology is None:
            topology = FleetTopology.from_pdn(
                pdn, sla=sla, normalized=normalized, dtype=dtype, device=device
            )
        elif sla is not None or normalized:
            raise ValueError("sla/normalized are fixed by the prebuilt topology")
        dev = topology.device
        return cls(
            l=topology.l,
            u=topology.u,
            r=torch.as_tensor(r, dtype=topology.l.dtype, device=dev),
            priority=torch.as_tensor(priority, device=dev),
            active=torch.as_tensor(active, device=dev),
            tree=topology.tree,
            sla=topology.sla,
            weight_scale=topology.weight_scale,
        )


class StepProblem(NamedTuple):
    """One convex program in the unified form (see module docstring)."""

    # objective
    w: torch.Tensor  # [n] diagonal quadratic weights (0 for LP)
    target: torch.Tensor  # [n] quadratic targets
    c: torch.Tensor  # [n] linear cost on x
    c_t: torch.Tensor  # scalar linear cost on t
    # variable boxes
    lo: torch.Tensor  # [n]
    hi: torch.Tensor  # [n]
    t_lo: torch.Tensor  # scalar
    t_hi: torch.Tensor  # scalar
    # row bounds (tree lower bound is implicitly -inf)
    tree_hi: torch.Tensor  # [m]
    sla_lo: torch.Tensor  # [k]
    sla_hi: torch.Tensor  # [k]
    imp_lo: torch.Tensor  # [n]; -inf disables row i

    @property
    def n(self) -> int:
        return self.w.shape[-1]
