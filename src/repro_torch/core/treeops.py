"""Matrix-free constraint operators for the nvPAX convex programs.

The constraint matrix ``K`` stacks three row blocks over the primal vector
``z = (x in R^n, t in R)``:

  * ``m`` PDN tree rows: row ``j`` sums devices in the DFS range
    ``[start_j, end_j)`` (coefficient 0 on ``t``);
  * ``k`` tenant SLA rows: row ``k`` sums an arbitrary device subset given
    by a static (device, tenant) incidence edge list (coefficient 0 on
    ``t``);
  * ``n`` max-min improvement rows: row ``i`` is ``x_i - t`` (used by
    Phases II/III; rows are made vacuous via infinite bounds when unused).

Because devices are DFS-ordered, the tree block is a cumulative sum plus two
gathers, and its transpose is a difference-array scatter plus a cumulative
sum — O(n + m) with no sparse data structures.  These are the plain PyTorch
operators, with one exception: on a CUDA tensor the sums that scatter (the
tree adjoint and both tenant sums) go through the deterministic kernels of
:mod:`repro_torch.kernels.tree_matvec`, because ``index_add_`` on a card
adds with atomics in an order that changes from run to run, and the
feasibility repair, the saturation masks and the KKT checks compare these
sums against thresholds.  ``SolverOptions(use_pallas_tree=True)`` also
routes the inner iteration's tree matvec through its kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import tree_matvec as tk
from repro_torch.kernels.tree_matvec import SlaIndex, TreeIndex, sla_index, tree_index

__all__ = [
    "TreeTopo",
    "SlaTopo",
    "tree_matvec",
    "tree_rmatvec",
    "sla_matvec",
    "sla_rmatvec",
    "full_matvec",
    "full_rmatvec",
]


def _as_index(v, device) -> torch.Tensor:
    return torch.as_tensor(np.array(v, np.int64), device=device)


def _as_float(v, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(v, np.float64), dtype=dtype, device=device)


class TreeTopo(NamedTuple):
    """Static tree-constraint topology.

    ``start``/``end`` are int64 for torch indexing; ``index`` holds the
    int32 copies and CSR lists the CUDA kernels take, made once per
    topology by :meth:`make`.
    """

    start: torch.Tensor  # [m] int64
    end: torch.Tensor  # [m] int64
    cap: torch.Tensor  # [m] float
    depth: torch.Tensor  # [m] int64 (root = 0); used by the feasibility repair
    index: TreeIndex

    @property
    def m(self) -> int:
        return self.start.shape[0]

    @classmethod
    def make(cls, start, end, cap, depth, n: int, *, dtype, device) -> "TreeTopo":
        """Build from host arrays (numpy or CPU tensors)."""
        start = np.asarray(start, np.int64)
        end = np.asarray(end, np.int64)
        return cls(
            start=_as_index(start, device),
            end=_as_index(end, device),
            cap=_as_float(cap, dtype, device),
            depth=_as_index(depth, device),
            index=tree_index(start, end, n, device),
        )


class SlaTopo(NamedTuple):
    """Static tenant-constraint topology.

    ``dev``/``ten`` form an incidence edge list: device ``dev[e]`` belongs
    to tenant ``ten[e]``.  Disjoint tenancy is the common case but is not
    assumed.  ``lo``/``hi`` are aggregate bounds (+-inf when absent).
    ``index`` holds the int32 copies and CSR lists the CUDA kernels take,
    made once per topology by :meth:`make`; re-pinning the bounds
    (``_replace(lo=..., hi=...)``) keeps it.
    """

    dev: torch.Tensor  # [nnz] int64
    ten: torch.Tensor  # [nnz] int64
    lo: torch.Tensor  # [k] float
    hi: torch.Tensor  # [k] float
    index: SlaIndex

    @property
    def k(self) -> int:
        return self.lo.shape[0]

    @classmethod
    def make(cls, dev, ten, lo, hi, *, n: int, dtype, device) -> "SlaTopo":
        """Build from host arrays (numpy or CPU tensors) for ``n`` devices."""
        lo = _as_float(lo, dtype, device)
        return cls(
            dev=_as_index(dev, device),
            ten=_as_index(ten, device),
            lo=lo,
            hi=_as_float(hi, dtype, device),
            index=sla_index(dev, ten, lo.shape[0], n, device),
        )

    @classmethod
    def empty(cls, n: int = 0, dtype=torch.float32, device="cpu") -> "SlaTopo":
        return cls.make([], [], [], [], n=n, dtype=dtype, device=device)


def tree_matvec(x: torch.Tensor, tree: TreeTopo) -> torch.Tensor:
    """Per-node subtree sums of ``x`` — the tree block of ``K z``."""
    csum = torch.cat([x.new_zeros(1), torch.cumsum(x, 0)])
    return csum[tree.end] - csum[tree.start]


def tree_rmatvec(y: torch.Tensor, tree: TreeTopo, n: int) -> torch.Tensor:
    """Transpose of :func:`tree_matvec`: device i accumulates its ancestors'
    duals (``n`` devices, as the tree was built for).  Difference-array
    scatter + cumsum, the kernel on a card."""
    return tk.tree_rmatvec(y, tree.index)


def sla_matvec(x: torch.Tensor, sla: SlaTopo) -> torch.Tensor:
    """Per-tenant sums of ``x`` over the incidence list, in edge order."""
    if sla.k == 0:
        return x.new_zeros(0)
    return tk.sla_matvec(x, sla.index)


def sla_rmatvec(y: torch.Tensor, sla: SlaTopo, n: int) -> torch.Tensor:
    """Adjoint of :func:`sla_matvec`: device d sums its tenants' duals."""
    if sla.k == 0:
        return y.new_zeros(n)
    return tk.sla_rmatvec(y, sla.index)


def full_matvec(x, t, tree: TreeTopo, sla: SlaTopo):
    """``K z`` split into (tree rows, tenant rows, improvement rows)."""
    return tree_matvec(x, tree), sla_matvec(x, sla), x - t


def full_rmatvec(y_tree, y_sla, y_imp, tree: TreeTopo, sla: SlaTopo):
    """``K^T y`` -> (gradient on x, gradient on t)."""
    n = y_imp.shape[0]
    gx = tree_rmatvec(y_tree, tree, n) + sla_rmatvec(y_sla, sla, n) + y_imp
    gt = -torch.sum(y_imp)
    return gx, gt
