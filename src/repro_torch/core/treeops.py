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
operators; ``SolverOptions(use_pallas_tree=True)`` routes the solver's tree
matvecs through the CUDA kernels of :mod:`repro_torch.kernels.tree_matvec`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.tree_matvec import TreeIndex, tree_index

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
    """

    dev: torch.Tensor  # [nnz] int64
    ten: torch.Tensor  # [nnz] int64
    lo: torch.Tensor  # [k] float
    hi: torch.Tensor  # [k] float

    @property
    def k(self) -> int:
        return self.lo.shape[0]

    @classmethod
    def make(cls, dev, ten, lo, hi, *, dtype, device) -> "SlaTopo":
        """Build from host arrays (numpy or CPU tensors)."""
        return cls(
            dev=_as_index(dev, device),
            ten=_as_index(ten, device),
            lo=_as_float(lo, dtype, device),
            hi=_as_float(hi, dtype, device),
        )

    @classmethod
    def empty(cls, dtype=torch.float32, device="cpu") -> "SlaTopo":
        return cls.make([], [], [], [], dtype=dtype, device=device)


def tree_matvec(x: torch.Tensor, tree: TreeTopo) -> torch.Tensor:
    """Per-node subtree sums of ``x`` — the tree block of ``K z``."""
    csum = torch.cat([x.new_zeros(1), torch.cumsum(x, 0)])
    return csum[tree.end] - csum[tree.start]


def tree_rmatvec(y: torch.Tensor, tree: TreeTopo, n: int) -> torch.Tensor:
    """Transpose of :func:`tree_matvec`: device i accumulates its ancestors'
    duals.  Difference-array scatter + cumsum."""
    diff = y.new_zeros(n + 1)
    diff.index_add_(0, tree.start, y)
    diff.index_add_(0, tree.end, -y)
    return torch.cumsum(diff, 0)[:n]


def sla_matvec(x: torch.Tensor, sla: SlaTopo) -> torch.Tensor:
    """Per-tenant sums of ``x`` over the incidence list."""
    out = x.new_zeros(sla.k)
    if sla.k == 0:
        return out
    return out.index_add_(0, sla.ten, x[sla.dev])


def sla_rmatvec(y: torch.Tensor, sla: SlaTopo, n: int) -> torch.Tensor:
    out = y.new_zeros(n)
    if sla.k == 0:
        return out
    return out.index_add_(0, sla.dev, y[sla.ten])


def full_matvec(x, t, tree: TreeTopo, sla: SlaTopo):
    """``K z`` split into (tree rows, tenant rows, improvement rows)."""
    return tree_matvec(x, tree), sla_matvec(x, sla), x - t


def full_rmatvec(y_tree, y_sla, y_imp, tree: TreeTopo, sla: SlaTopo):
    """``K^T y`` -> (gradient on x, gradient on t)."""
    n = y_imp.shape[0]
    gx = tree_rmatvec(y_tree, tree, n) + sla_rmatvec(y_sla, sla, n) + y_imp
    gt = -torch.sum(y_imp)
    return gx, gt
