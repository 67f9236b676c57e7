"""Plain PyTorch versions of the tree and tenant matvec kernels: the CPU path of
:mod:`.ops` and the oracle the CUDA kernels are held against."""

from __future__ import annotations

import torch

__all__ = [
    "tree_matvec_ref",
    "tree_rmatvec_ref",
    "sla_matvec_ref",
    "sla_rmatvec_ref",
    "scaled_rmatvec_ref",
]


def tree_matvec_ref(x, start, end):
    """Subtree sums over DFS-contiguous ranges: out[j] = sum x[start_j:end_j]."""
    csum = torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device), torch.cumsum(x, 0)])
    return csum[end] - csum[start]


def tree_rmatvec_ref(y, start, end, n):
    """Adjoint: device i accumulates the duals of the rows covering it.
    Difference-array scatter (row order, as a sequential ``index_add_``)
    plus a prefix sum."""
    diff = torch.zeros(n + 1, dtype=y.dtype, device=y.device)
    diff.index_add_(0, start, y)
    diff.index_add_(0, end, -y)
    return torch.cumsum(diff, 0)[:n]


def sla_matvec_ref(x, dev, ten, k):
    """Per-tenant sums over the incidence edge list:
    out[t] = sum_{e: ten_e = t} x[dev_e], added in edge order."""
    out = torch.zeros(k, dtype=x.dtype, device=x.device)
    return out.index_add_(0, ten, x[dev])


def sla_rmatvec_ref(y, dev, ten, n):
    """Adjoint: out[d] = sum_{e: dev_e = d} y[ten_e], added in edge order."""
    out = torch.zeros(n, dtype=y.dtype, device=y.device)
    return out.index_add_(0, dev, y[ten])


def scaled_rmatvec_ref(y_tree, y_sla, y_imp, d_tree, d_sla, d_imp, sm, tree_idx, sla_idx):
    """The scaled adjoint of ``core.solver.scaling.scaled_rmatvec``, composed
    in its order: ``yi = d_imp * y_imp`` and
    ``gx = sm * ((tree_rmatvec(d_tree * y_tree) + sla_rmatvec(d_sla * y_sla)) + yi)``
    with ``sm = s * mov``, the tenant term only when the index has tenants.
    The two sums dispatch on the device (:mod:`.ops`): the plain versions
    above on the CPU, on a card the deterministic segment-sum kernels, since
    ``index_add_`` there adds with atomics in an order that changes from run
    to run.  Returns ``(gx, yi)``."""
    from repro_torch.kernels.tree_matvec import ops

    yi = d_imp * y_imp
    gx = ops.tree_rmatvec(d_tree * y_tree, tree_idx)
    if sla_idx.k:
        gx = gx + ops.sla_rmatvec(d_sla * y_sla, sla_idx)
    gx = gx + yi
    return sm * gx, yi
