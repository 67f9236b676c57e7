"""Plain PyTorch versions of the tree and tenant matvec kernels: the CPU path of
:mod:`.ops` and the oracle the CUDA kernels are held against."""

from __future__ import annotations

import torch

__all__ = ["tree_matvec_ref", "tree_rmatvec_ref", "sla_matvec_ref", "sla_rmatvec_ref"]


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
