"""Plain PyTorch versions of the tree matvec kernels: the CPU path of
:mod:`.ops` and the oracle the CUDA kernels are held against."""

from __future__ import annotations

import torch

__all__ = ["tree_matvec_ref", "tree_rmatvec_ref"]


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
