"""Dispatch of the tree matvecs: a CUDA tensor launches the kernel (or the
kernel raises), a CPU tensor runs the plain version in :mod:`.ref`."""

from __future__ import annotations

import torch

from repro_torch.kernels.tree_matvec import kernel
from repro_torch.kernels.tree_matvec.kernel import TreeIndex, tree_index
from repro_torch.kernels.tree_matvec.ref import tree_matvec_ref, tree_rmatvec_ref

__all__ = ["TreeIndex", "tree_index", "tree_matvec", "tree_rmatvec"]


def tree_matvec(x: torch.Tensor, idx: TreeIndex) -> torch.Tensor:
    if x.device.type == "cpu":
        return tree_matvec_ref(x, idx.start, idx.end)
    return kernel.tree_matvec(x, idx)


def tree_rmatvec(y: torch.Tensor, idx: TreeIndex) -> torch.Tensor:
    if y.device.type == "cpu":
        return tree_rmatvec_ref(y, idx.start, idx.end, idx.n)
    return kernel.tree_rmatvec(y, idx)
