"""Dispatch of the tree and tenant matvecs: a CUDA tensor launches the
kernel (or the kernel raises), a CPU tensor runs the plain version in
:mod:`.ref`."""

from __future__ import annotations

import torch

from repro_torch.kernels.tree_matvec import kernel
from repro_torch.kernels.tree_matvec.kernel import (
    SlaIndex,
    TreeIndex,
    sla_index,
    sla_index_update,
    tree_index,
    tree_index_update,
)
from repro_torch.kernels.tree_matvec.ref import (
    PrimalStepData,
    primal_step_ref,
    scaled_rmatvec_ref,
    sla_matvec_ref,
    sla_rmatvec_ref,
    tree_matvec_ref,
    tree_rmatvec_ref,
)

__all__ = [
    "PrimalStepData",
    "SlaIndex",
    "TreeIndex",
    "sla_index",
    "sla_index_update",
    "sla_matvec",
    "sla_rmatvec",
    "scaled_rmatvec",
    "primal_step",
    "primal_step_plan",
    "tree_index",
    "tree_index_update",
    "tree_matvec",
    "tree_rmatvec",
]


def tree_matvec(x: torch.Tensor, idx: TreeIndex) -> torch.Tensor:
    if x.device.type == "cpu":
        return tree_matvec_ref(x, idx.start, idx.end)
    return kernel.tree_matvec(x, idx)


def tree_rmatvec(y: torch.Tensor, idx: TreeIndex) -> torch.Tensor:
    if y.device.type == "cpu":
        return tree_rmatvec_ref(y, idx.start, idx.end, idx.n)
    return kernel.tree_rmatvec(y, idx)


def sla_matvec(x: torch.Tensor, idx: SlaIndex) -> torch.Tensor:
    if x.device.type == "cpu":
        return sla_matvec_ref(x, idx.dev, idx.ten, idx.k)
    return kernel.sla_matvec(x, idx)


def sla_rmatvec(y: torch.Tensor, idx: SlaIndex) -> torch.Tensor:
    if y.device.type == "cpu":
        return sla_rmatvec_ref(y, idx.dev, idx.ten, idx.n)
    return kernel.sla_rmatvec(y, idx)


def scaled_rmatvec(y_tree, y_sla, y_imp, d_tree, d_sla, d_imp, sm, tree_idx: TreeIndex,
                   sla_idx: SlaIndex):
    if y_imp.device.type == "cpu":
        return scaled_rmatvec_ref(y_tree, y_sla, y_imp, d_tree, d_sla, d_imp, sm, tree_idx,
                                  sla_idx)
    return kernel.scaled_rmatvec(y_tree, y_sla, y_imp, d_tree, d_sla, d_imp, sm, tree_idx,
                                 sla_idx)


def primal_step_plan(data: PrimalStepData):
    """Once per solve: the data itself on the CPU, a checked
    :class:`.kernel.PrimalStepPlan` on a card."""
    if data.sm.device.type == "cpu":
        return data
    return kernel.primal_step_plan(data)


def primal_step(x, y_tree, y_sla, y_imp, tau, plan):
    """(x1, xe, xm, yi): the scaled adjoint with the primal update as its
    epilogue; ``plan`` from :func:`primal_step_plan`."""
    if x.device.type == "cpu":
        return primal_step_ref(x, y_tree, y_sla, y_imp, tau, plan)
    return kernel.primal_step(x, y_tree, y_sla, y_imp, tau, plan)
