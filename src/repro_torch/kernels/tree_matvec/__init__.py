from repro_torch.kernels.tree_matvec.ops import (
    PrimalStepData,
    SlaIndex,
    TreeIndex,
    primal_step,
    primal_step_plan,
    sla_index,
    sla_matvec,
    sla_rmatvec,
    scaled_rmatvec,
    tree_index,
    tree_matvec,
    tree_rmatvec,
)

__all__ = [
    "PrimalStepData",
    "SlaIndex",
    "TreeIndex",
    "primal_step",
    "primal_step_plan",
    "sla_index",
    "sla_matvec",
    "sla_rmatvec",
    "scaled_rmatvec",
    "tree_index",
    "tree_matvec",
    "tree_rmatvec",
]
