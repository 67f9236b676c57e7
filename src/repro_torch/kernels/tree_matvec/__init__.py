from repro_torch.kernels.tree_matvec.ops import (
    SlaIndex,
    TreeIndex,
    sla_index,
    sla_matvec,
    sla_rmatvec,
    scaled_rmatvec,
    tree_index,
    tree_matvec,
    tree_rmatvec,
)

__all__ = [
    "SlaIndex",
    "TreeIndex",
    "sla_index",
    "sla_matvec",
    "sla_rmatvec",
    "scaled_rmatvec",
    "tree_index",
    "tree_matvec",
    "tree_rmatvec",
]
