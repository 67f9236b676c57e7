from repro_torch.kernels.tree_matvec.ops import (
    TreeIndex,
    tree_index,
    tree_matvec,
    tree_rmatvec,
)

__all__ = ["TreeIndex", "tree_index", "tree_matvec", "tree_rmatvec"]
