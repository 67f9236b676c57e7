from repro_torch.kernels.pdhg_update.ops import (
    DualBlock,
    dual_chunk_stats,
    dual_prox,
    dual_update,
    primal_chunk_stats,
    primal_update,
)

__all__ = [
    "DualBlock",
    "dual_chunk_stats",
    "dual_prox",
    "dual_update",
    "primal_chunk_stats",
    "primal_update",
]
