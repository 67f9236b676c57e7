from repro_torch.kernels.pdhg_update.ops import (
    DualBlock,
    check_chunk_stats,
    dual_chunk_stats,
    dual_chunk_stats_pair,
    dual_prox,
    dual_update,
    primal_chunk_stats,
    primal_update,
)

__all__ = [
    "DualBlock",
    "check_chunk_stats",
    "dual_chunk_stats",
    "dual_chunk_stats_pair",
    "dual_prox",
    "dual_update",
    "primal_chunk_stats",
    "primal_update",
]
