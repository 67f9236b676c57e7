from repro_torch.kernels.pdhg_update.ops import (
    dual_chunk_stats,
    dual_prox,
    primal_chunk_stats,
    primal_update,
)

__all__ = ["dual_chunk_stats", "dual_prox", "primal_chunk_stats", "primal_update"]
