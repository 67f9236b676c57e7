from repro_torch.kernels.pdhg_update.ops import dual_prox, primal_update

__all__ = ["dual_prox", "primal_update"]
