"""Dispatch of the fused PDHG updates: a CUDA tensor launches the kernel (or
the kernel raises), a CPU tensor runs the plain version in :mod:`.ref`."""

from __future__ import annotations

from repro_torch.kernels.pdhg_update import kernel
from repro_torch.kernels.pdhg_update.ref import dual_prox_ref, primal_update_ref

__all__ = ["primal_update", "dual_prox"]


def primal_update(x, gx, c, w, target, lo, hi, tau):
    if x.device.type == "cpu":
        return primal_update_ref(x, gx, c, w, target, lo, hi, tau)
    return kernel.primal_update(x, gx, c, w, target, lo, hi, tau)


def dual_prox(y, a, sigma, lo, hi):
    if y.device.type == "cpu":
        return dual_prox_ref(y, a, sigma, lo, hi)
    return kernel.dual_prox(y, a, sigma, lo, hi)
