"""Plain PyTorch versions of the fused PDHG update kernels: the CPU path of
:mod:`.ops` and the oracle the CUDA kernels are held against."""

from __future__ import annotations

import torch

__all__ = ["primal_update_ref", "dual_prox_ref"]


def primal_update_ref(x, gx, c, w, target, lo, hi, tau):
    """Primal prox (diagonal quadratic + box) and over-relaxed extrapolation.

    x1 = clip((x - tau*(gx + c) + tau*w*target) / (1 + tau*w), lo, hi)
    xe = 2*x1 - x
    """
    x1 = torch.clamp((x - tau * (gx + c) + tau * w * target) / (1.0 + tau * w), lo, hi)
    return x1, 2.0 * x1 - x


def dual_prox_ref(y, a, sigma, lo, hi):
    """prox of sigma*g* for g = indicator[lo, hi] applied to z = y + sigma*a:
    z - sigma * clip(z / sigma, lo, hi)."""
    z = y + sigma * a
    return z - sigma * torch.clamp(z / sigma, lo, hi)
