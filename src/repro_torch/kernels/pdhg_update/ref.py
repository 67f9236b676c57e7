"""Plain PyTorch versions of the fused PDHG update kernels: the CPU path of
:mod:`.ops` and the oracle the CUDA kernels are held against."""

from __future__ import annotations

import torch

__all__ = [
    "primal_update_ref",
    "dual_prox_ref",
    "primal_chunk_stats_ref",
    "dual_chunk_stats_ref",
]


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


def _max_abs(v):
    # the reference pads to whole blocks with zeros, so an empty vector's max is 0
    return torch.max(torch.abs(v)) if v.shape[0] else v.new_zeros(())


def primal_chunk_stats_ref(x, px, rx, ax, cnt):
    """Chunk-boundary primal bookkeeping: average accumulation + move norms
    + current/average restart-candidate travel (squared)."""
    axn = ax + x
    return (
        axn,
        _max_abs(x - px),
        _max_abs(x),
        torch.sum((x - rx) ** 2),
        torch.sum((axn / cnt - rx) ** 2),
    )


def dual_chunk_stats_ref(y, ry, ay, cnt):
    """Chunk-boundary dual bookkeeping: average accumulation +
    current/average/zero-dual restart-candidate travel (squared)."""
    ayn = ay + y
    return (
        ayn,
        torch.sum((y - ry) ** 2),
        torch.sum((ayn / cnt - ry) ** 2),
        torch.sum(ry * ry),
    )
