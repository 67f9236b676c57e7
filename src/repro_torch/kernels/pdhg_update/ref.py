"""Plain PyTorch versions of the fused PDHG update kernels: the CPU path of
:mod:`.ops` and the oracle the CUDA kernels are held against.  Each takes
``[..., n]``: a vector, or ``[K, n]`` for K lanes, whose per-lane scalars
(step sizes, ``t``, the chunk statistics) are ``[K, 1]`` columns."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "DualBlock",
    "primal_update_ref",
    "dual_prox_ref",
    "dual_update_ref",
    "primal_chunk_stats_ref",
    "dual_chunk_stats_ref",
    "dual_chunk_stats_pair_ref",
    "check_chunk_stats_ref",
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


class DualBlock(NamedTuple):
    """One row block of the fused dual step: its duals ``y``, the matvec's
    raw output ``a`` (for the improvement rows, ``x = s * mov * xe``), the
    row scales ``d``, the step sizes ``sigma`` (a vector, or one 0-d tensor
    for every row) and the bounds ``lo``/``hi`` (may be infinite)."""

    y: torch.Tensor
    a: torch.Tensor
    d: torch.Tensor
    sigma: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor


def dual_update_ref(tree: DualBlock, sla: DualBlock, imp: DualBlock, s_t, t_mov, te):
    """The whole dual step of a PDHG iteration: the row scaling of the
    scaled forward operator (``a_tree = d_tree * kx``, ``a_sla = d_sla * sx``,
    ``a_imp = d_imp * (x - s_t * t_mov * te)``) and each block's dual prox,
    in the order of ``core.solver.scaling.scaled_matvec`` and
    :func:`dual_prox_ref`.  Returns the three blocks' new duals."""
    a_imp = imp.d * (imp.a - s_t * t_mov * te)
    return (
        dual_prox_ref(tree.y, tree.d * tree.a, tree.sigma, tree.lo, tree.hi),
        dual_prox_ref(sla.y, sla.d * sla.a, sla.sigma, sla.lo, sla.hi),
        dual_prox_ref(imp.y, a_imp, imp.sigma, imp.lo, imp.hi),
    )


def _max_abs(v):
    # the reference pads to whole blocks with zeros, so an empty vector's max is 0
    if v.ndim == 1:
        return torch.max(torch.abs(v)) if v.shape[0] else v.new_zeros(())
    return torch.abs(v).amax(-1, keepdim=True) if v.shape[-1] else v.new_zeros(v.shape[0], 1)


def _sum(v):
    return torch.sum(v) if v.ndim == 1 else v.sum(-1, keepdim=True)


def _true_div(v, cnt):
    # a 0-d tensor on v's device: torch's CUDA division by a host number
    # multiplies by its reciprocal, the kernels and the reference divide.
    # With lanes ``cnt`` holds one count per lane.
    if v.ndim == 1:
        return v / v.new_full((), cnt)
    if not isinstance(cnt, torch.Tensor):
        cnt = torch.as_tensor(np.array(cnt, np.float64))
    return v / cnt.to(v).reshape(-1, 1)


def primal_chunk_stats_ref(x, px, rx, ax, cnt):
    """Chunk-boundary primal bookkeeping: average accumulation + move norms
    + current/average restart-candidate travel (squared)."""
    axn = ax + x
    return (
        axn,
        _max_abs(x - px),
        _max_abs(x),
        _sum((x - rx) ** 2),
        _sum((_true_div(axn, cnt) - rx) ** 2),
    )


def dual_chunk_stats_ref(y, ry, ay, cnt):
    """Chunk-boundary dual bookkeeping: average accumulation +
    current/average/zero-dual restart-candidate travel (squared)."""
    ayn = ay + y
    return (
        ayn,
        _sum((y - ry) ** 2),
        _sum((_true_div(ayn, cnt) - ry) ** 2),
        _sum(ry * ry),
    )


def dual_chunk_stats_pair_ref(first, second, cnt):
    """:func:`dual_chunk_stats_ref` of two (y, ry, ay) triples: the solver's
    tree rows and improvement rows at a KKT check."""
    return dual_chunk_stats_ref(*first, cnt), dual_chunk_stats_ref(*second, cnt)


def check_chunk_stats_ref(primal, tree, imp, t, at, ys, ays, cnt):
    """Every chunk statistic of one KKT check: :func:`primal_chunk_stats_ref`
    of ``primal`` = (x, px, rx, ax), :func:`dual_chunk_stats_pair_ref` of the
    tree and improvement rows' (y, ry, ay), then the t and tenant
    accumulators ``at + t`` and ``ays + ys``."""
    return (
        primal_chunk_stats_ref(*primal, cnt),
        *dual_chunk_stats_pair_ref(tree, imp, cnt),
        at + t,
        ays + ys,
    )
