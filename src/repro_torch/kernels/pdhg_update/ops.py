"""Dispatch of the fused PDHG updates and chunk statistics: a CUDA tensor
launches the kernel (or the kernel raises), a CPU tensor runs the plain
version in :mod:`.ref`."""

from __future__ import annotations

from repro_torch.kernels.pdhg_update import kernel
from repro_torch.kernels.pdhg_update.ref import (
    DualBlock,
    check_chunk_stats_ref,
    dual_chunk_stats_pair_ref,
    dual_chunk_stats_ref,
    dual_prox_ref,
    dual_update_ref,
    primal_chunk_stats_ref,
    primal_update_ref,
)

__all__ = [
    "DualBlock",
    "primal_update",
    "dual_prox",
    "dual_update",
    "primal_chunk_stats",
    "dual_chunk_stats",
    "dual_chunk_stats_pair",
    "check_chunk_stats",
]


def primal_update(x, gx, c, w, target, lo, hi, tau):
    if x.device.type == "cpu":
        return primal_update_ref(x, gx, c, w, target, lo, hi, tau)
    return kernel.primal_update(x, gx, c, w, target, lo, hi, tau)


def dual_prox(y, a, sigma, lo, hi):
    if y.device.type == "cpu":
        return dual_prox_ref(y, a, sigma, lo, hi)
    return kernel.dual_prox(y, a, sigma, lo, hi)


def dual_update(tree: DualBlock, sla: DualBlock, imp: DualBlock, s_t, t_mov, te):
    if imp.y.device.type == "cpu":
        return dual_update_ref(tree, sla, imp, s_t, t_mov, te)
    return kernel.dual_update(tree, sla, imp, s_t, t_mov, te)


def primal_chunk_stats(x, px, rx, ax, cnt):
    if x.device.type == "cpu":
        return primal_chunk_stats_ref(x, px, rx, ax, cnt)
    return kernel.primal_chunk_stats(x, px, rx, ax, cnt)


def dual_chunk_stats(y, ry, ay, cnt):
    if y.device.type == "cpu":
        return dual_chunk_stats_ref(y, ry, ay, cnt)
    return kernel.dual_chunk_stats(y, ry, ay, cnt)


def dual_chunk_stats_pair(first, second, cnt):
    if first[0].device.type == "cpu":
        return dual_chunk_stats_pair_ref(first, second, cnt)
    return kernel.dual_chunk_stats_pair(first, second, cnt)


def check_chunk_stats(primal, tree, imp, t, at, ys, ays, cnt):
    if primal[0].device.type == "cpu":
        return check_chunk_stats_ref(primal, tree, imp, t, at, ys, ays, cnt)
    return kernel.check_chunk_stats(primal, tree, imp, t, at, ys, ays, cnt)
