"""Plain PyTorch versions of the tree and tenant matvec kernels: the CPU path of
:mod:`.ops` and the oracle the CUDA kernels are held against.  Each takes
``[..., n]``: a vector, or ``[K, n]`` for K lanes over the same rows, each
lane's row summed as the vector would be.  Rows and edges given as ``[K, m]``
/ ``[K, E]`` are each lane's own topology (a stacked fleet's domains): the
gathers read each lane's own entries, and the scatters run lane by lane, the
one-vector call on each lane's row, so that every lane gets the bits of the
vector call on its own topology."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.kernels.pdhg_update.ref import primal_update_ref

__all__ = [
    "PrimalStepData",
    "index_add",
    "take",
    "tree_matvec_ref",
    "tree_rmatvec_ref",
    "sla_matvec_ref",
    "sla_rmatvec_ref",
    "scaled_rmatvec_ref",
    "primal_step_ref",
]


def take(v, idx):
    """``v[..., idx]``; with ``[K, size]`` indices (each lane its own), lane
    j's entries of ``v[j]``."""
    if idx.ndim == 1:
        return v[..., idx]
    return torch.gather(v, -1, idx.to(torch.int64))


def index_add(out, idx, src):
    """``out.index_add_(-1, idx, src)``, in place: the entries of ``src``
    added in index order.  With ``[K, size]`` indices each lane adds its
    own, lane by lane on the CPU (the one-vector call on each row, so each
    lane has the bits of that call) and in one ``scatter_add_`` on a card,
    where ``index_add_`` adds with atomics in no fixed order either."""
    if idx.ndim == 1:
        return out.index_add_(-1, idx, src)
    if out.device.type == "cpu":
        for j in range(out.shape[0]):
            out[j].index_add_(0, idx[j], src[j])
        return out
    return out.scatter_add_(-1, idx.to(torch.int64), src)


def tree_matvec_ref(x, start, end):
    """Subtree sums over DFS-contiguous ranges: out[j] = sum x[start_j:end_j]."""
    zero = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    csum = torch.cat([zero, torch.cumsum(x, -1)], -1)
    return take(csum, end) - take(csum, start)


def tree_rmatvec_ref(y, start, end, n):
    """Adjoint: device i accumulates the duals of the rows covering it.
    Difference-array scatter (row order, as a sequential ``index_add_``)
    plus a prefix sum."""
    diff = torch.zeros(y.shape[:-1] + (n + 1,), dtype=y.dtype, device=y.device)
    index_add(diff, start, y)
    index_add(diff, end, -y)
    return torch.cumsum(diff, -1)[..., :n]


def sla_matvec_ref(x, dev, ten, k):
    """Per-tenant sums over the incidence edge list:
    out[t] = sum_{e: ten_e = t} x[dev_e], added in edge order."""
    out = torch.zeros(x.shape[:-1] + (k,), dtype=x.dtype, device=x.device)
    return index_add(out, ten, take(x, dev))


def sla_rmatvec_ref(y, dev, ten, n):
    """Adjoint: out[d] = sum_{e: dev_e = d} y[ten_e], added in edge order."""
    out = torch.zeros(y.shape[:-1] + (n,), dtype=y.dtype, device=y.device)
    return index_add(out, dev, take(y, ten))


def scaled_rmatvec_ref(y_tree, y_sla, y_imp, d_tree, d_sla, d_imp, sm, tree_idx, sla_idx):
    """The scaled adjoint of ``core.solver.scaling.scaled_rmatvec``, composed
    in its order: ``yi = d_imp * y_imp`` and
    ``gx = sm * ((tree_rmatvec(d_tree * y_tree) + sla_rmatvec(d_sla * y_sla)) + yi)``
    with ``sm = s * mov``, the tenant term only when the index has tenants.
    The two sums dispatch on the device (:mod:`.ops`): the plain versions
    above on the CPU, on a card the deterministic segment-sum kernels, since
    ``index_add_`` there adds with atomics in an order that changes from run
    to run.  Returns ``(gx, yi)``."""
    from repro_torch.kernels.tree_matvec import ops

    yi = d_imp * y_imp
    gx = ops.tree_rmatvec(d_tree * y_tree, tree_idx)
    if sla_idx.k:
        gx = gx + ops.sla_rmatvec(d_sla * y_sla, sla_idx)
    gx = gx + yi
    return sm * gx, yi


class PrimalStepData(NamedTuple):
    """What the primal step reads that stays fixed through a solve: the
    scaled problem data of the primal prox (``c``, ``w``, ``target``, ``lo``,
    ``hi``, each [n]), the row scales of the tree, tenant and improvement
    rows, ``sm = s * mov`` and the two kernel indexes."""

    c: torch.Tensor
    w: torch.Tensor
    target: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    d_tree: torch.Tensor
    d_sla: torch.Tensor
    d_imp: torch.Tensor
    sm: torch.Tensor
    tree_idx: Any  # TreeIndex
    sla_idx: Any  # SlaIndex


def primal_step_ref(x, y_tree, y_sla, y_imp, tau, data: PrimalStepData):
    """The primal half of a PDHG iteration, composed as the solver loop did
    it in three launches: :func:`scaled_rmatvec_ref`, then the primal prox
    and extrapolation (``primal_update_ref``), then the column scaling of
    the two matvecs' input, ``xm = sm * xe``.  ``tau`` is a [n] vector or a
    0-d tensor (with lanes, ``[K, n]`` or a ``[K, 1]`` column).  Returns
    ``(x1, xe, xm, yi)``."""
    gx, yi = scaled_rmatvec_ref(y_tree, y_sla, y_imp, data.d_tree, data.d_sla, data.d_imp,
                                data.sm, data.tree_idx, data.sla_idx)
    x1, xe = primal_update_ref(x, gx, data.c, data.w, data.target, data.lo, data.hi, tau)
    return x1, xe, data.sm * xe, yi
