"""Diagonal scaling and preconditioning for the matrix-free PDHG solver.

Two layers, both computed in closed form from the tree/SLA incidence (prefix
sums + segment sums — never a sparse matrix):

1. **Metric scaling** (:func:`make_scales`): curvature-aware primal variable
   scales (``s_i = 1/sqrt(w_i)`` so every quadratic variable has unit
   curvature; problem-range scale for LP variables), analytic row
   equilibration, and the fold-out of pinned columns.

2. **Step-size preconditioning** (:func:`pc_step_sizes`): per-variable /
   per-row Pock-Chambolle step sizes for the *scaled* operator
   ``A = D K_mov S``:

       tau_j   = theta * omega / sum_i |A_ij|      (column absolute sums)
       sigma_i = theta / (omega * sum_j |A_ij|)    (row absolute sums)

   which satisfy ``||Sigma^(1/2) A T^(1/2)|| <= theta`` for every
   ``theta <= 1`` by construction.  The scalar steps from a power iteration
   remain available via ``SolverOptions(precondition=False)``.

   Vacuous improvement rows (``imp_lo = -inf`` — every Phase I row) carry
   zero dual by construction, so they are excluded from the column sums.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.problem import StepProblem
from repro_torch.core.treeops import (
    SlaTopo,
    TreeTopo,
    sla_matvec,
    sla_rmatvec,
    tree_matvec,
    tree_rmatvec,
)
from repro_torch.kernels import tree_matvec as tk
from repro_torch.kernels.tree_matvec.ref import scaled_rmatvec_ref

__all__ = [
    "Scales",
    "StepSizes",
    "make_scales",
    "pc_step_sizes",
    "uniform_step_sizes",
    "scaled_matvec",
    "scaled_rmatvec",
    "estimate_norm",
]

class Scales(NamedTuple):
    s: torch.Tensor  # [n] primal variable scales
    s_t: torch.Tensor  # scalar: scale of t
    mov: torch.Tensor  # [n] 1.0 where the variable can move (lo < hi)
    t_mov: torch.Tensor  # scalar 0/1
    d_tree: torch.Tensor  # [m] row scales
    d_sla: torch.Tensor  # [k]
    d_imp: torch.Tensor  # [n]


class StepSizes(NamedTuple):
    """Unit-primal-weight diagonal step sizes for the scaled operator.

    The loop multiplies ``tau_*`` by the current primal weight ``omega`` and
    divides ``sig_*`` by it; the products ``tau_j * sig_i`` are
    omega-invariant, so the Pock-Chambolle bound holds for every omega.
    """

    tau_x: torch.Tensor  # [n]
    tau_t: torch.Tensor  # scalar
    sig_tree: torch.Tensor  # [m]
    sig_sla: torch.Tensor  # [k]
    sig_imp: torch.Tensor  # [n]


def make_scales(prob: StepProblem, tree: TreeTopo, sla: SlaTopo) -> Scales:
    """Curvature-aware primal scales + analytic row equilibration.

    Pinned variables (``lo == hi``) are folded out of the operator: their
    columns are zeroed via ``mov`` and the caller moves their contribution
    into the row bounds.  Row norms of the scaled movable constraint matrix
    are subtree / tenant sums of ``s^2 * mov``.
    """
    dtype = prob.lo.dtype
    span = prob.hi - prob.lo
    rng = torch.where(torch.isfinite(span), span, 0.0)
    range_scale = torch.clamp_min(torch.max(rng), 1.0)
    s = torch.where(
        prob.w > 0, 1.0 / torch.sqrt(torch.clamp_min(prob.w, 1e-30)), range_scale
    )
    s = torch.minimum(s, range_scale * 1e3)  # cap pathological 1/sqrt(w)
    # t appears in every active improvement row; shrink its scale by
    # 1/sqrt(n_imp) so the scaled column norm is O(1).
    n_imp = torch.sum(torch.isfinite(prob.imp_lo).to(dtype))
    s_t = range_scale / torch.sqrt(torch.clamp_min(n_imp, 1.0))

    mov = (prob.hi - prob.lo > 0).to(dtype)
    t_mov = (prob.t_hi - prob.t_lo > 0).to(dtype)
    s2m = s * s * mov
    d_tree = torch.rsqrt(torch.clamp_min(tree_matvec(s2m, tree), 1.0))
    if sla.k > 0:
        d_sla = torch.rsqrt(torch.clamp_min(sla_matvec(s2m, sla), 1.0))
    else:
        d_sla = s2m.new_zeros(0)
    d_imp = torch.rsqrt(torch.clamp_min(s2m + s_t * s_t * t_mov, 1.0))
    return Scales(s, s_t, mov, t_mov, d_tree, d_sla, d_imp)


def scaled_matvec(xs, ts, tree, sla, sc: Scales, *, use_kernels=False):
    """Scaled forward operator D2 K_mov S, split by row block.  Input is the
    SCALED primal (x~, t~); pinned columns are zeroed (folded into bounds).

    ``use_kernels`` routes the tree prefix through the CUDA kernel
    (:mod:`repro_torch.kernels.tree_matvec`) — the
    ``SolverOptions.use_pallas_tree`` path.  The tenant sums take their
    kernel on a card either way (see :mod:`repro_torch.core.treeops`).
    """
    x = sc.s * sc.mov * xs
    kx = tk.tree_matvec(x, tree.index) if use_kernels else tree_matvec(x, tree)
    return (
        sc.d_tree * kx,
        sc.d_sla * sla_matvec(x, sla),
        sc.d_imp * (x - sc.s_t * sc.t_mov * ts),
    )


def scaled_rmatvec(y_tree, y_sla, y_imp, tree, sla, sc: Scales, n):
    """Scaled adjoint S K_mov^T D2 -> (grad on x~, grad on t~) of ``n``
    devices (the tree's).

    The plain composition,
    :func:`repro_torch.kernels.tree_matvec.ref.scaled_rmatvec_ref`: both
    scatter sums take their deterministic kernels on a card and their
    plain versions on the CPU (see :mod:`repro_torch.core.treeops`), so
    unlike the reference this needs no kernel switch.  The solver loop
    launches the same arithmetic as one kernel with ``use_pallas_tree``."""
    gx, yi = scaled_rmatvec_ref(
        y_tree, y_sla, y_imp, sc.d_tree, sc.d_sla, sc.d_imp, sc.s * sc.mov, tree.index,
        sla.index,
    )
    return gx, -sc.s_t * sc.t_mov * torch.sum(yi)


def pc_step_sizes(
    prob: StepProblem, tree: TreeTopo, sla: SlaTopo, sc: Scales, theta
) -> StepSizes:
    """Pock-Chambolle (alpha = 1) diagonal step sizes from the incidence:
    subtree prefix sums for the tree rows, segment sums for the SLA rows, an
    ancestor scatter (``tree_rmatvec``) for the per-device column sums."""
    n = prob.n
    dtype = prob.lo.dtype
    sm = sc.s * sc.mov  # per-variable |column entry| before row scaling
    act = torch.isfinite(prob.imp_lo).to(dtype)  # improvement row is live

    # row absolute sums of A = D K_mov S
    row_tree = sc.d_tree * tree_matvec(sm, tree)
    if sla.k > 0:
        row_sla = sc.d_sla * sla_matvec(sm, sla)
    else:
        row_sla = sm.new_zeros(0)
    row_imp = sc.d_imp * (sm + sc.s_t * sc.t_mov)

    # column absolute sums: each device accumulates its covering rows' scales
    col_x = sm * (
        tree_rmatvec(sc.d_tree, tree, n)
        + sla_rmatvec(sc.d_sla, sla, n)
        + sc.d_imp * act
    )
    col_t = sc.s_t * sc.t_mov * torch.sum(sc.d_imp * act)

    tiny = 1e-12
    theta = torch.full((), theta, dtype=dtype, device=sm.device)
    return StepSizes(
        tau_x=theta / torch.clamp_min(col_x, tiny),
        tau_t=theta / torch.clamp_min(col_t, tiny),
        sig_tree=theta / torch.clamp_min(row_tree, tiny),
        sig_sla=theta / torch.clamp_min(row_sla, tiny),
        sig_imp=theta / torch.clamp_min(row_imp, tiny),
    )


def uniform_step_sizes(
    tree: TreeTopo, sla: SlaTopo, sc: Scales, n: int, theta, power_iters: int, dtype
) -> StepSizes:
    """Scalar steps broadcast to the diagonal form:
    ``tau = sigma = theta / ||A||`` with the norm from a power iteration."""
    knorm = torch.clamp_min(estimate_norm(tree, sla, sc, n, power_iters, dtype), 1e-6)
    tau = theta / knorm
    return StepSizes(
        tau_x=tau.expand(n).clone(),
        tau_t=tau.clone(),
        sig_tree=tau.expand(tree.m).clone(),
        sig_sla=tau.expand(sla.k).clone(),
        sig_imp=tau.expand(n).clone(),
    )


def estimate_norm(tree, sla, sc: Scales, n, iters, dtype):
    """||D2 K S||_2 via power iteration on (D2 K S)^T (D2 K S)."""
    dev = sc.s.device
    scale = torch.sqrt(torch.full((), n + 1, dtype=dtype, device=dev))
    x = torch.ones(n, dtype=dtype, device=dev) / scale
    t = torch.ones((), dtype=dtype, device=dev) / scale
    for _ in range(iters):
        nrm = torch.sqrt(torch.sum(x * x) + t * t)
        x, t = x / nrm, t / nrm
        a, b, c = scaled_matvec(x, t, tree, sla, sc)
        x, t = scaled_rmatvec(a, b, c, tree, sla, sc, n)
    return torch.sqrt(torch.sqrt(torch.sum(x * x) + t * t))  # sqrt ||K^TK v|| ~ ||K||
