"""Public datatypes of the :mod:`repro_torch.core.solver` package.

:class:`SolverOptions` keeps the reference's field names and order, so a
test can carry options across field by field.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "KKT_HIST_BUCKETS",
    "KKT_HIST_LO_EXP",
    "SolverOptions",
    "SolverState",
    "SolveStats",
]

# Shape of the in-loop KKT-score histogram accumulated by the solve loop:
# bucket ``b`` holds scores in ``[10**(LO_EXP+b), 10**(LO_EXP+b+1))``,
# clipped at both ends.
KKT_HIST_BUCKETS = 16
KKT_HIST_LO_EXP = -12


class SolverOptions(NamedTuple):
    eps_abs: float = 1e-6
    eps_rel: float = 1e-6
    max_iters: int = 50_000
    check_every: int = 50  # KKT check cadence (iterations)
    # maximum chunks between restarts.  With ``adaptive_restarts`` this is
    # the *artificial* restart cadence (the KKT-progress triggers usually
    # fire first); without it, the fixed restart period.
    restart_every: int = 8
    # step-size safety: tau_j * sigma_i * |K_ij| row/col sums <= theta^2
    theta: float = 0.9
    omega0: float = 0.0  # initial primal weight; <= 0 -> auto
    power_iters: int = 40  # only used when precondition=False
    # In the port these select this package's hand-written CUDA kernels:
    # ``use_pallas`` the fused primal/dual updates
    # (repro_torch.kernels.pdhg_update) for the n- and m-sized blocks of the
    # inner iteration (the tiny SLA block and the scalar t stay plain
    # torch).  On CPU tensors the kernels' plain versions run.
    use_pallas: bool = False
    # accepted for parity with the reference's options and ignored: the
    # port has no interpret mode
    pallas_interpret: bool | None = None
    # Diagonal (Pock-Chambolle) step sizes computed in closed form from the
    # tree/SLA incidence; False falls back to scalar steps from the global
    # operator-norm power iteration.
    precondition: bool = True
    # KKT-progress restart triggers (PDLP's sufficient/necessary decay
    # factors); False restarts on the fixed ``restart_every`` cadence only.
    adaptive_restarts: bool = True
    restart_beta_suff: float = 0.2
    restart_beta_nec: float = 0.8
    # consecutive no-improvement KKT checks before a stall forces a restart
    stall_checks: int = 2
    # no-progress / optimal-vertex certificate: exit when the primal iterate
    # has moved less than ``noprogress_tol`` (relative) for
    # ``noprogress_patience`` consecutive checks AND the t-polished iterate
    # is primal-feasible to tolerance.  0 disables the certificate.
    noprogress_tol: float = 1e-9
    noprogress_patience: int = 4
    # exact epigraph polish on exit: t <- clip(min_i(x_i - imp_lo_i))
    polish_t: bool = True
    # Route the tree matvec of the inner iteration through its CUDA kernel
    # (repro_torch.kernels.tree_matvec).  The scatter sums (tree adjoint,
    # tenant rows) take their deterministic kernels on a card regardless.
    use_pallas_tree: bool = False
    # Fused chunk-boundary statistics at every KKT check
    # (repro_torch.kernels.pdhg_update.check_chunk_stats): the average
    # accumulators, the move norms and the restart-candidate travel of every
    # block in one launch.
    use_pallas_stats: bool = False
    # Per-dual-block primal weights (PDLP multi-block style): a second
    # omega for the SLA rows.  Requires precondition=True (inert otherwise /
    # without SLAs).
    blockwise_omega: bool = False


class SolverState(NamedTuple):
    """Warm-startable solver state in ORIGINAL units (primal + duals); with
    K lanes every leaf has a leading ``[K]`` axis (``t`` a ``[K, 1]``
    column)."""

    x: torch.Tensor  # [n]
    t: torch.Tensor  # scalar
    y_tree: torch.Tensor  # [m] duals (original metric)
    y_sla: torch.Tensor  # [k]
    y_imp: torch.Tensor  # [n]

    @classmethod
    def zeros(cls, n: int, m: int, k: int, dtype, device, lanes: int | None = None
              ) -> "SolverState":
        lead = () if lanes is None else (lanes,)

        def z(*shape):
            return torch.zeros(lead + shape, dtype=dtype, device=device)

        return cls(z(n), z() if lanes is None else z(1), z(m), z(k), z(n))


class SolveStats(NamedTuple):
    """Per-solve statistics.  The loop's control flow runs on the host, so
    the counts and exit flags are Python values; residuals stay 0-d tensors
    on the solve's device.  With K lanes the counts and flags are numpy
    arrays of K entries and the residuals ``[K, 1]`` columns."""

    iterations: int
    primal_res: torch.Tensor
    dual_res: torch.Tensor
    comp_res: torch.Tensor
    # exited on a certificate (KKT or no-progress) rather than max_iters
    converged: bool
    omega: torch.Tensor
    # KKT-certified to tolerance; ``converged and not certified`` is the
    # no-progress/optimal-vertex certificate (see solver.termination)
    certified: bool
    restarts: int
    # [KKT_HIST_BUCKETS] int32: log10-bucketed KKT scores observed at the
    # in-loop termination checks
    score_hist: torch.Tensor
