"""Adaptive restart policy (PDLP-style) for the PDHG loop.

The loop evaluates the KKT score (max of the three relative residuals) of
the current iterate, of the running average and of the iterate with zero
duals at every check, takes the best as the *restart candidate*, and asks
:func:`restart_decision` whether to restart to it.  Three triggers:

* **sufficient decay** — the candidate improved on the score at the last
  restart by ``beta_suff``: lock the progress in;
* **necessary decay + stall** — improved by ``beta_nec`` but got *worse*
  since the previous check: the iterate is orbiting, adopt the candidate;
* **stall / artificial** — ``stall_checks`` consecutive checks without any
  score improvement, or ``restart_every`` chunks since the last restart.

On restart the primal weight is re-estimated from the primal/dual travel
distances since the last restart anchor (:func:`update_omega`); a frozen
side is a signal, not noise, so travel distances are floored, not gated.

Scores and the stall counter are 0-d tensors on the solve's device; only
the count of checks since the last restart is a host int.
"""

from __future__ import annotations

import torch

__all__ = ["restart_decision", "update_omega", "update_omega_blocks"]


def restart_decision(
    score_cand,
    score_prev,
    score_restart,
    chunks_since,
    stall_count,
    *,
    beta_suff: float,
    beta_nec: float,
    stall_checks: int,
    restart_every: int,
    adaptive: bool,
):
    """Decide whether to restart; returns
    ``(do_restart, new_stall_count, stalled)``, three 0-d tensors.

    ``chunks_since`` (checks since the last restart) is a host int, known
    because the loop brings each restart decision to the host; the scores
    and ``stall_count`` are 0-d tensors, so nothing here waits for the
    device.  ``score_prev`` is the candidate score at the previous check;
    ``score_restart`` the score right after the last restart.  ``stalled``
    reports that the stall detector (not a decay trigger) fired — the
    primal-weight update switches to residual balance in that case.
    """
    # "no improvement" leaves a little room for residual noise: a 0.1%
    # decay per 50-iteration chunk still means >= 10x over 5k iterations
    stalled_now = score_cand >= 0.999 * score_prev
    stall_count = torch.where(stalled_now, stall_count + 1, 0)
    artificial = chunks_since >= restart_every
    if not adaptive:
        do = torch.full_like(stalled_now, artificial)
        return do, torch.where(do, 0, stall_count), torch.zeros_like(stalled_now)
    # before any restart has anchored the score (inf), only the
    # stall/artificial triggers may fire
    anchored = torch.isfinite(score_restart)
    sufficient = anchored & (score_cand <= beta_suff * score_restart)
    necessary = (
        anchored
        & (score_cand <= beta_nec * score_restart)
        & (score_cand > score_prev)
    )
    stalled = stall_count >= stall_checks
    do = sufficient | necessary | stalled
    if artificial:
        do = torch.ones_like(do)
    return do, torch.where(do, 0, stall_count), stalled


def update_omega(omega, dx, dy, pres, dres, cres, stalled):
    """Primal-weight update: travel-ratio normally, residual-balance on
    stall.

    Our convention is ``tau ∝ omega``, so ``omega* ≈ dx/dy``, smoothed in
    log space.  When the restart was triggered by the stall detector the
    update balances residuals instead: ``omega* = omega * sqrt(dres /
    max(pres, cres))``.  A 4x rate limit and a global clip bound the
    adaptation.
    """
    tiny = 1e-10
    moved = (dx > tiny) | (dy > tiny)
    travel = torch.clamp_min(dx, tiny) / torch.clamp_min(dy, tiny)
    balance = torch.sqrt(
        torch.clamp_min(dres, tiny) / torch.clamp_min(torch.maximum(pres, cres), tiny)
    )
    ratio = torch.where(stalled, balance, travel)
    om_new = torch.where(
        moved | stalled,
        torch.exp(0.5 * torch.log(ratio) + 0.5 * torch.log(omega)),
        omega,
    )
    om_new = torch.minimum(torch.maximum(om_new, omega / 4.0), omega * 4.0)
    return torch.clamp(om_new, 1e-5, 1e5)


def update_omega_blocks(omega, omega_sla, dx, dy, dy_sla, pres, dres, cres, stalled):
    """Per-dual-block primal weights (PDLP multi-block style): the SLA rows
    get their own weight, re-estimated from their own dual travel against
    the shared primal travel with the :func:`update_omega` rule.  Returns
    ``(omega_new, omega_sla_new)``."""
    om = update_omega(omega, dx, dy, pres, dres, cres, stalled)
    om_sla = update_omega(omega_sla, dx, dy_sla, pres, dres, cres, stalled)
    return om, om_sla
