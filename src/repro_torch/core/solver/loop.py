"""The PDHG solve loop: chunks of ``check_every`` iterations, with the KKT
and restart checks between chunks.

Composition of the package: :mod:`~repro_torch.core.solver.scaling`
supplies the metric change and the diagonal (Pock-Chambolle) step sizes,
:mod:`~repro_torch.core.solver.restarts` the adaptive restart policy and
primal-weight updates, :mod:`~repro_torch.core.solver.termination` the KKT
residuals and the no-progress/optimal-vertex certificate.

The reference runs this as one jitted ``lax.while_loop`` over ``lax.scan``
chunks.  Here the chunk is a Python loop that queues device work without
waiting for it, and each check computes its decisions on the device and
brings them to the host in one transfer (three flags: done, restart,
certified).  Every arithmetic step keeps the reference's order, so the
iteration counts agree with it.
"""

from __future__ import annotations

import torch

from repro_torch.core.problem import StepProblem
from repro_torch.core.solver import restarts as restarts_mod
from repro_torch.core.solver import scaling, termination
from repro_torch.core.solver.options import (
    KKT_HIST_BUCKETS,
    KKT_HIST_LO_EXP,
    SolveStats,
    SolverOptions,
    SolverState,
)
from repro_torch.core.treeops import (
    SlaTopo,
    TreeTopo,
    sla_matvec,
    sla_rmatvec,
    tree_matvec,
    tree_rmatvec,
)
from repro_torch.kernels import pdhg_update as pk
from repro_torch.kernels import tree_matvec as tk

__all__ = ["solve"]

_INF = float("inf")


def _dual_prox(z, sigma, lo, hi):
    """prox of sigma * g* for g = indicator[lo, hi]:  z - sigma*clip(z/sigma).
    ``sigma`` may be a scalar or a per-row vector (preconditioned form)."""
    return z - sigma * torch.clamp(z / sigma, lo, hi)


def solve(
    prob: StepProblem,
    tree: TreeTopo,
    sla: SlaTopo,
    init: SolverState,
    opts: SolverOptions = SolverOptions(),
) -> tuple[SolverState, SolveStats]:
    """Solve one unified QP/LP.  Returns (state, stats); ``state.x`` is the
    allocation *before* the exact feasibility repair done by the caller."""
    n = prob.n
    dtype = prob.lo.dtype
    dev = prob.lo.device
    m, k = tree.m, sla.k

    sc = scaling.make_scales(prob, tree, sla)
    if opts.precondition:
        steps = scaling.pc_step_sizes(prob, tree, sla, sc, opts.theta)
    else:
        steps = scaling.uniform_step_sizes(
            tree, sla, sc, n, opts.theta, opts.power_iters, dtype
        )

    # problem data in the scaled metric
    w_s = prob.w * sc.s * sc.s  # 1 for curved vars, 0 for linear
    target_s = prob.target / sc.s
    c_s = prob.c * sc.s
    ct_s = prob.c_t * sc.s_t
    lo_s = prob.lo / sc.s
    hi_s = prob.hi / sc.s
    tlo_s = prob.t_lo / sc.s_t
    thi_s = prob.t_hi / sc.s_t

    # fold pinned-variable contributions into the row bounds (their columns
    # are zeroed in the scaled operator; see scaling.make_scales)
    pin_x = torch.where(sc.mov > 0, 0.0, prob.lo)
    pin_t = torch.where(sc.t_mov > 0, 0.0, prob.t_lo)
    kpin_tree = tree_matvec(pin_x, tree)
    kpin_sla = sla_matvec(pin_x, sla)
    kpin_imp = pin_x - pin_t

    # scaled, pin-folded row bounds
    tree_hi_s = sc.d_tree * (prob.tree_hi - kpin_tree)
    sla_lo_s = sc.d_sla * (prob.sla_lo - kpin_sla)
    sla_hi_s = sc.d_sla * (prob.sla_hi - kpin_sla)
    imp_lo_s = torch.where(
        torch.isfinite(prob.imp_lo), sc.d_imp * (prob.imp_lo - kpin_imp), -_INF
    )
    neg_inf_tree = torch.full((m,), -_INF, dtype=dtype, device=dev)
    pos_inf_imp = torch.full((n,), _INF, dtype=dtype, device=dev)
    # the column scaling of the scaled operator and the t column's factor in
    # the adjoint, both constant through the solve
    sm = sc.s * sc.mov
    gt_scale = -sc.s_t * sc.t_mov

    # per-dual-block primal weights (PDLP multi-block style): the SLA rows
    # get their own omega, and tau_x comes from the omega-weighted per-block
    # column sums so the Pock-Chambolle bound holds for any pair of weights.
    use_blockwise = bool(opts.blockwise_omega and opts.precondition and k > 0)
    if use_blockwise:
        act_bw = torch.isfinite(prob.imp_lo).to(dtype)
        col_sla_bw = sm * sla_rmatvec(sc.d_sla, sla, n)
        col_rest_bw = sm * (tree_rmatvec(sc.d_tree, tree, n) + sc.d_imp * act_bw)
        theta_bw = torch.full((), opts.theta, dtype=dtype, device=dev)

    def run_chunk(x, t, y_tree, y_sla, y_imp, omega, om_sla):
        """``opts.check_every`` PDHG iterations, queued without a sync.  The
        step sizes depend only on the primal weights, which change only at
        checks, so they are formed once per chunk.  With the kernel flags
        the scaled adjoint is one launch (``use_pallas_tree``) and the whole
        dual step after the two matvecs another (``use_pallas``); on the
        CPU both run their plain compositions, the flag-off path's bits."""
        if use_blockwise:
            tau_x = theta_bw / torch.clamp_min(
                col_rest_bw / omega + col_sla_bw / om_sla, 1e-12
            )
            sig_sla = steps.sig_sla / om_sla
        else:
            tau_x = omega * steps.tau_x
            sig_sla = steps.sig_sla / omega
        tau_t = omega * steps.tau_t
        sig_tree = steps.sig_tree / omega
        sig_imp = steps.sig_imp / omega
        for _ in range(opts.check_every):
            if opts.use_pallas_tree:
                gx, yi = tk.scaled_rmatvec(
                    y_tree, y_sla, y_imp, sc.d_tree, sc.d_sla, sc.d_imp, sm, tree.index,
                    sla.index,
                )
                # summed by torch, in the flag-off path's order
                gt = gt_scale * torch.sum(yi)
            else:
                gx, gt = scaling.scaled_rmatvec(y_tree, y_sla, y_imp, tree, sla, sc, n)
            if opts.use_pallas:
                # fused primal prox + extrapolation, one pass over memory
                x1, xe = pk.primal_update(x, gx, c_s, w_s, target_s, lo_s, hi_s, tau_x)
            else:
                # primal prox (diagonal quadratic + box)
                x1 = torch.clamp(
                    (x - tau_x * (gx + c_s) + tau_x * w_s * target_s)
                    / (1.0 + tau_x * w_s),
                    lo_s,
                    hi_s,
                )
                xe = 2.0 * x1 - x
            t1 = torch.clamp(t - tau_t * (gt + ct_s), tlo_s, thi_s)
            # dual with extrapolation
            te = 2.0 * t1 - t
            if opts.use_pallas:
                # scaled_matvec's two matvecs of xm = s * mov * xe, then its
                # row scaling and the dual prox of all three row blocks in
                # one launch
                xm = sm * xe
                if opts.use_pallas_tree:
                    kx = tk.tree_matvec(xm, tree.index)
                else:
                    kx = tree_matvec(xm, tree)
                y_tree, y_sla, y_imp = pk.dual_update(
                    pk.DualBlock(y_tree, kx, sc.d_tree, sig_tree, neg_inf_tree, tree_hi_s),
                    pk.DualBlock(y_sla, sla_matvec(xm, sla), sc.d_sla, sig_sla, sla_lo_s,
                                 sla_hi_s),
                    pk.DualBlock(y_imp, xm, sc.d_imp, sig_imp, imp_lo_s, pos_inf_imp),
                    sc.s_t, sc.t_mov, te,
                )
            else:
                a_tree, a_sla, a_imp = scaling.scaled_matvec(
                    xe, te, tree, sla, sc, use_kernels=opts.use_pallas_tree
                )
                y_tree = _dual_prox(
                    y_tree + sig_tree * a_tree, sig_tree, neg_inf_tree, tree_hi_s
                )
                y_imp = _dual_prox(y_imp + sig_imp * a_imp, sig_imp, imp_lo_s, pos_inf_imp)
                if k:
                    y_sla = _dual_prox(y_sla + sig_sla * a_sla, sig_sla, sla_lo_s, sla_hi_s)
            x, t = x1, t1
        return x, t, y_tree, y_sla, y_imp

    def unscale(x, t, yt, ys, yi):
        # original metric: x = S x~ (pinned vars pinned by their box),
        # y_orig = D2 y~
        return SolverState(
            torch.where(sc.mov > 0, sc.s * x, prob.lo),
            torch.where(sc.t_mov > 0, sc.s_t * t, prob.t_lo),
            sc.d_tree * yt,
            sc.d_sla * ys,
            sc.d_imp * yi,
        )

    def kkt_score(x, t, yt, ys, yi):
        p, d, cm = termination.kkt_residuals(unscale(x, t, yt, ys, yi), prob, tree, sla)
        return p, d, cm, torch.maximum(torch.maximum(p, d), cm)

    eps_tot = opts.eps_abs + opts.eps_rel
    n_chunks = opts.max_iters // opts.check_every
    use_cert = opts.noprogress_tol > 0 and opts.noprogress_patience > 0
    if use_cert:
        maxmin_lp = (
            torch.any(torch.isfinite(prob.imp_lo)) & (prob.c_t < 0) & (sc.t_mov > 0)
        )
    buckets = torch.arange(KKT_HIST_BUCKETS, dtype=torch.int32, device=dev)

    # In the scaled metric curvature is 1 and variable travel is O(1), so
    # omega = 1 is the natural start for both QP and LP.
    omega = torch.full(
        (), opts.omega0 if opts.omega0 > 0 else 1.0, dtype=dtype, device=dev
    )
    om_sla = omega
    # scale the warm-start state into the solve metric
    x = init.x / sc.s
    t = init.t / sc.s_t
    yt = init.y_tree / torch.clamp_min(sc.d_tree, 1e-30)
    ys = init.y_sla / torch.clamp_min(sc.d_sla, 1e-30) if k else init.y_sla
    yi = init.y_imp / torch.clamp_min(sc.d_imp, 1e-30)
    # averaging since the last restart
    ax, at, ayt, ays, ayi = (torch.zeros_like(v) for v in (x, t, yt, ys, yi))
    acount = 0.0
    # restart anchors (primal-weight travel ratio) and the previous check's
    # iterate (no-progress detection)
    rx, ry_tree, ry_sla, ry_imp = x, yt, ys, yi
    px, pt = x, t
    inf = torch.full((), _INF, dtype=dtype, device=dev)
    pres = dres = cres = inf
    score_prev = inf  # candidate score at the previous check
    score_restart = inf  # score right after the last restart
    stall = torch.zeros((), dtype=torch.int32, device=dev)
    frozen = torch.zeros((), dtype=torch.int32, device=dev)
    score_hist = torch.zeros(KKT_HIST_BUCKETS, dtype=torch.int32, device=dev)
    chunk = chunks_since = restarts = 0
    done = certified = False

    while not done and chunk < n_chunks:
        x, t, yt, ys, yi = run_chunk(x, t, yt, ys, yi, omega, om_sla)
        cnt = acount + 1.0
        if opts.use_pallas_stats:
            # fused chunk-boundary bookkeeping: average accumulation, move
            # norms and restart-candidate travel in one pass per block; the
            # results stay on the device
            ax, move_num, move_den, dx2_cur, dx2_avg = pk.primal_chunk_stats(
                x, px, rx, ax, cnt
            )
            ayt, dyt2_cur, dyt2_avg, dyt2_zero = pk.dual_chunk_stats(yt, ry_tree, ayt, cnt)
            ayi, dyi2_cur, dyi2_avg, dyi2_zero = pk.dual_chunk_stats(yi, ry_imp, ayi, cnt)
            at, ays = at + t, ays + ys
        else:
            ax, at, ayt, ays, ayi = ax + x, at + t, ayt + yt, ays + ys, ayi + yi

        # KKT of three restart candidates: the current iterate, the running
        # average, and the current primal with ZERO duals (the escape hatch
        # when a re-pin invalidates carried duals).
        p, d, cm, score = kkt_score(x, t, yt, ys, yi)
        xa, ta = ax / cnt, at / cnt
        yta, ysa, yia = ayt / cnt, ays / cnt, ayi / cnt
        pa, da, ca, score_a = kkt_score(xa, ta, yta, ysa, yia)
        zt, zs, zi = torch.zeros_like(yt), torch.zeros_like(ys), torch.zeros_like(yi)
        pz, dz, cz, score_z = kkt_score(x, t, zt, zs, zi)
        use_avg = (score_a < score) & (score_a <= score_z)
        use_zero = (score_z < score) & (score_z < score_a)

        def pick(cur, avg, zero):
            return torch.where(use_zero, zero, torch.where(use_avg, avg, cur))

        xn = pick(x, xa, x)
        tn = pick(t, ta, t)
        ytn = pick(yt, yta, zt)
        ysn = pick(ys, ysa, zs) if k else ys
        yin = pick(yi, yia, zi)
        score_cand = torch.minimum(torch.minimum(score, score_a), score_z)
        # log10 bucket of this check's best score
        score_b = torch.clamp(
            torch.floor(torch.log10(torch.clamp_min(score_cand, 10.0**KKT_HIST_LO_EXP))).to(
                torch.int32
            )
            - KKT_HIST_LO_EXP,
            0,
            KKT_HIST_BUCKETS - 1,
        )
        score_hist = score_hist + (buckets == score_b).to(torch.int32)
        pn = pick(p, pa, pz)
        dn = pick(d, da, dz)
        cn = pick(cm, ca, cz)
        done_kkt = (pn < eps_tot) & (dn < eps_tot) & (cn < eps_tot)

        # no-progress / optimal-vertex certificate (termination module):
        # only the max-min LP structure earns it; QP solves never exit so.
        if use_cert:
            if opts.use_pallas_stats:
                move_x = move_num / (1.0 + move_den)
            else:
                move_x = torch.max(torch.abs(x - px)) / (1.0 + torch.max(torch.abs(x)))
            move = torch.maximum(move_x, torch.abs(t - pt) / (1.0 + torch.abs(t)))
            frozen = torch.where(move < opts.noprogress_tol, frozen + 1, 0)
            st_cur = unscale(x, t, yt, ys, yi)
            t_pol = (
                termination.polish_t(st_cur.x, st_cur.t, prob)
                if opts.polish_t
                else st_cur.t
            )
            pres_pol = termination.primal_residual(st_cur.x, t_pol, prob, tree, sla)
            done_vertex = (
                maxmin_lp
                & (frozen >= opts.noprogress_patience)
                & (pres_pol < eps_tot)
                & (~done_kkt)
            )
            # adopt the raw iterate (with the polished t) on a vertex exit
            t_pol_s = torch.where(sc.t_mov > 0, t_pol / sc.s_t, t)
            xn = torch.where(done_vertex, x, xn)
            tn = torch.where(done_vertex, t_pol_s, tn)
            ytn = torch.where(done_vertex, yt, ytn)
            ysn = torch.where(done_vertex, ys, ysn) if k else ys
            yin = torch.where(done_vertex, yi, yin)
            pn = torch.where(done_vertex, pres_pol, pn)
            dn = torch.where(done_vertex, d, dn)
            cn = torch.where(done_vertex, cm, cn)
            done_t = done_kkt | done_vertex
        else:
            done_t = done_kkt

        chunk += 1
        chunks_since += 1
        do_restart, stall, stalled = restarts_mod.restart_decision(
            score_cand,
            score_prev,
            score_restart,
            chunks_since,
            stall,
            beta_suff=opts.restart_beta_suff,
            beta_nec=opts.restart_beta_nec,
            stall_checks=opts.stall_checks,
            restart_every=opts.restart_every,
            adaptive=opts.adaptive_restarts,
        )
        do_restart = do_restart & (~done_t)
        # the check's one transfer to the host
        done, restart, certified = torch.stack([done_t, do_restart, done_kkt]).tolist()

        if restart:
            # primal-weight re-estimate: travel ratio since the anchor, or
            # residual balance when the stall detector fired
            if opts.use_pallas_stats:
                # the fused travel partials of the adopted candidate (a
                # vertex exit is `done`, which suppresses the restart)
                dx = torch.sqrt(pick(dx2_cur, dx2_avg, dx2_cur))
                dy = torch.sqrt(
                    pick(dyt2_cur, dyt2_avg, dyt2_zero) + pick(dyi2_cur, dyi2_avg, dyi2_zero)
                )
            else:
                dx = torch.sqrt(torch.sum((xn - rx) ** 2))
                dy = torch.sqrt(
                    torch.sum((ytn - ry_tree) ** 2) + torch.sum((yin - ry_imp) ** 2)
                )
            if use_blockwise:
                dy_sla = torch.sqrt(torch.sum((ysn - ry_sla) ** 2))
                omega, om_sla = restarts_mod.update_omega_blocks(
                    omega, om_sla, dx, dy, dy_sla, pn, dn, cn, stalled
                )
            else:
                omega = restarts_mod.update_omega(omega, dx, dy, pn, dn, cn, stalled)

        px, pt = x, t
        # on restart (or exit) adopt the candidate; otherwise keep iterating
        # from the raw iterate
        if restart or done:
            x, t, yt, yi = xn, tn, ytn, yin
            if k:
                ys = ysn
        if restart:
            ax, at, ayt, ays, ayi = (torch.zeros_like(v) for v in (ax, at, ayt, ays, ayi))
            acount = 0.0
            rx, ry_tree, ry_sla, ry_imp = x, yt, ys, yi
            chunks_since = 0
            restarts += 1
            score_restart = score_cand
        else:
            acount = cnt
            # the first check anchors the restart score without restarting
            score_restart = torch.where(
                torch.isfinite(score_restart), score_restart, score_cand
            )
        pres, dres, cres = pn, dn, cn
        score_prev = score_cand

    # return state in original units
    state = unscale(x, t, yt, ys, yi)
    if opts.polish_t:
        # hand back the exact epigraph t for the returned x on every max-min
        # exit (polish_t is the identity for QPs)
        state = state._replace(t=termination.polish_t(state.x, state.t, prob))
    stats = SolveStats(
        iterations=chunk * opts.check_every,
        primal_res=pres,
        dual_res=dres,
        comp_res=cres,
        converged=bool(done),
        omega=omega,
        certified=bool(certified),
        restarts=restarts,
        score_hist=score_hist,
    )
    return state, stats
