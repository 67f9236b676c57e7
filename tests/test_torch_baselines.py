"""The port's baselines and cross-validation tools on the CPU, against the
JAX reference: ``core/greedy`` (Greedy proportional, Algorithms 4-5, and
Static), ``pdn/hierarchy_gen`` (random, homogeneous and the Appendix A
hierarchies), the Appendix A counter-example on the port's ``optimize``, and
``core/refsolve`` (scipy's HiGHS and trust-constr), with the port's Phase I
QP and max-min LP held to it as ``tests/test_pdhg_oracle.py`` holds the
reference's.

Bars: the numpy baselines and generators give the reference's arrays
exactly; ``ref_solve`` the reference's to 1e-9; the rest the reference
tests' own bars.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compat import enable_x64  # noqa: E402
from repro.core import greedy as j_greedy  # noqa: E402
from repro.core import phases as j_phases  # noqa: E402
from repro.core import refsolve as j_refsolve  # noqa: E402
from repro.core.nvpax import optimize as j_optimize  # noqa: E402
from repro.core.problem import AllocProblem as JAllocProblem  # noqa: E402
from repro.pdn import hierarchy_gen as j_gen  # noqa: E402
from repro.pdn.tenants import assign_tenants as j_assign_tenants  # noqa: E402
from repro_torch.core import phases, solver  # noqa: E402
from repro_torch.core.greedy import greedy_allocate, static_allocate  # noqa: E402
from repro_torch.core.metrics import satisfaction_ratio  # noqa: E402
from repro_torch.core.nvpax import optimize  # noqa: E402
from repro_torch.core.problem import AllocProblem  # noqa: E402
from repro_torch.core.refsolve import dense_constraints, ref_solve  # noqa: E402
from repro_torch.pdn import hierarchy_gen  # noqa: E402
from repro_torch.pdn.tenants import assign_tenants  # noqa: E402


def _same_pdn(a, b):
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name), err_msg=f.name)


def _feasible(pdn, a, tol=1e-6):
    csum = np.concatenate([[0.0], np.cumsum(a)])
    sums = csum[pdn.node_end] - csum[pdn.node_start]
    return (
        (a >= pdn.dev_l - tol).all()
        and (a <= pdn.dev_u + tol).all()
        and (sums <= pdn.node_cap + tol).all()
    )


# -- hierarchy generators ----------------------------------------------------


@pytest.mark.parametrize(
    "make",
    [
        lambda g: g.random_hierarchy(50, seed=3, depth=3),
        lambda g: g.random_hierarchy(400, seed=11),
        lambda g: g.random_hierarchy(60, seed=5, depth=2, oversub_range=(0.5, 0.6)),
        lambda g: g.homogeneous_fleet(),
        lambda g: g.homogeneous_fleet(3, racks_per_domain=3, root_oversub=0.8),
        lambda g: g.nonuniform_example(),
    ],
    ids=["random-50", "random-400", "random-oversub", "homogeneous", "homogeneous-3",
         "appendix-a"],
)
def test_generators_match_reference(make):
    _same_pdn(make(hierarchy_gen), make(j_gen))
    np.testing.assert_array_equal(hierarchy_gen.NONUNIFORM_REQUESTS, j_gen.NONUNIFORM_REQUESTS)


# -- Greedy and Static ----------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_greedy_and_static_match_reference(seed):
    pdn = hierarchy_gen.random_hierarchy(50 + 37 * seed, seed=seed % 7, depth=3)
    jpdn = j_gen.random_hierarchy(50 + 37 * seed, seed=seed % 7, depth=3)
    req = np.random.default_rng(seed).uniform(0, 900, pdn.n)
    a = greedy_allocate(pdn, req)
    np.testing.assert_array_equal(a, j_greedy.greedy_allocate(jpdn, req))
    assert _feasible(pdn, a)
    np.testing.assert_array_equal(static_allocate(pdn), j_greedy.static_allocate(jpdn))
    np.testing.assert_array_equal(static_allocate(pdn, req), static_allocate(pdn))


def test_greedy_satisfies_everyone_with_ample_capacity():
    from repro_torch.pdn.tree import build_from_level_sizes

    pdn = build_from_level_sizes([2, 2], gpus_per_server=4, oversubscription=1.0)
    np.testing.assert_allclose(greedy_allocate(pdn, np.full(pdn.n, 400.0)), 400.0, atol=1e-9)


# -- Appendix A: the non-uniform hierarchy where Greedy fails --------------


def test_appendix_a_on_the_port():
    """Figure 4: nvPAX 83.26% against Greedy ~73.94% satisfaction, nvPAX
    redirecting budget from the bottlenecked S_A1 subtree to racks B/C —
    on the port's optimize, within 1e-6 W of the reference's."""
    pdn = hierarchy_gen.nonuniform_example()
    req = hierarchy_gen.NONUNIFORM_REQUESTS
    r = np.clip(req, pdn.dev_l, pdn.dev_u)
    active = np.ones(pdn.n, bool)
    res = optimize(AllocProblem.build(pdn, req, active=active, device="cpu"))
    with enable_x64(True):
        jres = j_optimize(JAllocProblem.build(j_gen.nonuniform_example(), req, active=active))
    np.testing.assert_allclose(res.allocation, jres.allocation, rtol=0, atol=1e-6)
    assert res.stats["phase_iterations"] == jres.stats["phase_iterations"]
    assert res.stats["converged"]

    a_greedy = greedy_allocate(pdn, req)
    s_greedy = 100 * satisfaction_ratio(r, a_greedy)
    s_nvpax = 100 * satisfaction_ratio(r, res.allocation)
    assert abs(s_nvpax - 83.26) < 0.1, s_nvpax
    assert s_greedy < 75.0, s_greedy
    assert s_nvpax - s_greedy > 8.5

    a = res.allocation
    assert abs(a[:6].sum() - 2500.0) < 1.0  # S_A1 capped by its 2.5 kW server
    np.testing.assert_allclose(np.minimum(a[9:], 350.0), 350.0, atol=1.0)
    assert a_greedy[9:].sum() < a[9:].sum() - 500.0


# -- refsolve and the PDHG oracle cases -----------------------------------


def _build(seed, n=40, with_sla=True):
    """The port's and the reference's problem on the same data."""
    pdn = hierarchy_gen.random_hierarchy(n, seed=seed, depth=3)
    jpdn = j_gen.random_hierarchy(n, seed=seed, depth=3)
    req = np.random.default_rng(seed).uniform(50, 800, pdn.n)
    kw = dict(n_tenants=2, devices_per_tenant=min(8, n // 4), seed=seed)
    sla = jsla = prio = None
    if with_sla:
        lay, jlay = assign_tenants(pdn, **kw), j_assign_tenants(jpdn, **kw)
        sla, jsla, prio = lay.sla_topo(device="cpu"), jlay.sla_topo(), lay.priority
    ap = AllocProblem.build(pdn, req, sla=sla, priority=prio, device="cpu")
    with enable_x64(True):
        jap = JAllocProblem.build(jpdn, req, sla=jsla, priority=prio)
    return ap, jap


def _qp_objective(prob, x):
    w = np.asarray(prob.w)
    t = np.asarray(prob.target)
    return 0.5 * np.sum(w * (x - t) ** 2) + np.asarray(prob.c) @ x


def _qp(ap, with_sla, mod):
    p = int(np.asarray(ap.priority).max())
    mask_a = ap.active & (ap.priority == p)
    zeros = torch.zeros(ap.n, dtype=torch.bool) if mod is phases else np.zeros(ap.n, bool)
    return mod.qp_step(ap, ap.l, mask_a, zeros, 1e-5, pin_free=not with_sla), mask_a


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("with_sla", [False, True])
def test_ref_solve_matches_reference(seed, with_sla):
    """The dense constraints and the scipy solutions of both packages on the
    same Phase I QP and Phase II LP."""
    ap, jap = _build(seed, with_sla=with_sla)
    prob, _ = _qp(ap, with_sla, phases)
    with enable_x64(True):
        jprob, _ = _qp(jap, with_sla, j_phases)
        want = [np.asarray(v) for v in j_refsolve.dense_constraints(jap.tree, jap.sla, jap.n)]
        want_qp = j_refsolve.ref_solve(jprob, jap.tree, jap.sla)
        j_lp = j_phases.lp_step(jap, jap.u * 0.5, jap.active, ~(jap.active | jap.idle),
                                jap.idle, 1e-5)
        want_lp = j_refsolve.ref_solve(j_lp, jap.tree, jap.sla)
    for got, exp in zip(dense_constraints(ap.tree, ap.sla, ap.n), want):
        np.testing.assert_array_equal(got, exp)
    np.testing.assert_allclose(ref_solve(prob, ap.tree, ap.sla), want_qp, rtol=0, atol=1e-9)
    lp = phases.lp_step(ap, ap.u * 0.5, ap.active, ~(ap.active | ap.idle), ap.idle, 1e-5)
    np.testing.assert_allclose(ref_solve(lp, ap.tree, ap.sla), want_lp, rtol=0, atol=1e-9)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_sla", [False, True])
def test_phase1_qp_objective_matches_oracle(seed, with_sla):
    """The port's PDHG on a Phase I QP is no worse than scipy's optimum and
    agrees on the strictly convex request-tracking block."""
    ap, _ = _build(seed, with_sla=with_sla)
    prob, mask_a = _qp(ap, with_sla, phases)
    st = solver.SolverState.zeros(ap.n, ap.tree.m, ap.sla.k, torch.float64, "cpu")
    st, stats = solver.solve(prob, ap.tree, ap.sla, st)
    assert stats.converged
    zref = ref_solve(prob, ap.tree, ap.sla)
    x = st.x.numpy()
    obj_pdhg = _qp_objective(prob, x)
    obj_ref = _qp_objective(prob, zref[: ap.n])
    assert obj_pdhg <= obj_ref + 1e-4 * (1.0 + abs(obj_ref))
    a_block = mask_a.numpy()
    np.testing.assert_allclose(x[a_block], zref[: ap.n][a_block], atol=0.5)


@pytest.mark.parametrize("seed", [0, 1])
def test_maxmin_lp_matches_highs(seed):
    """The Phase II LP optimum t* (unique) matches HiGHS."""
    ap, _ = _build(seed, with_sla=True)
    x1, state, _ = phases.phase1(ap, solver.SolverOptions())
    mask_a = ap.active & ~phases.saturated_mask(x1, ap, ap.active)
    assert bool(mask_a.any())
    prob = phases.lp_step(ap, x1, mask_a, ~(mask_a | ap.idle), ap.idle, 1e-5)
    st = solver.SolverState(x1, torch.zeros((), dtype=torch.float64), state.y_tree,
                            state.y_sla, state.y_imp)
    st, stats = solver.solve(prob, ap.tree, ap.sla, st)
    assert stats.converged
    t_ref = ref_solve(prob, ap.tree, ap.sla)[-1]
    assert abs(float(st.t) - t_ref) < 0.05 * (1.0 + abs(t_ref))
