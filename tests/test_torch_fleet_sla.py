"""Tenants across the fleet's domain cut in the port (``repro_torch.fleet``)
on the CPU, against the JAX reference's ``repro.fleet``.

The cases mirror ``tests/test_fleet_sla.py``: the tenant classification
array for array, the entitlement split and ``plan_sla`` against the
reference's, the orchestrator's stacked and loop modes against the
reference's, the fleet against the monolithic tenant engine, minimums
through a brownout, churn, runtime contract changes and rebuilds (with
zero rebuilds of the built tensors where the reference counts zero
retraces), per-lane tenant topology after a rebuild, and the simulator's
cross-tenant scenario.

Bars: the split and the plan within ``ATOL`` (1e-9 W); allocations within
1e-9 W of the reference's.  The tenant LPs are eps-degenerate: on these
fleets the reference's own Phase II count moves by hundreds of iterations
when the telemetry moves one ulp (2,550 -> 3,000 on the first step of
``test_fleet_sla_matches_reference``'s 2-domain fleet at 600-690 W), so
iterations are held equal on cold steps only.  On telemetry of 150-300 W
the same fleet's warm step parts from the reference by 1.29e-9 W on the
binding tenant row (ROADMAP Queue 3), past the 1e-9 W bar these cases hold.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.nvpax import NvpaxOptions as JNvpaxOptions  # noqa: E402
from repro.core.pdhg import SolverOptions as JSolverOptions  # noqa: E402
from repro.core.waterfill import waterfill_arrays as j_waterfill_arrays  # noqa: E402
from repro.fleet import BudgetCoordinator as JBudgetCoordinator  # noqa: E402
from repro.fleet import FleetOrchestrator as JFleetOrchestrator  # noqa: E402
from repro.fleet import split_entitlements as j_split_entitlements  # noqa: E402
from repro.fleet import split_pdn as j_split_pdn  # noqa: E402
from repro.pdn.hierarchy_gen import homogeneous_fleet as j_homogeneous_fleet  # noqa: E402
from repro.pdn.tenants import TenantLayout as JTenantLayout  # noqa: E402
from repro.pdn.tenants import (  # noqa: E402
    assign_cross_domain_tenants as j_assign_cross_domain_tenants,
)
from repro.power.simulator import DatacenterSim as JDatacenterSim  # noqa: E402
from repro_torch.core.engine import AllocEngine  # noqa: E402
from repro_torch.core.nvpax import NvpaxOptions  # noqa: E402
from repro_torch.core.solver import SolverOptions  # noqa: E402
from repro_torch.fleet import (  # noqa: E402
    BudgetCoordinator,
    FleetLifecycle,
    FleetOrchestrator,
    split_entitlements,
    split_pdn,
)
from repro_torch.pdn.hierarchy_gen import homogeneous_fleet  # noqa: E402
from repro_torch.pdn.tenants import TenantLayout, assign_cross_domain_tenants  # noqa: E402
from repro_torch.power import DatacenterSim  # noqa: E402

from test_torch_fleet import _planned, _small_domain, one_domain_solve  # noqa: E402

ATOL = 1e-9
MONO_TOL = 1e-6
SLA_TOL = 1e-4  # watts: tenant sums inside [b_min, b_max] (the reference's bar)
# the reference's SLA parity options: the tenant programs certified at
# tight tolerance, so that binding rows land on the vertex
SOLVER = dict(eps_abs=1e-11, eps_rel=1e-11, max_iters=20_000)
OPTS = NvpaxOptions(solver=SolverOptions(**SOLVER))
J_OPTS = JNvpaxOptions(solver=JSolverOptions(**SOLVER))


def _layout(pdn, cls, lo_frac=0.35, hi_frac=0.55):
    """One cross-cut tenant over domains 0/1 + one domain-local tenant."""
    tenant_of = np.full(pdn.n, -1, np.int32)
    tenant_of[[0, 1, 16, 17]] = 0
    tenant_of[[4, 5, 6]] = 1
    b_min, b_max = np.zeros(2), np.zeros(2)
    for t in range(2):
        umax = pdn.dev_u[tenant_of == t].sum()
        b_min[t], b_max[t] = lo_frac * umax, hi_frac * umax
    return cls(tenant_of, 2, b_min, b_max, np.ones(pdn.n, np.int32))


@pytest.fixture(scope="module")
def slack_pdn():
    """(reference, port): 2 domains x 16 devices, node caps above the
    subtree maxima (the exact-parity regime for tenant fleets)."""
    kw = dict(domain_oversub=1.15, root_oversub=1.0)
    return j_homogeneous_fleet(2, **kw), homogeneous_fleet(2, **kw)


@pytest.fixture(scope="module")
def cross_fleet():
    """(reference, port) of ``homogeneous_fleet(4)`` with generated tenants
    spanning the cut, and their layouts."""
    jpdn, pdn = j_homogeneous_fleet(4), homogeneous_fleet(4)
    return (jpdn, pdn, j_assign_cross_domain_tenants(jpdn, 1, seed=3),
            assign_cross_domain_tenants(pdn, 1, seed=3))


def _tenant_sums(lay, x):
    return np.array([x[lay.tenant_of == t].sum() for t in range(lay.n_tenants)])


def _assert_contracts(lay, x):
    s = _tenant_sums(lay, x)
    assert (s >= lay.b_min - SLA_TOL).all() and (s <= lay.b_max + SLA_TOL).all()


# ---------------------------------------------------------------------------
# classification, the entitlement split and the plan
# ---------------------------------------------------------------------------

_SLA_ARRAYS = ("b_min", "b_max", "cross", "slice_tenant", "slice_domain", "slice_row",
               "ten_start", "ten_end", "cross_ids")


def _assert_fleet_sla_equal(jsla, sla):
    assert sla.n_tenants == jsla.n_tenants and sla.k == jsla.k
    for a in _SLA_ARRAYS:
        np.testing.assert_array_equal(getattr(sla, a), getattr(jsla, a), err_msg=a)
    for k in range(sla.k):
        np.testing.assert_array_equal(sla.rows[k], jsla.rows[k])
        np.testing.assert_array_equal(sla.row_slice[k], jsla.row_slice[k])
        for a, b in zip(sla.row_dev[k], jsla.row_dev[k]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(sla.edges(k), jsla.edges(k)):
            np.testing.assert_array_equal(a, b)


def test_build_fleet_sla_matches_reference(slack_pdn, cross_fleet):
    jpdn, pdn = slack_pdn
    jsla = j_split_pdn(jpdn, 1, tenants=_layout(jpdn, JTenantLayout)).sla
    sla = split_pdn(pdn, 1, tenants=_layout(pdn, TenantLayout)).sla
    _assert_fleet_sla_equal(jsla, sla)
    assert sla.cross.tolist() == [True, False] and sla.n_slices == 2
    jpdn4, pdn4, jlay, lay = cross_fleet
    _assert_fleet_sla_equal(j_split_pdn(jpdn4, 1, tenants=jlay).sla,
                            split_pdn(pdn4, 1, tenants=lay).sla)


def _numpy_split(sla, floor, umax, demand):
    """The split through the numpy sweep (the reference's host water-fill):
    the other choice of sweep, measured beside the one the port takes."""
    s, e = sla.ten_start, sla.ten_end
    ones = np.ones(floor.shape[0], bool)
    lo = j_waterfill_arrays(s, e, sla.b_min[sla.cross_ids], umax, floor, ones)
    hi = j_waterfill_arrays(s, e, sla.b_max[sla.cross_ids], np.clip(demand, lo, umax), lo, ones)
    return lo, j_waterfill_arrays(s, e, sla.b_max[sla.cross_ids], umax, hi, ones)


def test_split_entitlements_matches_reference(cross_fleet):
    """The split against the reference's (its jitted water-fill) on random
    slice aggregates; the numpy sweep's gap is measured too (the choice of
    sweep is recorded in ROADMAP Queue 3)."""
    jpdn, pdn, jlay, lay = cross_fleet
    jsla = j_split_pdn(jpdn, 1, tenants=jlay).sla
    sla = split_pdn(pdn, 1, tenants=lay).sla
    assert sla.n_slices >= 4
    rng = np.random.default_rng(0)
    gaps = []
    for _ in range(6):
        floor = rng.uniform(0.0, 800.0, sla.n_slices)
        umax = floor + rng.uniform(500.0, 3000.0, sla.n_slices)
        demand = rng.uniform(0.0, 4000.0, sla.n_slices)
        jlo, jhi = j_split_entitlements(jsla, floor, umax, demand)
        lo, hi = split_entitlements(sla, floor, umax, demand)
        np.testing.assert_allclose(lo, jlo, rtol=0, atol=ATOL)
        np.testing.assert_allclose(hi, jhi, rtol=0, atol=ATOL)
        nlo, nhi = _numpy_split(sla, floor, umax, demand)
        gaps.append(max(np.abs(nlo - jlo).max(), np.abs(nhi - jhi).max()))
        assert (lo >= floor - 1e-9).all() and (hi <= umax + 1e-9).all()
        assert (lo <= hi + 1e-9).all()
    assert max(gaps) <= 1e-6  # the numpy sweep's distance from the reference's


def test_plan_sla_matches_reference(slack_pdn):
    jpdn, pdn = slack_pdn
    jpart = j_split_pdn(jpdn, 1, tenants=_layout(jpdn, JTenantLayout, 0.6, 0.8))
    part = split_pdn(pdn, 1, tenants=_layout(pdn, TenantLayout, 0.6, 0.8))
    floor, umax = np.array([400.0, 400.0]), np.array([1400.0, 1400.0])
    kw = dict(slice_floor=floor, slice_umax=umax, slice_demand=np.array([1300.0, 500.0]),
              local_lift=np.array([1200.0, 0.0]))
    for demand in (np.full(2, 1000.0), np.array([20000.0, 3000.0])):
        got = BudgetCoordinator(part).plan_sla(demand, sla=part.sla, **kw)
        want = JBudgetCoordinator(jpart).plan_sla(demand, sla=jpart.sla, **kw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="deliverable maximum"):
        BudgetCoordinator(part).plan_sla(
            np.full(2, 1000.0), sla=part.sla, slice_floor=floor,
            slice_umax=np.array([700.0, 700.0]), slice_demand=floor)


# ---------------------------------------------------------------------------
# the orchestrator against the reference's and the monolithic engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["stacked", "loop", "sharded"])
def test_fleet_sla_matches_reference(slack_pdn, mode):
    """A cold and a warm step: the cold step with equal iterations per
    domain and phase, both within 1e-9 W, contracts kept."""
    jpdn, pdn = slack_pdn
    jlay, lay = _layout(jpdn, JTenantLayout), _layout(pdn, TenantLayout)
    jorch = JFleetOrchestrator(jpdn, level=1, tenants=jlay, mode=mode, options=J_OPTS)
    orch = FleetOrchestrator(pdn, level=1, tenants=lay, mode=mode, options=OPTS, device="cpu")
    rng = np.random.default_rng(0)
    for t in range(2):
        tele = rng.uniform(250, 400, pdn.n)
        res, jres = orch.step(tele), jorch.step(tele)
        np.testing.assert_allclose(res.allocation, jres.allocation, rtol=0, atol=ATOL)
        np.testing.assert_allclose(res.grants, jres.grants, rtol=0, atol=ATOL)
        np.testing.assert_allclose(res.stats["slice_lo"], jres.stats["slice_lo"], rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(res.stats["slice_hi"], jres.stats["slice_hi"], rtol=0,
                                   atol=ATOL)
        if t == 0:
            np.testing.assert_array_equal(res.stats["phase_iterations"],
                                          np.asarray(jres.stats["phase_iterations"]))
        _assert_contracts(lay, res.allocation)
        assert res.stats["converged"].all()


def test_fleet_sla_matches_monolithic(slack_pdn):
    """The reference's acceptance with tenants across the cut: subtree
    grants, the fleet against the monolithic tenant engine to 1e-6 W in
    total and per tenant."""
    _, pdn = slack_pdn
    lay = _layout(pdn, TenantLayout)
    mono = AllocEngine(pdn, sla=lay.sla_topo(device="cpu"), priority=lay.priority,
                       options=OPTS, device="cpu")
    orch = FleetOrchestrator(pdn, level=1, coordinator_mode="subtree", tenants=lay,
                             mode="stacked", options=OPTS, device="cpu")
    tele = np.random.default_rng(1).uniform(250, 400, pdn.n)
    rm, rf = mono.step(tele), orch.step(tele)
    assert abs(rm.allocation.sum() - rf.allocation.sum()) <= MONO_TOL
    np.testing.assert_allclose(_tenant_sums(lay, rf.allocation), _tenant_sums(lay, rm.allocation),
                               rtol=0, atol=MONO_TOL)
    _assert_contracts(lay, rf.allocation)


def test_brownout_honors_tenant_minimums():
    """A cross-cut tenant's minimum kept while domain 0's feed is halved."""
    pdn = homogeneous_fleet(2, domain_oversub=0.85, root_oversub=1.0)
    t_of = np.full(pdn.n, -1, np.int32)
    t_of[[0, 1, 16, 17]] = 0
    umax = pdn.dev_u[t_of == 0].sum()
    lay = TenantLayout(t_of, 1, np.array([0.7 * umax]), np.array([0.9 * umax]),
                       np.ones(pdn.n, np.int32))
    orch = FleetOrchestrator(pdn, level=1, tenants=lay, options=OPTS, device="cpu")
    orch.set_domain_supply(0, 0.5)
    res = orch.step(np.random.default_rng(2).uniform(600, 690, pdn.n))
    assert res.allocation[t_of == 0].sum() >= 0.7 * umax - SLA_TOL
    assert res.grants[0] <= 0.5 * orch.partition.domains[0].cap + 1e-6
    assert orch.rebuild_count() == 1


# ---------------------------------------------------------------------------
# churn, contract changes and rebuilds
# ---------------------------------------------------------------------------


def test_sla_churn_and_grants_zero_rebuild(slack_pdn):
    """Leave and rejoin on a cross-cut tenant and a runtime contract change
    swap values only: the built tensors are never rebuilt, minimums kept."""
    _, pdn = slack_pdn
    lay = _layout(pdn, TenantLayout, lo_frac=0.4)
    orch = FleetOrchestrator(pdn, level=1, tenants=lay, mode="stacked", options=OPTS,
                             device="cpu")
    life = FleetLifecycle(orch)
    t_of = lay.tenant_of
    tele = np.random.default_rng(8).uniform(250, 400, pdn.n)
    life.device_leave([1, 17])
    res = orch.step(tele)
    np.testing.assert_allclose(res.allocation[[1, 17]], 0.0)
    assert res.allocation[t_of == 0].sum() >= lay.b_min[0] - SLA_TOL
    life.device_join([1, 17])
    orch.set_tenant_bounds(0, b_min=0.5 * 2800.0, b_max=0.52 * 2800.0)
    res = orch.step(tele)
    assert 0.5 * 2800.0 - SLA_TOL <= res.allocation[t_of == 0].sum() <= 0.52 * 2800.0 + SLA_TOL
    assert orch.rebuild_count() == 1
    assert life.n_left == 0


def test_sla_mutations_validate_before_commit(slack_pdn):
    """A leave that kills a cross-cut minimum, an undeliverable contract and
    a rebuild that orphans a contracted tenant all raise with nothing
    committed; a rebuild within the padding then moves membership."""
    _, pdn = slack_pdn
    lay = _layout(pdn, TenantLayout, lo_frac=0.8, hi_frac=0.9)
    orch = FleetOrchestrator(pdn, level=1, tenants=lay, mode="stacked", options=OPTS,
                             device="cpu")
    life = FleetLifecycle(orch)
    with pytest.raises(ValueError, match="deliverable maximum"):
        life.device_leave([0, 1])
    assert life.n_left == 0
    with pytest.raises(ValueError, match="deliverable maximum"):
        orch.set_tenant_bounds(0, b_min=3000.0, b_max=3500.0)
    with pytest.raises(ValueError, match="b_min <= b_max"):
        orch.set_tenant_bounds(0, b_min=2000.0, b_max=1000.0)
    assert orch._sla.b_min[0] == lay.b_min[0]
    d0, d1 = orch.partition.domains
    with pytest.raises(ValueError, match="no devices"):
        orch.rebuild_domain(0, d0.pdn)  # orphans tenant 1
    assert orch._sla.rows[0].tolist() == [0, 1] and orch.rebuild_count() == 1
    orch.set_tenant_bounds(0, b_min=0.35 * 2800.0)
    orch.rebuild_domain(1, d1.pdn)  # tenant 0 becomes domain-local
    assert not orch._sla.cross.any() and orch.rebuild_count() == 2
    t_of1 = np.full(d1.pdn.n, -1, np.int32)
    t_of1[[0, 1]] = 0
    orch.rebuild_domain(1, d1.pdn, tenant_of=t_of1)
    assert orch._sla.cross.tolist() == [True, False] and orch.rebuild_count() == 3
    res = orch.step(np.full(orch.n, 350.0))
    assert res.allocation[lay.tenant_of == 0].sum() >= 0.35 * 2800.0 - SLA_TOL


def test_stacked_tenant_lanes_are_one_domain_solves_after_rebuild():
    """Per-lane tenant topology: three tenants over four domains, domain 1
    rebuilt to 8 devices keeping its slice of the cross-cut tenant; every
    lane the bits of the one-domain solve of its padded problem."""
    pdn = homogeneous_fleet(4, root_oversub=0.8)
    t_of = np.full(pdn.n, -1, np.int32)
    t_of[[0, 1, 16, 17]] = 0
    t_of[[4, 5, 6]] = 1
    t_of[[40, 41, 50]] = 2
    umax = np.array([pdn.dev_u[t_of == t].sum() for t in range(3)])
    lay = TenantLayout(t_of, 3, 0.35 * umax, 0.55 * umax, np.ones(pdn.n, np.int32))
    orch = FleetOrchestrator(pdn, level=1, tenants=lay, mode="stacked",
                             options=NvpaxOptions(solver=SolverOptions(
                                 max_iters=20_000, use_pallas=True, use_pallas_tree=True,
                                 use_pallas_stats=True)), device="cpu")
    idx = orch._dom.sla.index
    dev_before = idx.dev_ptr.clone()
    t_of1 = np.full(8, -1, np.int32)
    t_of1[:2] = 0
    orch.rebuild_domain(1, _small_domain(orch.partition.domains[1].cap), tenant_of=t_of1)
    for k in (0, 2, 3):
        assert torch.equal(idx.dev_ptr[k], dev_before[k])
    tele = np.random.default_rng(10).uniform(100, 650, orch.n)
    active = tele >= orch.idle_threshold
    grants, row_bounds = _planned(orch, tele, active)
    res = orch.step(tele)
    offs = orch._offsets()
    for k in range(orch.k):
        want = one_domain_solve(orch, k, tele, active, grants, row_bounds)
        assert np.array_equal(res.allocation[offs[k] : offs[k + 1]], want), k


# ---------------------------------------------------------------------------
# the simulator's cross-tenant scenario
# ---------------------------------------------------------------------------


def test_cross_tenant_simulation_matches_reference():
    jout = JDatacenterSim.cross_tenant().run(2)
    out = DatacenterSim.cross_tenant(device="cpu").run(2, prefetch=True)
    for key in ("S_nvpax", "S_static", "S_greedy"):
        np.testing.assert_allclose(out[key], jout[key], rtol=0, atol=1e-12, err_msg=key)
    for key in ("sla_min_margin", "sla_min_margin_static"):
        np.testing.assert_allclose(out[key], jout[key], rtol=0, atol=ATOL, err_msg=key)
    assert (out["sla_min_margin"] >= -SLA_TOL).all()
