"""The port's multi-domain fleet (``repro_torch.fleet``) on the CPU, against
the JAX reference's ``repro.fleet`` on the same inputs.

The cases mirror ``tests/test_fleet.py`` on the reference's small fleets
(``homogeneous_fleet(4)``: 4 domains x 2 racks x 2 servers x 4 devices =
64, with an ample feed and with a scarce one): the partition array for
array (and the production geometry), the coordinator's three modes, the
orchestrator's stacked and loop modes over a cold and two warm steps, the
fleet against the monolithic engine with subtree grants, per-lane
topology after a rebuild within the padding, zero rebuilds through grants,
derates, join and leave, the lifecycle's atomic batches, the telemetry
double buffer and the simulator's fleet mode.  Each reference program runs
once per module.

Bars: allocations within ``ATOL`` (1e-9 W) of the reference's with equal
per-domain iterations per phase; fleet vs the monolithic engine within
1e-6 W (the reference's own acceptance bar); each stacked lane the bits of
the port's one-domain solve of its padded problem.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.nvpax import NvpaxOptions as JNvpaxOptions  # noqa: E402
from repro.fleet import BudgetCoordinator as JBudgetCoordinator  # noqa: E402
from repro.fleet import FleetOrchestrator as JFleetOrchestrator  # noqa: E402
from repro.fleet import split_pdn as j_split_pdn  # noqa: E402
from repro.pdn.hierarchy_gen import homogeneous_fleet as j_homogeneous_fleet  # noqa: E402
from repro.pdn.tree import build_datacenter as j_build_datacenter  # noqa: E402
from repro.power.simulator import DatacenterSim as JDatacenterSim  # noqa: E402
from repro_torch.core.batched import solve_three_phase  # noqa: E402
from repro_torch.core.engine import AllocEngine  # noqa: E402
from repro_torch.core.nvpax import NvpaxOptions  # noqa: E402
from repro_torch.core.problem import AllocProblem  # noqa: E402
from repro_torch.core.solver import SolverOptions  # noqa: E402
from repro_torch.core.treeops import SlaTopo, TreeTopo  # noqa: E402
from repro_torch.fleet import (  # noqa: E402
    BudgetCoordinator,
    FleetLifecycle,
    FleetOrchestrator,
    TelemetryDoubleBuffer,
    split_pdn,
)
from repro_torch.pdn.hierarchy_gen import homogeneous_fleet  # noqa: E402
from repro_torch.pdn.tree import PDNNode, build_datacenter, flatten  # noqa: E402
from repro_torch.power import DatacenterSim  # noqa: E402

ATOL = 1e-9  # watts: port vs reference
MONO_TOL = 1e-6  # watts: fleet vs the monolithic engine (the reference's bar)
# every kernel flag: on the CPU each kernel's plain version
FLAGS = dict(use_pallas=True, use_pallas_tree=True, use_pallas_stats=True)


def _pair(**kw):
    return j_homogeneous_fleet(4, **kw), homogeneous_fleet(4, **kw)


@pytest.fixture(scope="module")
def fleet_pdn():
    """(reference, port): 4 identical domains, 64 devices, an ample feed
    (the exact-parity regime)."""
    return _pair()


@pytest.fixture(scope="module")
def scarce_pdn():
    """The same geometry with a scarce shared feed (root_oversub 0.8)."""
    return _pair(root_oversub=0.8)


def _tree_feasible(pdn, x, tol=1e-6):
    csum = np.concatenate([[0.0], np.cumsum(x)])
    return (csum[pdn.node_end] - csum[pdn.node_start] <= pdn.node_cap + tol).all()


def _telemetry(seed, n, steps, lo=80.0, hi=680.0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(lo, hi, n) for _ in range(steps)]


# ---------------------------------------------------------------------------
# partition
# ---------------------------------------------------------------------------

_FLAT = ("node_start", "node_end", "node_cap", "node_parent", "node_depth", "dev_l", "dev_u",
         "dev_node", "dev_depth")


def _assert_partitions_equal(jpart, part):
    assert part.k == jpart.k and part.level == jpart.level
    for a in ("coord_start", "coord_end", "coord_cap", "coord_depth"):
        np.testing.assert_array_equal(getattr(part, a), getattr(jpart, a), err_msg=a)
    np.testing.assert_array_equal(part.domain_cap, jpart.domain_cap)
    np.testing.assert_array_equal(part.domain_of_device(), jpart.domain_of_device())
    for d, jd in zip(part.domains, jpart.domains):
        assert (d.index, d.node_lo, d.node_hi, d.dev_lo, d.dev_hi) == (
            jd.index, jd.node_lo, jd.node_hi, jd.dev_lo, jd.dev_hi)
        for f in _FLAT:
            np.testing.assert_array_equal(getattr(d.pdn, f), getattr(jd.pdn, f), err_msg=f)


@pytest.mark.parametrize("level", [1, 2])
def test_split_pdn_matches_reference(fleet_pdn, level):
    jpdn, pdn = fleet_pdn
    _assert_partitions_equal(j_split_pdn(jpdn, level), split_pdn(pdn, level))


def test_split_pdn_production_geometry_matches_reference():
    kw = dict(n_halls=4, racks_per_hall=2, servers_per_rack=2, gpus_per_server=2)
    jpart = j_split_pdn(j_build_datacenter(**kw), 1)
    part = split_pdn(build_datacenter(**kw), 1)
    _assert_partitions_equal(jpart, part)
    # hall caps oversubscribe the root: ancestors really bind here
    assert part.domain_cap.sum() > part.coord_cap[0]


def test_partition_rejects_devices_above_cut():
    root = PDNNode(capacity=8000.0, n_devices=2)  # devices at the root
    root.add(PDNNode(capacity=4000.0, n_devices=4))
    with pytest.raises(ValueError, match="above the cut"):
        split_pdn(flatten(root, default_l=100.0, default_u=700.0), 1)


# ---------------------------------------------------------------------------
# coordinator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["waterfill", "subtree", "static"])
def test_coordinator_modes_match_reference(scarce_pdn, mode):
    jpdn, pdn = scarce_pdn
    jc = JBudgetCoordinator(j_split_pdn(jpdn, 1), mode=mode)
    c = BudgetCoordinator(split_pdn(pdn, 1), mode=mode)
    np.testing.assert_array_equal(c.domain_min, jc.domain_min)
    rng = np.random.default_rng(0)
    demands = [np.array([c.domain_cap[0], 1000.0, 1000.0, 1000.0]), np.zeros(4),
               rng.uniform(2000.0, 12000.0, 4)]
    for demand in demands:
        grants = c.plan(demand)
        np.testing.assert_allclose(grants, jc.plan(demand), rtol=0, atol=ATOL)
        c.check(grants)
        # a derated feed and domain
        kw = dict(coord_cap=c.cap * 0.9, domain_cap=c.domain_cap * np.array([0.5, 1, 1, 1]))
        np.testing.assert_allclose(c.plan(demand, **kw), jc.plan(demand, **kw), rtol=0,
                                   atol=ATOL)
    prev = c.plan(demands[0])
    dirty = c.domain_dirtiness(demands[2], prev, demands[0], prev)
    np.testing.assert_array_equal(dirty, jc.domain_dirtiness(demands[2], prev, demands[0], prev))
    with pytest.raises(ValueError, match="coordinator row"):
        c.plan(np.zeros(4), coord_cap=c.cap * 0.3)


# ---------------------------------------------------------------------------
# the orchestrator against the reference's
# ---------------------------------------------------------------------------

_REF: dict = {}


def _ref_steps(key, build, teles):
    """The reference orchestrator's results on ``teles``, once per module."""
    if key not in _REF:
        orch = build()
        _REF[key] = [orch.step(t) for t in teles]
    return _REF[key]


def _assert_step(res, jres, msg=""):
    np.testing.assert_allclose(res.allocation, jres.allocation, rtol=0, atol=ATOL, err_msg=msg)
    np.testing.assert_allclose(res.grants, jres.grants, rtol=0, atol=ATOL, err_msg=msg)
    np.testing.assert_allclose(res.demand, jres.demand, rtol=0, atol=ATOL, err_msg=msg)
    for key in ("phase_iterations", "solves", "converged", "skipped", "certify_pass"):
        np.testing.assert_array_equal(np.asarray(res.stats[key]), np.asarray(jres.stats[key]),
                                      err_msg=f"{msg} {key}")


@pytest.mark.parametrize("flags", [{}, FLAGS], ids=["plain", "kernel-flags"])
@pytest.mark.parametrize("mode", ["stacked", "loop", "sharded"])
def test_orchestrator_matches_reference(scarce_pdn, mode, flags):
    """Waterfill grants under a scarce feed, a cold and two warm steps."""
    jpdn, pdn = scarce_pdn
    teles = _telemetry(0, pdn.n, 3)
    jres = _ref_steps(("scarce", mode), lambda: JFleetOrchestrator(jpdn, level=1, mode=mode),
                      teles)
    opts = NvpaxOptions(solver=SolverOptions(**flags))
    orch = FleetOrchestrator(pdn, level=1, mode=mode, options=opts, device="cpu")
    assert orch.mode == mode
    for t, (tele, jr) in enumerate(zip(teles, jres)):
        res = orch.step(tele)
        _assert_step(res, jr, f"{mode} step {t}")
        assert res.stats["mode"] == mode
        assert _tree_feasible(pdn, res.allocation)
    assert orch.rebuild_count() == (orch.k if mode == "loop" else 1)


@pytest.mark.parametrize("mode", ["stacked", "loop"])
def test_fleet_matches_monolithic_with_subtree_grants(fleet_pdn, mode):
    """The reference's acceptance: with subtree grants and an ample feed the
    fleet is the monolithic solve, cold and warm, to 1e-6 W."""
    _, pdn = fleet_pdn
    mono = AllocEngine(pdn, device="cpu")
    orch = FleetOrchestrator(pdn, level=1, coordinator_mode="subtree", mode=mode, device="cpu")
    assert orch.k == 4
    for tele in _telemetry(0, pdn.n, 3):
        rm, rf = mono.step(tele), orch.step(tele)
        assert abs(rm.allocation.sum() - rf.allocation.sum()) <= MONO_TOL
        np.testing.assert_allclose(rf.allocation, rm.allocation, rtol=0, atol=MONO_TOL)
        assert _tree_feasible(pdn, rf.allocation)
        assert rf.stats["converged"].all()


def test_auto_mode_and_heterogeneous_loop(fleet_pdn):
    """Homogeneous domains stack; a 12 + 40-device fleet takes the loop and
    matches the monolithic solve."""
    assert FleetOrchestrator(fleet_pdn[1], level=1, device="cpu").mode == "stacked"
    root = PDNNode(capacity=0.0, name="feed")
    for i, (racks, per) in enumerate([(1, 12), (4, 10)]):
        dom = root.add(PDNNode(capacity=racks * per * 700.0, name=f"dom{i}"))
        for _ in range(racks):
            dom.add(PDNNode(capacity=0.9 * per * 700.0, n_devices=per))
    root.capacity = sum(c.capacity for c in root.children)
    pdn = flatten(root, default_l=200.0, default_u=700.0)
    orch = FleetOrchestrator(pdn, level=1, coordinator_mode="subtree", device="cpu")
    assert orch.mode == "loop"
    tele = np.random.default_rng(5).uniform(100, 650, pdn.n)
    rm, rf = AllocEngine(pdn, device="cpu").step(tele), orch.step(tele)
    assert abs(rm.allocation.sum() - rf.allocation.sum()) <= MONO_TOL


def test_fleet_feasible_when_ancestors_bind():
    """Halls oversubscribe the root: the grants respect the binding root
    row, so the fleet allocation is globally feasible and uses the feed."""
    kw = dict(n_halls=4, racks_per_hall=2, servers_per_rack=2, gpus_per_server=4)
    pdn = build_datacenter(**kw)
    tele = np.full(pdn.n, 690.0)
    res = FleetOrchestrator(pdn, level=1, device="cpu").step(tele)
    jres = JFleetOrchestrator(j_build_datacenter(**kw), level=1).step(tele)
    _assert_step(res, jres)
    assert _tree_feasible(pdn, res.allocation)
    assert res.allocation.sum() > pdn.node_cap[0] - 1.0


def test_brownout_matches_reference(scarce_pdn):
    """A domain feed derated to half: the derated domain is capped and the
    freed budget rerouted, as in the reference."""
    jpdn, pdn = scarce_pdn
    tele = np.random.default_rng(7).uniform(560, 690, pdn.n)
    jorch = JFleetOrchestrator(jpdn, level=1)
    orch = FleetOrchestrator(pdn, level=1, device="cpu")
    res0, jres0 = orch.step(tele), jorch.step(tele)
    _assert_step(res0, jres0)
    orch.set_domain_supply(0, 0.5)
    jorch.set_domain_supply(0, 0.5)
    res1, jres1 = orch.step(tele), jorch.step(tele)
    _assert_step(res1, jres1)
    d0 = orch.partition.domains[0]
    assert res1.grants[0] <= 0.5 * d0.cap + 1e-6
    assert res1.grants[1:].sum() > res0.grants[1:].sum() + 100.0
    assert orch.rebuild_count() == 1


@pytest.mark.parametrize("mode", ["stacked", "loop", "sharded"])
def test_incremental_matches_reference(fleet_pdn, mode):
    """Certify-first stepping per domain: a repeated step skips every
    domain, a step with one domain's telemetry moved re-solves that domain
    alone, as in the reference."""
    jpdn, pdn = fleet_pdn
    tele = np.random.default_rng(3).uniform(100, 650, pdn.n)
    tele[20] = 380.0
    moved = tele.copy()
    moved[20] = 395.0  # an active device of domain 1
    teles = [tele, tele, moved]
    jres = _ref_steps(("inc", mode), lambda: JFleetOrchestrator(
        jpdn, level=1, mode=mode, options=JNvpaxOptions(incremental=True)), teles)
    orch = FleetOrchestrator(pdn, level=1, mode=mode, options=NvpaxOptions(incremental=True),
                             device="cpu")
    for t, (x, jr) in enumerate(zip(teles, jres)):
        _assert_step(orch.step(x), jr, f"{mode} step {t}")
    assert orch.history[1]["skipped"] == 4 and orch.history[2]["skipped"] == 3


# ---------------------------------------------------------------------------
# per-lane topology: a rebuild within the padding, lanes against one-domain
# solves of their padded problems
# ---------------------------------------------------------------------------


def _small_domain(cap):
    """One rack of two 4-device servers: 8 devices, 4 nodes."""
    dom = PDNNode(capacity=cap)
    rack = dom.add(PDNNode(capacity=0.85 * 2 * 4 * 700.0))
    rack.add(PDNNode(capacity=4 * 700.0, n_devices=4))
    rack.add(PDNNode(capacity=4 * 700.0, n_devices=4))
    return flatten(dom)


def one_domain_solve(orch, k, tele, active, grants, row_bounds=None):
    """The port's one-scenario solve of domain ``k``'s padded problem (the
    lane's own inputs on one vector): what lane ``k`` of the stacked solve
    must reproduce bit for bit on the CPU."""
    N, T = orch._N, orch._T
    l, u, pri, start, end, depth, sdev, sten = orch._lane_arrays(k)
    cap = orch._cap_np[k].copy()
    cap[0] = grants[k]
    lo, hi = np.zeros(T), np.full(T, np.inf)
    if row_bounds is not None:
        r_lo, r_hi = row_bounds[k]
        lo[: r_lo.shape[0]], hi[: r_hi.shape[0]] = r_lo, r_hi
    f64 = torch.float64
    offs = orch._offsets()
    nk = int(offs[k + 1] - offs[k])
    r = np.zeros(N)
    a = np.zeros(N, bool)
    r[:nk], a[:nk] = tele[offs[k] : offs[k + 1]], active[offs[k] : offs[k + 1]]
    lt, ut, rt, at = torch.as_tensor(l), torch.as_tensor(u), torch.as_tensor(r), torch.as_tensor(a)
    ap = AllocProblem(
        l=lt, u=ut, r=torch.where(at, torch.clamp(rt, lt, ut), lt),
        priority=torch.as_tensor(pri), active=at,
        tree=TreeTopo.make(start, end, cap, depth, N, dtype=f64, device="cpu"),
        sla=SlaTopo.make(sdev, sten, lo, hi, n=N, dtype=f64, device="cpu"),
        weight_scale=torch.ones(N, dtype=f64),
    )
    return solve_three_phase(ap, orch.meta, orch.options.solver)[2].numpy()[:nk]


def _planned(orch, tele, active):
    offs = orch._offsets()
    shaped = np.where(active, np.clip(tele, orch.device_bounds(), orch.device_caps()),
                      orch.device_bounds())
    demand = np.array([shaped[offs[k] : offs[k + 1]].sum() for k in range(orch.k)])
    grants, row_bounds, _, _ = orch._plan(demand, shaped)
    return grants, row_bounds


@pytest.mark.parametrize("flags", [{}, FLAGS], ids=["plain", "kernel-flags"])
def test_stacked_lanes_are_one_domain_solves_after_rebuild(scarce_pdn, flags):
    """Domain 1 rebuilt to 8 devices and 4 nodes inside the 16 x 7 padding:
    one rebuild, the other lanes untouched, and every lane the bits of the
    one-domain solve of its padded problem, over a cold and a warm-reset
    step."""
    jpdn, pdn = scarce_pdn
    orch = FleetOrchestrator(pdn, level=1, mode="stacked",
                             options=NvpaxOptions(solver=SolverOptions(**flags)), device="cpu")
    idx = orch._dom.tree.index
    before = {f: getattr(idx, f).clone() for f in ("start", "end", "cover_ptr", "cover_rows")}
    bufs = [getattr(idx, f).data_ptr() for f in before]
    orch.rebuild_domain(1, _small_domain(orch.partition.domains[1].cap))
    assert orch.rebuild_count() == 2
    assert [getattr(idx, f).data_ptr() for f in before] == bufs  # rewritten in place
    for f, old in before.items():
        new = getattr(idx, f)
        for k in (0, 2, 3):
            assert torch.equal(new[k], old[k]), f
        assert not torch.equal(new[1], old[1]), f
    assert orch.n == pdn.n - 8
    for tele in _telemetry(11, orch.n, 2, 100.0, 650.0):
        active = tele >= orch.idle_threshold
        grants, _ = _planned(orch, tele, active)
        orch.reset_warm()
        res = orch.step(tele)
        offs = orch._offsets()
        for k in range(orch.k):
            want = one_domain_solve(orch, k, tele, active, grants)
            assert np.array_equal(res.allocation[offs[k] : offs[k + 1]], want), k
        assert res.stats["converged"].all()
        assert orch.rebuild_count() == 2


def test_stacked_rebuild_rejects_oversize(fleet_pdn):
    orch = FleetOrchestrator(fleet_pdn[1], level=1, mode="stacked", device="cpu")
    with pytest.raises(ValueError, match="padded shape"):
        orch.rebuild_domain(0, homogeneous_fleet(1, racks_per_domain=4))
    assert orch.rebuild_count() == 1


def test_loop_rebuild_spares_other_domains(fleet_pdn):
    """Loop mode rebuilds only the changed domain's engine."""
    _, pdn = fleet_pdn
    orch = FleetOrchestrator(pdn, level=1, mode="loop", device="cpu")
    tele = np.random.default_rng(9).uniform(100, 650, pdn.n)
    orch.step(tele)
    others = [orch._engines[k] for k in (1, 2, 3)]
    orch.rebuild_domain(0, _small_domain(orch.partition.domains[0].cap))
    assert [orch._engines[k] for k in (1, 2, 3)] == others
    assert orch.rebuild_count() == 5
    res = orch.step(np.concatenate([tele[:8], tele[16:]]))
    assert res.allocation.shape == (pdn.n - 8,)
    assert res.stats["converged"].all()
    assert orch.rebuild_count() == 5


# ---------------------------------------------------------------------------
# lifecycle: churn re-pins without rebuilds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["stacked", "loop"])
def test_churn_matches_reference_with_zero_rebuilds(scarce_pdn, mode):
    """Leave, a derate, a feed derate and a rejoin: each step as the
    reference's, and the built tensors never rebuilt."""
    jpdn, pdn = scarce_pdn
    tele = np.random.default_rng(8).uniform(100, 650, pdn.n)
    jorch = JFleetOrchestrator(jpdn, level=1, mode=mode)
    orch = FleetOrchestrator(pdn, level=1, mode=mode, device="cpu")
    from repro.fleet import FleetLifecycle as JFleetLifecycle

    jlife, life = JFleetLifecycle(jorch), FleetLifecycle(orch)
    _assert_step(orch.step(tele), jorch.step(tele))
    built = orch.rebuild_count()
    for act in (lambda o, lf: lf.device_leave([0, 5, 17]),
                lambda o, lf: o.set_domain_supply(2, 0.6),
                lambda o, lf: o.set_feed_scale(0.9),
                lambda o, lf: lf.device_join([0, 5, 17])):
        act(orch, life)
        act(jorch, jlife)
        res = orch.step(tele)
        _assert_step(res, jorch.step(tele), mode)
        assert _tree_feasible(pdn, res.allocation)
    assert life.n_left == 0
    assert orch.rebuild_count() == built


def test_lifecycle_join_batch_is_atomic(fleet_pdn):
    _, pdn = fleet_pdn
    orch = FleetOrchestrator(pdn, level=1, mode="stacked", device="cpu")
    life = FleetLifecycle(orch)
    life.device_leave([3, 20])
    with pytest.raises(KeyError, match="was not left"):
        life.device_join([3, 21])
    assert life.n_left == 2
    life.device_join([3, 20])
    assert life.n_left == 0
    res = orch.step(np.full(pdn.n, 400.0))
    assert (res.allocation[[3, 20]] >= pdn.dev_l[[3, 20]] - 1e-9).all()


def test_derates_and_repins_validate_before_mutating(scarce_pdn):
    _, pdn = scarce_pdn
    orch = FleetOrchestrator(pdn, level=1, device="cpu")
    with pytest.raises(ValueError, match="minimum draw"):
        orch.set_domain_supply(0, 0.1)
    with pytest.raises(ValueError, match="minimum draw"):
        orch.set_feed_scale(0.3)
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        orch.set_domain_supply(0, 1.5)
    l_before = orch._dev_l[0].copy()
    with pytest.raises(ValueError, match="0 <= l <= u"):
        orch.repin_domain(0, dev_l=np.full(16, 800.0))
    np.testing.assert_array_equal(orch._dev_l[0], l_before)
    life = FleetLifecycle(orch)
    life.device_leave(np.arange(12))
    orch.set_domain_supply(0, 0.1)
    with pytest.raises(ValueError, match="derated feed"):
        life.device_join(np.arange(12))
    assert life.n_left == 12
    res = orch.step(np.full(pdn.n, 400.0))
    assert res.grants[0] <= 0.1 * orch.partition.domain_cap[0] + 1e-6
    assert res.stats["converged"].all()
    assert orch.rebuild_count() == 1


def test_double_buffer_matches_sync_fetch():
    from repro_torch.pdn.telemetry import TelemetrySim, TraceConfig

    sim = TelemetrySim(TraceConfig(n_devices=16, seed=3))
    calls = []

    def traced(t):
        calls.append(t)
        return sim.power(t)

    with TelemetryDoubleBuffer(traced) as buf:
        for t in range(5):
            np.testing.assert_array_equal(buf.fetch(t), sim.power(t))
        snap = list(calls)
        assert sorted(set(snap)) == snap
    with pytest.raises(RuntimeError):
        buf.fetch(0)


# ---------------------------------------------------------------------------
# the simulator's fleet mode, and what is not ported
# ---------------------------------------------------------------------------


def test_simulator_fleet_mode_matches_reference(scarce_pdn):
    jpdn, pdn = scarce_pdn
    jout = JDatacenterSim.build(jpdn, seed=3, fleet_level=1).run(3, prefetch=True)
    out = DatacenterSim.build(pdn, seed=3, fleet_level=1, device="cpu").run(3)
    pre = DatacenterSim.build(pdn, seed=3, fleet_level=1, device="cpu").run(3, prefetch=True)
    for key in ("S_nvpax", "S_static", "S_greedy", "straggler_tax"):
        np.testing.assert_allclose(out[key], jout[key], rtol=0, atol=1e-12, err_msg=key)
        np.testing.assert_array_equal(pre[key], out[key], err_msg=key)
    assert (out["S_nvpax"] >= out["S_static"] - 1e-9).all()


def test_sharded_mode_and_recorder_run(fleet_pdn):
    """The sharded dispatch runs at one rank of this process and gives the
    stacked step (``tests/test_torch_fleet_sharded.py`` holds it to the
    reference); the flight recorder records one lane per domain."""
    _, pdn = fleet_pdn
    tele = _telemetry(1, pdn.n, 1)[0]
    sharded = FleetOrchestrator(pdn, level=1, mode="sharded", device="cpu").step(tele)
    stacked = FleetOrchestrator(pdn, level=1, mode="stacked", device="cpu").step(tele)
    assert sharded.stats["mode"] == "sharded"
    np.testing.assert_allclose(sharded.allocation, stacked.allocation, rtol=0, atol=MONO_TOL)
    np.testing.assert_allclose(sharded.grants, stacked.grants, rtol=0, atol=MONO_TOL)
    np.testing.assert_array_equal(sharded.stats["phase_iterations"],
                                  stacked.stats["phase_iterations"])
    with pytest.raises(ValueError, match="waterfill/subtree"):
        FleetOrchestrator(pdn, level=1, mode="sharded", coordinator_mode="static", device="cpu")
    # the flight recorder (item 10) records: one lane per domain
    orch = FleetOrchestrator(pdn, level=1, recorder=True, device="cpu")
    orch.step(np.full(pdn.n, 300.0))
    flight = orch.flush_recorder()
    assert flight["mode"] == orch.mode and len(flight["lanes"]) == orch.k
    assert all(lane["counters"]["n_steps"] == 1 for lane in flight["lanes"])
    with pytest.raises(ValueError, match="mutually exclusive"):
        from repro_torch.power import PowerController

        DatacenterSim.build(pdn, controller=PowerController(pdn, device="cpu"), fleet_level=1)
