"""The port's engine, one-scenario program and controller on the CPU,
against the JAX reference (``repro.core.engine``, ``repro.core.batched``,
``repro.power.controller``).  The cases mirror ``tests/test_engine.py`` on
the 48-device fleet, with and without four scattered tenants.

Bars: allocations agree to 1e-9 W per device and the per-phase PDHG
iteration counts are equal, over warm-carried runs; re-pins leave the
engine's ``rebuild_count()`` at 1.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compat import enable_x64  # noqa: E402
from repro.core import batched as j_batched  # noqa: E402
from repro.core.engine import AllocEngine as JAllocEngine  # noqa: E402
from repro.core.nvpax import NvpaxOptions as JNvpaxOptions  # noqa: E402
from repro.core.problem import AllocProblem as JAllocProblem  # noqa: E402
from repro.core.solver import SolverOptions as JSolverOptions  # noqa: E402
from repro.pdn.tenants import assign_tenants as j_assign_tenants  # noqa: E402
from repro.pdn.tree import build_from_level_sizes as j_build_from_level_sizes  # noqa: E402
from repro.power.controller import ControllerConfig as JControllerConfig  # noqa: E402
from repro.power.controller import PowerController as JPowerController  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import batched  # noqa: E402
from repro_torch.core.engine import AllocEngine  # noqa: E402
from repro_torch.core.nvpax import NvpaxOptions  # noqa: E402
from repro_torch.core.problem import AllocProblem  # noqa: E402
from repro_torch.core.solver import SolverOptions  # noqa: E402
from repro_torch.pdn.tenants import assign_tenants  # noqa: E402
from repro_torch.pdn.tree import build_from_level_sizes  # noqa: E402
from repro_torch.power import ControllerConfig, PowerController  # noqa: E402

ATOL = 1e-9  # watts: engine vs reference engine, same programs
STEPS = 5


def to_numpy(nt):
    if hasattr(nt, "_fields"):
        return {f: to_numpy(getattr(nt, f)) for f in nt._fields}
    return np.asarray(nt)


@pytest.fixture(scope="module")
def fleets():
    """(reference pdn, reference layout, port pdn, port layout)."""
    jpdn = j_build_from_level_sizes([2, 3, 2], gpus_per_server=4)  # n = 48
    pdn = build_from_level_sizes([2, 3, 2], gpus_per_server=4)
    kw = dict(n_tenants=4, devices_per_tenant=8, seed=1)
    return jpdn, j_assign_tenants(jpdn, **kw), pdn, assign_tenants(pdn, **kw)


def _engines(fleets, tenants, flags=None, **kw):
    jpdn, jlay, pdn, lay = fleets
    flags = flags or {}
    jeng = JAllocEngine(
        jpdn,
        sla=jlay.sla_topo() if tenants else None,
        priority=jlay.priority if tenants else None,
        options=JNvpaxOptions(solver=JSolverOptions(**flags)),
        **kw,
    )
    eng = AllocEngine(
        pdn,
        sla=lay.sla_topo(device="cpu") if tenants else None,
        priority=lay.priority if tenants else None,
        options=NvpaxOptions(solver=SolverOptions(**flags)),
        device="cpu",
        **kw,
    )
    return jeng, eng


def _assert_same(res, jres, msg=""):
    np.testing.assert_allclose(res.allocation, jres.allocation, rtol=0, atol=ATOL, err_msg=msg)
    np.testing.assert_allclose(res.phase1, jres.phase1, rtol=0, atol=ATOL, err_msg=msg)
    for key in ("phase_iterations", "total_solves", "converged", "kkt_certified", "truncated",
                "restarts", "skipped", "certify_pass"):
        assert res.stats[key] == jres.stats[key], (msg, key)
    np.testing.assert_array_equal(res.stats["kkt_hist"], np.asarray(jres.stats["kkt_hist"]))


def _tree_feasible(pdn, x, tol=1e-6):
    csum = np.concatenate([[0.0], np.cumsum(x)])
    return (csum[pdn.node_end] - csum[pdn.node_start] <= pdn.node_cap + tol).all()


@pytest.mark.parametrize("tenants", [False, True], ids=["tree", "tenants"])
def test_warm_carried_steps_match_reference(fleets, tenants):
    """Five warm-carried engine steps on independent telemetry: the tenant
    fleet runs Phases II/III as PDHG max-min LPs, the tree-only fleet as the
    water-fill on the device."""
    jeng, eng = _engines(fleets, tenants)
    rng = np.random.default_rng(0)
    for t in range(STEPS):
        tele = rng.uniform(100, 650, eng.n)
        res = eng.step(tele)
        _assert_same(res, jeng.step(tele), f"step {t}")
        assert _tree_feasible(fleets[2], res.allocation)
    assert eng.rebuild_count() == 1


@pytest.mark.parametrize(
    "flags",
    [
        dict(use_pallas=True),
        dict(use_pallas_tree=True),
        dict(use_pallas_stats=True),
        dict(use_pallas=True, use_pallas_tree=True, use_pallas_stats=True),
    ],
    ids=["pallas", "tree", "stats", "all"],
)
def test_kernel_flags_match_reference(fleets, flags):
    """Each kernel flag on the tenant fleet, two warm-carried steps: the
    reference runs its Pallas kernels in interpret mode, the port (on the
    CPU) their plain versions."""
    jeng, eng = _engines(fleets, True, flags)
    rng = np.random.default_rng(1)
    for t in range(2):
        tele = rng.uniform(100, 650, eng.n)
        _assert_same(eng.step(tele), jeng.step(tele), f"step {t}")


def test_engine_state_carries_across(fleets):
    """The reference engine's metadata and warm carry, handed over with
    convert.py, drive the port's one-scenario program to the reference's
    next step."""
    jpdn, jlay, pdn, lay = fleets
    jeng, eng = _engines(fleets, True)
    rng = np.random.default_rng(2)
    jeng.step(rng.uniform(100, 650, eng.n))
    tele = rng.uniform(100, 650, eng.n)
    jwarm = jeng._warm
    jres = jeng.step(tele)
    meta = convert.batch_meta_from_dict(jeng.meta._asdict())
    assert meta == eng.meta
    warm = convert.warm_carry_from_numpy(to_numpy(jwarm), device="cpu")
    act = tele >= eng.idle_threshold
    x1, x2, x3, _, stats = batched.solve_three_phase(
        _port_problem(eng, tele), meta, eng.options.solver, warm,
        present=batched.active_levels(eng.priority_np, act),
    )
    np.testing.assert_allclose(x3.numpy(), jres.allocation, rtol=0, atol=ATOL)
    assert [stats[f"iterations_p{i}"] for i in (1, 2, 3)] == jres.stats["phase_iterations"]


def _port_problem(eng, tele):
    from repro_torch.core.problem import AllocProblem

    return AllocProblem.build(
        eng.pdn, tele, priority=eng.priority_np, idle_threshold=eng.idle_threshold,
        topology=eng.fleet,
    )


def test_batch_meta_matches_reference(fleets):
    jpdn, jlay, pdn, lay = fleets
    tele = np.random.default_rng(3).uniform(100, 650, pdn.n)
    with enable_x64(True):
        jap = JAllocProblem.build(jpdn, tele, sla=jlay.sla_topo(), priority=jlay.priority)
    tap = convert.alloc_problem_from_numpy(to_numpy(jap), device="cpu")
    want = convert.batch_meta_from_dict(j_batched.batch_meta(jap, JNvpaxOptions())._asdict())
    assert batched.batch_meta(tap, NvpaxOptions()) == want
    with pytest.raises(ValueError, match="unknown"):
        convert.batch_meta_from_dict({**want._asdict(), "recorder": 1})


@pytest.mark.parametrize("budget", [1, 10**8], ids=["phase1-only", "unbounded"])
def test_iter_budget_matches_reference(fleets, budget):
    """``solve_three_phase`` with an iteration budget, against the
    reference's K = 1 batched program with the same budget: budget 1 keeps
    Phase I only and reports truncation; a huge budget equals no budget."""
    jpdn, jlay, pdn, lay = fleets
    tele = np.random.default_rng(7).uniform(100, 650, pdn.n)
    with enable_x64(True):
        jap = JAllocProblem.build(jpdn, tele, sla=jlay.sla_topo(), priority=jlay.priority)
        jres = j_batched.optimize_batched([jap], iter_budget=budget)
    tap = convert.alloc_problem_from_numpy(to_numpy(jap), device="cpu")
    meta = batched.batch_meta(tap, NvpaxOptions())
    x1, _, x3, _, stats = batched.solve_three_phase(tap, meta, SolverOptions(), None, budget)
    np.testing.assert_allclose(x3.numpy(), jres.allocation[0], rtol=0, atol=ATOL)
    assert stats["truncated"] == bool(jres.stats["truncated"][0]) == (budget == 1)
    assert [stats[f"iterations_p{i}"] for i in (1, 2, 3)] == list(
        jres.stats["iterations_per_phase"][0]
    )
    if budget == 1:
        assert torch.equal(x3, x1)
    else:
        _, _, free, _, free_stats = batched.solve_three_phase(tap, meta, SolverOptions())
        assert torch.equal(x3, free) and not free_stats["truncated"]


def test_repins_match_reference_without_rebuild(fleets):
    """Root-cap grant, supply drop, a device leaving (zero-width box) and a
    raised tenant minimum between warm-carried steps: both engines agree
    step for step, and the port never rebuilds its topology or index
    tables."""
    jpdn, jlay, pdn, lay = fleets
    jeng, eng = _engines(fleets, True)
    rng = np.random.default_rng(5)
    tele = rng.uniform(150, 600, eng.n)
    sla_lo = lay.b_min.copy()
    sla_lo[0] = 0.5 * lay.b_max[0]
    dev_l, dev_u = pdn.dev_l.copy(), pdn.dev_u.copy()
    dev_l[40:42] = dev_u[40:42] = 0.0
    repins = [
        lambda e: e.set_root_cap(0.9 * pdn.node_cap[0]),
        lambda e: e.rescale_supply(0.8),
        lambda e: e.repin(dev_l=dev_l, dev_u=dev_u),
        lambda e: e.set_sla_bounds(sla_lo, lay.b_max),
    ]
    _assert_same(eng.step(tele), jeng.step(tele), "before")
    for i, repin in enumerate(repins):
        repin(eng)
        repin(jeng)
        tele = tele * rng.uniform(0.98, 1.02, eng.n)
        res = eng.step(tele)
        _assert_same(res, jeng.step(tele), f"re-pin {i}")
        assert eng.rebuild_count() == 1
    assert _tree_feasible(pdn, res.allocation)
    np.testing.assert_array_equal(eng.fleet.sla.lo.numpy(), sla_lo)


def test_pin_free_is_fixed_at_construction(fleets):
    """pin_free comes from ``sla.lo > 0`` at construction, as in the
    reference; an engine built without tenant minimums refuses to raise
    them, and one built with them keeps them re-pinnable."""
    jpdn, jlay, pdn, lay = fleets
    sla = lay.sla_topo(device="cpu")
    free = AllocEngine(pdn, sla=sla._replace(lo=torch.zeros_like(sla.lo)), device="cpu")
    assert free.meta.pin_free
    free.set_sla_bounds(np.zeros(4), lay.b_max)  # lo stays 0: fine
    with pytest.raises(ValueError, match="pin-free"):
        free.set_sla_bounds(lay.b_min, lay.b_max)
    jeng, eng = _engines(fleets, True)
    assert eng.meta.pin_free is jeng.meta.pin_free is False
    with pytest.raises(ValueError, match="lo <= hi"):
        eng.set_sla_bounds(lay.b_max + 1.0, lay.b_max)


def test_pinned_levels_skip_empty(fleets):
    """Levels come from the full layout; a level with no active device is
    skipped, as the reference's engine and host driver do."""
    jpdn, _, pdn, _ = fleets
    priority = np.where(np.arange(pdn.n) % 2 == 0, 2, 1).astype(np.int32)
    jeng = JAllocEngine(jpdn, priority=priority)
    eng = AllocEngine(pdn, priority=priority, device="cpu")
    assert eng.meta.levels == jeng.meta.levels == (2, 1)
    tele = np.random.default_rng(2).uniform(200, 650, pdn.n)
    tele[priority == 2] = 50.0  # every priority-2 device idle
    _assert_same(eng.step(tele), jeng.step(tele))


def test_deadline_truncates(fleets):
    """A deadline below one iteration's cost keeps Phase I only; a generous
    one runs everything (the calibration probes time two cold solves)."""
    _, eng = _engines(fleets, False)
    tele = np.random.default_rng(10).uniform(100, 650, eng.n)
    res = eng.step(tele, deadline_s=1e-7)
    assert res.stats["truncated"] and res.stats["iter_budget"] == 0
    np.testing.assert_array_equal(res.allocation, res.phase1)
    res2 = eng.step(tele, deadline_s=600.0)
    assert not res2.stats["truncated"]
    assert eng.rebuild_count() == 1


def test_phase_cost_model_matches_reference():
    probes = (0.02, [200, 0, 0], 0.5, [200, 2050, 300])
    want = j_batched.PhaseCostModel.fit(*probes)
    got = batched.PhaseCostModel.fit(*probes)
    assert tuple(got) == tuple(want)
    for mix in (None, (0.3, 0.7)):
        assert got.cost_per_iter(mix) == want.cost_per_iter(mix)
        assert got.budget(0.25, mix) == want.budget(0.25, mix)
    flat = batched.PhaseCostModel.fit(0.02, [200, 0, 0], 0.03, [200, 0, 0])
    assert flat.p23_s == flat.p1_s == j_batched.PhaseCostModel.fit(
        0.02, [200, 0, 0], 0.03, [200, 0, 0]
    ).p23_s


def test_controller_engine_matches_legacy_and_reference(fleets):
    """Engine-served controller steps equal the rebuild-every-step
    controller's to 1e-9 W and the reference controller's, across a device
    failure and a supply drop (which re-pins, never rebuilds)."""
    jpdn, jlay, pdn, lay = fleets
    ctl_e = PowerController(pdn, sla=lay.sla_topo(device="cpu"), priority=lay.priority,
                            device="cpu")
    ctl_l = PowerController(pdn, sla=lay.sla_topo(device="cpu"), priority=lay.priority,
                            config=ControllerConfig(use_engine=False), device="cpu")
    ctl_j = JPowerController(jpdn, sla=jlay.sla_topo(), priority=jlay.priority,
                             config=JControllerConfig(use_engine=True))
    rng = np.random.default_rng(12)
    for t in range(4):
        if t == 2:
            for c in (ctl_e, ctl_l, ctl_j):
                c.fail_devices([3, 17])
        if t == 3:
            for c in (ctl_e, ctl_l, ctl_j):
                c.set_supply_scale(0.9)
        tele = rng.uniform(50, 650, pdn.n)
        res_e, res_l, res_j = ctl_e.step(tele), ctl_l.step(tele), ctl_j.step(tele)
        np.testing.assert_allclose(res_e.allocation, res_l.allocation, atol=ATOL,
                                   err_msg=f"step {t}")
        _assert_same(res_e, res_j, f"step {t}")
        assert res_e.stats["phase_iterations"] == res_l.stats["phase_iterations"]
    assert len(ctl_e.history) == len(ctl_l.history) == 4
    assert ctl_e.rebuild_count() == 1 and ctl_l.rebuild_count() == 0
    np.testing.assert_allclose(ctl_e._engine.fleet.tree.cap.numpy(), 0.9 * pdn.node_cap)
    assert ctl_e.flush_recorder() is None
    ctl_e.restore_devices([3, 17])
    assert not ctl_e.failed.any()


def test_stats_keys_match_reference(fleets):
    jeng, eng = _engines(fleets, False)
    tele = np.random.default_rng(6).uniform(100, 650, eng.n)
    assert set(eng.step(tele).stats) == set(jeng.step(tele).stats)


def test_unported_paths_raise(fleets):
    """What once raised (the flight recorder, ROADMAP item 10) now records:
    the engine, the controller and ``optimize_batched`` take ``recorder=`` /
    ``rec=`` and each recorded step is one row per lane."""
    from repro_torch.obs import recorder

    _, _, pdn, _ = fleets
    eng = AllocEngine(pdn, device="cpu")
    ctl = PowerController(pdn, device="cpu")
    tele = np.full((2, pdn.n), 300.0)
    rec_eng = AllocEngine(pdn, recorder=True, device="cpu")
    rec_eng.step(tele[0])
    assert rec_eng.flush_recorder()["step"]["counters"]["n_steps"] == 1
    rec_ctl = PowerController(pdn, recorder=True, device="cpu")
    rec_ctl.step(tele[0])
    assert rec_ctl.flush_recorder()["step"]["rows"].shape == (1, len(recorder.FIELDS))
    cfg = recorder.RecorderConfig()
    state = recorder.init_batch(cfg, 2, pdn.n, device="cpu")
    res = batched.optimize_batched(
        batched.stack_problems([AllocProblem.build(pdn, t, device="cpu") for t in tele]),
        rec=state, rec_cfg=cfg,
    )
    assert [lane["step"] for lane in recorder.flush_lanes(res.recorder, cfg)] == [1, 1]
    # the K-scenario path (item 8b) is ported, incremental form included
    inc = AllocEngine(pdn, options=NvpaxOptions(incremental=True), device="cpu")
    for res in (eng.step_batched(tele), ctl.step_batched(tele), ctl.what_if(tele),
                inc.step_batched(tele)):
        assert res.allocation.shape == (2, pdn.n)


def test_entry_points_need_a_card_or_cpu(fleets):
    """Without a card, device=None raises instead of falling back."""
    _, _, pdn, lay = fleets
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    for make in (
        lambda: AllocEngine(pdn),
        lambda: PowerController(pdn),
        lambda: lay.sla_topo(),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
