"""The port's K-scenario serving paths on the CPU: ``AllocEngine.step_batched``
and ``PowerController.step_batched`` / ``what_if``, against the JAX
reference's, and the batched incremental (certify-first) step.

The cases mirror the batched cases of ``tests/test_engine.py``,
``tests/test_batched.py::test_controller_step_batched`` and
``tests/test_incremental.py::test_batched_stats_survive_vmap`` on small
fleets.  Each reference program runs once per module.

Bars: lanes agree with the reference's lanes to 1e-9 W with equal
per-phase iteration counts ([K, 3]); ``what_if`` is stateless and
deterministic; batched calls leave ``rebuild_count()`` and the one-scenario
state alone; an identical batch skips every lane and one dirty lane
re-solves alone.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import AllocEngine as JAllocEngine  # noqa: E402
from repro.core.nvpax import NvpaxOptions as JNvpaxOptions  # noqa: E402
from repro.core.solver import SolverOptions as JSolverOptions  # noqa: E402
from repro.pdn.tenants import assign_tenants as j_assign_tenants  # noqa: E402
from repro.pdn.tree import build_from_level_sizes as j_build_from_level_sizes  # noqa: E402
from repro.power.controller import PowerController as JPowerController  # noqa: E402
from repro_torch.core.engine import AllocEngine  # noqa: E402
from repro_torch.core.nvpax import NvpaxOptions  # noqa: E402
from repro_torch.core.solver import SolverOptions  # noqa: E402
from repro_torch.pdn.tenants import assign_tenants  # noqa: E402
from repro_torch.pdn.tree import build_from_level_sizes  # noqa: E402
from repro_torch.power import ControllerConfig, PowerController  # noqa: E402

ATOL = 1e-9  # watts: port lanes vs the reference's lanes
K = 3


@pytest.fixture(scope="module")
def fleets():
    """(reference pdn, reference layout, port pdn, port layout)."""
    jpdn = j_build_from_level_sizes([2, 3, 2], gpus_per_server=4)  # n = 48
    pdn = build_from_level_sizes([2, 3, 2], gpus_per_server=4)
    kw = dict(n_tenants=4, devices_per_tenant=8, seed=1)
    return jpdn, j_assign_tenants(jpdn, **kw), pdn, assign_tenants(pdn, **kw)


def _tree_feasible(pdn, x, tol=1e-6):
    csum = np.concatenate([[0.0], np.cumsum(x)])
    return (csum[pdn.node_end] - csum[pdn.node_start] <= pdn.node_cap + tol).all()


def _assert_lanes(res, jres, msg=""):
    np.testing.assert_allclose(res.allocation, np.asarray(jres.allocation), rtol=0, atol=ATOL,
                               err_msg=msg)
    np.testing.assert_allclose(res.phase1, np.asarray(jres.phase1), rtol=0, atol=ATOL,
                               err_msg=msg)
    assert res.stats["phase_iterations"].shape == (res.allocation.shape[0], 3)
    for key in ("phase_iterations", "solves", "converged", "kkt_certified", "truncated",
                "skipped", "certify_pass"):
        np.testing.assert_array_equal(res.stats[key], np.asarray(jres.stats[key]),
                                      err_msg=f"{msg} {key}")


@pytest.fixture(scope="module")
def engine_runs(fleets):
    """Two consecutive warm-carried ``step_batched`` calls on drifting
    telemetry with the tenant layout, in both packages."""
    jpdn, jlay, pdn, lay = fleets
    rng = np.random.default_rng(5)
    tb0 = rng.uniform(100, 650, (K, pdn.n))
    tb1 = np.clip(tb0 + rng.normal(0, 6, tb0.shape), 80, 690)
    jeng = JAllocEngine(jpdn, sla=jlay.sla_topo(), priority=jlay.priority)
    eng = AllocEngine(pdn, sla=lay.sla_topo(device="cpu"), priority=lay.priority, device="cpu")
    jruns = [jeng.step_batched(tb) for tb in (tb0, tb1)]
    runs = [eng.step_batched(tb) for tb in (tb0, tb1)]
    return eng, runs, jruns, (tb0, tb1)


@pytest.mark.parametrize("call", [0, 1], ids=["cold", "warm-carried"])
def test_engine_step_batched_matches_reference(engine_runs, fleets, call):
    eng, runs, jruns, _ = engine_runs
    res, jres = runs[call], jruns[call]
    _assert_lanes(res, jres, f"call {call}")
    assert res.stats["converged"].all()
    for x in res.allocation:
        assert _tree_feasible(fleets[2], x)


def test_engine_step_batched_leaves_engine_state(engine_runs):
    """Batched calls build nothing (one topology build in all), carry their
    own warm state per K, and leave the one-scenario state and history
    alone; ``reset_warm`` drops both carries."""
    eng, runs, _, (tb0, _) = engine_runs
    assert eng.rebuild_count() == 1
    assert eng.history == [] and eng._warm is None
    assert set(eng._batched_warm) == {K}
    assert eng._batched_warm[K].p1.x.shape == (K, eng.n)
    eng.step(tb0[0])
    assert eng.rebuild_count() == 1 and len(eng.history) == 1
    eng.reset_warm()
    assert not eng._batched_warm and eng._warm is None


def test_engine_step_batched_lanes_are_single_steps(fleets):
    """Each cold lane is the engine's own cold one-scenario step, bit for
    bit, with a shared [n] active mask broadcast to every lane."""
    _, _, pdn, lay = fleets
    rng = np.random.default_rng(11)
    tb = rng.uniform(100, 650, (K, pdn.n))
    active = rng.random(pdn.n) < 0.8
    eng = AllocEngine(pdn, sla=lay.sla_topo(device="cpu"), priority=lay.priority, device="cpu")
    res = eng.step_batched(tb, active=active, carry_warm=False)
    for k in range(K):
        eng.reset_warm()
        one = eng.step(tb[k], active=active)
        np.testing.assert_array_equal(res.allocation[k], one.allocation)
        assert list(res.stats["phase_iterations"][k]) == one.stats["phase_iterations"]
    with pytest.raises(ValueError):
        eng.step_batched(tb[0])
    with pytest.raises(ValueError):
        eng.step_batched(tb, active=active[:-1])


@pytest.fixture(scope="module")
def controllers(fleets):
    jpdn, _, pdn, _ = fleets
    rng = np.random.default_rng(4)
    tele = rng.uniform(100, 600, (4, pdn.n))
    jres = JPowerController(jpdn).what_if(tele)
    return tele, jres


@pytest.mark.parametrize("use_engine", [True, False], ids=["engine", "rebuild-path"])
def test_controller_what_if_matches_reference(fleets, controllers, use_engine):
    """``what_if``: K scenarios in one call, no controller state advance,
    identical inputs give identical outputs, each lane the reference's and
    the controller's own committed step of that scenario."""
    _, _, pdn, _ = fleets
    tele, jres = controllers
    ctl = PowerController(pdn, config=ControllerConfig(use_engine=use_engine), device="cpu")
    res = ctl.what_if(tele)
    again = ctl.what_if(tele)
    assert len(ctl.history) == 0
    np.testing.assert_array_equal(res.allocation, again.allocation)
    _assert_lanes(res, jres, f"use_engine={use_engine}")
    for k in range(len(tele)):
        assert _tree_feasible(pdn, res.allocation[k])
        ctl.reset_warm()
        one = ctl.step(tele[k])
        np.testing.assert_allclose(res.allocation[k], one.allocation, rtol=0, atol=ATOL)
    if use_engine:
        assert ctl.rebuild_count() == 1


def test_controller_step_batched_carries_warm(fleets):
    """``step_batched`` carries the batched warm state per K (``what_if``
    does not), masks failed devices and scales the supply as ``step``."""
    _, _, pdn, _ = fleets
    rng = np.random.default_rng(6)
    tele = rng.uniform(100, 600, (2, pdn.n))
    ctl = PowerController(pdn, device="cpu")
    ctl.step_batched(tele)
    assert 2 in ctl._engine._batched_warm
    ctl.fail_devices([0, 1])
    ctl.set_supply_scale(0.9)
    res = ctl.step_batched(tele)
    assert (res.allocation[:, :2] == pdn.dev_l[:2]).all()
    scaled = pdn.node_cap * 0.9
    for x in res.allocation:
        csum = np.concatenate([[0.0], np.cumsum(x)])
        assert (csum[pdn.node_end] - csum[pdn.node_start] <= scaled + 1e-6).all()
    assert ctl.rebuild_count() == 1 and len(ctl.history) == 0


def test_batched_incremental_skip_and_dirty_lane():
    """The batched certify pass: an identical batch skips every lane (the
    all-skip assembly, no PDHG iteration), one dirty lane re-solves alone
    while the clean lanes hold; each step is the reference's."""
    kw = dict(gpus_per_server=4, l=200.0, u=700.0)
    jpdn = j_build_from_level_sizes([2, 2], **kw)
    pdn = build_from_level_sizes([2, 2], **kw)
    rng = np.random.default_rng(3)
    tb = rng.uniform(250, 650, (3, pdn.n))
    tb2 = tb.copy()
    tb2[1] *= 1.05
    jopts = JNvpaxOptions(incremental=True,
                          solver=JSolverOptions(eps_abs=1e-9, eps_rel=1e-9))
    tight = SolverOptions(eps_abs=1e-9, eps_rel=1e-9)
    opts = NvpaxOptions(incremental=True, solver=tight)
    jeng = JAllocEngine(jpdn, options=jopts)
    eng = AllocEngine(pdn, options=opts, device="cpu")
    jr = [jeng.step_batched(t) for t in (tb, tb, tb2)]
    r1, r2, r3 = (eng.step_batched(t) for t in (tb, tb, tb2))
    assert r1.stats["skipped"].shape == (3,) and not r1.stats["skipped"].any()
    assert r2.stats["skipped"].all() and r2.stats["certify_pass"].all()
    assert (r2.stats["iterations"] == 0).all()
    assert r2.stats["phase_iterations"].shape == (3, 3)
    assert np.abs(r2.allocation - r1.allocation).max() <= 1e-9
    assert list(r3.stats["skipped"]) == [True, False, True]
    np.testing.assert_array_equal(r3.stats["iterations"][[0, 2]], 0)
    for res, jres in zip((r1, r2, r3), jr):
        _assert_lanes(res, jres)
    ref = AllocEngine(pdn, options=NvpaxOptions(solver=tight), device="cpu").step_batched(tb2)
    assert np.abs(r3.allocation - ref.allocation).max() <= 1e-6
    assert eng.rebuild_count() == 1
