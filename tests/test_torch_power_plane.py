"""The port's power plane on the CPU, against the JAX reference: straggler
analysis, the trace-driven ``DatacenterSim`` (monolithic control plane, with
the Static and Greedy baselines), the controller in incremental mode, and
the host spans of ``obs.spans``.

Bars: the straggler numbers and every step's satisfaction ratios of the
three policies within 1e-9 of the reference's; incremental controller steps
with the reference's decisions and allocations within 1e-9 W.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.nvpax import NvpaxOptions as JNvpaxOptions  # noqa: E402
from repro.pdn.tenants import assign_tenants as j_assign_tenants  # noqa: E402
from repro.pdn.tree import build_from_level_sizes as j_build_from_level_sizes  # noqa: E402
from repro.power import straggler as j_straggler  # noqa: E402
from repro.power.controller import ControllerConfig as JControllerConfig  # noqa: E402
from repro.power.controller import PowerController as JPowerController  # noqa: E402
from repro.power.simulator import DatacenterSim as JDatacenterSim  # noqa: E402
from repro_torch.core.nvpax import NvpaxOptions  # noqa: E402
from repro_torch.obs import spans  # noqa: E402
from repro_torch.pdn.tenants import assign_tenants  # noqa: E402
from repro_torch.pdn.tree import build_from_level_sizes  # noqa: E402
from repro_torch.power import ControllerConfig, DatacenterSim, PowerController  # noqa: E402
from repro_torch.power import simulator as sim_mod  # noqa: E402
from repro_torch.power.straggler import job_slowdowns, straggler_report  # noqa: E402

S_TOL = 1e-9


@pytest.fixture(scope="module")
def fleets():
    """(reference pdn, port pdn): 2 halls x 3 racks x 2 servers x 4 = 48."""
    return (j_build_from_level_sizes([2, 3, 2], gpus_per_server=4),
            build_from_level_sizes([2, 3, 2], gpus_per_server=4))


# -- straggler ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = 96
    job_of = np.sort(rng.integers(0, 20, n))
    caps = rng.uniform(150, 700, n)
    np.testing.assert_allclose(job_slowdowns(caps, job_of),
                               j_straggler.job_slowdowns(caps, job_of), rtol=0, atol=1e-12)
    got, want = straggler_report(caps, job_of), j_straggler.straggler_report(caps, job_of)
    assert set(got) == set(want)
    for key in ("mean_tax", "max_tax", "p99_tax", "jobs"):
        assert abs(got[key] - want[key]) <= 1e-12, key
    np.testing.assert_allclose(got["tax"], want["tax"], rtol=0, atol=1e-12)


# -- DatacenterSim -----------------------------------------------------------


def _same_run(out, jout, steps):
    assert set(out) == set(jout)
    for key in ("S_nvpax", "S_static", "S_greedy", "straggler_tax", "sla_min_margin",
                "sla_min_margin_static"):
        if key in jout:
            assert out[key].shape == (steps,), key
            np.testing.assert_allclose(out[key], jout[key], rtol=0, atol=S_TOL, err_msg=key)
    np.testing.assert_array_equal(out["truncated"], jout["truncated"])
    assert out["wall_ms"].shape == (steps,) and (out["wall_ms"] > 0).all()


def test_datacenter_sim_matches_reference(fleets):
    jpdn, pdn = fleets
    steps = 4
    out = DatacenterSim.build(pdn, seed=3, device="cpu").run(steps)
    jout = JDatacenterSim.build(jpdn, seed=3).run(steps)
    _same_run(out, jout, steps)
    assert (out["S_nvpax"] >= out["S_static"] - 1e-9).all()
    assert (out["straggler_tax"] < 0.05).all()


def test_datacenter_sim_with_tenants_matches_reference(fleets):
    """Tenant SLAs on the simulator's default controller: the worst tenant
    lower-SLA margins of nvPAX and Static beside the three ratios."""
    jpdn, pdn = fleets
    kw = dict(n_tenants=4, devices_per_tenant=8, seed=1)
    steps = 2
    out = DatacenterSim.build(pdn, seed=5, tenants=assign_tenants(pdn, **kw),
                              device="cpu").run(steps)
    jout = JDatacenterSim.build(jpdn, seed=5, tenants=j_assign_tenants(jpdn, **kw)).run(steps)
    _same_run(out, jout, steps)
    assert (out["sla_min_margin"] >= -1e-6).all()


def test_datacenter_sim_hoists_static_baseline(fleets, monkeypatch):
    """``static_allocate`` is request-independent: one call per run."""
    _, pdn = fleets
    calls = {"n": 0}
    real = sim_mod.static_allocate

    def counting(p, requests=None):
        calls["n"] += 1
        return real(p, requests)

    monkeypatch.setattr(sim_mod, "static_allocate", counting)
    out = DatacenterSim.build(pdn, seed=3, device="cpu").run(4)
    assert out["S_static"].shape == (4,)
    assert calls["n"] == 1
    assert "S_static" not in DatacenterSim.build(pdn, seed=3, device="cpu").run(
        1, baselines=False)


def test_datacenter_sim_records_stage_spans(fleets):
    _, pdn = fleets
    spans.reset()
    spans.enable()
    try:
        DatacenterSim.build(pdn, seed=3, device="cpu").run(2)
        paths = [r["span"] for r in spans.drain()]
    finally:
        spans.disable()
    for stage in ("sim.telemetry", "sim.control", "sim.metrics"):
        assert paths.count(stage) == 2, stage


def test_fleet_modes_and_recorder_run(fleets):
    """The sharded fleet dispatch steps at one rank as the stacked one does;
    ``recorder=`` (item 10) records in both control planes the simulator
    builds, and without it ``flush_flight`` gives ``None``; fleet mode
    builds (``tests/test_torch_fleet.py`` holds it, the cross-tenant
    scenario and prefetch to the reference)."""
    from repro_torch.fleet import FleetOrchestrator

    _, pdn = fleets
    mono = DatacenterSim.build(pdn, seed=3, recorder=True, device="cpu")
    mono.run(1, baselines=False)
    assert mono.flush_flight()["step"]["counters"]["n_steps"] == 1
    stacked = DatacenterSim.build(pdn, seed=3, fleet_level=1, recorder=True, device="cpu")
    stacked.run(1, baselines=False)
    flight = stacked.flush_flight()
    assert flight["mode"] == "stacked" and len(flight["lanes"]) == 2
    tele = np.random.default_rng(3).uniform(100, 690, pdn.n)
    sharded = FleetOrchestrator(pdn, level=1, mode="sharded", device="cpu").step(tele)
    stacked = FleetOrchestrator(pdn, level=1, mode="stacked", device="cpu").step(tele)
    np.testing.assert_allclose(sharded.allocation, stacked.allocation, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(sharded.stats["phase_iterations"],
                                  stacked.stats["phase_iterations"])
    sim = DatacenterSim.build(pdn, device="cpu")
    assert sim.flush_flight() is None
    fleet = DatacenterSim.build(pdn, fleet_level=1, device="cpu")
    assert fleet.orchestrator.k == 2 and fleet.flush_flight() is None


def test_paper_scale_engine_waterfill_matches_reference_engine():
    """The paper fleet (n = 12,288) on the simulator's first two intervals
    (TelemetrySim seed 0, the scheduler's active mask, the controller's
    1.05 request margin): the port's engine gives the reference engine's
    allocations and hands out the whole root budget.  The reference's host
    ``optimize`` parts from its engine here by ~100 W per device: its numpy
    water-fill exits early (see ``repro_torch.core.waterfill.waterfill_torch``)."""
    from repro.core.engine import AllocEngine as JAllocEngine
    from repro.pdn.tree import build_datacenter as j_build_datacenter
    from repro_torch.core.engine import AllocEngine
    from repro_torch.pdn.telemetry import TelemetrySim, TraceConfig
    from repro_torch.pdn.tree import build_datacenter

    jpdn, pdn = j_build_datacenter(), build_datacenter()
    sim = TelemetrySim(TraceConfig(n_devices=pdn.n, seed=0))
    jeng, eng = JAllocEngine(jpdn), AllocEngine(pdn, device="cpu")
    for t in range(2):
        req, act = sim.power(t) * 1.05, sim.active_mask(t)
        res, jres = eng.step(req, active=act), jeng.step(req, active=act)
        np.testing.assert_allclose(res.allocation, jres.allocation, rtol=0, atol=1e-6)
        assert res.stats["phase_iterations"] == jres.stats["phase_iterations"]
        assert abs(res.allocation.sum() - pdn.node_cap[0]) <= 1e-6 * pdn.node_cap[0]


# -- the controller in incremental mode -------------------------------------


@pytest.mark.parametrize("use_engine", [True, False], ids=["engine", "legacy"])
def test_incremental_controller_matches_reference(fleets, use_engine):
    """``ControllerConfig(options=NvpaxOptions(incremental=True))`` reaches
    the engine: a held step skips, a moved one solves, as in the reference;
    the legacy rebuild-every-step path threads no anchor, as the
    reference's does not."""
    jpdn, pdn = fleets
    cfg = ControllerConfig(options=NvpaxOptions(incremental=True), use_engine=use_engine)
    jcfg = JControllerConfig(options=JNvpaxOptions(incremental=True), use_engine=use_engine)
    ctl = PowerController(pdn, config=cfg, device="cpu")
    jctl = JPowerController(jpdn, config=jcfg)
    rng = np.random.default_rng(6)
    tele = rng.uniform(200, 650, pdn.n)
    decisions = []
    for x in (tele, tele, tele * 1.01, tele * 1.01):
        res, jres = ctl.step(x), jctl.step(x)
        np.testing.assert_allclose(res.allocation, jres.allocation, rtol=0, atol=1e-9)
        for key in ("skipped", "certify_pass", "phase_iterations"):
            assert res.stats[key] == jres.stats[key], key
        decisions.append(res.stats["skipped"])
    assert decisions == ([False, True, False, True] if use_engine else [False] * 4)
    if use_engine:
        assert ctl.rebuild_count() == 1
        ctl.set_supply_scale(0.95)  # re-pin: drops the anchor with the warm state
        assert not ctl.step(tele).stats["certify_pass"] and ctl.rebuild_count() == 1


# -- host spans --------------------------------------------------------------


def test_spans_disabled_by_default_and_nest_when_enabled():
    spans.reset()
    with spans.span("never"):
        pass
    assert spans.drain() == []
    spans.enable()
    try:
        with spans.span("outer"):
            with spans.span("inner"):
                pass
            with spans.span("inner"):
                pass

        @spans.traced("deco")
        def work():
            with spans.span("leaf"):
                return 3

        assert work() == 3
        live = spans.summary()
        recs = spans.drain()
    finally:
        spans.disable()
    paths = [r["span"] for r in recs]
    assert paths == ["outer/inner", "outer/inner", "outer", "deco/leaf", "deco"]
    summ = spans.summary(recs)
    assert summ == live
    assert summ["outer/inner"]["count"] == 2
    assert summ["outer"]["total_ms"] >= summ["outer/inner"]["total_ms"]
    assert set(summ["outer"]) == {"count", "total_ms", "p50_ms", "p95_ms", "p99_ms"}
    assert not spans.enabled() and spans.drain() == []


def test_profile_trace_annotates_spans(tmp_path):
    """``profile_trace`` runs torch.profiler with span annotations and
    writes a Chrome trace holding each span's range; the span state before
    it is restored."""
    with spans.profile_trace(str(tmp_path)):
        assert spans.enabled()
        with spans.span("ctl"):
            with spans.span("solve"):
                torch.ones(8).sum()
    assert not spans.enabled()
    recs = spans.drain()
    assert [r["span"] for r in recs] == ["ctl/solve", "ctl"]
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"ctl", "ctl/solve"} <= names
