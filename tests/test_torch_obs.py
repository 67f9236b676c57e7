"""The port's flight recorder (``repro_torch.obs.recorder``, ``export``,
``report``) on the CPU, against the JAX reference's ``repro.obs``.

The same inputs, made from numpy seeds, go through both packages, and the
flushes are compared field by field: the integer fields, the counters and
the three histograms equal; the float fields within 1e-9 (watts, or the
KKT residual's units), the satisfaction ratio within 1e-12 relative; an
SLA margin of +inf (no tenant rows) on both sides.  The cases mirror
``tests/test_obs.py``: the ring's wraparound and partial fill, flush
idempotence and reset, the log buckets at their edges, every control plane
that records (engine, incremental engine with held rows, a deadline cut,
``step_batched`` lanes, ``optimize_batched``, stacked and loop fleets, a
tenant fleet across the cut, the controller, the simulator), a reference
state carried into the port at the wrap boundary, the exporters and the
report CLI byte for byte, and no rebuild while recording (the port's twin
of the reference's zero-retrace tests).  No wall-clock bar runs here: the
recorder's overhead is measured on the card (``chip_smoke.py`` phase 13).
"""

from __future__ import annotations

import contextlib
import io
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compat import enable_x64  # noqa: E402
from repro.core.batched import optimize_batched as j_optimize_batched  # noqa: E402
from repro.core.engine import AllocEngine as JAllocEngine  # noqa: E402
from repro.core.nvpax import NvpaxOptions as JNvpaxOptions  # noqa: E402
from repro.core.problem import AllocProblem as JAllocProblem  # noqa: E402
from repro.core.solver import SolverOptions as JSolverOptions  # noqa: E402
from repro.fleet import FleetOrchestrator as JFleetOrchestrator  # noqa: E402
from repro.obs import export as j_export  # noqa: E402
from repro.obs import recorder as j_recorder  # noqa: E402
from repro.obs import report as j_report  # noqa: E402
from repro.pdn.hierarchy_gen import homogeneous_fleet as j_homogeneous_fleet  # noqa: E402
from repro.pdn.tenants import TenantLayout as JTenantLayout  # noqa: E402
from repro.pdn.tenants import assign_tenants as j_assign_tenants  # noqa: E402
from repro.pdn.tree import build_from_level_sizes as j_build_from_level_sizes  # noqa: E402
from repro.power.controller import PowerController as JPowerController  # noqa: E402
from repro.power.simulator import DatacenterSim as JDatacenterSim  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.batched import optimize_batched  # noqa: E402
from repro_torch.core.engine import AllocEngine  # noqa: E402
from repro_torch.core.nvpax import NvpaxOptions  # noqa: E402
from repro_torch.core.problem import AllocProblem  # noqa: E402
from repro_torch.core.solver import SolverOptions  # noqa: E402
from repro_torch.fleet import FleetOrchestrator  # noqa: E402
from repro_torch.obs import export, recorder, report  # noqa: E402
from repro_torch.pdn.hierarchy_gen import homogeneous_fleet  # noqa: E402
from repro_torch.pdn.tenants import TenantLayout, assign_tenants  # noqa: E402
from repro_torch.pdn.tree import build_from_level_sizes  # noqa: E402
from repro_torch.power import DatacenterSim, PowerController  # noqa: E402

ATOL = 1e-9
SAT_RTOL = 1e-12
SRC = Path(__file__).resolve().parent.parent / "src"
INT_FIELDS = ("step", "restarts", "iterations", "iter_p1", "iter_p2", "iter_p3", "tier",
              "skipped", "converged", "certified", "truncated")
TIGHT = dict(eps_abs=1e-9, eps_rel=1e-9)
# the tenant fleet's options, as tests/test_torch_fleet_sla.py runs it
SLA_SOLVER = dict(eps_abs=1e-11, eps_rel=1e-11, max_iters=20_000)


def _powers(n, steps, seed=0, lo=50.0, hi=800.0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(lo, hi, n) for _ in range(steps)]


def assert_same_flush(got: dict, want: dict, tag: str = "") -> None:
    """One lane's flush against the reference's, field by field."""
    assert set(got) == set(want), tag
    for key in ("fields", "step", "capacity", "counters", "hist_lo_exp"):
        assert got[key] == want[key], f"{tag} {key}: {got[key]} != {want[key]}"
    for key in ("hist_kkt", "hist_move", "solver_hist"):
        assert got[key].dtype == np.int32, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=f"{tag} {key}")
    g, w = got["rows"], np.asarray(want["rows"])
    assert g.shape == w.shape and g.dtype == w.dtype, tag
    for j, name in enumerate(recorder.FIELDS):
        msg = f"{tag} {name}"
        if name in INT_FIELDS:
            np.testing.assert_array_equal(g[:, j], w[:, j], err_msg=msg)
        elif name == "satisfaction":
            np.testing.assert_allclose(g[:, j], w[:, j], rtol=SAT_RTOL, atol=0, err_msg=msg)
        else:  # equal infinities (no tenant rows) pass
            np.testing.assert_allclose(g[:, j], w[:, j], rtol=0, atol=ATOL, err_msg=msg)


def assert_same_lanes(got: list, want: list, tag: str = "") -> None:
    assert len(got) == len(want), tag
    for k, (g, w) in enumerate(zip(got, want)):
        if not w:  # a loop-mode domain that never stepped
            assert g == {}, f"{tag} lane {k}"
        else:
            assert_same_flush(g, w, f"{tag} lane {k}")


@pytest.fixture(scope="module")
def pdns():
    """(reference, port): 2 halls x 3 racks x 2 servers x 4 = 48 devices."""
    return (j_build_from_level_sizes([2, 3, 2], gpus_per_server=4),
            build_from_level_sizes([2, 3, 2], gpus_per_server=4))


@pytest.fixture(scope="module")
def engine_flights(pdns):
    """Engines of both packages stepped on the same telemetry: a capacity-4
    ring over 7 steps (wrapped) and a capacity-8 ring over 3 (partial)."""
    jpdn, pdn = pdns
    out = {}
    for cap, steps in ((4, 7), (8, 3)):
        eng = AllocEngine(pdn, recorder=recorder.RecorderConfig(capacity=cap), device="cpu")
        jeng = JAllocEngine(jpdn, recorder=j_recorder.RecorderConfig(capacity=cap))
        results = []
        for p in _powers(pdn.n, steps):
            results.append(eng.step(p))
            jeng.step(p)
        out[cap] = (eng, jeng, results)
    return out


# -- the ring and the histograms ---------------------------------------------


def test_ring_wraparound_matches_reference(engine_flights):
    """7 steps into a capacity-4 ring: rows 3..6 survive, oldest first;
    counters span all 7 steps; rows, counters and histograms the
    reference's."""
    eng, jeng, results = engine_flights[4]
    flight = eng.flush_recorder()["step"]
    assert_same_flush(flight, jeng.flush_recorder()["step"], "wrapped")
    assert flight["counters"]["n_steps"] == 7
    rows = recorder.rows_as_dicts(flight)
    assert [r["step"] for r in rows] == [3, 4, 5, 6]
    # the host oracle, from the results the engine returned
    for r, res in zip(rows, results[3:]):
        assert r["iterations"] == res.stats["total_iterations"]
        assert r["skipped"] == int(res.stats["skipped"])
        assert r["converged"] == int(res.stats["converged"])
        assert abs(r["alloc_W"] - float(res.allocation.sum())) <= ATOL
    for t in range(4, 7):
        move = float(np.abs(results[t].allocation - results[t - 1].allocation).max())
        assert abs(rows[t - 3]["grant_move"] - move) <= ATOL


def test_partial_ring_matches_reference(engine_flights):
    eng, jeng, _ = engine_flights[8]
    flight = eng.flush_recorder()["step"]
    assert_same_flush(flight, jeng.flush_recorder()["step"], "partial")
    assert flight["rows"].shape == (3, len(recorder.FIELDS))
    assert flight["rows"][:, 0].tolist() == [0.0, 1.0, 2.0]
    assert flight["rows"][0, recorder.FIELDS.index("grant_move")] == 0.0


def test_flush_idempotent_and_reset_clears(pdns):
    jpdn, pdn = pdns
    eng = AllocEngine(pdn, recorder=True, device="cpu")
    jeng = JAllocEngine(jpdn, recorder=True)
    powers = _powers(pdn.n, 3, seed=1)
    for p in powers[:2]:
        eng.step(p)
        jeng.step(p)
    a, b = eng.flush_recorder()["step"], eng.flush_recorder()["step"]
    assert_same_flush(a, b, "idempotent")
    assert_same_flush(eng.flush_recorder(reset=True)["step"],
                      jeng.flush_recorder(reset=True)["step"], "before reset")
    assert eng.flush_recorder() == {} == jeng.flush_recorder()
    eng.step(powers[2])  # lazily re-made
    jeng.step(powers[2])
    after = eng.flush_recorder()["step"]
    assert after["counters"]["n_steps"] == 1
    assert_same_flush(after, jeng.flush_recorder()["step"], "after reset")
    assert AllocEngine(pdn, device="cpu").flush_recorder() is None
    assert eng.recorder_config == recorder.RecorderConfig()


def _bucket_values(dtype):
    """The reference test's edge values, each power of ten from 1e-14 to
    1e5 with its ``nextafter`` neighbours, and a log-uniform sweep."""
    vals = [0.0, 9.99e-12, 1e-30, 1e30, np.inf]
    for e in range(-14, 6):
        v = dtype(f"1e{e}")
        vals += [v, np.nextafter(v, dtype(0)), np.nextafter(v, dtype(np.inf))]
    sweep = 10.0 ** np.random.default_rng(0).uniform(-14, 6, 20_000)
    return np.concatenate([np.array(vals, dtype), sweep.astype(dtype)])


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["float32", "float64"])
def test_log_bucket_edges_match_reference(dtype):
    """Bucket b holds [10**(lo+b), 10**(lo+b+1)); zero floors, huge clips;
    at every power of ten and its neighbours the reference's bucket (whose
    log10 rounds either side of an exact power: float32 1e-9 lands in
    bucket 2, float64 1e2 - 1 ulp in 13)."""
    cfg = recorder.RecorderConfig()
    v = _bucket_values(dtype)
    with enable_x64(True):
        want = np.asarray(jax.jit(jax.vmap(
            lambda x: j_recorder.log_bucket(x, j_recorder.RecorderConfig())))(jnp.asarray(v)))
    got = recorder.log_bucket(torch.as_tensor(v), cfg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)

    def bucket(x):
        return int(recorder.log_bucket(torch.tensor(x, dtype=torch.from_numpy(v).dtype), cfg))

    assert bucket(0.0) == bucket(1e-12) == bucket(9.99e-12) == 0
    assert bucket(1e-11) == 1 and bucket(1.0) == 12
    assert bucket(1e30) == bucket(float("inf")) == cfg.buckets - 1


def _synthetic_step(rng, n, lanes):
    """One step's stats, allocation, request and margin from ``rng``, as
    the reference's traced values and the port's host values and tensors."""
    shape = () if lanes is None else (lanes,)
    ints = {k: rng.integers(0, 500, shape) for k in
            ("restarts", "iterations", "iterations_p1", "iterations_p2", "iterations_p3")}
    flags = {k: rng.random(shape) < 0.5 for k in
             ("skipped", "certify_pass", "converged", "kkt_certified", "truncated")}
    kkt = 10.0 ** rng.uniform(-14, 2, shape)
    hist = rng.integers(0, 9, shape + (16,)).astype(np.int32)
    alloc = rng.uniform(100.0, 700.0, shape + (n,))
    r = rng.uniform(0.0, 800.0, shape + (n,))
    margin = rng.normal(0.0, 50.0, shape)
    jstats = {k: jnp.asarray(v) for k, v in {**ints, **flags}.items()}
    jstats.update(kkt_res=jnp.asarray(kkt), kkt_hist=jnp.asarray(hist))
    tstats = {**ints, **flags}
    tstats.update(kkt_res=torch.as_tensor(kkt).reshape(shape + (1,) if lanes else ()),
                  kkt_hist=torch.as_tensor(hist))
    return (jstats, jnp.asarray(alloc), jnp.asarray(r), jnp.asarray(margin),
            tstats, torch.as_tensor(alloc), torch.as_tensor(r), torch.as_tensor(margin))


@pytest.mark.parametrize("lanes", [None, 3], ids=["one", "lanes"])
def test_state_from_numpy_appends_at_the_wrap_boundary(lanes):
    """A reference ring filled to its capacity (the cursor back at row 0),
    carried into the port, then one more row appended by both packages from
    the same gauges: the port's flush is the reference's."""
    cfg = recorder.RecorderConfig(capacity=4)
    jcfg = j_recorder.RecorderConfig(capacity=4)
    n = 12
    rng = np.random.default_rng(7)
    with enable_x64(True):
        if lanes is None:
            jst = j_recorder.init_state(jcfg, n)
            metrics, rec = j_recorder.step_metrics, j_recorder.record_step
        else:
            jst = j_recorder.init_batch(jcfg, lanes, n)
            metrics = jax.vmap(j_recorder.step_metrics)
            rec = jax.vmap(lambda s, m, a: j_recorder.record_step(jcfg, s, m, a))
        for _ in range(4):
            js, ja, jr, jm, *_ = _synthetic_step(rng, n, lanes)
            jst = (rec(jst, metrics(js, ja, jr, jm), ja) if lanes
                   else rec(jcfg, jst, metrics(js, ja, jr, jm), ja))
        st = convert.recorder_state_from_numpy(
            {f: np.asarray(getattr(jst, f)) for f in jst._fields}, device="cpu")
        js, ja, jr, jm, ts, ta, tr, tm = _synthetic_step(rng, n, lanes)
        jst = (rec(jst, metrics(js, ja, jr, jm), ja) if lanes
               else rec(jcfg, jst, metrics(js, ja, jr, jm), ja))
        jst = jax.tree_util.tree_map(np.asarray, jst)
    before = int(st.step.reshape(-1)[0])
    assert before == 4
    out = recorder.record_step(cfg, st, recorder.step_metrics(ts, ta, tr, tm), ta)
    assert out is st
    if lanes is None:
        assert_same_flush(recorder.flush(st, cfg), j_recorder.flush(jst, jcfg), "one")
    else:
        assert_same_lanes(recorder.flush_lanes(st, cfg), j_recorder.flush_lanes(jst, jcfg),
                          "lanes")
    # written in place, each lane in a buffer of its own (no broadcast view)
    assert out.ring is st.ring and st.ring.stride(0) != 0


def test_static_metrics_record_the_reference_rows():
    """Gauges loaded into one set of static buffers (a CUDA-graph capture's
    inputs) before each of 6 appends to a capacity-4 ring: the flush is the
    reference's over the same steps, and the buffers stay the same."""
    cfg = recorder.RecorderConfig(capacity=4)
    jcfg = j_recorder.RecorderConfig(capacity=4)
    n = 12
    rng = np.random.default_rng(11)
    static = recorder.static_metrics(cfg, device="cpu")
    ptrs = [t.data_ptr() for t in static]
    alloc = torch.zeros(n, dtype=torch.float64)
    st = recorder.init_state(cfg, n, device="cpu")
    with enable_x64(True):
        jst = j_recorder.init_state(jcfg, n)
        for _ in range(6):
            js, ja, jr, jm, ts, ta, tr, tm = _synthetic_step(rng, n, None)
            jst = j_recorder.record_step(jcfg, jst, j_recorder.step_metrics(js, ja, jr, jm), ja)
            recorder.copy_metrics(static, recorder.step_metrics(ts, ta, tr, tm))
            alloc.copy_(ta)
            recorder.record_step(cfg, st, static, alloc)
        jst = jax.tree_util.tree_map(np.asarray, jst)
    assert [t.data_ptr() for t in static] == ptrs
    assert_same_flush(recorder.flush(st, cfg), j_recorder.flush(jst, jcfg), "static")


def test_recording_never_reads_a_device_value_back():
    """The host gauges must be host values: a tensor among them raises
    instead of being read back."""
    n = 4
    stats = {k: 0 for k in ("restarts", "iterations", "iterations_p1", "iterations_p2",
                            "iterations_p3", "skipped", "certify_pass", "converged",
                            "kkt_certified", "truncated")}
    stats.update(kkt_res=torch.zeros(()), kkt_hist=torch.zeros(16, dtype=torch.int32))
    x = torch.ones(n, dtype=torch.float64)
    recorder.step_metrics(stats, x, x, torch.zeros((), dtype=torch.float64))
    with pytest.raises(TypeError, match="host value"):
        recorder.step_metrics({**stats, "iterations": torch.tensor(3)}, x, x,
                              torch.zeros((), dtype=torch.float64))


# -- the control planes ------------------------------------------------------


def test_incremental_engine_records_held_rows(pdns):
    """Incremental tenant engines of both packages over solve, full skip,
    Phase I reuse (a slack root-cap move), full skip, solve: tiers 0, 2, 1,
    2, 0 and every row the reference's, the tenant margin finite."""
    jpdn, pdn = pdns
    kw = dict(n_tenants=4, devices_per_tenant=8, seed=1)
    jlay, lay = j_assign_tenants(jpdn, **kw), assign_tenants(pdn, **kw)
    jeng = JAllocEngine(jpdn, sla=jlay.sla_topo(), priority=jlay.priority, recorder=True,
                        options=JNvpaxOptions(incremental=True,
                                              solver=JSolverOptions(**TIGHT)))
    eng = AllocEngine(pdn, sla=lay.sla_topo(device="cpu"), priority=lay.priority,
                      recorder=True, device="cpu",
                      options=NvpaxOptions(incremental=True, solver=SolverOptions(**TIGHT)))
    tele = np.random.default_rng(4).uniform(150, 450, pdn.n)  # root cap slack
    cap0 = float(pdn.node_cap[0])
    for event, x in [(None, tele), (None, tele), ("cap", tele), (None, tele),
                     (None, tele * 1.01)]:
        if event == "cap":
            for e in (jeng, eng):
                e.set_root_cap(cap0 - 50.0)
        eng.step(x)
        jeng.step(x)
    flight = eng.flush_recorder()["step"]
    assert_same_flush(flight, jeng.flush_recorder()["step"], "incremental")
    rows = recorder.rows_as_dicts(flight)
    assert [r["tier"] for r in rows] == [0, 2, 1, 2, 0]
    assert flight["counters"]["n_skipped"] == 2 and flight["counters"]["n_p1_skips"] == 1
    assert all(np.isfinite(r["sla_min_margin"]) for r in rows)
    # the record survives reset_warm (telemetry, not solver state)
    eng.reset_warm()
    assert eng.flush_recorder()["step"]["counters"]["n_steps"] == 5
    assert eng.rebuild_count() == 1


def test_deadline_cut_step_records_one_row(pdns):
    """A step cut by a deadline no solve can meet (Phase I runs, the
    refinement is cut) records one truncated row, the reference's; the
    deadline's calibration probes record nothing."""
    jpdn, pdn = pdns
    eng = AllocEngine(pdn, recorder=True, device="cpu")
    jeng = JAllocEngine(jpdn, recorder=True)
    for p, deadline in zip(_powers(pdn.n, 2, seed=2), (None, 1e-12)):
        res = eng.step(p, deadline_s=deadline)
        jeng.step(p, deadline_s=deadline)
    assert res.stats["truncated"]
    flight = eng.flush_recorder()["step"]
    assert_same_flush(flight, jeng.flush_recorder()["step"], "deadline")
    assert [r["truncated"] for r in recorder.rows_as_dicts(flight)] == [0, 1]
    assert flight["counters"]["n_truncated"] == 1


def test_step_batched_lanes_match_reference(pdns):
    """K = 3 lanes over 4 steps, then K = 1: one record per batch size,
    each lane the reference's."""
    jpdn, pdn = pdns
    eng = AllocEngine(pdn, recorder=True, device="cpu")
    jeng = JAllocEngine(jpdn, recorder=True)
    tele = [np.stack([p * (1.0 + 0.1 * k) for k in range(3)])
            for p in _powers(pdn.n, 4, seed=3)]
    for tb in tele + [tele[0][:1]]:
        eng.step_batched(tb)
        jeng.step_batched(tb)
    got, want = eng.flush_recorder(), jeng.flush_recorder()
    assert set(got) == {"batched"} and sorted(got["batched"]) == [1, 3]
    for K in (1, 3):
        assert_same_lanes(got["batched"][K], want["batched"][K], f"K={K}")
    assert [lane["counters"]["n_steps"] for lane in got["batched"][3]] == [4, 4, 4]
    assert eng.rebuild_count() == 1


def test_optimize_batched_records_each_lane(pdns):
    """``optimize_batched(rec=, rec_cfg=)`` advances the per-lane state in
    place and returns it as ``res.recorder``, each lane the reference's."""
    jpdn, pdn = pdns
    cfg, jcfg = recorder.RecorderConfig(capacity=8), j_recorder.RecorderConfig(capacity=8)
    tele = _powers(pdn.n, 2, seed=6)
    rec = recorder.init_batch(cfg, 2, pdn.n, device="cpu")
    res = optimize_batched([AllocProblem.build(pdn, t, device="cpu") for t in tele],
                           rec=rec, rec_cfg=cfg)
    assert res.recorder is rec
    with enable_x64(True):
        jres = j_optimize_batched([JAllocProblem.build(jpdn, t) for t in tele],
                                  rec=j_recorder.init_batch(jcfg, 2, pdn.n), rec_cfg=jcfg)
    assert_same_lanes(recorder.flush_lanes(rec, cfg),
                      j_recorder.flush_lanes(jres.recorder, jcfg), "optimize_batched")


@pytest.mark.parametrize("mode", ["stacked", "loop"])
def test_fleet_flights_match_reference(pdns, mode):
    """Three steps of the 2-hall fleet: one [K, ...] state recorded in one
    update (stacked) or each domain engine's own (loop), every lane the
    reference's; no rebuild while recording."""
    jpdn, pdn = pdns
    orch = FleetOrchestrator(pdn, level=1, mode=mode, recorder=True, device="cpu")
    jorch = JFleetOrchestrator(jpdn, level=1, mode=mode, recorder=True)
    built = orch.rebuild_count()
    for p in _powers(pdn.n, 3, seed=5):
        orch.step(p)
        jorch.step(p)
    got, want = orch.flush_recorder(), jorch.flush_recorder()
    assert got["mode"] == want["mode"] == mode
    assert_same_lanes(got["lanes"], want["lanes"], mode)
    assert [lane["counters"]["n_steps"] for lane in got["lanes"]] == [3, 3]
    assert orch.rebuild_count() == built
    orch.flush_recorder(reset=True)
    assert orch.flush_recorder() == {"mode": mode, "lanes": [] if mode == "stacked"
                                     else [{}, {}]}


def _cross_layout(pdn, cls):
    """One tenant across the cut (domains 0 and 1) and one inside domain 0
    (``tests/test_torch_fleet_sla.py``'s layout)."""
    tenant_of = np.full(pdn.n, -1, np.int32)
    tenant_of[[0, 1, 16, 17]] = 0
    tenant_of[[4, 5, 6]] = 1
    b_min, b_max = np.zeros(2), np.zeros(2)
    for t in range(2):
        umax = pdn.dev_u[tenant_of == t].sum()
        b_min[t], b_max[t] = 0.35 * umax, 0.55 * umax
    return cls(tenant_of, 2, b_min, b_max, np.ones(pdn.n, np.int32))


def test_tenant_fleet_margin_across_the_cut():
    """A cold stacked step of a 2-domain fleet with a tenant split at the
    cut: each lane's SLA margin (its pad edges on the inert ``lo = 0`` row
    included) and the rest of its row the reference's."""
    kw = dict(domain_oversub=1.15, root_oversub=1.0)
    jpdn, pdn = j_homogeneous_fleet(2, **kw), homogeneous_fleet(2, **kw)
    orch = FleetOrchestrator(pdn, level=1, tenants=_cross_layout(pdn, TenantLayout),
                             mode="stacked", recorder=True, device="cpu",
                             options=NvpaxOptions(solver=SolverOptions(**SLA_SOLVER)))
    jorch = JFleetOrchestrator(jpdn, level=1, tenants=_cross_layout(jpdn, JTenantLayout),
                               mode="stacked", recorder=True,
                               options=JNvpaxOptions(solver=JSolverOptions(**SLA_SOLVER)))
    tele = np.random.default_rng(0).uniform(250, 400, pdn.n)
    orch.step(tele)
    jorch.step(tele)
    got = orch.flush_recorder()["lanes"]
    assert_same_lanes(got, jorch.flush_recorder()["lanes"], "tenant fleet")
    i = recorder.FIELDS.index("sla_min_margin")
    for k, lane in enumerate(got):
        margin = lane["rows"][0, i]
        assert np.isfinite(margin) and margin >= -1e-6, (k, margin)


def test_controller_flush_recorder_matches_reference(pdns):
    jpdn, pdn = pdns
    ctl = PowerController(pdn, recorder=True, device="cpu")
    jctl = JPowerController(jpdn, recorder=True)
    assert ctl.flush_recorder() is None  # no engine step yet
    for p in _powers(pdn.n, 2, seed=8):
        ctl.step(p)
        jctl.step(p)
    assert_same_flush(ctl.flush_recorder()["step"], jctl.flush_recorder()["step"],
                      "controller")
    assert ctl.rebuild_count() == 1
    assert PowerController(pdn, device="cpu").flush_recorder() is None


@pytest.fixture(scope="module")
def sim_flights(pdns):
    """``DatacenterSim`` of both packages, 3 intervals, recording."""
    jpdn, pdn = pdns
    sim = DatacenterSim.build(pdn, seed=3, recorder=True, device="cpu")
    jsim = JDatacenterSim.build(jpdn, seed=3, recorder=True)
    out = sim.run(3, baselines=False)
    jsim.run(3, baselines=False)
    return sim.flush_flight()["step"], jsim.flush_flight()["step"], out["wall_ms"]


def test_simulator_flush_flight_matches_reference(sim_flights, pdns):
    got, want, _ = sim_flights
    assert_same_flush(got, want, "simulator")
    assert got["counters"]["n_steps"] == 3
    assert DatacenterSim.build(pdns[1], seed=3, device="cpu").flush_flight() is None


# -- the exporters and the report CLI ------------------------------------------


def test_exporters_match_reference_byte_for_byte(sim_flights, pdns, tmp_path):
    """For the same flushes (one lane and a fleet's lanes), the port's rows,
    JSONL, Prometheus text and summaries are the reference's."""
    _, want, walls = sim_flights
    jpdn, _ = pdns
    jorch = JFleetOrchestrator(jpdn, level=1, mode="stacked", recorder=True)
    for p in _powers(jpdn.n, 2, seed=9):
        jorch.step(p)
    lanes = jorch.flush_recorder()["lanes"]
    for flushes, w in ((want, walls), (lanes, None), (lanes, [1.5, 2.5])):
        rows = export.flight_rows(flushes, walls_ms=w)
        assert rows == j_export.flight_rows(flushes, walls_ms=w)
        assert export.prometheus_text(flushes) == j_export.prometheus_text(flushes)
        assert (export.prometheus_text(flushes, prefix="nvpax")
                == j_export.prometheus_text(flushes, prefix="nvpax"))
        a, b = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
        assert export.write_jsonl(str(a), rows) == j_export.write_jsonl(str(b), rows)
        assert a.read_bytes() == b.read_bytes()
        assert export.read_jsonl(str(a)) == rows
    s, js = export.StreamSummary(), j_export.StreamSummary()
    assert s.as_dict() == js.as_dict() and np.isnan(s.percentile(50))
    s.extend(walls)
    js.extend(walls)
    assert s.as_dict() == js.as_dict() and len(s) == len(js) == 3
    assert export.prometheus_text({**want, "rows": want["rows"][:0]}) == \
        j_export.prometheus_text({**want, "rows": want["rows"][:0]})


def _run_report(main, path, prom, monkeypatch) -> str:
    monkeypatch.chdir(path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["flight.jsonl", "--prom", prom]) == 0
    return buf.getvalue()


def test_report_cli_matches_reference(sim_flights, tmp_path, monkeypatch):
    """The report of the same JSONL, and its ``--prom`` file, byte for byte;
    ``python -m repro_torch.obs.report`` prints it too."""
    _, want, walls = sim_flights
    rows = j_export.flight_rows(want, walls_ms=walls)
    for sub in ("port", "ref", "cli"):
        (tmp_path / sub).mkdir()
        j_export.write_jsonl(str(tmp_path / sub / "flight.jsonl"), rows)
    got = _run_report(report.main, tmp_path / "port", "flight.prom", monkeypatch)
    ref = _run_report(j_report.main, tmp_path / "ref", "flight.prom", monkeypatch)
    assert got == ref
    assert got.startswith("flight record: 3 steps") and "interval wall:" in got
    assert ((tmp_path / "port" / "flight.prom").read_bytes()
            == (tmp_path / "ref" / "flight.prom").read_bytes())
    assert "repro_steps_total 3" in (tmp_path / "port" / "flight.prom").read_text()
    assert report.summarize(rows) == j_report.summarize(rows)
    assert report.render(report.summarize([])) == j_report.render(j_report.summarize([]))
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", "flight.jsonl", "--prom",
         "flight.prom"], cwd=tmp_path / "cli", env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout == got
