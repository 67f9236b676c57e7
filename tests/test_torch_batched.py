"""The port's K-scenario program (``repro_torch.core.batched.optimize_batched``)
on the CPU, against the JAX reference's ``repro.core.batched.optimize_batched``
and host ``optimize``, and against the port's own one-scenario program.

The cases mirror ``tests/test_batched.py`` and the batched deadline cases
of ``tests/test_engine.py`` on the 48-device fleet: tree-only K = 4 (the
water-fill path), four scattered tenants K = 3 (the iterated-LP path, three
priority levels), the LP path against the water-fill path, the warm-start
round trip, ``stack_problems``' topology check, ``batch_meta``, and the
iteration budget and deadline.  Each reference program runs once per
module (every distinct program costs the reference a compile).

Bars: each lane agrees with the reference's lane and with the reference's
host ``optimize`` of that scenario to 1e-9 W, with equal per-phase
iteration counts; each lane of the port's K-lane solve gives the bits of
the port's one-scenario solve of that lane (the CPU's row reductions are
the vector's), with and without the kernel flags.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import batched as j_batched  # noqa: E402
from repro.core.nvpax import NvpaxOptions as JNvpaxOptions  # noqa: E402
from repro.core.nvpax import optimize as j_optimize  # noqa: E402
from repro.core.problem import AllocProblem as JAllocProblem  # noqa: E402
from repro.pdn.tenants import assign_tenants as j_assign_tenants  # noqa: E402
from repro.pdn.tree import build_from_level_sizes as j_build_from_level_sizes  # noqa: E402
from repro_torch.core import batched  # noqa: E402
from repro_torch.core.nvpax import NvpaxOptions  # noqa: E402
from repro_torch.core.problem import AllocProblem  # noqa: E402
from repro_torch.core.solver import SolverOptions  # noqa: E402
from repro_torch.pdn.tenants import assign_tenants  # noqa: E402
from repro_torch.pdn.tree import build_from_level_sizes  # noqa: E402

ATOL = 1e-9  # watts: port lanes vs the reference's lanes and host optimize
# every kernel flag: on the CPU each kernel's plain version, on lanes
FLAGS = dict(use_pallas=True, use_pallas_tree=True, use_pallas_stats=True)


def _tree_feasible(pdn, x, tol=1e-6):
    csum = np.concatenate([[0.0], np.cumsum(x)])
    return (csum[pdn.node_end] - csum[pdn.node_start] <= pdn.node_cap + tol).all()


class Case:
    """One set of scenarios, built in both packages from the same numpy
    draws; the reference's results are computed once and kept."""

    def __init__(self, tenants: bool, seed: int, k: int, lo: float, hi: float):
        self.jpdn = j_build_from_level_sizes([2, 3, 2], gpus_per_server=4)  # n = 48
        self.pdn = build_from_level_sizes([2, 3, 2], gpus_per_server=4)
        self.reqs = np.random.default_rng(seed).uniform(lo, hi, (k, self.pdn.n))
        jkw, kw = {}, {}
        self.layout = None
        if tenants:
            lay_kw = dict(n_tenants=4, devices_per_tenant=8, seed=1)
            self.jlayout = j_assign_tenants(self.jpdn, **lay_kw)
            self.layout = assign_tenants(self.pdn, **lay_kw)
            jkw = dict(sla=self.jlayout.sla_topo(), priority=self.jlayout.priority)
            kw = dict(sla=self.layout.sla_topo(device="cpu"), priority=self.layout.priority)
        self.japs = [JAllocProblem.build(self.jpdn, r, **jkw) for r in self.reqs]
        self.aps = [AllocProblem.build(self.pdn, r, device="cpu", **kw) for r in self.reqs]
        self._ref = {}

    def ref(self, key, fn):
        if key not in self._ref:
            self._ref[key] = fn()
        return self._ref[key]

    def ref_batched(self, **kw):
        return self.ref(("batched", tuple(sorted(kw.items()))),
                        lambda: j_batched.optimize_batched(self.japs, **kw))

    def ref_host(self):
        return self.ref("host", lambda: [j_optimize(ap) for ap in self.japs])


@pytest.fixture(scope="module")
def tree_case():
    return Case(tenants=False, seed=0, k=4, lo=50.0, hi=650.0)


@pytest.fixture(scope="module")
def sla_case():
    return Case(tenants=True, seed=1, k=3, lo=100.0, hi=650.0)


@pytest.fixture(scope="module", params=["tree", "sla"])
def case(request, tree_case, sla_case):
    return tree_case if request.param == "tree" else sla_case


def port(case, **flags):
    """The port's K-lane solve of the case, once per set of flags."""
    opts = NvpaxOptions(solver=SolverOptions(**flags))
    return case.ref(("port", tuple(sorted(flags.items()))),
                    lambda: batched.optimize_batched(case.aps, opts))


def _assert_lanes(res, jres, msg=""):
    np.testing.assert_allclose(res.allocation, np.asarray(jres.allocation), rtol=0, atol=ATOL,
                               err_msg=msg)
    np.testing.assert_allclose(res.phase1, np.asarray(jres.phase1), rtol=0, atol=ATOL,
                               err_msg=msg)
    np.testing.assert_allclose(res.phase2, np.asarray(jres.phase2), rtol=0, atol=ATOL,
                               err_msg=msg)
    for key in ("phase_iterations", "solves", "converged", "kkt_certified", "truncated",
                "restarts", "skipped", "certify_pass", "kkt_hist"):
        np.testing.assert_array_equal(res.stats[key], np.asarray(jres.stats[key]),
                                      err_msg=f"{msg} {key}")


def test_lanes_match_reference_batched(case):
    res = port(case)
    jres = case.ref_batched()
    assert res.allocation.shape == (len(case.reqs), case.pdn.n)
    assert res.stats["converged"].all()
    assert res.stats["n_scenarios"] == len(case.reqs)
    _assert_lanes(res, jres)
    for x in res.allocation:
        assert _tree_feasible(case.pdn, x)


def test_lanes_match_reference_host_optimize(case):
    res = port(case)
    for k, jr in enumerate(case.ref_host()):
        np.testing.assert_allclose(res.allocation[k], jr.allocation, rtol=0, atol=ATOL,
                                   err_msg=f"scenario {k}")
        np.testing.assert_allclose(res.phase1[k], jr.phase1, rtol=0, atol=ATOL)
        assert list(res.stats["phase_iterations"][k]) == list(jr.stats["phase_iterations"])


@pytest.mark.parametrize("flags", [{}, FLAGS], ids=["plain", "kernel-flags"])
def test_each_lane_is_its_one_scenario_solve(case, flags):
    """Every lane of the K-lane solve has the bits and counts of the
    one-scenario program on that lane (the same launches, on one lane)."""
    res = port(case, **flags)
    opts = SolverOptions(**flags)
    meta = batched.batch_meta(batched.stack_problems(case.aps), NvpaxOptions())
    for k, ap in enumerate(case.aps):
        x1, x2, x3, warm, st = batched.solve_three_phase(ap, meta, opts)
        np.testing.assert_array_equal(res.allocation[k], x3.numpy())
        np.testing.assert_array_equal(res.phase1[k], x1.numpy())
        np.testing.assert_array_equal(res.phase2[k], x2.numpy())
        assert list(res.stats["phase_iterations"][k]) == [st[f"iterations_p{i}"]
                                                          for i in (1, 2, 3)]
        assert res.stats["restarts"][k] == st["restarts"]
        np.testing.assert_array_equal(res.stats["kkt_hist"][k], st["kkt_hist"].numpy())
        for lane_leaf, leaf in zip(res.warm_state.p3, warm.p3):
            np.testing.assert_array_equal(lane_leaf[k].numpy(), leaf.reshape(-1).numpy())


def test_sla_lanes_respect_tenant_bounds(sla_case):
    res = port(sla_case)
    lay = sla_case.layout
    owned = lay.tenant_of >= 0
    assert len(batched.batch_meta(batched.stack_problems(sla_case.aps), NvpaxOptions()).levels) == 3
    for x in res.allocation:
        agg = np.bincount(lay.tenant_of[owned], weights=x[owned], minlength=lay.n_tenants)
        assert (agg <= lay.b_max + 1e-6).all()


@pytest.fixture(scope="module")
def lp_case():
    return Case(tenants=False, seed=2, k=2, lo=150.0, hi=500.0)


def test_lp_path_matches_waterfill_path(lp_case):
    """The iterated max-min LP rounds (lanes stopping on their own rounds)
    reach the water-fill's allocation, and each lane is the reference's."""
    res_wf = batched.optimize_batched(lp_case.aps, NvpaxOptions(use_waterfill=True))
    res_lp = batched.optimize_batched(lp_case.aps, NvpaxOptions(use_waterfill=False))
    np.testing.assert_allclose(res_wf.allocation, res_lp.allocation, atol=0.05)
    jres = lp_case.ref_batched(options=JNvpaxOptions(use_waterfill=False))
    _assert_lanes(res_lp, jres, "LP path")


def test_warm_start_roundtrip(case):
    """The warm state of one batched call is taken by the next, and the
    warm-started lanes are the reference's warm-started lanes (counts
    included).  Without tenants the solution holds (the reference's own
    check); with them the ε-degenerate max-min LPs may take another vertex
    of equal quality, as the reference's do."""
    first = port(case)
    second = batched.optimize_batched(case.aps, warm=first.warm_state)
    if case.layout is None:
        np.testing.assert_allclose(second.allocation, first.allocation, atol=1e-4)
    sla_case = case
    jfirst = sla_case.ref_batched()
    jsecond = sla_case.ref(
        "warm", lambda: j_batched.optimize_batched(sla_case.japs, warm=jfirst.warm_state))
    _assert_lanes(second, jsecond, "warm")
    for p in ("p1", "p2", "p3"):
        for leaf, jleaf in zip(getattr(second.warm_state, p), getattr(jsecond.warm_state, p)):
            jleaf = np.asarray(jleaf)
            np.testing.assert_allclose(leaf.numpy().reshape(jleaf.shape), jleaf, rtol=0,
                                       atol=1e-6)


def test_stack_problems_rejects_topology_mismatch(tree_case):
    other = build_from_level_sizes([2, 2, 2], gpus_per_server=4)
    a = AllocProblem.build(tree_case.pdn, np.full(tree_case.pdn.n, 300.0), device="cpu")
    b = AllocProblem.build(other, np.full(other.n, 300.0), device="cpu")
    with pytest.raises(ValueError):
        batched.stack_problems([a, b])
    with pytest.raises(ValueError):
        batched.stack_problems([])
    with pytest.raises(ValueError):
        batched.optimize_batched(a)  # not stacked


def test_stack_problems_shares_one_topology(tree_case):
    """Scenarios built on one prebuilt topology stack without a compare;
    the stacked leaves are [K, n] and the topology is the shared one."""
    from repro_torch.core.problem import FleetTopology

    topo = FleetTopology.from_pdn(tree_case.pdn, device="cpu")
    aps = [AllocProblem.build(tree_case.pdn, r, topology=topo) for r in tree_case.reqs]
    st = batched.stack_problems(aps)
    assert st.l.shape == (len(aps), tree_case.pdn.n) and st.tree is topo.tree


def test_batch_meta_is_static_and_hashable(tree_case):
    a = tree_case.aps[0]
    meta = batched.batch_meta(batched.stack_problems([a, a]), NvpaxOptions())
    assert isinstance(meta, batched.BatchMeta)
    hash(meta)
    assert meta.n_depths == 4  # root + 3 internal levels
    assert meta.levels == (1,)


def test_iter_budget_truncates_to_phase1(sla_case):
    """Budget 1: the refinement phases never start, the allocation is Phase
    I's (feasible), every lane truncated; the reference's lanes too."""
    res = batched.optimize_batched(sla_case.aps, iter_budget=1)
    assert res.stats["truncated"].all()
    np.testing.assert_array_equal(res.allocation, res.phase1)
    for x in res.allocation:
        assert _tree_feasible(sla_case.pdn, x)
    _assert_lanes(res, sla_case.ref_batched(iter_budget=1), "budget 1")


def test_iter_budget_large_matches_unbudgeted(sla_case):
    budgeted = batched.optimize_batched(sla_case.aps, iter_budget=10**8)
    assert not budgeted.stats["truncated"].any()
    np.testing.assert_array_equal(budgeted.allocation, port(sla_case).allocation)
    assert budgeted.stats["iter_budget"] == 10**8


def test_iter_budget_cuts_lanes_mid_phase(sla_case):
    """A budget inside Phase II cuts each lane at its own saturation round:
    the lanes are the reference's at the same budget."""
    budget = 1_000
    res = batched.optimize_batched(sla_case.aps, iter_budget=budget)
    jres = sla_case.ref_batched(iter_budget=budget)
    _assert_lanes(res, jres, "budget 1000")
    assert res.stats["truncated"].any()


def test_deadline_s_honored(sla_case):
    """``options.deadline_s`` drives the calibrated iteration budget: a tiny
    deadline truncates every lane, a generous one none."""
    tiny = batched.optimize_batched(sla_case.aps, NvpaxOptions(deadline_s=1e-7))
    assert tiny.stats["truncated"].all()
    assert tiny.stats["iter_budget"] is not None
    roomy = batched.optimize_batched(sla_case.aps, NvpaxOptions(deadline_s=600.0))
    assert not roomy.stats["truncated"].any()
    model = batched.calibrate_phase_cost(batched.stack_problems(sla_case.aps),
                                         batched.batch_meta(batched.stack_problems(sla_case.aps),
                                                            NvpaxOptions()),
                                         SolverOptions())
    assert model.p1_s > 0 and model.p23_s > 0


def test_optimize_batched_records_lanes(tree_case):
    """``rec``/``rec_cfg`` append one flight-record row per lane in place and
    hand the state back as ``res.recorder``; each lane's row holds that
    lane's iterations and granted watts (``tests/test_torch_obs.py`` holds
    the rows to the reference's)."""
    from repro_torch.obs import recorder

    cfg = recorder.RecorderConfig(capacity=4)
    rec = recorder.init_batch(cfg, len(tree_case.aps), tree_case.pdn.n, device="cpu")
    res = batched.optimize_batched(tree_case.aps, rec=rec, rec_cfg=cfg)
    assert res.recorder is rec
    lanes = recorder.flush_lanes(res.recorder, cfg)
    assert len(lanes) == len(tree_case.aps)
    for k, lane in enumerate(lanes):
        (row,) = recorder.rows_as_dicts(lane)
        assert row["step"] == 0 and row["tier"] == 0
        assert row["iterations"] == res.stats["iterations"][k]
        assert abs(row["alloc_W"] - res.allocation[k].sum()) <= ATOL
    # a state without its config is handed back untouched
    assert batched.optimize_batched(tree_case.aps, rec=rec).recorder is rec
    assert int(rec.step[0]) == 1
    assert batched.optimize_batched(tree_case.aps).recorder is None
