"""The port's certify-first incremental stepping on the CPU, against the JAX
reference (``repro.core.solver.certify``, ``optimize(carry=)``, the engine's
incremental anchor).

The cases mirror the host-path tiers of ``tests/test_incremental.py`` (full
skip on an identical step, a rejected demand move, a Phase I skip on a slack
cap move), each run through both packages on the same inputs, plus the
solved step that follows a skip, and the engine's warm carry after each
tier.  Bars: equal ``skipped``/``certify_pass``, equal per-phase PDHG
iterations, allocations within 1e-9 W.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compat import enable_x64  # noqa: E402
from repro.core.engine import AllocEngine as JAllocEngine  # noqa: E402
from repro.core.nvpax import NvpaxOptions as JNvpaxOptions  # noqa: E402
from repro.core.nvpax import optimize as j_optimize  # noqa: E402
from repro.core.problem import AllocProblem as JAllocProblem  # noqa: E402
from repro.core.solver import SolverOptions as JSolverOptions  # noqa: E402
from repro.pdn.tenants import assign_tenants as j_assign_tenants  # noqa: E402
from repro.pdn.tree import build_from_level_sizes as j_build_from_level_sizes  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import solver  # noqa: E402
from repro_torch.core.engine import AllocEngine  # noqa: E402
from repro_torch.core.nvpax import NvpaxOptions, optimize  # noqa: E402
from repro_torch.core.problem import AllocProblem  # noqa: E402
from repro_torch.core.solver import SolverOptions  # noqa: E402
from repro_torch.pdn.tenants import assign_tenants  # noqa: E402
from repro_torch.pdn.tree import build_from_level_sizes  # noqa: E402

ATOL = 1e-9  # watts
TIGHT = dict(eps_abs=1e-9, eps_rel=1e-9)
KERNELS = dict(use_pallas=True, use_pallas_tree=True, use_pallas_stats=True)
FLAGS = pytest.mark.parametrize("flags", [{}, KERNELS], ids=["plain", "kernels"])


def _options(flags, incremental=True):
    kw = {**TIGHT, **flags}
    return (
        JNvpaxOptions(incremental=incremental, solver=JSolverOptions(**kw)),
        NvpaxOptions(incremental=incremental, solver=SolverOptions(**kw)),
    )


def to_numpy(nt):
    if hasattr(nt, "_fields"):
        return {f: to_numpy(getattr(nt, f)) for f in nt._fields}
    return np.asarray(nt)


def small_pdn():
    return j_build_from_level_sizes([2, 2], gpus_per_server=4, l=200.0, u=700.0)


class Pair:
    """The same control steps through both packages' host ``optimize``,
    each threading its own warm state and incremental anchor."""

    def __init__(self, flags):
        self.jopts, self.topts = _options(flags)
        self.jres = self.tres = None

    def step(self, pdn, tele):
        with enable_x64(True):
            jap = JAllocProblem.build(pdn, tele)
            jres = j_optimize(
                jap, self.jopts,
                warm=self.jres and self.jres.warm_state, carry=self.jres and self.jres.carry,
            )
        tap = AllocProblem.build(pdn, tele, device="cpu")
        tres = optimize(
            tap, self.topts,
            warm=self.tres and self.tres.warm_state, carry=self.tres and self.tres.carry,
        )
        _assert_same(tres, jres)
        self.jres, self.tres = jres, tres
        return tres


def _assert_same(tres, jres, msg=""):
    for key in ("skipped", "certify_pass", "phase_iterations", "converged", "kkt_certified",
                "truncated"):
        assert tres.stats[key] == jres.stats[key], (msg, key, tres.stats[key], jres.stats[key])
    np.testing.assert_allclose(tres.allocation, jres.allocation, rtol=0, atol=ATOL, err_msg=msg)
    np.testing.assert_allclose(tres.phase1, jres.phase1, rtol=0, atol=ATOL, err_msg=msg)
    np.testing.assert_allclose(tres.phase2, jres.phase2, rtol=0, atol=ATOL, err_msg=msg)
    assert (tres.carry is None) == (jres.carry is None)
    if tres.carry is not None:
        _assert_tree_close(tres.carry, jres.carry, msg)


def _assert_tree_close(tleaf, jleaf, msg=""):
    """Every leaf of a NamedTuple tree (a carry, a warm state) within ATOL."""
    if hasattr(tleaf, "_fields"):
        for f in tleaf._fields:
            _assert_tree_close(getattr(tleaf, f), getattr(jleaf, f), f"{msg}.{f}")
        return
    t = tleaf.cpu().numpy() if isinstance(tleaf, torch.Tensor) else np.asarray(tleaf)
    j = np.asarray(jleaf)
    assert t.shape == j.shape, msg
    if t.dtype == bool:
        np.testing.assert_array_equal(t, j, err_msg=msg)
    else:
        np.testing.assert_allclose(t, j, rtol=0, atol=ATOL, err_msg=msg)


# -- certify tiers (host path) ---------------------------------------------


@FLAGS
def test_full_skip_on_identical_step(flags):
    """The identical step certifies in both packages and returns the carried
    allocation; the warm state that comes back is the incoming one, so the
    solved step after it starts where the reference's does."""
    pdn = small_pdn()
    tele = np.random.default_rng(0).uniform(250, 650, pdn.n)
    pair = Pair(flags)
    res = pair.step(pdn, tele)
    assert res.carry is not None and not res.stats["skipped"]
    warm = res.warm_state
    res2 = pair.step(pdn, tele)
    assert res2.stats["skipped"] and res2.stats["certify_pass"]
    assert res2.stats["total_iterations"] == 0
    np.testing.assert_array_equal(res2.allocation, res.allocation)
    assert res2.warm_state is warm and res2.carry is res.carry
    # the next solved step after the skip: equal iterations
    res3 = pair.step(pdn, tele * 1.02)
    assert not res3.stats["certify_pass"] and res3.stats["total_iterations"] > 0


@FLAGS
def test_rejected_demand_move(flags):
    """Any demand move forces a re-solve, even on a device holding far more
    than it asks for; the re-solve equals an always-full solve."""
    pdn = small_pdn()
    tele = np.full(pdn.n, 300.0)  # deep surplus everywhere
    pair = Pair(flags)
    pair.step(pdn, tele)
    tele2 = tele.copy()
    tele2[3] += 5.0  # still far below its allocation
    res2 = pair.step(pdn, tele2)
    assert not res2.stats["skipped"] and not res2.stats["certify_pass"]
    _, full = _options(flags, incremental=False)
    ref = optimize(AllocProblem.build(pdn, tele2, device="cpu"), full)
    assert np.abs(res2.allocation - ref.allocation).max() <= 1e-6


@FLAGS
def test_phase1_skip_on_slack_cap_move(flags):
    """A root cap move that keeps Phase I's slack reuses the carried Phase I
    point and re-runs Phases II/III only."""
    pdn = small_pdn()
    tele = np.full(pdn.n, 300.0)  # light load: huge cap slack
    pair = Pair(flags)
    pair.step(pdn, tele)
    cap2 = np.asarray(pdn.node_cap, np.float64).copy()
    cap2[0] -= 50.0  # slack still >> certify_margin
    pdn2 = dataclasses.replace(pdn, node_cap=cap2)
    res2 = pair.step(pdn2, tele)
    assert not res2.stats["skipped"] and res2.stats["certify_pass"]
    assert res2.stats["phase_iterations"][0] == 0
    _, full = _options(flags, incremental=False)
    ref = optimize(AllocProblem.build(pdn2, tele, device="cpu"), full)
    assert np.abs(res2.allocation - ref.allocation).max() <= 1e-6
    # the anchor keeps Phase I's point and demands, takes the new caps
    np.testing.assert_array_equal(res2.carry.cap.numpy(), cap2)
    # and the same step again is a full skip against the new caps
    res3 = pair.step(pdn2, tele)
    assert res3.stats["skipped"]


def test_certify_step_matches_reference():
    """The decision record itself, on the tree rows and with tenants, for
    an identical step, a moved demand and a tightened tenant cap."""
    from repro.core.solver import certify as j_certify

    jpdn = j_build_from_level_sizes([2, 3, 2], gpus_per_server=4)
    jlay = j_assign_tenants(jpdn, n_tenants=4, devices_per_tenant=8, seed=1)
    tele = np.random.default_rng(2).uniform(250, 650, jpdn.n)
    jopts, topts = _options({})
    with enable_x64(True):
        jap = JAllocProblem.build(jpdn, tele, sla=jlay.sla_topo(), priority=jlay.priority)
        jres = j_optimize(jap, jopts)
        cases = [("same", jap)]
        moved = tele.copy()
        moved[5] += 1.0
        cases.append(("moved", JAllocProblem.build(
            jpdn, moved, sla=jlay.sla_topo(), priority=jlay.priority)))
        sla = jap.sla._replace(hi=jap.sla.hi * 0.5)
        cases.append(("tenant cap", jap._replace(sla=sla)))
        want = {
            name: j_certify.certify_step(ap, jres.carry, ap.n_tree_depths(), tol=1e-9,
                                         margin=1e-2, opts=jopts.solver)
            for name, ap in cases
        }
    tcarry = solver.make_carry(
        convert.alloc_problem_from_numpy(to_numpy(jap), device="cpu"),
        torch.as_tensor(np.array(jres.phase1)), torch.as_tensor(np.array(jres.allocation)),
    )
    for name, ap in cases:
        tap = convert.alloc_problem_from_numpy(to_numpy(ap), device="cpu")
        got = solver.certify_step(tap, tcarry, tap.n_tree_depths(), tol=1e-9, margin=1e-2,
                                  opts=topts.solver)
        assert got.flags() == (bool(want[name].skip), bool(want[name].skip_p1)), name
        np.testing.assert_allclose(got.x_snap.numpy(), np.asarray(want[name].x_snap),
                                   rtol=0, atol=ATOL, err_msg=name)
        assert abs(float(got.feas_res) - float(want[name].feas_res)) <= ATOL, name
    assert bool(want["same"].skip)
    assert not bool(want["moved"].skip) and not bool(want["tenant cap"].skip)


# -- the engine: anchor and warm carry through skips ----------------------


@pytest.mark.parametrize("tenants", [False, True], ids=["tree", "tenants"])
def test_engine_warm_carry_through_skips(tenants):
    """Incremental engines of both packages over solve, full skip, Phase I
    skip (a slack root-cap move), full skip, solve: per step the same
    decision, allocations and per-phase iterations, and the same warm state
    and anchor after every step — a wrong warm state after a skip would show
    as other iteration counts on the next solved step."""
    jpdn = j_build_from_level_sizes([2, 3, 2], gpus_per_server=4)  # n = 48
    pdn = build_from_level_sizes([2, 3, 2], gpus_per_server=4)
    kw = dict(n_tenants=4, devices_per_tenant=8, seed=1)
    jlay, lay = j_assign_tenants(jpdn, **kw), assign_tenants(pdn, **kw)
    jopts, topts = _options({})
    jeng = JAllocEngine(
        jpdn, sla=jlay.sla_topo() if tenants else None,
        priority=jlay.priority if tenants else None, options=jopts,
    )
    eng = AllocEngine(
        pdn, sla=lay.sla_topo(device="cpu") if tenants else None,
        priority=lay.priority if tenants else None, options=topts, device="cpu",
    )
    rng = np.random.default_rng(4)
    tele = rng.uniform(150, 450, pdn.n)  # light load: root cap slack
    cap0 = float(pdn.node_cap[0])
    expect = []
    for t, (event, x) in enumerate([
        (None, tele), (None, tele), ("cap", tele), (None, tele), (None, tele * 1.01),
    ]):
        if event == "cap":
            for e in (jeng, eng):
                e.set_root_cap(cap0 - 50.0)
        jres, tres = jeng.step(x), eng.step(x)
        _assert_same(tres, jres, f"step {t}")
        _assert_tree_close(eng._warm, jeng._warm, f"step {t} warm")
        _assert_tree_close(eng._inc_carry, jeng._inc_carry, f"step {t} anchor")
        expect.append((tres.stats["skipped"], tres.stats["certify_pass"]))
    assert expect == [(False, False), (True, True), (False, True), (True, True),
                      (False, False)]
    assert eng.rebuild_count() == 1
    eng.reset_warm()
    assert eng._inc_carry is None and not eng.step(tele * 1.01).stats["certify_pass"]
