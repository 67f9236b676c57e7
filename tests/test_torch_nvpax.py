"""The port's control step (``repro_torch.core.nvpax.optimize``) on the CPU,
against the JAX reference's ``repro.core.nvpax.optimize``.

Bars: allocations agree to 1e-6 W, the per-phase PDHG iteration counts are
equal, and every allocation passes the feasibility checks of the verify
recipe (subtree sums <= cap + 1e-6 W, allocation inside the device box).
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compat import enable_x64  # noqa: E402
from repro.core.nvpax import NvpaxOptions as JNvpaxOptions  # noqa: E402
from repro.core.nvpax import optimize as j_optimize  # noqa: E402
from repro.core.problem import AllocProblem as JAllocProblem  # noqa: E402
from repro.core.solver import SolverOptions as JSolverOptions  # noqa: E402
from repro.pdn.tenants import assign_tenants  # noqa: E402
from repro.pdn.tree import build_datacenter  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.compat import resolve_device  # noqa: E402
from repro_torch.core.nvpax import NvpaxOptions, optimize  # noqa: E402
from repro_torch.core.problem import AllocProblem  # noqa: E402
from repro_torch.core.solver import SolverOptions  # noqa: E402
from repro_torch.pdn import tree as t_tree  # noqa: E402

ALLOC_TOL = 1e-6  # watts
SRC = Path(__file__).resolve().parents[1] / "src"


def to_numpy(nt):
    if hasattr(nt, "_fields"):
        return {f: to_numpy(getattr(nt, f)) for f in nt._fields}
    return np.asarray(nt)


def _check_feasible(pdn, x):
    csum = np.concatenate([[0.0], np.cumsum(x)])
    sums = csum[pdn.node_end] - csum[pdn.node_start]
    assert (sums <= pdn.node_cap + 1e-6).all()
    assert (x >= pdn.dev_l - 1e-9).all() and (x <= pdn.dev_u + 1e-9).all()


def _options(use_waterfill, kernels):
    kw = dict(use_pallas=kernels, use_pallas_tree=kernels)
    jopts = JNvpaxOptions(use_waterfill=use_waterfill, solver=JSolverOptions(**kw))
    topts = NvpaxOptions(use_waterfill=use_waterfill, solver=SolverOptions(**kw))
    return jopts, topts


def _assert_same(jres, tres, pdn):
    np.testing.assert_allclose(tres.allocation, jres.allocation, rtol=0, atol=ALLOC_TOL)
    assert list(tres.stats["phase_iterations"]) == list(jres.stats["phase_iterations"])
    assert tres.stats["kkt_certified"] == jres.stats["kkt_certified"]
    assert tres.stats["converged"] == jres.stats["converged"]
    _check_feasible(pdn, tres.allocation)


def _requests(pdn, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(100.0, 650.0, pdn.n), rng.integers(1, 4, pdn.n)


@pytest.mark.parametrize("warm", ["cold", "warm"])
@pytest.mark.parametrize("use_waterfill", [True, False])
@pytest.mark.parametrize("kernels", [False, True])
def test_optimize_matches_reference(small_pdn, kernels, use_waterfill, warm):
    """One control step; the warm case first runs a step in the reference and
    carries its WarmCarry across with convert.py into both packages' next
    step.  With the kernel flags the CPU runs their plain versions."""
    jopts, topts = _options(use_waterfill, kernels)
    req0, pri = _requests(small_pdn, 0)
    req1 = np.clip(req0 + np.random.default_rng(1).normal(0.0, 20.0, small_pdn.n), 0, 800)
    with enable_x64(True):
        jwarm = None
        if warm == "warm":
            jwarm = j_optimize(
                JAllocProblem.build(small_pdn, req0, priority=pri), jopts
            ).warm_state
        jres = j_optimize(JAllocProblem.build(small_pdn, req1, priority=pri), jopts, jwarm)
    twarm = None if jwarm is None else convert.warm_carry_from_numpy(to_numpy(jwarm), "cpu")
    tap = AllocProblem.build(small_pdn, req1, priority=pri, device="cpu")
    tres = optimize(tap, topts, twarm)
    _assert_same(jres, tres, small_pdn)


def test_optimize_with_tenants_matches_reference(small_pdn):
    """Tenant SLA rows run through their kernels' plain versions on the CPU,
    also with the kernel flags set."""
    layout = assign_tenants(small_pdn, n_tenants=4, devices_per_tenant=8, seed=1)
    tele = np.random.default_rng(3).uniform(100, 650, small_pdn.n)
    with enable_x64(True):
        jap = JAllocProblem.build(
            small_pdn, tele, sla=layout.sla_topo(), priority=layout.priority
        )
        jres = j_optimize(jap)
    tap = convert.alloc_problem_from_numpy(to_numpy(jap), device="cpu")
    _, topts = _options(True, True)
    _assert_same(jres, optimize(tap, topts), small_pdn)


def test_paper_scale_step_matches_reference():
    """The paper's fleet (n = 12,288, m = 1,637) on the default path."""
    pdn = build_datacenter()
    req, pri = _requests(pdn, 0)
    with enable_x64(True):
        jres = j_optimize(JAllocProblem.build(pdn, req, priority=pri))
    tres = optimize(AllocProblem.build(t_tree.build_datacenter(), req, priority=pri, device="cpu"))
    _assert_same(jres, tres, pdn)
    assert tres.stats["phase_iterations"][0] > 0


def test_fleet_topology_carries_across(small_pdn):
    """A topology converted from the reference's serves the zero-rebuild
    build path and gives the same step as one built by the port."""
    from repro.core.problem import FleetTopology as JFleetTopology

    req, pri = _requests(small_pdn, 4)
    with enable_x64(True):
        jtopo = JFleetTopology.from_pdn(small_pdn)
    topo = convert.fleet_topology_from_numpy(to_numpy(jtopo), device="cpu")
    a = optimize(AllocProblem.build(small_pdn, req, priority=pri, topology=topo))
    b = optimize(AllocProblem.build(small_pdn, req, priority=pri, device="cpu"))
    np.testing.assert_array_equal(a.allocation, b.allocation)


def test_deadline_truncates_refinement_phases(small_pdn):
    req, pri = _requests(small_pdn, 5)
    tap = AllocProblem.build(small_pdn, req, priority=pri, device="cpu")
    res = optimize(tap, NvpaxOptions(deadline_s=0.0))
    assert res.stats["truncated"]
    np.testing.assert_array_equal(res.allocation, res.phase1)
    _check_feasible(small_pdn, res.allocation)


def test_unported_paths_raise(small_pdn):
    req, pri = _requests(small_pdn, 6)
    tap = AllocProblem.build(small_pdn, req, priority=pri, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        optimize(tap, NvpaxOptions(incremental=True))


def test_device_rule():
    """device=None means cuda; without a card that raises instead of
    falling back to the CPU."""
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)


def test_import_loads_neither_jax_nor_reference():
    code = (
        "import sys, repro_torch, repro_torch.convert, repro_torch.core, "
        "repro_torch.kernels, repro_torch.pdn, repro_torch.obs, repro_torch.power, "
        "repro_torch.pdn.tenants, repro_torch.core.engine, repro_torch.core.batched, "
        "repro_torch.core.metrics\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stdout + out.stderr
