"""The port's tenant layouts and metrics on the CPU, against the JAX
reference, and the paper's Appendix B tenant fleet through both engines.

Bars: the same seed gives the same layout array for array (exact); the
metrics agree exactly (both are numpy).  The paper-scale Appendix B cold
step has equal per-phase PDHG iterations and is certified in both; its
allocations miss the 1e-9 W per-device bar above the requests only, so the
1e-9 W bar is held on each device's useful power, min(request, cap) (see
its docstring).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import metrics as j_metrics  # noqa: E402
from repro.core.engine import AllocEngine as JAllocEngine  # noqa: E402
from repro.core.nvpax import NvpaxOptions as JNvpaxOptions  # noqa: E402
from repro.core.solver import SolverOptions as JSolverOptions  # noqa: E402
from repro.pdn import tenants as j_tenants  # noqa: E402
from repro.pdn.telemetry import TelemetrySim, TraceConfig  # noqa: E402
from repro.pdn.tree import build_datacenter as j_build_datacenter  # noqa: E402
from repro.pdn.tree import build_from_level_sizes as j_build_from_level_sizes  # noqa: E402
from repro_torch.core import metrics as t_metrics  # noqa: E402
from repro_torch.core.engine import AllocEngine  # noqa: E402
from repro_torch.core.nvpax import NvpaxOptions  # noqa: E402
from repro_torch.core.solver import SolverOptions  # noqa: E402
from repro_torch.pdn import tenants as t_tenants  # noqa: E402
from repro_torch.pdn.tree import build_datacenter, build_from_level_sizes  # noqa: E402

ALLOC_TOL = 1e-9  # watts
PHASE1_TOL = 1e-6  # watts: the strictly convex Phase I QP, the bar of test_torch_nvpax.py's paper-scale step
FEAS_TOL = 1e-6  # watts: breaker caps and tenant contracts
KERNEL_FLAGS = dict(use_pallas=True, use_pallas_tree=True, use_pallas_stats=True)


def _same_layout(got, want):
    assert got.n_tenants == want.n_tenants
    for field in ("tenant_of", "b_min", "b_max", "priority"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)


def test_appendix_b_layout_matches_reference():
    """100 tenants x 100 devices on the paper fleet, seed 0."""
    want = j_tenants.appendix_b_layout(j_build_datacenter(), seed=0)
    got = t_tenants.appendix_b_layout(build_datacenter(), seed=0)
    _same_layout(got, want)
    assert got.n_tenants == 100 and (got.tenant_of >= 0).sum() == 10_000


@pytest.mark.parametrize("scattered", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_assign_tenants_matches_reference(scattered, seed):
    kw = dict(n_tenants=4, devices_per_tenant=8, scattered=scattered, seed=seed)
    want = j_tenants.assign_tenants(j_build_from_level_sizes([2, 3, 2], gpus_per_server=4), **kw)
    got = t_tenants.assign_tenants(build_from_level_sizes([2, 3, 2], gpus_per_server=4), **kw)
    _same_layout(got, want)


def test_cross_domain_tenants_match_reference():
    kw = dict(level=1, n_cross=2, per_domain=3, n_local_per_domain=1, local_size=2, seed=4)
    want = j_tenants.assign_cross_domain_tenants(
        j_build_from_level_sizes([3, 2, 2], gpus_per_server=4), **kw
    )
    got = t_tenants.assign_cross_domain_tenants(
        build_from_level_sizes([3, 2, 2], gpus_per_server=4), **kw
    )
    _same_layout(got, want)


def test_too_many_tenant_devices_raise():
    with pytest.raises(ValueError, match="tenant devices"):
        t_tenants.assign_tenants(
            build_from_level_sizes([2, 2], gpus_per_server=2), n_tenants=3, devices_per_tenant=4
        )


def test_sla_topo_matches_reference_with_its_index():
    """The port's SlaTopo has the reference's incidence and bounds, on the
    requested device, with the kernel index built from them."""
    lay = t_tenants.assign_tenants(
        build_from_level_sizes([2, 3, 2], gpus_per_server=4), n_tenants=4, devices_per_tenant=8,
        seed=1,
    )
    want = j_tenants.assign_tenants(
        j_build_from_level_sizes([2, 3, 2], gpus_per_server=4), n_tenants=4,
        devices_per_tenant=8, seed=1,
    ).sla_topo()
    got = lay.sla_topo(device="cpu")
    for field in ("dev", "ten", "lo", "hi"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)))
    assert got.lo.dtype == torch.float64 and got.k == 4
    assert got.index.n == 48 and got.index.k == 4
    np.testing.assert_array_equal(got.index.ten_ptr.numpy(), [0, 8, 16, 24, 32])


def test_metrics_match_reference():
    rng = np.random.default_rng(0)
    n, k = 64, 5
    req = rng.uniform(0, 700, n)
    alloc = rng.uniform(0, 700, n)
    base = rng.uniform(0, 700, n)
    tenant_of = rng.integers(-1, k, n).astype(np.int32)
    b_min, b_max = rng.uniform(0, 500, k), rng.uniform(600, 2000, k)
    for name in ("useful_utilization", "satisfaction_ratio"):
        assert getattr(t_metrics, name)(req, alloc) == getattr(j_metrics, name)(req, alloc)
    assert t_metrics.satisfaction_ratio(np.zeros(n), alloc) == 1.0
    assert t_metrics.relative_improvement(req, alloc, base) == j_metrics.relative_improvement(
        req, alloc, base
    )
    np.testing.assert_array_equal(
        t_metrics.tenant_satisfaction(req, alloc, tenant_of, k),
        j_metrics.tenant_satisfaction(req, alloc, tenant_of, k),
    )
    np.testing.assert_array_equal(
        t_metrics.sla_margin(alloc, tenant_of, k, b_min, b_max),
        j_metrics.sla_margin(alloc, tenant_of, k, b_min, b_max),
    )


def _appendix_b_cold_steps(samples, flags, ulp=False):
    """Cold engine steps of both packages on the Appendix B fleet with the
    same telemetry: [(sample, requests, reference result, port result,
    reference result on telemetry one ulp up, with ``ulp``)]."""
    jpdn = j_build_datacenter()
    jlay = j_tenants.appendix_b_layout(jpdn, seed=0)
    jeng = JAllocEngine(
        jpdn, sla=jlay.sla_topo(), priority=jlay.priority,
        options=JNvpaxOptions(solver=JSolverOptions(**flags)),
    )
    pdn = build_datacenter()
    lay = t_tenants.appendix_b_layout(pdn, seed=0)
    eng = AllocEngine(
        pdn, sla=lay.sla_topo(device="cpu"), priority=lay.priority,
        options=NvpaxOptions(solver=SolverOptions(**flags)), device="cpu",
    )
    sim = TelemetrySim(TraceConfig(n_devices=jpdn.n, seed=0))
    for t in samples:
        tele = sim.power(t) * 1.05  # the controller's request margin
        jeng.reset_warm()
        jres = jeng.step(tele)
        jres_ulp = None
        if ulp:
            jeng.reset_warm()
            jres_ulp = jeng.step(np.nextafter(tele, np.inf))
        yield t, tele, jres, eng.step(tele), jres_ulp
        eng.reset_warm()


def _useful(tele, x, pdn):
    """Per-device useful power min(request, cap); idle devices request 0."""
    req = np.where(tele >= 150.0, np.clip(tele, pdn.dev_l, pdn.dev_u), 0.0)
    return np.minimum(req, x)


def test_appendix_b_cold_step_matches_reference():
    """The paper-scale case of this slice: the Appendix B tenant fleet
    (n = 12,288, k = 100, E = 10,000), one cold engine step on telemetry
    sample 0 with every kernel flag on, through both packages on the CPU
    (the reference's Pallas kernels in interpret mode, the port's plain
    versions).  The reference certifies it in 2,350 PDHG iterations.

    The per-phase iterations are equal and both certify, but the caps
    differ by ~2.5e-3 W per device: torch and XLA sum in different orders,
    Phase I then differs by ~4e-9 W, and the epsilon-degenerate tenant
    max-min LP of Phase II spreads the surplus above the requests
    differently at equal quality.  The reference itself moves by 1.5e-4 to
    2.1e-2 W per device when its telemetry moves by one ulp (ROADMAP Queue
    3).  So, as the reference's SLA warm-carry test does, this compares at
    quality level: each device's useful power, min(request, cap), to the
    1e-9 W bar (all of the gap sits above the requests), Phase I (a strictly
    convex QP) to 1e-6 W, and feasibility of the breakers and tenant
    contracts."""
    pdn = build_datacenter()
    lay = t_tenants.appendix_b_layout(pdn, seed=0)
    _, tele, jres, res, _ = next(_appendix_b_cold_steps([0], KERNEL_FLAGS))
    assert res.stats["phase_iterations"] == jres.stats["phase_iterations"]
    assert sum(res.stats["phase_iterations"]) == 2350
    assert res.stats["kkt_certified"] and jres.stats["kkt_certified"]
    np.testing.assert_allclose(res.phase1, jres.phase1, rtol=0, atol=PHASE1_TOL)
    np.testing.assert_allclose(
        _useful(tele, res.allocation, pdn), _useful(tele, jres.allocation, pdn),
        rtol=0, atol=ALLOC_TOL,
    )
    # the tenant contracts and the breakers hold
    owned = lay.tenant_of >= 0
    sums = np.bincount(lay.tenant_of[owned], weights=res.allocation[owned], minlength=100)
    assert (sums >= lay.b_min - FEAS_TOL).all() and (sums <= lay.b_max + FEAS_TOL).all()
    csum = np.concatenate([[0.0], np.cumsum(res.allocation)])
    assert (csum[pdn.node_end] - csum[pdn.node_start] <= pdn.node_cap + FEAS_TOL).all()
    assert (res.allocation >= pdn.dev_l - 1e-9).all() and (res.allocation <= pdn.dev_u + 1e-9).all()


def _appendix_b_repin(scale=0.9):
    """Both packages' CPU ``PowerController`` on the Appendix B fleet with
    every kernel flag on (``chip_smoke.py`` phase 7's options): a cold step
    on telemetry sample 0, then ``set_supply_scale(scale)``, which re-pins
    the engine and drops the warm state, and the same sample again.
    Returns (requests, reference result, port result) of the re-pinned
    step."""
    from repro.power.controller import ControllerConfig as JControllerConfig
    from repro.power.controller import PowerController as JPowerController
    from repro_torch.power import ControllerConfig, PowerController

    jpdn = j_build_datacenter()
    jlay = j_tenants.appendix_b_layout(jpdn, seed=0)
    jctl = JPowerController(
        jpdn, sla=jlay.sla_topo(), priority=jlay.priority,
        config=JControllerConfig(options=JNvpaxOptions(solver=JSolverOptions(**KERNEL_FLAGS))),
    )
    pdn = build_datacenter()
    lay = t_tenants.appendix_b_layout(pdn, seed=0)
    ctl = PowerController(
        pdn, sla=lay.sla_topo(device="cpu"), priority=lay.priority,
        config=ControllerConfig(options=NvpaxOptions(solver=SolverOptions(**KERNEL_FLAGS))),
        device="cpu",
    )
    tele = TelemetrySim(TraceConfig(n_devices=jpdn.n, seed=0)).power(0)
    out = []
    for c in (jctl, ctl):
        c.step(tele)
        c.set_supply_scale(scale)
        out.append(c.step(tele))
    return tele * 1.05, out[0], out[1]


if __name__ == "__main__":
    import sys

    if sys.argv[1:] == ["repin"]:
        # ROADMAP Queue 3's re-pin check: the supply re-pinned to 0.9 on the
        # Appendix B fleet, a cold step through both packages on the CPU.
        #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_tenants.py repin
        pdn = build_datacenter()
        lay = t_tenants.appendix_b_layout(pdn, seed=0)
        req, jres, res = _appendix_b_repin()
        ju, tu = _useful(req, jres.allocation, pdn), _useful(req, res.allocation, pdn)
        owned = lay.tenant_of >= 0
        for tag, r in (("reference", jres), ("port", res)):
            sums = np.bincount(lay.tenant_of[owned], weights=r.allocation[owned], minlength=100)
            csum = np.concatenate([[0.0], np.cumsum(r.allocation)])
            print(
                f"supply 0.9, {tag}: iterations {r.stats['phase_iterations']}, certified "
                f"{r.stats['kkt_certified']}, cap excess "
                f"{(csum[pdn.node_end] - csum[pdn.node_start] - 0.9 * pdn.node_cap).max():.2e} W, "
                f"tenant bound excess {max((lay.b_min - sums).max(), (sums - lay.b_max).max()):.2e} W",
                flush=True,
            )
        print(
            f"supply 0.9, port vs reference: phase I {np.abs(res.phase1 - jres.phase1).max():.2e} W, "
            f"caps {np.abs(res.allocation - jres.allocation).max():.2e} W, useful power "
            f"{np.abs(tu - ju).max():.2e} W, total {res.allocation.sum() - jres.allocation.sum():+.3e} W",
            flush=True,
        )
        sys.exit(0)
    # The measurements behind ROADMAP Queue 3's Appendix B entry: for cold
    # samples 0-2 (default options), the port's CPU run against the
    # reference's, and the reference against itself on telemetry one ulp up.
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_tenants.py
    pdn = build_datacenter()
    for t, tele, jres, res, jres_ulp in _appendix_b_cold_steps([0, 1, 2], {}, ulp=True):
        ju, tu = _useful(tele, jres.allocation, pdn), _useful(tele, res.allocation, pdn)
        print(
            f"sample {t}: iterations reference {jres.stats['phase_iterations']} "
            f"port {res.stats['phase_iterations']}; port vs reference: phase I "
            f"{np.abs(res.phase1 - jres.phase1).max():.2e} W, caps "
            f"{np.abs(res.allocation - jres.allocation).max():.2e} W, useful power "
            f"{np.abs(tu - ju).max():.2e} W, total {res.allocation.sum() - jres.allocation.sum():+.3e} W; "
            f"reference one ulp up: caps {np.abs(jres_ulp.allocation - jres.allocation).max():.2e} W, "
            f"useful power {np.abs(_useful(tele, jres_ulp.allocation, pdn) - ju).max():.2e} W, "
            f"iterations {jres_ulp.stats['phase_iterations']}",
            flush=True,
        )
