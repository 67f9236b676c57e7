"""The 200-step mixed trace of ``tests/test_incremental.py`` on the port's
engines (CPU): an incremental engine against an always-full one over a
quasi-static telemetry cadence (a refresh every 5 steps) with a brownout, a
tenant-contract change (with tenants) and a churn re-pin.

Bars: every step within 1e-6 W of the always-full engine SLA-free, and
within max(1e-6 W, 5 x the always-full engine's own drift on held steps)
with tenants (the ε-degenerate tenant LPs move their own answer between
re-solves of identical telemetry); at least 120 skips; tenant minimums on
every step; ``rebuild_count()`` unchanged by the events.  SLA-free, the
port's incremental engine is also held to the reference's on the same
trace: the same decision on every step, allocations within 1e-9 W.
"""

from __future__ import annotations

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import AllocEngine as JAllocEngine  # noqa: E402
from repro.core.nvpax import NvpaxOptions as JNvpaxOptions  # noqa: E402
from repro.core.solver import SolverOptions as JSolverOptions  # noqa: E402
from repro_torch.core.engine import AllocEngine  # noqa: E402
from repro_torch.core.nvpax import NvpaxOptions  # noqa: E402
from repro_torch.core.solver import SolverOptions  # noqa: E402
from repro_torch.pdn.tree import build_from_level_sizes  # noqa: E402

TIGHT = NvpaxOptions(solver=SolverOptions(eps_abs=1e-9, eps_rel=1e-9))
TIGHT_INC = NvpaxOptions(incremental=True, solver=SolverOptions(eps_abs=1e-9, eps_rel=1e-9))
STEPS = 200
MIN_SKIPS = 120


def _drive_mixed_trace(sla, reference: bool = False):
    """The reference test's trace on the port's engines.  Returns per-step
    parities against the always-full engine, that engine's self-drift on
    held steps, the skip count and, with ``reference``, the per-step gaps to
    the reference's incremental engine (its decision asserted equal)."""
    pdn = build_from_level_sizes([2, 4], gpus_per_server=8, l=200.0, u=700.0)
    n = pdn.n  # 64
    full = AllocEngine(pdn, sla=sla, options=TIGHT, device="cpu")
    inc = AllocEngine(pdn, sla=sla, options=TIGHT_INC, device="cpu")
    engines = [full, inc]
    jinc = None
    if reference:
        jinc = JAllocEngine(
            pdn, options=JNvpaxOptions(
                incremental=True, solver=JSolverOptions(eps_abs=1e-9, eps_rel=1e-9)
            ),
        )
        engines.append(jinc)
    sla_lo = None if sla is None else np.asarray(sla.lo, np.float64).copy()

    rng = np.random.default_rng(7)
    base = rng.uniform(250, 650, n)
    cap0 = float(pdn.node_cap[0])

    for _ in range(3):
        for e in engines:
            e.step(base)
    builds0 = [e.rebuild_count() for e in (full, inc)]

    skips = 0
    parities: list[float] = []
    ref_gaps: list[float] = []
    self_drift = 0.0
    tele = base
    prev_tele = None
    prev_full = None
    for t in range(STEPS):
        if t % 5 == 0:  # quasi-static refresh cadence
            tele = base * rng.uniform(0.97, 1.03, n)
        if t == 80:  # brownout: derate the root budget
            for e in engines:
                e.set_root_cap(0.9 * cap0)
        if t == 120 and sla is not None:  # raise tenant 0's minimum
            sla_lo = sla_lo.copy()
            sla_lo[0] = 3800.0
            for e in engines:
                e.set_sla_bounds(sla_lo, np.asarray(sla.hi, np.float64))
        if t == 160:  # churn re-pin: two devices leave the fleet
            dev_l = np.asarray(pdn.dev_l, np.float64).copy()
            dev_u = np.asarray(pdn.dev_u, np.float64).copy()
            dev_l[40:42] = 0.0
            dev_u[40:42] = 0.0
            for e in engines:
                e.repin(dev_l=dev_l, dev_u=dev_u, reset_warm=True)
        rf = full.step(tele)
        ri = inc.step(tele)
        parities.append(float(np.abs(ri.allocation - rf.allocation).max()))
        if jinc is not None:
            rj = jinc.step(tele)
            for key in ("skipped", "certify_pass", "phase_iterations"):
                assert ri.stats[key] == rj.stats[key], (t, key)
            ref_gaps.append(float(np.abs(ri.allocation - rj.allocation).max()))
        if prev_full is not None and prev_tele is tele and t not in (80, 120, 160):
            self_drift = max(self_drift, float(np.abs(rf.allocation - prev_full).max()))
        prev_full = rf.allocation.copy()
        prev_tele = tele
        if sla_lo is not None:
            for ten in range(2):
                dev = np.asarray(sla.dev)[np.asarray(sla.ten) == ten]
                assert ri.allocation[dev].sum() >= sla_lo[ten] - 1e-6, (t, ten)
        skips += int(ri.stats["skipped"])
        assert not rf.stats["skipped"]
    assert [e.rebuild_count() for e in (full, inc)] == builds0 == [1, 1]
    return parities, self_drift, skips, ref_gaps


def test_mixed_trace_parity_200_steps():
    """SLA-free: the max-min phases run the exact water-fill, so both
    engines are deterministic and the bar is 1e-6 W on every step; the
    port's incremental engine also takes the reference's decisions and
    allocations (1e-9 W)."""
    parities, _, skips, ref_gaps = _drive_mixed_trace(None, reference=True)
    assert max(parities) <= 1e-6, max(parities)
    assert skips >= MIN_SKIPS, skips
    assert max(ref_gaps) <= 1e-9, max(ref_gaps)


def test_mixed_trace_tenant_minimums_200_steps():
    """With tenants (and the step-120 contract change): minimums held on
    every step, parity bounded by the always-full engine's own noise."""
    sla = types.SimpleNamespace(
        dev=np.arange(32, dtype=np.int32),
        ten=np.repeat(np.arange(2, dtype=np.int32), 16),
        lo=np.array([3300.0, 3300.0]),
        hi=np.array([16 * 700.0, 16 * 700.0]),
    )
    parities, self_drift, skips, _ = _drive_mixed_trace(sla)
    bar = max(1e-6, 5 * self_drift)
    assert max(parities) <= bar, (max(parities), bar)
    assert skips >= MIN_SKIPS, skips
