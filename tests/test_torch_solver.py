"""The port's PDHG solver on the CPU, against the JAX reference.

One Phase I QP or Phase II max-min LP step is built once by the reference,
carried across with :mod:`repro_torch.convert`, and solved by both
``repro.core.solver.solve`` and ``repro_torch.core.solver.solve``.  The port
keeps every arithmetic step of the reference in order, so the iteration
count, the restart count and the certificate agree exactly and the solution
to 1e-9 W.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.compat import enable_x64  # noqa: E402
from repro.core import phases as jphases  # noqa: E402
from repro.core import solver as jsolver  # noqa: E402
from repro.core.problem import AllocProblem as JAllocProblem  # noqa: E402
from repro.core.treeops import SlaTopo as JSlaTopo  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import phases as tphases  # noqa: E402
from repro_torch.core import solver as tsolver  # noqa: E402

EPS = 1e-5
SOL_TOL = 1e-9


def to_numpy(nt):
    """A reference container as the dict of numpy arrays convert.py takes."""
    if hasattr(nt, "_fields"):
        return {f: to_numpy(getattr(nt, f)) for f in nt._fields}
    return np.asarray(nt)


def _two_tenants():
    """Two hand-built tenants on the 48-device fleet: tenant 0 spans two
    servers under a 3 kW ceiling, tenant 1 spans two racks with a 5 kW
    floor."""
    dev = np.concatenate([np.arange(0, 10), np.arange(20, 36)])
    ten = np.concatenate([np.zeros(10), np.ones(16)])
    return JSlaTopo(
        dev=jnp.asarray(dev, jnp.int32),
        ten=jnp.asarray(ten, jnp.int32),
        lo=jnp.asarray([-np.inf, 5000.0]),
        hi=jnp.asarray([3000.0, np.inf]),
    )


def _pair(pdn, seed, *, sla=False, lo=100.0, hi=400.0):
    rng = np.random.default_rng(seed)
    req = rng.uniform(lo, hi, pdn.n)
    pri = rng.integers(1, 4, pdn.n)
    with enable_x64(True):
        jap = JAllocProblem.build(
            pdn, req, priority=pri, sla=_two_tenants() if sla else None
        )
    return jap, convert.alloc_problem_from_numpy(to_numpy(jap), device="cpu")


def _options(**kw):
    jopts = jsolver.SolverOptions(**kw)
    return jopts, convert.solver_options_from_dict(jopts._asdict())


def _solve_both(jap, tap, build, jinit, opts_kw):
    """``build(phases_module, ap, to_array)`` makes one step problem in
    either package from the same numpy inputs."""
    jopts, topts = _options(**opts_kw)
    with enable_x64(True):
        jprob = build(jphases, jap, jnp.asarray)
        jst, jstats = jsolver.solve(jprob, jap.tree, jap.sla, jinit, jopts)
    tprob = build(tphases, tap, torch.as_tensor)
    tinit = convert.solver_state_from_numpy(to_numpy(jinit), device="cpu")
    tst, tstats = tsolver.solve(tprob, tap.tree, tap.sla, tinit, topts)
    np.testing.assert_allclose(tst.x.numpy(), np.asarray(jst.x), rtol=0, atol=SOL_TOL)
    np.testing.assert_allclose(float(tst.t), float(jst.t), rtol=0, atol=SOL_TOL)
    assert tstats.iterations == int(jstats.iterations)
    assert tstats.restarts == int(jstats.restarts)
    assert tstats.certified == bool(jstats.certified)
    assert tstats.converged == bool(jstats.converged)
    np.testing.assert_array_equal(tstats.score_hist.numpy(), np.asarray(jstats.score_hist))
    return jstats


def _top_level_qp(mask_src, pin_free):
    top = int(np.max(mask_src["pri"][mask_src["act"]]))
    mask_a = mask_src["act"] & (mask_src["pri"] == top)

    def build(ph, ap, arr):
        return ph.qp_step(
            ap, ap.l, arr(mask_a), arr(np.zeros_like(mask_a)), EPS, pin_free=pin_free
        )

    return build


def _zeros(jap):
    with enable_x64(True):
        return jsolver.SolverState.zeros(jap.n, jap.tree.m, jap.sla.k, jnp.float64)


QP_CASES = {
    "tiny": ("tiny_pdn", False, {}),
    "small": ("small_pdn", False, {}),
    "small-uniform-steps": ("small_pdn", False, {"precondition": False}),
    "small-fixed-restarts": ("small_pdn", False, {"adaptive_restarts": False}),
    "small-two-tenants": ("small_pdn", True, {}),
}


@pytest.mark.parametrize("case", list(QP_CASES))
def test_phase1_qp_solve_matches_reference(case, request):
    fixture, sla, opts_kw = QP_CASES[case]
    jap, tap = _pair(request.getfixturevalue(fixture), seed=1, sla=sla)
    src = {"pri": np.asarray(jap.priority), "act": np.asarray(jap.active)}
    stats = _solve_both(
        jap, tap, _top_level_qp(src, pin_free=jap.pin_free_ok()), _zeros(jap), opts_kw
    )
    assert bool(stats.converged)


LP_CASES = {
    "tiny": ("tiny_pdn", False, {}),
    "small": ("small_pdn", False, {}),
    "small-two-tenants": ("small_pdn", True, {}),
    "small-two-tenants-blockwise-omega": ("small_pdn", True, {"blockwise_omega": True}),
}


@pytest.mark.parametrize("case", list(LP_CASES))
def test_phase2_lp_solve_matches_reference(case, request):
    """The first Phase II round after the reference's Phase I, warm-started
    from its duals: both packages get the same base point and masks."""
    fixture, sla, opts_kw = LP_CASES[case]
    jap, tap = _pair(request.getfixturevalue(fixture), seed=2, sla=sla)
    with enable_x64(True):
        x1, st1, _ = jphases.phase1(jap, jsolver.SolverOptions())
        mask_a = np.asarray(jap.active & ~jphases.saturated_mask(x1, jap, jap.active))
        jinit = jsolver.SolverState(
            x1, jnp.zeros(()), st1.y_tree, st1.y_sla, st1.y_imp
        )
    assert mask_a.any(), "the case needs head-room for Phase II"
    base = np.array(x1)
    idle = ~np.asarray(jap.active)
    mask_f = ~(mask_a | idle)

    def build(ph, ap, arr):
        return ph.lp_step(ap, arr(base), arr(mask_a), arr(mask_f), arr(idle), EPS)

    stats = _solve_both(jap, tap, build, jinit, opts_kw)
    assert int(stats.iterations) > 0


def test_solver_state_and_options_round_trip():
    """convert.py keeps dtypes and refuses options the port does not know."""
    st = convert.solver_state_from_numpy(
        {
            "x": np.ones(3, np.float32),
            "t": np.float32(2.0),
            "y_tree": np.zeros(2, np.float32),
            "y_sla": np.zeros(0, np.float32),
            "y_imp": np.zeros(3, np.float32),
        },
        device="cpu",
    )
    assert all(v.dtype == torch.float32 for v in st)
    assert st.t.shape == ()
    with pytest.raises(ValueError, match="unknown solver option"):
        convert.solver_options_from_dict({"use_magic": True})
    assert convert.solver_options_from_dict({"pallas_interpret": True}).pallas_interpret
