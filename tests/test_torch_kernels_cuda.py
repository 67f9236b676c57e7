"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: run them on a machine with an NVIDIA Hopper card with

    python -m pytest -m gpu tests/test_torch_kernels_cuda.py

Elsewhere every test skips (the ``cuda`` fixture decides, so that every
pytest worker collects the same tests).  Tolerances, as in ``chip_smoke.py``:
the elementwise kernels round every operation as the plain expression does,
|d| <= 1e-13 * max(1, |ref|) in float64 and 4 ulp of max(1, |ref|) in
float32; the tree kernels scan in another order than ``torch.cumsum``,
|d| <= 1e-12 * sum|input| in float64 and 4 unit roundoffs of sum|input| in
float32 (about 7x the float32 error measured on the H100).  The tenant
kernels sum each CSR list in edge order: they equal the CPU plain version
bit for bit.  The chunk statistics' accumulator and maxima are exact; their
sums are held to 8 unit roundoffs of the sum (all terms are squares).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.pdhg_update import kernel as pk  # noqa: E402
from repro_torch.kernels.pdhg_update import ref as pref  # noqa: E402
from repro_torch.kernels.tree_matvec import kernel as tk  # noqa: E402
from repro_torch.kernels.tree_matvec import ref as tref  # noqa: E402
from repro_torch.pdn.tree import build_datacenter, build_from_level_sizes  # noqa: E402

pytestmark = pytest.mark.gpu

ELEM_TOL = {torch.float64: 1e-13, torch.float32: 4 * 2.0**-23}
TREE_TOL = {torch.float64: 1e-12, torch.float32: 4 * 2.0**-24}
STATS_TOL = {torch.float64: 8 * 2.0**-53, torch.float32: 8 * 2.0**-24}
# 2,162,689 is past the elementwise grid (see test_sizes_cover_a_second_grid_pass)
SIZES = [1, 31, 1023, 1024, 1025, 3079, 12288, 100_003, 2_162_689]
DTYPES = [torch.float64, torch.float32]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available here)")
    return torch.device("cuda")


def _vec(rng, n, dtype, device, scale=100.0):
    return torch.as_tensor(rng.normal(size=n) * scale, dtype=dtype, device=device)


def _rows(rng, n):
    m = min(2 * n, 5000) + 4
    s = rng.integers(0, n + 1, m)
    e = rng.integers(0, n + 1, m)
    s, e = np.minimum(s, e), np.maximum(s, e)
    s[:4], e[:4] = [0, 0, n, n // 2], [n, 0, n, n]
    return s, e


def _assert_within(got, want, tol):
    torch.cuda.synchronize()
    # equal infinities match; a NaN anywhere is a mismatch
    err = torch.where(got == want, 0.0, (got - want).abs())
    assert bool((err <= tol).all()), f"max |d| {float(err.max()):.3e}"


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_tree_kernels_match_plain(cuda, n, dtype):
    rng = np.random.default_rng(n)
    s, e = _rows(rng, n)
    idx = tk.tree_index(s, e, n, cuda)
    x = _vec(rng, n, dtype, cuda, 1.0)
    y = _vec(rng, len(s), dtype, cuda, 1.0)
    start, end = idx.start.long(), idx.end.long()
    _assert_within(
        tk.tree_matvec(x, idx),
        tref.tree_matvec_ref(x, start, end),
        TREE_TOL[dtype] * float(x.abs().sum()),
    )
    _assert_within(
        tk.tree_rmatvec(y, idx),
        tref.tree_rmatvec_ref(y, start, end, n),
        TREE_TOL[dtype] * float(y.abs().sum()),
    )


def test_tree_kernels_on_the_paper_fleet(cuda):
    pdn = build_datacenter()
    idx = tk.tree_index(pdn.node_start, pdn.node_end, pdn.n, cuda)
    rng = np.random.default_rng(0)
    x = _vec(rng, pdn.n, torch.float64, cuda)
    y = _vec(rng, pdn.m, torch.float64, cuda)
    start, end = idx.start.long(), idx.end.long()
    _assert_within(
        tk.tree_matvec(x, idx),
        tref.tree_matvec_ref(x, start, end),
        1e-12 * float(x.abs().sum()),
    )
    _assert_within(
        tk.tree_rmatvec(y, idx),
        tref.tree_rmatvec_ref(y, start, end, pdn.n),
        1e-12 * float(y.abs().sum()),
    )


def test_sizes_cover_a_second_grid_pass(cuda):
    """The largest size makes the elementwise kernels' grid-stride loop run
    more than one pass."""
    from repro_torch.kernels import _build

    assert max(SIZES) > 2 * _build.library().elementwise_grid_threads()


def test_tree_rmatvec_is_deterministic(cuda):
    """No atomics: the same input gives the same bits on every launch."""
    pdn = build_from_level_sizes([4, 24, 16])
    idx = tk.tree_index(pdn.node_start, pdn.node_end, pdn.n, cuda)
    y = _vec(np.random.default_rng(1), pdn.m, torch.float64, cuda)
    first = tk.tree_rmatvec(y, idx)
    for _ in range(5):
        assert torch.equal(tk.tree_rmatvec(y, idx), first)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("vector_step", [False, True])
def test_elementwise_kernels_match_plain(cuda, n, dtype, vector_step):
    rng = np.random.default_rng(n + 7)
    x, gx, c, target = (_vec(rng, n, dtype, cuda) for _ in range(4))
    w = _vec(rng, n, dtype, cuda).abs()
    lo = _vec(rng, n, dtype, cuda) - 50.0
    hi = lo + _vec(rng, n, dtype, cuda).abs() + 1.0
    tau = (
        _vec(rng, n, dtype, cuda).abs() / 100.0 + 0.01
        if vector_step
        else torch.full((), 0.37, dtype=dtype, device=cuda)
    )
    got = pk.primal_update(x, gx, c, w, target, lo, hi, tau)
    want = pref.primal_update_ref(x, gx, c, w, target, lo, hi, tau)
    for g, r in zip(got, want):
        _assert_within(g, r, ELEM_TOL[dtype] * r.abs().clamp_min(1.0))
    # the solver's row bounds: (-inf, hi] tree rows, [lo, +inf) rows
    y, a, base = (_vec(rng, n, dtype, cuda) for _ in range(3))
    dlo = torch.where(_vec(rng, n, dtype, cuda) > 0, -float("inf"), base)
    dhi = torch.where(_vec(rng, n, dtype, cuda) > 0, float("inf"), base + 10.0)
    sigma = tau if vector_step else torch.full((), 0.21, dtype=dtype, device=cuda)
    got = pk.dual_prox(y, a, sigma, dlo, dhi)
    want = pref.dual_prox_ref(y, a, sigma, dlo, dhi)
    _assert_within(got, want, ELEM_TOL[dtype] * want.abs().clamp_min(1.0))


def test_solver_runs_through_the_kernels(cuda):
    """A control step with the tree and update kernel flags on a tree-only
    fleet launches the four kernels of that path and lands on the plain
    path's allocation."""
    from repro_torch.core.nvpax import NvpaxOptions, optimize
    from repro_torch.core.problem import AllocProblem
    from repro_torch.core.solver import SolverOptions

    pdn = build_from_level_sizes([2, 3, 2], gpus_per_server=4)
    rng = np.random.default_rng(3)
    req, pri = rng.uniform(100, 650, pdn.n), rng.integers(1, 4, pdn.n)
    ap = AllocProblem.build(pdn, req, priority=pri, device=cuda)
    opts = NvpaxOptions(
        use_waterfill=False, solver=SolverOptions(use_pallas=True, use_pallas_tree=True)
    )
    plain = optimize(ap, NvpaxOptions(use_waterfill=False))
    reset_launch_counts()
    res = optimize(ap, opts)
    path = ("tree_matvec", "tree_rmatvec", "primal_update", "dual_prox")
    assert all(launch_counts()[k] > 0 for k in path), launch_counts()
    np.testing.assert_allclose(res.allocation, plain.allocation, rtol=0, atol=1e-6)
    assert res.stats["phase_iterations"] == plain.stats["phase_iterations"]


def _edges(rng, n):
    """Random incidence edges: devices in several tenants, empty tenants."""
    k = max(1, n // 50)
    e = min(3 * n, 300_000)
    return rng.integers(0, n, e), rng.integers(0, k, e), k


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_sla_kernels_match_plain(cuda, n, dtype):
    """Against the plain version on the card (atomics: to TREE_TOL of
    sum|terms|) and on the CPU (bit for bit)."""
    rng = np.random.default_rng(n + 3)
    dev, ten, k = _edges(rng, n)
    idx = tk.sla_index(dev, ten, k, n, cuda)
    dev64, ten64 = idx.dev.long(), idx.ten.long()
    x = _vec(rng, n, dtype, cuda, 1.0)
    y = _vec(rng, k, dtype, cuda, 1.0)
    got = tk.sla_matvec(x, idx)
    _assert_within(got, tref.sla_matvec_ref(x, dev64, ten64, k),
                   TREE_TOL[dtype] * float(x[dev64].abs().sum()))
    assert torch.equal(got.cpu(), tref.sla_matvec_ref(x.cpu(), dev64.cpu(), ten64.cpu(), k))
    got = tk.sla_rmatvec(y, idx)
    _assert_within(got, tref.sla_rmatvec_ref(y, dev64, ten64, n),
                   TREE_TOL[dtype] * float(y[ten64].abs().sum()))
    assert torch.equal(got.cpu(), tref.sla_rmatvec_ref(y.cpu(), dev64.cpu(), ten64.cpu(), n))


def test_sla_kernels_on_the_appendix_b_fleet_are_deterministic(cuda):
    """100 tenants x 100 devices on the paper fleet: repeated launches give
    the same bits; no edges gives zeros without a launch."""
    from repro_torch.pdn.tenants import appendix_b_layout

    pdn = build_datacenter()
    sla = appendix_b_layout(pdn, seed=0).sla_topo(device=cuda)
    rng = np.random.default_rng(4)
    x = _vec(rng, pdn.n, torch.float64, cuda)
    y = _vec(rng, sla.k, torch.float64, cuda)
    first = tk.sla_matvec(x, sla.index), tk.sla_rmatvec(y, sla.index)
    for _ in range(5):
        assert torch.equal(tk.sla_matvec(x, sla.index), first[0])
        assert torch.equal(tk.sla_rmatvec(y, sla.index), first[1])
    empty = tk.sla_index([], [], 3, pdn.n, cuda)
    reset_launch_counts()
    assert not tk.sla_matvec(x, empty).any() and not tk.sla_rmatvec(y[:3], empty).any()
    assert launch_counts()["sla_matvec"] == launch_counts()["sla_rmatvec"] == 0


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_chunk_stats_kernels_match_plain(cuda, n, dtype):
    rng = np.random.default_rng(n + 11)
    x, px, rx, ax = (_vec(rng, n, dtype, cuda) for _ in range(4))
    for fn, ref, args, n_exact in (
        (pk.primal_chunk_stats, pref.primal_chunk_stats_ref, (x, px, rx, ax), 3),
        (pk.dual_chunk_stats, pref.dual_chunk_stats_ref, (x, px, rx), 1),
    ):
        got, want = fn(*args, 3.0), ref(*args, 3.0)
        for i, (g, r) in enumerate(zip(got, want)):
            if i < n_exact:  # accumulator and maxima
                _assert_within(g, r, ELEM_TOL[dtype] * r.abs().clamp_min(1.0))
            else:
                _assert_within(g, r, STATS_TOL[dtype] * float(r))
        again = fn(*args, 3.0)  # no atomics: the same bits every launch
        assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_tenant_engine_step_runs_through_every_kernel(cuda):
    """A cold engine step on a tenant fleet with every kernel flag launches
    all eight kernels, certifies, keeps the contracts, lands on the CPU
    run's iterations, and repeats bit for bit."""
    from repro_torch.core.engine import AllocEngine
    from repro_torch.core.nvpax import NvpaxOptions
    from repro_torch.core.solver import SolverOptions
    from repro_torch.pdn.tenants import assign_tenants

    pdn = build_from_level_sizes([2, 3, 2], gpus_per_server=4)
    lay = assign_tenants(pdn, n_tenants=4, devices_per_tenant=8, seed=1)
    opts = NvpaxOptions(
        solver=SolverOptions(use_pallas=True, use_pallas_tree=True, use_pallas_stats=True)
    )
    tele = np.random.default_rng(1).uniform(100, 650, pdn.n)

    def engine(device):
        return AllocEngine(pdn, sla=lay.sla_topo(device=device), priority=lay.priority,
                           options=opts, device=device)

    eng = engine(cuda)
    reset_launch_counts()
    res = eng.step(tele)
    assert all(v > 0 for v in launch_counts().values()), launch_counts()
    cpu = engine("cpu").step(tele)
    assert res.stats["kkt_certified"]
    assert res.stats["phase_iterations"] == cpu.stats["phase_iterations"]
    np.testing.assert_allclose(res.allocation, cpu.allocation, rtol=0, atol=1e-6)
    owned = lay.tenant_of >= 0
    sums = np.bincount(lay.tenant_of[owned], weights=res.allocation[owned], minlength=4)
    assert (sums >= lay.b_min - 1e-6).all() and (sums <= lay.b_max + 1e-6).all()
    eng.reset_warm()
    assert np.array_equal(eng.step(tele).allocation, res.allocation)
    assert eng.rebuild_count() == 1


def test_tree_only_engine_step_waterfills_through_the_tree_kernels(cuda):
    """Without tenants the max-min phases are the device water-fill, which
    runs the tree kernels; it lands on the CPU run's allocation."""
    from repro_torch.core.engine import AllocEngine

    pdn = build_datacenter(n_halls=2, racks_per_hall=6)
    tele = np.random.default_rng(2).uniform(100, 650, pdn.n)
    eng = AllocEngine(pdn, device=cuda)
    res = eng.step(tele)  # warm the library and allocator
    reset_launch_counts()
    eng.reset_warm()
    res = eng.step(tele)
    counts = launch_counts()
    assert counts["tree_matvec"] > 0 and counts["tree_rmatvec"] > 0, counts
    cpu = AllocEngine(pdn, device="cpu").step(tele)
    assert res.stats["phase_iterations"] == cpu.stats["phase_iterations"]
    np.testing.assert_allclose(res.allocation, cpu.allocation, rtol=0, atol=1e-6)
