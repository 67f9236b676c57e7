"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: run them on a machine with an NVIDIA Hopper card with

    python -m pytest -m gpu tests/test_torch_kernels_cuda.py

Elsewhere every test skips (the ``cuda`` fixture decides, so that every
pytest worker collects the same tests).  Tolerances, as in ``chip_smoke.py``:
the elementwise kernels round every operation as the plain expression does,
|d| <= 1e-13 * max(1, |ref|) in float64 and 4 ulp of max(1, |ref|) in
float32; the tree kernels scan in another order than ``torch.cumsum``,
|d| <= 1e-12 * sum|input| in float64 and 4 unit roundoffs of sum|input| in
float32 (about 7x the float32 error measured on the H100).
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
    """A control step with the kernel flags launches every kernel and lands
    on the plain path's allocation."""
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
    assert all(v > 0 for v in launch_counts().values()), launch_counts()
    np.testing.assert_allclose(res.allocation, plain.allocation, rtol=0, atol=1e-6)
    assert res.stats["phase_iterations"] == plain.stats["phase_iterations"]
