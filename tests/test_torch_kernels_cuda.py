"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: run them on a machine with an NVIDIA Hopper card with

    python -m pytest -m gpu tests/test_torch_kernels_cuda.py

Elsewhere every test skips (the ``cuda`` fixture decides, so that every
pytest worker collects the same tests).  Tolerances, as in ``chip_smoke.py``:
the elementwise kernels round every operation as the plain expression does,
|d| <= 1e-13 * max(1, |ref|) in float64 and 4 ulp of max(1, |ref|) in
float32; the tree kernels scan in another order than ``torch.cumsum``,
|d| <= 1e-12 * sum|input| in float64 and 4 unit roundoffs of sum|input| in
float32 (about 7x the float32 error measured on the H100); past the
paper's n their rows nest as a tree's do, whose covering-rows index fits
int32 (rows that overlap at will need up to m x n entries).  The forward tree sums are one launch (a thread block cluster up to
16 tiles, a cooperative grid past that) whose adds are those of the
three-pass scan it replaced: they equal a host emulation of that arithmetic
bit for bit.  The tenant
kernels sum each CSR list in edge order: they equal the CPU plain version
bit for bit.  The fused dual step (``dual_update``), scaled adjoint
(``scaled_rmatvec``) and primal step (``primal_step``: the scaled adjoint
with the primal update as its epilogue) equal the launches they replace
bit for bit.  The chunk statistics' accumulator and maxima are exact; their
sums are held to 8 unit roundoffs of the sum (all terms are squares); the
two-vector ``dual_chunk_stats_pair`` is one launch whose bits are the
single-vector call's on each vector, and ``check_chunk_stats`` (every
statistic of a KKT check with the t and tenant accumulators) one launch
whose bits are those of the primal call, the pair and torch's two adds.
Flash attention is held to its plain version (``attention_ref``) row by
row, |d| <= tol * max|ref row|: the kernel the wrapper picks and, where that
is the Hopper (TMA + wgmma) kernel, the mma.sync kernel too.  Float32: 1e-5 (both keep float32
throughout, summing in other orders).  Bfloat16: 2^-7 against the plain
version run in float32 on the same values (the kernel rounds P and the
output to bfloat16, one unit roundoff 2^-8 each), and 2^-5 against the plain
version in bfloat16, which also rounds each product q.k to bfloat16 before
the scale (an error of up to 2^-8 |q.k| dh^-0.5 in a logit: 1.6e-2 of the
row's largest output measured on the H100 at the serving shape).
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
# the kernels of the allocator's tenant path with every flag (flash attention
# is the data plane's; dual_prox, scaled_rmatvec and primal_update stand
# alone since the fused dual step and primal step took their place in the
# loop)
ALLOCATOR_KERNELS = (
    "tree_matvec", "tree_rmatvec", "sla_matvec", "sla_rmatvec", "primal_step",
    "dual_update", "check_chunk_stats",
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available here)")
    return torch.device("cuda")


def _vec(rng, n, dtype, device, scale=100.0):
    return torch.as_tensor(rng.normal(size=n) * scale, dtype=dtype, device=device)


def _nested_rows(rng, n, m):
    """At most m rows of a random tree over [0, n), in random order: three
    levels, each splitting the one above at random cut points (repeated cuts
    give empty rows)."""
    cuts = np.array([0, n])
    starts, ends = [], []
    for size in (m // 16, m // 4, m // 2):
        cuts = np.sort(np.concatenate([cuts, rng.integers(0, n + 1, size)]))
        starts.append(cuts[:-1])
        ends.append(cuts[1:])
    s, e = np.concatenate(starts), np.concatenate(ends)
    keep = rng.permutation(s.size)[:m]
    return s[keep], e[keep]


def _rows(rng, n):
    """Rows that overlap at will up to the paper's n = 12,288; past it the
    rows of a random tree, so that the adjoint's covering-rows index (the
    rows' total length, n x depth for a tree) fits int32.  Either way the
    whole range, empty rows and rows at both ends."""
    m = min(2 * n, 5000) + 4
    if n > 12_288:
        s, e = _nested_rows(rng, n, m)
    else:
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


def test_tree_rmatvec_is_one_launch_of_the_ordered_sum(cuda):
    """One segment_sums launch per call, summing each position's covering
    rows in ascending row order: the bits of that ordered sum on the CPU."""
    pdn = build_datacenter()
    idx = tk.tree_index(pdn.node_start, pdn.node_end, pdn.n, cuda)
    y = _vec(np.random.default_rng(2), pdn.m, torch.float64, cuda)
    reset_launch_counts()
    got = tk.tree_rmatvec(y, idx)
    assert launch_counts()["tree_rmatvec"] == 1
    ptr, rows, yh = idx.cover_ptr.cpu().numpy(), idx.cover_rows.cpu().numpy(), y.cpu().numpy()
    want = np.zeros(pdn.n)
    for i in range(pdn.n):
        for r in rows[ptr[i] : ptr[i + 1]]:
            want[i] += yh[r]
    np.testing.assert_array_equal(got.cpu().numpy(), want)


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


# solver flags, the kernels the PDHG loop must launch and those it must not
SOLVER_PATHS = [
    pytest.param(dict(use_pallas=True, use_pallas_tree=True),
                 ("tree_matvec", "tree_rmatvec", "primal_step", "dual_update"),
                 ("scaled_rmatvec", "primal_update", "dual_prox"), id="both-flags"),
    pytest.param(dict(use_pallas=True), ("primal_update", "dual_update"),
                 ("primal_step", "scaled_rmatvec", "dual_prox"), id="use-pallas"),
    pytest.param(dict(use_pallas_tree=True), ("tree_matvec", "scaled_rmatvec"),
                 ("primal_step", "primal_update", "dual_update"), id="use-pallas-tree"),
]


@pytest.mark.parametrize("flags, launched, idle", SOLVER_PATHS)
def test_solver_runs_through_the_kernels(cuda, flags, launched, idle):
    """A control step on a tree-only fleet with the tree and update kernel
    flags launches the kernels of that path (with both flags the fused
    primal step, not the standalone adjoint and primal update, and never the
    standalone ``dual_prox``) and lands on the plain path's allocation; each
    flag alone keeps a path through the standalone kernels."""
    from repro_torch.core.nvpax import NvpaxOptions, optimize
    from repro_torch.core.problem import AllocProblem
    from repro_torch.core.solver import SolverOptions

    pdn = build_from_level_sizes([2, 3, 2], gpus_per_server=4)
    rng = np.random.default_rng(3)
    req, pri = rng.uniform(100, 650, pdn.n), rng.integers(1, 4, pdn.n)
    ap = AllocProblem.build(pdn, req, priority=pri, device=cuda)
    opts = NvpaxOptions(use_waterfill=False, solver=SolverOptions(**flags))
    plain = optimize(ap, NvpaxOptions(use_waterfill=False))
    reset_launch_counts()
    res = optimize(ap, opts)
    counts = launch_counts()
    assert all(counts[k] > 0 for k in launched), counts
    assert all(counts[k] == 0 for k in idle), counts
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


# tenant list lengths around a warp (32 lanes) and past the 128-edge chunk
# of sla_matvec's kernel; "all": one tenant holds every edge
LIST_LENGTHS = [0, 1, 31, 32, 33, 1000, "all"]


def _long_list_edges(rng, n, length):
    """Edges of 4 tenants in random edge order: tenant 1 holds ``length``
    edges, tenants 0 and 3 a few, tenant 2 none; or tenant 2 holds all
    300,000 edges.  Devices repeat within a list."""
    if length == "all":
        ten = np.full(300_000, 2)
    else:
        ten = np.concatenate([np.zeros(5), np.ones(length), np.full(3, 3)])
        ten = ten[rng.permutation(ten.size)]
    return rng.integers(0, n, ten.size), ten.astype(np.int64)


@pytest.mark.parametrize("length", LIST_LENGTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_sla_matvec_long_lists_equal_the_cpu_plain_version(cuda, length, dtype):
    """The warp-per-tenant kernel adds each list in edge order, chunk after
    chunk with the carry: the CPU plain version's bits, at every length."""
    rng = np.random.default_rng(7 if length == "all" else length)
    n = 12_288
    dev, ten = _long_list_edges(rng, n, length)
    idx = tk.sla_index(dev, ten, 4, n, cuda)
    x = _vec(rng, n, dtype, cuda, 1.0)
    got = tk.sla_matvec(x, idx)
    want = tref.sla_matvec_ref(x.cpu(), idx.dev.long().cpu(), idx.ten.long().cpu(), 4)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(tk.sla_matvec(x, idx), got)


TRACE_ATTEMPTS = 3


def _device_kernels(fn, calls):
    """Kernels the card ran during ``calls`` calls of ``fn``, by
    torch.profiler's CUDA activity.  A trace with no kernel, or fewer than
    the wrappers counted launches in it (now and then the profiler drops
    some or all of the card's records), is taken again, up to ``TRACE_ATTEMPTS``
    times, as ``chip_smoke.device_kernels`` does; the wrappers' launch
    counts are reset before each attempt, so ``launch_counts()`` afterwards
    covers the attempt that was kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # built and warm
    torch.cuda.synchronize()
    for _ in range(TRACE_ATTEMPTS):
        reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ran = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if ran and len(ran) >= sum(launch_counts().values()):
            break
    return ran


def _paper_fused(cuda, dtype, tenants=True, vector_sigma=True, pinned=False, seed=0):
    """Inputs of the two fused kernels at the paper's shapes (n = 12,288,
    m = 1,637; with ``tenants`` the Appendix B k = 100, E = 10,000, else
    k = 0): (dual_update's arguments, scaled_rmatvec's arguments).  About
    30% of the columns pinned (mov = 0), all with ``pinned``; every bound
    vector partly infinite; step sizes vectors or one 0-d tensor."""
    from repro_torch.kernels.pdhg_update.ref import DualBlock
    from repro_torch.pdn.tenants import appendix_b_layout

    pdn = build_datacenter()
    n, m = pdn.n, pdn.m
    tidx = tk.tree_index(pdn.node_start, pdn.node_end, n, cuda)
    if tenants:
        lay = appendix_b_layout(pdn, seed=0)
        dev = np.nonzero(lay.tenant_of >= 0)[0]
        ten, k = lay.tenant_of[dev], lay.n_tenants
    else:
        dev = ten = np.zeros(0, np.int64)
        k = 0
    sidx = tk.sla_index(dev, ten, k, n, cuda)
    rng = np.random.default_rng(seed)
    inf = float("inf")

    def vec(size):
        return _vec(rng, size, dtype, cuda, 1.0)

    def pos(size):
        return vec(size).abs() + 0.1

    mov = torch.zeros(n, dtype=dtype, device=cuda) if pinned else (vec(n) > -0.5).to(dtype)
    sm = pos(n) * mov
    blocks = []
    for size, a in ((m, vec(m)), (k, vec(k)), (n, sm * vec(n))):
        sig = pos(size) if vector_sigma else torch.full((), 0.37, dtype=dtype, device=cuda)
        lo = vec(size)
        hi = lo + pos(size)
        lo = torch.where(vec(size) > 0.5, -inf, lo)
        hi = torch.where(vec(size) > 0.5, inf, hi)
        blocks.append(DualBlock(vec(size), a, pos(size), sig, lo, hi))
    scalars = [torch.full((), v, dtype=dtype, device=cuda) for v in (1.7, 1.0, 0.6)]
    adjoint = (vec(m), vec(k), vec(n), pos(m), pos(k), pos(n), sm, tidx, sidx)
    return (*blocks, *scalars), adjoint


def _step_inputs(adjoint, gen, vector_tau=True):
    """The primal step's inputs over a scaled adjoint's, drawn from ``gen``:
    (x, y_tree, y_sla, y_imp, tau, PrimalStepData); a third of the columns
    linear (w = 0), a step size vector or one 0-d tensor."""
    y_tree, y_sla, y_imp, d_tree, d_sla, d_imp, sm, tidx, sidx = adjoint
    n = tidx.n

    def vec():
        return torch.as_tensor(gen.normal(size=n), dtype=sm.dtype, device=sm.device)

    x, c, target = vec(), vec(), vec()
    w = vec().abs()
    w[::3] = 0
    lo = vec() - 1.0
    hi = lo + vec().abs() + 0.1
    tau = vec().abs() + 0.05 if vector_tau else torch.full((), 0.37, dtype=sm.dtype,
                                                           device=sm.device)
    data = tk.PrimalStepData(c, w, target, lo, hi, d_tree, d_sla, d_imp, sm, tidx, sidx)
    return x, y_tree, y_sla, y_imp, tau, data


def _composition(x, y_tree, y_sla, y_imp, tau, data):
    """The three launches the primal step replaces: the scaled adjoint
    kernel, the primal update kernel and the column scaling."""
    gx, yi = tk.scaled_rmatvec(y_tree, y_sla, y_imp, data.d_tree, data.d_sla, data.d_imp,
                               data.sm, data.tree_idx, data.sla_idx)
    x1, xe = pk.primal_update(x, gx, *data[:5], tau)
    return x1, xe, data.sm * xe, yi


def _bits(v):
    return v.view(torch.int64 if v.dtype == torch.float64 else torch.int32)


# (tenants, vector step sizes, every column pinned)
FUSED_CASES = [
    pytest.param(True, True, False, id="tenants"),
    pytest.param(False, True, False, id="no-tenants"),
    pytest.param(True, False, False, id="scalar-steps"),
    pytest.param(True, True, True, id="all-pinned"),
]


@pytest.mark.parametrize("tenants, vector_sigma, pinned", FUSED_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_kernels_equal_their_plain_composition(cuda, dtype, tenants, vector_sigma, pinned):
    """dual_update and scaled_rmatvec at the paper's shapes, one launch per
    call, give the bits of the launches they replace (max |d| = 0): the
    plain compositions on the card, whose adjoint sums are the
    deterministic segment-sum kernels.  dual_update also gives the CPU plain
    version's bits."""
    from repro_torch.kernels.pdhg_update.ref import dual_update_ref

    dual, adjoint = _paper_fused(cuda, dtype, tenants, vector_sigma, pinned)
    reset_launch_counts()
    got = pk.dual_update(*dual)
    gx, yi = tk.scaled_rmatvec(*adjoint)
    assert launch_counts()["dual_update"] == launch_counts()["scaled_rmatvec"] == 1
    want = dual_update_ref(*dual)
    cpu = dual_update_ref(*(
        type(b)(*(v.cpu() for v in b)) if isinstance(b, tuple) else b.cpu() for b in dual
    ))
    torch.cuda.synchronize()
    for g, w, c in zip(got, want, cpu):
        assert torch.equal(_bits(g), _bits(w)) and torch.equal(_bits(g.cpu()), _bits(c))
    wgx, wyi = tref.scaled_rmatvec_ref(*adjoint)
    assert torch.equal(_bits(gx), _bits(wgx)) and torch.equal(_bits(yi), _bits(wyi))
    # the primal step: the bits of the three launches it replaces and of its
    # plain version on the card, one launch
    step = _step_inputs(adjoint, np.random.default_rng(5), vector_tau=vector_sigma)
    plan = tk.primal_step_plan(step[-1])
    reset_launch_counts()
    got = tk.primal_step(*step[:-1], plan)
    assert launch_counts()["primal_step"] == 1
    for want in (_composition(*step), tref.primal_step_ref(*step)):
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("n", [1, 255, 257, 1025, 100_003])
@pytest.mark.parametrize("dtype", DTYPES)
def test_primal_step_at_edge_sizes(cuda, n, dtype):
    """Around a CTA's 256 devices and past the paper's n, on random rows
    and tenant edges (devices in several tenants): the bits of the three
    launches it replaces."""
    rng = np.random.default_rng(n + 13)
    s, e = _rows(rng, n)
    dev, ten, k = _edges(rng, n)
    tidx = tk.tree_index(s, e, n, cuda)
    sidx = tk.sla_index(dev, ten, k, n, cuda)
    m = len(s)

    def vec(size, scale=1.0):
        return _vec(rng, size, dtype, cuda, scale)

    sm = (vec(n).abs() + 0.1) * (vec(n) > -0.5).to(dtype)
    adjoint = (vec(m), vec(k), vec(n), vec(m).abs() + 0.1, vec(k).abs() + 0.1,
               vec(n).abs() + 0.1, sm, tidx, sidx)
    for vector_tau in (True, False):
        step = _step_inputs(adjoint, rng, vector_tau)
        got = tk.primal_step(*step[:-1], tk.primal_step_plan(step[-1]))
        want = _composition(*step)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(_bits(g), _bits(w))


def _redesigned(cuda):
    """tree_matvec on the paper fleet, sla_matvec on its Appendix B tenants
    and the two fused kernels at those shapes, each as (name, call, input
    it reads)."""
    from repro_torch.pdn.tenants import appendix_b_layout

    pdn = build_datacenter()
    idx = tk.tree_index(pdn.node_start, pdn.node_end, pdn.n, cuda)
    sla = appendix_b_layout(pdn, seed=0).sla_topo(device=cuda)
    rng = np.random.default_rng(9)
    x = _vec(rng, pdn.n, torch.float64, cuda)
    dual, adjoint = _paper_fused(cuda, torch.float64)
    step = _step_inputs(adjoint, rng)
    plan = tk.primal_step_plan(step[-1])
    pair = [tuple(_vec(rng, r, torch.float64, cuda) for _ in range(3)) for r in (pdn.m, pdn.n)]
    primal = tuple(_vec(rng, pdn.n, torch.float64, cuda) for _ in range(4))
    accs = _check_accs(rng, 100, torch.float64, cuda)
    return [
        ("tree_matvec", lambda: tk.tree_matvec(x, idx), x),
        ("sla_matvec", lambda: tk.sla_matvec(x, sla.index), x),
        ("dual_update", lambda: pk.dual_update(*dual), dual[0].a),
        ("scaled_rmatvec", lambda: tk.scaled_rmatvec(*adjoint), adjoint[0]),
        ("primal_step", lambda: tk.primal_step(*step[:-1], plan), step[1]),
        ("dual_chunk_stats", lambda: pk.dual_chunk_stats_pair(*pair, 3.0), pair[1][0]),
        ("primal_chunk_stats", lambda: pk.primal_chunk_stats(*primal, 3.0), primal[0]),
        ("check_chunk_stats", lambda: pk.check_chunk_stats(primal, *pair, *accs, 3.0),
         primal[0]),
    ]


def _tensors(out):
    """A call's outputs as a flat list of tensors."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _tensors(o)]


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))


REDESIGNED = range(8)


@pytest.mark.parametrize("which", REDESIGNED)
def test_redesigned_kernels_are_one_device_launch_per_call(cuda, which):
    """LAUNCHES counts wrapper calls; the profiler counts what the card ran:
    one kernel per call, nothing else (no memset, no copy)."""
    name, fn, _ = _redesigned(cuda)[which]
    ran = _device_kernels(fn, 5)
    assert len(ran) == 5, ran
    assert launch_counts()[name] == 5  # the kept attempt's calls


@pytest.mark.parametrize("which", REDESIGNED)
def test_redesigned_kernels_repeat_their_bits_and_replay_in_a_graph(cuda, which):
    """The same bits on 20 launches and from a CUDA graph replay, also after
    the graph's input changes in place."""
    _, call, x = _redesigned(cuda)[which]

    def fn():
        return _tensors(call())

    first = fn()
    for _ in range(20):
        assert _equal(fn(), first)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    assert _equal(out, first)
    x.mul_(-0.5)
    graph.replay()
    torch.cuda.synchronize()
    assert _equal(out, fn())
    x.mul_(-2.0)


def _block_scan(v):
    """The kernel's block scan of [B, 256] values: Hillis-Steele shuffles in
    each warp, then warp 0's scan of the 8 warp totals.  Returns the
    exclusive scans and the block totals."""
    w = v.reshape(v.shape[0], 8, 32).copy()
    for d in (1, 2, 4, 8, 16):
        w[..., d:] = w[..., d:] + w[..., :-d].copy()
    excl = np.concatenate([np.zeros_like(w[..., :1]), w[..., :-1]], axis=-1)
    wt = w[..., 31].copy()
    for d in (1, 2, 4):
        wt[:, d:] = wt[:, d:] + wt[:, :-d].copy()
    we = np.concatenate([np.zeros_like(wt[:, :1]), wt[:, :-1]], axis=-1)
    return (excl + we[..., None]).reshape(v.shape), wt[:, 7]


def _emulated_tree_matvec(x, start, end):
    """tree_matvec's arithmetic on the host, add for add: tiles of 256
    threads x 4 items, the block scan, tile offsets scanned 256 at a time
    with a carry, the offset added at the gather."""
    n = x.size
    nb = -(-n // 1024)
    xp = np.zeros(nb * 1024, x.dtype)
    xp[:n] = x
    run = xp.reshape(nb, 256, 4).copy()
    for i in range(1, 4):
        run[..., i] = run[..., i - 1] + run[..., i]
    off, totals = _block_scan(run[..., 3])
    local = (off[..., None] + run).reshape(-1)
    offsets = np.zeros(nb, x.dtype)
    carry = x.dtype.type(0)
    for b0 in range(0, nb, 256):
        chunk = np.zeros(256, x.dtype)
        chunk[: min(256, nb - b0)] = totals[b0 : b0 + 256]
        excl, total = _block_scan(chunk[None])
        offsets[b0 : b0 + 256] = (carry + excl[0])[: min(256, nb - b0)]
        carry = carry + total[0]

    def csum(p):
        q = np.maximum(p - 1, 0)
        return np.where(p > 0, local[q] + offsets[q // 1024], x.dtype.type(0))

    return csum(end) - csum(start)


@pytest.mark.parametrize(
    "n", [1, 1025, 12_288, "one_cluster", "past_one_cluster", 1_000_003, 2_162_689]
)
@pytest.mark.parametrize("dtype", DTYPES)
def test_tree_matvec_keeps_the_three_pass_bits(cuda, n, dtype):
    """One launch, the arithmetic of the three launches it replaced: equal
    bit for bit to their host emulation, on both sides of the one-cluster
    path's last size (a thread block cluster, then a cooperative grid)."""
    from repro_torch.kernels import _build

    lib = _build.library()
    n = {
        "one_cluster": lib.tree_cluster_tiles() * lib.tree_scan_tile(),
        "past_one_cluster": lib.tree_cluster_tiles() * lib.tree_scan_tile() + 1,
    }.get(n, n)
    rng = np.random.default_rng(n + 5)
    s, e = _rows(rng, n)
    idx = tk.tree_index(s, e, n, cuda)
    x = _vec(rng, n, dtype, cuda, 1.0)
    reset_launch_counts()
    got = tk.tree_matvec(x, idx)
    assert launch_counts()["tree_matvec"] == 1
    want = _emulated_tree_matvec(x.cpu().numpy(), s.astype(np.int64), e.astype(np.int64))
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    _assert_within(got, tref.tree_matvec_ref(x, idx.start.long(), idx.end.long()),
                   TREE_TOL[dtype] * float(x.abs().sum()))


def test_float32_chunk_stats_at_one_element_over_many_seeds(cuda):
    """One term per sum, where a rounding of the division shows undamped:
    the kernels and the plain versions both divide by cnt, within
    STATS_TOL on every draw."""
    tol = STATS_TOL[torch.float32]
    for seed in range(200):
        rng = np.random.default_rng(seed)
        x, px, rx, ax = (_vec(rng, 1, torch.float32, cuda) for _ in range(4))
        for cnt in (3.0, 7.0):
            for fn, ref, args in (
                (pk.primal_chunk_stats, pref.primal_chunk_stats_ref, (x, px, rx, ax)),
                (pk.dual_chunk_stats, pref.dual_chunk_stats_ref, (x, px, rx)),
            ):
                got, want = fn(*args, cnt), ref(*args, cnt)
                for g, r in zip(got[-3:], want[-3:]):
                    _assert_within(g, r, tol * float(r))


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


@pytest.mark.parametrize("m, n", [(0, 12_288), (1, 1), (1_637, 12_288), (12_288, 2_162_689)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_dual_chunk_stats_pair_matches_plain(cuda, m, n, dtype):
    """The two dual blocks' statistics in one launch: the accumulators
    exact, the sums within STATS_TOL of the plain version, each block's
    bits those of the single-vector call (the same kernel on one block),
    on every launch."""
    rng = np.random.default_rng(m + n)
    pair = [tuple(_vec(rng, r, dtype, cuda) for _ in range(3)) for r in (m, n)]
    reset_launch_counts()
    got = pk.dual_chunk_stats_pair(*pair, 3.0)
    assert launch_counts()["dual_chunk_stats"] == 1
    want = pref.dual_chunk_stats_pair_ref(*pair, 3.0)
    for g, w, vec in zip(got, want, pair):
        _assert_within(g[0], w[0], 0.0)
        for gs, ws in zip(g[1:], w[1:]):
            _assert_within(gs, ws, STATS_TOL[dtype] * float(ws))
        assert _equal(list(g), list(pk.dual_chunk_stats(*vec, 3.0)))
    for _ in range(3):
        assert _equal(_tensors(pk.dual_chunk_stats_pair(*pair, 3.0)), _tensors(got))


def _check_accs(rng, k, dtype, device):
    """t and its accumulator (0-d), the k tenant duals and theirs."""
    t, at = (torch.as_tensor(rng.normal() * 100.0, dtype=dtype, device=device) for _ in range(2))
    return t, at, _vec(rng, k, dtype, device), _vec(rng, k, dtype, device)


# (n, m, k): the tenant fleet's primal and improvement rows, tree rows and
# tenants; one row each; an empty primal block; no tree rows; past the
# elementwise grid
CHECK_SHAPES = [(12_288, 1_637, 100), (1, 1, 1), (0, 5, 0), (1_025, 0, 257),
                (2_162_689, 31, 3)]


@pytest.mark.parametrize("n, m, k", CHECK_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_check_chunk_stats_matches_plain(cuda, n, m, k, dtype):
    """Every chunk statistic of a KKT check in one launch: the accumulators
    and maxima exact, the sums within STATS_TOL of the plain version; the
    bits of the primal call, the dual pair and torch's two adds; the same
    bits on every launch, and the three ticket counters back at zero."""
    rng = np.random.default_rng(n + 3 * m + 7 * k)
    primal = tuple(_vec(rng, n, dtype, cuda) for _ in range(4))
    tree, imp = (tuple(_vec(rng, r, dtype, cuda) for _ in range(3)) for r in (m, n))
    accs = _check_accs(rng, k, dtype, cuda)
    reset_launch_counts()
    got = pk.check_chunk_stats(primal, tree, imp, *accs, 3.0)
    assert launch_counts()["check_chunk_stats"] == 1
    assert not bool(pk._tickets(cuda).any())
    want = pref.check_chunk_stats_ref(primal, tree, imp, *accs, 3.0)
    for g, w, n_exact in zip(got[:3], want[:3], (3, 1, 1)):
        for i, (gv, wv) in enumerate(zip(g, w)):
            if i < n_exact:  # accumulator and maxima
                _assert_within(gv, wv, 0.0)
            else:
                _assert_within(gv, wv, STATS_TOL[dtype] * float(wv))
    t, at, ys, ays = accs
    separate = [pk.primal_chunk_stats(*primal, 3.0), *pk.dual_chunk_stats_pair(tree, imp, 3.0),
                at + t, ays + ys]
    assert _equal(_tensors(got), _tensors(separate))
    assert _equal(_tensors(got[3:]), _tensors(want[3:]))
    for _ in range(3):
        assert _equal(_tensors(pk.check_chunk_stats(primal, tree, imp, *accs, 3.0)),
                      _tensors(got))
        assert not bool(pk._tickets(cuda).any())


def test_tenant_engine_step_runs_through_every_kernel(cuda):
    """A cold engine step on a tenant fleet with every kernel flag launches
    every kernel wrapper of the path, certifies, keeps the contracts, lands on the CPU
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
    counts = launch_counts()
    assert all(counts[k] > 0 for k in ALLOCATOR_KERNELS), counts
    # the PDHG loop: one fused primal step and one fused dual step per
    # iteration, one statistics launch per check (no standalone primal or
    # dual chunk statistics); the standalone adjoints run only outside it
    # (step sizes, KKT checks)
    iterations = sum(res.stats["phase_iterations"])
    assert counts["dual_update"] == counts["primal_step"] == iterations, counts
    assert counts["check_chunk_stats"] == iterations // 50, counts
    assert counts["dual_chunk_stats"] == counts["primal_chunk_stats"] == 0, counts
    assert counts["dual_prox"] == counts["scaled_rmatvec"] == counts["primal_update"] == 0, counts
    assert counts["tree_rmatvec"] < iterations and counts["sla_rmatvec"] < iterations, counts
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


# ---------------------------------------------------------------------------
# flash attention

FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-5}
FLASH_TOL_VS_F32 = 2.0**-7  # a bfloat16 kernel against the plain version in float32
# B, Sq, Sk, H, KV, dh, causal, dtype
FLASH_CASES = [
    (4, 2048, 2048, 32, 8, 128, True, torch.bfloat16),  # the serving prefill of qwen3-4b
    (2, 300, 1000, 8, 2, 128, True, torch.bfloat16),  # Sq < Sk
    (2, 1000, 300, 8, 2, 128, True, torch.bfloat16),  # Sq > Sk: 700 rows see no key
    (1, 1000, 1537, 4, 4, 128, True, torch.bfloat16),  # ragged tiles
    (2, 1537, 1537, 8, 1, 128, True, torch.bfloat16),  # MQA
    (2, 513, 513, 4, 2, 64, True, torch.bfloat16),
    (2, 700, 900, 4, 2, 128, False, torch.bfloat16),
    (1, 257, 257, 4, 2, 32, True, torch.bfloat16),  # the reduced configs' head_dim
    (1, 200, 200, 2, 1, 160, True, torch.bfloat16),
    (1, 1, 77, 4, 2, 128, True, torch.bfloat16),  # one query
    # head dims 160 (stablelm-12b) and 32 on the Hopper kernel's 64-byte swizzle
    (2, 2048, 2048, 8, 2, 160, True, torch.bfloat16),  # stablelm-12b's heads, fewer of them
    (2, 300, 1000, 8, 2, 160, True, torch.bfloat16),  # Sq < Sk
    (2, 1000, 300, 8, 2, 160, True, torch.bfloat16),  # Sq > Sk: 700 rows see no key
    (1, 1000, 1537, 4, 4, 160, True, torch.bfloat16),  # ragged tiles
    (2, 777, 777, 8, 1, 160, True, torch.bfloat16),  # MQA
    (2, 700, 900, 4, 2, 160, False, torch.bfloat16),
    (2, 1000, 300, 4, 2, 32, True, torch.bfloat16),  # Sq > Sk
    (1, 1000, 1537, 8, 2, 32, True, torch.bfloat16),  # ragged tiles, GQA
    (2, 513, 513, 4, 1, 32, False, torch.bfloat16),  # MQA, non-causal
    # the float32 kernel at every built head dim
    (2, 1000, 1537, 8, 2, 128, True, torch.float32),
    (2, 1000, 300, 4, 2, 64, True, torch.float32),
    (1, 333, 333, 4, 1, 32, False, torch.float32),
    (1, 100, 100, 2, 2, 160, True, torch.float32),
    (1, 1152, 1152, 32, 8, 128, True, torch.float32),  # chip_smoke 8g's float32 shape
    (2, 1000, 300, 4, 2, 160, True, torch.float32),  # Sq > Sk
    (1, 1000, 1537, 4, 4, 160, True, torch.float32),  # ragged tiles
    (2, 777, 777, 8, 1, 32, True, torch.float32),  # MQA
    (2, 700, 900, 4, 2, 160, False, torch.float32),
    (1, 1, 77, 4, 2, 64, True, torch.float32),  # one query
]


def _flash_inputs(rng, B, Sq, Sk, H, KV, dh, dtype, device):
    def t(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32).to(device, dtype)

    return t(B, Sq, H, dh), t(B, Sk, KV, dh), t(B, Sk, KV, dh)


def _assert_rows_close(got, want, tol):
    scale = want.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
    rel = ((got.float() - want.float()).abs() / scale).max().item()
    assert rel <= tol, f"max |d| / max|ref row| {rel:.3e} > {tol:.3e}"


@pytest.mark.parametrize("B,Sq,Sk,H,KV,dh,causal,dtype", FLASH_CASES)
def test_flash_attention_matches_plain(cuda, B, Sq, Sk, H, KV, dh, causal, dtype):
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import attention_ref

    q, k, v = _flash_inputs(np.random.default_rng(Sq + Sk + dh), B, Sq, Sk, H, KV, dh, dtype, cuda)
    kind = "f32" if dtype == torch.float32 else "wgmma"  # every built head dim in bf16
    assert fk.variant(q, k, v) == kind
    runs = [(kind, fk.flash_attention)]
    if kind == "wgmma":  # the mma.sync kernel at the same shape, through its private entry
        runs.append(("mma", fk._flash_attention_mma))
    plain = attention_ref(q, k, v, causal=causal)
    for name, fn in runs:
        reset_launch_counts()
        got = fn(q, k, v, causal=causal)
        assert launch_counts()[f"flash_attention_{name}"] == 1
        assert sum(n for key, n in launch_counts().items() if key.startswith("flash")) == 1
        assert got.dtype == dtype and got.shape == q.shape
        _assert_rows_close(got, plain, FLASH_TOL[dtype])
        if dtype == torch.bfloat16:
            exact = attention_ref(q.float(), k.float(), v.float(), causal=causal)
            _assert_rows_close(got, exact, FLASH_TOL_VS_F32)
        if causal and Sq > Sk:  # rows that see no key return the mean of V
            blind = got[:, : Sq - Sk].float()
            mean_v = v.float().mean(1).repeat_interleave(H // KV, dim=1)[:, None]
            _assert_rows_close(blind, mean_v.expand_as(blind), FLASH_TOL[dtype])


def test_a_prefill_sequence_launches_only_the_hopper_kernel(cuda):
    """36 layers' worth of bf16 calls at head dim 128 (qwen3-4b's shapes,
    a shorter prompt) go to the Hopper kernel every time."""
    from repro_torch.kernels.flash_attention import kernel as fk

    q, k, v = _flash_inputs(np.random.default_rng(36), 2, 256, 256, 32, 8, 128, torch.bfloat16, cuda)
    reset_launch_counts()
    for _ in range(36):
        fk.flash_attention(q, k, v)
    counts = launch_counts()
    assert counts["flash_attention_wgmma"] == 36
    assert counts["flash_attention_mma"] == counts["flash_attention_f32"] == 0


def test_flash_attention_reads_strided_inputs(cuda):
    """q, k and v as views of one packed [B, S, H + 2 KV, dh] projection
    (strides that are not the contiguous ones) give the contiguous result."""
    from repro_torch.kernels.flash_attention import kernel as fk

    B, S, H, KV, dh = 2, 700, 8, 2, 128
    rng = np.random.default_rng(5)
    qkv = torch.as_tensor(rng.normal(size=(B, S, H + 2 * KV, dh)), dtype=torch.bfloat16).to(cuda)
    q, k, v = qkv[:, :, :H], qkv[:, :, H : H + KV], qkv[:, :, H + KV :]
    assert not q.is_contiguous()
    assert fk.variant(q, k, v) == "wgmma"  # the tensor maps read the views in place
    got = fk.flash_attention(q, k, v)
    want = fk.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(got, want)
    from repro_torch.kernels.flash_attention.ref import attention_ref

    _assert_rows_close(got, attention_ref(q, k, v), FLASH_TOL[torch.bfloat16])


def test_flash_attention_reads_a_packed_projection_at_head_dim_160(cuda):
    """stablelm-12b's head dim: q, k and v as views of one packed
    [B, S, H + 2 KV, 160] projection go to the Hopper kernel in place and
    give the contiguous result, within the bars of the plain version."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import attention_ref

    B, S, H, KV, dh = 2, 700, 8, 2, 160
    rng = np.random.default_rng(6)
    qkv = torch.as_tensor(rng.normal(size=(B, S, H + 2 * KV, dh)), dtype=torch.bfloat16).to(cuda)
    q, k, v = qkv[:, :, :H], qkv[:, :, H : H + KV], qkv[:, :, H + KV :]
    assert not q.is_contiguous()
    assert fk.variant(q, k, v) == "wgmma"
    reset_launch_counts()
    got = fk.flash_attention(q, k, v)
    assert launch_counts()["flash_attention_wgmma"] == 1
    want = fk.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(got, want)
    _assert_rows_close(got, attention_ref(q, k, v), FLASH_TOL[torch.bfloat16])
    exact = attention_ref(q.float(), k.float(), v.float())
    _assert_rows_close(got, exact, FLASH_TOL_VS_F32)


@pytest.mark.parametrize("dh", [32, 160])
def test_unreadable_bf16_inputs_take_the_mma_kernel(cuda, dh):
    """A strided head dim leaves no tensor map to read: the mma.sync kernel
    takes a copy, at the new head dims too, within the bars."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import attention_ref

    q, k, v = (t.repeat_interleave(2, dim=-1)[..., ::2] for t in _flash_inputs(
        np.random.default_rng(dh), 1, 300, 300, 4, 2, dh, torch.bfloat16, cuda))
    assert fk.variant(q, k, v) == "mma"
    reset_launch_counts()
    got = fk.flash_attention(q, k, v)
    assert launch_counts()["flash_attention_mma"] == 1
    _assert_rows_close(got, attention_ref(q, k, v), FLASH_TOL[torch.bfloat16])


def test_flash_attention_rejects_what_it_has_no_kernel_for(cuda):
    from repro_torch.kernels.flash_attention import kernel as fk

    q = torch.zeros(1, 8, 2, 96, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head_dim 96"):
        fk.flash_attention(q, q, q)
    with pytest.raises(TypeError):
        fk.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="multiple"):
        fk.flash_attention(torch.zeros(1, 8, 3, 64, device=cuda), *(2 * [torch.zeros(1, 8, 2, 64, device=cuda)]))


def test_prefill_runs_the_flash_kernel_and_matches_the_cpu(cuda):
    """Reduced qwen3-4b in float32, one set of weights: lm_prefill on the card
    (blocked branch: the kernel, once per layer) against the CPU (its plain
    version), and the card's plain blocked scan (flash_vjp=False)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import build

    cfg = get_arch("qwen3-4b").reduced()
    api = build(cfg)
    params = api.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (2, 192)))
    reset_launch_counts()
    logits, caches = api.prefill(params, tokens.to(cuda))
    assert launch_counts()["flash_attention_f32"] == cfg.n_layers
    cpu_logits, _ = api.prefill(params.to("cpu"), tokens)
    params.to(cuda)
    torch.testing.assert_close(logits.cpu(), cpu_logits, rtol=0, atol=2e-5)
    blocked = build(dataclasses.replace(cfg, flash_vjp=False))
    reset_launch_counts()
    plain_logits, _ = blocked.prefill(params, tokens.to(cuda))
    assert not any(n for key, n in launch_counts().items() if key.startswith("flash")), launch_counts()
    torch.testing.assert_close(logits, plain_logits, rtol=0, atol=2e-5)


# -- the row log-sum-exp and the flash_vjp backward (the training slice) ------

# lse: against the plain version run in float32 on the same values, |d| <=
# 1e-5 * max(1, |lse|) (the kernels' exponentials and sums in float32, in
# other orders); rows that see no key hold exactly the masked -1e30
LSE_TOL = 1e-5


@pytest.mark.parametrize("B,Sq,Sk,H,KV,dh,causal,dtype", FLASH_CASES)
def test_flash_attention_lse_matches_plain(cuda, B, Sq, Sk, H, KV, dh, causal, dtype):
    """Every kernel asked for the row log-sum-exp: lse against the plain
    version's, out the same bits as without it, one launch counted under
    the variant's ``_lse`` name."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import attention_ref

    q, k, v = _flash_inputs(np.random.default_rng(Sq + Sk + dh), B, Sq, Sk, H, KV, dh, dtype, cuda)
    _, want = attention_ref(q.float(), k.float(), v.float(), causal=causal, return_lse=True)
    kind = fk.variant(q, k, v)
    runs = [(kind, fk.flash_attention)]
    if kind == "wgmma":
        runs.append(("mma", fk._flash_attention_mma))
    for name, fn in runs:
        plain_out = fn(q, k, v, causal=causal)
        reset_launch_counts()
        out, lse = fn(q, k, v, causal=causal, return_lse=True)
        counts = launch_counts()
        assert counts[f"flash_attention_{name}_lse"] == 1 and counts[f"flash_attention_{name}"] == 0
        assert torch.equal(out, plain_out)
        assert lse.dtype == torch.float32 and lse.shape == (B, H, Sq)
        err = torch.where(lse == want, 0.0, (lse - want).abs() / want.abs().clamp_min(1.0))
        assert float(err.max()) <= LSE_TOL, (name, float(err.max()))
        if causal and Sq > Sk:
            assert bool((lse[..., : Sq - Sk] == -1e30).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_vjp_backward_matches_autograd_through_the_plain_scan(cuda, dtype):
    """models/flash_vjp on the card (the kernel with the lse, the
    hand-written backward) against autograd through the port's plain
    blocked scan on the card: float32 within 2e-5 of each tensor's largest
    magnitude, bfloat16 within 2^-5 in relative Frobenius norm (the two
    round P and the products to bfloat16 at other places)."""
    from repro_torch.models import attention, flash_vjp

    B, S, H, KV, dh, chunk = 1, 1024, 8, 2, 128, 256
    q, k, v = (t.requires_grad_(True) for t in _flash_inputs(
        np.random.default_rng(26), B, S, S, H, KV, dh, dtype, cuda))
    g = torch.as_tensor(np.random.default_rng(27).normal(size=(B, S, H, dh)),
                        dtype=torch.float32).to(cuda, dtype)
    reset_launch_counts()
    out = flash_vjp.blocked_attention_mo(q, k, v, True, dh**-0.5, chunk, chunk)
    out.backward(g)
    kind = "f32" if dtype == torch.float32 else "wgmma"
    assert launch_counts()[f"flash_attention_{kind}_lse"] == 1
    got = [out.detach()] + [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    ref_out = attention._blocked_attention(q, k, v, True, chunk)
    ref_out.backward(g)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, [ref_out.detach(), q.grad, k.grad, v.grad]):
        a, b = a.float(), b.float()
        if dtype == torch.float32:
            err = float((a - b).abs().max() / b.abs().max())
            assert err <= 2e-5, (name, err)
        else:
            err = float((a - b).norm() / b.norm())
            assert err <= 2.0**-5, (name, err)


# -- the lane axis (the K-scenario path) ------------------------------------


def _lane_cases(cuda, dtype, lanes, n, m, k, seed):
    """Every allocator kernel on ``lanes`` lanes of random inputs over one
    tree of about m rows over n positions and k tenants: {wrapper: (the
    call on [lanes, size] inputs, the call on lane j's inputs alone)}, each
    returning a tuple of outputs."""
    from repro_torch.kernels.pdhg_update.ref import DualBlock

    gen = np.random.default_rng(seed)
    s, e = _nested_rows(gen, n, m)
    s[:2], e[:2] = [0, n // 2], [n, n]
    tidx = tk.tree_index(s, e, n, cuda)
    sidx = tk.sla_index(gen.integers(0, n, 8 * k), gen.integers(0, k, 8 * k), k, n, cuda)
    m = len(s)
    inf = float("inf")

    def vec(size, pos=False):
        v = torch.as_tensor(gen.normal(size=(lanes, size)), dtype=dtype, device=cuda)
        return v.abs() + 0.1 if pos else v

    def col(*values):  # one value per lane, [lanes, 1]
        return torch.as_tensor(gen.choice(values, (lanes, 1)), dtype=dtype, device=cuda)

    x, yt, ys, yi = vec(n), vec(m), vec(k), vec(n)
    sm = vec(n, pos=True) * (vec(n) > -0.5).to(dtype)
    d_tree, d_sla, d_imp = vec(m, True), vec(k, True), vec(n, True)
    blocks = []
    for size, a in ((m, vec(m)), (k, vec(k)), (n, sm * vec(n))):
        lo = vec(size)
        hi = lo + vec(size, True)
        blocks.append(DualBlock(vec(size), a, vec(size, True), vec(size, True),
                                torch.where(vec(size) > 0.5, -inf, lo),
                                torch.where(vec(size) > 0.5, inf, hi)))
    s_t, t_mov, te = col(1.7, 0.3), col(0.0, 1.0), vec(1)
    w = vec(n).abs() * (vec(n) > -0.5).to(dtype)
    lo = vec(n) - 1.0
    data = tk.PrimalStepData(vec(n), w, vec(n), lo, lo + vec(n, True), d_tree, d_sla, d_imp, sm,
                             tidx, sidx)
    tau, tau_col = vec(n, True), col(0.37, 0.5)
    prox = (x, vec(n), vec(n), w, vec(n), lo, lo + vec(n, True))
    check = ((x, vec(n), vec(n), vec(n)), (yt, vec(m), vec(m)), (yi, vec(n), vec(n)),
             vec(1), vec(1), ys, vec(k))
    cnt = gen.integers(1, 9, lanes).astype(np.float64)
    cnt_dev = torch.as_tensor(cnt, dtype=dtype, device=cuda)  # the lanes' counts, on the card
    adjoint = (yt, ys, yi, d_tree, d_sla, d_imp, sm, tidx, sidx)

    def lane(j, args):
        """Lane j of (nested) arguments: [lanes, 1] columns become 0-d."""
        if isinstance(args, (tk.TreeIndex, tk.SlaIndex)):  # shared by every lane
            return args
        if isinstance(args, tuple):
            return type(args)(*(lane(j, a) for a in args)) if hasattr(args, "_fields") else (
                tuple(lane(j, a) for a in args))
        if isinstance(args, torch.Tensor):
            return args[j, 0] if args.shape[-1:] == (1,) else args[j]
        return args

    def plan_of(d):
        return tk.primal_step_plan(d)

    return {
        "tree_matvec": (lambda: (tk.tree_matvec(x, tidx),),
                        lambda j: (tk.tree_matvec(x[j], tidx),)),
        "tree_rmatvec": (lambda: (tk.tree_rmatvec(yt, tidx),),
                         lambda j: (tk.tree_rmatvec(yt[j], tidx),)),
        "sla_matvec": (lambda: (tk.sla_matvec(x, sidx),), lambda j: (tk.sla_matvec(x[j], sidx),)),
        "sla_rmatvec": (lambda: (tk.sla_rmatvec(ys, sidx),),
                        lambda j: (tk.sla_rmatvec(ys[j], sidx),)),
        "scaled_rmatvec": (lambda: tk.scaled_rmatvec(*adjoint),
                           lambda j: tk.scaled_rmatvec(*lane(j, adjoint))),
        "primal_step": (
            lambda: tk.primal_step(x, yt, ys, yi, tau, plan_of(data))
            + tk.primal_step(x, yt, ys, yi, tau_col, plan_of(data)),
            lambda j: tk.primal_step(x[j], yt[j], ys[j], yi[j], tau[j], plan_of(lane(j, data)))
            + tk.primal_step(x[j], yt[j], ys[j], yi[j], tau_col[j, 0], plan_of(lane(j, data)))),
        "primal_update": (lambda: pk.primal_update(*prox, tau) + pk.primal_update(*prox, tau_col),
                          lambda j: pk.primal_update(*lane(j, prox), tau[j])
                          + pk.primal_update(*lane(j, prox), tau_col[j, 0])),
        "dual_prox": (lambda: (pk.dual_prox(*blocks[0][:2], blocks[0].sigma, *blocks[0][4:]),),
                      lambda j: (pk.dual_prox(*lane(j, (blocks[0][0], blocks[0][1],
                                                       blocks[0].sigma, *blocks[0][4:]))),)),
        "dual_update": (lambda: pk.dual_update(*blocks, s_t, t_mov, te),
                        lambda j: pk.dual_update(*lane(j, (*blocks, s_t, t_mov, te)))),
        "check_chunk_stats": (
            lambda: tuple(_flat(pk.check_chunk_stats(*check, cnt_dev))),
            lambda j: tuple(_flat(pk.check_chunk_stats(*lane(j, check), float(cnt[j]))))),
    }


def _flat(out):
    return [v for o in out for v in (o if isinstance(o, tuple) else (o,))]


# (n, m, k): the paper fleet's shapes with Appendix B's tenants, and past
# tree_matvec's one-cluster size (its cooperative path)
LANE_SHAPES = [(12_288, 1_637, 100), (16_385, 1_637, 7)]


@pytest.mark.parametrize("n, m, k", LANE_SHAPES)
@pytest.mark.parametrize("lanes", [1, 2, 8])
@pytest.mark.parametrize("dtype", DTYPES)
def test_lane_kernels_give_each_lane_its_one_lane_bits(cuda, n, m, k, lanes, dtype):
    """Every allocator kernel on [K, size] lanes is one launch per call (the
    primal step and primal update are called with a per-lane vector and a
    per-lane scalar step: two), and lane j of each output has the bits of
    the call on lane j's inputs alone; the chunk statistics' ticket counters
    are back at zero."""
    cases = _lane_cases(cuda, dtype, lanes, n, m, k, seed=lanes)
    for name, (many, one) in cases.items():
        reset_launch_counts()
        got = many()
        calls = 2 if name in ("primal_step", "primal_update") else 1
        assert launch_counts()[name] == calls, (name, launch_counts())
        for j in range(lanes):
            want = one(j)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(_bits(g[j].reshape(-1)), _bits(w.reshape(-1))), (name, j)
    assert not bool(pk._tickets(cuda, lanes).any())


def test_lane_kernels_reject_what_they_cannot_launch(cuda):
    """A lane count past the grid's y axis raises, as does a lane tensor
    whose lanes disagree with the other inputs'."""
    tidx = tk.tree_index([0], [4], 4, cuda)
    with pytest.raises(ValueError, match="lanes"):
        tk.tree_matvec(torch.zeros(tk.MAX_LANES + 1, 4, dtype=torch.float64, device=cuda), tidx)
    y = torch.zeros(2, 5, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        pk.dual_prox(y, y[:1], 0.5, y, y)


def test_batched_solve_runs_the_lane_kernels(cuda):
    """``optimize_batched`` with every kernel flag on a tenant fleet: every
    allocator kernel launched, each launch over the K lanes, and each lane
    the card's own cold one-scenario engine step (equal iterations per
    phase and exit certificate, 1e-9 W), inside the contracts."""
    from repro_torch.core.batched import optimize_batched
    from repro_torch.core.engine import AllocEngine
    from repro_torch.core.nvpax import NvpaxOptions
    from repro_torch.core.problem import AllocProblem
    from repro_torch.core.solver import SolverOptions
    from repro_torch.kernels import lane_launch_counts
    from repro_torch.pdn.tenants import assign_tenants

    pdn = build_from_level_sizes([2, 3, 2], gpus_per_server=4)
    lay = assign_tenants(pdn, n_tenants=4, devices_per_tenant=8, seed=1)
    opts = NvpaxOptions(
        solver=SolverOptions(use_pallas=True, use_pallas_tree=True, use_pallas_stats=True)
    )
    tb = np.random.default_rng(1).uniform(100, 650, (3, pdn.n))
    eng = AllocEngine(pdn, sla=lay.sla_topo(device=cuda), priority=lay.priority, options=opts,
                      device=cuda)
    res = eng.step_batched(tb, carry_warm=False)  # warm the library and allocator
    reset_launch_counts()
    res = eng.step_batched(tb, carry_warm=False)
    counts, lane_counts = launch_counts(), lane_launch_counts()
    assert all(counts[k] > 0 for k in ALLOCATOR_KERNELS), counts
    assert all(lane_counts[k] == counts[k] for k in ALLOCATOR_KERNELS), (counts, lane_counts)
    assert res.stats["converged"].all()
    owned = lay.tenant_of >= 0
    for j in range(len(tb)):
        eng.reset_warm()
        one = eng.step(tb[j])
        assert list(res.stats["phase_iterations"][j]) == one.stats["phase_iterations"]
        assert res.stats["kkt_certified"][j] == one.stats["kkt_certified"]
        np.testing.assert_allclose(res.allocation[j], one.allocation, rtol=0, atol=1e-9)
        sums = np.bincount(lay.tenant_of[owned], weights=res.allocation[j][owned], minlength=4)
        assert (sums >= lay.b_min - 1e-6).all() and (sums <= lay.b_max + 1e-6).all()
    aps = [AllocProblem.build(pdn, t, sla=lay.sla_topo(device=cuda), priority=lay.priority)
           for t in tb]
    np.testing.assert_allclose(optimize_batched(aps, opts).allocation, res.allocation, rtol=0,
                               atol=1e-9)


# ---------------------------------------------------------------------------
# per-lane topology: indexes of K topologies (a stacked fleet's domains)
# ---------------------------------------------------------------------------


def _topology_lanes(cuda, gen, lanes, n, m, k):
    """K distinct topologies over n positions laid out as the fleet lays
    them: each lane a random tree of at most m rows padded with the empty
    row [n, n), and random tenant edges padded to the longest lane's count
    with edges from device 0 to the last row.  Returns the K-topology tree
    and tenant indexes and each lane's own one-topology indexes."""
    starts = np.full((lanes, m), n, np.int64)
    ends = np.full((lanes, m), n, np.int64)
    counts = gen.integers(k, 12 * k, lanes) if k else np.zeros(lanes, np.int64)
    e_max = int(counts.max())
    devs = np.zeros((lanes, e_max), np.int64)
    tens = np.full((lanes, e_max), max(k - 1, 0), np.int64)
    for j in range(lanes):
        s, e = _nested_rows(gen, n - j, m)  # each lane its own device count
        s[0], e[0] = 0, n - j
        starts[j, : s.size], ends[j, : e.size] = s, e
        devs[j, : counts[j]] = gen.integers(0, n - j, counts[j])
        tens[j, : counts[j]] = gen.integers(0, max(k - 1, 1), counts[j])
    tidx = tk.tree_index(starts, ends, n, cuda)
    sidx = tk.sla_index(devs, tens, k, n, cuda)
    ones = [(tk.tree_index(starts[j], ends[j], n, cuda), tk.sla_index(devs[j], tens[j], k, n, cuda))
            for j in range(lanes)]
    return tidx, sidx, ones


# (n, m, k): the paper fleet cut into 4 halls (3,072 devices, 409 rows per
# hall; Appendix B's tenants), the uncut fleet, and past tree_matvec's
# one-cluster size (its cooperative path)
TOPOLOGY_SHAPES = [(3_072, 409, 100), (12_288, 1_637, 100), (16_385, 1_637, 7)]


@pytest.mark.parametrize("n, m, k", TOPOLOGY_SHAPES)
@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", DTYPES)
def test_topology_lanes_give_each_lane_its_own_topologys_bits(cuda, n, m, k, lanes, dtype):
    """Every tree and tenant kernel over an index of K topologies is one
    launch per call, and lane j has the bits of a one-lane launch on lane
    j's own index."""
    gen = np.random.default_rng(100 + lanes)
    tidx, sidx, ones = _topology_lanes(cuda, gen, lanes, n, m, k)

    def vec(size, pos=False):
        v = torch.as_tensor(gen.normal(size=(lanes, size)), dtype=dtype, device=cuda)
        return v.abs() + 0.1 if pos else v

    x, yt, ys, yi = vec(n), vec(m), vec(k), vec(n)
    dt, ds, di, sm = vec(m, True), vec(k, True), vec(n, True), vec(n, True)
    c, w, target, lo = vec(n), vec(n, True), vec(n), vec(n) - 1.0
    hi, tau = lo + vec(n, True), vec(n, True)
    data = tk.PrimalStepData(c, w, target, lo, hi, dt, ds, di, sm, tidx, sidx)

    def step_one(j):
        t1, s1 = ones[j]
        d1 = tk.PrimalStepData(c[j], w[j], target[j], lo[j], hi[j], dt[j], ds[j], di[j], sm[j],
                               t1, s1)
        return tk.primal_step(x[j], yt[j], ys[j], yi[j], tau[j], tk.primal_step_plan(d1))

    cases = {
        "tree_matvec": (lambda: (tk.tree_matvec(x, tidx),),
                        lambda j: (tk.tree_matvec(x[j], ones[j][0]),)),
        "tree_rmatvec": (lambda: (tk.tree_rmatvec(yt, tidx),),
                         lambda j: (tk.tree_rmatvec(yt[j], ones[j][0]),)),
        "sla_matvec": (lambda: (tk.sla_matvec(x, sidx),),
                       lambda j: (tk.sla_matvec(x[j], ones[j][1]),)),
        "sla_rmatvec": (lambda: (tk.sla_rmatvec(ys, sidx),),
                        lambda j: (tk.sla_rmatvec(ys[j], ones[j][1]),)),
        "scaled_rmatvec": (
            lambda: tk.scaled_rmatvec(yt, ys, yi, dt, ds, di, sm, tidx, sidx),
            lambda j: tk.scaled_rmatvec(yt[j], ys[j], yi[j], dt[j], ds[j], di[j], sm[j], *ones[j])),
        "primal_step": (lambda: tk.primal_step(x, yt, ys, yi, tau, tk.primal_step_plan(data)),
                        step_one),
    }
    for name, (many, one) in cases.items():
        reset_launch_counts()
        got = many()
        assert launch_counts()[name] == 1, (name, launch_counts())
        for j in range(lanes):
            want = one(j)
            torch.cuda.synchronize()
            for g, wv in zip(got, want):
                assert torch.equal(_bits(g[j].reshape(-1)), _bits(wv.reshape(-1))), (name, j)


def test_topology_lanes_take_exactly_their_lanes(cuda):
    """An index of K topologies refuses one vector or another lane count."""
    gen = np.random.default_rng(3)
    tidx, sidx, _ = _topology_lanes(cuda, gen, 3, 64, 9, 4)
    for lanes in ((), (2,)):
        x = torch.zeros(lanes + (64,), dtype=torch.float64, device=cuda)
        with pytest.raises(ValueError, match="topologies"):
            tk.tree_matvec(x, tidx)
        with pytest.raises(ValueError, match="topologies"):
            tk.sla_matvec(x, sidx)


@pytest.mark.parametrize("tenants", [False, True])
def test_stacked_fleet_runs_the_topology_lanes(cuda, tenants):
    """A stacked fleet on the card with every kernel flag: every allocator
    kernel launched over the K domains.  Without tenants the step is within
    1e-9 W of the loop mode on the card and of the stacked mode on the CPU,
    with equal iterations per domain and phase; the eps-degenerate tenant
    LPs are held at the quality level (total power within 1e-6 W, every
    contract and breaker kept)."""
    from repro_torch.core.nvpax import NvpaxOptions
    from repro_torch.core.solver import SolverOptions
    from repro_torch.fleet import FleetOrchestrator
    from repro_torch.kernels import lane_launch_counts
    from repro_torch.pdn.hierarchy_gen import homogeneous_fleet
    from repro_torch.pdn.tenants import assign_cross_domain_tenants

    pdn = homogeneous_fleet(4, root_oversub=0.8)
    lay = assign_cross_domain_tenants(pdn, 1, seed=3) if tenants else None
    # the reference's tenant-parity tolerance, so that the contract rows
    # land on their vertex (at the default 1e-6 a minimum is met to ~3e-7 of
    # itself, 2.4e-4 W at 840 W)
    tight = dict(eps_abs=1e-11, eps_rel=1e-11, max_iters=20_000) if tenants else {}
    opts = NvpaxOptions(solver=SolverOptions(use_pallas=True, use_pallas_tree=True,
                                             use_pallas_stats=True, **tight))
    tele = np.random.default_rng(4).uniform(100, 650, pdn.n)
    runs = {}
    for mode, device in (("stacked", cuda), ("loop", cuda), ("stacked", "cpu")):
        orch = FleetOrchestrator(pdn, level=1, tenants=lay, mode=mode, options=opts,
                                 device=device)
        reset_launch_counts()
        runs[mode, str(device)] = orch.step(tele)
        if (mode, device) == ("stacked", cuda):
            counts, lane_counts = launch_counts(), lane_launch_counts()
            used = [k for k in ALLOCATOR_KERNELS if tenants or not k.startswith("sla")]
            assert all(counts[k] > 0 for k in used if k != "sla_rmatvec"), counts
            assert all(lane_counts[k] == counts[k] for k in ALLOCATOR_KERNELS), lane_counts
    ref = runs["stacked", "cuda"]
    csum_of = np.concatenate
    for key, res in runs.items():
        x = res.allocation
        csum = csum_of([[0.0], np.cumsum(x)])
        assert (csum[pdn.node_end] - csum[pdn.node_start] <= pdn.node_cap + 1e-6).all(), key
        if not tenants:
            np.testing.assert_allclose(x, ref.allocation, rtol=0, atol=1e-9, err_msg=str(key))
            np.testing.assert_array_equal(res.stats["phase_iterations"],
                                          ref.stats["phase_iterations"])
            continue
        assert abs(x.sum() - ref.allocation.sum()) <= 1e-6, key
        owned = lay.tenant_of >= 0
        sums = np.bincount(lay.tenant_of[owned], weights=x[owned], minlength=lay.n_tenants)
        # the reference's own bar on tenant sums (tests/test_fleet_sla.py)
        assert (sums >= lay.b_min - 1e-4).all() and (sums <= lay.b_max + 1e-4).all(), key


# ---------------------------------------------------------------------------
# the flight recorder on the card (repro_torch.obs.recorder)
# ---------------------------------------------------------------------------


def _recorder_inputs(rng, n: int, lanes, device):
    """One step's stats (counts and flags host values, the residual and the
    in-loop histogram device tensors), allocation, request and margin."""
    shape = () if lanes is None else (lanes,)
    stats = {k: rng.integers(0, 500, shape) for k in
             ("restarts", "iterations", "iterations_p1", "iterations_p2", "iterations_p3")}
    stats.update({k: rng.random(shape) < 0.5 for k in
                  ("skipped", "certify_pass", "converged", "kkt_certified", "truncated")})
    kkt = torch.as_tensor(10.0 ** rng.uniform(-14, 2, shape), device=device)
    stats["kkt_res"] = kkt if lanes is None else kkt.reshape(lanes, 1)
    stats["kkt_hist"] = torch.as_tensor(rng.integers(0, 9, shape + (16,)).astype(np.int32),
                                        device=device)
    alloc = torch.as_tensor(rng.uniform(100.0, 700.0, shape + (n,)), device=device)
    r = torch.as_tensor(rng.uniform(0.0, 800.0, shape + (n,)), device=device)
    margin = torch.as_tensor(rng.normal(0.0, 50.0, shape), device=device)
    return stats, alloc, r, margin


def test_recorder_step_replays_in_a_cuda_graph(cuda):
    """One ``record_step`` captured in a CUDA graph with its gauges in
    static buffers, replayed 5 times (the capacity-4 ring wraps) with new
    values copied in before each: the ring, counters, histograms, step and
    last allocation are the bits of 5 eager calls (``chip_smoke.py`` 13e at
    the paper's n)."""
    from repro_torch.obs import recorder

    cfg = recorder.RecorderConfig(capacity=4)
    n = 1_000
    rng = np.random.default_rng(0)
    static = recorder.static_metrics(cfg, device=cuda)
    alloc = torch.zeros(n, dtype=torch.float64, device=cuda)
    eager, graphed, scratch = (recorder.init_state(cfg, n, device=cuda) for _ in range(3))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            recorder.record_step(cfg, scratch, static, alloc)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        recorder.record_step(cfg, graphed, static, alloc)
    for _ in range(5):
        stats, a, r, margin = _recorder_inputs(rng, n, None, cuda)
        m = recorder.step_metrics(stats, a, r, margin)
        recorder.copy_metrics(static, m)
        alloc.copy_(a)
        graph.replay()
        recorder.record_step(cfg, eager, m, a)
    torch.cuda.synchronize()
    for leaf in ("step", "ring", "hists", "solver_hist", "counters", "last_alloc"):
        assert torch.equal(getattr(graphed, leaf), getattr(eager, leaf)), leaf
    assert int(graphed.step) == 5


def test_batched_record_matches_one_lane_records(cuda):
    """A K = 8 record of one batched update against 8 one-lane records of
    each lane's inputs: integer fields, counters, histograms, KKT residual,
    margin and grant movement the same bits; granted watts and satisfaction
    (row sums over ``[K, n]``, which the card adds in another order than a
    vector's) within 1e-12 relative."""
    from repro_torch.obs import recorder

    cfg = recorder.RecorderConfig(capacity=4)
    K, n = 8, 12_288
    rng = np.random.default_rng(1)
    lanes = recorder.init_batch(cfg, K, n, device=cuda)
    ones = [recorder.init_state(cfg, n, device=cuda) for _ in range(K)]
    for _ in range(5):
        stats, alloc, r, margin = _recorder_inputs(rng, n, K, cuda)
        recorder.record_step(cfg, lanes, recorder.step_metrics(stats, alloc, r, margin), alloc)
        for j in range(K):
            one = {k: v[j] for k, v in stats.items()}
            one["kkt_res"] = stats["kkt_res"][j, 0]
            recorder.record_step(
                cfg, ones[j], recorder.step_metrics(one, alloc[j], r[j], margin[j]), alloc[j])
    got = recorder.flush_lanes(lanes, cfg)
    for j, st in enumerate(ones):
        want = recorder.flush(st, cfg)
        for key in ("counters", "step"):
            assert got[j][key] == want[key], (j, key)
        for key in ("hist_kkt", "hist_move", "solver_hist"):
            np.testing.assert_array_equal(got[j][key], want[key])
        for i, name in enumerate(recorder.FIELDS):
            if name in ("alloc_W", "satisfaction"):
                np.testing.assert_allclose(got[j]["rows"][:, i], want["rows"][:, i],
                                           rtol=1e-12, atol=0, err_msg=name)
            else:
                np.testing.assert_array_equal(got[j]["rows"][:, i], want["rows"][:, i],
                                              err_msg=name)


@pytest.mark.parametrize("lanes", [None, 3])
def test_recorder_margin_is_the_cpu_bits(cuda, lanes):
    """The SLA margin on the card goes through ``gather_sums`` (one
    ``sla_matvec`` launch) and gives the CPU plain version's bits, on the
    Appendix B tenants of the paper's fleet."""
    from repro_torch.obs import recorder
    from repro_torch.pdn.tenants import appendix_b_layout

    pdn = build_datacenter()
    lay = appendix_b_layout(pdn, seed=0)
    shape = (pdn.n,) if lanes is None else (lanes, pdn.n)
    x = np.random.default_rng(2).uniform(200.0, 700.0, shape)
    reset_launch_counts()
    got = recorder.sla_min_margin(torch.as_tensor(x, device=cuda), lay.sla_topo(device=cuda))
    counts = {k: v for k, v in launch_counts().items() if v}
    assert counts == {"sla_matvec": 1}, counts
    want = recorder.sla_min_margin(torch.as_tensor(x), lay.sla_topo(device="cpu"))
    assert torch.equal(got.cpu(), want)
    assert torch.isfinite(want).all()


# ---------------------------------------------------------------------------
# the stacked tenant fleet's lanes against their one-lane solves
# ---------------------------------------------------------------------------


def _lane(tree, j: int, k: int):
    """Lane ``j`` of a ``[k, ...]`` NamedTuple tree, as a one-lane tree."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_lane(v, j, k) for v in tree))
    if isinstance(tree, torch.Tensor) and tree.ndim >= 1 and tree.shape[0] == k:
        return tree[j : j + 1].contiguous()
    return tree


@pytest.fixture(scope="module")
def paper_tenant_fleet():
    """The paper's datacenter cut at its 4 halls with Appendix B's tenants
    split at the cut (hall 2's 2,534 edges fill its lane's edge block, the
    others hold 70, 25 and 41 pad edges), stacked on the card with every
    kernel flag; TelemetrySim seed 0, sample 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available here)")
    from repro_torch.core.nvpax import NvpaxOptions
    from repro_torch.core.solver import SolverOptions
    from repro_torch.fleet import FleetOrchestrator
    from repro_torch.pdn.telemetry import TelemetrySim, TraceConfig
    from repro_torch.pdn.tenants import appendix_b_layout

    pdn = build_datacenter()
    lay = appendix_b_layout(pdn, seed=0)
    opts = NvpaxOptions(solver=SolverOptions(use_pallas=True, use_pallas_tree=True,
                                             use_pallas_stats=True))
    orch = FleetOrchestrator(pdn, level=1, tenants=lay, mode="stacked", options=opts,
                             device=torch.device("cuda"))
    sim = TelemetrySim(TraceConfig(n_devices=pdn.n, seed=0))
    return orch, sim.power(0), sim.active_mask(0)


def test_stacked_lane_sums_are_each_lanes_one_lane_sums(cuda, paper_tenant_fleet):
    """The lane sums, the plain tree sums and the feasibility repair over the
    4 hall lanes (one with no pad edge), on the card: each lane's the bits
    of the same call on that lane alone.  torch sums and scans the rows of a
    ``[K, n]`` tensor on a card in an order that changes with K; a lane's
    folded row bounds, step sizes and KKT checks then depend on how many
    lanes share the call."""
    from repro_torch.core import lanes, phases, treeops
    from repro_torch.core.problem import AllocProblem

    orch, _, _ = paper_tenant_fleet
    dom = orch._dom
    K, N = dom.l.shape
    assert K == 4 and [orch._E - orch._sla.edges(k)[0].size for k in range(K)][2] == 0
    rng = np.random.default_rng(11)
    x = torch.as_tensor(rng.uniform(100.0, 700.0, (K, N)), device=cuda)
    x[:, N // 3 : N // 3 + 300] = 0.0  # a stretch of zeros: a pinned rack folds to 0
    sums = lanes.lane_sum(x)
    four = treeops.tree_matvec(x, dom.tree)
    for j in range(K):
        assert torch.equal(sums[j : j + 1], lanes.lane_sum(x[j : j + 1])), f"lane {j}"
        one = treeops.tree_matvec(x[j : j + 1], _lane(dom.tree, j, K))
        assert torch.equal(four[j : j + 1], one), f"lane {j}"
    cap = dom.tree.start.new_zeros(dom.tree.start.shape, dtype=x.dtype) + 5_000.0
    cap[:, 0] = 1.0e6
    ap = AllocProblem(l=dom.l, u=dom.u, r=x, priority=dom.priority,
                      active=torch.ones_like(x, dtype=torch.bool),
                      tree=dom.tree._replace(cap=cap), sla=dom.sla,
                      weight_scale=dom.weight_scale)
    xs = torch.clamp(x, dom.l, dom.u)
    fixed = phases.repair(xs, ap, orch.meta.n_depths)
    for j in range(K):
        one = phases.repair(xs[j : j + 1], _lane(ap, j, K), orch.meta.n_depths)
        assert torch.equal(fixed[j : j + 1], one), f"lane {j}"


def test_stacked_tenant_fleet_lanes_are_their_one_lane_solves(cuda, paper_tenant_fleet):
    """One cold stacked step of the 4-hall tenant fleet with every kernel
    flag: every hall converged, every hall's grant handed out but for at
    most 250 W, and every hall's lane the bits and iterations of its
    one-lane solve on the card.  The four-lane step once left 40.6 kW of
    hall 2's grant unallocated (the lane with no pad edge), where a one-lane
    step left 237 W, and halls 0 and 3 took other iterations than alone."""
    import repro_torch.fleet.orchestrator as orch_mod
    from repro_torch.core.batched import _solve_batched

    orch, tele, act = paper_tenant_fleet
    kept = {}
    real = orch_mod._solve_batched

    def keep(ap, meta, opts, warm, *a, **kw):
        kept.update(ap=ap, meta=meta, opts=opts)
        return real(ap, meta, opts, warm, *a, **kw)

    orch.reset_warm()
    orch_mod._solve_batched = keep
    try:
        res = orch.step(tele, active=act)
    finally:
        orch_mod._solve_batched = real
    offs = np.concatenate([[0], np.cumsum(orch.domain_sizes)])
    left = [float(res.grants[k] - res.allocation[offs[k] : offs[k + 1]].sum())
            for k in range(orch.k)]
    assert res.stats["converged"].all() and max(left) <= 250.0, left
    K = orch.k
    for j in range(K):
        _, _, xj, _, st, _ = _solve_batched(_lane(kept["ap"], j, K), kept["meta"],
                                            kept["opts"], None)
        np.testing.assert_array_equal(xj[0, : offs[j + 1] - offs[j]].cpu().numpy(),
                                      res.allocation[offs[j] : offs[j + 1]], err_msg=f"hall {j}")
        assert [int(st[f"iterations_p{i}"][0]) for i in (1, 2, 3)] == \
            res.stats["phase_iterations"][j].tolist(), f"hall {j}"


# ---------------------------------------------------------------------------
# the training launcher's modules on the card: checkpoint, compression
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_on_the_card(cuda, tmp_path):
    """A reduced qwen3-4b train state on the card after one step, saved and
    restored onto the card (every leaf the same bits) and onto the CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import build
    from repro_torch.training import checkpoint
    from repro_torch.training.step import init_train_state, make_train_step

    cfg = get_arch("qwen3-4b").reduced()
    api = build(cfg)
    state = init_train_state(cfg, api, torch.Generator(device=cuda).manual_seed(0), cuda)
    batch = SyntheticLMData(cfg.vocab, seed=0).batch(0, 2, 128)
    state, _ = make_train_step(cfg, api)(state, {k: torch.as_tensor(v, device=cuda)
                                                 for k, v in batch.items()})
    checkpoint.save(str(tmp_path), 1, state, cfg=cfg)
    like = init_train_state(cfg, api, torch.Generator(device=cuda).manual_seed(1), cuda)
    for device in (None, "cpu"):
        got = checkpoint.restore(str(tmp_path), 1, like, cfg=cfg, device=device)
        assert got.step == 1
        for a, b in ((got.params, state.params), (got.opt.m, state.opt.m),
                     (got.opt.v, state.opt.v)):
            for p, q in zip(a.parameters(), b.parameters(), strict=True):
                assert p.device.type == ("cuda" if device is None else "cpu")
                assert p.dtype == q.dtype and torch.equal(p.cpu(), q.cpu())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_dequantize_is_the_cpus_bits(cuda, dtype):
    """float32 division and round-half-to-even are correctly rounded on both
    devices: the card's int8 round trip is the CPU's bit for bit."""
    from repro_torch.training.compression import quantize_dequantize

    rng = np.random.default_rng(4)
    for n in (1, 1000, 1_000_003):
        g = torch.as_tensor(rng.normal(size=n).astype(np.float32)).to(dtype)
        err = torch.as_tensor((rng.normal(size=n) * 1e-2).astype(np.float32))
        want = quantize_dequantize(g, err)
        got = quantize_dequantize(g.to(cuda), err.to(cuda))
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b), n


def test_compressed_psum_at_one_nccl_rank(cuda):
    """One NCCL rank: the mean over one rank is the int8 round trip of a
    zero error, bit for bit."""
    import datetime

    import torch.distributed as dist

    from repro_torch.training.compression import compressed_psum, quantize_dequantize

    if dist.is_initialized():
        pytest.skip("a process group is already initialised in this process")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        rng = np.random.default_rng(6)
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.as_tensor(rng.normal(size=(513, 7)).astype(np.float32)).to(cuda, dtype)
            want, _ = quantize_dequantize(g, torch.zeros(g.shape, device=cuda))
            got = compressed_psum(g)
            assert got.dtype == dtype and torch.equal(got, want)
    finally:
        dist.destroy_process_group()
