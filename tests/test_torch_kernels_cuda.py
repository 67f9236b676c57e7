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
bit for bit.  The fused dual step (``dual_update``) and scaled adjoint
(``scaled_rmatvec``) equal the launches they replace bit for bit.  The
chunk statistics' accumulator and maxima are exact; their
sums are held to 8 unit roundoffs of the sum (all terms are squares).
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
# the kernels of the allocator's paths (flash attention is the data plane's;
# dual_prox stands alone since the fused dual step took its place in the loop)
ALLOCATOR_KERNELS = (
    "tree_matvec", "tree_rmatvec", "sla_matvec", "sla_rmatvec", "scaled_rmatvec",
    "primal_update", "dual_update", "primal_chunk_stats", "dual_chunk_stats",
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


def test_solver_runs_through_the_kernels(cuda):
    """A control step with the tree and update kernel flags on a tree-only
    fleet launches the five kernels of that path (not the standalone
    ``dual_prox``) and lands on the plain path's allocation."""
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
    path = ("tree_matvec", "tree_rmatvec", "scaled_rmatvec", "primal_update", "dual_update")
    assert all(launch_counts()[k] > 0 for k in path), launch_counts()
    assert launch_counts()["dual_prox"] == 0
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


def _device_kernels(fn, calls):
    """Kernels the card ran during ``calls`` calls of ``fn``, by
    torch.profiler's CUDA activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # built and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


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


def _redesigned(cuda):
    """tree_matvec on the paper fleet, sla_matvec on its Appendix B tenants
    and the two fused kernels at those shapes, each as (name, call, input
    it reads)."""
    from repro_torch.pdn.tenants import appendix_b_layout

    pdn = build_datacenter()
    idx = tk.tree_index(pdn.node_start, pdn.node_end, pdn.n, cuda)
    sla = appendix_b_layout(pdn, seed=0).sla_topo(device=cuda)
    x = _vec(np.random.default_rng(9), pdn.n, torch.float64, cuda)
    dual, adjoint = _paper_fused(cuda, torch.float64)
    return [
        ("tree_matvec", lambda: tk.tree_matvec(x, idx), x),
        ("sla_matvec", lambda: tk.sla_matvec(x, sla.index), x),
        ("dual_update", lambda: pk.dual_update(*dual), dual[0].a),
        ("scaled_rmatvec", lambda: tk.scaled_rmatvec(*adjoint), adjoint[0]),
    ]


def _first(out):
    """A call's output, or the first of its outputs."""
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("which", [0, 1, 2, 3])
def test_redesigned_kernels_are_one_device_launch_per_call(cuda, which):
    """LAUNCHES counts wrapper calls; the profiler counts what the card ran:
    one kernel per call, nothing else (no memset, no copy)."""
    name, fn, _ = _redesigned(cuda)[which]
    reset_launch_counts()
    ran = _device_kernels(fn, 5)
    assert len(ran) == 5, ran
    assert launch_counts()[name] == 6


@pytest.mark.parametrize("which", [0, 1, 2, 3])
def test_redesigned_kernels_repeat_their_bits_and_replay_in_a_graph(cuda, which):
    """The same bits on every launch and from a CUDA graph replay, also after
    the graph's input changes in place."""
    _, call, x = _redesigned(cuda)[which]

    def fn():
        return _first(call())

    first = fn()
    for _ in range(5):
        assert torch.equal(fn(), first)
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
    assert torch.equal(out, first)
    x.mul_(-0.5)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, fn())
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


def test_tenant_engine_step_runs_through_every_kernel(cuda):
    """A cold engine step on a tenant fleet with every kernel flag launches
    all nine kernels of the path, certifies, keeps the contracts, lands on the CPU
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
    # the PDHG loop: one fused dual step and one fused adjoint per iteration;
    # the standalone adjoints run only outside it (step sizes, KKT checks)
    iterations = sum(res.stats["phase_iterations"])
    assert counts["dual_update"] == counts["scaled_rmatvec"] == iterations, counts
    assert counts["dual_prox"] == 0, counts
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
