"""The port's kernel modules on the CPU, against the JAX reference.

Each kernel's plain PyTorch version (``repro_torch.kernels.*.ref``, which
``ops`` runs for a CPU tensor) is held against the reference's Pallas kernel
in interpret mode and against its jnp oracle, on the sweeps of
``tests/test_kernels.py`` at small n (block and edge-chunk sizes made small
so the sweeps cross them).  Inputs are made with numpy from a
seed and handed to both packages.  The CUDA kernels themselves run only on
the card (``tests/test_torch_kernels_cuda.py``); here the host-side parts
they depend on (the CSR indexes of the adjoints and tenant sums, the
wrappers' refusal of CPU tensors) are checked.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.compat import enable_x64  # noqa: E402
from repro.kernels.pdhg_update import dual_chunk_stats as j_dual_chunk_stats  # noqa: E402
from repro.kernels.pdhg_update import dual_prox as j_dual_prox  # noqa: E402
from repro.kernels.pdhg_update import primal_chunk_stats as j_primal_chunk_stats  # noqa: E402
from repro.kernels.pdhg_update import primal_update as j_primal_update  # noqa: E402
from repro.kernels.pdhg_update.ref import dual_prox_ref as j_dual_prox_ref  # noqa: E402
from repro.kernels.pdhg_update.ref import (  # noqa: E402
    primal_update_ref as j_primal_update_ref,
)
from repro.kernels.pdhg_update.ref import (  # noqa: E402
    dual_chunk_stats_ref as j_dual_chunk_stats_ref,
)
from repro.kernels.pdhg_update.ref import (  # noqa: E402
    primal_chunk_stats_ref as j_primal_chunk_stats_ref,
)
from repro.kernels.tree_matvec import sla_matvec as j_sla_matvec  # noqa: E402
from repro.kernels.tree_matvec import sla_rmatvec as j_sla_rmatvec  # noqa: E402
from repro.kernels.tree_matvec import tree_matvec as j_tree_matvec  # noqa: E402
from repro.kernels.tree_matvec import tree_rmatvec as j_tree_rmatvec  # noqa: E402
from repro.kernels.tree_matvec.ref import sla_matvec_ref as j_sla_matvec_ref  # noqa: E402
from repro.kernels.tree_matvec.ref import sla_rmatvec_ref as j_sla_rmatvec_ref  # noqa: E402
from repro.kernels.tree_matvec.ref import tree_matvec_ref as j_tree_matvec_ref  # noqa: E402
from repro.kernels.tree_matvec.ref import (  # noqa: E402
    tree_rmatvec_ref as j_tree_rmatvec_ref,
)
from repro.core.solver import loop as j_loop  # noqa: E402
from repro.core.solver import scaling as j_scaling  # noqa: E402
from repro.core.treeops import SlaTopo as JSlaTopo  # noqa: E402
from repro.core.treeops import TreeTopo as JTreeTopo  # noqa: E402
from repro_torch.core.solver import scaling as t_scaling  # noqa: E402
from repro_torch.core.treeops import SlaTopo, TreeTopo  # noqa: E402
from repro_torch.kernels import pdhg_update as pk  # noqa: E402
from repro_torch.kernels import tree_matvec as tk  # noqa: E402
from repro_torch.kernels.pdhg_update import kernel as pk_kernel  # noqa: E402
from repro_torch.kernels.tree_matvec import kernel as tk_kernel  # noqa: E402
from repro_torch.pdn.tree import build_from_level_sizes  # noqa: E402

# fp64 bar for the plain versions against the reference; fp32 keeps the
# reference suite's own bar
TOL = {np.float64: 1e-12, np.float32: 1e-6}
JNP = {np.float64: jnp.float64, np.float32: jnp.float32}
TDT = {np.float64: torch.float64, np.float32: torch.float32}


def _close(got, *wants, dtype):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    for want in wants:
        np.testing.assert_allclose(got, np.asarray(want), rtol=TOL[dtype], atol=TOL[dtype])


# ---------------------------------------------------------------------------
# pdhg_update
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [7, 128, 1000])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("vector_tau", [False, True])
def test_primal_update_matches_reference(n, dtype, vector_tau):
    rng = np.random.default_rng(n)

    def mk():
        return rng.normal(size=n).astype(dtype)

    x, gx, c, w, target = mk(), mk(), mk(), np.abs(mk()), mk()
    lo = mk() - 2.0
    hi = lo + np.abs(mk()) + 0.1
    tau = np.abs(mk()) + dtype(0.05) if vector_tau else dtype(0.37)
    args = (x, gx, c, w, target, lo, hi, tau)
    with enable_x64(dtype == np.float64):
        jargs = [jnp.asarray(a, JNP[dtype]) for a in args]
        jk = j_primal_update(*jargs)
        jr = j_primal_update_ref(*jargs)
    got = pk.primal_update(*(torch.as_tensor(a) for a in args))
    for g, a, b in zip(got, jk, jr):
        assert g.dtype == torch.from_numpy(x).dtype
        _close(g, a, b, dtype=dtype)


@pytest.mark.parametrize("n", [5, 1024])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("vector_sigma", [False, True])
def test_dual_prox_matches_reference(n, dtype, vector_sigma):
    rng = np.random.default_rng(n + 1)

    def mk():
        return rng.normal(size=n).astype(dtype)

    y, a = mk(), mk()
    lo = np.where(mk() > 0, -np.inf, mk()).astype(dtype)
    hi = np.where(mk() > 0, np.inf, lo + 1.0).astype(dtype)
    sigma = np.abs(mk()) + dtype(0.05) if vector_sigma else dtype(0.21)
    args = (y, a, sigma, lo, hi)
    with enable_x64(dtype == np.float64):
        jargs = [jnp.asarray(v, JNP[dtype]) for v in args]
        jk = j_dual_prox(*jargs)
        jr = j_dual_prox_ref(*jargs)
    got = pk.dual_prox(*(torch.as_tensor(v) for v in args))
    _close(got, jk, jr, dtype=dtype)


# ---------------------------------------------------------------------------
# tree_matvec
# ---------------------------------------------------------------------------


def _tree(sizes):
    pdn = build_from_level_sizes(sizes, gpus_per_server=4)
    return pdn, tk.tree_index(pdn.node_start, pdn.node_end, pdn.n, "cpu")


@pytest.mark.parametrize("sizes", [[2, 2], [3, 2, 2], [4, 4]])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_tree_matvec_matches_reference(sizes, dtype):
    pdn, idx = _tree(sizes)
    x = np.random.default_rng(0).normal(size=pdn.n).astype(dtype)
    with enable_x64(dtype == np.float64):
        jx = jnp.asarray(x, JNP[dtype])
        start, end = jnp.asarray(pdn.node_start), jnp.asarray(pdn.node_end)
        jk = j_tree_matvec(jx, start, end)
        jr = j_tree_matvec_ref(jx, start, end)
    _close(tk.tree_matvec(torch.as_tensor(x), idx), jk, jr, dtype=dtype)


@pytest.mark.parametrize("sizes", [[2, 2], [3, 3]])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_tree_rmatvec_matches_reference(sizes, dtype):
    pdn, idx = _tree(sizes)
    y = np.random.default_rng(1).normal(size=pdn.m).astype(dtype)
    with enable_x64(dtype == np.float64):
        jy = jnp.asarray(y, JNP[dtype])
        start, end = jnp.asarray(pdn.node_start), jnp.asarray(pdn.node_end)
        jk = j_tree_rmatvec(jy, start, end, pdn.n)
        jr = j_tree_rmatvec_ref(jy, start, end, pdn.n)
    _close(tk.tree_rmatvec(torch.as_tensor(y), idx), jk, jr, dtype=dtype)


@pytest.mark.parametrize("block", [64, 256])
def test_tree_matvecs_match_multi_block_reference(block):
    """The reference's forced multi-block prefix grids (cross-block offsets)
    agree with the port's plain versions."""
    pdn, idx = _tree([3, 2, 2])
    rng = np.random.default_rng(5)
    x = rng.normal(size=pdn.n)
    y = rng.normal(size=pdn.m)
    with enable_x64(True):
        start, end = jnp.asarray(pdn.node_start), jnp.asarray(pdn.node_end)
        jk = j_tree_matvec(jnp.asarray(x), start, end, block=block, row_block=block)
        jkt = j_tree_rmatvec(
            jnp.asarray(y), start, end, pdn.n, block=block, row_block=block
        )
    _close(tk.tree_matvec(torch.as_tensor(x), idx), jk, dtype=np.float64)
    _close(tk.tree_rmatvec(torch.as_tensor(y), idx), jkt, dtype=np.float64)


@pytest.mark.parametrize("n", [1, 37, 1025])
def test_tree_index_cover_lists_the_covering_rows(n):
    """The adjoint kernel sums, for each position, the duals of the rows
    listed for it in the covering-rows CSR, in list order.  Each list must be
    exactly the rows with start <= i < end, ascending, for random (also
    empty and end-of-range) rows.  That ordered sum, emulated here on the
    host, matches the plain adjoint to 1e-12 of sum|y| but not bit for bit:
    the plain version scatters a difference array and takes its prefix
    sum, which adds in another order."""
    rng = np.random.default_rng(n)
    m = 2 * n + 4
    s = rng.integers(0, n + 1, m)
    e = rng.integers(0, n + 1, m)
    s, e = np.minimum(s, e), np.maximum(s, e)
    s[:3], e[:3] = [0, n, 0], [n, n, 0]
    idx = tk.tree_index(s, e, n, "cpu")
    ptr, rows = idx.cover_ptr.numpy(), idx.cover_rows.numpy()
    assert ptr[0] == 0 and ptr[-1] == rows.size == int((e - s).sum())
    y = rng.normal(size=m)
    ordered = np.zeros(n)
    for p in range(n):
        listed = rows[ptr[p] : ptr[p + 1]]
        np.testing.assert_array_equal(listed, np.nonzero((s <= p) & (p < e))[0])
        acc = 0.0
        for r in listed:
            acc += y[r]
        ordered[p] = acc
    want = tk.tree_rmatvec(torch.as_tensor(y), idx).numpy()
    np.testing.assert_allclose(ordered, want, rtol=0, atol=1e-12 * np.abs(y).sum())


def test_tree_index_refuses_a_cover_past_int32():
    """Rows that overlap at will can cover more (position, row) pairs than
    the int32 index holds; a tree covers n x depth."""
    n = 2**20
    with pytest.raises(ValueError, match="int32 covering-rows index"):
        tk.tree_index(np.zeros(2100, np.int64), np.full(2100, n), n, "cpu")


def test_tree_index_rejects_malformed_rows():
    with pytest.raises(ValueError, match="start <= end"):
        tk.tree_index([2], [1], 4, "cpu")
    with pytest.raises(ValueError, match="start <= end"):
        tk.tree_index([0], [5], 4, "cpu")


# ---------------------------------------------------------------------------
# tenant (SLA) matvecs
# ---------------------------------------------------------------------------

# the reference's edge chunk, small so the sweep crosses chunk edges
EDGE_BLOCK = 64


def _edges(rng, n, k, e):
    """Random incidence edges: devices may sit in several tenants (and
    repeat within one), tenants may be empty."""
    return rng.integers(0, n, e).astype(np.int32), rng.integers(0, k, e).astype(np.int32)


@pytest.mark.parametrize(
    "e", [0, 1, EDGE_BLOCK - 1, EDGE_BLOCK, EDGE_BLOCK + 1, 3 * EDGE_BLOCK + 5]
)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sla_matvecs_match_reference(e, dtype):
    """Forward and adjoint tenant sums against the reference's chunked
    Pallas kernels (interpret mode) and its jnp oracles, across edge-chunk
    edges and with no edges at all."""
    rng = np.random.default_rng(e)
    n, k = 50, 7
    dev, ten = _edges(rng, n, k, e)
    x = rng.normal(size=n).astype(dtype)
    y = rng.normal(size=k).astype(dtype)
    with enable_x64(dtype == np.float64):
        jx, jy = jnp.asarray(x, JNP[dtype]), jnp.asarray(y, JNP[dtype])
        jdev, jten = jnp.asarray(dev), jnp.asarray(ten)
        jk = j_sla_matvec(jx, jdev, jten, k, edge_block=EDGE_BLOCK)
        jr = j_sla_matvec_ref(jx, jdev, jten, k)
        jkt = j_sla_rmatvec(jy, jdev, jten, n, edge_block=EDGE_BLOCK)
        jrt = j_sla_rmatvec_ref(jy, jdev, jten, n)
    idx = tk.sla_index(dev, ten, k, n, "cpu")
    _close(tk.sla_matvec(torch.as_tensor(x), idx), jk, jr, dtype=dtype)
    _close(tk.sla_rmatvec(torch.as_tensor(y), idx), jkt, jrt, dtype=dtype)


def test_sla_matvecs_without_tenants():
    """k = 0 (no tenant rows): empty sums and a zero adjoint."""
    idx = tk.sla_index([], [], 0, 9, "cpu")
    x = torch.arange(9, dtype=torch.float64)
    assert tk.sla_matvec(x, idx).shape == (0,)
    assert torch.equal(tk.sla_rmatvec(x[:0], idx), torch.zeros(9, dtype=torch.float64))
    with enable_x64(True):
        assert np.asarray(j_sla_matvec(jnp.asarray(x.numpy()), jnp.zeros(0, jnp.int32),
                                       jnp.zeros(0, jnp.int32), 0)).shape == (0,)


# tenant list lengths around the CUDA kernel's warp (32 lanes) and past its
# 128-edge chunk; "all": one tenant holds every edge
LIST_LENGTHS = [0, 1, 31, 32, 33, 1000, "all"]


def _long_list_edges(rng, n, length):
    """Edges of 4 tenants in random edge order: tenant 1 holds ``length``
    edges, tenants 0 and 3 a few, tenant 2 none; or tenant 2 holds all 700
    edges.  Devices repeat within a list."""
    if length == "all":
        ten = np.full(700, 2)
    else:
        ten = np.concatenate([np.zeros(5), np.ones(length), np.full(3, 3)])
        ten = ten[rng.permutation(ten.size)]
    return rng.integers(0, n, ten.size).astype(np.int32), ten.astype(np.int32)


@pytest.mark.parametrize("length", LIST_LENGTHS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sla_matvecs_on_long_lists_match_reference(length, dtype):
    """The warp-per-tenant kernel's cases: empty, short and long tenant
    lists and one tenant holding every edge.  The plain versions (the CPU
    path) against the reference's chunked Pallas kernels (interpret mode)
    and its jnp oracles, and equal bit for bit to the in-order sum of each
    CSR list that the CUDA kernels compute."""
    rng = np.random.default_rng(7 if length == "all" else length)
    n, k = 300, 4
    dev, ten = _long_list_edges(rng, n, length)
    x = rng.normal(size=n).astype(dtype)
    y = rng.normal(size=k).astype(dtype)
    with enable_x64(dtype == np.float64):
        jx, jy = jnp.asarray(x, JNP[dtype]), jnp.asarray(y, JNP[dtype])
        jdev, jten = jnp.asarray(dev), jnp.asarray(ten)
        jk = j_sla_matvec(jx, jdev, jten, k, edge_block=EDGE_BLOCK)
        jr = j_sla_matvec_ref(jx, jdev, jten, k)
        jkt = j_sla_rmatvec(jy, jdev, jten, n, edge_block=EDGE_BLOCK)
        jrt = j_sla_rmatvec_ref(jy, jdev, jten, n)
    idx = tk.sla_index(dev, ten, k, n, "cpu")
    got = tk.sla_matvec(torch.as_tensor(x), idx)
    _close(got, jk, jr, dtype=dtype)
    _close(tk.sla_rmatvec(torch.as_tensor(y), idx), jkt, jrt, dtype=dtype)
    ptr, ids = idx.ten_ptr.numpy(), idx.ten_dev.numpy()
    ordered = np.zeros(k, dtype)
    for t in range(k):
        for d in ids[ptr[t] : ptr[t + 1]]:
            ordered[t] = ordered[t] + x[d]
    np.testing.assert_array_equal(got.numpy(), ordered)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sla_index_csr_reproduces_index_add(seed):
    """The kernels sum each CSR list in its stored order.  Emulated here on
    the host, that sum equals a sequential ``index_add_`` bit for bit,
    forward and adjoint, for devices in several tenants."""
    rng = np.random.default_rng(seed)
    n, k, e = 40, 6, 300
    dev, ten = _edges(rng, n, k, e)
    idx = tk.sla_index(dev, ten, k, n, "cpu")
    x, y = rng.normal(size=n) * 1e3, rng.normal(size=k) * 1e3

    def csr_sums(v, ptr, ids):
        out = np.zeros(len(ptr) - 1)
        for s in range(len(out)):
            acc = 0.0
            for j in ids[ptr[s] : ptr[s + 1]]:
                acc += v[j]
            out[s] = acc
        return out

    fwd = csr_sums(x, idx.ten_ptr.numpy(), idx.ten_dev.numpy())
    adj = csr_sums(y, idx.dev_ptr.numpy(), idx.dev_ten.numpy())
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    dev64, ten64 = torch.as_tensor(dev, dtype=torch.int64), torch.as_tensor(ten, dtype=torch.int64)
    want_fwd = torch.zeros(k, dtype=torch.float64).index_add_(0, ten64, tx[dev64])
    want_adj = torch.zeros(n, dtype=torch.float64).index_add_(0, dev64, ty[ten64])
    np.testing.assert_array_equal(fwd, want_fwd.numpy())
    np.testing.assert_array_equal(adj, want_adj.numpy())
    np.testing.assert_array_equal(tk.sla_matvec(tx, idx).numpy(), fwd)
    np.testing.assert_array_equal(tk.sla_rmatvec(ty, idx).numpy(), adj)


def test_sla_index_rejects_malformed_edges():
    with pytest.raises(ValueError, match="0 <= dev < n"):
        tk.sla_index([4], [0], 1, 4, "cpu")
    with pytest.raises(ValueError, match="0 <= dev < n"):
        tk.sla_index([0], [1], 1, 4, "cpu")
    with pytest.raises(ValueError, match="differ"):
        tk.sla_index([0, 1], [0], 1, 4, "cpu")


# ---------------------------------------------------------------------------
# chunk statistics
# ---------------------------------------------------------------------------

STATS_BLOCK = 128
# float32: the sums of squares add in another order than the reference's
# per-block partials; 1e-5 relative covers a few hundred terms
STATS_TOL = {np.float64: 1e-12, np.float32: 1e-5}


@pytest.mark.parametrize(
    "n", [1, STATS_BLOCK - 1, STATS_BLOCK, STATS_BLOCK + 1, 3 * STATS_BLOCK + 5]
)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_chunk_stats_match_reference(n, dtype):
    """Primal and dual chunk statistics against the reference's Pallas
    kernels (interpret mode, per-block partials) and jnp oracles, across
    block edges: the accumulators and maxima exactly, the sums to
    ``STATS_TOL`` relative."""
    rng = np.random.default_rng(n)
    x, px, rx, ax = (rng.normal(size=n).astype(dtype) for _ in range(4))
    cnt = 3.0
    with enable_x64(dtype == np.float64):
        jargs = [jnp.asarray(v, JNP[dtype]) for v in (x, px, rx, ax)]
        jp = j_primal_chunk_stats(*jargs, cnt, block=STATS_BLOCK)
        jpr = j_primal_chunk_stats_ref(*jargs, cnt)
        jd = j_dual_chunk_stats(*jargs[:3], cnt, block=STATS_BLOCK)
        jdr = j_dual_chunk_stats_ref(*jargs[:3], cnt)
    got_p = pk.primal_chunk_stats(*(torch.as_tensor(v) for v in (x, px, rx, ax)), cnt)
    got_d = pk.dual_chunk_stats(*(torch.as_tensor(v) for v in (x, px, rx)), cnt)
    tol = STATS_TOL[dtype]
    for i, (g, a, b) in enumerate(zip(got_p, jp, jpr)):
        assert g.dtype == torch.from_numpy(x).dtype
        if i < 3:  # accumulator and maxima: no reordering
            np.testing.assert_array_equal(g.numpy(), np.asarray(a))
            np.testing.assert_array_equal(g.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(a), rtol=tol)
            np.testing.assert_allclose(g.numpy(), np.asarray(b), rtol=tol)
    np.testing.assert_array_equal(got_d[0].numpy(), np.asarray(jd[0]))
    for g, a, b in zip(got_d[1:], jd[1:], jdr[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(a), rtol=tol)
        np.testing.assert_allclose(g.numpy(), np.asarray(b), rtol=tol)


@pytest.mark.parametrize("cnt", [3.0, 7.0])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_chunk_stats_plain_versions_divide_exactly(cnt, dtype):
    """The average's travel divides the accumulator by ``cnt`` as the CUDA
    kernels and the reference do, not by a multiply with the reciprocal
    (what torch's CUDA division by a host number does).  One term per draw,
    so the sum is the term: equal to numpy's true division bit for bit, on
    draws where the reciprocal gives other bits."""
    rng = np.random.default_rng(int(cnt))
    by_reciprocal_differs = False
    for _ in range(200):
        x, px, rx, ax = (rng.normal(size=1).astype(dtype) * dtype(100) for _ in range(4))
        want_p = ((ax + x) / dtype(cnt) - rx) ** 2
        want_d = ((ax + x) / dtype(cnt) - px) ** 2
        recip = ((ax + x) * (dtype(1) / dtype(cnt)) - rx) ** 2
        by_reciprocal_differs |= bool(recip[0] != want_p[0])
        got_p = pk.primal_chunk_stats(*(torch.as_tensor(v) for v in (x, px, rx, ax)), cnt)
        got_d = pk.dual_chunk_stats(*(torch.as_tensor(v) for v in (x, px, ax)), cnt)
        assert got_p[4].dtype == torch.from_numpy(x).dtype
        np.testing.assert_array_equal(got_p[4].numpy(), want_p[0])
        np.testing.assert_array_equal(got_d[2].numpy(), want_d[0])
    assert by_reciprocal_differs


def test_chunk_stats_of_an_empty_vector_are_zero():
    """The reference pads to whole blocks with zeros, so nothing moved and
    nothing travelled."""
    z = torch.zeros(0, dtype=torch.float64)
    axn, *rest = pk.primal_chunk_stats(z, z, z, z, 1.0)
    assert axn.shape == (0,) and all(float(v) == 0.0 for v in rest)
    ayn, *rest = pk.dual_chunk_stats(z, z, z, 1.0)
    assert ayn.shape == (0,) and all(float(v) == 0.0 for v in rest)


# ---------------------------------------------------------------------------
# the fused dual step and scaled adjoint of one PDHG iteration
# ---------------------------------------------------------------------------

# (tenants, vector step sizes, t movable, every column pinned): k = 0 and
# k > 0, scalar steps, a pinned t column, and all columns pinned; some
# columns are pinned (mov = 0) in every case
FUSED_CASES = [
    pytest.param(0, True, True, False, id="no-tenants"),
    pytest.param(6, True, True, False, id="tenants"),
    pytest.param(6, False, True, False, id="scalar-steps"),
    pytest.param(6, True, False, False, id="pinned-t"),
    pytest.param(6, True, True, True, id="all-pinned"),
]


def _fused_problem(dtype, k, vector_sigma, t_movable, all_pinned, seed=0):
    """A 48-device tree with k tenants over random edges, random scales,
    duals, step sizes and bounds (each bound vector partly infinite), made
    with numpy from ``seed``: a dict of host arrays."""
    pdn = build_from_level_sizes([3, 2, 2], gpus_per_server=4)
    n, m = pdn.n, pdn.m
    rng = np.random.default_rng(seed)

    def pos(size):
        return (np.abs(rng.normal(size=size)) + 0.1).astype(dtype)

    def bounds(size):
        lo = rng.normal(size=size).astype(dtype)
        hi = lo + pos(size)
        return (np.where(rng.random(size) < 0.3, -np.inf, lo).astype(dtype),
                np.where(rng.random(size) < 0.3, np.inf, hi).astype(dtype))

    dev, ten = (rng.integers(0, n, 3 * k), rng.integers(0, k, 3 * k)) if k else ([], [])
    mov = np.zeros(n) if all_pinned else (rng.random(n) < 0.7)
    p = dict(
        pdn=pdn, n=n, m=m, k=k, dev=np.asarray(dev, np.int32), ten=np.asarray(ten, np.int32),
        s=pos(n), mov=mov.astype(dtype), s_t=dtype(1.7), t_mov=dtype(1.0 if t_movable else 0.0),
        d_tree=pos(m), d_sla=pos(k), d_imp=pos(n),
        xs=rng.normal(size=n).astype(dtype), ts=dtype(0.6),
        y_tree=rng.normal(size=m).astype(dtype), y_sla=rng.normal(size=k).astype(dtype),
        y_imp=rng.normal(size=n).astype(dtype),
    )
    for name, size in (("tree", m), ("sla", k), ("imp", n)):
        p[f"sig_{name}"] = pos(size) if vector_sigma else dtype(0.37)
        p[f"lo_{name}"], p[f"hi_{name}"] = bounds(size)
    return p


def _both_topologies(p, dtype):
    """(reference TreeTopo, SlaTopo, Scales; port TreeTopo, SlaTopo)."""
    pdn, k = p["pdn"], p["k"]
    jt = JTreeTopo(jnp.asarray(pdn.node_start), jnp.asarray(pdn.node_end),
                   jnp.asarray(pdn.node_cap, JNP[dtype]), jnp.asarray(pdn.node_depth))
    js = JSlaTopo(jnp.asarray(p["dev"]), jnp.asarray(p["ten"]), jnp.zeros(k, JNP[dtype]),
                  jnp.ones(k, JNP[dtype]))
    jsc = j_scaling.Scales(*(jnp.asarray(p[f], JNP[dtype]) for f in
                             ("s", "s_t", "mov", "t_mov", "d_tree", "d_sla", "d_imp")))
    tt = TreeTopo.make(pdn.node_start, pdn.node_end, pdn.node_cap, pdn.node_depth, p["n"],
                       dtype=TDT[dtype], device="cpu")
    ts = SlaTopo.make(p["dev"], p["ten"], np.zeros(k), np.ones(k), n=p["n"], dtype=TDT[dtype],
                      device="cpu")
    return jt, js, jsc, tt, ts


@pytest.mark.parametrize("k, vector_sigma, t_movable, all_pinned", FUSED_CASES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dual_update_matches_reference(dtype, k, vector_sigma, t_movable, all_pinned):
    """The fused dual step's plain version (the CPU path of ``dual_update``)
    against the reference's composition: ``scaled_matvec``, then its Pallas
    ``dual_prox`` (interpret mode) on the tree and improvement rows and the
    solver loop's ``_dual_prox`` on the tenant rows."""
    p = _fused_problem(dtype, k, vector_sigma, t_movable, all_pinned)
    with enable_x64(dtype == np.float64):
        jt, js, jsc, tt, ts = _both_topologies(p, dtype)
        J = {key: jnp.asarray(v, JNP[dtype]) for key, v in p.items()
             if isinstance(v, (np.ndarray, np.floating)) and key not in ("dev", "ten")}
        a_tree, a_sla, a_imp = j_scaling.scaled_matvec(J["xs"], J["ts"], jt, js, jsc)
        want = (
            j_dual_prox(J["y_tree"], a_tree, J["sig_tree"], J["lo_tree"], J["hi_tree"],
                        interpret=True),
            j_loop._dual_prox(J["y_sla"] + J["sig_sla"] * a_sla, J["sig_sla"], J["lo_sla"],
                              J["hi_sla"]),
            j_dual_prox(J["y_imp"], a_imp, J["sig_imp"], J["lo_imp"], J["hi_imp"],
                        interpret=True),
        )
    T = {key: torch.as_tensor(v) for key, v in p.items()
         if isinstance(v, (np.ndarray, np.floating)) and key not in ("dev", "ten")}
    xm = T["s"] * T["mov"] * T["xs"]
    blocks = [
        pk.DualBlock(T[f"y_{b}"], a, T[f"d_{b}"], T[f"sig_{b}"], T[f"lo_{b}"], T[f"hi_{b}"])
        for b, a in (("tree", tk.tree_matvec(xm, tt.index)),
                     ("sla", tk.sla_matvec(xm, ts.index)), ("imp", xm))
    ]
    got = pk.dual_update(*blocks, T["s_t"], T["t_mov"], T["ts"])
    assert [g.shape[0] for g in got] == [p["m"], k, p["n"]]
    for g, w in zip(got, want):
        assert g.dtype == T["y_imp"].dtype
        _close(g, w, dtype=dtype)


@pytest.mark.parametrize("k, all_pinned", [(0, False), (6, False), (6, True)])
@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_scaled_rmatvec_matches_reference(dtype, use_kernels, k, all_pinned):
    """The fused scaled adjoint's plain version (the CPU path of
    ``scaled_rmatvec``) against the reference's ``scaled_rmatvec``, through
    its Pallas adjoints (interpret mode) and its jnp ones; ``gt`` as the
    solver forms it from the returned ``yi``.  The port's own
    ``scaling.scaled_rmatvec`` is the same composition, bit for bit."""
    p = _fused_problem(dtype, k, True, True, all_pinned, seed=1)
    with enable_x64(dtype == np.float64):
        jt, js, jsc, tt, ts = _both_topologies(p, dtype)
        jgx, jgt = j_scaling.scaled_rmatvec(
            *(jnp.asarray(p[f], JNP[dtype]) for f in ("y_tree", "y_sla", "y_imp")),
            jt, js, jsc, p["n"], use_kernels=use_kernels,
        )
    T = {f: torch.as_tensor(p[f]) for f in
         ("y_tree", "y_sla", "y_imp", "s", "s_t", "mov", "t_mov", "d_tree", "d_sla", "d_imp")}
    gx, yi = tk.scaled_rmatvec(T["y_tree"], T["y_sla"], T["y_imp"], T["d_tree"], T["d_sla"],
                               T["d_imp"], T["s"] * T["mov"], tt.index, ts.index)
    gt = -T["s_t"] * T["t_mov"] * torch.sum(yi)
    _close(gx, jgx, dtype=dtype)
    _close(gt, jgt, dtype=dtype)
    sc = t_scaling.Scales(*(T[f] for f in ("s", "s_t", "mov", "t_mov", "d_tree", "d_sla",
                                           "d_imp")))
    pgx, pgt = t_scaling.scaled_rmatvec(T["y_tree"], T["y_sla"], T["y_imp"], tt, ts, sc, p["n"])
    assert torch.equal(pgx, gx) and torch.equal(pgt, gt)


@pytest.mark.parametrize("with_tenants", [False, True])
def test_fused_flags_leave_the_cpu_solve_bit_for_bit(with_tenants):
    """On the CPU the fused dual step and scaled adjoint run their plain
    compositions: a control step with the two kernel flags on gives the
    flag-off step's allocation and iterations bit for bit."""
    from repro_torch.core.engine import AllocEngine
    from repro_torch.core.nvpax import NvpaxOptions
    from repro_torch.core.solver import SolverOptions
    from repro_torch.pdn.tenants import assign_tenants

    pdn = build_from_level_sizes([2, 3, 2], gpus_per_server=4)
    lay = assign_tenants(pdn, n_tenants=4, devices_per_tenant=8, seed=1)
    tele = np.random.default_rng(1).uniform(100, 650, pdn.n)
    runs = []
    for flags in ({}, dict(use_pallas=True, use_pallas_tree=True)):
        eng = AllocEngine(
            pdn, sla=lay.sla_topo(device="cpu") if with_tenants else None,
            priority=lay.priority, options=NvpaxOptions(solver=SolverOptions(**flags)),
            device="cpu",
        )
        runs.append(eng.step(tele))
    assert runs[0].stats["phase_iterations"] == runs[1].stats["phase_iterations"]
    np.testing.assert_array_equal(runs[0].allocation, runs[1].allocation)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper never takes the plain path itself: ops dispatches a CPU
    tensor to ``ref``, and the kernel wrappers only take CUDA tensors."""
    pdn, idx = _tree([2, 2])
    x = torch.zeros(pdn.n, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        tk_kernel.tree_matvec(x, idx)
    with pytest.raises(ValueError, match="CUDA"):
        tk_kernel.tree_rmatvec(torch.zeros(pdn.m, dtype=torch.float64), idx)
    with pytest.raises(ValueError, match="CUDA"):
        pk_kernel.primal_update(*([x] * 8))
    with pytest.raises(ValueError, match="CUDA"):
        pk_kernel.dual_prox(*([x] * 5))
    blk = pk.DualBlock(x, x, x, x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        pk_kernel.dual_update(blk, blk, blk, x[0], x[0], x[0])
    with pytest.raises(ValueError, match="CUDA"):
        pk_kernel.primal_chunk_stats(x, x, x, x, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        pk_kernel.dual_chunk_stats(x, x, x, 1.0)
    sidx = tk.sla_index([0, 1], [0, 0], 1, pdn.n, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tk_kernel.sla_matvec(x, sidx)
    with pytest.raises(ValueError, match="CUDA"):
        tk_kernel.sla_rmatvec(torch.zeros(1, dtype=torch.float64), sidx)
    y = torch.zeros(pdn.m, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        tk_kernel.scaled_rmatvec(y, x[:1], x, y, x[:1], x, x, idx, sidx)
