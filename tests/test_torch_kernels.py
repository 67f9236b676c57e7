"""The port's kernel modules on the CPU, against the JAX reference.

Each kernel's plain PyTorch version (``repro_torch.kernels.*.ref``, which
``ops`` runs for a CPU tensor) is held against the reference's Pallas kernel
in interpret mode and against its jnp oracle, on the sweeps of
``tests/test_kernels.py`` at small n.  Inputs are made with numpy from a
seed and handed to both packages.  The CUDA kernels themselves run only on
the card (``tests/test_torch_kernels_cuda.py``); here the host-side parts
they depend on (the CSR index of the adjoint, the wrappers' refusal of CPU
tensors) are checked.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.compat import enable_x64  # noqa: E402
from repro.kernels.pdhg_update import dual_prox as j_dual_prox  # noqa: E402
from repro.kernels.pdhg_update import primal_update as j_primal_update  # noqa: E402
from repro.kernels.pdhg_update.ref import dual_prox_ref as j_dual_prox_ref  # noqa: E402
from repro.kernels.pdhg_update.ref import (  # noqa: E402
    primal_update_ref as j_primal_update_ref,
)
from repro.kernels.tree_matvec import tree_matvec as j_tree_matvec  # noqa: E402
from repro.kernels.tree_matvec import tree_rmatvec as j_tree_rmatvec  # noqa: E402
from repro.kernels.tree_matvec.ref import tree_matvec_ref as j_tree_matvec_ref  # noqa: E402
from repro.kernels.tree_matvec.ref import (  # noqa: E402
    tree_rmatvec_ref as j_tree_rmatvec_ref,
)
from repro_torch.kernels import pdhg_update as pk  # noqa: E402
from repro_torch.kernels import tree_matvec as tk  # noqa: E402
from repro_torch.kernels.pdhg_update import kernel as pk_kernel  # noqa: E402
from repro_torch.kernels.tree_matvec import kernel as tk_kernel  # noqa: E402
from repro_torch.pdn.tree import build_from_level_sizes  # noqa: E402

# fp64 bar for the plain versions against the reference; fp32 keeps the
# reference suite's own bar
TOL = {np.float64: 1e-12, np.float32: 1e-6}
JNP = {np.float64: jnp.float64, np.float32: jnp.float32}


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
def test_tree_index_csr_reproduces_difference_array(n):
    """The adjoint kernel loads each position's difference-array entry from
    the CSR lists, summing in row order.  Emulated here on the host, that
    load followed by a prefix sum equals the plain adjoint bit for bit, for
    random (also empty and end-of-range) rows."""
    rng = np.random.default_rng(n)
    m = 2 * n + 4
    s = rng.integers(0, n + 1, m)
    e = rng.integers(0, n + 1, m)
    s, e = np.minimum(s, e), np.maximum(s, e)
    s[:3], e[:3] = [0, n, 0], [n, n, 0]
    idx = tk.tree_index(s, e, n, "cpu")
    y = rng.normal(size=m)
    sp, sr = idx.start_ptr.numpy(), idx.start_rows.numpy()
    ep, er = idx.end_ptr.numpy(), idx.end_rows.numpy()
    diff = np.zeros(n)
    for p in range(n):
        acc = 0.0
        for r in sr[sp[p] : sp[p + 1]]:
            acc += y[r]
        for r in er[ep[p] : ep[p + 1]]:
            acc -= y[r]
        diff[p] = acc
    want = tk.tree_rmatvec(torch.as_tensor(y), idx).numpy()
    np.testing.assert_array_equal(np.cumsum(diff), want)


def test_tree_index_rejects_malformed_rows():
    with pytest.raises(ValueError, match="start <= end"):
        tk.tree_index([2], [1], 4, "cpu")
    with pytest.raises(ValueError, match="start <= end"):
        tk.tree_index([0], [5], 4, "cpu")


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
