"""ctypes wrappers of the CUDA tree and tenant matvec kernels
(``csrc/tree_matvec.cu``).

Replace ``repro/kernels/tree_matvec/kernel.py:tree_matvec``,
``:tree_rmatvec``, ``:sla_matvec`` and ``:sla_rmatvec`` (Pallas, TPU).  The
source's header comment gives the design and what bounds it: the forward
tree sums are one launch (tile scans, a wait for every tile, the row
gather; a thread block cluster up to 16 tiles, a cooperative grid past
that), the adjoint and the tenant pair are segmented sums over CSR lists
built here once per topology, a warp per list for ``sla_matvec``'s long
tenant lists.  ``scaled_rmatvec`` is the solver's whole scaled adjoint in
one launch: both adjoints' list walks with the row and column scaling
around them.  Each wrapper checks its inputs, allocates its output and
scratch with ``torch.empty``, launches one kernel on the current stream,
raises on a non-zero ``cudaGetLastError``, and counts its launches in
:data:`LAUNCHES`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = [
    "LAUNCHES",
    "SlaIndex",
    "TreeIndex",
    "sla_index",
    "sla_matvec",
    "sla_rmatvec",
    "scaled_rmatvec",
    "tree_index",
    "tree_matvec",
    "tree_rmatvec",
]

LAUNCHES = {
    "tree_matvec": 0,
    "tree_rmatvec": 0,
    "sla_matvec": 0,
    "sla_rmatvec": 0,
    "scaled_rmatvec": 0,
}


class TreeIndex(NamedTuple):
    """Kernel-ready tree rows, made once per topology by :func:`tree_index`.

    ``start``/``end`` are int32 copies of the row ranges.  The covering-rows
    CSR drives the adjoint as one segmented sum without atomics: the rows
    with ``start_j <= i < end_j`` are ``cover_rows[cover_ptr[i]:cover_ptr[i + 1]]``,
    in ascending row order.
    """

    start: torch.Tensor  # [m] int32
    end: torch.Tensor  # [m] int32
    cover_ptr: torch.Tensor  # [n + 1] int32
    cover_rows: torch.Tensor  # [sum(end - start)] int32
    n: int


def _cover(start: np.ndarray, end: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """CSR of the rows covering each position, each list in ascending row
    order: a counting sort, rows written in order into their positions'
    slots."""
    counts = np.cumsum(np.bincount(start, minlength=n + 1) - np.bincount(end, minlength=n + 1))
    ptr = np.concatenate([[0], np.cumsum(counts[:n])])
    cursor = ptr[:-1].copy()
    rows = np.empty(int(ptr[-1]), np.int32)
    for j in np.nonzero(end > start)[0]:
        s, e = start[j], end[j]
        rows[cursor[s:e]] = j
        cursor[s:e] += 1
    return ptr, rows


def _host_index(v) -> np.ndarray:
    host = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return host.astype(np.int64)


def tree_index(start, end, n: int, device) -> TreeIndex:
    """Validate ``0 <= start <= end <= n`` and build the kernel index.

    The covering-rows list has ``sum(end - start)`` entries: ``n x depth``
    for the rows of a tree (49,152 for the paper's fleet), but up to ``m x n``
    for rows that overlap at will.  Raises if it does not fit int32."""
    start, end = _host_index(start), _host_index(end)
    if start.shape != end.shape or start.ndim != 1:
        raise ValueError(f"start/end shapes {start.shape}/{end.shape} differ")
    if ((start < 0) | (start > end) | (end > n)).any():
        raise ValueError(f"tree rows must satisfy 0 <= start <= end <= n={n}")
    if n >= 2**31 or start.shape[0] >= 2**31:
        raise ValueError(f"n={n} does not fit the kernels' int32 positions")
    total = int((end - start).sum())
    if total >= 2**31:
        raise ValueError(
            f"the rows cover {total} (position, row) pairs, more than the kernels' int32 "
            "covering-rows index holds"
        )
    c_ptr, c_rows = _cover(start, end, n)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    return TreeIndex(i32(start), i32(end), i32(c_ptr), i32(c_rows), int(n))


class SlaIndex(NamedTuple):
    """Kernel-ready tenant incidence, made once per tenant topology by
    :func:`sla_index`.

    ``dev``/``ten`` are int32 copies of the edge list (edge ``e`` puts device
    ``dev[e]`` in tenant ``ten[e]``).  The CSR lists drive both sums without
    atomics, each list in edge order: tenant ``t`` sums
    ``x[ten_dev[ten_ptr[t]:ten_ptr[t + 1]]]``, device ``d`` sums
    ``y[dev_ten[dev_ptr[d]:dev_ptr[d + 1]]]``.
    """

    dev: torch.Tensor  # [E] int32
    ten: torch.Tensor  # [E] int32
    ten_ptr: torch.Tensor  # [k + 1] int32
    ten_dev: torch.Tensor  # [E] int32: device ids, grouped by tenant
    dev_ptr: torch.Tensor  # [n + 1] int32
    dev_ten: torch.Tensor  # [E] int32: tenant ids, grouped by device
    k: int
    n: int


def _group(key: np.ndarray, size: int) -> tuple[np.ndarray, np.ndarray]:
    """CSR of edge ids grouped by ``key`` in ``[0, size)``, edge order kept
    within each group (a stable sort)."""
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=size)
    return np.concatenate([[0], np.cumsum(counts)]), order


def sla_index(dev, ten, k: int, n: int, device) -> SlaIndex:
    """Validate ``0 <= dev < n``, ``0 <= ten < k`` and build the kernel
    index."""
    dev, ten = _host_index(dev), _host_index(ten)
    if dev.shape != ten.shape or dev.ndim != 1:
        raise ValueError(f"dev/ten shapes {dev.shape}/{ten.shape} differ")
    if ((dev < 0) | (dev >= n)).any() or ((ten < 0) | (ten >= k)).any():
        raise ValueError(f"tenant edges must satisfy 0 <= dev < n={n}, 0 <= ten < k={k}")
    if max(n, k, dev.shape[0]) >= 2**31:
        raise ValueError("the tenant incidence does not fit the kernels' int32 indices")
    t_ptr, t_order = _group(ten, k)
    d_ptr, d_order = _group(dev, n)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    return SlaIndex(
        i32(dev), i32(ten), i32(t_ptr), i32(dev[t_order]), i32(d_ptr), i32(ten[d_order]),
        int(k), int(n),
    )


def _check_vec(name: str, v: torch.Tensor, size: int) -> None:
    if v.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {v.device}")
    if v.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"{name} must be float64 or float32, got {v.dtype}")
    if v.shape != (size,) or not v.is_contiguous():
        raise ValueError(
            f"{name} must be contiguous of shape ({size},), got {tuple(v.shape)}"
        )


def _check_index(idx: TreeIndex, device: torch.device) -> None:
    for name in ("start", "end", "cover_ptr", "cover_rows"):
        t = getattr(idx, name)
        if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"index.{name} must be contiguous int32 on {device}")


def _suffix(dtype: torch.dtype) -> str:
    return "f64" if dtype == torch.float64 else "f32"


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def tree_matvec(x: torch.Tensor, idx: TreeIndex) -> torch.Tensor:
    """out[j] = sum x[start_j:end_j]: one launch scans the tiles, waits for
    all of them, and gathers the rows."""
    n = idx.n
    m = idx.start.shape[0]
    _check_vec("x", x, n)
    _check_index(idx, x.device)
    out = torch.empty(m, dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    lib = _build.library()
    nb = (n + lib.tree_scan_tile() - 1) // lib.tree_scan_tile()
    # the cooperative path's tile prefixes, totals and offsets; the cluster
    # path keeps them on chip
    size = n + 2 * nb if nb > lib.tree_cluster_tiles() else 0
    scratch = torch.empty(size, dtype=x.dtype, device=x.device)
    fn = getattr(lib, f"tree_matvec_{_suffix(x.dtype)}")
    err = fn(
        x.device.index,
        x.data_ptr(),
        idx.start.data_ptr(),
        idx.end.data_ptr(),
        scratch.data_ptr(),
        out.data_ptr(),
        n,
        m,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on(err, "tree_matvec")
    LAUNCHES["tree_matvec"] += 1
    return out


def tree_rmatvec(y: torch.Tensor, idx: TreeIndex) -> torch.Tensor:
    """Adjoint: out[i] = sum of y over the rows covering position i, in
    ascending row order: one segmented-sum launch over the covering-rows
    CSR."""
    _check_vec("y", y, idx.start.shape[0])
    _check_index(idx, y.device)
    return _segment_sums("tree_rmatvec", y, idx.cover_ptr, idx.cover_rows, idx.n)


def _check_sla_index(idx: SlaIndex, device: torch.device) -> None:
    for name in ("ten_ptr", "ten_dev", "dev_ptr", "dev_ten"):
        t = getattr(idx, name)
        if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"index.{name} must be contiguous int32 on {device}")


def _segment_sums(name, v, ptr, ids, nseg, entry="segment_sums"):
    """Sums over CSR lists through ``entry``: ``segment_sums`` (a thread per
    list) or ``sla_matvec`` (a warp per list)."""
    out = torch.empty(nseg, dtype=v.dtype, device=v.device)
    if ids.shape[0] == 0:
        return out.zero_()  # no edges: zeros without a launch
    fn = getattr(_build.library(), f"{entry}_{_suffix(v.dtype)}")
    err = fn(
        v.device.index,
        v.data_ptr(),
        ptr.data_ptr(),
        ids.data_ptr(),
        nseg,
        out.data_ptr(),
        torch.cuda.current_stream(v.device).cuda_stream,
    )
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def sla_matvec(x: torch.Tensor, idx: SlaIndex) -> torch.Tensor:
    """out[t] = sum of x over tenant t's devices, in edge order: a warp per
    tenant gathers, one lane adds."""
    _check_vec("x", x, idx.n)
    _check_sla_index(idx, x.device)
    return _segment_sums("sla_matvec", x, idx.ten_ptr, idx.ten_dev, idx.k, entry="sla_matvec")


def sla_rmatvec(y: torch.Tensor, idx: SlaIndex) -> torch.Tensor:
    """Adjoint: out[d] = sum of y over device d's tenants, in edge order."""
    _check_vec("y", y, idx.k)
    _check_sla_index(idx, y.device)
    return _segment_sums("sla_rmatvec", y, idx.dev_ptr, idx.dev_ten, idx.n)


def scaled_rmatvec(y_tree, y_sla, y_imp, d_tree, d_sla, d_imp, sm, tree_idx: TreeIndex,
                   sla_idx: SlaIndex):
    """(gx, yi) of the scaled adjoint, one thread per device: its covering
    rows' ``d_tree * y_tree`` summed in list order, then (k > 0) its tenants'
    ``d_sla * y_sla``, then ``yi = d_imp * y_imp`` added, then the product
    with ``sm = s * mov``; the bits of :func:`.ref.scaled_rmatvec_ref`."""
    n, m, k = tree_idx.n, tree_idx.start.shape[0], sla_idx.k
    for name, v, size in (("y_imp", y_imp, n), ("d_imp", d_imp, n), ("sm", sm, n),
                          ("y_tree", y_tree, m), ("d_tree", d_tree, m),
                          ("y_sla", y_sla, k), ("d_sla", d_sla, k)):
        _check_vec(name, v, size)
        if v.dtype != y_imp.dtype or v.device != y_imp.device:
            raise ValueError(f"{name} must be {y_imp.dtype} on {y_imp.device}")
    _check_index(tree_idx, y_imp.device)
    if k:
        if sla_idx.n != n:
            raise ValueError(f"the tenant index is for n={sla_idx.n} devices, not {n}")
        _check_sla_index(sla_idx, y_imp.device)
    gx = torch.empty_like(y_imp)
    yi = torch.empty_like(y_imp)
    fn = getattr(_build.library(), f"scaled_rmatvec_{_suffix(y_imp.dtype)}")
    err = fn(
        y_imp.device.index,
        y_tree.data_ptr(),
        d_tree.data_ptr(),
        tree_idx.cover_ptr.data_ptr(),
        tree_idx.cover_rows.data_ptr(),
        y_sla.data_ptr(),
        d_sla.data_ptr(),
        sla_idx.dev_ptr.data_ptr(),
        sla_idx.dev_ten.data_ptr(),
        y_imp.data_ptr(),
        d_imp.data_ptr(),
        sm.data_ptr(),
        k,
        n,
        gx.data_ptr(),
        yi.data_ptr(),
        torch.cuda.current_stream(y_imp.device).cuda_stream,
    )
    _raise_on(err, "scaled_rmatvec")
    LAUNCHES["scaled_rmatvec"] += 1
    return gx, yi
