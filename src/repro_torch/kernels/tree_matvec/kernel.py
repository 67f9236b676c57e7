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
around them; ``primal_step`` is that launch with the primal update of the
same iteration as its epilogue, its fixed inputs checked once per solve
(:func:`primal_step_plan`).  Each wrapper checks its inputs, allocates its
output and scratch with ``torch.empty``, launches one kernel on the current stream,
raises on a non-zero ``cudaGetLastError``, and counts its launches in
:data:`LAUNCHES`.

Every wrapper also takes K lanes of its vectors, ``[K, size]`` contiguous,
over the one index it is given (the K-scenario path): one launch covers
the K lanes, each lane's result the bits of a launch on that lane alone;
such a launch is also counted in :data:`LANE_LAUNCHES`.  An index built
from K topologies (``[K, m]`` rows, ``[K, E]`` edges: a stacked fleet's
domains) carries a lane axis of its own: its arrays are laid end to end per
lane, and each kernel reads lane L's topology at L times the array's lane
stride (the stride is 0 for an index shared by every lane).  Such an index
takes exactly its K lanes.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.tree_matvec.ref import PrimalStepData

__all__ = [
    "LANE_LAUNCHES",
    "LAUNCHES",
    "PrimalStepPlan",
    "SlaIndex",
    "TreeIndex",
    "primal_step",
    "primal_step_plan",
    "sla_index",
    "sla_index_update",
    "sla_matvec",
    "sla_rmatvec",
    "scaled_rmatvec",
    "tree_index",
    "tree_index_update",
    "tree_matvec",
    "tree_rmatvec",
]

LAUNCHES = {
    "tree_matvec": 0,
    "tree_rmatvec": 0,
    "sla_matvec": 0,
    "sla_rmatvec": 0,
    "scaled_rmatvec": 0,
    "primal_step": 0,
}
# the launches above that took [K, size] lanes
LANE_LAUNCHES = dict.fromkeys(LAUNCHES, 0)

# the grid's y axis holds the lanes (csrc/tree_matvec.cu)
MAX_LANES = 65_535


class TreeIndex(NamedTuple):
    """Kernel-ready tree rows, made once per topology by :func:`tree_index`.

    ``start``/``end`` are int32 copies of the row ranges.  The covering-rows
    CSR drives the adjoint as one segmented sum without atomics: the rows
    with ``start_j <= i < end_j`` are ``cover_rows[cover_ptr[i]:cover_ptr[i + 1]]``,
    in ascending row order.

    Built from K topologies every array has a leading lane axis: lane L's
    rows are ``start[L]``/``end[L]``, its pointers ``cover_ptr[L]`` index its
    own list ``cover_rows[L]``, which is padded to the index's capacity (the
    longest list it was sized for), so that :func:`tree_index_update` can
    rewrite one lane in place.
    """

    start: torch.Tensor  # [m] int32, or [K, m]
    end: torch.Tensor  # [m] int32, or [K, m]
    cover_ptr: torch.Tensor  # [n + 1] int32, or [K, n + 1]
    cover_rows: torch.Tensor  # [sum(end - start)] int32, or [K, capacity]
    n: int

    @property
    def m(self) -> int:
        return self.start.shape[-1]

    @property
    def lanes(self) -> int:
        """K for an index of K topologies, 0 for one shared by every lane."""
        return self.start.shape[0] if self.start.ndim == 2 else 0


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


def _check_rows(start: np.ndarray, end: np.ndarray, n: int) -> int:
    """``0 <= start <= end <= n`` within int32; returns the covering-rows
    list's length, ``sum(end - start)``."""
    if ((start < 0) | (start > end) | (end > n)).any():
        raise ValueError(f"tree rows must satisfy 0 <= start <= end <= n={n}")
    if n >= 2**31 or start.shape[-1] >= 2**31:
        raise ValueError(f"n={n} does not fit the kernels' int32 positions")
    total = int((end - start).sum())
    if total >= 2**31:
        raise ValueError(
            f"the rows cover {total} (position, row) pairs, more than the kernels' int32 "
            "covering-rows index holds"
        )
    return total


def _i32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)


def tree_index(start, end, n: int, device, *, capacity: int | None = None) -> TreeIndex:
    """Validate ``0 <= start <= end <= n`` and build the kernel index.

    The covering-rows list has ``sum(end - start)`` entries: ``n x depth``
    for the rows of a tree (49,152 for the paper's fleet), but up to ``m x n``
    for rows that overlap at will.  Raises if it does not fit int32.

    ``[K, m]`` rows build an index of K topologies (one per lane), each
    lane's covering-rows list padded to ``capacity`` entries (default: the
    longest lane's)."""
    start, end = _host_index(start), _host_index(end)
    if start.shape != end.shape or start.ndim not in (1, 2):
        raise ValueError(f"start/end shapes {start.shape}/{end.shape} differ")
    if start.ndim == 1:
        _check_rows(start, end, n)
        c_ptr, c_rows = _cover(start, end, n)
        return TreeIndex(_i32(start, device), _i32(end, device), _i32(c_ptr, device),
                         _i32(c_rows, device), int(n))
    if not 1 <= start.shape[0] <= MAX_LANES:
        raise ValueError(f"{start.shape[0]} topologies: an index takes 1 to {MAX_LANES}")
    totals = [_check_rows(s, e, n) for s, e in zip(start, end)]
    capacity = max(totals) if capacity is None else int(capacity)
    if capacity < max(totals) or capacity >= 2**31:
        raise ValueError(f"capacity {capacity} does not hold the longest lane's {max(totals)}")
    ptr = np.zeros((start.shape[0], n + 1), np.int64)
    rows = np.zeros((start.shape[0], capacity), np.int32)
    for j, (s, e) in enumerate(zip(start, end)):
        ptr[j], r = _cover(s, e, n)
        rows[j, : r.shape[0]] = r
    return TreeIndex(_i32(start, device), _i32(end, device), _i32(ptr, device),
                     _i32(rows, device), int(n))


def tree_index_update(idx: TreeIndex, lane: int, start, end) -> None:
    """Rewrite lane ``lane`` of an index of K topologies in place with new
    rows of the same count: the buffers stay where they are (a captured
    launch keeps its addresses), the other lanes are not touched.  Raises if
    the new covering-rows list is longer than the index's capacity."""
    if not idx.lanes:
        raise ValueError("tree_index_update takes an index of K topologies")
    start, end = _host_index(start), _host_index(end)
    if start.shape != (idx.m,) or end.shape != (idx.m,):
        raise ValueError(f"lane rows must be ({idx.m},), got {start.shape}/{end.shape}")
    total = _check_rows(start, end, idx.n)
    if total > idx.cover_rows.shape[-1]:
        raise ValueError(
            f"the new rows cover {total} (position, row) pairs, past the index's capacity "
            f"{idx.cover_rows.shape[-1]}"
        )
    ptr, rows = _cover(start, end, idx.n)
    padded = np.zeros(idx.cover_rows.shape[-1], np.int32)
    padded[: rows.shape[0]] = rows
    dev = idx.start.device
    for buf, host in ((idx.start, start), (idx.end, end), (idx.cover_ptr, ptr),
                      (idx.cover_rows, padded)):
        buf[lane].copy_(_i32(host, dev))


class SlaIndex(NamedTuple):
    """Kernel-ready tenant incidence, made once per tenant topology by
    :func:`sla_index`.

    ``dev``/``ten`` are int32 copies of the edge list (edge ``e`` puts device
    ``dev[e]`` in tenant ``ten[e]``).  The CSR lists drive both sums without
    atomics, each list in edge order: tenant ``t`` sums
    ``x[ten_dev[ten_ptr[t]:ten_ptr[t + 1]]]``, device ``d`` sums
    ``y[dev_ten[dev_ptr[d]:dev_ptr[d + 1]]]``.
    """

    dev: torch.Tensor  # [E] int32, or [K, E]
    ten: torch.Tensor  # [E] int32, or [K, E]
    ten_ptr: torch.Tensor  # [k + 1] int32, or [K, k + 1]
    ten_dev: torch.Tensor  # [E] int32: device ids, grouped by tenant; or [K, E]
    dev_ptr: torch.Tensor  # [n + 1] int32, or [K, n + 1]
    dev_ten: torch.Tensor  # [E] int32: tenant ids, grouped by device; or [K, E]
    k: int
    n: int

    @property
    def lanes(self) -> int:
        """K for an index of K incidences (each lane its own ``[E]`` edges,
        its pointers offsets into its own lists), 0 for one shared by every
        lane."""
        return self.dev.shape[0] if self.dev.ndim == 2 else 0


def _group(key: np.ndarray, size: int) -> tuple[np.ndarray, np.ndarray]:
    """CSR of edge ids grouped by ``key`` in ``[0, size)``, edge order kept
    within each group (a stable sort)."""
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=size)
    return np.concatenate([[0], np.cumsum(counts)]), order


def _sla_lists(dev: np.ndarray, ten: np.ndarray, k: int, n: int):
    """(ten_ptr, ten_dev, dev_ptr, dev_ten) of one edge list."""
    t_ptr, t_order = _group(ten, k)
    d_ptr, d_order = _group(dev, n)
    return t_ptr, dev[t_order], d_ptr, ten[d_order]


def sla_index(dev, ten, k: int, n: int, device) -> SlaIndex:
    """Validate ``0 <= dev < n``, ``0 <= ten < k`` and build the kernel
    index; ``[K, E]`` edges build an index of K incidences, one per lane."""
    dev, ten = _host_index(dev), _host_index(ten)
    if dev.shape != ten.shape or dev.ndim not in (1, 2):
        raise ValueError(f"dev/ten shapes {dev.shape}/{ten.shape} differ")
    if ((dev < 0) | (dev >= n)).any() or ((ten < 0) | (ten >= k)).any():
        raise ValueError(f"tenant edges must satisfy 0 <= dev < n={n}, 0 <= ten < k={k}")
    if max(n, k, dev.shape[-1]) >= 2**31:
        raise ValueError("the tenant incidence does not fit the kernels' int32 indices")
    if dev.ndim == 2:
        if not 1 <= dev.shape[0] <= MAX_LANES:
            raise ValueError(f"{dev.shape[0]} incidences: an index takes 1 to {MAX_LANES}")
        lists = [np.stack(a) for a in zip(*(_sla_lists(d, t, k, n) for d, t in zip(dev, ten)))]
    else:
        lists = _sla_lists(dev, ten, k, n)
    return SlaIndex(_i32(dev, device), _i32(ten, device), *(_i32(a, device) for a in lists),
                    int(k), int(n))


def sla_index_update(idx: SlaIndex, lane: int, dev, ten) -> None:
    """Rewrite lane ``lane`` of an index of K incidences in place with a new
    edge list of the same length (the buffers stay where they are)."""
    if not idx.lanes:
        raise ValueError("sla_index_update takes an index of K incidences")
    dev, ten = _host_index(dev), _host_index(ten)
    e = idx.dev.shape[-1]
    if dev.shape != (e,) or ten.shape != (e,):
        raise ValueError(f"lane edges must be ({e},), got {dev.shape}/{ten.shape}")
    if ((dev < 0) | (dev >= idx.n)).any() or ((ten < 0) | (ten >= idx.k)).any():
        raise ValueError(
            f"tenant edges must satisfy 0 <= dev < n={idx.n}, 0 <= ten < k={idx.k}"
        )
    device = idx.dev.device
    host = (dev, ten) + _sla_lists(dev, ten, idx.k, idx.n)
    for buf, h in zip(idx[:6], host):
        buf[lane].copy_(_i32(h, device))


def _check_vec(name: str, v: torch.Tensor, size: int, lead: tuple = ()) -> None:
    """``v`` a contiguous float CUDA tensor of shape ``lead + (size,)``:
    ``lead`` is ``()`` for one vector, ``(K,)`` for K lanes."""
    if v.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {v.device}")
    if v.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"{name} must be float64 or float32, got {v.dtype}")
    if v.shape != tuple(lead) + (size,) or not v.is_contiguous():
        raise ValueError(
            f"{name} must be contiguous of shape {tuple(lead) + (size,)}, got {tuple(v.shape)}"
        )


def _lead(v: torch.Tensor) -> tuple:
    """``()`` for a vector, ``(K,)`` for K lanes of vectors."""
    if v.ndim not in (1, 2):
        raise ValueError(f"expected a vector or [K, size] lanes, got shape {tuple(v.shape)}")
    if v.ndim == 2 and not 1 <= v.shape[0] <= MAX_LANES:
        raise ValueError(f"{v.shape[0]} lanes: a launch takes 1 to {MAX_LANES}")
    return tuple(v.shape[:-1])


def _lane_stride(t: torch.Tensor) -> int:
    """The lane stride of an index array: its row length with a lane axis,
    0 when every lane shares it."""
    return t.shape[-1] if t.ndim == 2 else 0


def _check_lanes(idx, lead: tuple) -> None:
    """An index of K topologies takes exactly K lanes."""
    if idx.lanes and lead != (idx.lanes,):
        raise ValueError(
            f"an index of {idx.lanes} topologies takes [{idx.lanes}, size] lanes, got "
            f"{'one vector' if not lead else f'{lead[0]} lanes'}"
        )


def _count(name: str, lead: tuple) -> None:
    LAUNCHES[name] += 1
    if lead:
        LANE_LAUNCHES[name] += 1


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
    all of them, and gathers the rows (for each lane of ``[K, n]`` lanes)."""
    n = idx.n
    m = idx.m
    lead = _lead(x)
    lanes = lead[0] if lead else 1
    _check_vec("x", x, n, lead)
    _check_index(idx, x.device)
    _check_lanes(idx, lead)
    out = torch.empty(lead + (m,), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    lib = _build.library()
    nb = (n + lib.tree_scan_tile() - 1) // lib.tree_scan_tile()
    # the cooperative path's tile prefixes, totals and offsets, per lane;
    # the cluster path keeps them on chip
    size = lanes * (n + 2 * nb) if nb > lib.tree_cluster_tiles() else 0
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
        _lane_stride(idx.start),  # 0: one topology for every lane
        lanes,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on(err, "tree_matvec")
    _count("tree_matvec", lead)
    return out


def tree_rmatvec(y: torch.Tensor, idx: TreeIndex) -> torch.Tensor:
    """Adjoint: out[i] = sum of y over the rows covering position i, in
    ascending row order: one segmented-sum launch over the covering-rows
    CSR."""
    _check_vec("y", y, idx.m, _lead(y))
    _check_index(idx, y.device)
    _check_lanes(idx, _lead(y))
    return _segment_sums("tree_rmatvec", y, idx.cover_ptr, idx.cover_rows, idx.n)


def _check_sla_index(idx: SlaIndex, device: torch.device) -> None:
    for name in ("ten_ptr", "ten_dev", "dev_ptr", "dev_ten"):
        t = getattr(idx, name)
        if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"index.{name} must be contiguous int32 on {device}")


def _segment_sums(name, v, ptr, ids, nseg, entry="segment_sums"):
    """Sums over CSR lists through ``entry``: ``segment_sums`` (a thread per
    list) or ``sla_matvec`` (a warp per list); each lane of ``v`` over the
    same lists, or over its own (``[K, ...]`` lists)."""
    lead = tuple(v.shape[:-1])
    out = torch.empty(lead + (nseg,), dtype=v.dtype, device=v.device)
    if ids.shape[-1] == 0:
        return out.zero_()  # no edges: zeros without a launch
    fn = getattr(_build.library(), f"{entry}_{_suffix(v.dtype)}")
    err = fn(
        v.device.index,
        v.data_ptr(),
        v.shape[-1],  # a lane's values
        ptr.data_ptr(),
        _lane_stride(ptr),  # 0: one index for every lane
        ids.data_ptr(),
        _lane_stride(ids),
        nseg,
        lead[0] if lead else 1,
        out.data_ptr(),
        torch.cuda.current_stream(v.device).cuda_stream,
    )
    _raise_on(err, name)
    _count(name, lead)
    return out


def sla_matvec(x: torch.Tensor, idx: SlaIndex) -> torch.Tensor:
    """out[t] = sum of x over tenant t's devices, in edge order: a warp per
    tenant gathers, one lane adds."""
    _check_vec("x", x, idx.n, _lead(x))
    _check_sla_index(idx, x.device)
    _check_lanes(idx, _lead(x))
    return _segment_sums("sla_matvec", x, idx.ten_ptr, idx.ten_dev, idx.k, entry="sla_matvec")


def sla_rmatvec(y: torch.Tensor, idx: SlaIndex) -> torch.Tensor:
    """Adjoint: out[d] = sum of y over device d's tenants, in edge order."""
    _check_vec("y", y, idx.k, _lead(y))
    _check_sla_index(idx, y.device)
    _check_lanes(idx, _lead(y))
    return _segment_sums("sla_rmatvec", y, idx.dev_ptr, idx.dev_ten, idx.n)


def _check_like(like: torch.Tensor, named) -> None:
    """Each (name, vector, size) of ``named`` contiguous of that size, with
    ``like``'s lanes, float dtype and CUDA device."""
    lead = _lead(like)
    for name, v, size in named:
        _check_vec(name, v, size, lead)
        if v.dtype != like.dtype or v.device != like.device:
            raise ValueError(f"{name} must be {like.dtype} on {like.device}")


def _check_indexes(tree_idx: TreeIndex, sla_idx: SlaIndex, device: torch.device,
                   lead: tuple) -> None:
    """The scaled adjoint's two indexes on ``device``, over the same
    devices, for these lanes; the tenant one is read only when it has
    tenants."""
    _check_index(tree_idx, device)
    _check_lanes(tree_idx, lead)
    if sla_idx.k:
        if sla_idx.n != tree_idx.n:
            raise ValueError(f"the tenant index is for n={sla_idx.n} devices, not {tree_idx.n}")
        _check_sla_index(sla_idx, device)
        _check_lanes(sla_idx, lead)


def scaled_rmatvec(y_tree, y_sla, y_imp, d_tree, d_sla, d_imp, sm, tree_idx: TreeIndex,
                   sla_idx: SlaIndex):
    """(gx, yi) of the scaled adjoint, one thread per device: its covering
    rows' ``d_tree * y_tree`` summed in list order, then (k > 0) its tenants'
    ``d_sla * y_sla``, then ``yi = d_imp * y_imp`` added, then the product
    with ``sm = s * mov``; the bits of :func:`.ref.scaled_rmatvec_ref`."""
    n, m, k = tree_idx.n, tree_idx.m, sla_idx.k
    _check_like(y_imp, (("y_imp", y_imp, n), ("d_imp", d_imp, n), ("sm", sm, n),
                        ("y_tree", y_tree, m), ("d_tree", d_tree, m),
                        ("y_sla", y_sla, k), ("d_sla", d_sla, k)))
    lead = _lead(y_imp)
    _check_indexes(tree_idx, sla_idx, y_imp.device, lead)
    gx = torch.empty_like(y_imp)
    yi = torch.empty_like(y_imp)
    adj = _adjoint(y_tree, d_tree, y_sla, d_sla, y_imp, d_imp, sm, tree_idx, sla_idx)
    fn = getattr(_build.library(), f"scaled_rmatvec_{_suffix(y_imp.dtype)}")
    err = fn(y_imp.device.index, adj, lead[0] if lead else 1, gx.data_ptr(), yi.data_ptr(),
             torch.cuda.current_stream(y_imp.device).cuda_stream)
    _raise_on(err, "scaled_rmatvec")
    _count("scaled_rmatvec", lead)
    return gx, yi


def _adjoint(y_tree, d_tree, y_sla, d_sla, y_imp, d_imp, sm, tree_idx, sla_idx):
    """The ``ScaledAdjoint`` of these tensors (``None`` duals: a null
    pointer, filled in per call), each index read through its lane strides
    (0 when every lane shares it)."""

    def ptr(v):
        return None if v is None else v.data_ptr()

    return _build.ScaledAdjoint(
        y_tree=ptr(y_tree), d_tree=ptr(d_tree), cover_ptr=tree_idx.cover_ptr.data_ptr(),
        cover_rows=tree_idx.cover_rows.data_ptr(), y_sla=ptr(y_sla), d_sla=ptr(d_sla),
        dev_ptr=sla_idx.dev_ptr.data_ptr(), dev_ten=sla_idx.dev_ten.data_ptr(),
        y_imp=ptr(y_imp), d_imp=ptr(d_imp), sm=ptr(sm), k=sla_idx.k, n=tree_idx.n,
        m=tree_idx.m, cover_ptr_lane=_lane_stride(tree_idx.cover_ptr),
        cover_rows_lane=_lane_stride(tree_idx.cover_rows),
        dev_ptr_lane=_lane_stride(sla_idx.dev_ptr), dev_ten_lane=_lane_stride(sla_idx.dev_ten),
    )


class PrimalStepPlan(NamedTuple):
    """:class:`PrimalStepData` checked for the kernel, with its pointers laid
    out once (``fixed``: a ``PrimalStepArgs`` whose per-call fields are left
    empty) and the kernel's entry point.  Made by :func:`primal_step_plan`."""

    data: PrimalStepData
    fixed: _build.PrimalStepArgs
    fn: Any


def primal_step_plan(data: PrimalStepData) -> PrimalStepPlan:
    """Check the solve's fixed inputs of :func:`primal_step` once: CUDA
    tensors of one float dtype, contiguous, of the index's sizes."""
    tree_idx, sla_idx = data.tree_idx, data.sla_idx
    n, m, k = tree_idx.n, tree_idx.m, sla_idx.k
    like = data.sm
    _check_like(like, [(name, getattr(data, name), size) for name, size in (
        ("c", n), ("w", n), ("target", n), ("lo", n), ("hi", n), ("d_tree", m), ("d_sla", k),
        ("d_imp", n), ("sm", n))])
    _check_indexes(tree_idx, sla_idx, like.device, _lead(like))
    adj = _adjoint(None, data.d_tree, None, data.d_sla, None, data.d_imp, data.sm, tree_idx,
                   sla_idx)
    fixed = _build.PrimalStepArgs(
        adj=adj, c=data.c.data_ptr(), w=data.w.data_ptr(), target=data.target.data_ptr(),
        lo=data.lo.data_ptr(), hi=data.hi.data_ptr(),
    )
    fn = getattr(_build.library(), f"primal_step_{_suffix(like.dtype)}")
    return PrimalStepPlan(data, fixed, fn)


def primal_step(x, y_tree, y_sla, y_imp, tau, plan: PrimalStepPlan):
    """(x1, xe, xm, yi) of :func:`.ref.primal_step_ref`, bit for bit, in one
    launch: the scaled adjoint of (y_tree, y_sla, y_imp), then the primal
    prox and extrapolation of ``x`` with step ``tau`` (a [n] vector or a 0-d
    tensor; with K lanes a ``[K, n]`` vector, a ``[K, 1]`` column or one 0-d
    tensor for every lane) and ``xm = sm * xe``.  Only the per-call inputs
    are checked; the plan's were checked when it was made."""
    if not isinstance(plan, PrimalStepPlan):
        raise TypeError("primal_step on a card takes a PrimalStepPlan (primal_step_plan)")
    like = plan.data.sm
    lead = tuple(like.shape[:-1])
    n, m, k = plan.fixed.adj.n, plan.fixed.adj.m, plan.fixed.adj.k
    _check_like(like, (("x", x, n), ("y_tree", y_tree, m), ("y_sla", y_sla, k),
                       ("y_imp", y_imp, n)))
    if not isinstance(tau, torch.Tensor) or tau.dtype != like.dtype or tau.device != like.device:
        raise ValueError(f"tau must be a {like.dtype} tensor on {like.device}")
    if tau.ndim == 0:
        tau_stride = tau_lane = 0
    elif lead and tau.shape == lead + (1,):
        tau_stride, tau_lane = 0, 1
    else:
        _check_vec("tau", tau, n, lead)
        tau_stride, tau_lane = 1, n
    x1, xe, xm, yi = (torch.empty_like(x) for _ in range(4))
    args = _build.PrimalStepArgs.from_buffer_copy(plan.fixed)
    args.adj.y_tree = y_tree.data_ptr()
    args.adj.y_sla = y_sla.data_ptr()
    args.adj.y_imp = y_imp.data_ptr()
    args.x = x.data_ptr()
    args.tau = tau.data_ptr()
    args.tau_stride = tau_stride
    args.tau_lane = tau_lane
    args.x1, args.xe, args.xm, args.yi = (v.data_ptr() for v in (x1, xe, xm, yi))
    err = plan.fn(x.device.index, args, lead[0] if lead else 1,
                  torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "primal_step")
    _count("primal_step", lead)
    return x1, xe, xm, yi
