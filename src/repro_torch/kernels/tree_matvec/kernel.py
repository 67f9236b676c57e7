"""ctypes wrappers of the CUDA tree matvec kernels (``csrc/tree_matvec.cu``).

Replace ``repro/kernels/tree_matvec/kernel.py:tree_matvec`` and
``:tree_rmatvec`` (Pallas, TPU).  The source's header comment gives the
design and what bounds it.  Each wrapper checks its inputs, allocates its
output and scratch with ``torch.empty``, launches on the current stream,
raises on a non-zero ``cudaGetLastError``, and counts its launches in
:data:`LAUNCHES`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = ["LAUNCHES", "TreeIndex", "tree_index", "tree_matvec", "tree_rmatvec"]

LAUNCHES = {"tree_matvec": 0, "tree_rmatvec": 0}


class TreeIndex(NamedTuple):
    """Kernel-ready tree rows, made once per topology by :func:`tree_index`.

    ``start``/``end`` are int32 copies of the row ranges.  The CSR lists
    drive the adjoint without atomics: the rows whose range starts at
    position ``p < n`` are ``start_rows[start_ptr[p]:start_ptr[p + 1]]`` in
    row order, and likewise for the rows ending at ``p``.
    """

    start: torch.Tensor  # [m] int32
    end: torch.Tensor  # [m] int32
    start_ptr: torch.Tensor  # [n + 1] int32
    start_rows: torch.Tensor  # int32
    end_ptr: torch.Tensor  # [n + 1] int32
    end_rows: torch.Tensor  # int32
    n: int


def _csr(pos: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    rows = np.nonzero(pos < n)[0]
    rows = rows[np.argsort(pos[rows], kind="stable")]
    counts = np.bincount(pos[rows], minlength=n)
    return np.concatenate([[0], np.cumsum(counts)]), rows


def _host_index(v) -> np.ndarray:
    host = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return host.astype(np.int64)


def tree_index(start, end, n: int, device) -> TreeIndex:
    """Validate ``0 <= start <= end <= n`` and build the kernel index."""
    start, end = _host_index(start), _host_index(end)
    if start.shape != end.shape or start.ndim != 1:
        raise ValueError(f"start/end shapes {start.shape}/{end.shape} differ")
    if ((start < 0) | (start > end) | (end > n)).any():
        raise ValueError(f"tree rows must satisfy 0 <= start <= end <= n={n}")
    if n >= 2**31:
        raise ValueError(f"n={n} does not fit the kernels' int32 positions")
    s_ptr, s_rows = _csr(start, n)
    e_ptr, e_rows = _csr(end, n)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    return TreeIndex(
        i32(start), i32(end), i32(s_ptr), i32(s_rows), i32(e_ptr), i32(e_rows), int(n)
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
    for name in ("start", "end", "start_ptr", "start_rows", "end_ptr", "end_rows"):
        t = getattr(idx, name)
        if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"index.{name} must be contiguous int32 on {device}")


def _suffix(dtype: torch.dtype) -> str:
    return "f64" if dtype == torch.float64 else "f32"


def _scratch(n: int, like: torch.Tensor, tile: int) -> tuple[torch.Tensor, torch.Tensor]:
    nb = (n + tile - 1) // tile
    return (
        torch.empty(nb, dtype=like.dtype, device=like.device),
        torch.empty(nb, dtype=like.dtype, device=like.device),
    )


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def tree_matvec(x: torch.Tensor, idx: TreeIndex) -> torch.Tensor:
    """out[j] = sum x[start_j:end_j]: tile scan, offset scan, row gather."""
    n = idx.n
    m = idx.start.shape[0]
    _check_vec("x", x, n)
    _check_index(idx, x.device)
    lib = _build.library()
    totals, offsets = _scratch(n, x, lib.tree_scan_tile())
    local = torch.empty(n, dtype=x.dtype, device=x.device)
    out = torch.empty(m, dtype=x.dtype, device=x.device)
    fn = getattr(lib, f"tree_matvec_{_suffix(x.dtype)}")
    err = fn(
        x.device.index,
        x.data_ptr(),
        idx.start.data_ptr(),
        idx.end.data_ptr(),
        local.data_ptr(),
        totals.data_ptr(),
        offsets.data_ptr(),
        out.data_ptr(),
        n,
        m,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on(err, "tree_matvec")
    LAUNCHES["tree_matvec"] += 1
    return out


def tree_rmatvec(y: torch.Tensor, idx: TreeIndex) -> torch.Tensor:
    """Adjoint: out[i] = sum of y over the rows covering position i.  Each
    position sums its CSR lists in row order, then the same scan runs."""
    n = idx.n
    _check_vec("y", y, idx.start.shape[0])
    _check_index(idx, y.device)
    lib = _build.library()
    totals, offsets = _scratch(n, y, lib.tree_scan_tile())
    out = torch.empty(n, dtype=y.dtype, device=y.device)
    fn = getattr(lib, f"tree_rmatvec_{_suffix(y.dtype)}")
    err = fn(
        y.device.index,
        y.data_ptr(),
        idx.start_ptr.data_ptr(),
        idx.start_rows.data_ptr(),
        idx.end_ptr.data_ptr(),
        idx.end_rows.data_ptr(),
        totals.data_ptr(),
        offsets.data_ptr(),
        out.data_ptr(),
        n,
        torch.cuda.current_stream(y.device).cuda_stream,
    )
    _raise_on(err, "tree_rmatvec")
    LAUNCHES["tree_rmatvec"] += 1
    return out
