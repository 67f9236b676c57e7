"""ctypes wrappers of the fused CUDA PDHG update kernels
(``csrc/pdhg_update.cu``).

Replace ``repro/kernels/pdhg_update/kernel.py:primal_update``,
``:dual_prox``, ``:primal_chunk_stats`` and ``:dual_chunk_stats`` (Pallas,
TPU); ``dual_update`` is ``dual_prox`` redesigned as the solver's whole dual
step, with the row scaling before it, in one launch.  The source's header
comment gives the design and what bounds it.  Each wrapper checks its
inputs, allocates its outputs with ``torch.empty``, launches on the current
stream, raises on a non-zero ``cudaGetLastError``, and counts its launches
in :data:`LAUNCHES`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pdhg_update.ref import DualBlock

__all__ = [
    "LAUNCHES",
    "dual_chunk_stats",
    "dual_prox",
    "dual_update",
    "primal_chunk_stats",
    "primal_update",
]

LAUNCHES = {
    "primal_update": 0,
    "dual_prox": 0,
    "dual_update": 0,
    "primal_chunk_stats": 0,
    "dual_chunk_stats": 0,
}


def _check(names: str, tensors, n: int, like: torch.Tensor) -> None:
    if like.device.type != "cuda":
        raise ValueError(f"expected CUDA tensors, got {like.device}")
    if like.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"expected float64 or float32, got {like.dtype}")
    for name, v in zip(names.split(), tensors):
        if v.device != like.device or v.dtype != like.dtype:
            raise ValueError(f"{name} must be {like.dtype} on {like.device}")
        if v.shape != (n,) or not v.is_contiguous():
            raise ValueError(
                f"{name} must be contiguous of shape ({n},), got {tuple(v.shape)}"
            )


def _step(name: str, s, n: int, like: torch.Tensor) -> tuple[torch.Tensor, int]:
    """A step size as (buffer, stride): a [n] vector read with stride 1, or
    one scalar (Python number or 0-d tensor) broadcast with stride 0."""
    if not isinstance(s, torch.Tensor):
        return torch.full((1,), float(s), dtype=like.dtype, device=like.device), 0
    if s.ndim == 0:
        if s.device != like.device or s.dtype != like.dtype:
            raise ValueError(f"{name} must be {like.dtype} on {like.device}")
        return s.reshape(1), 0
    _check(name, (s,), n, like)
    return s, 1


def _suffix(dtype: torch.dtype) -> str:
    return "f64" if dtype == torch.float64 else "f32"


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def primal_update(x, gx, c, w, target, lo, hi, tau):
    """(x1, xe) of the fused primal prox + extrapolation."""
    n = x.shape[0]
    _check("x gx c w target lo hi", (x, gx, c, w, target, lo, hi), n, x)
    tau_buf, tau_stride = _step("tau", tau, n, x)
    x1 = torch.empty_like(x)
    xe = torch.empty_like(x)
    fn = getattr(_build.library(), f"primal_update_{_suffix(x.dtype)}")
    err = fn(
        x.device.index,
        x.data_ptr(),
        gx.data_ptr(),
        c.data_ptr(),
        w.data_ptr(),
        target.data_ptr(),
        lo.data_ptr(),
        hi.data_ptr(),
        tau_buf.data_ptr(),
        tau_stride,
        n,
        x1.data_ptr(),
        xe.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on(err, "primal_update")
    LAUNCHES["primal_update"] += 1
    return x1, xe


def dual_prox(y, a, sigma, lo, hi):
    """z - sigma * clip(z / sigma, lo, hi) with z = y + sigma * a."""
    n = y.shape[0]
    _check("y a lo hi", (y, a, lo, hi), n, y)
    sig_buf, sig_stride = _step("sigma", sigma, n, y)
    out = torch.empty_like(y)
    fn = getattr(_build.library(), f"dual_prox_{_suffix(y.dtype)}")
    err = fn(
        y.device.index,
        y.data_ptr(),
        a.data_ptr(),
        sig_buf.data_ptr(),
        sig_stride,
        lo.data_ptr(),
        hi.data_ptr(),
        n,
        out.data_ptr(),
        torch.cuda.current_stream(y.device).cuda_stream,
    )
    _raise_on(err, "dual_prox")
    LAUNCHES["dual_prox"] += 1
    return out


def _dual_rows(name: str, blk: DualBlock, like: torch.Tensor):
    """(the block's ``DualRows``, its output, the buffers to keep alive)."""
    n = blk.y.shape[0]
    _check(" ".join(f"{name}.{f}" for f in ("y", "a", "d", "lo", "hi")),
           (blk.y, blk.a, blk.d, blk.lo, blk.hi), n, like)
    sig, stride = _step(f"{name}.sigma", blk.sigma, n, like)
    out = torch.empty_like(blk.y)
    rows = _build.DualRows(
        blk.y.data_ptr(), blk.a.data_ptr(), blk.d.data_ptr(), sig.data_ptr(), stride,
        blk.lo.data_ptr(), blk.hi.data_ptr(), out.data_ptr(), n,
    )
    return rows, out, sig


def dual_update(tree: DualBlock, sla: DualBlock, imp: DualBlock, s_t, t_mov, te):
    """The fused dual step: each block's ``d * a`` (the improvement rows'
    ``d * (x - s_t * t_mov * te)``) and dual prox, all rows in one launch.
    Returns the new (tree, tenant, improvement) duals."""
    like = imp.y
    blocks = [_dual_rows(name, blk, like) for name, blk in
              (("tree", tree), ("sla", sla), ("imp", imp))]
    scalars = [_step(name, v, 1, like)[0] for name, v in
               (("s_t", s_t), ("t_mov", t_mov), ("te", te))]
    args = _build.DualUpdateArgs(*(b[0] for b in blocks), *(v.data_ptr() for v in scalars))
    fn = getattr(_build.library(), f"dual_update_{_suffix(like.dtype)}")
    err = fn(like.device.index, args, torch.cuda.current_stream(like.device).cuda_stream)
    _raise_on(err, "dual_update")
    LAUNCHES["dual_update"] += 1
    return tuple(b[1] for b in blocks)


def _chunk_stats(name: str, vecs, cnt, n_out: int):
    """Launch one chunk-stats pass over ``vecs`` (the iterate first, the
    accumulator last); returns the new accumulator and ``n_out`` 0-d
    results on the device."""
    v = vecs[0]
    n = v.shape[0]
    lib = _build.library()
    acc = torch.empty_like(v)
    part = torch.empty(max(lib.chunk_stats_blocks(n), 1) * n_out, dtype=v.dtype, device=v.device)
    out = torch.empty(n_out, dtype=v.dtype, device=v.device)
    fn = getattr(lib, f"{name}_{_suffix(v.dtype)}")
    err = fn(
        v.device.index,
        *(t.data_ptr() for t in vecs),
        float(cnt),
        n,
        acc.data_ptr(),
        part.data_ptr(),
        out.data_ptr(),
        torch.cuda.current_stream(v.device).cuda_stream,
    )
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return (acc, *out.unbind())


def primal_chunk_stats(x, px, rx, ax, cnt):
    """(ax + x, max|x - px|, max|x|, sum (x - rx)^2, sum ((ax + x)/cnt - rx)^2);
    ``cnt`` is a host number."""
    _check("x px rx ax", (x, px, rx, ax), x.shape[0], x)
    return _chunk_stats("primal_chunk_stats", (x, px, rx, ax), cnt, 4)


def dual_chunk_stats(y, ry, ay, cnt):
    """(ay + y, sum (y - ry)^2, sum ((ay + y)/cnt - ry)^2, sum ry^2)."""
    _check("y ry ay", (y, ry, ay), y.shape[0], y)
    return _chunk_stats("dual_chunk_stats", (y, ry, ay), cnt, 3)
