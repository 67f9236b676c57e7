"""ctypes wrappers of the fused CUDA PDHG update kernels
(``csrc/pdhg_update.cu``).

Replace ``repro/kernels/pdhg_update/kernel.py:primal_update``,
``:dual_prox``, ``:primal_chunk_stats`` and ``:dual_chunk_stats`` (Pallas,
TPU); ``dual_update`` is ``dual_prox`` redesigned as the solver's whole dual
step, with the row scaling before it, in one launch, and
``check_chunk_stats`` every chunk statistic of a KKT check in one launch:
the primal block, the solver's two dual blocks and the ``t`` and tenant
accumulators.  ``primal_chunk_stats``, ``dual_chunk_stats`` and
``dual_chunk_stats_pair`` are one launch of the same kernel on their blocks
alone (the pass and the combine of its partial rows).  The source's header
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
    "check_chunk_stats",
    "dual_chunk_stats",
    "dual_chunk_stats_pair",
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
    "check_chunk_stats": 0,
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


# chunk_stats' ticket counters, three per device (one per statistics block
# of a launch): zero between launches (each launch leaves them so), made
# once, before any CUDA graph captures a launch.  Calls on two streams at
# once would share them.
_TICKETS: dict[int, torch.Tensor] = {}

# the blocks a launch takes (csrc/pdhg_update.cu, chunk_stats' mask)
_PRIMAL, _FIRST, _SECOND, _ACC = 1, 2, 4, 8


def _tickets(device: torch.device) -> torch.Tensor:
    t = _TICKETS.get(device.index)
    if t is None:
        t = _TICKETS[device.index] = torch.zeros(3, dtype=torch.int32, device=device)
    return t


def _chunk_stats(name: str, cnt, primal=None, duals=(), accs=None) -> list:
    """One launch of the chunk statistics over the blocks given: the primal
    ``(x, px, rx, ax)``, up to two dual ``(y, ry, ay)`` and the accumulators
    ``(t, at, ys, ays)`` (``t`` and ``at`` 0-d).  Returns, for the blocks
    given and in that order, the primal result (``ax + x`` and four 0-d
    values), each dual block's (``ay + y`` and three 0-d sums), and
    ``at + t``, ``ays + ys``; counts one launch of ``name``."""
    like = (primal or duals[0] or accs)[0]
    if primal is not None:
        _check("x px rx ax", primal, primal[0].shape[0], like)
    for j, v in enumerate(duals):
        _check(f"y{j} ry{j} ay{j}", v, v[0].shape[0], like)
    if accs is not None:
        t, at, ys, ays = accs
        _check("ys ays", (ys, ays), ys.shape[0], like)
        for nm, v in (("t", t), ("at", at)):
            if v.shape != () or v.device != like.device or v.dtype != like.dtype:
                raise ValueError(f"{nm} must be a 0-d {like.dtype} tensor on {like.device}")
    lib = _build.library()
    rows_p = lib.chunk_stats_blocks(primal[0].shape[0]) if primal is not None else 0
    rows_d = sum(lib.chunk_stats_blocks(v[0].shape[0]) for v in duals)
    part = torch.empty(4 * rows_p + 3 * rows_d, dtype=like.dtype, device=like.device)
    out = torch.empty(4 * (primal is not None) + 3 * len(duals), dtype=like.dtype,
                      device=like.device)
    args = _build.ChunkStatsArgs(part=part.data_ptr(),
                                 tickets=_tickets(like.device).data_ptr())
    mask = 0
    stats = []  # each statistics block's new accumulator and count of 0-d results

    def out_ptr():  # where the next block's 0-d results go
        return out.data_ptr() + sum(k for _, k in stats) * out.element_size()

    if primal is not None:
        x, px, rx, ax = primal
        axn = torch.empty_like(x)
        args.primal = _build.PrimalStatsRows(*(v.data_ptr() for v in (x, px, rx, ax, axn)),
                                             out_ptr(), x.shape[0])
        mask |= _PRIMAL
        stats.append((axn, 4))
    for (y, ry, ay), field, bit in zip(duals, ("first", "second"), (_FIRST, _SECOND)):
        ayn = torch.empty_like(y)
        setattr(args, field, _build.StatsRows(*(v.data_ptr() for v in (y, ry, ay, ayn)),
                                              out_ptr(), y.shape[0]))
        mask |= bit
        stats.append((ayn, 3))
    if accs is not None:
        atn, aysn = torch.empty_like(at), torch.empty_like(ays)
        args.acc = _build.AccRows(*(v.data_ptr() for v in (t, at, atn, ys, ays, aysn)),
                                  ys.shape[0])
        mask |= _ACC
    err = getattr(lib, f"chunk_stats_{_suffix(like.dtype)}")(
        like.device.index, args, float(cnt), mask,
        torch.cuda.current_stream(like.device).cuda_stream,
    )
    _raise_on(err, name)
    LAUNCHES[name] += 1
    values, results, i = out.unbind(), [], 0
    for acc, k in stats:
        results.append((acc, *values[i : i + k]))
        i += k
    return results + ([atn, aysn] if accs is not None else [])


def primal_chunk_stats(x, px, rx, ax, cnt):
    """(ax + x, max|x - px|, max|x|, sum (x - rx)^2, sum ((ax + x)/cnt - rx)^2);
    ``cnt`` is a host number."""
    return _chunk_stats("primal_chunk_stats", cnt, primal=(x, px, rx, ax))[0]


def dual_chunk_stats(y, ry, ay, cnt):
    """(ay + y, sum (y - ry)^2, sum ((ay + y)/cnt - ry)^2, sum ry^2)."""
    return _chunk_stats("dual_chunk_stats", cnt, duals=[(y, ry, ay)])[0]


def dual_chunk_stats_pair(first, second, cnt):
    """:func:`dual_chunk_stats` of two (y, ry, ay) triples (the solver's tree
    and improvement rows) in one launch; returns the two results."""
    return tuple(_chunk_stats("dual_chunk_stats", cnt, duals=[first, second]))


def check_chunk_stats(primal, tree, imp, t, at, ys, ays, cnt):
    """Every chunk statistic of one KKT check in one launch: returns
    (:func:`primal_chunk_stats` of ``primal`` = (x, px, rx, ax), the two
    results of :func:`dual_chunk_stats_pair` of ``tree`` and ``imp``,
    ``at + t``, ``ays + ys``), each with the bits of those calls and of
    torch's adds."""
    return tuple(_chunk_stats("check_chunk_stats", cnt, primal, [tree, imp], (t, at, ys, ays)))
