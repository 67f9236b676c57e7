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

Every wrapper also takes K lanes of its vectors, ``[K, size]`` contiguous
(the K-scenario path): one launch covers the K lanes, each lane's result
the bits of a launch on that lane alone; a per-lane scalar is a ``[K, 1]``
column, a 0-d tensor one value for every lane.  Such a launch is also
counted in :data:`LANE_LAUNCHES`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pdhg_update.ref import DualBlock

__all__ = [
    "LANE_LAUNCHES",
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
# the launches above that took [K, size] lanes
LANE_LAUNCHES = dict.fromkeys(LAUNCHES, 0)

# the grid's y axis holds the lanes (csrc/pdhg_update.cu)
MAX_LANES = 65_535


def _lead(like: torch.Tensor) -> tuple:
    """``()`` for vectors, ``(K,)`` for K lanes of them."""
    if like.ndim not in (1, 2):
        raise ValueError(f"expected a vector or [K, size] lanes, got shape {tuple(like.shape)}")
    if like.ndim == 2 and not 1 <= like.shape[0] <= MAX_LANES:
        raise ValueError(f"{like.shape[0]} lanes: a launch takes 1 to {MAX_LANES}")
    return tuple(like.shape[:-1])


def _check(names: str, tensors, n: int, like: torch.Tensor) -> None:
    """Each tensor contiguous of ``like``'s lanes by ``n``, its dtype and
    CUDA device."""
    if like.device.type != "cuda":
        raise ValueError(f"expected CUDA tensors, got {like.device}")
    if like.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"expected float64 or float32, got {like.dtype}")
    shape = _lead(like) + (n,)
    for name, v in zip(names.split(), tensors):
        if v.device != like.device or v.dtype != like.dtype:
            raise ValueError(f"{name} must be {like.dtype} on {like.device}")
        if v.shape != shape or not v.is_contiguous():
            raise ValueError(
                f"{name} must be contiguous of shape {shape}, got {tuple(v.shape)}"
            )


def _step(name: str, s, n: int, like: torch.Tensor) -> tuple[torch.Tensor, int, int]:
    """A step size as (buffer, stride, lane stride): a vector of ``like``'s
    lanes by ``n`` (stride 1, lane stride n), a ``[K, 1]`` column of one
    value per lane (0, 1), or one scalar (Python number or 0-d tensor) for
    every element (0, 0)."""
    if not isinstance(s, torch.Tensor):
        return torch.full((1,), float(s), dtype=like.dtype, device=like.device), 0, 0
    if s.device != like.device or s.dtype != like.dtype:
        raise ValueError(f"{name} must be {like.dtype} on {like.device}")
    lead = _lead(like)
    if s.ndim == 0:
        return s.reshape(1), 0, 0
    if lead and s.shape == lead + (1,) and s.is_contiguous():
        return s, 0, 1
    _check(name, (s,), n, like)
    return s, 1, n


def _count(name: str, like: torch.Tensor) -> None:
    LAUNCHES[name] += 1
    if like.ndim == 2:
        LANE_LAUNCHES[name] += 1


def _lanes(like: torch.Tensor) -> int:
    return like.shape[0] if like.ndim == 2 else 1


def _suffix(dtype: torch.dtype) -> str:
    return "f64" if dtype == torch.float64 else "f32"


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def primal_update(x, gx, c, w, target, lo, hi, tau):
    """(x1, xe) of the fused primal prox + extrapolation."""
    n = x.shape[-1]
    _check("x gx c w target lo hi", (x, gx, c, w, target, lo, hi), n, x)
    tau_buf, tau_stride, tau_lane = _step("tau", tau, n, x)
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
        tau_lane,
        n,
        _lanes(x),
        x1.data_ptr(),
        xe.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on(err, "primal_update")
    _count("primal_update", x)
    return x1, xe


def dual_prox(y, a, sigma, lo, hi):
    """z - sigma * clip(z / sigma, lo, hi) with z = y + sigma * a."""
    n = y.shape[-1]
    _check("y a lo hi", (y, a, lo, hi), n, y)
    sig_buf, sig_stride, sig_lane = _step("sigma", sigma, n, y)
    out = torch.empty_like(y)
    fn = getattr(_build.library(), f"dual_prox_{_suffix(y.dtype)}")
    err = fn(
        y.device.index,
        y.data_ptr(),
        a.data_ptr(),
        sig_buf.data_ptr(),
        sig_stride,
        sig_lane,
        lo.data_ptr(),
        hi.data_ptr(),
        n,
        _lanes(y),
        out.data_ptr(),
        torch.cuda.current_stream(y.device).cuda_stream,
    )
    _raise_on(err, "dual_prox")
    _count("dual_prox", y)
    return out


def _dual_rows(name: str, blk: DualBlock, like: torch.Tensor):
    """(the block's ``DualRows``, its output, the buffers to keep alive)."""
    n = blk.y.shape[-1]
    _check(" ".join(f"{name}.{f}" for f in ("y", "a", "d", "lo", "hi")),
           (blk.y, blk.a, blk.d, blk.lo, blk.hi), n, like)
    sig, stride, lane = _step(f"{name}.sigma", blk.sigma, n, like)
    out = torch.empty_like(blk.y)
    rows = _build.DualRows(
        blk.y.data_ptr(), blk.a.data_ptr(), blk.d.data_ptr(), sig.data_ptr(), stride, lane,
        blk.lo.data_ptr(), blk.hi.data_ptr(), out.data_ptr(), n,
    )
    return rows, out, sig


def dual_update(tree: DualBlock, sla: DualBlock, imp: DualBlock, s_t, t_mov, te):
    """The fused dual step: each block's ``d * a`` (the improvement rows'
    ``d * (x - s_t * t_mov * te)``) and dual prox, all rows in one launch.
    With K lanes ``s_t``, ``t_mov`` and ``te`` are ``[K, 1]`` columns (or 0-d,
    one value for every lane).  Returns the new (tree, tenant, improvement)
    duals."""
    like = imp.y
    blocks = [_dual_rows(name, blk, like) for name, blk in
              (("tree", tree), ("sla", sla), ("imp", imp))]
    scalars = [_scalar(name, v, like) for name, v in (("s_t", s_t), ("t_mov", t_mov), ("te", te))]
    lanes = {lane for _, lane in scalars}
    if len(lanes) != 1:
        raise ValueError("s_t, t_mov and te must all be per lane or all shared")
    args = _build.DualUpdateArgs(*(b[0] for b in blocks), *(v.data_ptr() for v, _ in scalars),
                                 lanes.pop())
    fn = getattr(_build.library(), f"dual_update_{_suffix(like.dtype)}")
    err = fn(like.device.index, args, _lanes(like),
             torch.cuda.current_stream(like.device).cuda_stream)
    _raise_on(err, "dual_update")
    _count("dual_update", like)
    return tuple(b[1] for b in blocks)


def _scalar(name: str, v, like: torch.Tensor) -> tuple[torch.Tensor, int]:
    """One scalar per lane as (buffer, lane stride): a 0-d tensor (or a
    Python number) shared by every lane, or a ``[K, 1]`` column."""
    buf, stride, lane = _step(name, v, 1, like)
    if stride:
        raise ValueError(f"{name} must be 0-d or one value per lane")
    return buf, lane


# chunk_stats' ticket counters, three per lane per device (one per
# statistics block of a launch): zero between launches (each launch leaves
# them so), made when a launch first takes that many lanes (one lane: the
# first launch), before any CUDA graph captures a launch of them.  Calls on
# two streams at once would share them.
_TICKETS: dict[int, torch.Tensor] = {}

# the blocks a launch takes (csrc/pdhg_update.cu, chunk_stats' mask)
_PRIMAL, _FIRST, _SECOND, _ACC = 1, 2, 4, 8


def _tickets(device: torch.device, lanes: int = 1) -> torch.Tensor:
    """The counters of ``lanes`` lanes (grown, never shrunk: a larger K
    makes a new zeroed buffer; launches at or under its size reuse it)."""
    t = _TICKETS.get(device.index)
    if t is None or t.numel() < 3 * lanes:
        size = 3 * max(lanes, 1 if t is None else t.numel() // 3)
        t = _TICKETS[device.index] = torch.zeros(size, dtype=torch.int32, device=device)
    return t


def _chunk_stats(name: str, cnt, primal=None, duals=(), accs=None) -> list:
    """One launch of the chunk statistics over the blocks given: the primal
    ``(x, px, rx, ax)``, up to two dual ``(y, ry, ay)`` and the accumulators
    ``(t, at, ys, ays)`` (``t`` and ``at`` 0-d).  Returns, for the blocks
    given and in that order, the primal result (``ax + x`` and four 0-d
    values), each dual block's (``ay + y`` and three 0-d sums), and
    ``at + t``, ``ays + ys``; counts one launch of ``name``.

    With K lanes (``[K, size]`` blocks, ``t`` and ``at`` ``[K, 1]``) ``cnt``
    holds one count per lane (host numbers, or K values on the card, read
    without a copy) and each 0-d result is a ``[K, 1]`` column."""
    like = (primal or duals[0] or accs)[0]
    lead = _lead(like)
    lanes = _lanes(like)
    if primal is not None:
        _check("x px rx ax", primal, primal[0].shape[-1], like)
    for j, v in enumerate(duals):
        _check(f"y{j} ry{j} ay{j}", v, v[0].shape[-1], like)
    if accs is not None:
        t, at, ys, ays = accs
        _check("ys ays", (ys, ays), ys.shape[-1], like)
        scalar = lead + (1,) if lead else ()
        for nm, v in (("t", t), ("at", at)):
            if v.shape != scalar or v.device != like.device or v.dtype != like.dtype:
                raise ValueError(f"{nm} must be a {like.dtype} tensor of shape {scalar} on "
                                 f"{like.device}")
    lib = _build.library()
    rows_p = lib.chunk_stats_blocks(primal[0].shape[-1]) if primal is not None else 0
    rows_d = sum(lib.chunk_stats_blocks(v[0].shape[-1]) for v in duals)
    part = torch.empty(lanes * (4 * rows_p + 3 * rows_d), dtype=like.dtype, device=like.device)
    n_out = 4 * (primal is not None) + 3 * len(duals)
    out = torch.empty(lead + (n_out,), dtype=like.dtype, device=like.device)
    cnt_lanes = None
    if lead:
        cnt_lanes = _lane_counts(cnt, like)
    args = _build.ChunkStatsArgs(part=part.data_ptr(),
                                 tickets=_tickets(like.device, lanes).data_ptr(),
                                 cnt=None if cnt_lanes is None else cnt_lanes.data_ptr(),
                                 out_lane=n_out)
    mask = 0
    stats = []  # each statistics block's new accumulator and count of 0-d results

    def out_ptr():  # where the next block's 0-d results go
        return out.data_ptr() + sum(k for _, k in stats) * out.element_size()

    if primal is not None:
        x, px, rx, ax = primal
        axn = torch.empty_like(x)
        args.primal = _build.PrimalStatsRows(*(v.data_ptr() for v in (x, px, rx, ax, axn)),
                                             out_ptr(), x.shape[-1])
        mask |= _PRIMAL
        stats.append((axn, 4))
    for (y, ry, ay), field, bit in zip(duals, ("first", "second"), (_FIRST, _SECOND)):
        ayn = torch.empty_like(y)
        setattr(args, field, _build.StatsRows(*(v.data_ptr() for v in (y, ry, ay, ayn)),
                                              out_ptr(), y.shape[-1]))
        mask |= bit
        stats.append((ayn, 3))
    if accs is not None:
        atn, aysn = torch.empty_like(at), torch.empty_like(ays)
        args.acc = _build.AccRows(*(v.data_ptr() for v in (t, at, atn, ys, ays, aysn)),
                                  ys.shape[-1])
        mask |= _ACC
    err = getattr(lib, f"chunk_stats_{_suffix(like.dtype)}")(
        like.device.index, args, 0.0 if lead else float(cnt), mask, lanes,
        torch.cuda.current_stream(like.device).cuda_stream,
    )
    _raise_on(err, name)
    _count(name, like)
    values = out.split(1, -1) if lead else out.unbind()
    results, i = [], 0
    for acc, k in stats:
        results.append((acc, *values[i : i + k]))
        i += k
    return results + ([atn, aysn] if accs is not None else [])


def _lane_counts(cnt, like: torch.Tensor) -> torch.Tensor:
    """The K lanes' counts as a contiguous device vector of ``like``'s dtype:
    a tensor there already (K values) is read as it is; host numbers are
    copied over (one host-to-device copy)."""
    lanes = like.shape[0]
    if isinstance(cnt, torch.Tensor) and cnt.device == like.device:
        if cnt.dtype != like.dtype or cnt.numel() != lanes or not cnt.is_contiguous():
            raise ValueError(f"cnt must be {lanes} contiguous {like.dtype} values")
        return cnt.reshape(lanes)
    host = np.array(np.broadcast_to(np.asarray(cnt, np.float64), (lanes,)))
    return torch.as_tensor(host).to(device=like.device, dtype=like.dtype)


def primal_chunk_stats(x, px, rx, ax, cnt):
    """(ax + x, max|x - px|, max|x|, sum (x - rx)^2, sum ((ax + x)/cnt - rx)^2);
    ``cnt`` is a host number (with K lanes, one per lane)."""
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
