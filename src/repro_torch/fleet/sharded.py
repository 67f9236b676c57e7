"""Sharded fleet dispatch: the stacked K-domain control step over the ranks
of a ``torch.distributed`` process group.

The stacked dispatch in :mod:`repro_torch.fleet.orchestrator` solves all K
domains as K lanes of one solve on one device.  This module splits those
lanes over the ranks of a process group (the port's form of the
reference's ``shard_map`` over a ``("domains",)`` mesh): rank ``r`` of the
``d`` shards holds domains ``[r K/d, (r+1) K/d)`` as the lanes of its own
stacked solve, padded to the *global* ``(N, M, E, T)`` so that every lane
is the program the stacked dispatch runs.  The only cross-rank
communication of a control step is:

1. each rank reduces its local telemetry to per-domain aggregate demand
   (and, with tenants, the demand of each cross-cut slice it holds: the
   tenant row sums of :func:`repro_torch.core.treeops.sla_matvec`);
2. ONE ``all_reduce(SUM)`` of the ``[K + S]`` vector assembles the global
   demand on every rank.  Every slot has one writer (a domain, or a slice,
   lives on one rank), so the sum is exact whatever order the backend adds
   in;
3. every rank computes the :class:`BudgetCoordinator` plan from the same
   vector with the same kernels, so every rank holds the same bits: the
   demand and headroom water-fills over the above-cut coordinator tree
   (:func:`repro_torch.core.waterfill.waterfill_torch`), and with tenants
   the demand-shaped half of the entitlement split over the tenant forest;
   each rank takes its own domains' feeds and solves its lanes;
4. ONE ``all_gather`` of every rank's ``[K/d, N]`` allocation and per-lane
   statistics gives every rank the global result (the reference's
   ``np.asarray`` of the sharded output).

Everything demand-independent (effective domain floors with the tenant
minimum lifts, derated caps, the demand-free entitlement minimums) is
planned on the host from the orchestrator's mirrors, as the stacked planner
does, and enters the step as small tensors (:class:`PlanRep`,
:class:`RowMaps`).  The coordinator tree's kernel index is built once and
the tenant forest's once per slice structure, so derates, grant changes,
join/leave re-pins and ``set_tenant_bounds`` rebuild nothing (the
orchestrator's ``rebuild_count``, the reference's ``trace_count``).

Shard count: the largest divisor of K that is at most the group size
(:func:`shard_count`).  Ranks past it hold no lanes; they still join both
collectives, plan and return the same result.  A group of one rank is the
stacked program plus two trivial collectives.  ``group=None`` means the
default group when ``torch.distributed`` is initialised, else a one-rank
group private to the caller over a :class:`torch.distributed.HashStore`:
NCCL for a CUDA device (raising where NCCL cannot be built), gloo for the
CPU.  A gloo group on a CUDA device stages both collectives through host
memory.
"""

from __future__ import annotations

import datetime
from collections import Counter
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.compat import group_backend, staged_on_host
from repro_torch.core.batched import _record_batch, _solve_batched
from repro_torch.core.lanes import lane_sum
from repro_torch.core.solver.options import KKT_HIST_BUCKETS
from repro_torch.core.treeops import TreeTopo, sla_matvec
from repro_torch.core.waterfill import waterfill_torch
from repro_torch.obs import recorder as obs_recorder

__all__ = [
    "COLLECTIVES",
    "PlanRep",
    "RowMaps",
    "ShardLayout",
    "shard_count",
    "shard_layout",
    "step",
]

GROUP_TIMEOUT = datetime.timedelta(seconds=60)

# collectives issued, by kind: "all_reduce" and "all_gather" (one each per
# step), "flush_gather" (one per sharded flight-recorder flush)
COLLECTIVES: Counter = Counter()

# the per-lane statistics gathered beside the allocation, in column order
# (kkt_hist's buckets follow)
_STAT_COLS = ("solves", "iterations", "iterations_p1", "iterations_p2", "iterations_p3",
              "converged", "kkt_certified", "truncated", "skipped", "certify_pass",
              "restarts")
_INT_STATS = ("solves", "iterations", "iterations_p1", "iterations_p2", "iterations_p3",
              "restarts")
# the recorder leaves a flush reads, gathered as one buffer
_REC_LEAVES = ("step", "ring", "hists", "solver_hist", "counters")


def shard_count(k: int, n_ranks: int) -> int:
    """Largest divisor of ``k`` that is at most ``n_ranks`` (domains are
    never split across shards, so the shard count divides K)."""
    d = max(1, min(int(n_ranks), int(k)))
    while k % d:
        d -= 1
    return d


class ShardLayout(NamedTuple):
    """Where this rank sits: its group and backend, its rank, the shard
    count ``d`` and its domains ``[lo, hi)`` (empty for ranks ``>= d``)."""

    group: Any  # a ProcessGroup, or a backend of one rank
    backend: str  # "nccl" | "gloo"
    rank: int
    world: int
    shards: int
    k: int
    lo: int
    hi: int
    device: torch.device

    @property
    def k_loc(self) -> int:
        return self.k // self.shards

    @property
    def staged(self) -> bool:
        """Collectives go through host memory (gloo on a CUDA device)."""
        return staged_on_host(self.device, self.backend)

    def lane(self, k: int) -> int | None:
        """Domain ``k``'s lane on this rank, ``None`` if another holds it."""
        return k - self.lo if self.lo <= k < self.hi else None


def _private_group(device: torch.device):
    """A one-rank group over a :class:`HashStore`: NCCL on a CUDA device,
    gloo on the CPU.  It needs no environment and no rendezvous."""
    store = dist.HashStore()
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("this torch build has no NCCL: pass a group (group=) to run "
                               "the sharded fleet on a CUDA device")
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = GROUP_TIMEOUT
        return dist.ProcessGroupNCCL(store, 0, 1, opts), "nccl"
    return dist.ProcessGroupGloo(store, 0, 1, GROUP_TIMEOUT), "gloo"


def shard_layout(k: int, group, device: torch.device) -> ShardLayout:
    """This rank's place among ``shard_count(k, group size)`` shards."""
    if group is None:
        if dist.is_available() and dist.is_initialized():
            group = dist.group.WORLD
            backend = group_backend(group, device)
        else:
            group, backend = _private_group(device)
    else:
        backend = group_backend(group, device)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"sharded dispatch runs on nccl or gloo, got {backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("an NCCL group carries CUDA tensors; pass device='cuda' or a gloo group")
    rank, world = int(group.rank()), int(group.size())
    d = shard_count(k, world)
    k_loc = k // d
    lo, hi = (rank * k_loc, (rank + 1) * k_loc) if rank < d else (k, k)
    return ShardLayout(group, backend, rank, world, d, k, lo, hi, device)


class RowMaps(NamedTuple):
    """This rank's ``[K/d, T]`` tenant-row routing.  ``slice_idx`` points
    into the global slice arrays (``S`` = an always-inert extra slot for
    domain-local and pad rows); ``lo_local``/``hi_local`` carry the
    contractual bounds of domain-local rows ([0, inf) elsewhere, so
    ``max``/``min`` against the slice gather needs no mask).  The port adds
    the inverse of ``slice_idx`` over this rank's slice rows (``lane``,
    ``row`` -> ``slot``), which writes each slice's demand into its slot
    without a scatter: every slot has one row."""

    slice_idx: torch.Tensor  # [K/d, T] int64 in [0, S]
    lo_local: torch.Tensor  # [K/d, T]
    hi_local: torch.Tensor  # [K/d, T]
    lane: torch.Tensor  # [s_loc] int64
    row: torch.Tensor  # [s_loc] int64
    slot: torch.Tensor  # [s_loc] int64 in [0, S)


class PlanRep(NamedTuple):
    """Replicated demand-independent planning state, rebuilt on the host
    every step from the orchestrator mirrors as the stacked planner's
    inputs are.  The reference's ``coord_start``/``coord_end``/``ccap`` are
    ``ctree`` (the coordinator tree, its kernel index built once, ``ccap``
    its caps) and ``ten_start``/``ten_end``/``b_max_c`` are ``forest`` (the
    cross-cut tenants over their slices, ``b_max_c`` its caps)."""

    dmin_tot: torch.Tensor  # [K] domain floors + tenant minimum lifts
    dcap: torch.Tensor  # [K] derated domain caps
    ctree: TreeTopo  # [m_anc] coordinator rows, derated caps
    slice_lo: torch.Tensor  # [S] demand-free entitlement minimum split
    slice_umax: torch.Tensor  # [S] per-slice deliverable maximum
    forest: TreeTopo | None  # [Tc] tenants over slices, contractual maxima


class StepOut(NamedTuple):
    """One sharded step: the global result on the host of every rank, and
    this rank's own carries."""

    x3: np.ndarray  # [K, N] allocations (padded lanes)
    stats: dict  # the K lanes' statistics, as the stacked program's
    grants: np.ndarray  # [K]
    demand: np.ndarray  # [K]
    slice_lo: np.ndarray  # [S]
    slice_hi: np.ndarray  # [S]
    warm: Any  # this rank's WarmCarry ([K/d, ...] leaves) or None
    carry: Any  # this rank's incremental anchor or None


def _np_dtype(dt: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dt).numpy().dtype


def _all_reduce(lay: ShardLayout, v: torch.Tensor) -> torch.Tensor:
    COLLECTIVES["all_reduce"] += 1
    buf = v.cpu() if lay.staged else v
    lay.group.allreduce([buf]).wait()
    return buf.to(v.device) if lay.staged else buf


def _all_gather(lay: ShardLayout, v: torch.Tensor, kind: str) -> np.ndarray:
    """Every rank's ``[rows, W]`` float64 block, stacked in rank order on
    the host."""
    COLLECTIVES[kind] += 1
    buf = v.cpu() if lay.staged else v
    out = [torch.empty_like(buf) for _ in range(lay.world)]
    lay.group.allgather([out], [buf]).wait()
    return torch.cat(out).cpu().numpy()


def _sharded_solve(dom, cap, r, active, rowmap, warm, carry, rep, rec, *,
                   lay, meta, opts, coord_mode, rec_cfg):
    """Per-shard body: local aggregates -> one all-reduce -> replicated
    coordinator plan -> local feeds -> the stacked solve of the local
    lanes -> one all-gather."""
    dt = rep.dcap.dtype
    K = lay.k
    S = rep.slice_lo.shape[0]
    agg = torch.zeros(K + S, dtype=dt, device=lay.device)
    ap = None
    if dom is not None:
        lo, hi = (dom.sla.lo, dom.sla.hi) if rowmap is None else (rowmap.lo_local,
                                                                 rowmap.hi_local)
        ap = dom.problem(r, active, cap, lo, hi)
        shaped = ap.r  # clipped to the box, idle devices at l
        agg[lay.lo : lay.hi] = lane_sum(shaped)[:, 0]  # each lane's bits whatever K
        if S and rowmap.slot.numel():
            row_demand = sla_matvec(shaped, ap.sla)
            agg[K + rowmap.slot] = row_demand[rowmap.lane, rowmap.row]

    # -- the one cross-rank reduction: [K] demand (+ [S] slice demand) ------
    agg = _all_reduce(lay, agg)
    demand = agg[:K]

    # -- replicated coordinator plan (water-fill over the above-cut tree) ---
    mask_k = torch.ones(K, dtype=torch.bool, device=lay.device)
    grants = rep.dmin_tot
    if coord_mode == "waterfill":
        grants = waterfill_torch(grants, mask_k, rep.ctree,
                                 torch.clamp(demand, rep.dmin_tot, rep.dcap))
    grants = waterfill_torch(grants, mask_k, rep.ctree, rep.dcap)
    slice_hi = rep.slice_lo
    if S:
        mask_s = torch.ones(S, dtype=torch.bool, device=lay.device)
        slice_hi = waterfill_torch(rep.slice_lo, mask_s, rep.forest,
                                   torch.clamp(agg[K:], rep.slice_lo, rep.slice_umax))
        slice_hi = waterfill_torch(slice_hi, mask_s, rep.forest, rep.slice_umax)

    # -- this rank's feeds and the stacked solve of its lanes ---------------
    K_loc = lay.k_loc
    width = r.shape[-1]  # the global padded N
    wcarry = new_inc = None
    if dom is not None:
        cap_step = cap.clone()
        cap_step[:, 0] = grants[lay.lo : lay.hi]
        sla = ap.sla
        if S:
            zero = torch.zeros(1, dtype=dt, device=lay.device)
            inf = torch.full((1,), float("inf"), dtype=dt, device=lay.device)
            lo_ext = torch.cat([rep.slice_lo, zero])
            hi_ext = torch.cat([slice_hi, inf])
            sla = sla._replace(lo=torch.maximum(rowmap.lo_local, lo_ext[rowmap.slice_idx]),
                               hi=torch.minimum(rowmap.hi_local, hi_ext[rowmap.slice_idx]))
        ap = ap._replace(tree=ap.tree._replace(cap=cap_step), sla=sla)
        _, _, x3, wcarry, stats, new_inc = _solve_batched(ap, meta, opts, warm, None, carry)
        if rec is not None:
            # shard-local: each rank appends its own lanes, gathered at flush
            _record_batch(rec_cfg, rec, stats, x3, ap)
        cols = torch.as_tensor(np.stack([np.asarray(stats[c], np.float64) for c in _STAT_COLS],
                                        axis=1), device=lay.device)
        block = torch.cat([x3.to(torch.float64), cols, stats["kkt_res"].reshape(K_loc, 1)
                           .to(torch.float64), stats["kkt_hist"].to(torch.float64)], dim=1)
    else:
        block = torch.zeros(K_loc, width + len(_STAT_COLS) + 1 + KKT_HIST_BUCKETS,
                            dtype=torch.float64, device=lay.device)

    # -- the result on every rank: one all-gather of the lanes --------------
    rows = _all_gather(lay, block, "all_gather")[:K]
    n_s = len(_STAT_COLS)
    stats_all = {c: rows[:, width + i].astype(np.int64 if c in _INT_STATS else bool)
                 for i, c in enumerate(_STAT_COLS)}
    stats_all["kkt_res"] = torch.as_tensor(rows[:, width + n_s : width + n_s + 1], dtype=dt)
    stats_all["kkt_hist"] = torch.as_tensor(rows[:, width + n_s + 1 :].astype(np.int32))
    planned = torch.cat([grants, demand, rep.slice_lo, slice_hi]).cpu().numpy()
    return StepOut(
        x3=rows[:, :width].astype(_np_dtype(dt)),
        stats=stats_all,
        grants=planned[:K],
        demand=planned[K : 2 * K],
        slice_lo=planned[2 * K : 2 * K + S],
        slice_hi=planned[2 * K + S :],
        warm=wcarry,
        carry=new_inc,
    )


def step(dom, cap, r, active, rowmap, warm, carry, rep, rec=None, *,
         layout, meta, opts, coord_mode, rec_cfg=None) -> StepOut:
    """One sharded fleet control step on this rank.  ``dom`` is this
    rank's ``[K/d, ...]`` domain batch (``None`` on a rank that holds no
    lanes), ``cap``/``r``/``active`` its lanes' caps and telemetry,
    ``warm``/``carry`` its lanes' warm state and incremental anchor, and
    ``rec`` its lanes' recorder state (``None`` when recording is off).  A
    rank without lanes passes ``r`` as ``[0, N]``: the gathered width.
    Every rank of the group must call it, with the same ``rep``."""
    if coord_mode not in ("waterfill", "subtree"):
        raise ValueError(
            f"sharded dispatch supports waterfill/subtree coordinators, got {coord_mode!r}"
        )
    return _sharded_solve(dom, cap, r, active, rowmap, warm, carry, rep, rec, lay=layout,
                          meta=meta, opts=opts, coord_mode=coord_mode, rec_cfg=rec_cfg)


def flush_lanes(lay: ShardLayout, state, cfg, n: int, dtype) -> list[dict[str, Any]]:
    """The K lanes' flight records on every rank, in domain order, from one
    all-gather of every rank's recorder leaves (the only place the shards'
    records meet).  ``state`` is this rank's ``[K/d, ...]`` state, ``None``
    on a rank without lanes."""
    K_loc = lay.k_loc
    if state is None:
        state = obs_recorder.init_batch(cfg, K_loc, n, dtype, lay.device)
    leaves = [getattr(state, name).reshape(K_loc, -1).to(torch.float64) for name in _REC_LEAVES]
    sizes = [t.shape[1] for t in leaves]
    rows = _all_gather(lay, torch.cat(leaves, dim=1), "flush_gather")[: lay.k]
    h, at = {}, 0
    for name, size in zip(_REC_LEAVES, sizes):
        like = getattr(state, name)
        h[name] = rows[:, at : at + size].reshape((lay.k,) + tuple(like.shape[1:]))
        h[name] = h[name].astype(_np_dtype(like.dtype))
        at += size
    return obs_recorder.flush_host_lanes(h, cfg)
