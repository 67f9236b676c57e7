"""The flight recorder: a fixed-shape ring of per-step control-plane
telemetry that lives on the device and is updated in place.

The twin of the reference's ``repro.obs.recorder``.  Every recorded step
appends ONE row of :data:`FIELDS` to the ring (the cursor ``step % capacity``
computed on the device) and bumps counters and log-bucket histograms, all
with in-place tensor ops (``scatter_``, ``scatter_add_``, ``add_``,
``copy_``) on buffers allocated once: no leaf is ever rebound, so a step's
recording can be captured in a ``torch.cuda.CUDAGraph`` as it stands.
Nothing is read back to the host while recording; :func:`flush` is the only
transfer.

What a row records: the certify tier taken (0 = full solve, 1 = Phase I
skip, 2 = full skip), the per-phase PDHG iteration split, the KKT residual
and restart counts of the inner solver, the SLA minimum margin, the
satisfaction ratio, the grant movement against the previous step and the
granted watts.  The solver's counts and flags are host values in the port
(:func:`repro_torch.core.batched.solve_three_phase`), so they go down to
the device in one small copy per step (from pinned memory, asynchronous on
a card); the residual, the in-loop KKT histogram, the margin (through the
``sla_matvec`` kernel on a card), the satisfaction, the granted watts and
the grant movement are computed on the device.

Per-lane states (a K-scenario batch, a stacked fleet's K domains) have
``[K, ...]`` leaves, allocated per lane, and one batched update records all
K lanes.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.core.solver.options import KKT_HIST_BUCKETS, KKT_HIST_LO_EXP
from repro_torch.kernels import tree_matvec as tm

__all__ = [
    "FIELDS",
    "RecorderConfig",
    "RecorderState",
    "StepMetrics",
    "init_state",
    "init_batch",
    "flush_host_lanes",
    "log_bucket",
    "sla_min_margin",
    "step_metrics",
    "static_metrics",
    "copy_metrics",
    "record_step",
    "record",
    "flush",
    "flush_lanes",
    "rows_as_dicts",
]

# ring-row field order; flush() returns rows as [R, len(FIELDS)] arrays
FIELDS = (
    "step",
    "kkt_res",
    "restarts",
    "iterations",
    "iter_p1",
    "iter_p2",
    "iter_p3",
    "tier",
    "skipped",
    "converged",
    "certified",
    "truncated",
    "sla_min_margin",
    "satisfaction",
    "grant_move",
    "alloc_W",
)

# the gauges known on the host, FIELDS[2:12] in order, then the four
# counter increments (skipped, Phase I skip, certified, truncated)
_HOST_GAUGES = 10
_COUNTERS = ("n_skipped", "n_p1_skips", "n_certified", "n_truncated")
# the StepMetrics leaves with buffers of their own (the ten host gauges are views of host)
_OWN = ("kkt_res", "sla_min_margin", "satisfaction", "alloc_W", "solver_hist", "host")

_NUMPY = {torch.float64: np.float64, torch.float32: np.float32}


class RecorderConfig(NamedTuple):
    """The recorder's fixed shape."""

    capacity: int = 256  # ring rows kept (oldest overwritten)
    buckets: int = KKT_HIST_BUCKETS  # log10 histogram buckets
    lo_exp: int = KKT_HIST_LO_EXP  # bucket 0 left edge = 10**lo_exp


class RecorderState(NamedTuple):
    """The flight record on the device (``[K, ...]`` leaves per lane).

    The leaves carry the reference's names.  The two gauge histograms are
    views of ``hists`` and the four counters views of ``counters``, so one
    launch bumps each group."""

    step: torch.Tensor  # int32: rows ever written (ring cursor = step % cap)
    ring: torch.Tensor  # [capacity, len(FIELDS)]
    hist_kkt: torch.Tensor  # [B] int32: per-step max KKT residual buckets
    hist_move: torch.Tensor  # [B] int32: per-step grant movement buckets
    solver_hist: torch.Tensor  # [B] int32: accumulated in-loop KKT buckets
    n_skipped: torch.Tensor  # int32
    n_p1_skips: torch.Tensor  # int32
    n_certified: torch.Tensor  # int32
    n_truncated: torch.Tensor  # int32
    last_alloc: torch.Tensor  # [n]: previous step's grants (movement gauge)
    hists: torch.Tensor  # [2, B] int32: hist_kkt, hist_move
    counters: torch.Tensor  # [4] int32: the four counters in order


class StepMetrics(NamedTuple):
    """One step's gauges on the device, assembled by :func:`step_metrics`.
    The ten host-known gauges are views of ``host``, the one staged copy."""

    kkt_res: torch.Tensor
    restarts: torch.Tensor
    iterations: torch.Tensor
    iter_p1: torch.Tensor
    iter_p2: torch.Tensor
    iter_p3: torch.Tensor
    tier: torch.Tensor  # 0 full solve / 1 Phase I skip / 2 full skip
    skipped: torch.Tensor
    converged: torch.Tensor
    certified: torch.Tensor
    truncated: torch.Tensor
    sla_min_margin: torch.Tensor
    satisfaction: torch.Tensor
    alloc_W: torch.Tensor
    solver_hist: torch.Tensor  # [B] int32 this step's in-loop KKT buckets
    host: torch.Tensor  # [14]: FIELDS[2:12], then the counter increments


# -- log buckets ----------------------------------------------------------

# (buckets, lo_exp, dtype, device) -> the B - 1 inner bucket edges
_EDGES: dict[tuple, torch.Tensor] = {}
# device -> a 0-d int32 one: the histograms' increment, made before any capture
_ONE: dict[str, torch.Tensor] = {}

# the reference's log10 is log(x) times this constant in the value's dtype
_ONE_OVER_LN10 = 0.4342944819032518


def _host_edges(cfg: RecorderConfig, dtype: torch.dtype) -> torch.Tensor:
    """The smallest value of ``dtype`` at which the reference's bucket
    ``floor(log(x) * (1/ln 10))`` reaches each ``lo_exp + b``, b = 1..B-1,
    found by bisection over the bit patterns near ``10**(lo_exp + b)`` with
    that formula evaluated on the CPU (where it gives the reference's
    buckets bit for bit, ``tests/test_torch_obs.py``)."""
    bits = torch.int64 if dtype == torch.float64 else torch.int32
    exps = torch.arange(cfg.lo_exp + 1, cfg.lo_exp + cfg.buckets, dtype=torch.float64)
    c = torch.tensor(_ONE_OVER_LN10, dtype=dtype)

    def reached(b):
        return torch.floor(torch.log(b.view(dtype)) * c) >= exps.to(dtype)

    lo = (10.0**exps * (1 - 1e-4)).to(dtype).view(bits).clone()
    hi = (10.0**exps * (1 + 1e-4)).to(dtype).view(bits).clone()
    assert not reached(lo).any() and reached(hi).all()
    while bool((hi - lo > 1).any()):
        mid = lo + (hi - lo) // 2
        ok = reached(mid)
        hi = torch.where(ok, mid, hi)
        lo = torch.where(ok, lo, mid)
    return hi.view(dtype)


def _edges(cfg: RecorderConfig, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    key = (cfg.buckets, cfg.lo_exp, dtype, str(device))
    if key not in _EDGES:
        _EDGES[key] = _host_edges(cfg, dtype).to(device)
    return _EDGES[key]


def _bucket(v: torch.Tensor, cfg: RecorderConfig) -> torch.Tensor:
    """int64 bucket indices: the count of inner edges at or below ``v``."""
    return torch.bucketize(v, _edges(cfg, v.dtype, v.device), right=True)


def log_bucket(v: torch.Tensor, cfg: RecorderConfig) -> torch.Tensor:
    """log10 bucket index of a non-negative value: bucket ``b`` holds
    values in ``[10**(lo_exp+b), 10**(lo_exp+b+1))``, clipped at the ends
    (zero/denormal -> bucket 0, overflow -> bucket B-1).

    The reference takes ``floor(log10(max(v, 10**lo_exp)))``, with its
    log10 the log times ``1/ln 10``; at an exact power of ten that product
    can round either side of the integer.  Here each edge is the value of
    ``v``'s dtype where the reference's bucket changes (:func:`_host_edges`),
    and the bucket is a comparison against those edges, so the card's own
    ``log`` never decides one."""
    return _bucket(v, cfg).to(torch.int32)


# -- state ----------------------------------------------------------------


def _alloc_state(cfg: RecorderConfig, lead: tuple, n: int, dtype, device) -> RecorderState:
    step = torch.zeros(lead, dtype=torch.int32, device=resolve_device(device))
    dev = step.device  # with its index, as the recorded tensors name it
    # the edges and the increment exist before any graph capture records a step
    _edges(cfg, dtype, dev)
    if str(dev) not in _ONE:
        _ONE[str(dev)] = torch.ones((), dtype=torch.int32, device=dev)
    hists = torch.zeros(*lead, 2, cfg.buckets, dtype=torch.int32, device=dev)
    counters = torch.zeros(*lead, len(_COUNTERS), dtype=torch.int32, device=dev)
    return RecorderState(
        step=step,
        ring=torch.zeros(*lead, cfg.capacity, len(FIELDS), dtype=dtype, device=dev),
        hist_kkt=hists[..., 0, :],
        hist_move=hists[..., 1, :],
        solver_hist=torch.zeros(*lead, cfg.buckets, dtype=torch.int32, device=dev),
        n_skipped=counters[..., 0],
        n_p1_skips=counters[..., 1],
        n_certified=counters[..., 2],
        n_truncated=counters[..., 3],
        last_alloc=torch.zeros(*lead, n, dtype=dtype, device=dev),
        hists=hists,
        counters=counters,
    )


def init_state(cfg: RecorderConfig, n: int, dtype=torch.float64, device=None) -> RecorderState:
    """Fresh (empty) recorder state for an ``n``-device plane on ``device``
    (``None`` means ``cuda``)."""
    return _alloc_state(cfg, (), n, dtype, device)


def init_batch(cfg: RecorderConfig, k: int, n: int, dtype=torch.float64,
               device=None) -> RecorderState:
    """Per-lane recorder states with ``[k, ...]`` leaves: distinct buffers
    per lane (not a broadcast view), so each lane takes its own writes."""
    return _alloc_state(cfg, (k,), n, dtype, device)


# -- one step ---------------------------------------------------------------


def sla_min_margin(alloc: torch.Tensor, sla) -> torch.Tensor:
    """Minimum tenant-row slack ``min_t(sum alloc[row t] - lo_t)`` in watts
    per lane (+inf when the plane has no tenant rows).  The sums are
    ``sla_matvec`` (the ``gather_sums`` kernel on a card) over ``sla``, a
    :class:`~repro_torch.core.treeops.SlaTopo`; a stacked fleet's pad edges
    add into its ``lo = 0`` pad row, which can only report non-negative
    slack, as in the reference."""
    if sla.k == 0:
        return alloc.new_full(alloc.shape[:-1], float("inf"))
    return (tm.sla_matvec(alloc, sla.index) - sla.lo).amin(-1)


def _host(stats: dict, key: str) -> np.ndarray:
    v = stats[key]
    if isinstance(v, torch.Tensor):
        # recording must not read the device back
        raise TypeError(f"stats[{key!r}] is a tensor; the recorder takes it as a host value")
    return np.asarray(v)


def step_metrics(stats: dict, alloc: torch.Tensor, r: torch.Tensor,
                 margin: torch.Tensor) -> StepMetrics:
    """One step's gauges from the solve's stats dict (counts and flags host
    values, ``kkt_res`` and ``kkt_hist`` device tensors), the final
    allocation, the request vector of the satisfaction ratio (zero where
    there is no demand) and the SLA minimum margin."""
    dtype, dev = alloc.dtype, alloc.device
    lead = alloc.shape[:-1]
    skipped = _host(stats, "skipped").astype(bool)
    certify = _host(stats, "certify_pass").astype(bool)
    tier = np.where(skipped, 2, np.where(certify & ~skipped, 1, 0))
    certified = _host(stats, "kkt_certified")
    truncated = _host(stats, "truncated")
    gauges = [_host(stats, "restarts"), _host(stats, "iterations")]
    gauges += [_host(stats, f"iterations_p{i}") for i in (1, 2, 3)]
    gauges += [tier, skipped, _host(stats, "converged"), certified, truncated]
    gauges += [skipped, tier == 1, certified, truncated]
    host = np.stack([np.broadcast_to(g, lead) for g in gauges], -1).astype(_NUMPY[dtype])
    staged = torch.from_numpy(host)
    if dev.type == "cuda":
        staged = staged.pin_memory()
    g = staged.to(dev, non_blocking=True)
    # the satisfaction ratio's two sums and the granted watts in one reduction
    sums = torch.stack([torch.minimum(r, alloc), r, alloc], -2).sum(-1)
    met, req_tot, alloc_w = sums.unbind(-1)
    sat = torch.where(req_tot > 0, met / req_tot.clamp_min(1e-30), 1.0)
    return StepMetrics(
        stats["kkt_res"].to(dtype).reshape(lead),
        *g[..., :_HOST_GAUGES].unbind(-1),
        sla_min_margin=margin.to(dtype),
        satisfaction=sat,
        alloc_W=alloc_w,
        solver_hist=stats["kkt_hist"].to(torch.int32),
        host=g,
    )


def static_metrics(cfg: RecorderConfig, dtype=torch.float64, device=None) -> StepMetrics:
    """Zeroed one-lane gauges laid out as :func:`step_metrics` lays them:
    the static buffers of a CUDA-graph capture of :func:`record_step`,
    which :func:`copy_metrics` loads with a step's gauges before a replay."""
    host = torch.zeros(_HOST_GAUGES + len(_COUNTERS), dtype=dtype,
                       device=resolve_device(device))
    return StepMetrics(
        host.new_zeros(()),
        *host[:_HOST_GAUGES].unbind(),
        sla_min_margin=host.new_zeros(()),
        satisfaction=host.new_zeros(()),
        alloc_W=host.new_zeros(()),
        solver_hist=torch.zeros(cfg.buckets, dtype=torch.int32, device=host.device),
        host=host,
    )


def copy_metrics(dst: StepMetrics, src: StepMetrics) -> StepMetrics:
    """Copy ``src``'s gauges into ``dst``'s buffers in place.  Returns ``dst``."""
    for name in _OWN:
        getattr(dst, name).copy_(getattr(src, name))
    return dst


def record_step(cfg: RecorderConfig, state: RecorderState, m: StepMetrics,
                alloc: torch.Tensor) -> RecorderState:
    """Append one step in place: one ring-row write at ``step % capacity``
    and the counter and histogram bumps.  Device ops only, with no host
    read, so it replays in a CUDA graph.  Returns ``state``."""
    dtype = state.ring.dtype
    lead = state.step.shape
    move = torch.where(state.step > 0, (alloc - state.last_alloc).abs().amax(-1), 0.0)
    row = torch.cat(
        [
            state.step.to(dtype).unsqueeze(-1),
            m.kkt_res.unsqueeze(-1),
            m.host[..., :_HOST_GAUGES],
            m.sla_min_margin.unsqueeze(-1),
            m.satisfaction.unsqueeze(-1),
            move.unsqueeze(-1),
            m.alloc_W.unsqueeze(-1),
        ],
        -1,
    )
    cursor = torch.remainder(state.step, cfg.capacity).long()
    state.ring.scatter_(
        -2, cursor[..., None, None].expand(*lead, 1, len(FIELDS)), row.unsqueeze(-2)
    )
    buckets = _bucket(torch.stack([m.kkt_res, move], -1), cfg).unsqueeze(-1)
    state.hists.scatter_add_(-1, buckets, _ONE[str(state.hists.device)].expand(buckets.shape))
    state.solver_hist.add_(m.solver_hist)
    state.counters.add_(m.host[..., _HOST_GAUGES:].to(torch.int32))
    state.step.add_(1)
    state.last_alloc.copy_(alloc)
    return state


def record(cfg: RecorderConfig, state: RecorderState, stats: dict, alloc: torch.Tensor,
           r: torch.Tensor, sla) -> RecorderState:
    """A control plane's whole append: the SLA margin of ``alloc`` over
    ``sla``, :func:`step_metrics` and :func:`record_step`."""
    m = step_metrics(stats, alloc, r, sla_min_margin(alloc, sla))
    return record_step(cfg, state, m, alloc)


# -- host side ----------------------------------------------------------------


def _flush_host(h: dict[str, np.ndarray], cfg: RecorderConfig) -> dict[str, Any]:
    step = int(h["step"])
    ring = h["ring"]
    if step <= cfg.capacity:
        rows = ring[:step].copy()
    else:
        rows = np.roll(ring, -(step % cfg.capacity), axis=0)
    return {
        "fields": list(FIELDS),
        "rows": rows,
        "step": step,
        "capacity": cfg.capacity,
        "counters": {"n_steps": step, **{c: int(h["counters"][i])
                                         for i, c in enumerate(_COUNTERS)}},
        "hist_kkt": h["hists"][0].copy(),
        "hist_move": h["hists"][1].copy(),
        "solver_hist": h["solver_hist"].copy(),
        "hist_lo_exp": cfg.lo_exp,
    }


def _to_host(state: RecorderState) -> dict[str, np.ndarray]:
    return {k: getattr(state, k).cpu().numpy()
            for k in ("step", "ring", "hists", "solver_hist", "counters")}


def flush(state: RecorderState, cfg: RecorderConfig) -> dict[str, Any]:
    """One lane's flight record as host numpy: time-ordered rows, counters
    and histograms.  The recorder's only transfer to the host."""
    return _flush_host(_to_host(state), cfg)


def flush_lanes(state: RecorderState, cfg: RecorderConfig) -> list[dict[str, Any]]:
    """A batched state (``[K, ...]`` leaves) as one flush dict per lane,
    from one transfer of each leaf."""
    return flush_host_lanes(_to_host(state), cfg)


def flush_host_lanes(h: dict[str, np.ndarray], cfg: RecorderConfig) -> list[dict[str, Any]]:
    """One flush dict per lane from host copies of a batched state's
    ``step``, ``ring``, ``hists``, ``solver_hist`` and ``counters``."""
    return [_flush_host({k: v[i] for k, v in h.items()}, cfg) for i in range(h["step"].shape[0])]


def rows_as_dicts(flushed: dict[str, Any], lane: int | None = None) -> list[dict]:
    """Flight rows as JSONL-ready dicts (ints for counters/flags)."""
    int_fields = {
        "step",
        "restarts",
        "iterations",
        "iter_p1",
        "iter_p2",
        "iter_p3",
        "tier",
        "skipped",
        "converged",
        "certified",
        "truncated",
    }
    out = []
    for row in flushed["rows"]:
        d = {}
        if lane is not None:
            d["lane"] = lane
        for name, value in zip(flushed["fields"], row):
            d[name] = int(value) if name in int_fields else float(value)
        out.append(d)
    return out
