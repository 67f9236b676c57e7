"""Carry the reference's containers across into the port's.

Each function takes a reference container given as a dict of numpy arrays
(its ``NamedTuple`` fields by name; a nested container is a nested dict,
e.g. ``{"tree": {"start": ..., ...}, ...}``) and returns the port's
container on ``device`` (``None`` means ``cuda``, see
:func:`repro_torch.compat.resolve_device`).  Float arrays keep their dtype;
index arrays become the port's index tensors (int64 for torch indexing,
plus the int32 kernel copies of a tree, made from the given arrays).

With these a test feeds both packages the same step and the same warm
start, without the port importing the reference.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.core.batched import BatchMeta
from repro_torch.core.phases import WarmCarry
from repro_torch.core.problem import AllocProblem, FleetTopology
from repro_torch.core.solver import SolverOptions, SolverState
from repro_torch.core.treeops import SlaTopo, TreeTopo

__all__ = [
    "alloc_problem_from_numpy",
    "batch_meta_from_dict",
    "fleet_topology_from_numpy",
    "solver_state_from_numpy",
    "warm_carry_from_numpy",
    "solver_options_from_dict",
]


def _float(a, device) -> torch.Tensor:
    a = np.array(a)  # a copy: the reference's buffers are read-only
    if a.dtype not in (np.float64, np.float32):
        raise TypeError(f"expected a float64 or float32 array, got {a.dtype}")
    return torch.as_tensor(a, device=device)


def _trees(d: Mapping[str, Any], n: int, device) -> tuple[TreeTopo, SlaTopo]:
    t, s = d["tree"], d["sla"]
    dtype = torch.float64 if np.asarray(t["cap"]).dtype == np.float64 else torch.float32
    tree = TreeTopo.make(
        t["start"], t["end"], t["cap"], t["depth"], n, dtype=dtype, device=device
    )
    sla = SlaTopo.make(s["dev"], s["ten"], s["lo"], s["hi"], n=n, dtype=dtype, device=device)
    return tree, sla


def fleet_topology_from_numpy(d: Mapping[str, Any], device=None) -> FleetTopology:
    """``FleetTopology(tree, sla, l, u, weight_scale)``."""
    device = resolve_device(device)
    l = _float(d["l"], device)
    tree, sla = _trees(d, l.shape[0], device)
    return FleetTopology(
        tree=tree,
        sla=sla,
        l=l,
        u=_float(d["u"], device),
        weight_scale=_float(d["weight_scale"], device),
    )


def alloc_problem_from_numpy(d: Mapping[str, Any], device=None) -> AllocProblem:
    """``AllocProblem(l, u, r, priority, active, tree, sla, weight_scale)``."""
    device = resolve_device(device)
    l = _float(d["l"], device)
    tree, sla = _trees(d, l.shape[0], device)
    return AllocProblem(
        l=l,
        u=_float(d["u"], device),
        r=_float(d["r"], device),
        priority=torch.as_tensor(np.array(d["priority"], np.int32), device=device),
        active=torch.as_tensor(np.array(d["active"], bool), device=device),
        tree=tree,
        sla=sla,
        weight_scale=_float(d["weight_scale"], device),
    )


def solver_state_from_numpy(d: Mapping[str, Any], device=None) -> SolverState:
    """``SolverState(x, t, y_tree, y_sla, y_imp)``; ``t`` is a 0-d array."""
    device = resolve_device(device)
    return SolverState(*(_float(d[f], device) for f in SolverState._fields))


def warm_carry_from_numpy(d: Mapping[str, Any], device=None) -> WarmCarry:
    """``WarmCarry(p1, p2, p3)`` of three solver states."""
    return WarmCarry(*(solver_state_from_numpy(d[f], device) for f in WarmCarry._fields))


def solver_options_from_dict(d: Mapping[str, Any]) -> SolverOptions:
    """``SolverOptions`` field by field; a field the port does not know raises."""
    unknown = set(d) - set(SolverOptions._fields)
    if unknown:
        raise ValueError(f"unknown solver option(s): {sorted(unknown)}")
    return SolverOptions(**dict(d))


# the reference's incremental-mode (certify-first) fields, which the port
# leaves out until ROADMAP Queue 1 item 9
_INCREMENTAL_META = ("certify_tol", "certify_margin")


def batch_meta_from_dict(d: Mapping[str, Any]) -> BatchMeta:
    """``BatchMeta`` field by field (the reference engine's ``meta``); its
    incremental-mode tolerances are dropped, any other unknown field
    raises."""
    d = {key: value for key, value in d.items() if key not in _INCREMENTAL_META}
    unknown = set(d) - set(BatchMeta._fields)
    if unknown:
        raise ValueError(f"unknown engine metadata field(s): {sorted(unknown)}")
    return BatchMeta(**{**d, "levels": tuple(int(p) for p in d["levels"])})
