"""Carry the reference's containers across into the port's.

Each function takes a reference container given as a dict of numpy arrays
(its ``NamedTuple`` fields by name; a nested container is a nested dict,
e.g. ``{"tree": {"start": ..., ...}, ...}``) and returns the port's
container on ``device`` (``None`` means ``cuda``, see
:func:`repro_torch.compat.resolve_device`).  Float arrays keep their dtype;
index arrays become the port's index tensors (int64 for torch indexing,
plus the int32 kernel copies of a tree, made from the given arrays).

With these a test feeds both packages the same step and the same warm
start, and runs an LM on the reference's weights, without the port
importing the reference.  The inverses (``*_to_numpy``) give a model's
weights, or their gradients, in the reference's stacked layout, so that a
test compares them leaf by leaf.
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
from repro_torch.models.common import Params
from repro_torch.obs import recorder as obs_recorder

__all__ = [
    "alloc_problem_from_numpy",
    "batch_meta_from_dict",
    "encdec_params_from_numpy",
    "encdec_params_to_numpy",
    "fleet_topology_from_numpy",
    "lm_params_from_numpy",
    "lm_params_to_numpy",
    "recorder_state_from_numpy",
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


def recorder_state_from_numpy(d: Mapping[str, Any], device=None) -> obs_recorder.RecorderState:
    """The reference's ``RecorderState`` (``step``, ``ring``, ``hist_kkt``,
    ``hist_move``, ``solver_hist``, the four counters, ``last_alloc``; a
    ``[K]`` ``step`` for per-lane leaves) as the port's state, in fresh
    buffers laid out as :func:`repro_torch.obs.recorder.init_state` lays
    them, so recording goes on from the same ring."""
    step = np.asarray(d["step"])
    ring = np.asarray(d["ring"])
    cfg = obs_recorder.RecorderConfig(capacity=ring.shape[-2],
                                      buckets=np.asarray(d["hist_kkt"]).shape[-1])
    dtype = torch.float64 if ring.dtype == np.float64 else torch.float32
    n = np.asarray(d["last_alloc"]).shape[-1]
    if step.ndim:
        st = obs_recorder.init_batch(cfg, step.shape[0], n, dtype, device)
    else:
        st = obs_recorder.init_state(cfg, n, dtype, device)
    # the reference's leaves; the port's ``hists`` and ``counters`` are the
    # storage that its gauge histograms and counters are views of
    storage = ("hists", "counters")
    ref_fields = [f for f in obs_recorder.RecorderState._fields if f not in storage]
    for name in ref_fields:
        leaf = getattr(st, name)
        leaf.copy_(torch.as_tensor(np.array(d[name]), dtype=leaf.dtype))
    return st


def solver_options_from_dict(d: Mapping[str, Any]) -> SolverOptions:
    """``SolverOptions`` field by field; a field the port does not know raises."""
    unknown = set(d) - set(SolverOptions._fields)
    if unknown:
        raise ValueError(f"unknown solver option(s): {sorted(unknown)}")
    return SolverOptions(**dict(d))


def batch_meta_from_dict(d: Mapping[str, Any]) -> BatchMeta:
    """``BatchMeta`` field by field (the reference engine's ``meta``); a
    field the port does not know raises."""
    unknown = set(d) - set(BatchMeta._fields)
    if unknown:
        raise ValueError(f"unknown engine metadata field(s): {sorted(unknown)}")
    return BatchMeta(**{**d, "levels": tuple(int(p) for p in d["levels"])})


def _tree(d: Mapping[str, Any], pick, device) -> dict:
    """A nested mapping of numpy arrays as tensors on ``device``, each array
    through ``pick`` first."""
    return {
        name: _tree(value, pick, device) if isinstance(value, Mapping)
        else _float(pick(value), device)
        for name, value in d.items()
    }


def _layers(stacked: Mapping[str, Any], n: int, device) -> list[dict]:
    """The ``n`` layers of a reference stack (every leaf ``[n, ...]``), one
    tree each."""
    return [_tree(stacked, lambda a: np.asarray(a)[i], device) for i in range(n)]


def lm_params_from_numpy(params: Mapping[str, Any], cfg, device=None) -> Params:
    """The port's model with the weights of the reference's ``init_lm``
    params tree (numpy arrays by the reference's names; each unit position
    ``unit/b{pos}`` stacked ``[n_units, ...]``).  Layer ``u * unit_size +
    pos`` gets unit ``u`` of ``b{pos}``, the port's one entry per layer;
    every block's leaves carry across, the attention or SSD mixer's and the
    dense or MoE feed-forward's (router and experts) alike."""
    device = resolve_device(device)
    out = _tree({name: v for name, v in params.items() if name != "unit"}, lambda a: a, device)
    units = [_layers(params["unit"][f"b{pos}"], cfg.n_units, device)
             for pos in range(cfg.unit_size)]
    out["layers"] = [units[layer % cfg.unit_size][layer // cfg.unit_size]
                     for layer in range(cfg.n_layers)]
    return Params(out)


def encdec_params_from_numpy(params: Mapping[str, Any], cfg, device=None) -> Params:
    """The port's encoder-decoder with the weights of the reference's
    ``init_encdec`` params tree: the encoder stack ``enc`` ``[enc_layers,
    ...]`` and the decoder stack ``dec`` ``[n_layers, ...]`` (with its
    cross-attention ``xattn``, ``ln_x``) become one entry per layer."""
    device = resolve_device(device)
    out = _tree({name: v for name, v in params.items() if name not in ("enc", "dec")},
                lambda a: a, device)
    out["enc"] = _layers(params["enc"], cfg.enc_layers, device)
    out["dec"] = _layers(params["dec"], cfg.n_layers, device)
    return Params(out)


def _numpy_tree(params: Params, grad: bool) -> dict:
    """The weights as nested dicts of numpy arrays (lists for the per-layer
    stacks), or with ``grad`` their gradients (zeros where a weight has
    none)."""
    def leaf(p):
        t = p if not grad else p.grad if p.grad is not None else torch.zeros_like(p)
        return t.detach().cpu().numpy()

    return params.tree(leaf)


def _stacked(trees: list) -> dict:
    """Per-layer trees as one tree of ``[layers, ...]`` leaves."""
    first = trees[0]
    if isinstance(first, Mapping):
        return {name: _stacked([t[name] for t in trees]) for name in first}
    return np.stack(trees)


def lm_params_to_numpy(params: Params, cfg, *, grad: bool = False) -> dict:
    """The inverse of :func:`lm_params_from_numpy`: the reference's
    ``init_lm`` tree, each unit position ``unit/b{pos}`` stacked ``[n_units,
    ...]`` from layers ``pos, pos + unit_size, ...``; with ``grad``, the
    weights' gradients in that layout."""
    tree = _numpy_tree(params, grad)
    layers = tree.pop("layers")
    U = cfg.unit_size
    tree["unit"] = {f"b{pos}": _stacked(layers[pos::U]) for pos in range(U)}
    return tree


def encdec_params_to_numpy(params: Params, cfg, *, grad: bool = False) -> dict:
    """The inverse of :func:`encdec_params_from_numpy`: the encoder and
    decoder stacks ``enc`` ``[enc_layers, ...]`` and ``dec`` ``[n_layers,
    ...]``; with ``grad``, the weights' gradients in that layout."""
    tree = _numpy_tree(params, grad)
    tree["enc"], tree["dec"] = _stacked(tree["enc"]), _stacked(tree["dec"])
    return tree
