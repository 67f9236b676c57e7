"""Checkpointing (the port's ``repro/training/checkpoint.py``).

Format, the reference's: one directory ``step_%08d`` per step holding a flat
``leaves.npz`` of leaves keyed by the reference's pytree paths and a JSON
manifest (step, each leaf's shape and dtype).  A :class:`TrainState` is
written under the reference's keys and stacked layout (``.step`` a 0-d
int32, ``.params/...``, ``.opt/.m/...`` and ``.opt/.v/...``, with the
``unit/b<i>`` or ``enc``/``dec`` stacks of ``convert``), so one checkpoint
directory serves both packages: the reference's ``restore`` reads the
port's checkpoint and this ``restore`` reads the reference's.  ``save``
also takes a bare ``Params`` (the same layout, without the prefix) and a
plain dict of tensors (its keys).  numpy has no bfloat16, so a bfloat16
leaf is written as float32 (exactly) and cast back on restore.

Writes are atomic (a ``.tmp_`` directory under ``ckpt_dir``, then a rename)
and trimmed to the ``keep`` most recent, so a failure mid-write never
touches the latest good checkpoint.

On a mesh (a state of DTensors, see :mod:`repro_torch.sharding`) every rank
calls ``save``: each leaf is gathered whole (``full_tensor``), rank 0 writes
it under the same keys, in the same format, and the ranks meet at a barrier.
``restore`` puts the full leaves on one device, and with ``shardings=`` (a
:func:`repro_torch.sharding.param_sharding` tree) distributes each onto its
placements on the current mesh: the reference's elastic resharding, so a
checkpoint written at one mesh restores at another.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from collections.abc import Mapping

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.convert import (
    encdec_params_from_numpy,
    encdec_params_to_numpy,
    lm_params_from_numpy,
    lm_params_to_numpy,
)
from repro_torch.models.common import Params
from repro_torch.sharding import distribute_params, gather_params, is_distributed
from repro_torch.training.optimizer import AdamWState
from repro_torch.training.state import TrainState, gathered

__all__ = ["save", "restore", "latest_step"]


def _params_tree(params: Params, cfg, shell: bool) -> dict:
    """A model's weights in the reference's layout (nested dicts of numpy
    arrays; with ``shell``, empty ones: the keys alone).  Without per-layer
    stacks (a plain tree of weights) ``cfg`` is not needed."""
    params = params.map(lambda p: torch.empty(0) if shell
                        else p.float() if p.dtype == torch.bfloat16 else p)
    if "layers" in params or "enc" in params:
        if cfg is None:
            raise ValueError("a model's per-layer stacks need the model's config: pass cfg=")
        to_numpy = encdec_params_to_numpy if cfg.is_encdec else lm_params_to_numpy
        return to_numpy(params, cfg)
    return params.tree(lambda p: p.detach().cpu().numpy())


def _flat(tree: Mapping, prefix: str, out: dict) -> dict:
    for name, value in tree.items():
        key = f"{prefix}{name}"
        if isinstance(value, Mapping):
            _flat(value, key + "/", out)
        else:
            out[key] = value
    return out


def _leaf(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        t = value.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return np.asarray(value)


def _flatten(state, cfg=None, shell: bool = False) -> dict[str, np.ndarray]:
    """The reference's ``_flatten`` of ``state`` as numpy arrays (with
    ``shell``, empty ones), in the port's leaf order (``params.parameters()``,
    then the moments)."""
    if isinstance(state, TrainState):
        out = {".step": np.asarray(state.step, np.int32)}
        _flat(_params_tree(state.params, cfg, shell), ".params/", out)
        _flat(_params_tree(state.opt.m, cfg, shell), ".opt/.m/", out)
        _flat(_params_tree(state.opt.v, cfg, shell), ".opt/.v/", out)
        return out
    if isinstance(state, Params):
        return _flat(_params_tree(state, cfg, shell), "", {})
    if isinstance(state, Mapping):
        return {k: _leaf(v) for k, v in _flat(state, "", {}).items()}
    raise TypeError(f"cannot checkpoint a {type(state).__name__}")


def _gathered(state):
    """``state`` with every DTensor leaf gathered whole (a collective), and
    whether it was on a mesh."""
    if isinstance(state, TrainState) and is_distributed(next(state.params.parameters())):
        return gathered(state), True
    if isinstance(state, Params) and is_distributed(next(state.parameters())):
        return gather_params(state), True
    return state, False


def save(ckpt_dir: str, step: int, state, *, keep: int = 3, cfg=None) -> str:
    """Write ``state`` atomically; returns the checkpoint's path.  ``cfg``
    is the model's config, needed for a model's per-layer stacks (a
    ``TrainState`` or a model's ``Params``).  A state on a mesh: every rank
    calls it, rank 0 writes."""
    state, on_mesh = _gathered(state)
    final = os.path.join(ckpt_dir, f"step_{int(step):08d}")
    if on_mesh and dist.get_rank() != 0:
        dist.barrier()
        return final
    try:
        _write(ckpt_dir, step, state, keep, cfg, final)
    finally:
        if on_mesh:
            dist.barrier()
    return final


def _write(ckpt_dir, step, state, keep, cfg, final) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = _flatten(state, cfg)
    manifest = {
        "step": int(step),
        "leaves": {k: {"shape": list(a.shape), "dtype": str(a.dtype)} for k, a in arrays.items()},
    }
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "leaves.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _trim(ckpt_dir, keep)


def _trim(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.startswith(".tmp")
    ]
    return max(steps) if steps else None


def _nested(arrays: dict, keys, prefix: str) -> dict:
    """The leaves under ``prefix`` as nested dicts, in the order of ``keys``."""
    tree: dict = {}
    for key in keys:
        if key.startswith(prefix):
            *path, name = key[len(prefix):].split("/")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[name] = arrays[key]
    return tree


def _params_like(arrays: dict, keys, prefix: str, like: Params, cfg, device) -> Params:
    """A ``Params`` structured like ``like`` from the leaves under
    ``prefix``, each leaf in ``like``'s dtype and gradient flag."""
    tree = _nested(arrays, keys, prefix)
    if "unit" in tree or "enc" in tree:
        from_numpy = encdec_params_from_numpy if cfg.is_encdec else lm_params_from_numpy
        out = from_numpy(tree, cfg, device)
    else:
        out = Params(_to_tensors(tree, device))
    for new, old in zip(out.parameters(), like.parameters(), strict=True):
        if new.shape != old.shape:
            raise ValueError(f"checkpoint leaf of shape {tuple(new.shape)} where the state "
                             f"has {tuple(old.shape)}")
        if new.dtype != old.dtype:
            new.data = new.data.to(old.dtype)
        new.requires_grad_(old.requires_grad)
    return out


def _to_tensors(tree: Mapping, device) -> dict:
    return {name: _to_tensors(v, device) if isinstance(v, Mapping)
            else torch.as_tensor(np.array(v), device=device) for name, v in tree.items()}


def _device_of(like) -> torch.device:
    if isinstance(like, TrainState):
        like = like.params
    if isinstance(like, Params):
        return next(like.parameters()).device
    first = next(iter(_flat(like, "", {}).values()))
    return first.device if isinstance(first, torch.Tensor) else torch.device("cpu")


def restore(ckpt_dir: str, step: int, like, shardings=None, *, cfg=None, device=None):
    """Rebuild a state structured like ``like`` (a ``TrainState``, a
    ``Params`` or a dict of tensors) from the checkpoint, each leaf cast to
    ``like``'s dtype, on ``device`` (``None``: ``like``'s device).  ``cfg``
    as for :func:`save`.  ``shardings``: the weights' placements on a mesh
    (:func:`repro_torch.sharding.param_sharding`'s tree; a ``TrainState``'s
    moments take their weights'), onto which every rank distributes the
    full leaves it read; ``None`` keeps them whole."""
    if shardings is not None and not isinstance(like, (TrainState, Params)):
        raise TypeError("shardings= places a TrainState's or a Params' weights")
    out = _restore(ckpt_dir, step, like, cfg, device)
    if shardings is None:
        return out
    if isinstance(out, Params):
        return distribute_params(out, shardings)
    for tree in (out.params, out.opt.m, out.opt.v):
        distribute_params(tree, shardings)
    return out


def _restore(ckpt_dir, step, like, cfg, device):
    path = os.path.join(ckpt_dir, f"step_{int(step):08d}")
    with np.load(os.path.join(path, "leaves.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    keys = list(_flatten(like, cfg, shell=True))
    missing = set(keys) - set(arrays)
    if missing:
        raise ValueError(f"checkpoint missing leaves: {sorted(missing)[:5]}")
    device = _device_of(like) if device is None else torch.device(device)
    if isinstance(like, TrainState):
        return TrainState(
            step=int(arrays[".step"]),
            params=_params_like(arrays, keys, ".params/", like.params, cfg, device),
            opt=AdamWState(
                m=_params_like(arrays, keys, ".opt/.m/", like.opt.m, cfg, device),
                v=_params_like(arrays, keys, ".opt/.v/", like.opt.v, cfg, device),
            ),
        )
    if isinstance(like, Params):
        return _params_like(arrays, keys, "", like, cfg, device)
    flat_like, out = _flat(like, "", {}), {}
    for key in keys:
        t = torch.as_tensor(arrays[key], device=device)
        out[key] = t.to(flat_like[key].dtype) if isinstance(flat_like[key], torch.Tensor) else t
    return _nested(out, keys, "")
