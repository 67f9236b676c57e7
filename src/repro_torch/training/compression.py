"""int8 error-feedback gradient compression (the port's
``repro/training/compression.py``).

``make_compressor`` returns a gradient post-process hook that (a) quantizes
each gradient to int8 with a per-tensor scale and (b) carries the
quantization error into the next step (error feedback, so the bias does not
accumulate).  ``compressed_psum`` reduces a gradient across the ranks of a
``torch.distributed`` group on its int8 values (the reference's
``shard_map`` body over a mesh axis).

The arithmetic is the reference's, in float32 and in its order, so both
packages give the same bits: ``round`` rounds half to even in both.  The
scale is the reference's per leaf: the layers that the reference stacks
into one leaf (``unit/b<i>``, ``enc``, ``dec``; see ``convert``) share one
scale, the largest over them.  The
reduction's payload is an int32 accumulator, as the reference's is: 4 bytes
an element, as many as float32, so it saves no bytes on the wire (the
reference's docstring claims a 4x cut).  On a mesh the gradients are
DTensors and each scale is taken over the whole tensor.
"""

from __future__ import annotations

import itertools
from collections.abc import Mapping

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.compat import via_host
from repro_torch.convert import encdec_params_to_numpy, lm_params_to_numpy
from repro_torch.models.common import Params

__all__ = ["quantize_dequantize", "make_compressor", "compressed_psum"]


def _scale(targets: list[torch.Tensor]) -> torch.Tensor:
    """The int8 scale of float32 values spread over ``targets``."""
    top = targets[0].abs().max()
    for t in targets[1:]:
        top = torch.maximum(top, t.abs().max())
    return torch.clamp_min(top, 1e-12) / 127.0


def _round_trip(target: torch.Tensor, scale: torch.Tensor):
    q = torch.clamp(torch.round(target / scale), -127, 127).to(torch.int8)
    g_hat = q.float() * scale
    return g_hat, target - g_hat


def quantize_dequantize(g: torch.Tensor, err: torch.Tensor):
    """int8 round trip with error feedback: (g_hat in ``g``'s dtype, new_err)
    with g_hat = Q(g + err) and new_err = (g + err) - g_hat in float32."""
    target = g.float() + err
    g_hat, new_err = _round_trip(target, _scale([target]))
    return g_hat.to(g.dtype), new_err


def _leaf_groups(params: Params, cfg) -> list[list[int]]:
    """Indices into ``params.parameters()`` of each of the reference's
    leaves: a stacked leaf's layers together, every other weight alone."""
    if not ("layers" in params or "enc" in params):
        return [[i] for i in range(sum(1 for _ in params.parameters()))]
    counter = itertools.count()  # Params.map visits the weights in parameters() order
    ids = params.map(lambda p: torch.tensor(next(counter)))
    to_numpy = encdec_params_to_numpy if cfg.is_encdec else lm_params_to_numpy
    groups = []

    def walk(tree):
        for value in tree.values():
            if isinstance(value, Mapping):
                walk(value)
            else:
                groups.append([int(i) for i in np.asarray(value).reshape(-1)])

    walk(to_numpy(ids, cfg))
    return groups


def make_compressor(cfg):
    """(init_err, apply) over the list of gradients that
    ``make_train_step``'s ``grad_postprocess`` receives (``params.parameters()``
    order), for a model of config ``cfg``.  ``init_err(params)`` fixes the
    reference's leaves, which ``apply`` scales one by one (the layers of a
    stacked leaf share one scale); ``apply`` raises before it.  The caller
    threads the error list from step to step."""
    groups = None

    def init_err(params: Params) -> list[torch.Tensor]:
        nonlocal groups
        groups = _leaf_groups(params, cfg)
        return [torch.zeros_like(p, dtype=torch.float32, memory_format=torch.contiguous_format)
                for p in params.parameters()]

    def apply(grads, err):
        if groups is None:
            raise RuntimeError("call init_err(params) first: it fixes the leaves apply scales")
        grads, err = list(grads), list(err)
        if not len(grads) == len(err) == sum(map(len, groups)):
            raise ValueError(f"{len(grads)} gradients and {len(err)} error tensors for "
                             f"{sum(map(len, groups))} weights")
        g_hat, new_err = [None] * len(grads), [None] * len(grads)
        for group in groups:
            targets = [grads[i].float() + err[i] for i in group]
            scale = _scale(targets)
            for i, target in zip(group, targets):
                h, new_err[i] = _round_trip(target, scale)
                g_hat[i] = h.to(grads[i].dtype)
        return g_hat, new_err

    return init_err, apply


def compressed_psum(g: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``g`` over the ranks of ``group`` (``None``: the default
    group) on int8 values: the shared scale is the largest rank's (one
    float32 all-reduce), each rank's int8 values are summed in an int32
    accumulator (exact up to 2^23 ranks), then scaled back."""
    staged = via_host(g, group)
    g32 = g.float()
    scale = torch.clamp_min(g32.abs().max(), 1e-12) / 127.0
    scale = scale.cpu() if staged else scale
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    scale = scale.to(g.device)
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int32)
    q = q.cpu() if staged else q
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    total = q.to(g.device)
    n = torch.tensor(float(dist.get_world_size(group)), dtype=torch.float32, device=g.device)
    return (total.float() * scale / n).to(g.dtype)
