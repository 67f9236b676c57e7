"""AdamW with decoupled weight decay, global-norm clipping and a
configurable moment dtype (the port's ``repro/training/optimizer.py``).

The reference's arithmetic: the global norm of the gradients in float32,
the moments updated in float32 and stored in their own dtype, bias
correction at ``step + 1``, decay on every leaf.  The port updates the
parameters, the moments and the gradients in place, one leaf at a time, so
that a step holds at most two float32 temporaries of the largest leaf (the
reference returns new trees).  It is not ``torch.optim.AdamW``: the moment
dtype and the float32 global norm are part of the reference's contract."""

from __future__ import annotations

from typing import Iterable, NamedTuple

import torch

from repro_torch.models.common import Params
from repro_torch.sharding import is_distributed

__all__ = ["AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm"]


class AdamWState(NamedTuple):
    m: Params  # first moments, the params' names and layout
    v: Params  # second moments


def adamw_init(params: Params, dtype=torch.float32) -> AdamWState:
    """Zero moments of ``dtype`` beside every weight of ``params``."""
    def z(p):  # a DTensor's moments take its placements
        return torch.zeros_like(p, dtype=dtype, memory_format=torch.contiguous_format)

    return AdamWState(m=params.map(z), v=params.map(z))


def clip_by_global_norm(grads: Iterable[torch.Tensor], max_norm: float):
    """Scale ``grads`` in place so that their global norm (in float32) is at
    most ``max_norm``: (the grads, the norm before clipping, a 0-d float32
    tensor)."""
    grads = list(grads)
    if grads and is_distributed(grads[0]):
        gn = _sharded_norm(grads)
    else:
        sq = None
        for g in grads:
            g32 = g.detach().float().reshape(-1)
            s = torch.dot(g32, g32)
            sq = s if sq is None else sq + s
        gn = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp_min(gn, 1e-12), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return grads, gn


def _sharded_norm(grads) -> torch.Tensor:
    """The global norm of DTensor gradients placed by ``Shard`` and
    ``Replicate`` (as ``make_train_step`` places them), a 0-d float32 tensor
    on every rank: each rank sums the squares of its own shards, each
    divided by the number of ranks that hold the same shard, and one sum
    over the mesh adds them up."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = grads[0].device_mesh
    local = None
    for g in grads:
        if any(not isinstance(pl, Replicate) and not pl.is_shard() for pl in g.placements):
            raise ValueError(f"a gradient placed {g.placements}: reduce it onto its weight's first")
        copies = 1
        for size, pl in zip(g.device_mesh.shape, g.placements):
            copies *= size if isinstance(pl, Replicate) else 1
        g32 = g.to_local().detach().float().reshape(-1)
        s = torch.dot(g32, g32) / copies
        local = s if local is None else local + s
    total = DTensor.from_local(local, mesh, [Partial()] * mesh.ndim, run_check=False)
    return torch.sqrt(total.full_tensor())


@torch.no_grad()
def adamw_update(
    grads,
    opt: AdamWState,
    params: Params,
    *,
    step: int,
    lr: float,
    b1=0.9,
    b2=0.95,
    eps=1e-8,
    weight_decay=0.1,
    max_grad_norm=1.0,
):
    """One step over ``grads`` (one tensor per weight, in
    ``params.parameters()`` order; clipped in place): the parameters and the
    moments are updated in place.  Returns (params, opt, grad_norm)."""
    grads, gn = clip_by_global_norm(grads, max_grad_norm)
    f32 = torch.float32
    t = torch.tensor(step + 1, dtype=f32)
    c1 = float(1.0 - torch.tensor(b1, dtype=f32) ** t)
    c2 = float(1.0 - torch.tensor(b2, dtype=f32) ** t)
    lr = float(torch.tensor(lr, dtype=f32))
    for p, g, m, v in zip(params.parameters(), grads, opt.m.parameters(), opt.v.parameters(),
                          strict=True):
        # float32 views of the leaves (the leaf itself when it is float32)
        g32, m32, v32, p32 = g.float(), m.float(), v.float(), p.float()
        m32.mul_(b1).add_(g32, alpha=1 - b1)
        v32.mul_(b2).addcmul_(g32, g32, value=1 - b2)
        # mhat / (sqrt(vhat) + eps) + decay * p, two temporaries at most
        delta = torch.div(v32, c2).sqrt_().add_(eps)
        delta = torch.div(m32, c1).div_(delta)
        delta.add_(p32, alpha=weight_decay)
        p32.sub_(delta, alpha=lr)
        for leaf, leaf32 in ((p, p32), (m, m32), (v, v32)):
            if leaf32 is not leaf:
                leaf.copy_(leaf32)
    return params, opt, gn
