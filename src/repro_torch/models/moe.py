"""Top-k mixture-of-experts feed-forward with GShard-style capacity
dispatch (the port's ``repro/models/moe.py``).

Routing runs per chunk of ``cfg.moe_chunk`` tokens: a float32 router, the
top-k gates renormalised, each (token, choice) given a slot in its
expert's capacity buffer of ``cap = max(1, int(capacity_factor * k * C /
E))`` slots with choices taking priority over tokens (every token's first
choice before any token's second), the overflow dropped, and the experts'
outputs combined through the one-hot ``[B, C, E, cap]`` combine weights.
The reference computes these contractions with ``jnp.einsum`` outside any
Pallas kernel; here they are ``torch.einsum`` (bf16 GEMMs on a card).  The
dispatched tokens, the experts' hidden states and the combined tokens take
the reference's sharding constraints (a no-op off a mesh); on a mesh, each
rank runs its own rows and experts (:func:`_sharded_experts`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import init_dense
from repro_torch.sharding import constrain, is_distributed

__all__ = ["init_moe", "moe_apply", "moe_specs"]


def init_moe(generator, cfg, device=None) -> dict:
    """Router ``[D, E]`` (kept in float32) and the experts' SwiGLU weights
    ``wg``/``wu`` ``[E, D, F]`` and ``wd`` ``[E, F, D]``."""
    D, FF, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = cfg.param_dtype

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return w.mul_(scale).to(dt)

    return {
        "router": init_dense(generator, D, E, torch.float32, device),
        "wg": normal((E, D, FF), D**-0.5),
        "wu": normal((E, D, FF), D**-0.5),
        "wd": normal((E, FF, D), FF**-0.5),
    }


def moe_specs(cfg) -> dict:
    """The logical names of :func:`init_moe`'s weights, the reference's."""
    return {
        "router": ("embed", None),
        "wg": ("experts", "embed", "ff"),
        "wu": ("experts", "embed", "ff"),
        "wd": ("experts", "ff", "embed"),
    }


def _route(p, cfg, xc):
    """Router for one chunk: xc [B, C, D] -> (combine, dispatch, aux).

    ``dispatch`` is the ``[B, C, E, cap]`` one-hot slot mask (one 1 for each
    (token, choice) pair that found a slot), ``combine`` the same weighted
    by each kept choice's renormalised gate; ``aux`` is the switch
    load-balancing loss of the chunk."""
    B, C, D = xc.shape
    E, k = cfg.n_experts, cfg.top_k
    cap = max(1, int(cfg.capacity_factor * k * C / E))
    gates = torch.softmax(xc.float() @ p["router"], dim=-1)  # [B, C, E]
    topv, topi = torch.topk(gates, k, dim=-1)  # [B, C, k], largest first
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)

    # each (token, choice)'s slot in its expert's buffer: a cumsum over the
    # chunk with the choices outermost, so a token's top-1 beats others' top-2
    sel = F.one_hot(topi, E).float()  # [B, C, k, E]
    sel_flat = sel.transpose(1, 2).reshape(B, k * C, E)
    pos = torch.cumsum(sel_flat, dim=1) - sel_flat
    pos = pos.reshape(B, k, C, E).transpose(1, 2)  # [B, C, k, E]
    keep = (pos < cap) * sel  # the overflow dropped
    pos = torch.clamp(pos, 0, cap - 1).long()
    cap_onehot = F.one_hot(pos, cap).float()  # [B, C, k, E, cap]
    disp = (keep[..., None] * cap_onehot).sum(2)  # [B, C, E, cap]
    combine = ((topv[..., None] * keep)[..., None] * cap_onehot).sum(2)

    # switch aux loss: the fraction routed times the mean gate, per expert
    frac = sel.sum(2).mean(1)  # [B, E]
    me = gates.mean(1)  # [B, E]
    aux = (frac * me).sum(-1).mean() * E / k
    return combine, disp, aux


def _experts(ein, wg, wu, wd, combine):
    """The experts' SwiGLU on their dispatched tokens ein [B, E, cap, D],
    combined back onto the chunk's tokens: [B, C, D]."""
    h = F.silu(torch.einsum("bekd,edf->bekf", ein, wg))
    h = h * torch.einsum("bekd,edf->bekf", ein, wu)
    h = constrain(h, "batch", "experts", None, "ff")
    yo = torch.einsum("bekf,efd->bekd", h, wd)
    return torch.einsum("bekd,bcek->bcd", yo, combine)


def _sharded_experts(ein, wg, wu, wd, combine):
    """:func:`_experts` of DTensors, on each rank's own batch rows and
    experts (``local_map``; autograd runs through it): each rank gathers its
    experts' whole weights, and the combined tokens are its experts' part of
    the sum over the experts (``Partial`` on the mesh dims that split
    them)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = ein.device_mesh
    rows = list(ein.placements)  # batch (dim 0) and experts (dim 1) of ein
    if any(not isinstance(pl, (Shard, Replicate)) or (isinstance(pl, Shard) and pl.dim > 1)
           for pl in rows):
        raise ValueError(f"dispatched tokens placed {rows}: expected batch and experts shards")
    weights = [Shard(0) if pl == Shard(1) else Replicate() for pl in rows]
    # a weight whole on a mesh dim that splits the batch rows gets from each
    # rank the gradient of its own rows: a partial sum
    weight_grads = [Partial() if pl == Shard(0) else w for pl, w in zip(rows, weights)]
    lay_combine = [Shard(2) if pl == Shard(1) else pl for pl in rows]
    out = [Partial() if pl == Shard(1) else pl for pl in rows]
    wg, wu, wd = (w.redistribute(mesh, weights) for w in (wg, wu, wd))
    combine = combine.redistribute(mesh, lay_combine)
    fn = local_map(_experts, out_placements=out,
                   in_placements=(rows, weights, weights, weights, lay_combine),
                   in_grad_placements=(rows, weight_grads, weight_grads, weight_grads,
                                       lay_combine),
                   device_mesh=mesh)
    return fn(ein, wg, wu, wd, combine)


def moe_apply(p, cfg, x):
    """x: [B, S, D] -> (y, aux loss), chunk by chunk of ``cfg.moe_chunk``
    tokens (the loss the chunks' mean)."""
    B, S, D = x.shape
    C = min(cfg.moe_chunk, S)
    if S % C:
        raise ValueError(f"seq {S} is not divisible by moe_chunk {C}")
    cd = cfg.compute_dtype
    wg, wu, wd = (p[name].to(cd) for name in ("wg", "wu", "wd"))
    ys, auxs = [], []
    for c0 in range(0, S, C):
        xc = x[:, c0 : c0 + C]
        combine, disp, aux = _route(p, cfg, xc)
        ein = torch.einsum("bcek,bcd->bekd", disp.to(cd), xc)
        ein = constrain(ein, "batch", "experts", None, None)
        if is_distributed(ein):
            yc = _sharded_experts(ein, wg, wu, wd, combine.to(cd))
        else:
            yc = _experts(ein, wg, wu, wd, combine.to(cd))
        ys.append(constrain(yc, "batch", None, None))
        auxs.append(aux)
    return torch.cat(ys, dim=1), torch.stack(auxs).mean()
