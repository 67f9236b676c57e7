"""GPipe-style pipeline parallelism over the ranks of a process group (the
port's ``repro/training/pipeline.py``).

The layer stack is split into ``P`` contiguous stages; stage ``s`` is rank
``s`` of the group and holds only its own stage's parameters (the
reference's ``[n_stages]``-stacked leaves, sliced by ``shard_map``, become
one stage per process).  The GPipe schedule: with M microbatches, ``M + P -
1`` ticks; at tick t stage 0 takes microbatch t, stage s runs microbatch ``t
- s`` when it is in range (else its input passes through unchanged), the
last stage banks its result, and every tick ends with a ring hand-off from
stage s to ``(s + 1) mod P`` (``batch_isend_irecv``, the reference's
``ppermute``).  The banked outputs are then replicated to every rank (the
reference's masked ``psum``).

This is the forward schedule (inference and evaluation pipelines); the
reference leaves the 1F1B training variant to future work, and so does the
port.  On gloo a card's activations go through host memory for each send;
NCCL takes them as they are.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.compat import via_host

__all__ = ["pipeline_forward"]


def pipeline_forward(group, stage_fn: Callable, n_microbatches: int) -> Callable:
    """Build a pipelined forward over the ranks of ``group`` (``None``: the
    default group).

    ``stage_fn(stage_params, x) -> x`` applies ONE stage's layers.  Returns
    ``apply(stage_params, batch) -> outputs``: ``stage_params`` are this
    rank's stage's, ``batch`` ``[M, mb, ...]`` is the same on every rank,
    and every rank gets the ``[M, mb, ...]`` outputs of the last stage."""
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)

    def peer(s: int) -> int:
        s %= n_stages
        return s if group is None else dist.get_global_rank(group, s)

    def handoff(y: torch.Tensor) -> torch.Tensor:
        if n_stages == 1:
            return y
        staged = via_host(y, group)
        send = y.cpu() if staged else y.contiguous()
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, peer(stage + 1), group),
               dist.P2POp(dist.irecv, recv, peer(stage - 1), group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv.to(y.device)

    def apply(stage_params, batch: torch.Tensor) -> torch.Tensor:
        M = batch.shape[0]
        if M != n_microbatches:
            raise ValueError(f"batch has {M} microbatches, the pipeline {n_microbatches}")
        inflight = torch.zeros_like(batch[0])
        outputs = torch.zeros_like(batch)
        for t in range(M + n_stages - 1):
            m = t - stage
            x_in = batch[t] if stage == 0 and t < M else inflight
            y = stage_fn(stage_params, x_in) if 0 <= m < M else x_in
            if stage == n_stages - 1 and 0 <= m < M:
                outputs[m] = y
            inflight = handoff(y)
        staged = via_host(outputs, group)
        out = outputs.cpu() if staged else outputs
        dist.broadcast(out, peer(n_stages - 1), group=group)
        return out.to(batch.device)

    return apply
