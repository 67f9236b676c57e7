"""Train and serve step factories (the port's ``repro/training/step.py``).

``make_train_step`` builds the training step: microbatched gradient
accumulation (``cfg.microbatch``), per-unit rematerialisation (inside the
model), global-norm clipping, AdamW and the cosine schedule.  The step has
the signature ``(state, batch) -> (state, metrics)`` and updates the
state's parameters and moments in place.  On a mesh the parameters and
moments are DTensors and the batch is sharded on its rows: each rank splits
its own rows into microbatches, each gradient is reduced onto its
parameter's placements, and the metrics come back whole.  Inside the
step, bf16 GEMMs reduce in float32 (:func:`float32_reductions`).
``make_serve_steps`` builds (prefill, decode_step) for inference.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from repro_torch.compat import resolve_device
from repro_torch.sharding import distribute_params, is_distributed, param_sharding
from repro_torch.training.optimizer import adamw_init, adamw_update
from repro_torch.training.schedule import cosine_schedule
from repro_torch.training.state import TrainState

__all__ = ["float32_reductions", "init_train_state", "make_serve_steps", "make_train_step"]


@contextlib.contextmanager
def float32_reductions():
    """bf16 GEMMs on the card that reduce in float32 throughout, as the
    reference's dots accumulate: PyTorch lets cuBLAS reduce a split-K bf16
    GEMM's partial sums in bf16 unless told otherwise.  With that on,
    whisper-tiny's first-step gradients of the norm gains on the H100 lay
    7-10% (relative) from the float32 run's and its losses 3.6e-4 from that
    run after three steps; off, 1.8e-5, as near as its runs on a mesh
    fall (``tools/mesh_grad_gap.py``)."""
    flags = torch.backends.cuda.matmul
    was = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        flags.allow_bf16_reduced_precision_reduction = was


def init_train_state(cfg, api, generator, device=None, rules=None) -> TrainState:
    """Weights drawn from ``generator`` on ``device`` (``None`` means
    ``cuda``), each requiring a gradient, and zero moments of
    ``cfg.opt_dtype``, at step 0.  With ``rules`` on a mesh of more than one
    rank (every rank drawing the same weights), each weight is a DTensor on
    its placements from the model's spec tree, and its moments take them
    (the reference's ``param_sharding`` and ``device_put``)."""
    params = api.init(generator, resolve_device(device))
    if rules is not None and rules.mesh is not None and rules.mesh.size() > 1:
        distribute_params(params, param_sharding(api.specs(), params, rules))
    params.requires_grad_(True)
    return TrainState(step=0, params=params, opt=adamw_init(params, cfg.opt_dtype))


def make_train_step(
    cfg,
    api,
    *,
    lr: float = 3e-4,
    warmup: int = 100,
    total_steps: int = 10_000,
    grad_postprocess: Callable | None = None,
) -> Callable:
    """``grad_postprocess``: an optional hook applied to the accumulated
    grads (a list in ``params.parameters()`` order) before the optimizer,
    returning the grads to use.  ``batch`` is a dict of tensors on the
    params' device (``tokens``, ``targets`` and an encoder-decoder's
    ``enc_input``); the metrics are 0-d tensors there: ``loss``,
    ``grad_norm`` and the loss's own."""
    schedule = cosine_schedule(lr, warmup, total_steps)

    @float32_reductions()
    def train_step(state: TrainState, batch: dict):
        params = state.params
        leaves = list(params.parameters())
        mb = max(cfg.microbatch, 1)
        b = next(iter(batch.values())).shape[0]
        if b % mb:
            raise ValueError(f"batch {b} not divisible by microbatch {mb}")
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        # float32 sums of the microbatches' grads: each leaf's .grad where it
        # is float32 (autograd adds into it), a buffer of its own otherwise
        acc = [None] * len(leaves)
        loss_sum, metric_sums = None, {}
        for i in range(mb):
            part = {k: _microbatch(v, i, mb) for k, v in batch.items()}
            loss, metrics = api.loss(params, **part)
            loss.backward()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            for k, v in metrics.items():
                metric_sums[k] = v if k not in metric_sums else metric_sums[k] + v
            for j, p in enumerate(leaves):
                if p.grad is not None and p.grad.dtype != torch.float32:
                    acc[j] = p.grad.float() if acc[j] is None else acc[j] + p.grad.float()
                    p.grad = None
        grads = [a if a is not None else p.grad if p.grad is not None else torch.zeros_like(
            p, dtype=torch.float32) for p, a in zip(leaves, acc)]
        # on a mesh, each gradient reduced onto its weight's placements (from
        # Partial sums over the batch's shards): the reference's out_shardings
        grads = [g.redistribute(p.device_mesh, p.placements)
                 if is_distributed(g) and g.placements != p.placements else g
                 for p, g in zip(leaves, grads)]
        if mb > 1:
            for g in grads:
                g.div_(mb)
        loss = loss_sum / mb
        metrics = {k: v / mb for k, v in metric_sums.items()}
        if grad_postprocess is not None:
            grads = grad_postprocess(grads)
        _, _, gn = adamw_update(grads, state.opt, params, step=state.step,
                                lr=float(schedule(state.step)))
        for p in leaves:
            p.grad = None
        new_state = TrainState(step=state.step + 1, params=params, opt=state.opt)
        metrics = {k: _full(v) for k, v in {"loss": loss, "grad_norm": gn, **metrics}.items()}
        return new_state, metrics

    return train_step


def _microbatch(v, i: int, mb: int):
    """Microbatch ``i`` of ``mb`` of a batch tensor: its rows ``i * b / mb``
    onwards, or of a DTensor sharded on the batch each rank's own rows ``i *
    b_local / mb`` onwards (slicing its global rows would gather the batch).
    Either way the microbatches together hold every row once."""
    if not is_distributed(v):
        n = v.shape[0] // mb
        return v[i * n : (i + 1) * n]
    from torch.distributed.tensor import DTensor

    local = v.to_local()
    if local.shape[0] % mb:
        raise ValueError(f"{local.shape[0]} rows a rank not divisible by microbatch {mb}")
    n = local.shape[0] // mb
    shape = (v.shape[0] // mb, *v.shape[1:])
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local[i * n : (i + 1) * n], v.device_mesh, v.placements,
                              run_check=False, shape=shape, stride=stride)


def _full(t):
    """A metric as a plain tensor (a DTensor's full value)."""
    return t.full_tensor() if is_distributed(t) else t


def make_serve_steps(cfg, api):
    """(prefill_fn, decode_fn) with uniform signatures for the launcher.

    prefill: (params, batch_dict) -> (logits, caches[, memory])
    decode:  (params, caches, tokens, pos) -> (logits, caches)
    """

    def prefill(params, batch):
        if cfg.is_encdec:
            return api.prefill(params, batch["tokens"], batch["enc_input"])
        return api.prefill(params, batch["tokens"])

    def decode(params, caches, tokens, pos):
        return api.decode_step(params, caches, tokens, pos)

    return prefill, decode
