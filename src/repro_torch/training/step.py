"""Train and serve step factories (the port's ``repro/training/step.py``).

``make_train_step`` builds the training step: microbatched gradient
accumulation (``cfg.microbatch``), per-unit rematerialisation (inside the
model), global-norm clipping, AdamW and the cosine schedule.  The step has
the signature ``(state, batch) -> (state, metrics)`` and updates the
state's parameters and moments in place.  ``make_serve_steps`` builds
(prefill, decode_step) for inference.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.compat import resolve_device
from repro_torch.training.optimizer import adamw_init, adamw_update
from repro_torch.training.schedule import cosine_schedule
from repro_torch.training.state import TrainState

__all__ = ["init_train_state", "make_serve_steps", "make_train_step"]


def init_train_state(cfg, api, generator, device=None) -> TrainState:
    """Weights drawn from ``generator`` on ``device`` (``None`` means
    ``cuda``), each requiring a gradient, and zero moments of
    ``cfg.opt_dtype``, at step 0."""
    params = api.init(generator, resolve_device(device))
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
            part = {k: v[i * (b // mb) : (i + 1) * (b // mb)] for k, v in batch.items()}
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
        return new_state, {"loss": loss, "grad_norm": gn, **metrics}

    return train_step


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
