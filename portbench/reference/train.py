"""A plain float32 training step: the next-token loss of
:mod:`portbench.reference.lm` over microbatches, the gradient's global norm
clipped, and AdamW (decoupled decay, bias correction at step + 1) under a
linear warm-up and cosine decay, the update the configuration states."""

from __future__ import annotations

import math

import torch

from portbench.reference import lm


def learning_rate(h: dict, step: int) -> float:
    """Linear warm-up to ``lr`` over ``warmup`` steps, then a cosine decay to
    ``min_frac`` of it at ``total_steps``."""
    lr, warm, total = h["lr"], h["warmup"], h["total_steps"]
    if step < warm:
        return lr * min((step + 1) / max(warm, 1), 1.0)
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return lr * (h["min_frac"] + (1 - h["min_frac"]) * 0.5 * (1 + math.cos(math.pi * prog)))


class Trainer:
    """Parameters, gradients and moments of one run, float32, by leaf name.
    It trains ``weights`` in place (their storage, not copies)."""

    def __init__(self, weights: dict, c: dict, h: dict, prec: str = "fp32"):
        self.w = {k: v.detach().requires_grad_(True) for k, v in weights.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.w.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.w.items()}
        self.c, self.h, self.prec = c, h, prec
        self.step_no = 0

    def step(self, tokens: torch.Tensor, targets: torch.Tensor) -> dict:
        """One step on a batch; returns the loss and each leaf's clipped
        gradient's norm (as AdamW receives it).  A step holds the weights,
        their gradients, both moments and two temporaries of a leaf."""
        mb = self.h["microbatch"]
        rows = tokens.shape[0] // mb
        total = 0.0
        for i in range(mb):
            sl = slice(i * rows, (i + 1) * rows)
            loss = lm.loss(self.w, self.c, tokens[sl], targets[sl], self.prec)
            loss.backward()
            total += float(loss.detach())
        with torch.no_grad():
            grads = {k: p.grad.div_(mb) for k, p in self.w.items()}
            gn = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            scale = min(1.0, self.h["max_grad_norm"] / max(float(gn), 1e-12))
            b1, b2, eps, wd = self.h["b1"], self.h["b2"], self.h["eps"], self.h["weight_decay"]
            t = self.step_no + 1
            c1, c2 = 1 - b1 ** t, 1 - b2 ** t
            lr = learning_rate(self.h, self.step_no)
            norms = {}
            for k, p in self.w.items():
                g = grads[k].mul_(scale)
                norms[k] = float(g.double().norm())
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = torch.div(self.v[k], c2).sqrt_().add_(eps)
                upd = torch.div(self.m[k], c1).div_(upd).add_(p, alpha=wd)
                p.sub_(upd, alpha=lr)
                p.grad = None
        self.step_no += 1
        return {"loss": total / mb, "grad_norms": norms}
