"""Learning-rate schedules (the port's ``repro/training/schedule.py``)."""

from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule"]


def cosine_schedule(base_lr: float, warmup: int, total: int, min_frac=0.1):
    """lr(step) -> a 0-d float32 tensor: linear warmup to ``base_lr`` over
    ``warmup`` steps, then a cosine decay to ``min_frac * base_lr`` at
    ``total``, computed in float32 as the reference's."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * torch.clamp((step + 1) / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, base_lr * cos)

    return lr
