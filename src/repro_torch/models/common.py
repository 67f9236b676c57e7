"""Shared model building blocks: norms, rotary embeddings, initializers
(the port's ``repro/models/common.py``).

Weights keep the reference's ``(d_in, d_out)`` layout and are applied as
``x @ w``, so carrying the reference's weights across is a copy.  A model's
weights are a :class:`Params` tree with the reference's names.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["Params", "rms_norm", "init_dense", "sinusoidal_positions", "rope_freqs",
           "apply_rope"]


class Params(nn.Module):
    """A tree of weights addressed by the reference's names, ``p["attn"]["wq"]``.

    Built from a nested mapping: a mapping becomes a child ``Params``, a list
    an ``nn.ModuleList`` of them (the port's per-layer stack, where the
    reference stacks units for ``lax.scan``), a tensor an ``nn.Parameter``
    without gradient (it shares the tensor's storage)."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, Mapping):
                self.add_module(name, Params(value))
            elif isinstance(value, (list, tuple)):
                self.add_module(name, nn.ModuleList(Params(v) for v in value))
            else:
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def tree(self, fn) -> dict:
        """The weights' names and layout as nested dicts (a list of them for
        a per-layer stack), each weight replaced by ``fn(weight)``."""
        out = {name: fn(p) for name, p in self._parameters.items()}
        for name, child in self._modules.items():
            out[name] = ([c.tree(fn) for c in child] if isinstance(child, nn.ModuleList)
                         else child.tree(fn))
        return out

    def map(self, fn) -> "Params":
        """A tree of the same names and layout whose weights are
        ``fn(weight)`` (e.g. an optimizer's moments)."""
        return Params(self.tree(lambda p: fn(p.detach())))


def rms_norm(x, g, eps=1e-5):
    """Computed in float32, returned in ``x``'s dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (y * g.float()).to(x.dtype)


def init_dense(generator, d_in, d_out, dtype, device, scale=None):
    """N(0, 1) * scale weights of shape (d_in, d_out); scale d_in^-0.5 by
    default, as the reference's (its values come from ``jax.random``, these
    from ``generator``)."""
    scale = scale if scale is not None else d_in**-0.5
    w = torch.randn(d_in, d_out, generator=generator, dtype=torch.float32, device=device)
    return w.mul_(scale).to(dtype)


def sinusoidal_positions(n_pos: int, d_model: int, dtype=torch.float32, device=None):
    """Whisper-style sinusoidal position embeddings [n_pos, d_model],
    computed in float32 in the reference's order, then cast to ``dtype``."""
    half = d_model // 2
    log_base = torch.tensor(-np.log(np.float32(10_000.0)), device=device)
    freq = torch.exp(log_base * torch.arange(half, dtype=torch.float32, device=device) / (half - 1))
    args = torch.arange(n_pos, dtype=torch.float32, device=device)[:, None] * freq[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1).to(dtype)


def rope_freqs(head_dim: int, rope_frac: float, theta: float, device=None):
    """Inverse frequencies for the rotated sub-dimension, and its width.

    ``rope_frac < 1`` implements partial rotary (chatglm3's '2d RoPE': only
    the first half of each head dim is rotated, the rest passes through).
    """
    rot = int(head_dim * rope_frac)
    rot -= rot % 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot))
    return inv, rot


def apply_rope(x, positions, inv_freq, rot: int):
    """x: [B, S, H, dh]; positions: [B, S] (absolute token positions).

    Rotates interleaved pairs (x[..., 0::2], x[..., 1::2]), as the reference
    does, not the two halves of the rotated width."""
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    ang = positions[..., None].float() * inv_freq  # [B, S, rot/2]
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    xr = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    return torch.cat([xr.to(x.dtype), xp], dim=-1)
