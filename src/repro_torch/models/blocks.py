"""Decoder blocks: pre-norm residual wrappers composing attention or SSD
mixers with dense or MoE feed-forwards, per the arch config's layer
pattern, and the encoder-decoder's cross-attention (the port's
``repro/models/blocks.py``)."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, mlp, moe, ssm
from repro_torch.models.common import rms_norm

__all__ = ["init_block", "block_specs", "block_train", "block_decode", "remat"]


def remat(cfg, fn, *args):
    """``fn(*args)``; with ``cfg.remat``, where autograd records, its
    activations are not kept but recomputed in the backward
    (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``
    sites do."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def init_block(generator, cfg, pos: int, *, cross: bool = False, device=None) -> dict:
    """One block at position ``pos`` within the repeating unit; ``cross``
    adds the encoder-decoder's cross-attention after the mixer."""
    dt = cfg.param_dtype
    p = {"ln1": torch.ones(cfg.d_model, dtype=dt, device=device)}
    if cfg.layer_kind(pos) == "attn":
        p["attn"] = attention.init_attn(generator, cfg, device)
    else:
        p["ssd"] = ssm.init_ssd(generator, cfg, device)
    if cross:
        p["ln_x"] = torch.ones(cfg.d_model, dtype=dt, device=device)
        p["xattn"] = attention.init_attn(generator, cfg, device)
    if cfg.layer_moe(pos):
        p["ln2"] = torch.ones(cfg.d_model, dtype=dt, device=device)
        p["moe"] = moe.init_moe(generator, cfg, device)
    elif cfg.d_ff > 0:
        p["ln2"] = torch.ones(cfg.d_model, dtype=dt, device=device)
        p["mlp"] = mlp.init_mlp(generator, cfg, device)
    # d_ff == 0 (pure-SSM mamba2): a mixer-only block, no feed-forward
    return p


def block_specs(cfg, pos: int, *, cross: bool = False) -> dict:
    """The logical names of :func:`init_block`'s weights, the reference's."""
    s = {"ln1": ("embed",)}
    if cfg.layer_kind(pos) == "attn":
        s["attn"] = attention.attn_specs(cfg)
    else:
        s["ssd"] = ssm.ssd_specs(cfg)
    if cross:
        s["ln_x"] = ("embed",)
        s["xattn"] = attention.attn_specs(cfg)
    if cfg.layer_moe(pos):
        s["ln2"] = ("embed",)
        s["moe"] = moe.moe_specs(cfg)
    elif cfg.d_ff > 0:
        s["ln2"] = ("embed",)
        s["mlp"] = mlp.mlp_specs(cfg)
    return s


def stacked_specs(specs: dict) -> dict:
    """A block's names as the reference stacks them for a ``lax.scan``: each
    leaf's with a leading "unit"."""
    return {k: stacked_specs(v) if isinstance(v, dict) else ("unit",) + v
            for k, v in specs.items()}


def _feed_forward(p, cfg, x):
    """The block's second half: (x + its feed-forward, the MoE aux loss, or
    None without experts)."""
    if "moe" in p:
        o, aux = moe.moe_apply(p["moe"], cfg, rms_norm(x, p["ln2"], cfg.norm_eps))
        return x + o, aux
    if "mlp" in p:
        x = x + mlp.mlp_apply(p["mlp"], cfg, rms_norm(x, p["ln2"], cfg.norm_eps))
    return x, None


def _cross(p, cfg, x, positions, memory):
    hx = rms_norm(x, p["ln_x"], cfg.norm_eps)
    ox, _ = attention.attn_train(p["xattn"], cfg, hx, positions, memory=memory, rope=False)
    return x + ox


def block_train(p, cfg, pos, x, positions, *, causal=True, rope=True, memory=None):
    """A block over a whole sequence: (x_out, MoE aux loss, cache), the cache
    a KVCache of an attention block or the SSMCache a decode continues
    from."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.layer_kind(pos) == "attn":
        o, cache = attention.attn_train(p["attn"], cfg, h, positions, causal=causal, rope=rope)
    else:
        o, cache = ssm.ssd_train(p["ssd"], cfg, h)
    x = x + o
    if "xattn" in p:
        x = _cross(p, cfg, x, positions, memory)
    x, aux = _feed_forward(p, cfg, x)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux, cache


def block_decode(p, cfg, pos, x, tok_pos, cache, *, rope=True, memory=None):
    """One-token step against this block's cache: a KVCache (written in
    place) or an SSMCache (a new one).  Cross-attention runs when the block
    has one and ``memory`` is given."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.layer_kind(pos) == "attn":
        o, new_cache = attention.attn_decode(p["attn"], cfg, h, tok_pos, cache, rope=rope)
    else:
        o, new_cache = ssm.ssd_decode(p["ssd"], cfg, h, cache)
    x = x + o
    if "xattn" in p and memory is not None:
        positions = torch.zeros((x.shape[0], 1), dtype=torch.int64, device=x.device)
        x = _cross(p, cfg, x, positions, memory)
    x, _ = _feed_forward(p, cfg, x)
    return x, new_cache
