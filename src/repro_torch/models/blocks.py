"""Decoder blocks: pre-norm residual attention + dense feed-forward, per the
arch config's layer pattern (the port's ``repro/models/blocks.py``).

Only attention + MLP blocks are ported; SSD mixers and MoE feed-forwards
raise ``NotImplementedError`` (:data:`QUEUE_ITEM`), and encoder-decoder
models (cross-attention) are refused by ``models.build``."""

from __future__ import annotations

import torch

from repro_torch.models import attention, mlp
from repro_torch.models.common import rms_norm

__all__ = ["QUEUE_ITEM", "check_ported", "init_block", "block_train", "block_decode"]

QUEUE_ITEM = "ROADMAP Queue 1 item 14"


def check_ported(cfg, pos: int) -> None:
    """Raise ``NotImplementedError`` unless the block at unit position
    ``pos`` is one the port has (attention + dense MLP)."""
    missing = (
        "SSD (Mamba-2) mixers" if cfg.layer_kind(pos) != "attn"
        else "MoE feed-forwards" if cfg.layer_moe(pos)
        else None
    )
    if missing:
        raise NotImplementedError(f"{cfg.name}: {missing} are not ported yet ({QUEUE_ITEM})")


def init_block(generator, cfg, pos: int, *, device=None) -> dict:
    """One block at position ``pos`` within the repeating unit."""
    check_ported(cfg, pos)
    dt = cfg.param_dtype
    p = {
        "ln1": torch.ones(cfg.d_model, dtype=dt, device=device),
        "attn": attention.init_attn(generator, cfg, device),
    }
    if cfg.d_ff > 0:
        p["ln2"] = torch.ones(cfg.d_model, dtype=dt, device=device)
        p["mlp"] = mlp.init_mlp(generator, cfg, device)
    return p


def block_train(p, cfg, x, positions):
    """Causal block over a whole sequence: (x_out, KVCache).  (The
    reference's MoE aux loss comes with the MoE blocks.)"""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    o, kv = attention.attn_train(p["attn"], cfg, h, positions)
    x = x + o
    if "mlp" in p:
        x = x + mlp.mlp_apply(p["mlp"], cfg, rms_norm(x, p["ln2"], cfg.norm_eps))
    return x, kv


def block_decode(p, cfg, x, tok_pos, cache):
    """One-token step against this block's KVCache (written in place)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    o, new_cache = attention.attn_decode(p["attn"], cfg, h, tok_pos, cache)
    x = x + o
    if "mlp" in p:
        x = x + mlp.mlp_apply(p["mlp"], cfg, rms_norm(x, p["ln2"], cfg.norm_eps))
    return x, new_cache
