"""Decoder-only language model: prefill and decode entry points (the port's
``repro/models/lm.py``).

The reference stacks each unit position's params ``[n_units, ...]`` for a
``lax.scan``; the port keeps one entry of ``params["layers"]`` per layer
(layer ``u * unit_size + pos`` is unit ``u``'s block ``pos``) and loops.
A layer's cache is a KVCache (attention) or an SSMCache (SSD), by
``cfg.layer_kind``, so hybrid units (jamba) prefill and decode as dense
ones do.  ``lm_forward`` and ``lm_loss`` come with the training slice
(ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

import torch

from repro_torch.compat import resolve_device
from repro_torch.models import attention, blocks, ssm
from repro_torch.models.common import Params, rms_norm

__all__ = ["init_lm", "lm_prefill", "lm_decode_step", "init_decode_cache"]


def init_lm(generator, cfg, device=None) -> Params:
    """Weights drawn from ``generator`` (on ``device``; ``None`` means
    ``cuda``) with the reference's distributions.  ``jax.random`` gives
    other values for the same seed: to run the reference's weights, carry
    them across with :func:`repro_torch.convert.lm_params_from_numpy`."""
    device = resolve_device(device)
    dt = cfg.param_dtype

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return w.mul_(scale).to(dt)

    tree = {
        "tok_embed": normal((cfg.vocab, cfg.d_model), 0.02),
        "final_norm": torch.ones(cfg.d_model, dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = normal((cfg.d_model, cfg.vocab), cfg.d_model**-0.5)
    tree["layers"] = [
        blocks.init_block(generator, cfg, layer % cfg.unit_size, device=device)
        for layer in range(cfg.n_layers)
    ]
    return Params(tree)


def _head(params, cfg):
    if cfg.tie_embeddings:
        return params["tok_embed"].T.to(cfg.compute_dtype)
    return params["lm_head"].to(cfg.compute_dtype)


def _embed(params, cfg, tokens):
    return params["tok_embed"][tokens].to(cfg.compute_dtype)


def init_decode_cache(cfg, batch, seq, device=None) -> list:
    """One cache per layer: a KVCache [batch, seq, n_kv, head_dim] at an
    attention layer, an SSMCache (state and conv window) at an SSD layer."""
    device = resolve_device(device)
    return [
        attention.init_kv_cache(cfg, batch, seq, device=device)
        if cfg.layer_kind(layer % cfg.unit_size) == "attn"
        else ssm.init_ssm_cache(cfg, batch, device=device)
        for layer in range(cfg.n_layers)
    ]


def lm_prefill(params, cfg, tokens):
    """Full forward over a prompt [B, S]; returns (last-position logits
    [B, 1, vocab] in float32, one cache per layer: a KVCache [B, S, n_kv,
    head_dim] or an SSMCache)."""
    B, S = tokens.shape
    x = _embed(params, cfg, tokens)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    caches = []
    for layer, block in enumerate(params["layers"]):
        x, _, cache = blocks.block_train(block, cfg, layer % cfg.unit_size, x, positions)
        caches.append(cache)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, -1:] @ _head(params, cfg)).float()
    return logits, caches


def lm_decode_step(params, cfg, caches, tokens, pos):
    """One decode step: tokens [B, 1] at position ``pos`` -> (logits
    [B, 1, vocab] in float32, the caches: KV caches written in place, new
    SSM caches)."""
    x = _embed(params, cfg, tokens)
    new_caches = []
    for layer, block in enumerate(params["layers"]):
        x, cache = blocks.block_decode(block, cfg, layer % cfg.unit_size, x, pos, caches[layer])
        new_caches.append(cache)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ _head(params, cfg)).float()
    return logits, new_caches
