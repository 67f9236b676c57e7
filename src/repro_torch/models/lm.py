"""Decoder-only language model: the training forward and its chunked
cross-entropy, prefill and decode entry points (the port's
``repro/models/lm.py``).

The reference stacks each unit position's params ``[n_units, ...]`` for a
``lax.scan``; the port keeps one entry of ``params["layers"]`` per layer
(layer ``u * unit_size + pos`` is unit ``u``'s block ``pos``) and loops.
The training forward rematerialises unit by unit under ``cfg.remat``, as
the reference's scan body does.  A layer's cache is a KVCache (attention)
or an SSMCache (SSD), by ``cfg.layer_kind``, so hybrid units (jamba)
prefill and decode as dense ones do.
"""

from __future__ import annotations

import torch

from repro_torch.compat import resolve_device
from repro_torch.models import attention, blocks, ssm
from repro_torch.models.common import Params, rms_norm
from repro_torch.sharding import constrain

__all__ = ["init_lm", "lm_specs", "lm_forward", "lm_loss", "lm_prefill", "lm_decode_step",
           "init_decode_cache"]


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


def lm_specs(cfg) -> dict:
    """The logical spec tree of :func:`init_lm`'s weights, without allocating
    any: the reference's ``init_lm`` specs, each unit position ``unit/b{pos}``
    stacked (its names led by "unit"), as ``convert.lm_params_to_numpy`` lays
    the weights out."""
    specs = {"tok_embed": ("vocab", "embed"), "final_norm": ("embed",)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("embed", "vocab")
    specs["unit"] = {f"b{pos}": blocks.stacked_specs(blocks.block_specs(cfg, pos))
                     for pos in range(cfg.unit_size)}
    return specs


def _head(params, cfg):
    if cfg.tie_embeddings:
        return params["tok_embed"].T.to(cfg.compute_dtype)
    return params["lm_head"].to(cfg.compute_dtype)


def _embed(params, cfg, tokens):
    return params["tok_embed"][tokens].to(cfg.compute_dtype)


def _unit_body(cfg, layers, x, positions):
    """One unit's blocks applied to x: (x, their MoE aux losses summed)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for pos, block in enumerate(layers):
        x, a, _ = blocks.block_train(block, cfg, pos, x, positions)
        aux = aux + a
    return x, aux


def lm_forward(params, cfg, tokens):
    """tokens [B, S] -> (final hidden states [B, S, D], the MoE aux loss
    summed over the layers and divided by ``n_layers``)."""
    B, S = tokens.shape
    x = constrain(_embed(params, cfg, tokens), "batch", "seq", "embed_act")
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    U = cfg.unit_size
    for u in range(cfg.n_units):
        x, a = blocks.remat(cfg, _unit_body, cfg, params["layers"][u * U : (u + 1) * U], x,
                            positions)
        x = constrain(x, "batch", "seq", "embed_act")
        aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux / max(cfg.n_layers, 1)


def chunked_xent(h, W, targets, chunk: int):
    """Summed next-token cross-entropy of hidden states h [B, S, D] under the
    head W [D, V] against targets [B, S], ``chunk`` tokens of each row at a
    time so that the [tokens, vocab] logits never exist for the whole
    sequence: the logits in the compute dtype, then float32, logsumexp minus
    the gold logit."""
    B, S, _ = h.shape
    C = min(chunk, S)
    if S % C:
        raise ValueError(f"seq {S} is not divisible by loss_chunk {C}")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, C):
        logits = (h[:, c0 : c0 + C] @ W).float()  # [B, C, V]
        logits = constrain(logits, "batch", None, "vocab")
        gold = logits.gather(-1, targets[:, c0 : c0 + C, None].long())
        gold = constrain(gold, "batch", None, None)  # summed over the vocab's shards
        gold = gold[..., 0]
        total = total + (torch.logsumexp(logits, dim=-1) - gold).sum()
    return total


def lm_loss(params, cfg, tokens, targets):
    """Mean next-token cross-entropy (chunks of ``cfg.loss_chunk`` tokens),
    plus 0.01 x the MoE aux loss for a config with experts: (loss, metrics
    ``{"xent", "moe_aux"}``)."""
    h, aux = lm_forward(params, cfg, tokens)
    B, S = tokens.shape
    loss = chunked_xent(h, _head(params, cfg), targets, cfg.loss_chunk) / (B * S)
    moe_w = 0.01 if cfg.n_experts else 0.0
    return loss + moe_w * aux, {"xent": loss.detach(), "moe_aux": aux.detach()}


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
