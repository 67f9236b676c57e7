"""Encoder-decoder backbone, whisper's family (the port's
``repro/models/encdec.py``).

The conv audio frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings ``[B, enc_frames, d_model]``.  Sinusoidal
positions are added to the encoder's frames and the decoder's tokens;
attention uses no rotary; the encoder's self-attention is not causal.  The
reference stacks each stack's layers ``[layers, ...]`` for a ``lax.scan``;
the port keeps one entry of ``params["enc"]`` / ``params["dec"]`` per layer.
Under ``cfg.remat`` the encoder's and the training decoder's layers
rematerialise one by one, at the reference's ``jax.checkpoint`` sites.
"""

from __future__ import annotations

import torch

from repro_torch.compat import resolve_device
from repro_torch.models import attention, blocks
from repro_torch.models.common import Params, rms_norm, sinusoidal_positions
from repro_torch.sharding import constrain
from repro_torch.models.lm import chunked_xent

__all__ = [
    "encdec_decode_step",
    "encdec_loss",
    "encdec_prefill",
    "encode",
    "init_decode_cache",
    "init_encdec",
    "encdec_specs",
]


def init_encdec(generator, cfg, device=None) -> Params:
    """Weights drawn from ``generator`` (on ``device``; ``None`` means
    ``cuda``) with the reference's distributions; to run the reference's
    weights, carry them across with
    :func:`repro_torch.convert.encdec_params_from_numpy`."""
    device = resolve_device(device)
    dt = cfg.param_dtype

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return w.mul_(scale).to(dt)

    tree = {
        "tok_embed": normal((cfg.vocab, cfg.d_model), 0.02),
        "enc_norm": torch.ones(cfg.d_model, dtype=dt, device=device),
        "final_norm": torch.ones(cfg.d_model, dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = normal((cfg.d_model, cfg.vocab), cfg.d_model**-0.5)
    tree["enc"] = [blocks.init_block(generator, cfg, 0, device=device)
                   for _ in range(cfg.enc_layers)]
    tree["dec"] = [blocks.init_block(generator, cfg, 0, cross=True, device=device)
                   for _ in range(cfg.n_layers)]
    return Params(tree)


def encdec_specs(cfg) -> dict:
    """The logical spec tree of :func:`init_encdec`'s weights, without
    allocating any: the reference's, the ``enc`` and ``dec`` stacks' names
    led by "unit", as ``convert.encdec_params_to_numpy`` lays the weights
    out."""
    specs = {"tok_embed": ("vocab", "embed"), "enc_norm": ("embed",), "final_norm": ("embed",)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("embed", "vocab")
    specs["enc"] = blocks.stacked_specs(blocks.block_specs(cfg, 0))
    specs["dec"] = blocks.stacked_specs(blocks.block_specs(cfg, 0, cross=True))
    return specs


def _embed(params, cfg, tokens, pos_emb):
    return params["tok_embed"][tokens].to(cfg.compute_dtype) + pos_emb


def encode(params, cfg, enc_input):
    """enc_input: the stub's frame embeddings [B, F, D] -> the encoder's
    memory [B, F, D] (non-causal self-attention, no rotary)."""
    cd = cfg.compute_dtype
    B, F, D = enc_input.shape
    x = enc_input.to(cd) + sinusoidal_positions(F, D, cd, enc_input.device)[None]
    x = constrain(x, "batch", "seq", "embed_act")
    positions = torch.arange(F, device=enc_input.device).expand(B, F)

    def apply_layer(layer, x):
        return blocks.block_train(layer, cfg, 0, x, positions, causal=False, rope=False)[0]

    for layer in params["enc"]:
        x = blocks.remat(cfg, apply_layer, layer, x)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _decode_stack(params, cfg, x, positions, memory, want_cache=True):
    """The decoder over a whole sequence: (final-normed hidden states, one
    KVCache of its self-attention per layer, or none without
    ``want_cache``, when each layer rematerialises under ``cfg.remat``)."""
    caches = []

    def apply_layer(layer, x):
        return blocks.block_train(layer, cfg, 0, x, positions, causal=True, rope=False,
                                  memory=memory)[0]

    for layer in params["dec"]:
        if want_cache:
            x, _, cache = blocks.block_train(layer, cfg, 0, x, positions, causal=True,
                                             rope=False, memory=memory)
            caches.append(cache)
        else:
            x = blocks.remat(cfg, apply_layer, layer, x)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), caches


def _head(params, cfg):
    if cfg.tie_embeddings:
        return params["tok_embed"].T.to(cfg.compute_dtype)
    return params["lm_head"].to(cfg.compute_dtype)


def encdec_loss(params, cfg, tokens, targets, enc_input):
    """Teacher-forced seq2seq cross-entropy, chunks of ``cfg.loss_chunk``
    tokens: (loss, metrics ``{"xent"}``)."""
    memory = encode(params, cfg, enc_input)
    B, S = tokens.shape
    x = _embed(params, cfg, tokens,
               sinusoidal_positions(S, cfg.d_model, cfg.compute_dtype, tokens.device)[None])
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    h, _ = _decode_stack(params, cfg, x, positions, memory, want_cache=False)
    loss = chunked_xent(h, _head(params, cfg), targets, cfg.loss_chunk) / (B * S)
    return loss, {"xent": loss.detach()}


def init_decode_cache(cfg, batch, seq, device=None) -> list[attention.KVCache]:
    """One KVCache [batch, seq, n_kv, head_dim] per decoder layer."""
    device = resolve_device(device)
    return [attention.init_kv_cache(cfg, batch, seq, device=device) for _ in range(cfg.n_layers)]


def encdec_prefill(params, cfg, tokens, enc_input):
    """Encode ``enc_input``, then the decoder over the prompt [B, S]:
    (last-position logits [B, 1, vocab] in float32, the decoder's KV caches,
    the encoder's memory)."""
    memory = encode(params, cfg, enc_input)
    B, S = tokens.shape
    x = _embed(params, cfg, tokens,
               sinusoidal_positions(S, cfg.d_model, cfg.compute_dtype, tokens.device)[None])
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    h, caches = _decode_stack(params, cfg, x, positions, memory)
    logits = (h[:, -1:] @ _head(params, cfg)).float()
    return logits, caches, memory


def encdec_decode_step(params, cfg, caches, tokens, pos, memory=None):
    """One decode step: tokens [B, 1] at position ``pos`` -> (logits
    [B, 1, vocab] in float32, the caches, written in place).  Without
    ``memory`` the cross-attention attends one zero frame (the reference's
    pure-LM cell); with it, each layer projects K and V from the memory again,
    as the reference does.  Every step adds the position embedding of row 0,
    as the reference does."""
    cd = cfg.compute_dtype
    B = tokens.shape[0]
    if memory is None:
        memory = torch.zeros((B, 1, cfg.d_model), dtype=cd, device=tokens.device)
    pos_row = sinusoidal_positions(2, cfg.d_model, cd, tokens.device)[0]
    x = _embed(params, cfg, tokens, pos_row[None, None])
    new_caches = []
    for layer, cache in zip(params["dec"], caches):
        x, cache = blocks.block_decode(layer, cfg, 0, x, pos, cache, rope=False, memory=memory)
        new_caches.append(cache)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ _head(params, cfg)).float()
    return logits, new_caches
