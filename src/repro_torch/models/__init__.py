"""The data plane's models (the port's ``repro.models``): decoder-only LMs
of attention or SSD mixers with dense or MoE feed-forwards (dense, MoE,
Mamba-2 and hybrid families), and the encoder-decoder (whisper).

``build(cfg)`` returns a :class:`ModelApi` with the reference's init /
loss / prefill / decode entry points, dispatching on the arch family."""

from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.models import attention, blocks, common, encdec, flash_vjp, lm, mlp, moe, ssm

__all__ = [
    "ModelApi",
    "attention",
    "blocks",
    "build",
    "common",
    "encdec",
    "flash_vjp",
    "lm",
    "mlp",
    "moe",
    "ssm",
]


class ModelApi(NamedTuple):
    init: Callable  # (generator, device=None) -> params (a common.Params tree)
    # (params, tokens, targets[, enc_input]) -> (loss, metrics), differentiable
    # in the params that require a gradient
    loss: Callable
    # (params, tokens[, enc_input]) -> (last-position logits, caches[, memory])
    prefill: Callable
    # (params, caches, tokens, pos) -> (logits, caches); the encoder-decoder's
    # also takes memory= (None: one zero frame, as the reference's)
    decode_step: Callable
    init_decode_cache: Callable  # (batch, seq, device=None) -> caches
    # () -> the weights' logical spec tree, the reference's layout (see
    # repro_torch.sharding.param_sharding)
    specs: Callable


def build(cfg) -> ModelApi:
    if cfg.is_encdec:
        return ModelApi(
            init=lambda generator, device=None: encdec.init_encdec(generator, cfg, device),
            loss=lambda params, tokens, targets, enc_input: encdec.encdec_loss(
                params, cfg, tokens, targets, enc_input
            ),
            prefill=lambda params, tokens, enc_input: encdec.encdec_prefill(
                params, cfg, tokens, enc_input
            ),
            decode_step=lambda params, caches, tokens, pos, memory=None: (
                encdec.encdec_decode_step(params, cfg, caches, tokens, pos, memory)
            ),
            init_decode_cache=lambda batch, seq, device=None: encdec.init_decode_cache(
                cfg, batch, seq, device
            ),
            specs=lambda: encdec.encdec_specs(cfg),
        )
    return ModelApi(
        init=lambda generator, device=None: lm.init_lm(generator, cfg, device),
        loss=lambda params, tokens, targets: lm.lm_loss(params, cfg, tokens, targets),
        prefill=lambda params, tokens: lm.lm_prefill(params, cfg, tokens),
        decode_step=lambda params, caches, tokens, pos: lm.lm_decode_step(
            params, cfg, caches, tokens, pos
        ),
        init_decode_cache=lambda batch, seq, device=None: lm.init_decode_cache(
            cfg, batch, seq, device
        ),
        specs=lambda: lm.lm_specs(cfg),
    )
