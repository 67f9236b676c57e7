"""The data plane's models (the port's ``repro.models``): dense decoder-only
LMs, attention + MLP blocks.

``build(cfg)`` returns a :class:`ModelApi` with the reference's init /
prefill / decode entry points.  Encoder-decoder models and the families
whose modules are not ported yet (MoE, SSD/hybrid) raise
``NotImplementedError``; so does the training loss, which comes with the
training slice (ROADMAP Queue 1 item 14)."""

from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.models import attention, blocks, common, lm, mlp

__all__ = ["ModelApi", "attention", "blocks", "build", "common", "lm", "mlp"]


class ModelApi(NamedTuple):
    init: Callable  # (generator, device=None) -> params (a common.Params tree)
    prefill: Callable  # (params, tokens) -> (last-position logits, caches)
    decode_step: Callable  # (params, caches, tokens, pos) -> (logits, caches)
    init_decode_cache: Callable  # (batch, seq, device=None) -> caches


def build(cfg) -> ModelApi:
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet ({blocks.QUEUE_ITEM})"
        )
    for pos in range(cfg.unit_size):
        blocks.check_ported(cfg, pos)
    return ModelApi(
        init=lambda generator, device=None: lm.init_lm(generator, cfg, device),
        prefill=lambda params, tokens: lm.lm_prefill(params, cfg, tokens),
        decode_step=lambda params, caches, tokens, pos: lm.lm_decode_step(
            params, cfg, caches, tokens, pos
        ),
        init_decode_cache=lambda batch, seq, device=None: lm.init_decode_cache(
            cfg, batch, seq, device
        ),
    )
