"""Serve step factory (the port's ``repro/training/step.py``).

``make_serve_steps`` builds (prefill, decode_step) for inference; the
reference's ``make_train_step`` and ``init_train_state`` come with the
training slice (ROADMAP Queue 1 item 14)."""

from __future__ import annotations

__all__ = ["make_serve_steps"]


def make_serve_steps(cfg, api):
    """(prefill_fn, decode_fn) with uniform signatures for the launcher.

    prefill: (params, batch_dict) -> (logits, caches[, memory])
    decode:  (params, caches, tokens, pos) -> (logits, caches)
    """

    def prefill(params, batch):
        if cfg.is_encdec:
            return api.prefill(params, batch["tokens"], batch["enc_input"])
        return api.prefill(params, batch["tokens"])

    def decode(params, caches, tokens, pos):
        return api.decode_step(params, caches, tokens, pos)

    return prefill, decode
